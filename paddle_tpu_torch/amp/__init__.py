"""AMP: counterpart of ``paddle_tpu/amp/``: ``auto_cast`` with the port's
own white and black lists, ``decorate``, ``debugging``, and dynamic loss
scaling (``GradScaler`` / ``AmpScaler``)."""
from .auto_cast import (  # noqa: F401
    amp_guard, amp_state, auto_cast, black_list, decorate,
    is_bfloat16_supported, is_float16_supported, white_list,
)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401
from . import debugging  # noqa: F401,E402

__all__ = ["AmpScaler", "GradScaler", "auto_cast", "amp_guard", "decorate",
           "white_list", "black_list", "amp_state", "is_float16_supported",
           "is_bfloat16_supported", "debugging"]
