"""``incubate.optimizer``: counterpart of
``paddle_tpu/incubate/optimizer``: ``LBFGS`` (promoted to
``optimizer``), and ``LookAhead`` / ``ModelAverage`` (defined in
``incubate.ops``)."""
from ...optimizer.lbfgs import LBFGS  # noqa: F401
from ..ops import LookAhead, ModelAverage  # noqa: F401

__all__ = ["LBFGS", "LookAhead", "ModelAverage"]
