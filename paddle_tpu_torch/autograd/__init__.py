"""Autograd: counterpart of ``paddle_tpu/autograd/``, over torch's
autograd engine (the JAX package's ``GradNode`` tape becomes torch's
graph of ``grad_fn`` nodes)."""
from .backward import backward, grad  # noqa: F401
from .functional import (Hessian, Jacobian, hessian, jacobian,  # noqa: F401
                         jvp, vhp, vjp)
from .grad_mode import (enable_grad, is_grad_enabled, no_grad,  # noqa: F401
                        set_grad_enabled)
from .py_layer import PyLayer, PyLayerContext  # noqa: F401
from .saved_tensors_hooks import saved_tensors_hooks  # noqa: F401
