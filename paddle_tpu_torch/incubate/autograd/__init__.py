"""``incubate.autograd``: counterpart of
``paddle_tpu/incubate/autograd``. The functional transforms (over the
port's ``autograd.functional``), ``forward_grad`` and ``grad``, and the
prim switch: Paddle's "prim" transform splits ops into primitives for
its compiler; the port runs torch's autograd over torch's own ops, so
``enable_prim`` / ``disable_prim`` only record the setting, as the JAX
ones do."""
from ...autograd.functional import Hessian, Jacobian, jvp, vjp  # noqa: F401
from ...utils.memo import LockedLRU

__all__ = ["vjp", "jvp", "Jacobian", "Hessian", "enable_prim",
           "disable_prim", "prim_enabled", "forward_grad", "grad"]

_PRIM = LockedLRU(maxsize=None)


def enable_prim():
    _PRIM.put("enabled", True)


def disable_prim():
    _PRIM.put("enabled", False)


def prim_enabled():
    return bool(_PRIM.get("enabled", False))


def forward_grad(outputs, inputs, grad_inputs=None):
    """Forward-mode derivative of the callable ``outputs`` at ``inputs``
    along ``grad_inputs`` (``jvp``'s tangents)."""
    if callable(outputs):
        _, tangents = jvp(outputs, inputs, grad_inputs)
        return tangents
    raise NotImplementedError(
        "forward_grad over recorded static programs: use the functional "
        "form forward_grad(fn, inputs, tangents)")


def grad(outputs, inputs, grad_outputs=None):
    """Reverse-mode gradients (``autograd.grad``)."""
    from ...autograd.backward import grad as _grad
    return _grad(outputs, inputs, grad_outputs)
