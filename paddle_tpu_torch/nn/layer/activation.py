"""Activation layers: counterpart of
``paddle_tpu/nn/layer/activation.py``. ``_mk`` builds each as the JAX
module does: a ``Layer`` whose ``__init__`` takes the functional's
parameters as real positional parameters in the reference's order, then
``name`` (``LeakyReLU(0.1)`` sets the slope)."""
from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "Sigmoid", "LogSigmoid", "Tanh", "Tanhshrink",
           "Silu", "Swish", "Mish", "GELU", "ELU", "SELU", "CELU",
           "LeakyReLU", "Hardsigmoid", "Hardswish", "Hardtanh", "Hardshrink",
           "Softshrink", "Softplus", "Softsign", "ThresholdedReLU",
           "LogSoftmax", "Maxout", "Softmax", "PReLU", "RReLU"]


def _mk(name, fn_name, **defaults):
    """A Layer whose ``__init__(<defaults...>, name=None)`` keeps its
    arguments for ``F.<fn_name>``."""
    arglist = "".join(f"{k}={v!r}, " for k, v in defaults.items())
    kwdict = ", ".join(f"{k!r}: {k}" for k in defaults)
    ns = {"Layer": Layer}
    exec(  # noqa: S102 — static strings derived from the defaults dict
        f"def __init__(self, {arglist}name=None):\n"
        f"    Layer.__init__(self)\n"
        f"    self._kw = {{{kwdict}}}\n", ns)

    def forward(self, x):
        return getattr(F, fn_name)(x, **self._kw)

    return type(name, (Layer,), {"__init__": ns["__init__"],
                                 "forward": forward})


ReLU = _mk("ReLU", "relu")
ReLU6 = _mk("ReLU6", "relu6")
Sigmoid = _mk("Sigmoid", "sigmoid")
LogSigmoid = _mk("LogSigmoid", "log_sigmoid")
Tanh = _mk("Tanh", "tanh")
Tanhshrink = _mk("Tanhshrink", "tanhshrink")
Silu = _mk("Silu", "silu")
Swish = _mk("Swish", "swish")
Mish = _mk("Mish", "mish")
GELU = _mk("GELU", "gelu", approximate=False)
ELU = _mk("ELU", "elu", alpha=1.0)
SELU = _mk("SELU", "selu", scale=1.0507009873554805,
           alpha=1.6732632423543772)
CELU = _mk("CELU", "celu", alpha=1.0)
LeakyReLU = _mk("LeakyReLU", "leaky_relu", negative_slope=0.01)
Hardsigmoid = _mk("Hardsigmoid", "hardsigmoid")
Hardswish = _mk("Hardswish", "hardswish")
Hardtanh = _mk("Hardtanh", "hardtanh", min=-1.0, max=1.0)
Hardshrink = _mk("Hardshrink", "hardshrink", threshold=0.5)
Softshrink = _mk("Softshrink", "softshrink", threshold=0.5)
Softplus = _mk("Softplus", "softplus", beta=1.0, threshold=20.0)
Softsign = _mk("Softsign", "softsign")
ThresholdedReLU = _mk("ThresholdedReLU", "thresholded_relu", threshold=1.0)
LogSoftmax = _mk("LogSoftmax", "log_softmax", axis=-1)
Maxout = _mk("Maxout", "maxout", groups=2, axis=1)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter([num_parameters],
                                            attr=weight_attr, device=device)
        Constant(init)(self.weight)

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)
