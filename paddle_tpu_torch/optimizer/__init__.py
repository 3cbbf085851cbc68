"""Optimizers: the ``Optimizer`` base, the ten rule optimizers, ``LBFGS``
and the LR schedulers (``optimizer.lr``)."""
from . import lr  # noqa: F401
from .lbfgs import LBFGS  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import (  # noqa: F401
    SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Lars, Momentum,
    RMSProp)

__all__ = ["lr", "Optimizer", "LBFGS", "SGD", "Momentum", "Adam", "AdamW",
           "Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars"]
