"""Weight-decay regularizers: counterpart of ``paddle_tpu/regularizer.py``
(``L1Decay``, ``L2Decay``). Called on a parameter's value, each returns
its penalty's gradient. The optimizers take a callable ``weight_decay``
as no decay, as the JAX ones do (``optimizer/optimizer.py``'s ``_wd``)."""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __call__(self, param_value):
        """The gradient of the penalty with respect to the parameter."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """penalty = coeff * sum|w|, gradient coeff * sign(w)."""

    def __call__(self, param_value):
        return self._coeff * torch.sign(param_value)


class L2Decay(WeightDecayRegularizer):
    """penalty = coeff / 2 * sum w^2, gradient coeff * w."""

    def __call__(self, param_value):
        return self._coeff * param_value
