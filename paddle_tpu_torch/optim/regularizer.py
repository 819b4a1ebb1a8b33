"""Weight-decay regularizers: ``L1Decay`` and ``L2Decay``.

The counterparts of ``paddle_tpu/optim/regularizer.py``'s (:22-29): a
transform of the gradient, ``g + coeff * sign(p)`` and ``g + coeff *
p``, which the optimizer applies before its update (coupled decay;
``AdamW`` decays on its own and applies none).
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    def __call__(self, param, grad):
        return grad + self.coeff * torch.sign(param)


class L2Decay(WeightDecayRegularizer):
    def __call__(self, param, grad):
        return grad + self.coeff * param
