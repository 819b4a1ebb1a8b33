"""``LayerNorm``, the counterpart of ``paddle_tpu/nn/layers/norm.py``'s:
parameters ``weight`` (ones) and ``bias`` (zeros) over
``normalized_shape``, forward through ``ops.norm_ops.layer_norm`` (which
routes to the fused kernel where the JAX package does)."""
from __future__ import annotations

from torch import nn

from ..._device import resolve_device
from .. import functional as F
from ..initializer import Constant
from .common import make_parameter

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        device = resolve_device(device)
        self.weight = make_parameter(Constant(1.0), self._normalized_shape,
                                     device)
        self.bias = make_parameter(Constant(0.0), self._normalized_shape,
                                   device)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"{self._normalized_shape}, epsilon={self._epsilon}"
