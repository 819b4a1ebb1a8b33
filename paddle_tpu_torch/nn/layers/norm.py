"""``LayerNorm``, the counterpart of ``paddle_tpu/nn/layers/norm.py``'s:
parameters ``weight`` (ones) and ``bias`` (zeros) over
``normalized_shape``, made by ``create_parameter`` from ``weight_attr``
and ``bias_attr`` (``False``: no such parameter), forward through
``ops.norm_ops.layer_norm`` (which routes to the fused kernel where the
JAX package does: both parameters present and 1-D)."""
from __future__ import annotations

from torch import nn

from ..._device import resolve_device
from .. import functional as F
from ..initializer import Constant
from .common import create_parameter

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, device=None, generator=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        device = resolve_device(device)
        self.weight = create_parameter(
            self._normalized_shape, weight_attr,
            default_initializer=Constant(1.0), device=device,
            generator=generator)
        self.bias = create_parameter(self._normalized_shape, bias_attr,
                                     is_bias=True, device=device,
                                     generator=generator)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"{self._normalized_shape}, epsilon={self._epsilon}"
