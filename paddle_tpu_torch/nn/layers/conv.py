"""``Conv2D``, the counterpart of ``paddle_tpu/nn/layers/conv.py``'s
``_ConvNd`` and ``Conv2D`` (``:24-75``): a weight ``(out, in / groups,
kh, kw)`` drawn from N(0, 2 / fan_in) with ``fan_in = in * kh * kw /
groups`` unless ``weight_attr`` says otherwise, and a bias ``(out,)``
of zeros (``bias_attr=False``: none), forward through
``functional.conv2d``. (The reference's ``padding_mode`` and
``data_format`` are taken there and not read; the port does not take
them.)"""
from __future__ import annotations

import math

from torch import nn

from ..._device import resolve_device
from .. import functional as F
from ..initializer import Normal
from .common import create_parameter

__all__ = ["Conv2D"]


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


class Conv2D(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, device=None, generator=None):
        super().__init__()
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _ntuple(kernel_size, 2)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        device = resolve_device(device)
        fan_in = in_channels * math.prod(self._kernel_size) // groups
        std = (2.0 / fan_in) ** 0.5
        self.weight = create_parameter(
            (out_channels, in_channels // groups, *self._kernel_size),
            weight_attr, default_initializer=Normal(0.0, std),
            device=device, generator=generator)
        self.bias = create_parameter((out_channels,), bias_attr,
                                     is_bias=True, device=device,
                                     generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
