"""Convolution layers, the counterparts of
``paddle_tpu/nn/layers/conv.py``'s (``_ConvNd``, ``:24-119``):
``Conv1D``/``2D``/``3D`` hold a weight ``(out, in / groups, *k)``, the
``Conv*Transpose`` layers one of ``(in, out / groups, *k)``, each drawn
from N(0, 2 / fan_in) with ``fan_in = in * prod(k) / groups`` unless
``weight_attr`` says otherwise, and a bias ``(out,)`` of zeros
(``bias_attr=False``: none); forward through the ``functional`` conv of
their rank. The reference's ``padding_mode`` and ``data_format`` are
taken there and not read; so here. A transposed layer's forward takes
``output_size``, which picks its ``output_padding``.
"""
from __future__ import annotations

import math


from ..layer import Layer
from ..._device import resolve_device
from .. import functional as F
from ..initializer import Normal
from .common import create_parameter

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


class _ConvNd(Layer):
    nsp = 2
    transposed = False

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, device=None, generator=None,
                 padding_mode="zeros", data_format=None, output_padding=0):
        super().__init__()
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _ntuple(kernel_size, self.nsp)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._output_padding = output_padding
        device = resolve_device(device)
        if self.transposed:
            shape = (in_channels, out_channels // groups, *self._kernel_size)
        else:
            shape = (out_channels, in_channels // groups, *self._kernel_size)
        fan_in = in_channels * math.prod(self._kernel_size) // groups
        self.weight = create_parameter(
            shape, weight_attr, default_initializer=Normal(
                0.0, (2.0 / fan_in) ** 0.5),
            device=device, generator=generator, owner=self)
        self.bias = create_parameter((out_channels,), bias_attr,
                                     is_bias=True, device=device,
                                     generator=generator, owner=self)

    def _args(self):
        return dict(stride=self._stride, padding=self._padding,
                    dilation=self._dilation, groups=self._groups)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    nsp = 1

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, **self._args())


class Conv2D(_ConvNd):
    nsp = 2

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, **self._args())


class Conv3D(_ConvNd):
    nsp = 3

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, **self._args())


class _ConvTransposeNd(_ConvNd):
    transposed = True
    FN = None

    def forward(self, x, output_size=None):
        return type(self).FN(x, self.weight, self.bias,
                             output_padding=self._output_padding,
                             output_size=output_size, **self._args())


class Conv1DTranspose(_ConvTransposeNd):
    nsp = 1
    FN = staticmethod(F.conv1d_transpose)


class Conv2DTranspose(_ConvTransposeNd):
    nsp = 2
    FN = staticmethod(F.conv2d_transpose)


class Conv3DTranspose(_ConvTransposeNd):
    nsp = 3
    FN = staticmethod(F.conv3d_transpose)
