"""Pooling layers, the counterparts of
``paddle_tpu/nn/layers/pooling.py``'s (``:15-93``): no parameters;
forward through the ``functional`` pool of their kind, with what the
JAX layers pass to it. So ``AvgPool1D`` and ``AvgPool3D`` leave the
padding out of each window's count (``exclusive``'s default) and
``AvgPool2D`` counts it (``count_include_pad``'s); the ``exclusive``,
``return_mask`` and ``divisor_override`` they are made with are not
read, as in the JAX package."""
from __future__ import annotations

from ..layer import Layer
from .. import functional as F

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
           "AvgPool2D", "AvgPool3D", "AdaptiveAvgPool1D",
           "AdaptiveAvgPool2D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D"]


class _PoolNd(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, exclusive=True, divisor_override=None,
                 data_format=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.return_mask = return_mask
        self.exclusive = exclusive

    def _window(self):
        return self.kernel_size, self.stride, self.padding


class MaxPool1D(_PoolNd):
    def forward(self, x):
        return F.max_pool1d(x, *self._window())


class MaxPool2D(_PoolNd):
    def forward(self, x):
        return F.max_pool2d(x, *self._window(), ceil_mode=self.ceil_mode)


class MaxPool3D(_PoolNd):
    def forward(self, x):
        return F.max_pool3d(x, *self._window())


class AvgPool1D(_PoolNd):
    def forward(self, x):
        return F.avg_pool1d(x, *self._window())


class AvgPool2D(_PoolNd):
    def forward(self, x):
        return F.avg_pool2d(x, *self._window(), ceil_mode=self.ceil_mode)


class AvgPool3D(_PoolNd):
    def forward(self, x):
        return F.avg_pool3d(x, *self._window())


class _Adaptive(Layer):
    def __init__(self, output_size, return_mask=False, data_format=None):
        super().__init__()
        self.output_size = output_size


class AdaptiveAvgPool1D(_Adaptive):
    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_Adaptive):
    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)


class AdaptiveMaxPool1D(_Adaptive):
    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size)


class AdaptiveMaxPool2D(_Adaptive):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)
