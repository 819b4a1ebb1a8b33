"""``MaxPool2D`` and ``AdaptiveAvgPool2D``, the counterparts of
``paddle_tpu/nn/layers/pooling.py``'s (``:15-37``, ``:69-75``), forward
through ``functional.max_pool2d`` and ``functional.adaptive_avg_pool2d``.
They hold no parameters."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["MaxPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding = padding

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)
