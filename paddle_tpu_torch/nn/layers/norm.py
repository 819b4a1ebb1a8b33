"""``LayerNorm`` and ``BatchNorm2D``, the counterparts of
``paddle_tpu/nn/layers/norm.py``'s.

``LayerNorm``: parameters ``weight`` (ones) and ``bias`` (zeros) over
``normalized_shape``, made by ``create_parameter`` from ``weight_attr``
and ``bias_attr`` (``False``: no such parameter), forward through
``ops.norm_ops.layer_norm`` (which routes to the fused kernel where the
JAX package does: both parameters present and 1-D).

``BatchNorm2D`` (``_BatchNormBase``, ``norm.py:26-80``): ``weight``
(ones) and ``bias`` (zeros) over ``num_features``, and the buffers
``_mean`` (zeros) and ``_variance`` (ones), float32 when made, under
the reference's names so that state dicts map name by name;
``model.bfloat16()`` casts them with the parameters, as the reference's
``Layer._to_dtype`` does (``paddle_tpu/nn/layer.py:337-347``). Forward
through ``functional.batch_norm``, which in training updates the
buffers in place.
"""
from __future__ import annotations

import torch
from torch import nn

from ..._device import resolve_device
from .. import functional as F
from ..initializer import Constant
from .common import create_parameter

__all__ = ["LayerNorm", "BatchNorm2D"]


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


class BatchNorm2D(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, device=None, generator=None):
        super().__init__()
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        device = resolve_device(device)
        self.weight = create_parameter(
            (num_features,), weight_attr, default_initializer=Constant(1.0),
            device=device, generator=generator)
        self.bias = create_parameter((num_features,), bias_attr,
                                     is_bias=True, device=device,
                                     generator=generator)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"{self._num_features}, momentum={self._momentum}"
