"""Normalization layers, the counterparts of
``paddle_tpu/nn/layers/norm.py``'s: ``LayerNorm``, ``BatchNorm``,
``BatchNorm1D``/``2D``/``3D``, ``SyncBatchNorm``, ``GroupNorm``,
``InstanceNorm1D``/``2D``/``3D``, ``LocalResponseNorm`` and
``SpectralNorm``.

``LayerNorm``: parameters ``weight`` (ones) and ``bias`` (zeros) over
``normalized_shape``, made by ``create_parameter`` from ``weight_attr``
and ``bias_attr`` (``False``: no such parameter), forward through
``ops.norm_ops.layer_norm`` (which routes to the fused kernel where the
JAX package does: both parameters present and 1-D).

The BatchNorms (``_BatchNormBase``, ``norm.py:26-80``): ``weight``
(ones) and ``bias`` (zeros) over ``num_features``, and the buffers
``_mean`` (zeros) and ``_variance`` (ones), float32 when made, under
the reference's names so that state dicts map name by name;
``model.bfloat16()`` casts them with the parameters, as the reference's
``Layer._to_dtype`` does (``paddle_tpu/nn/layer.py:337-347``). Forward
through ``functional.batch_norm``, which in training updates the
buffers in place. ``BatchNorm1D`` and ``3D`` differ only in their
layout's name; ``BatchNorm`` is fluid's, with ``act``.
"""
from __future__ import annotations

import math

import torch

from ..layer import Layer
from ..._device import resolve_device
from ...core.random import default_generator
from ...ops._base import register
from ...ops.norm_ops import power_sigma
from .. import functional as F
from ..initializer import Constant
from .common import create_parameter

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


class LayerNorm(Layer):
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
            generator=generator, owner=self)
        self.bias = create_parameter(self._normalized_shape, bias_attr,
                                     is_bias=True, device=device,
                                     generator=generator, owner=self)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"{self._normalized_shape}, epsilon={self._epsilon}"


class _BatchNormBase(Layer):
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
            device=device, generator=generator, owner=self)
        self.bias = create_parameter((num_features,), bias_attr,
                                     is_bias=True, device=device,
                                     generator=generator, owner=self)
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


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    """Over (N, C) or (N, C, L): channel axis 1."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, device=None, generator=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCL", use_global_stats, device,
                         generator)


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, device=None, generator=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCDHW", use_global_stats, device,
                         generator)


class BatchNorm(_BatchNormBase):
    """fluid's ``dygraph.BatchNorm``: ``act`` (a ``functional`` name)
    applied after the normalisation; ``use_global_stats=False`` means
    "by the mode", as in the JAX layer."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, use_global_stats=False,
                 device=None, generator=None):
        super().__init__(num_channels, momentum=momentum, epsilon=epsilon,
                         weight_attr=param_attr, bias_attr=bias_attr,
                         data_format=data_layout,
                         use_global_stats=use_global_stats or None,
                         device=device, generator=generator)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(F, self._act)(out) if self._act else out


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm whose training statistics are taken over every rank of
    the process group (``dist.init_parallel_env``'s;
    ``ops.norm_ops.sync_stats``): the reference's ``sync_batch_norm_op``.
    The JAX layer is a plain BatchNorm whose batch-axis mean becomes a
    cross-replica sum when GSPMD shards the batch; the port's matches it
    there. Under the JAX package's explicit exchange (a vmap over the
    shards) the JAX layer normalises each shard alone; the port's still
    syncs, as the reference's does (ROADMAP Queue 3, "not port
    faults"). In a world of one it is BatchNorm."""

    def forward(self, x):
        from ...dist.env import get_group
        from ...ops.norm_ops import sync_stats

        group = get_group()
        if group is None or not self.training:
            return super().forward(x)
        with sync_stats(group):
            return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every BatchNorm in it (itself included) made a
        ``SyncBatchNorm`` that shares its parameters and buffers."""
        out = layer
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format,
                                use_global_stats=layer._use_global_stats,
                                device=layer._mean.device)
            out.weight, out.bias = layer.weight, layer.bias
            out._mean, out._variance = layer._mean, layer._variance
        for name, sub in list(layer.named_children()):
            setattr(out, name, cls.convert_sync_batchnorm(sub))
        return out


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, generator=None):
        super().__init__()
        self._num_groups, self._epsilon = num_groups, epsilon
        self._data_format = data_format
        device = resolve_device(device)
        self.weight = create_parameter(
            (num_channels,), weight_attr, default_initializer=Constant(1.0),
            device=device, generator=generator, owner=self)
        self.bias = create_parameter((num_channels,), bias_attr,
                                     is_bias=True, device=device,
                                     generator=generator, owner=self)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias,
                            self._epsilon, self._data_format)


class _InstanceNormBase(Layer):
    """``weight_attr=False``: neither ``weight`` nor ``bias``, as in the
    JAX layer."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, generator=None):
        super().__init__()
        self._epsilon = epsilon
        device = resolve_device(device)
        if weight_attr is False:
            self.weight = self.bias = None
        else:
            self.weight = create_parameter(
                (num_features,), weight_attr,
                default_initializer=Constant(1.0), device=device,
                generator=generator, owner=self)
            self.bias = create_parameter((num_features,), bias_attr,
                                         is_bias=True, device=device,
                                         generator=generator, owner=self)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW"):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


@register("spectral_norm", inputs=("weight", "u", "v"))
def _spectral_norm(weight, u, v, *, dim, power_iters, eps):
    mat = weight.movedim(dim, 0).reshape(weight.shape[dim], -1)
    return weight / power_sigma(mat, u, v, power_iters, eps)


class SpectralNorm(Layer):
    """A weight over its largest singular value, by ``power_iters`` power
    iterations from the buffers ``weight_u`` (``weight_shape[dim]``
    values) and ``weight_v`` (the rest), N(0, 1) draws from
    ``generator`` when made (``convert`` carries the JAX layer's across);
    like the JAX layer it does not write the iterates back."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", device=None, generator=None):
        super().__init__()
        self._dim, self._power_iters, self._eps = dim, power_iters, eps
        device = resolve_device(device)
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        self.register_buffer("weight_u", torch.randn(
            h, generator=generator or default_generator(device),
            device=device))
        self.register_buffer("weight_v", torch.randn(
            w, generator=generator or default_generator(device),
            device=device))

    def forward(self, weight):
        return _spectral_norm(weight, self.weight_u, self.weight_v,
                              dim=self._dim, power_iters=self._power_iters,
                              eps=self._eps)
