"""Normalization ops: ``layer_norm``.

The counterpart of ``layer_norm`` in ``paddle_tpu/ops/norm_ops.py``,
with its routing: a LayerNorm over the last axis with 1-D scale and
shift, ``D % 128 == 0`` and ``N % 8 == 0`` goes to the fused kernel
(``ops.kernels.layernorm``, whose wrapper picks the CUDA kernel or its
plain version by device); anything else takes the dense float32 path,
the JAX package's own. Without a ``weight`` the LayerNorm has no
affine part, and a ``bias`` is not read either, as in the JAX package's
``layer_norm_noaffine`` route (``norm_ops.py:106-107``); a ``weight``
without a ``bias`` scales only (the JAX package raises there).
"""
from __future__ import annotations

import torch

from .kernels.layernorm import fused_layer_norm

__all__ = ["layer_norm", "fused_ln_ok"]


def fused_ln_ok(shape, begin_norm_axis, weight, bias):
    """True when the JAX package routes this LayerNorm to its kernel
    (``norm_ops.py:68-76``, without the platform switch)."""
    if begin_norm_axis != len(shape) - 1 or weight is None or \
            bias is None or weight.dim() != 1 or bias.dim() != 1:
        return False
    D = shape[-1]
    N = 1
    for s in shape[:-1]:
        N *= s
    return D % 128 == 0 and N % 8 == 0


def _dense(x, weight, bias, epsilon, begin):
    axes = tuple(range(begin, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=axes, keepdim=True)
    out = xc * torch.rsqrt(var + epsilon)
    shape = [1] * begin + list(x.shape[begin:])
    if weight is not None:
        out = out * weight.float().reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    return out.to(x.dtype)


def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` axes of ``x``
    (default: the last one), statistics in float32, result in x's type."""
    if normalized_shape is None:
        begin = x.dim() - 1
    else:
        ns = [normalized_shape] if isinstance(normalized_shape, int) \
            else list(normalized_shape)
        begin = x.dim() - len(ns)
    if weight is None:
        bias = None
    if fused_ln_ok(tuple(x.shape), begin, weight, bias):
        D = x.shape[-1]
        out = fused_layer_norm(x.reshape(-1, D).contiguous(), weight, bias,
                               float(epsilon))
        return out.reshape(x.shape)
    return _dense(x, weight, bias, float(epsilon), begin)
