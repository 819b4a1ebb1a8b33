"""Normalization ops: ``layer_norm`` and ``batch_norm``.

The counterparts of ``layer_norm`` and ``batch_norm`` in
``paddle_tpu/ops/norm_ops.py``. ``layer_norm`` keeps the JAX package's
routing: a LayerNorm over the last axis with 1-D scale and
shift, ``D % 128 == 0`` and ``N % 8 == 0`` goes to the fused kernel
(``ops.kernels.layernorm``, whose wrapper picks the CUDA kernel or its
plain version by device); anything else takes the dense float32 path,
the JAX package's own. Without a ``weight`` the LayerNorm has no
affine part, and a ``bias`` is not read either, as in the JAX package's
``layer_norm_noaffine`` route (``norm_ops.py:106-107``); a ``weight``
without a ``bias`` scales only (the JAX package raises there).

``batch_norm`` has no kernel under it in either package (the JAX one is
plain ``jnp``, ``norm_ops.py:18-61``). Training normalises with float32
statistics of the batch and updates the running statistics in place
with Paddle's semantics; eval normalises with the running statistics in
x's type (``_bn_infer``). See ``batch_norm``.
"""
from __future__ import annotations

import torch

from .kernels.layernorm import fused_layer_norm

__all__ = ["layer_norm", "fused_ln_ok", "batch_norm"]


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


class _BatchNormTrain(torch.autograd.Function):
    """``_bn_train`` (``norm_ops.py:27-38``): the mean and the variance
    (ddof 0) over every axis but ``axis`` in float32, the output
    ``((xf - mean) * rsqrt(var + eps)) * w + b`` in float32, cast to x's
    type. Returns ``(out, mean, var)``; the statistics carry no
    gradient. It saves x in its own type, the mean and the reciprocal
    standard deviation (C values each), and its backward is the closed
    form in float32, cast back: a composition of plain ops would save
    about three float32 copies of every normalised element instead (at
    ResNet-50's batch 128 in bfloat16, ~1.4e9 elements a step)."""

    @staticmethod
    def forward(ctx, x, weight, bias, epsilon, axis):
        shape = [1] * x.dim()
        shape[axis] = -1
        dims = [d for d in range(x.dim()) if d != axis]
        xf = x.to(torch.float32, copy=True)
        var, mean = torch.var_mean(xf, dim=dims, correction=0)
        rstd = torch.rsqrt(var + epsilon)
        out = xf.sub_(mean.reshape(shape)).mul_(rstd.reshape(shape))
        out.mul_(weight.float().reshape(shape)).add_(
            bias.float().reshape(shape))
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.axis = axis
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        shape = [1] * x.dim()
        shape[ctx.axis] = -1
        dims = [d for d in range(x.dim()) if d != ctx.axis]
        n = x.numel() // x.shape[ctx.axis]
        xhat = x.to(torch.float32, copy=True).sub_(
            mean.reshape(shape)).mul_(rstd.reshape(shape))
        dyf = dy.to(torch.float32, copy=True)
        db = dyf.sum(dim=dims)
        dw = (dyf * xhat).sum(dim=dims)
        # dx = rstd * w * (dy - mean(dy) - xhat * mean(dy * xhat))
        dx = dyf.sub_((db / n).reshape(shape)).sub_(
            xhat.mul_((dw / n).reshape(shape)))
        dx.mul_((rstd * weight.float()).reshape(shape))
        return (dx.to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype),
                None, None)


def _bn_infer(x, mean, var, weight, bias, epsilon, axis):
    """``_bn_infer`` (``norm_ops.py:18-24``): in x's type (as the JAX
    package promotes it), ``rsqrt`` taken in float32 and cast back."""
    shape = [1] * x.dim()
    shape[axis] = -1
    inv = torch.rsqrt(var.float() + epsilon).to(x.dtype)
    out = (x - mean.reshape(shape)) * inv.reshape(shape)
    return out * weight.reshape(shape) + bias.reshape(shape)


def _in_type(value, dtype):
    """The Python number ``value`` rounded to ``dtype`` on the host, as
    JAX rounds a weakly typed scalar to the array it meets."""
    return torch.tensor(value, dtype=dtype).item()


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None):
    """Batch normalisation over channel axis 1 (``data_format`` NC...)
    or the last one. With ``use_global_stats`` (default: ``not
    training``) it normalises by ``running_mean``/``running_var``;
    otherwise by the batch's statistics, and then updates the running
    statistics in place (``copy_``: a CUDA graph replays into the
    storage it captured), as ``norm_ops.py:50-60`` does: momentum is the
    share kept, the variance is made unbiased by n / (n - 1), and the
    update runs in the buffers' type, ``running * m +
    stat.to(buffer type) * (1 - m)``, with ``m`` and ``1 - m`` rounded to
    that type first."""
    axis = 1 if data_format.startswith("NC") else x.dim() - 1
    if use_global_stats is None:
        use_global_stats = not training
    if use_global_stats:
        return _bn_infer(x, running_mean, running_var, weight, bias,
                         float(epsilon), axis)
    out, mean, var = _BatchNormTrain.apply(x, weight, bias, float(epsilon),
                                           axis)
    n = x.numel() // x.shape[axis]
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        for buf, stat in ((running_mean, mean), (running_var, unbiased)):
            keep = _in_type(momentum, buf.dtype)
            take = _in_type(1 - momentum, buf.dtype)
            buf.copy_(buf * keep + stat.to(buf.dtype) * take)
    return out
