"""Normalization ops: ``layer_norm``, ``batch_norm``, ``group_norm``,
``instance_norm``, ``normalize``, ``l2_normalize``,
``local_response_norm`` (also ``lrn``), ``spectral_norm`` and fluid's
``data_norm``.

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

``group_norm`` and ``instance_norm`` take float32 statistics (mean,
then the mean of the squared deviations) and return x's type
(``norm_ops.py:112-167``); ``instance_norm`` reads no running
statistics, as the JAX package reads none. ``normalize`` divides by the
p-norm, at least ``epsilon``; ``local_response_norm`` sums the squares
of ``size`` neighbouring channels and takes Paddle's ``alpha`` as it is
(torch's divides it by ``size``); ``spectral_norm`` divides a weight by
its largest singular value after ``power_iters`` power iterations from
all-ones ``u``, ``v`` (``norm_ops.py:187-241``).
"""
from __future__ import annotations

import math

import torch

from ._base import register
from .kernels.layernorm import fused_layer_norm

__all__ = ["layer_norm", "fused_ln_ok", "batch_norm", "group_norm",
           "instance_norm", "normalize", "l2_normalize", "local_response_norm",
           "lrn", "spectral_norm", "data_norm"]


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


def _standardize(xf, axes, epsilon):
    """``(xf - mean) * rsqrt(var + epsilon)`` over ``axes``, the variance
    the mean of the squared deviations."""
    mean = xf.mean(dim=axes, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=axes, keepdim=True)
    return xc * torch.rsqrt(var + epsilon)


def _dense(x, weight, bias, epsilon, begin):
    out = _standardize(x.float(), tuple(range(begin, x.dim())), epsilon)
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
        return _layer_norm_noaffine(x, epsilon=float(epsilon),
                                    begin_norm_axis=begin)
    return _layer_norm(x, weight, bias, epsilon=float(epsilon),
                       begin_norm_axis=begin)


@register("layer_norm", inputs=("x", "weight", "bias"))
def _layer_norm(x, weight, bias, *, epsilon, begin_norm_axis):
    """The JAX package's op ``layer_norm`` (``norm_ops.py:64-87``): the
    fused kernel where ``fused_ln_ok``, else the dense path."""
    if fused_ln_ok(tuple(x.shape), begin_norm_axis, weight, bias):
        D = x.shape[-1]
        out = fused_layer_norm(x.reshape(-1, D).contiguous(), weight, bias,
                               epsilon)
        return out.reshape(x.shape)
    return _dense(x, weight, bias, epsilon, begin_norm_axis)


@register("layer_norm_noaffine", inputs=("x",))
def _layer_norm_noaffine(x, *, epsilon, begin_norm_axis):
    return _dense(x, None, None, epsilon, begin_norm_axis)


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


def _affine(out, weight, bias, axis):
    shape = [1] * out.dim()
    shape[axis] = -1
    return out * weight.float().reshape(shape) + bias.float().reshape(shape)


@register("group_norm", inputs=("x", "weight", "bias"))
def _group_norm(x, weight, bias, *, num_groups, epsilon, channel_axis):
    n, c = x.shape[0], x.shape[channel_axis]
    if channel_axis == 1:
        xg = x.reshape(n, num_groups, c // num_groups, *x.shape[2:])
        axes = tuple(range(2, xg.dim()))
    else:
        xg = x.reshape(*x.shape[:-1], num_groups, c // num_groups)
        axes = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
    out = _standardize(xg.float(), axes, epsilon).reshape(x.shape)
    return _affine(out, weight, bias, channel_axis).to(x.dtype)


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    """GroupNorm: the channels in ``num_groups`` groups, each group of
    each sample normalised; then ``weight`` (default ones) and ``bias``
    (zeros) per channel."""
    axis = 1 if data_format.startswith("NC") else x.dim() - 1
    c = x.shape[axis]
    if weight is None:
        weight = torch.ones(c, dtype=x.dtype, device=x.device)
    if bias is None:
        bias = torch.zeros(c, dtype=x.dtype, device=x.device)
    return _group_norm(x, weight, bias, num_groups=int(num_groups),
                       epsilon=float(epsilon), channel_axis=axis)


@register("instance_norm", inputs=("x", "weight", "bias"))
def _instance_norm(x, weight, bias, *, epsilon):
    out = _standardize(x.float(), tuple(range(2, x.dim())), epsilon)
    return _affine(out, weight, bias, 1).to(x.dtype)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW"):
    """InstanceNorm of an NC... ``x``: each channel of each sample
    normalised over its spatial axes, then ``weight`` (ones) and
    ``bias`` (zeros). The running statistics and ``momentum`` are taken
    and not read, as in the JAX package."""
    c = x.shape[1]
    if weight is None:
        weight = torch.ones(c, dtype=x.dtype, device=x.device)
    if bias is None:
        bias = torch.zeros(c, dtype=x.dtype, device=x.device)
    return _instance_norm(x, weight, bias, epsilon=float(eps))


@register("p_normalize", inputs=("x",))
def _p_normalize(x, *, p, axis, epsilon):
    n = (torch.abs(x) ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(n, epsilon)


def normalize(x, p=2, axis=1, epsilon=1e-12):
    """``x`` divided by its ``p``-norm along ``axis`` (at least
    ``epsilon``)."""
    return _p_normalize(x, p=float(p), axis=int(axis),
                        epsilon=float(epsilon))


@register("l2_normalize", inputs=("x",))
def _l2_normalize(x, *, axis, epsilon):
    norm = torch.sqrt((x * x).sum(dim=axis, keepdim=True))
    return x / torch.clamp_min(norm, epsilon)


def l2_normalize(x, axis=-1, epsilon=1e-12):
    """``x`` over its L2 norm along ``axis``, the norm at least
    ``epsilon`` (``norm_ops.py:170-176``)."""
    return _l2_normalize(x, axis=int(axis), epsilon=float(epsilon))


@register("local_response_norm", inputs=("x",))
def _lrn(x, *, size, alpha, beta, k):
    sq = x * x
    half = size // 2
    pad = torch.nn.functional.pad(sq, (0, 0, 0, 0, half, size - half - 1))
    acc = pad[:, 0:x.shape[1]]
    for i in range(1, size):
        acc = acc + pad[:, i:i + x.shape[1]]
    return x / torch.pow(k + alpha * acc, beta)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    """Cross-channel LRN of an NCHW ``x``: ``x / (k + alpha * s) **
    beta``, ``s`` the sum of the squares of ``size`` channels around
    each (``alpha`` not divided by ``size``)."""
    return _lrn(x, size=int(size), alpha=float(alpha), beta=float(beta),
                k=float(k))


lrn = local_response_norm


def power_sigma(mat, u, v, power_iters, eps):
    """``u @ mat @ v`` after ``power_iters`` power iterations from ``u``
    and ``v``: the largest singular value of the 2-D ``mat``."""
    for _ in range(power_iters):
        v = mat.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return u @ mat @ v


@register("spectral_norm_op", inputs=("weight",))
def _spectral_norm(weight, *, dim, power_iters, eps):
    mat = weight.movedim(dim, 0).reshape(weight.shape[dim], -1)
    u = torch.ones(mat.shape[0], dtype=torch.float32, device=mat.device)
    v = torch.ones(mat.shape[1], dtype=torch.float32, device=mat.device)
    return weight / power_sigma(mat, u, v, power_iters, eps)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12):
    """``weight`` over its largest singular value (``weight`` seen as a
    matrix of ``weight.shape[dim]`` rows), estimated by power iteration
    from all-ones vectors."""
    return _spectral_norm(weight, dim=int(dim), power_iters=int(power_iters),
                          eps=float(eps))


@register("data_norm_op",
          inputs=("x", "batch_size", "batch_sum", "batch_square_sum"))
def _data_norm(x, batch_size, batch_sum, batch_square_sum, *, epsilon):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = (batch_sum / batch_size).reshape(shape)
    var = (batch_square_sum / batch_size).reshape(shape) - mean * mean
    return (x - mean) / torch.sqrt(var + epsilon)


@register("_dn_sum", inputs=("x",))
def _dn_sum(x, *, axes):
    return x.float().sum(dim=axes)


@register("_dn_sqsum", inputs=("x",))
def _dn_sqsum(x, *, axes):
    return (x.float() ** 2).sum(dim=axes)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, moving_mean_name=None,
              moving_variance_name=None,
              do_model_average_for_mean_and_var=False, slot_dim=-1,
              summary_decay_rate=0.9999999, stats=None):
    """Fluid's data_norm (``norm_ops.py:240-264``): ``input`` (N, C, ...)
    normalised per channel by accumulated statistics ``stats = (batch
    size, batch sum, batch square sum)``, each (C,): mean ``sum /
    size``, variance ``square sum / size - mean²``, then ``(x - mean) /
    sqrt(var + epsilon)``, and ``act`` (a ``nn.functional`` name) on
    that. Without ``stats`` the batch's own float32 statistics over
    every axis but 1. The statistics are read, not updated (the caller
    keeps them), so ``summary_decay_rate`` and the layer's other
    arguments are taken and not read, as in the JAX package."""
    if stats is None:
        axes = tuple(i for i in range(input.dim()) if i != 1)
        n = float(math.prod(input.shape[i] for i in axes))
        bsize = torch.full((input.shape[1],), n, dtype=torch.float32,
                           device=input.device)
        stats = (bsize, _dn_sum(input, axes=axes),
                 _dn_sqsum(input, axes=axes))
    out = _data_norm(input, *stats, epsilon=float(epsilon))
    if act is not None:
        from ..nn import functional as F

        out = getattr(F, act)(out)
    return out
