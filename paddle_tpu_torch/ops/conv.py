"""Convolution, pooling and resizing: ``conv1d``/``conv2d``/``conv3d``,
their transposes, ``max_pool1d``/``2d``/``3d``, ``avg_pool1d``/``2d``/
``3d``, ``adaptive_{avg,max}_pool{1d,2d}``, ``interpolate``,
``pixel_shuffle``, ``unfold``, ``affine_grid`` and ``grid_sample``.

The counterparts of ``paddle_tpu/ops/conv.py``'s, which compute every
one of these outside any Pallas kernel (``lax.conv_general_dilated``,
``lax.reduce_window``, reshape-means, weight matmuls, gathers): so here
they are PyTorch's own operators, with no kernel of this package under
them. Layouts are the JAX package's default ones: ``x`` NC..., a conv's
weight ``(out, in / groups, *k)`` and a transposed conv's ``(in, out /
groups, *k)`` (Paddle's conventions); the channels-last forms it also
takes are not ported, but for ``max_pool2d``'s ``data_format``.

Every convolution runs in the input's type with float32 accumulation,
forward and backward through cuDNN with ``benchmark=False``,
``deterministic=True`` and ``allow_tf32=False``, set around each call
and put back after it (``_cudnn``): so a float32 conv on the card is a
float32 conv, not a TF32 one (cuDNN's default), and the backward, which
autograd runs long after the forward returned, is repeatable from run to
run as the forward is. ``_Conv`` is the ``torch.autograd.Function`` that
wraps both calls. A transposed conv is the full one (no padding), cut
(or padded with zeros) to the JAX package's output: its padding is
``(d (k - 1) - p0, d (k - 1) - p1 + output_padding)`` on the dilated
input (``conv.py:820-841``), which may be uneven.

Pooling pads with -inf (max) or zeros (average) as ``reduce_window``
does; a max's gradient goes to the first largest element of a window in
row-major order, where the JAX package's ``reduce_window`` max transpose
sends it (constructed ties are tested). An average divides the window's
sum by the window's size, or with Paddle's ``exclusive`` (``avg_pool1d``/
``3d``; ``count_include_pad=False`` for ``avg_pool2d``) by the count of
elements inside the input. ``max_pool2d`` takes the JAX signature:
``ceil_mode`` and ``return_mask`` are taken there and not read, and
``data_format="NHWC"`` transposes around the NCHW pool.

The adaptive pools take the JAX package's windows (rows ``floor(i H /
oh)`` to ``ceil((i + 1) H / oh)``), as a reshape-mean or ``amax`` where
the input divides evenly, else a mean or ``amax`` per window (a max's
gradient splits over ties, as ``jnp.max``'s). ``interpolate`` is one
matmul per spatial axis by an ``(n_out, n_in)`` weight matrix made on
the host in float32 as the JAX package makes it (``conv.py:459-514``):
``nearest``, the linear modes and ``bicubic`` (Keys, a = -0.75); its
``"area"`` mode is linear, as in the JAX package. Neither uses
``F.interpolate``'s or the adaptive pools' CUDA backwards, which add
with atomics. ``grid_sample`` gathers its four taps as the JAX package
does (its backward, a scatter-add, adds with atomics on the card);
``affine_grid`` is its ``einsum``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ._base import register
from .manipulation import reshape, squeeze, transpose, unsqueeze
from .math import add

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "max_pool1d",
           "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
           "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "interpolate",
           "upsample", "pixel_shuffle", "unfold", "affine_grid",
           "grid_sample"]


def _pair(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _conv_padding(padding, nsp):
    """A Paddle padding spec as the JAX package normalises it
    (``conv.py:33-47``): ``"SAME"``/``"VALID"``, or one ``(lo, hi)``
    pair per spatial axis."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nsp
    padding = list(padding)
    if len(padding) == nsp and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nsp:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nsp)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        # [[0,0],[0,0],[t,b],[l,r]] NCHW form: keep trailing spatial entries
        return [tuple(p) for p in padding[-nsp:]]
    raise ValueError(f"bad padding {padding}")


def _pads(pad, spatial, ksize, stride, dilation):
    """``(lo, hi)`` per spatial axis for a normalised padding: a string
    resolved as ``lax.padtype_to_pads`` does it."""
    if pad == "VALID":
        return [(0, 0)] * len(spatial)
    if pad == "SAME":
        out = []
        for n, k, s, d in zip(spatial, ksize, stride, dilation):
            total = max((math.ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(pad, str):
        raise ValueError(f"bad padding {pad!r}")
    return [tuple(int(v) for v in p) for p in pad]


def _flat(pads):
    """``(lo, hi)`` per spatial axis as ``F.pad``'s list (last axis
    first)."""
    return [w for lo_hi in reversed(pads) for w in lo_hi]


def _cudnn():
    """cuDNN as the port's convs take it: on, no benchmarking,
    deterministic algorithms only, no TF32; the caller's flags are put
    back on exit."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class _Conv(torch.autograd.Function):
    """``aten.convolution`` forward (``transposed``: the transposed conv,
    no output padding), ``aten.convolution_backward`` for dx and dw,
    each under ``_cudnn``."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding, dilation, groups,
                transposed):
        ctx.save_for_backward(x, weight)
        ctx.args = (stride, padding, dilation, transposed,
                    (0,) * len(stride), groups)
        with _cudnn():
            return torch.ops.aten.convolution(x, weight, None, stride,
                                              padding, dilation, transposed,
                                              (0,) * len(stride), groups)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _cudnn():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                grad, x, weight, None, *ctx.args, mask)
        return dx, dw, None, None, None, None, None


def _conv(x, weight, stride, padding, dilation, groups, data_format, nc):
    """The convolution without its bias, as the JAX package's ops
    ``conv1d``/``conv2d``/``conv3d``: ``padding`` normalised by
    ``_conv_padding``; an uneven (or negative) padding is applied to
    ``x`` first (zeros), an even one by the convolution. ``data_format``
    is taken as the JAX op takes it, so a bundle the JAX package saved
    loads here; only ``nc`` (NCL, NCHW, NCDHW) is ported."""
    if data_format != nc:
        raise NotImplementedError(
            f"conv data_format={data_format!r}: only {nc} is ported")
    pads = _pads(padding, x.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi >= 0 for lo, hi in pads):
        even = tuple(lo for lo, _ in pads)
    else:
        x, even = F.pad(x, _flat(pads)), (0,) * len(pads)
    return _Conv.apply(x, weight, tuple(stride), even, tuple(dilation),
                       groups, False)


@register("conv1d", inputs=("x", "weight"))
def _conv1d(x, weight, *, stride, padding, dilation, groups,
            data_format="NCL"):
    return _conv(x, weight, stride, padding, dilation, groups, data_format,
                 "NCL")


@register("conv2d", inputs=("x", "weight"))
def _conv2d(x, weight, *, stride, padding, dilation, groups,
            data_format="NCHW"):
    return _conv(x, weight, stride, padding, dilation, groups, data_format,
                 "NCHW")


@register("conv3d", inputs=("x", "weight"))
def _conv3d(x, weight, *, stride, padding, dilation, groups,
            data_format="NCDHW"):
    return _conv(x, weight, stride, padding, dilation, groups, data_format,
                 "NCDHW")


_CONVS = {1: _conv1d, 2: _conv2d, 3: _conv3d}


def _conv_nd(nsp, x, weight, bias, stride, padding, dilation, groups,
             data_format):
    out = _CONVS[nsp](x, weight, stride=_pair(stride, nsp),
                      padding=_conv_padding(padding, nsp),
                      dilation=_pair(dilation, nsp), groups=int(groups),
                      data_format=data_format)
    if bias is None:
        return out
    # the bias through the registered reshape and add, as in the JAX
    # package (conv.py:72-76), so a static program records them
    return add(out, reshape(bias, (1, -1) + (1,) * nsp))


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    """1-D convolution of ``x`` (N, C, L) by ``weight`` (O, C / groups,
    k), plus ``bias`` (O,) when given; padding as ``conv2d`` takes it."""
    return _conv_nd(1, x, weight, bias, stride, padding, dilation, groups,
                    data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution of ``x`` (N, C, H, W) by ``weight`` (O, C / groups,
    kh, kw), plus ``bias`` (O,) when given. Padding as Paddle takes it:
    an int, one per axis, ``(top, bottom, left, right)``, pairs, or
    ``"SAME"``/``"VALID"``; an uneven padding is applied to ``x`` first
    (zeros), an even one by the convolution."""
    return _conv_nd(2, x, weight, bias, stride, padding, dilation, groups,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    """3-D convolution of ``x`` (N, C, D, H, W) by ``weight`` (O, C /
    groups, kd, kh, kw), plus ``bias`` (O,) when given."""
    return _conv_nd(3, x, weight, bias, stride, padding, dilation, groups,
                    data_format)


def _conv_transpose(x, weight, stride, padding, dilation, groups,
                    output_padding):
    """The JAX package's ``_convnd_transpose`` (``conv.py:820-841``): the
    conv over ``x`` dilated by ``stride`` and padded by ``(lo, hi)`` a
    spatial axis, with the flipped, in/out-swapped weight. That is the
    full transposed conv (``lo = hi = d (k - 1)``) with ``d (k - 1) -
    lo`` cut from the start of each axis and ``d (k - 1) - hi`` from its
    end (a negative cut pads zeros)."""
    if isinstance(padding, str):
        raise ValueError(f"padding {padding!r}: a transposed conv takes "
                         "explicit padding (lax refuses a string here)")
    ks = weight.shape[2:]
    full = [d * (k - 1) for k, d in zip(ks, dilation)]
    pads = [(f - p0, f - p1 + op) for (p0, p1), f, op
            in zip(padding, full, output_padding)]
    out = _Conv.apply(x, weight, tuple(stride), (0,) * len(ks),
                      tuple(dilation), groups, True)
    cut = [(lo - f, hi - f) for (lo, hi), f in zip(pads, full)]
    if all(c == (0, 0) for c in cut):
        return out
    return F.pad(out, _flat(cut))


@register("conv1d_transpose", inputs=("x", "weight"))
def _conv1d_transpose(x, weight, *, stride, padding, dilation, groups,
                      output_padding):
    return _conv_transpose(x, weight, stride, padding, dilation, groups,
                           output_padding)


@register("conv2d_transpose", inputs=("x", "weight"))
def _conv2d_transpose(x, weight, *, stride, padding, dilation, groups,
                      output_padding):
    return _conv_transpose(x, weight, stride, padding, dilation, groups,
                           output_padding)


@register("conv3d_transpose", inputs=("x", "weight"))
def _conv3d_transpose(x, weight, *, stride, padding, dilation, groups,
                      output_padding):
    return _conv_transpose(x, weight, stride, padding, dilation, groups,
                           output_padding)


_TRANSPOSES = {1: (_conv1d_transpose, "NLC"), 2: (_conv2d_transpose, "NHWC"),
               3: (_conv3d_transpose, "NDHWC")}


def _output_padding_for(output_size, x_spatial, stride, padding, dilation,
                        ksize):
    """The ``output_padding`` that gives ``output_size`` (Paddle lets
    either pick the transposed conv's output shape)."""
    ops = []
    for out, n, s, (p0, p1), d, k in zip(output_size, x_spatial, stride,
                                         padding, dilation, ksize):
        op = int(out) - ((n - 1) * s - (p0 + p1) + d * (k - 1) + 1)
        if op < 0 or op >= s:
            raise ValueError(
                f"output_size {output_size} unreachable: needs "
                f"output_padding {op} for stride {s}")
        ops.append(op)
    return tuple(ops)


def _transpose_nd(nsp, x, weight, bias, stride, padding, output_padding,
                  dilation, groups, output_size, data_format):
    """``conv.py:134-167``: the channels-last layout transposed to and
    from NC..., ``output_size`` turned into ``output_padding``, the bias
    added through ``reshape`` and ``add``."""
    op, channel_last = _TRANSPOSES[nsp]
    stride, dilation = _pair(stride, nsp), _pair(dilation, nsp)
    pad = _conv_padding(padding, nsp)
    last = data_format == channel_last
    if last:
        x = transpose(x, [0, nsp + 1] + list(range(1, nsp + 1)))
    if output_size is not None:
        if isinstance(pad, str):
            raise ValueError("output_size with SAME/VALID padding is "
                             "ambiguous")
        output_padding = _output_padding_for(
            _pair(output_size, nsp), x.shape[2:], stride, pad, dilation,
            weight.shape[2:])
    else:
        output_padding = _pair(output_padding, nsp)
    out = op(x, weight, stride=stride, padding=pad, dilation=dilation,
             groups=int(groups), output_padding=output_padding)
    if bias is not None:
        out = add(out, reshape(bias, (1, -1) + (1,) * nsp))
    if last:
        out = transpose(out, [0] + list(range(2, nsp + 2)) + [1])
    return out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL"):
    """Transposed 1-D conv of ``x`` (N, C, L) by ``weight`` (C, O /
    groups, k): out = (L - 1) s - p0 - p1 + d (k - 1) + output_padding +
    1."""
    return _transpose_nd(1, x, weight, bias, stride, padding,
                         output_padding, dilation, groups, output_size,
                         data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW"):
    """Transposed 2-D conv of ``x`` (N, C, H, W) by ``weight`` (C, O /
    groups, kh, kw)."""
    return _transpose_nd(2, x, weight, bias, stride, padding,
                         output_padding, dilation, groups, output_size,
                         data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW"):
    """Transposed 3-D conv of ``x`` (N, C, D, H, W) by ``weight`` (C, O /
    groups, kd, kh, kw)."""
    return _transpose_nd(3, x, weight, bias, stride, padding,
                         output_padding, dilation, groups, output_size,
                         data_format)


# -- pooling -----------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _max_pool(x, ksize, stride, padding):
    pads = _pads(padding, x.shape[2:], ksize, stride, (1,) * len(ksize))
    pool = _MAX_POOL[len(ksize)]
    if all(lo == hi and 0 <= lo <= k // 2 for (lo, hi), k in zip(pads,
                                                               ksize)):
        # PyTorch's own padding never wins a window: -inf padding's max
        return pool(x, ksize, stride, tuple(lo for lo, _ in pads))
    low = float("-inf") if x.is_floating_point() else \
        torch.iinfo(x.dtype).min
    return pool(F.pad(x, _flat(pads), value=low), ksize, stride)


@register("max_pool1d", inputs=("x",))
def _max_pool1d(x, *, ksize, stride, padding):
    return _max_pool(x, ksize, stride, padding)


@register("max_pool2d", inputs=("x",))
def _max_pool2d(x, *, ksize, stride, padding):
    return _max_pool(x, ksize, stride, padding)


@register("max_pool3d", inputs=("x",))
def _max_pool3d(x, *, ksize, stride, padding):
    return _max_pool(x, ksize, stride, padding)


def _window(kernel_size, stride, padding, nsp):
    ksize = _pair(kernel_size, nsp)
    stride = ksize if stride is None else _pair(stride, nsp)
    return dict(ksize=ksize, stride=stride,
                padding=_conv_padding(padding, nsp))


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False):
    """Max over ``kernel_size`` windows of ``x`` (N, C, L) at ``stride``
    (default: the window), padded with -inf."""
    return _max_pool1d(x, **_window(kernel_size, stride, padding, 1))


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    """Max over ``kernel_size`` windows of ``x`` (N, C, H, W; or N, H, W,
    C with ``data_format="NHWC"``) at ``stride`` (default: the window),
    padded with -inf. ``ceil_mode`` and ``return_mask`` are taken and
    not read, as in the JAX package (``conv.py:236-247``)."""
    w = _window(kernel_size, stride, padding, 2)
    if data_format != "NCHW":
        out = _max_pool2d(transpose(x, [0, 3, 1, 2]), **w)
        return transpose(out, [0, 2, 3, 1])
    return _max_pool2d(x, **w)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW"):
    """Max over ``kernel_size`` windows of ``x`` (N, C, D, H, W)."""
    return _max_pool3d(x, **_window(kernel_size, stride, padding, 3))


def _window_sums(x, ksize, stride, pads):
    """Sums of ``x``'s windows after zero padding (``F.avg_pool*`` with a
    divisor of 1; the 1-D one through the 2-D pool)."""
    xp = F.pad(x, _flat(pads))
    if len(ksize) == 1:
        return F.avg_pool2d(xp.unsqueeze(2), (1,) + ksize, (1,) + stride,
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if len(ksize) == 2 else F.avg_pool3d
    return pool(xp, ksize, stride, divisor_override=1)


def _avg_pool(x, ksize, stride, padding, count_include_pad):
    """``_pool(..., avg=True)`` (``conv.py:178-193``): window sums over
    the window's size, or (``count_include_pad=False`` with a padding
    that is not ``"VALID"``) over the count of elements in the input."""
    pads = _pads(padding, x.shape[2:], ksize, stride, (1,) * len(ksize))
    sums = _window_sums(x, ksize, stride, pads)
    if count_include_pad or padding == "VALID":
        return sums / float(math.prod(ksize))
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return sums / _window_sums(ones, ksize, stride, pads)


@register("avg_pool1d", inputs=("x",))
def _avg_pool1d(x, *, ksize, stride, padding, count_include_pad=True):
    return _avg_pool(x, ksize, stride, padding, count_include_pad)


@register("avg_pool2d", inputs=("x",))
def _avg_pool2d(x, *, ksize, stride, padding, count_include_pad=True):
    xf = x.float() if x.dtype == torch.bfloat16 else x
    return _avg_pool(xf, ksize, stride, padding,
                     count_include_pad).to(x.dtype)


@register("avg_pool3d", inputs=("x",))
def _avg_pool3d(x, *, ksize, stride, padding, count_include_pad=True):
    xf = x.float() if x.dtype == torch.bfloat16 else x
    return _avg_pool(xf, ksize, stride, padding,
                     count_include_pad).to(x.dtype)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False):
    """Means over ``kernel_size`` windows of ``x`` (N, C, L); with
    ``exclusive`` (the default) the padding does not count."""
    return _avg_pool1d(x, **_window(kernel_size, stride, padding, 1),
                       count_include_pad=not exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               count_include_pad=True, divisor_override=None,
               data_format="NCHW"):
    """Means over ``kernel_size`` windows of ``x`` (N, C, H, W), in
    float32 for a bfloat16 ``x``; the padding counts unless
    ``count_include_pad=False``. ``ceil_mode``, ``divisor_override`` and
    ``data_format`` are taken and not read, as in the JAX package."""
    return _avg_pool2d(x, **_window(kernel_size, stride, padding, 2),
                       count_include_pad=bool(count_include_pad))


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCDHW"):
    """Means over ``kernel_size`` windows of ``x`` (N, C, D, H, W); with
    ``exclusive`` (the default) the padding does not count."""
    return _avg_pool3d(x, **_window(kernel_size, stride, padding, 3),
                       count_include_pad=not exclusive)


def _bins(n, m):
    """The JAX package's adaptive windows: ``m`` of them over ``n``."""
    return [(math.floor(i * n / m), math.ceil((i + 1) * n / m))
            for i in range(m)]


def _adaptive(x, output_size, reduce):
    n, c, h, w = x.shape
    oh, ow = output_size
    if h % oh == 0 and w % ow == 0:
        return reduce(x.reshape(n, c, oh, h // oh, ow, w // ow), (3, 5))
    rows = [torch.stack([reduce(x[:, :, y0:y1, x0:x1], (2, 3))
                         for x0, x1 in _bins(w, ow)], dim=-1)
            for y0, y1 in _bins(h, oh)]
    return torch.stack(rows, dim=-2)


@register("adaptive_avg_pool2d", inputs=("x",))
def _adaptive_avg_pool2d(x, *, output_size):
    return _adaptive(x, output_size, lambda t, d: t.mean(dim=d))


@register("adaptive_max_pool2d", inputs=("x",))
def _adaptive_max_pool2d(x, *, output_size):
    return _adaptive(x, output_size, lambda t, d: torch.amax(t, dim=d))


@register("adaptive_max_pool2d_mask", inputs=("x",))
def _adaptive_max_pool2d_mask(x, *, output_size):
    """``(out, mask)``: the mask holds each window's first largest
    element's flat index ``y * W + x`` (``conv.py:368-391``)."""
    n, c, h, w = x.shape
    outs, idxs = [], []
    for y0, y1 in _bins(h, output_size[0]):
        row_o, row_i = [], []
        for x0, x1 in _bins(w, output_size[1]):
            cell = x[:, :, y0:y1, x0:x1].reshape(n, c, -1)
            flat = torch.argmax(cell, dim=-1)
            cw = x1 - x0
            row_o.append(torch.amax(cell, dim=-1))
            row_i.append((y0 + flat // cw) * w + x0 + flat % cw)
        outs.append(torch.stack(row_o, dim=-1))
        idxs.append(torch.stack(row_i, dim=-1))
    return torch.stack(outs, dim=-2), torch.stack(idxs, dim=-2)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Means of ``x`` (N, C, H, W) over an ``output_size`` grid of
    windows, in x's type; window ``i`` of ``oh`` spans rows ``floor(i *
    H / oh)`` to ``ceil((i + 1) * H / oh)``, as in the JAX package
    (``conv.py:336-352``)."""
    return _adaptive_avg_pool2d(x, output_size=_pair(output_size, 2))


def adaptive_max_pool2d(x, output_size, return_mask=False):
    """Maxima of ``x`` (N, C, H, W) over the adaptive windows; with
    ``return_mask`` also each window's argmax as a flat index into H x
    W."""
    if return_mask:
        return _adaptive_max_pool2d_mask(x,
                                         output_size=_pair(output_size, 2))
    return _adaptive_max_pool2d(x, output_size=_pair(output_size, 2))


def _one(output_size):
    return int(output_size[0] if isinstance(output_size, (list, tuple))
               else output_size)


def adaptive_avg_pool1d(x, output_size):
    """``adaptive_avg_pool2d`` of ``x`` (N, C, L) as (N, C, 1, L)."""
    return squeeze(adaptive_avg_pool2d(unsqueeze(x, 2),
                                       (1, _one(output_size))), 2)


def adaptive_max_pool1d(x, output_size, return_mask=False):
    """``adaptive_max_pool2d`` of ``x`` (N, C, L) as (N, C, 1, L);
    ``return_mask`` is taken and not read, as in the JAX package."""
    return squeeze(adaptive_max_pool2d(unsqueeze(x, 2),
                                       (1, _one(output_size))), 2)


# -- resize, shuffle, unfold, sampling grids ---------------------------------

_F32 = np.float32


def _src_positions(n_in, n_out, align_corners, align_mode):
    """Output pixel -> source coordinate, float32 (``conv.py:421-436``)."""
    dst = np.arange(n_out, dtype=_F32)
    if n_out <= 1:
        return np.zeros(n_out, _F32)
    if align_corners:
        return dst * _F32((n_in - 1) / (n_out - 1))
    if align_mode == 0:
        return (dst + _F32(0.5)) * _F32(n_in / n_out) - _F32(0.5)
    return dst * _F32(n_in / n_out)


def _clamped_positions(n_in, n_out, align_corners, align_mode):
    return np.clip(_src_positions(n_in, n_out, align_corners, align_mode),
                   _F32(0.0), _F32(n_in - 1))


def _cubic_contrib(t, a=_F32(-0.75)):
    """Keys cubic convolution kernel (``conv.py:445-451``), float32."""
    t = np.abs(t)
    w1 = ((a + _F32(2.0)) * t - (a + _F32(3.0))) * t * t + _F32(1.0)
    w2 = a * (((t - _F32(5.0)) * t + _F32(8.0)) * t - _F32(4.0))
    return np.where(t <= 1.0, w1, np.where(t < 2.0, w2, _F32(0.0)))


@functools.lru_cache(maxsize=None)
def _resize_weights_np(n_in, n_out, align_corners, align_mode, mode):
    """The ``(n_out, n_in)`` float32 interpolation matrix of one axis, as
    ``_resize_weights`` (``conv.py:454-495``) makes it: positions clamp
    into ``[0, in - 1]`` and out-of-range taps add at the clamped
    index."""
    rows = np.arange(n_out)
    W = np.zeros((n_out, n_in), _F32)
    if mode == "nearest":
        pos = _clamped_positions(n_in, n_out, align_corners, 1)
        idx = np.floor(pos + _F32(0.5 if align_corners else 0.0))
        W[rows, np.clip(idx.astype(np.int32), 0, n_in - 1)] = 1.0
        return W
    if mode == "cubic":
        pos = _src_positions(n_in, n_out, align_corners, 0)
        lo = np.floor(pos).astype(np.int32)
        for tap in (-1, 0, 1, 2):
            i = lo + tap
            np.add.at(W, (rows, np.clip(i, 0, n_in - 1)),
                      _cubic_contrib(pos - i.astype(_F32)).astype(_F32))
        return W
    pos = _clamped_positions(n_in, n_out, align_corners, align_mode)
    lo = np.floor(pos).astype(np.int32)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = pos - lo.astype(_F32)
    np.add.at(W, (rows, lo), _F32(1.0) - frac)
    np.add.at(W, (rows, hi), frac)
    return W


_WEIGHTS = {}


def _resize_weights(n_in, n_out, align_corners, align_mode, mode, device):
    """``_resize_weights_np`` on ``device``, made once a device: a CUDA
    graph captured after the first call reads the same tensor."""
    key = (n_in, n_out, align_corners, align_mode, mode, str(device))
    if key not in _WEIGHTS:
        _WEIGHTS[key] = torch.from_numpy(_resize_weights_np(
            n_in, n_out, align_corners, align_mode, mode)).to(device)
    return _WEIGHTS[key]


_AXIS_MODE = {"nearest": "nearest", "linear": "linear",
              "bilinear": "linear", "trilinear": "linear",
              "bicubic": "cubic", "area": "linear"}


@register("interpolate", inputs=("x",))
def _interpolate(x, *, size, mode, align_corners, align_mode=1):
    """N-spatial-axis resize as one matmul per axis in float32
    (``conv.py:498-520``), cast back to x's type."""
    spatial = x.shape[2:]
    if len(size) != len(spatial):
        raise ValueError(f"size {size} does not match the {len(spatial)} "
                         f"spatial dims of {tuple(x.shape)}")
    out = x.float()
    for ax, (n_in, n_out) in enumerate(zip(spatial, size)):
        W = _resize_weights(n_in, n_out, bool(align_corners),
                            int(align_mode), _AXIS_MODE[mode], x.device)
        out = torch.matmul(out.movedim(2 + ax, -1), W.t()).movedim(-1,
                                                                   2 + ax)
    return out.to(x.dtype)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW"):
    """Resize the spatial axes of ``x`` (NCL, NCHW, NCDHW) to ``size``, or
    by ``scale_factor`` (``int(n * factor)``), with ``mode`` ``nearest``,
    ``linear``/``bilinear``/``trilinear``, ``bicubic`` or ``area`` (taken
    as linear, as the JAX package takes it); ``align_mode`` 0 takes
    half-pixel centres, 1 ``dst * in / out``. ``data_format`` is taken
    and not read, as in the JAX package."""
    if size is None:
        nsp = x.dim() - 2
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else (scale_factor,) * nsp
        size = tuple(int(x.shape[2 + i] * sf[i]) for i in range(nsp))
    elif isinstance(size, torch.Tensor):
        size = tuple(int(v) for v in size.tolist())
    else:
        size = tuple(int(s) for s in size)
    return _interpolate(x, size=size, mode=mode,
                        align_corners=bool(align_corners),
                        align_mode=int(align_mode))


upsample = interpolate


@register("pixel_shuffle", inputs=("x",))
def _pixel_shuffle(x, *, upscale_factor):
    n, c, h, w = x.shape
    r = upscale_factor
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    """(N, C r², H, W) -> (N, C, H r, W r)."""
    return _pixel_shuffle(x, upscale_factor=int(upscale_factor))


@register("unfold", inputs=("x",))
def _unfold(x, *, ksize, stride, padding, dilation):
    return F.unfold(x, ksize, dilation=dilation, padding=padding[:2],
                    stride=stride)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: (N, C, H, W) -> (N, C kh kw, L), channel-major, the
    padding the first two of ``paddings`` (as in the JAX package)."""
    return _unfold(x, ksize=_pair(kernel_sizes, 2), stride=_pair(strides, 2),
                   padding=_pair(paddings, 2), dilation=_pair(dilations, 2))


@register("affine_grid", inputs=("theta",))
def _affine_grid(theta, *, out_h, out_w, align_corners):
    kw = dict(dtype=torch.float32, device=theta.device)
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, out_h, **kw)
        xs = torch.linspace(-1.0, 1.0, out_w, **kw)
    else:
        ys = (torch.arange(out_h, **kw) * 2.0 + 1.0) / out_h - 1.0
        xs = (torch.arange(out_w, **kw) * 2.0 + 1.0) / out_w - 1.0
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([xg, yg, torch.ones_like(xg)], dim=-1)
    return torch.einsum("hwk,nik->nhwi", base.to(theta.dtype), theta)


def affine_grid(theta, out_shape, align_corners=True):
    """The sampling grid (N, H, W, 2) of the affine maps ``theta`` (N, 2,
    3) over ``out_shape`` [N, C, H, W], in normalised [-1, 1] xy."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    return _affine_grid(theta, out_h=int(out_shape[2]),
                        out_w=int(out_shape[3]),
                        align_corners=bool(align_corners))


def _reflect(v, lo, hi):
    """Triangular-wave reflection into [lo, hi] (``conv.py:660-666``)."""
    rng = hi - lo
    return rng - torch.abs(torch.remainder(v - lo, 2 * rng + 1e-12)
                           - rng) + lo


@register("grid_sample", inputs=("x", "grid"))
def _grid_sample(x, grid, *, mode, padding_mode, align_corners):
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1.0) * 0.5 * (w - 1)
        fy = (gy + 1.0) * 0.5 * (h - 1)
    else:
        fx = ((gx + 1.0) * w - 1.0) * 0.5
        fy = ((gy + 1.0) * h - 1.0) * 0.5
    if padding_mode == "border":
        fx, fy = fx.clamp(0.0, w - 1.0), fy.clamp(0.0, h - 1.0)
    elif padding_mode == "reflection":
        if align_corners:
            fx, fy = _reflect(fx, 0.0, w - 1.0), _reflect(fy, 0.0, h - 1.0)
        else:
            fx = _reflect(fx, -0.5, w - 0.5)
            fy = _reflect(fy, -0.5, h - 0.5)
        fx, fy = fx.clamp(0.0, w - 1.0), fy.clamp(0.0, h - 1.0)
    flat = x.reshape(n, c, h * w)

    def tap(ix, iy):
        """x at (iy, ix), 0 outside: (N, C, H', W')."""
        inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        idx = (iy.clamp(0, h - 1).long() * w
               + ix.clamp(0, w - 1).long()).reshape(n, 1, -1)
        v = flat.gather(2, idx.expand(n, c, idx.shape[-1]))
        return v.reshape(n, c, *ix.shape[1:]) * inb[:, None].to(x.dtype)

    if mode == "nearest":
        return tap(torch.round(fx), torch.round(fy))
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx = (fx - x0).to(x.dtype)[:, None]
    wy = (fy - y0).to(x.dtype)[:, None]
    return (tap(x0, y0) * (1 - wx) * (1 - wy) + tap(x0 + 1, y0) * wx
            * (1 - wy) + tap(x0, y0 + 1) * (1 - wx) * wy
            + tap(x0 + 1, y0 + 1) * wx * wy)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """``x`` (N, C, H, W) sampled at ``grid`` (N, H', W', 2; xy in [-1,
    1]): (N, C, H', W'); ``mode`` ``bilinear`` or ``nearest``,
    ``padding_mode`` ``zeros``, ``border`` or ``reflection``."""
    return _grid_sample(x, grid, mode=mode, padding_mode=padding_mode,
                        align_corners=bool(align_corners))
