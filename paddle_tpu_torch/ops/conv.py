"""Convolution and pooling: ``conv2d``, ``max_pool2d`` and
``adaptive_avg_pool2d``.

The counterparts of ``paddle_tpu/ops/conv.py``'s (``:21-76``,
``:206-246``, ``:336-352``), which compute every one of these outside
any Pallas kernel (``lax.conv_general_dilated``, ``lax.reduce_window``,
a reshape-mean): so here they are PyTorch's own operators, with no
kernel of this package under them. Layouts are the JAX package's
default ones: ``x`` NCHW, the weight OIHW (Paddle's convention); the
channels-last forms it also takes are not ported.

``conv2d`` runs in the input's type with float32 accumulation and no
``preferred_element_type`` (``conv.py:27-30``), forward and backward
through cuDNN with ``benchmark=False``, ``deterministic=True`` and
``allow_tf32=False``, set around each call and put back after it
(``_cudnn``): so a float32 conv on the card is a float32 conv, not a
TF32 one (cuDNN's default), and the backward, which autograd runs long
after the forward returned, is repeatable from run to run as the
forward is. ``_Conv2d`` is the ``torch.autograd.Function`` that wraps
both calls. ``max_pool2d`` pads with -inf; its gradient goes to the
first largest element of a window in row-major order, where the JAX
package's ``reduce_window`` max transpose sends it (constructed ties
are tested). ``adaptive_avg_pool2d`` is a reshape-mean in the input's
type where the input divides evenly (ResNet's global 7 x 7 -> 1 x 1),
else a mean per window.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._base import register
from .manipulation import reshape
from .math import add

__all__ = ["conv2d", "max_pool2d", "adaptive_avg_pool2d"]


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


def _cudnn():
    """cuDNN as the port's convs take it: on, no benchmarking,
    deterministic algorithms only, no TF32; the caller's flags are put
    back on exit."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class _Conv2d(torch.autograd.Function):
    """``aten.convolution`` forward, ``aten.convolution_backward`` for
    dx and dw, each under ``_cudnn``."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.args = (stride, padding, dilation, groups)
        with _cudnn():
            return torch.ops.aten.convolution(
                x, weight, None, stride, padding, dilation, False, (0, 0),
                groups)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.args
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _cudnn():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                grad, x, weight, None, stride, padding, dilation, False,
                (0, 0), groups, mask)
        return dx, dw, None, None, None, None


@register("conv2d", inputs=("x", "weight"))
def _conv2d(x, weight, *, stride, padding, dilation, groups,
            data_format="NCHW"):
    """The convolution without its bias, as the JAX package's op
    ``conv2d`` (``conv.py:50-57``): ``padding`` normalised by
    ``_conv_padding``. ``data_format`` is taken as the JAX op takes it,
    so a bundle the JAX package saved loads here; only ``"NCHW"`` is
    ported."""
    if data_format != "NCHW":
        raise NotImplementedError(
            f"conv2d data_format={data_format!r}: only NCHW is ported")
    pads = _pads(padding, x.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        even = tuple(lo for lo, _ in pads)
    else:
        (t, b), (l, r) = pads
        x, even = F.pad(x, (l, r, t, b)), (0, 0)
    return _Conv2d.apply(x, weight, stride, even, dilation, groups)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """2-D convolution of ``x`` (N, C, H, W) by ``weight`` (O, C / groups,
    kh, kw), plus ``bias`` (O,) when given. Padding as Paddle takes it:
    an int, one per axis, ``(top, bottom, left, right)``, pairs, or
    ``"SAME"``/``"VALID"``; an uneven padding is applied to ``x`` first
    (zeros), an even one by the convolution. The bias goes through the
    registered ``reshape`` and ``add``, as in the JAX package
    (``conv.py:72-76``), so a static program records them with their
    attributes."""
    out = _conv2d(x, weight, stride=_pair(stride, 2),
                  padding=_conv_padding(padding, 2),
                  dilation=_pair(dilation, 2), groups=int(groups),
                  data_format="NCHW")
    return out if bias is None else add(out, reshape(bias, (1, -1, 1, 1)))


def max_pool2d(x, kernel_size, stride=None, padding=0):
    """Max over ``kernel_size`` windows of ``x`` (N, C, H, W) at ``stride``
    (default: the window), padded with -inf. (The JAX package's
    ``ceil_mode`` is taken there and not read; the port does not take
    it.)"""
    ksize = _pair(kernel_size, 2)
    stride = ksize if stride is None else _pair(stride, 2)
    return _max_pool2d(x, ksize=ksize, stride=stride,
                       padding=_conv_padding(padding, 2))


@register("max_pool2d", inputs=("x",))
def _max_pool2d(x, *, ksize, stride, padding):
    pads = _pads(padding, x.shape[2:], ksize, stride, (1, 1))
    if all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, ksize)):
        # PyTorch's own padding never wins a window: -inf padding's max
        return F.max_pool2d(x, ksize, stride, tuple(lo for lo, _ in pads))
    (t, b), (l, r) = pads
    x = F.pad(x, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(x, ksize, stride)


def adaptive_avg_pool2d(x, output_size):
    """Means of ``x`` (N, C, H, W) over an ``output_size`` grid of
    windows, in x's type. Window ``i`` of ``oh`` spans rows
    ``floor(i * H / oh)`` to ``ceil((i + 1) * H / oh)``, as in the JAX
    package (``conv.py:344-348``)."""
    n, c, h, w = x.shape
    oh, ow = _pair(output_size, 2)
    if h % oh == 0 and w % ow == 0:
        return x.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    ys = [(math.floor(i * h / oh), math.ceil((i + 1) * h / oh))
          for i in range(oh)]
    xs = [(math.floor(j * w / ow), math.ceil((j + 1) * w / ow))
          for j in range(ow)]
    rows = [torch.stack([x[:, :, y0:y1, x0:x1].mean(dim=(2, 3))
                         for x0, x1 in xs], dim=-1) for y0, y1 in ys]
    return torch.stack(rows, dim=-2)
