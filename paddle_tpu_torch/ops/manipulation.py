"""Shape ops: ``reshape``, ``flatten``, ``transpose``, ``concat``,
``split``, ``stack``, ``squeeze``/``unsqueeze`` and ``pad``, the
counterparts of ``paddle_tpu/ops/manipulation.py``'s (``:23-135``,
``:349-378``). The rest of that module comes with the tensor API."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._base import register

__all__ = ["reshape", "flatten", "transpose", "concat", "split", "stack",
           "squeeze", "unsqueeze", "pad"]


@register("reshape", inputs=("x",))
def _reshape(x, *, shape):
    return torch.reshape(x, shape)


def reshape(x, shape):
    """``x`` in ``shape`` (one ``-1`` dim is inferred)."""
    return _reshape(x, shape=tuple(int(s) for s in shape))


@register("flatten", inputs=("x",))
def flatten(x, start_axis=0, stop_axis=-1):
    """``x`` with axes ``start_axis`` to ``stop_axis`` (both included)
    merged into one."""
    return torch.flatten(x, start_axis, stop_axis)


@register("transpose", inputs=("x",))
def _transpose(x, *, perm):
    return x.permute(perm)


def transpose(x, perm=None):
    """``x`` with its axes in the order ``perm`` (default: reversed)."""
    if perm is None:
        perm = range(x.dim() - 1, -1, -1)
    return _transpose(x, perm=tuple(int(p) for p in perm))


@register("concat", inputs=("xs",))
def _concat(*xs, axis=0):
    return torch.cat(xs, dim=axis)


def concat(x, axis=0):
    """The tensors of the list ``x`` joined along ``axis``."""
    return _concat(*x, axis=int(axis))


@register("stack", inputs=("xs",))
def _stack(*xs, axis=0):
    return torch.stack(xs, dim=axis)


def stack(x, axis=0):
    """The tensors of the list ``x`` stacked along a new ``axis``."""
    return _stack(*x, axis=int(axis))


@register("split", inputs=("x",))
def _split(x, *, sections, axis):
    if isinstance(sections, int):
        return torch.chunk(x, sections, dim=axis)
    return torch.split(x, list(sections), dim=axis)


def split(x, num_or_sections, axis=0):
    """``x`` cut along ``axis`` into ``num_or_sections`` equal parts, or
    parts of the listed sizes (one ``-1`` takes the rest); a list."""
    axis = int(axis)
    if isinstance(num_or_sections, (list, tuple)):
        secs = [int(s) for s in num_or_sections]
        if -1 in secs:
            rest = x.shape[axis] - sum(s for s in secs if s != -1)
            secs = [rest if s == -1 else s for s in secs]
        return list(_split(x, sections=tuple(secs), axis=axis))
    n = int(num_or_sections)
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of size {x.shape[axis]} does not "
                         f"split into {n} equal parts")
    return list(_split(x, sections=n, axis=axis))


@register("squeeze", inputs=("x",))
def _squeeze(x, *, axis=None):
    return x.squeeze() if axis is None else x.squeeze(axis)


def squeeze(x, axis=None):
    """``x`` without its size-1 axes (all of them, or those of ``axis``
    that have size 1; another axis is left as it is)."""
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis if x.shape[a] == 1) or None
    elif axis is not None and x.shape[axis] != 1:
        return x
    return _squeeze(x, axis=axis)


@register("unsqueeze", inputs=("x",))
def _unsqueeze(x, *, axis):
    if isinstance(axis, int):
        return x.unsqueeze(axis)
    nd = x.dim() + len(axis)
    for a in sorted(a % nd for a in axis):
        x = x.unsqueeze(a)
    return x


def unsqueeze(x, axis):
    """``x`` with a size-1 axis inserted at ``axis`` (or at each of a
    list's positions in the result, as ``jnp.expand_dims``)."""
    axis = tuple(int(a) for a in axis) if isinstance(axis, (list, tuple)) \
        else int(axis)
    return _unsqueeze(x, axis=axis)


_PAD_MODES = ("constant", "reflect", "replicate", "circular")


def _pad_axis(x, d, lo, hi, mode):
    """``x`` padded along axis ``d`` by ``lo`` and ``hi`` in a mode other
    than ``constant``, from slices of ``x`` (``jnp.pad``'s ``reflect``,
    ``edge``, ``wrap``): the backward sums in a fixed order, where
    ``F.pad``'s reflection and replication backwards add with atomics on
    the card."""
    n = x.shape[d]
    if mode == "reflect":
        parts = [x.narrow(d, 1, lo).flip(d), x,
                 x.narrow(d, n - 1 - hi, hi).flip(d)]
    elif mode == "replicate":
        parts = [x.narrow(d, 0, 1)] * lo + [x] + [x.narrow(d, n - 1, 1)] * hi
    else:   # circular
        parts = [x.narrow(d, n - lo, lo), x, x.narrow(d, 0, hi)]
    return torch.cat(parts, dim=d)


@register("pad", inputs=("x",))
def _pad(x, *, paddings, mode="constant", value=0.0):
    if mode == "constant":
        flat = [w for lo_hi in reversed(paddings) for w in lo_hi]
        return F.pad(x, flat, mode="constant", value=value)
    # axis by axis, each padding the last one's result, as jnp.pad does
    for d, (lo, hi) in enumerate(paddings):
        if lo or hi:
            x = _pad_axis(x, d, lo, hi, mode)
    return x


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    """Paddle's ``pad``: ``2 * ndim`` entries pad every axis in order
    (``[d0_lo, d0_hi, d1_lo, ...]``); fewer pad the spatial axes from
    the last one back (``[left, right, top, bottom, ...]``), which sit
    after the channel axis for ``NC*`` layouts and before it for
    ``N*C`` ones. ``mode``: ``constant`` (``value``), ``reflect``,
    ``replicate``, ``circular``."""
    nd = x.dim()
    pad = [int(p) for p in pad]
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        nspatial = len(pad) // 2
        widths = [(0, 0)] * nd
        if data_format.upper().endswith("C"):
            spatial = list(range(1, 1 + nspatial))
        else:
            spatial = list(range(nd - nspatial, nd))
        for i, d in enumerate(reversed(spatial)):
            widths[d] = (pad[2 * i], pad[2 * i + 1])
    if mode not in _PAD_MODES:
        raise ValueError(f"pad mode {mode!r} (one of {_PAD_MODES})")
    return _pad(x, paddings=tuple(widths), mode=mode, value=float(value))
