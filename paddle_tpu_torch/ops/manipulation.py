"""Shape, layout, gather and scatter ops, the counterparts of
``paddle_tpu/ops/manipulation.py``'s: ``reshape`` ... ``pad`` (the shape
ops the layers call), ``t``, ``chunk``, ``unbind``, ``slice``,
``strided_slice``, the gathers (``gather``, ``gather_nd``,
``take_along_axis``, ``index_select``, ``index_sample``), the scatters
(``scatter``, ``scatter_nd``, ``scatter_nd_add``, ``put_along_axis``),
``tile``, ``expand``/``broadcast_to``/``expand_as``,
``repeat_interleave``, ``flip``, ``roll``, ``where``, ``topk``,
``sort``/``argsort``, ``one_hot``, ``cast``, ``masked_fill``,
``moveaxis``, ``swapaxes``, ``rot90``, ``shard_index``,
``as_real``/``as_complex``, and the ops whose output shape depends on
the data (``nonzero``, ``masked_select``, ``unique``, ``bincount``),
which compute on the tensor's device and read the shape back (a host
sync, as the JAX package's do, ``:471-516``).

The JAX package's rules are kept where torch's differ:

- ``scatter(overwrite=True)`` with a repeated index: the last write wins
  (``scatter(zeros(4), [1, 1, 2], [5, 7, 9])`` is ``[0, 7, 9, 0]``), and
  only that update takes a gradient. ``index_put_``/``scatter_`` give no
  order on the card, so every write to a slot carries the winner's
  value (``_scatter``); the same holds for ``put_along_axis``'s
  ``assign``;
- ``argsort(descending=True)`` and ``sort(descending=True)`` are the
  ascending stable sort flipped, so ties come out last index first
  (``[3, 1, 3, 2, 3]`` gives ``[4, 2, 0, 3, 1]``), where torch's stable
  descending sort gives ``[0, 2, 4, 3, 1]``;
- ``topk`` puts the lower index first among ties, as ``lax.top_k``
  does: a stable sort, where ``torch.topk`` on the card gives no order;
- the gathers' backwards, the accumulating scatters and ``bincount``'s
  weighted counts add repeated indices with ``index_put_`` in PyTorch's
  deterministic mode (``_args.deterministic``: sorted, one order), not
  with atomics.

Indices come out ``int64`` (Paddle's type; the JAX package's are
``int32``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._args import deterministic, dtype_of, norm_axis, tensor
from ._base import register

__all__ = ["reshape", "flatten", "transpose", "concat", "split", "stack",
           "squeeze", "unsqueeze", "pad", "t", "chunk", "unbind", "slice",
           "strided_slice", "gather", "gather_nd", "take_along_axis",
           "index_select", "index_sample", "scatter", "scatter_nd",
           "scatter_nd_add", "put_along_axis", "tile", "expand",
           "broadcast_to", "expand_as", "repeat_interleave", "flip", "roll",
           "where", "topk", "sort", "argsort", "one_hot", "cast", "nonzero",
           "masked_select", "unique", "masked_fill", "bincount", "moveaxis",
           "swapaxes", "rot90", "shard_index", "as_real", "as_complex"]


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


def t(x, name=None):
    """``x`` with its two axes swapped (a 0-d or 1-d ``x`` as it is)."""
    return x if x.dim() < 2 else _transpose(x, perm=(1, 0))


def chunk(x, chunks, axis=0, name=None):
    """``split(x, chunks, axis)``."""
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    """The slices of ``x`` along ``axis``, that axis dropped."""
    axis = int(axis)
    return [squeeze(p, axis) for p in split(x, x.shape[axis], axis)]


_SLICE = slice


def _strided(n, start, end, step):
    """Python's ``start:end:step`` over ``n`` as ``(first, count,
    step)``."""
    r = range(*_SLICE(start, end, step).indices(n))
    return (r.start if len(r) else 0), len(r), step


@register("slice_op", inputs=("x",))
def _slice_op(x, *, axes, starts, ends):
    for ax, s, e in zip(axes, starts, ends):
        first, count, _ = _strided(x.shape[ax], s, e, 1)
        x = x.narrow(ax, first, count)
    return x


def slice(x, axes, starts, ends):
    """``x[starts[i]:ends[i]]`` along each of ``axes`` (Python's rules
    for negative and out-of-range bounds)."""
    item = lambda v: int(v.item()) if isinstance(v, torch.Tensor) \
        else int(v)
    return _slice_op(x, axes=tuple(int(a) for a in axes),
                     starts=tuple(item(s) for s in starts),
                     ends=tuple(item(e) for e in ends))


@register("strided_slice", inputs=("x",))
def _strided_slice(x, *, axes, starts, ends, strides):
    for ax, s, e, st in zip(axes, starts, ends, strides):
        n = x.shape[ax]
        first, count, step = _strided(n, s, e, st)
        if step < 0:   # torch slices forward only: flip, then step on
            x, first, step = x.flip(ax), n - 1 - first, -step
        x = x.narrow(ax, first, (count - 1) * step + 1 if count else 0)
        x = x[(_SLICE(None),) * (ax % x.dim()) + (_SLICE(None, None, step),)]
    return x


def strided_slice(x, axes, starts, ends, strides, name=None):
    """``x[starts[i]:ends[i]:strides[i]]`` along each of ``axes``;
    a negative stride walks backwards."""
    return _strided_slice(x, axes=tuple(int(a) for a in axes),
                          starts=tuple(int(s) for s in starts),
                          ends=tuple(int(e) for e in ends),
                          strides=tuple(int(s) for s in strides))


# -- gathers: linear indices into the flattened x -----------------------------

class _Take(torch.autograd.Function):
    """The flattened ``x`` at the linear indices ``lin`` (any shape). The
    backward adds the gradient of repeated indices with ``index_put_`` in
    deterministic mode."""

    @staticmethod
    def forward(ctx, x, lin):
        ctx.shape = x.shape
        ctx.save_for_backward(lin)
        return x.reshape(-1)[lin]

    @staticmethod
    def backward(ctx, g):
        (lin,) = ctx.saved_tensors
        out = g.new_zeros(math.prod(ctx.shape))
        with deterministic():
            out.index_put_((lin.reshape(-1),), g.reshape(-1),
                           accumulate=True)
        return out.reshape(ctx.shape), None


def _wrap(index, n):
    """Indices with a negative one counted from the end, as ``jnp``
    takes them."""
    index = index.long()
    return torch.where(index < 0, index + n, index)


def _strides(shape):
    out, acc = [], 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return out[::-1]


def _lin_axis(shape, index, axis):
    """Linear indices of ``jnp.take(x, index, axis)`` for an ``x`` of
    ``shape``: shape ``shape[:axis] + index.shape + shape[axis + 1:]``."""
    pre, post = math.prod(shape[:axis]), math.prod(shape[axis + 1:])
    dev = index.device
    idx = _wrap(index, shape[axis]).reshape(1, -1, 1)
    lin = (torch.arange(pre, device=dev).reshape(-1, 1, 1) * shape[axis]
           + idx) * post + torch.arange(post, device=dev).reshape(1, 1, -1)
    return lin.reshape(tuple(shape[:axis]) + tuple(index.shape)
                       + tuple(shape[axis + 1:]))


def _lin_along(shape, index, axis, out_shape=None):
    """Linear indices of ``jnp.take_along_axis(x, index, axis)`` (with
    ``out_shape``: of ``x.at[index along axis]`` over ``out_shape``)."""
    nd = len(shape)
    axis %= nd
    if out_shape is None:
        out_shape = torch.broadcast_shapes(
            tuple(index.shape[axis] if d == axis else s
                  for d, s in enumerate(shape)), tuple(index.shape))
    lin = None
    for d, stride in enumerate(_strides(shape)):
        if d == axis:
            i = _wrap(index, shape[d])
        elif shape[d] == out_shape[d]:
            i = torch.arange(out_shape[d], device=index.device).reshape(
                [-1 if k == d else 1 for k in range(nd)])
        else:
            continue       # a broadcast axis of x: index 0
        lin = i * stride if lin is None else lin + i * stride
    return lin.expand(out_shape)


def _lin_nd(shape, index):
    """Linear indices of ``x[tuple(moveaxis(index, -1, 0))]``: shape
    ``index.shape[:-1] + shape[k:]`` for ``k = index.shape[-1]``."""
    k = index.shape[-1]
    block = math.prod(shape[k:])
    strides = _strides(shape[:k])
    lin = torch.zeros(index.shape[:-1], dtype=torch.long,
                      device=index.device)
    for d in range(k):
        lin = lin + _wrap(index[..., d], shape[d]) * strides[d]
    lin = lin.unsqueeze(-1) * block + torch.arange(block,
                                                   device=index.device)
    return lin.reshape(tuple(index.shape[:-1]) + tuple(shape[k:]))


@register("gather", inputs=("x", "index"))
def _gather(x, index, *, axis=0):
    if index.dim() == 0:
        index = index.reshape(1)
    return _Take.apply(x, _lin_axis(x.shape, index, axis % x.dim()))


def gather(x, index, axis=0, name=None):
    """``x``'s slices along ``axis`` at ``index`` (a 0-d index gives a
    1-long axis)."""
    return _gather(x, tensor(index, x, torch.int64), axis=int(norm_axis(
        axis)))


@register("gather_nd", inputs=("x", "index"))
def _gather_nd(x, index):
    return _Take.apply(x, _lin_nd(x.shape, index))


def gather_nd(x, index, name=None):
    """``x`` at the leading coordinates held in ``index``'s last axis."""
    return _gather_nd(x, tensor(index, x, torch.int64))


@register("take_along_axis", inputs=("x", "index"))
def _take_along_axis(x, index, *, axis):
    return _Take.apply(x, _lin_along(x.shape, index, axis))


def take_along_axis(x, indices, axis, name=None):
    """``x`` at ``indices`` along ``axis``, the other axes broadcast."""
    return _take_along_axis(x, tensor(indices, x, torch.int64),
                            axis=int(axis))


@register("index_select", inputs=("x", "index"))
def _index_select(x, index, *, axis=0):
    return _Take.apply(x, _lin_axis(x.shape, index, axis % x.dim()))


def index_select(x, index, axis=0, name=None):
    """``x``'s slices along ``axis`` at ``index``."""
    return _index_select(x, tensor(index, x, torch.int64), axis=int(axis))


@register("index_sample", inputs=("x", "index"))
def _index_sample(x, index):
    return _Take.apply(x, _lin_along(x.shape, index, 1))


def index_sample(x, index, name=None):
    """Row ``i`` of ``x`` at ``index[i]``: ``take_along_axis(x, index,
    1)``."""
    return _index_sample(x, tensor(index, x, torch.int64))


# -- scatters -------------------------------------------------------------------

def _scatter(x, lin, vals, how):
    """``x`` with the values ``vals`` written at the linear indices
    ``lin`` (same shape): ``set`` (the last of a repeated index wins, and
    only it takes a gradient), ``add`` or ``multiply``."""
    flat = x.reshape(-1)
    lin, vals = lin.reshape(-1), vals.to(x.dtype).reshape(-1)
    if how == "add":
        with deterministic():
            out = flat.index_put((lin,), vals, accumulate=True)
    elif how == "multiply":
        out = flat.scatter_reduce(0, lin, vals, "prod")
    else:
        order = torch.arange(lin.numel(), device=lin.device)
        last = torch.full_like(flat, -1, dtype=torch.long).scatter_reduce(
            0, lin, order, "amax")
        win = last[lin]
        vals = torch.where(win == order, vals, vals[win].detach())
        out = flat.index_put((lin,), vals)
    return out.reshape(x.shape)


@register("scatter", inputs=("x", "index", "updates"))
def _scatter_op(x, index, updates, *, overwrite=True):
    index = index.reshape(-1)
    block = math.prod(x.shape[1:])
    lin = _wrap(index, x.shape[0]).unsqueeze(-1) * block + torch.arange(
        block, device=index.device)
    vals = updates.expand((index.numel(),) + tuple(x.shape[1:]))
    return _scatter(x, lin, vals, "set" if overwrite else "add")


def scatter(x, index, updates, overwrite=True, name=None):
    """``x`` with its rows ``index`` set to (``overwrite``) or added
    ``updates``; with ``overwrite`` the last update of a repeated index
    wins."""
    return _scatter_op(x, tensor(index, x, torch.int64), tensor(updates, x),
                       overwrite=bool(overwrite))


@register("scatter_nd_add", inputs=("x", "index", "updates"))
def _scatter_nd_add(x, index, updates):
    lin = _lin_nd(x.shape, index)
    return _scatter(x, lin, updates.expand(lin.shape), "add")


def scatter_nd_add(x, index, updates, name=None):
    """``x`` with ``updates`` added at the leading coordinates of
    ``index``'s last axis (repeated ones add up)."""
    return _scatter_nd_add(x, tensor(index, x, torch.int64),
                           tensor(updates, x))


def scatter_nd(index, updates, shape, name=None):
    """``scatter_nd_add`` into zeros of ``shape``."""
    updates = tensor(updates)
    zeros = torch.zeros([int(s) for s in shape], dtype=updates.dtype,
                        device=updates.device)
    return scatter_nd_add(zeros, index, updates)


@register("put_along_axis", inputs=("x", "index", "value"))
def _put_along_axis(x, index, value, *, axis, reduce="assign"):
    lin = _lin_along(x.shape, index, axis, out_shape=tuple(index.shape))
    how = {"add": "add", "multiply": "multiply"}.get(reduce, "set")
    return _scatter(x, lin, value.expand(index.shape), how)


def put_along_axis(x, index, value, axis, reduce="assign", name=None):
    """``x`` with ``value`` (broadcast to ``index``'s shape) put at
    ``index`` along ``axis``: ``assign`` (the last of a repeated index
    wins), ``add`` or ``multiply``; any other ``reduce`` assigns, as in
    the JAX package."""
    return _put_along_axis(x, tensor(index, x, torch.int64),
                           tensor(value, x), axis=int(axis),
                           reduce=str(reduce))


# -- tiling and broadcasting ----------------------------------------------------

@register("tile", inputs=("x",))
def _tile(x, *, repeat_times):
    return torch.tile(x, repeat_times)


def tile(x, repeat_times, name=None):
    """``x`` repeated ``repeat_times[i]`` times along each axis (a short
    list pads with 1s in front, as ``jnp.tile``)."""
    if isinstance(repeat_times, torch.Tensor):
        repeat_times = repeat_times.tolist()
    return _tile(x, repeat_times=tuple(int(r) for r in repeat_times))


@register("expand", inputs=("x",))
def _expand(x, *, shape):
    lead = len(shape) - x.dim()
    shape = tuple(x.shape[i - lead] if s in (-1, None) and i >= lead else s
                  for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


def expand(x, shape, name=None):
    """``x`` broadcast to ``shape`` (``-1`` keeps ``x``'s size)."""
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return _expand(x, shape=tuple(int(s) for s in shape))


broadcast_to = expand


def expand_as(x, y, name=None):
    """``x`` broadcast to ``y``'s shape."""
    return expand(x, tuple(y.shape))


@register("repeat_interleave", inputs=("x",))
def _repeat_interleave(x, *, repeats, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis %= x.dim()
    shape = list(x.shape)
    y = x.unsqueeze(axis + 1).expand(
        shape[:axis + 1] + [repeats] + shape[axis + 1:])
    return y.reshape(shape[:axis] + [shape[axis] * repeats]
                     + shape[axis + 1:])


def repeat_interleave(x, repeats, axis=None, name=None):
    """Each element of ``x`` repeated ``repeats`` times along ``axis``
    (``None``: of the flattened ``x``)."""
    return _repeat_interleave(x, repeats=int(repeats),
                              axis=None if axis is None else int(axis))


@register("flip", inputs=("x",))
def _flip(x, *, axis):
    return torch.flip(x, axis)


def flip(x, axis, name=None):
    """``x`` reversed along ``axis`` (an int or a list)."""
    axis = tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),)
    return _flip(x, axis=axis)


@register("roll", inputs=("x",))
def _roll(x, *, shifts, axis=None):
    return torch.roll(x, shifts, axis)


def roll(x, shifts, axis=None, name=None):
    """``x`` rolled by ``shifts`` along ``axis`` (``None``: the flattened
    ``x``, reshaped back)."""
    shifts = tuple(int(s) for s in shifts) if isinstance(
        shifts, (list, tuple)) else int(shifts)
    return _roll(x, shifts=shifts, axis=norm_axis(axis))


@register("where", inputs=("cond", "x", "y"))
def _where(cond, x, y):
    return torch.where(cond, x, y)


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition`` holds, else ``y``; with neither,
    ``nonzero(condition, as_tuple=True)``."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    like = x if isinstance(x, torch.Tensor) else y
    if not isinstance(like, torch.Tensor):
        like = tensor(x, condition, torch.float32)
    return _where(condition, tensor(x, like), tensor(y, like))


# -- sorting ------------------------------------------------------------------------

@register("topk", inputs=("x",))
def _topk(x, *, k, axis=-1, largest=True):
    s = torch.sort(x, dim=axis, descending=bool(largest), stable=True)
    return s.values.narrow(axis, 0, k), s.indices.narrow(axis, 0, k)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """The ``k`` largest (smallest unless ``largest``) values along
    ``axis``, in order, and their indices: of equal values, the lower
    index first (``lax.top_k``)."""
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    return _topk(x, k=int(k), axis=int(axis), largest=bool(largest))


@register("sort", inputs=("x",))
def _sort(x, *, axis=-1, descending=False):
    out = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(out, (axis,)) if descending else out


def sort(x, axis=-1, descending=False, name=None):
    """``x`` sorted along ``axis``; descending is the ascending order
    reversed."""
    return _sort(x, axis=int(axis), descending=bool(descending))


@register("argsort", inputs=("x",))
def _argsort(x, *, axis=-1, descending=False):
    idx = torch.sort(x, dim=axis, stable=True).indices
    return torch.flip(idx, (axis,)) if descending else idx


def argsort(x, axis=-1, descending=False, name=None):
    """The indices that sort ``x`` along ``axis`` (a stable ascending
    sort; descending is its reverse, so ties come last index first)."""
    return _argsort(x, axis=int(axis), descending=bool(descending))


# -- types and elementwise selections -------------------------------------------

def one_hot(x, num_classes, name=None):
    """float32 one-hot rows of the integer ``x`` (the layers' op,
    ``nn.functional.one_hot``)."""
    from ..nn.functional.common import one_hot as _one_hot

    if isinstance(num_classes, torch.Tensor):
        num_classes = int(num_classes.item())
    return _one_hot(x, int(num_classes))


@register("cast", inputs=("x",))
def _cast(x, *, dtype):
    return x.to(dtype)


def cast(x, dtype):
    """``x`` as ``dtype``."""
    return _cast(x, dtype=dtype_of(dtype))


@register("masked_fill", inputs=("x", "mask"))
def _masked_fill(x, mask, *, value):
    return torch.where(mask, torch.full((), value, dtype=x.dtype,
                                        device=x.device), x)


def masked_fill(x, mask, value, name=None):
    """``x`` with ``value`` where ``mask`` holds (broadcast)."""
    if isinstance(value, torch.Tensor):
        value = value.item()
    return _masked_fill(x, mask, value=value)


@register("shard_index", inputs=("x",))
def _shard_index(x, *, index_num, nshards, shard_id, ignore_value):
    size = index_num // nshards
    inside = torch.div(x, size, rounding_mode="floor") == shard_id
    return torch.where(inside, torch.remainder(x, size),
                       torch.full((), ignore_value, dtype=x.dtype,
                                  device=x.device))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Ids of shard ``shard_id`` (of ``nshards`` over ``index_num``) as
    offsets into it, ``ignore_value`` elsewhere."""
    return _shard_index(input, index_num=int(index_num),
                        nshards=int(nshards), shard_id=int(shard_id),
                        ignore_value=int(ignore_value))


@register("as_real", inputs=("x",))
def _as_real(x):
    return torch.stack([x.real, x.imag], dim=-1)


@register("as_complex", inputs=("x",))
def _as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    """A complex ``x`` as its real and imaginary parts on a new last
    axis."""
    return _as_real(x)


def as_complex(x, name=None):
    """A last axis of 2 (real, imaginary) as a complex tensor."""
    return _as_complex(x)


@register("moveaxis", inputs=("x",))
def _moveaxis(x, *, source, destination):
    return torch.movedim(x, source, destination)


def moveaxis(x, source, destination, name=None):
    """``x`` with axes ``source`` moved to ``destination``."""
    return _moveaxis(x, source=norm_axis(source),
                     destination=norm_axis(destination))


@register("swapaxes", inputs=("x",))
def _swapaxes(x, *, axis1, axis2):
    return torch.swapaxes(x, axis1, axis2)


def swapaxes(x, axis1, axis2, name=None):
    """``x`` with ``axis1`` and ``axis2`` swapped."""
    return _swapaxes(x, axis1=int(axis1), axis2=int(axis2))


@register("rot90", inputs=("x",))
def _rot90(x, *, k, axes):
    return torch.rot90(x, k, axes)


def rot90(x, k=1, axes=(0, 1), name=None):
    """``x`` rotated by ``k`` quarter turns in the plane of ``axes``."""
    return _rot90(x, k=int(k), axes=tuple(int(a) for a in axes))


# -- shapes that depend on the data: a host sync each -------------------------

def nonzero(x, as_tuple=False):
    """The coordinates of ``x``'s nonzero elements: an (n, ndim) tensor,
    or one 1-d tensor an axis with ``as_tuple``."""
    return torch.nonzero(x, as_tuple=bool(as_tuple))


def masked_select(x, mask, name=None):
    """The elements of ``x`` where ``mask`` (broadcast) holds, 1-d."""
    return torch.masked_select(x, mask.to(torch.bool))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """``np.unique``: the sorted unique values (slices along ``axis``),
    and on request the index of each one's first occurrence, the inverse
    (``x``'s shape for ``axis=None``) and the counts."""
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    out = [vals]
    idt = dtype_of(dtype)
    if return_index:
        n = x.numel() if axis is None else x.shape[axis]
        first = torch.full((vals.shape[0 if axis is None else axis],), n,
                           dtype=torch.long, device=x.device)
        first = first.scatter_reduce(0, inv.reshape(-1),
                                     torch.arange(n, device=x.device),
                                     "amin")
        out.append(first.to(idt))
    if return_inverse:
        out.append(inv.to(idt))
    if return_counts:
        out.append(counts.to(idt))
    return out[0] if len(out) == 1 else tuple(out)


def bincount(x, weights=None, minlength=0, name=None):
    """The count of each value of the non-negative ints ``x`` (or the sum
    of their ``weights``), ``max(x.max() + 1, minlength)`` long; a
    bool ``x`` counts as 0 and 1."""
    x = x.reshape(-1)
    if x.dtype == torch.bool:
        x = x.to(torch.int64)
    n = max(int(x.max()) + 1 if x.numel() else 0, int(minlength))
    if weights is None:
        return torch.bincount(x, minlength=n)
    w = weights.reshape(-1)
    with deterministic():
        return torch.zeros(n, dtype=w.dtype, device=w.device).index_put_(
            (x.long(),), w, accumulate=True)
