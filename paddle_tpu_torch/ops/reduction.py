"""Reductions: ``max``/``amax``, ``min``/``amin`` and ``mean``, the
counterparts of ``paddle_tpu/ops/reduction.py``'s (``:23-45``), which
the layers call. The rest of that module comes with the tensor API.

``max`` and ``min`` are ``torch.amax``/``torch.amin``: their gradient
splits evenly over the elements that tie for the extreme, as
``jnp.max``'s does. ``torch.max(x, dim).values`` would send all of it to
one index, and a max-pool over an LSTM's zero-padded steps ties on
every unit whose valid outputs are all negative.
"""
from __future__ import annotations

import torch

from ._base import register
from .misc import torch_dtype

__all__ = ["max", "amax", "min", "amin", "mean"]


def _dims(axis, x):
    """A Paddle ``axis`` (``None``: every axis; an int; a list) as
    ``torch``'s ``dim``."""
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


@register("reduce_max", inputs=("x",))
def _max(x, *, axis=None, keepdim=False):
    return torch.amax(x, dim=_dims(axis, x), keepdim=keepdim)


@register("reduce_min", inputs=("x",))
def _min(x, *, axis=None, keepdim=False):
    return torch.amin(x, dim=_dims(axis, x), keepdim=keepdim)


@register("reduce_mean", inputs=("x",))
def _mean(x, *, axis=None, keepdim=False):
    return torch.mean(x, dim=_dims(axis, x), keepdim=keepdim)


def _reduction(op):
    def fn(x, axis=None, keepdim=False, dtype=None):
        if isinstance(axis, (list, tuple)):
            axis = tuple(int(a) for a in axis)
        out = op(x, axis=axis, keepdim=bool(keepdim))
        return out if dtype is None else out.to(torch_dtype(dtype))

    fn.__name__ = op.__name__.lstrip("_")
    fn.__doc__ = (f"The {fn.__name__} of ``x`` over ``axis`` (``None``: "
                  "all), keeping the reduced axes as 1 with ``keepdim``; "
                  "cast to ``dtype`` when given.")
    return fn


max = amax = _reduction(_max)
min = amin = _reduction(_min)
mean = _reduction(_mean)
