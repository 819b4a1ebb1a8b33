"""Reductions, the counterparts of ``paddle_tpu/ops/reduction.py``'s:
``sum``, ``mean``, ``max``/``amax``, ``min``/``amin``, ``prod``, ``all``,
``any``, ``logsumexp``, ``argmax``/``argmin``, ``std``/``var``,
``median``, ``quantile``, ``kthvalue``, ``mode``, ``count_nonzero``,
``nansum`` and ``nanmean``, each registered under the JAX registry's
name (``reduce_sum``, ``reduce_prod``, ...).

``max`` and ``min`` are ``torch.amax``/``torch.amin``: their gradient
splits evenly over the elements that tie for the extreme, as
``jnp.max``'s does. ``torch.max(x, dim).values`` would send all of it to
one index, and a max-pool over an LSTM's zero-padded steps ties on
every unit whose valid outputs are all negative.

Where torch's own reduction keeps other rules than the JAX package's,
the op is written out in the JAX form:

- ``median`` of an even count averages the two middle values
  (``jnp.median``); ``torch.median`` takes the lower one;
- ``mode`` is the most frequent value that occurs first, with that
  index, from a pairwise count (``reduction.py:152-162``);
  ``torch.mode`` takes the smallest such value;
- ``kthvalue``'s index under ties is the k-th of a stable sort
  (``reduction.py:136-144``), where ``torch.kthvalue`` gives any.

Integer and bool inputs promote as jnp promotes them: ``mean``,
``nanmean``, ``std`` and ``var`` compute in float32 (``_float``), and
``argmax``/``argmin`` take a bool as 0 and 1. Indices come out
``int64`` (Paddle's type); the JAX package, without x64, gives
``int32``.
"""
from __future__ import annotations

import torch

from ._args import astype, dims, norm_axis, tensor
from ._base import register

__all__ = ["sum", "mean", "max", "amax", "min", "amin", "prod", "all",
           "any", "logsumexp", "argmax", "argmin", "std", "var", "median",
           "quantile", "kthvalue", "mode", "mode_op", "count_nonzero",
           "nansum", "nanmean"]


def _reduction(name, fn):
    """``fn(x, dims, keepdim)`` registered as ``name`` over ``x``'s
    ``axis`` (``None``: all), with Paddle's ``keepdim`` and ``dtype``."""

    @register(name, inputs=("x",))
    def _op(x, *, axis=None, keepdim=False):
        return fn(x, dims(axis, x), keepdim)

    def op(x, axis=None, keepdim=False, dtype=None, name=None):
        out = _op(tensor(x), axis=norm_axis(axis), keepdim=bool(keepdim))
        return astype(out, dtype)

    op.__name__ = name.replace("reduce_", "")
    op.__doc__ = (f"The {op.__name__} of ``x`` over ``axis`` (``None``: "
                  "all), keeping the reduced axes as 1 with ``keepdim``; "
                  "cast to ``dtype`` when given.")
    return op


def _prod(x, d, keepdim):
    # torch.prod takes one dim: the axes move to the end and merge
    d = (d,) if isinstance(d, int) else d
    d = tuple(sorted(a % x.dim() for a in d)) if x.dim() else ()
    if not d:
        return x.clone()
    rest = [a for a in range(x.dim()) if a not in d]
    y = x.permute(rest + list(d)).reshape([x.shape[a] for a in rest] + [-1])
    out = torch.prod(y, -1)
    if keepdim:
        out = out.reshape([1 if a in d else x.shape[a]
                           for a in range(x.dim())])
    return out


def _bool(x):
    return x if x.dtype == torch.bool else x != 0


def _float(x):
    """An integer or bool ``x`` as float32, as jnp promotes it in a
    mean, a variance or a decomposition; a float ``x`` as it is."""
    return x if x.is_floating_point() or x.is_complex() \
        else x.to(torch.float32)


sum = _reduction("reduce_sum",
                 lambda x, d, k: torch.sum(x, dim=d, keepdim=k))
mean = _reduction("reduce_mean",
                  lambda x, d, k: torch.mean(_float(x), dim=d, keepdim=k))
max = amax = _reduction("reduce_max",
                        lambda x, d, k: torch.amax(x, dim=d, keepdim=k))
min = amin = _reduction("reduce_min",
                        lambda x, d, k: torch.amin(x, dim=d, keepdim=k))
prod = _reduction("reduce_prod", _prod)
all = _reduction("reduce_all",
                 lambda x, d, k: torch.all(_bool(x), dim=d, keepdim=k))
any = _reduction("reduce_any",
                 lambda x, d, k: torch.any(_bool(x), dim=d, keepdim=k))
logsumexp = _reduction(
    "logsumexp", lambda x, d, k: torch.logsumexp(x, dim=d, keepdim=k))
count_nonzero = _reduction(
    "count_nonzero", lambda x, d, k: torch.sum(x != 0, dim=d, keepdim=k))
nansum = _reduction("nansum",
                    lambda x, d, k: torch.nansum(x, dim=d, keepdim=k))
nanmean = _reduction(
    "nanmean", lambda x, d, k: torch.nanmean(_float(x), dim=d, keepdim=k))


def _arg(name, fn):
    @register(name, inputs=("x",))
    def _op(x, *, axis=None, keepdim=False):
        if x.dtype == torch.bool:   # torch refuses bool; jnp counts it 0/1
            x = x.to(torch.uint8)
        if axis is None:   # over the flattened x, never kept
            return fn(x.reshape(-1), 0)
        return fn(x, int(axis), keepdim)

    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        out = _op(tensor(x), axis=norm_axis(axis), keepdim=bool(keepdim))
        return astype(out, dtype)

    op.__name__ = name
    op.__doc__ = (f"The index of the first {name[3:]}imum of ``x`` along "
                  "``axis`` (``None``: of the flattened ``x``), as "
                  "``dtype``.")
    return op


argmax = _arg("argmax", lambda x, d, k=False: torch.argmax(x, d, keepdim=k))
argmin = _arg("argmin", lambda x, d, k=False: torch.argmin(x, d, keepdim=k))


@register("std", inputs=("x",))
def _std(x, *, axis=None, unbiased=True, keepdim=False):
    return torch.std(_float(x), dim=dims(axis, x), correction=int(bool(unbiased)),
                     keepdim=keepdim)


@register("var", inputs=("x",))
def _var(x, *, axis=None, unbiased=True, keepdim=False):
    return torch.var(_float(x), dim=dims(axis, x), correction=int(bool(unbiased)),
                     keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    """The standard deviation over ``axis``, ``n - 1`` in the divisor
    with ``unbiased``."""
    return _std(tensor(x), axis=norm_axis(axis), unbiased=bool(unbiased),
                keepdim=bool(keepdim))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    """The variance over ``axis``, ``n - 1`` in the divisor with
    ``unbiased``."""
    return _var(tensor(x), axis=norm_axis(axis), unbiased=bool(unbiased),
                keepdim=bool(keepdim))


@register("median", inputs=("x",))
def _median(x, *, axis=None, keepdim=False):
    x = _float(x)
    if axis is None:
        s = torch.sort(x.reshape(-1), stable=True).values
        d = 0
    else:
        d = int(axis) % x.dim()
        s = torch.sort(x, dim=d, stable=True).values
    n = s.shape[d]
    lo, hi = s.narrow(d, (n - 1) // 2, 1), s.narrow(d, n // 2, 1)
    out = (lo + hi) / 2 if n % 2 == 0 else lo
    if axis is None:
        return out.reshape([1] * x.dim()) if keepdim else out.reshape(())
    return out if keepdim else out.squeeze(d)


def median(x, axis=None, keepdim=False, name=None):
    """The median over ``axis`` (``None``: all); an even count averages
    its two middle values."""
    return _median(tensor(x), axis=norm_axis(axis), keepdim=bool(keepdim))


def _quantile1(x, q, axis, keepdim):
    if isinstance(axis, tuple) and len(axis) == 1:
        axis = axis[0]
    if axis is None or isinstance(axis, tuple):
        out = torch.quantile(x.reshape(-1), q)
        return out.reshape((1,) * x.dim()) if keepdim else out
    return torch.quantile(x, q, dim=int(axis), keepdim=keepdim)


@register("quantile", inputs=("x",))
def _quantile(x, *, q, axis=None, keepdim=False):
    x = _float(x)
    if isinstance(q, tuple):   # one quantile at a time: no host copy
        return torch.stack([_quantile1(x, float(v), axis, keepdim)
                            for v in q])
    return _quantile1(x, float(q), axis, keepdim)


def quantile(x, q, axis=None, keepdim=False, name=None):
    """The ``q``-quantile(s) over ``axis``, interpolated linearly; a list
    ``q`` puts its axis first."""
    q = q.tolist() if isinstance(q, torch.Tensor) else q
    q = tuple(q) if isinstance(q, (list, tuple)) else float(q)
    return _quantile(tensor(x), q=q, axis=norm_axis(axis),
                     keepdim=bool(keepdim))


@register("kthvalue", inputs=("x",))
def _kthvalue(x, *, k, axis=-1, keepdim=False):
    s = torch.sort(x, dim=axis, stable=True)
    v = s.values.narrow(axis, k - 1, 1)
    i = s.indices.narrow(axis, k - 1, 1)
    return (v, i) if keepdim else (v.squeeze(axis), i.squeeze(axis))


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The ``k``-th smallest value along ``axis`` and its index (the
    k-th of a stable sort under ties)."""
    return _kthvalue(tensor(x), k=int(k), axis=int(axis),
                     keepdim=bool(keepdim))


@register("mode", inputs=("x",))
def _mode(x, *, axis=-1, keepdim=False):
    ax = axis % x.dim()
    counts = torch.sum(x.unsqueeze(ax) == x.unsqueeze(ax + 1), dim=ax + 1)
    idx = torch.argmax(counts, dim=ax, keepdim=True)
    val = torch.gather(x, ax, idx)
    if not keepdim:
        return val.squeeze(ax), idx.squeeze(ax)
    return val, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` and its index: of the
    values that occur most often, the one that occurs first."""
    return _mode(tensor(x), axis=int(axis), keepdim=bool(keepdim))


mode_op = mode
