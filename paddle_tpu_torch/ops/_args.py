"""Argument handling the tensor API's ops share: Paddle ``axis`` values as
``torch`` dims, Python scalars and arrays as tensors beside the tensor
they meet, and deterministic accumulation.

The JAX package's ops take Paddle ``Tensor``s, numpy arrays and Python
scalars alike (``paddle_tpu/ops/math.py:299-317``): a Python scalar
takes the type of the tensor it meets (``int`` into an int tensor
truncates), an array becomes a tensor. Here tensors are ``torch``
tensors; an array goes to the device of the tensor it meets (the card
when it meets none, ``_device.resolve_device``).
"""
from __future__ import annotations

import contextlib
import numbers

import numpy as np
import torch

from .._device import resolve_device
from ..core import dtype as _dtype
from .misc import torch_dtype

__all__ = ["dims", "norm_axis", "tensor", "operands", "deterministic",
           "dtype_of", "astype"]

def dtype_of(d):
    """A Paddle dtype (a name, a torch or numpy dtype, ``None``: the
    default, ``core.dtype.set_default_dtype``'s, as the JAX package's
    ``convert_dtype(None)``) as a torch dtype."""
    if d is None:
        return _dtype.convert_dtype(None)
    if not isinstance(d, (str, torch.dtype)):
        d = np.dtype(d).name
    return torch_dtype(d)


def astype(x, dtype):
    """``x`` as ``dtype`` (None: as it is) through the registered ``cast``
    op, which a static Program records, as the JAX package's
    ``astype`` does."""
    if dtype is None:
        return x
    from .manipulation import cast

    return cast(x, dtype)


def norm_axis(axis):
    """A Paddle ``axis`` (None, an int, a list, a 1-d int tensor) as
    None, an int or a tuple of ints."""
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return axis if axis is None else int(axis)


def dims(axis, x):
    """``axis`` as ``torch``'s ``dim`` for a reduction over ``x``
    (``None``: every axis)."""
    axis = norm_axis(axis)
    return tuple(range(x.dim())) if axis is None else axis


def _scalar_of(v, like):
    """A Python scalar as the type of ``like``: truncated into an int
    tensor, a bool into a bool one, as the JAX package's
    ``jnp.asarray(v, x.dtype)``."""
    if isinstance(v, bool) or like.dtype == torch.bool:
        return bool(v)
    if not like.is_floating_point() and not like.is_complex():
        return int(v)
    return float(v) if not isinstance(v, complex) else v


def tensor(v, like=None, dtype=None):
    """``v`` as a tensor: a tensor as it is (cast to ``dtype`` when
    given); a Python scalar as a 0-d tensor of ``like``'s type on its
    device (the host for a static Variable); an array or list on
    ``like``'s device, else the card."""
    if isinstance(v, torch.Tensor):
        return v if dtype is None or v.dtype == dtype else v.to(dtype)
    dev = None if like is None else like.device
    if dev is not None and dev.type == "meta":
        dev = torch.device("cpu")
    if isinstance(v, numbers.Number) and like is not None:
        return torch.full((), _scalar_of(v, like), dtype=dtype or like.dtype,
                          device=dev)
    a = np.asarray(v)
    t = torch.from_numpy(np.require(a, requirements="C").copy()) \
        if a.dtype != object else torch.as_tensor(v)
    if a.dtype == np.float64 and dtype is None:
        t = t.to(torch.float32)
    return t.to(device=dev if dev is not None else resolve_device(None),
                dtype=dtype or t.dtype)


def operands(x, y):
    """A binary op's operands as tensors: a Python scalar or array takes
    the other operand's type and device."""
    if not isinstance(x, torch.Tensor):
        if not isinstance(y, torch.Tensor):
            x = tensor(x)
        else:
            x = tensor(x, y)
    return x, tensor(y, x)


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms for the calls inside: an
    accumulating ``index_put_`` sorts its indices on the card instead of
    adding with atomics, so repeated indices sum in one order."""
    on = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch._C._set_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch._C._set_deterministic_algorithms(on, warn_only=warn)
