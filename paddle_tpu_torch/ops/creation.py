"""Tensor creation, the counterparts of ``paddle_tpu/ops/creation.py``'s:
the constant makers (``zeros`` ... ``fill_constant``), the ``*_like``
ops, ``arange``/``linspace``/``logspace``/``eye``, ``tril``/``triu``,
``meshgrid``, ``diagflat``, ``assign``/``clone``, and the random makers
(``rand``, ``randn``/``standard_normal``, ``randint``, ``randperm``,
``uniform``, ``normal``, ``bernoulli``, ``multinomial``).

The makers take ``device=`` (``None``: the card, through
``_device.resolve_device``; ``"cpu"`` only when asked for) and Paddle's
dtype rules: float32 when none is given, and ``arange`` of ints is
``int64`` (``creation.py:97-106``; the JAX package, without x64, gives
``int32``). ``empty`` is ``zeros`` (``creation.py:64``): no maker
returns uninitialised memory.

Every random draw takes an explicit ``torch.Generator``: the device's
(``core.random.default_generator``), or, for ``uniform(seed=s)`` with
``s`` not 0, one seeded with ``s`` for the call, so that the same seed
draws the same numbers. The draws cannot
match the JAX package's key stream bit for bit; they match its shapes,
types, ranges and distributions.
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from ..core.random import default_generator
from ._args import dtype_of, tensor
from ._base import register

__all__ = ["zeros", "ones", "full", "empty", "zeros_like", "ones_like",
           "full_like", "empty_like", "arange", "linspace", "logspace",
           "eye", "tril", "triu", "meshgrid", "diagflat", "assign", "clone",
           "rand", "randn", "randint", "randperm", "uniform", "normal",
           "bernoulli", "multinomial", "standard_normal", "fill_constant"]


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return [int(s) for s in shape.reshape(-1).tolist()]
    if isinstance(shape, int):
        return [shape]
    return [int(s) for s in shape]


def _item(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None, name=None, device=None):
    """Zeros of ``shape`` (float32 unless ``dtype`` says otherwise)."""
    return torch.zeros(_shape(shape), dtype=dtype_of(dtype),
                       device=resolve_device(device))


def ones(shape, dtype=None, name=None, device=None):
    """Ones of ``shape``."""
    return torch.ones(_shape(shape), dtype=dtype_of(dtype),
                      device=resolve_device(device))


def full(shape, fill_value, dtype=None, name=None, device=None):
    """``fill_value`` everywhere in ``shape``."""
    return torch.full(_shape(shape), _item(fill_value),
                      dtype=dtype_of(dtype), device=resolve_device(device))


empty = zeros    # deterministic "empty", as the JAX package's


def fill_constant(shape, dtype, value, name=None, out=None, device=None):
    """``full(shape, value, dtype)``, written into ``out`` when given."""
    t = full(shape, value, dtype,
             device=out.device if out is not None else device)
    if out is not None:
        with torch.no_grad():
            out.copy_(t)
        return out
    return t


def _like(name, fill):
    @register(name, inputs=("x",))
    def _op(x, *, dtype=None, value=None):
        return torch.full_like(x, fill if value is None else value,
                               dtype=dtype)

    return _op


_zeros_like = _like("zeros_like", 0)
_ones_like = _like("ones_like", 1)
_full_like = _like("full_like", 0)


def zeros_like(x, dtype=None, name=None):
    """Zeros of ``x``'s shape, its type unless ``dtype`` is given."""
    return _zeros_like(x, dtype=None if dtype is None else dtype_of(dtype))


def ones_like(x, dtype=None, name=None):
    """Ones of ``x``'s shape."""
    return _ones_like(x, dtype=None if dtype is None else dtype_of(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    """``fill_value`` in ``x``'s shape."""
    return _full_like(x, value=_item(fill_value),
                      dtype=None if dtype is None else dtype_of(dtype))


empty_like = zeros_like


def arange(start=0, end=None, step=1, dtype=None, name=None, device=None):
    """``[start, end)`` by ``step`` (one argument: ``[0, start)``); int64
    when every bound is an int, else float32, unless ``dtype`` says."""
    start, end, step = _item(start), _item(end), _item(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = "int64" if all(isinstance(v, int) and not isinstance(
            v, bool) for v in (start, end, step)) else "float32"
    return torch.arange(start, end, step, dtype=dtype_of(dtype),
                        device=resolve_device(device))


def linspace(start, stop, num, dtype=None, name=None, device=None):
    """``num`` evenly spaced values from ``start`` to ``stop``, both
    included."""
    return torch.linspace(_item(start), _item(stop), int(_item(num)),
                          dtype=dtype_of(dtype),
                          device=resolve_device(device))


def logspace(start, stop, num, base=10.0, dtype=None, name=None,
             device=None):
    """``base`` to the powers of ``linspace(start, stop, num)``."""
    return torch.logspace(_item(start), _item(stop), int(num),
                          base=float(base), dtype=dtype_of(dtype),
                          device=resolve_device(device))


def eye(num_rows, num_columns=None, dtype=None, name=None, device=None):
    """The ``num_rows x num_columns`` identity."""
    m = int(num_rows) if num_columns is None else int(num_columns)
    return torch.eye(int(num_rows), m, dtype=dtype_of(dtype),
                     device=resolve_device(device))


@register("tril", inputs=("x",))
def _tril(x, *, diagonal=0):
    return torch.tril(x, diagonal)


@register("triu", inputs=("x",))
def _triu(x, *, diagonal=0):
    return torch.triu(x, diagonal)


def tril(x, diagonal=0, name=None):
    """``x`` with the elements above diagonal ``diagonal`` set to 0."""
    return _tril(x, diagonal=int(diagonal))


def triu(x, diagonal=0, name=None):
    """``x`` with the elements below diagonal ``diagonal`` set to 0."""
    return _triu(x, diagonal=int(diagonal))


def diagflat(x, offset=0, name=None):
    """The flattened ``x`` on diagonal ``offset`` of a square matrix."""
    return torch.diagflat(tensor(x), int(offset))


def meshgrid(*args, name=None):
    """The coordinate grids of 1-d tensors, ``ij`` indexing."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(torch.meshgrid(*args, indexing="ij"))


@register("assign", inputs=("x",))
def _assign(x):
    return x.clone()


def assign(x, output=None):
    """A copy of ``x`` (an array goes to the card), written into
    ``output`` when given."""
    out = _assign(tensor(x))
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x, name=None):
    """A copy of ``x`` (the ``assign`` op)."""
    return _assign(x)


# -- random makers ------------------------------------------------------------

def _float_dtype(dtype):
    d = dtype_of(dtype)
    return d if d.is_floating_point else torch.float32


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None,
            device=None):
    """U(``min``, ``max``) of ``shape``; ``seed`` not 0 draws from a
    generator seeded with it for this call."""
    dev = resolve_device(device)
    gen = (torch.Generator(device=dev).manual_seed(int(seed)) if seed
           else default_generator(dev))
    out = torch.empty(_shape(shape), dtype=_float_dtype(dtype), device=dev)
    return out.uniform_(float(min), float(max), generator=gen)


def rand(shape, dtype=None, name=None, device=None):
    """U(0, 1) of ``shape``."""
    return uniform(shape, dtype, 0.0, 1.0, device=device)


def randn(shape, dtype=None, name=None, device=None):
    """N(0, 1) of ``shape``."""
    dev = resolve_device(device)
    return torch.randn(_shape(shape), dtype=_float_dtype(dtype), device=dev,
                       generator=default_generator(dev))


standard_normal = randn


def normal(mean=0.0, std=1.0, shape=None, name=None, device=None):
    """``mean + std * N(0, 1)``: of ``shape``, or of the broadcast shape
    of ``mean`` and ``std`` when either is a tensor (on its device)."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        ref = mean if isinstance(mean, torch.Tensor) else std
        dev = ref.device
        shp = (torch.broadcast_shapes(torch.as_tensor(mean).shape,
                                      torch.as_tensor(std).shape)
               if shape is None else _shape(shape))
    else:
        dev = resolve_device(device)
        shp = [] if shape is None else _shape(shape)
    z = torch.randn(shp, dtype=torch.float32, device=dev,
                    generator=default_generator(dev))
    return mean + std * z


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None,
            device=None):
    """Integers uniform in ``[low, high)`` (one bound: ``[0, low)``)."""
    if high is None:
        low, high = 0, low
    dev = resolve_device(device)
    return torch.randint(int(low), int(high), _shape(shape),
                         dtype=dtype_of(dtype), device=dev,
                         generator=default_generator(dev))


def randperm(n, dtype="int64", name=None, device=None):
    """A random permutation of ``range(n)``."""
    dev = resolve_device(device)
    return torch.randperm(int(n), dtype=dtype_of(dtype), device=dev,
                          generator=default_generator(dev))


def bernoulli(x, name=None):
    """1 with probability ``x``, else 0, in ``x``'s type and device."""
    return torch.bernoulli(x, generator=default_generator(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """``num_samples`` indices drawn from each row's weights ``x`` (with
    or without ``replacement``)."""
    return torch.multinomial(x, int(num_samples), bool(replacement),
                             generator=default_generator(x.device))


# fluid's spellings (creation.py:108, 194, 217-218)
range_ = arange
uniform_random = uniform
gaussian = gaussian_random = normal
