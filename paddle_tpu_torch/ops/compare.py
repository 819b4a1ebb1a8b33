"""Comparisons and logical ops, the counterparts of
``paddle_tpu/ops/compare.py``'s: ``equal`` ... ``greater_equal``, the
``logical_*`` and ``bitwise_*`` ops, ``isclose``/``allclose`` (with
``equal_nan``), ``equal_all`` and ``is_empty`` (0-d bool tensors on the
operand's device) and ``is_tensor``. A Python scalar operand takes the
other operand's type, as the JAX package's ``_coerce`` does.
"""
from __future__ import annotations

import torch

from ._args import operands, tensor
from ._base import register

__all__ = ["equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal", "logical_and", "logical_or", "logical_xor",
           "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
           "bitwise_not", "isclose", "allclose", "equal_all", "is_empty",
           "is_tensor"]


def _binary(name, fn):
    def body(x, y):
        return fn(x, y)

    body.__name__ = f"_{name}"
    op_ = register(name, inputs=("x", "y"))(body)

    def op(x, y, name=None):
        return op_(*operands(x, y))

    op.__name__ = name
    op.__doc__ = f"``{name}(x, y)``, elementwise and broadcast."
    return op


equal = _binary("equal", torch.eq)
not_equal = _binary("not_equal", torch.ne)
less_than = _binary("less_than", torch.lt)
less_equal = _binary("less_equal", torch.le)
greater_than = _binary("greater_than", torch.gt)
greater_equal = _binary("greater_equal", torch.ge)
bitwise_and = _binary("bitwise_and", torch.bitwise_and)
bitwise_or = _binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary("bitwise_xor", torch.bitwise_xor)


@register("bitwise_not", inputs=("x",))
def _bitwise_not(x):
    return torch.bitwise_not(x)


def bitwise_not(x, out=None, name=None):
    """``~x`` bit by bit (logical for bool)."""
    return _bitwise_not(tensor(x))


def _logical(name, fn):
    @register(name, inputs=("x", "y"))
    def _op(x, y=None):
        return fn(x) if y is None else fn(x, y)

    def op(x, y=None, out=None, name=None):
        x = tensor(x)
        res = _op(x) if y is None else _op(*operands(x, y))
        if out is not None:
            out.copy_(res)
            return out
        return res

    op.__name__ = name
    op.__doc__ = f"``{name}`` of ``x`` (and ``y``), as bool."
    return op


logical_and = _logical("logical_and", torch.logical_and)
logical_or = _logical("logical_or", torch.logical_or)
logical_xor = _logical("logical_xor", torch.logical_xor)
logical_not = _logical("logical_not", torch.logical_not)


@register("isclose", inputs=("x", "y"))
def _isclose(x, y, *, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    """``|x - y| <= atol + rtol |y|`` elementwise (NaNs equal with
    ``equal_nan``)."""
    return _isclose(*operands(x, y), rtol=float(rtol), atol=float(atol),
                    equal_nan=bool(equal_nan))


@register("allclose_op", inputs=("x", "y"))
def _allclose(x, y, *, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.isclose(x, y, rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    """Whether ``isclose`` holds everywhere: a 0-d bool tensor."""
    return _allclose(*operands(x, y), rtol=float(rtol), atol=float(atol),
                     equal_nan=bool(equal_nan))


def equal_all(x, y, name=None):
    """Whether ``x`` and ``y`` have one shape and equal elements: a 0-d
    bool tensor."""
    x, y = operands(x, y)
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return torch.eq(x, y).all()


def is_empty(x, name=None):
    """Whether ``x`` has no element: a 0-d bool tensor."""
    x = tensor(x)
    return torch.full((), x.numel() == 0, dtype=torch.bool, device=x.device)


def is_tensor(x):
    """Whether ``x`` is a tensor."""
    return isinstance(x, torch.Tensor)
