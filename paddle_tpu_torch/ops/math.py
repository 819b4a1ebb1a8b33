"""Elementwise and product math, the counterparts of
``paddle_tpu/ops/math.py``'s: the binary ops (``add`` ... ``atan2``,
``logaddexp``), the unary table (``exp`` ... ``rad2deg``), ``matmul``
and its forms (``mm``, ``bmm``, ``mul``, ``dot``, ``outer``, ``inner``),
``scale``, ``clip``, ``add_n``, ``cumsum``/``cumprod``, ``lerp``,
``einsum``, ``kron``, ``trace``, ``diag``, ``diagonal``, ``nan_to_num``,
``stanh`` and ``increment``. Each is registered under the JAX
registry's name, so ``amp.auto_cast`` casts it by its list entry and a
static Program records it as one op.

A Python scalar operand takes the type of the tensor it meets (an int
tensor truncates it), as the JAX package's ``_binop`` converts it
(``math.py:299-317``). Where torch's op keeps another rule than
``jnp``'s, the op is written in the ``jnp`` form:

- ``remainder`` follows the divisor's sign, from ``fmod`` and one
  correction (``jnp.remainder``), and ``floor_divide`` rounds towards
  minus infinity: ``[-3, 3]`` over ``[2, -2]`` gives ``[-2, -2]`` and
  ``[1, -1]``;
- ``clip`` is a ``maximum`` then a ``minimum``, so at a bound the
  gradient splits as ``jnp.clip``'s does;
- ``lerp`` is ``x + w (y - x)`` (``torch.lerp`` switches formulas at
  ``w = 0.5``);
- ``outer`` flattens its operands and ``dot`` sums the last axis;
- a bool operand is an int in ``floor_divide``, ``remainder`` and
  ``pow``, an int or bool a float32 in ``logaddexp``, and ``abs``,
  ``floor``, ``ceil`` and ``trunc`` give a bool back as it is; two bool
  operands of ``matmul`` and ``inner`` give a bool, true where any
  product is.
"""
from __future__ import annotations

import torch

from ._args import astype, operands, tensor
from ._base import register
from .reduction import _float

__all__ = ["add", "subtract", "multiply", "divide", "floor_divide",
           "remainder", "mod", "pow", "maximum", "minimum", "atan2",
           "logaddexp", "matmul", "mm", "bmm", "mul", "dot", "outer",
           "inner", "scale", "clip", "add_n", "cumsum", "cumprod", "lerp",
           "einsum", "kron", "trace", "diag", "diagonal", "nan_to_num",
           "stanh", "increment", "isnan", "isinf", "isfinite", "exp",
           "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "abs",
           "neg", "floor", "ceil", "round", "trunc", "sin", "cos", "tan",
           "asin", "acos", "atan", "sinh", "cosh", "asinh", "acosh", "atanh",
           "erf", "erfinv", "sign", "reciprocal", "square", "digamma",
           "lgamma", "frac", "angle", "conj", "deg2rad", "rad2deg"]


def _int(x):
    """A bool ``x`` as int64, as jnp promotes a bool in integer
    arithmetic (its int32: the port's integers are int64)."""
    return x.to(torch.int64) if x.dtype == torch.bool else x


def _ints(fn):
    return lambda x, y: fn(_int(x), _int(y))


def _floats(fn):
    return lambda x, y: fn(_float(x), _float(y))


def _matmul(x, y):
    """``torch.matmul``, with jnp's rule for two bool operands: a bool
    product, true where any term is (counted in float32, exact to
    2^24 terms, since cuBLAS has no integer GEMM)."""
    if x.dtype == torch.bool and y.dtype == torch.bool:
        return torch.matmul(x.to(torch.float32), y.to(torch.float32)) > 0
    return torch.matmul(x, y)


def _remainder(x, y):
    m = torch.fmod(x, y)
    return torch.where((m != 0) & ((m < 0) != (y < 0)), m + y, m)


def _floor_divide(x, y):
    return torch.div(x, y, rounding_mode="floor")


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


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.subtract)
multiply = _binary("multiply", torch.multiply)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", _ints(_floor_divide))
remainder = mod = _binary("remainder", _ints(_remainder))
pow = _binary("pow", _ints(torch.pow))
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
atan2 = _binary("atan2", torch.atan2)
logaddexp = _binary("logaddexp", _floats(torch.logaddexp))


@register("matmul", inputs=("x", "y"))
def matmul(x, y, transpose_x=False, transpose_y=False):
    """``x @ y``, either operand's last two axes swapped first."""
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    return _matmul(x, y)


def mm(x, y, name=None):
    """``x @ y``."""
    return matmul(x, y)


bmm = mm


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    """Paddle's ``mul`` (``mul_op.cc``): ``x`` flattened to a matrix at
    axis ``x_num_col_dims``, ``y`` at ``y_num_col_dims``, multiplied, and
    the product shaped ``x.shape[:x_num_col_dims] +
    y.shape[y_num_col_dims:]``."""
    from .manipulation import reshape

    xs, ys = list(x.shape), list(y.shape)
    rows = 1
    for s in xs[:x_num_col_dims]:
        rows *= s
    inner_ = 1
    for s in ys[:y_num_col_dims]:
        inner_ *= s
    out = matmul(reshape(x, [rows, -1]), reshape(y, [inner_, -1]))
    return reshape(out, xs[:x_num_col_dims] + ys[y_num_col_dims:])


@register("dot", inputs=("x", "y"))
def _dot(x, y):
    return torch.sum(x * y, dim=-1)


@register("outer", inputs=("x", "y"))
def _outer(x, y):
    return x.reshape(-1, 1) * y.reshape(1, -1)


@register("inner", inputs=("x", "y"))
def _inner(x, y):
    if x.dtype == torch.bool and y.dtype == torch.bool:
        return torch.inner(x.to(torch.float32), y.to(torch.float32)) > 0
    return torch.inner(x, y)


def dot(x, y, name=None):
    """The sum of ``x * y`` over the last axis (row by row for 2-d)."""
    return _dot(x, y)


def outer(x, y, name=None):
    """The outer product of ``x`` and ``y``, both flattened."""
    return _outer(x, y)


def inner(x, y, name=None):
    """The inner product over the last axes of ``x`` and ``y``."""
    return _inner(x, y)


@register("scale", inputs=("x",))
def _scale(x, *, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x * scale + bias`` (``(x + bias) * scale`` unless
    ``bias_after_scale``), then the activation named ``act``."""
    if isinstance(scale, torch.Tensor):
        scale = float(scale.item())
    out = _scale(tensor(x), scale=float(scale), bias=float(bias),
                 bias_after_scale=bool(bias_after_scale))
    if act:
        from . import activation

        out = getattr(activation, act)(out)
    return out


def increment(x, value=1.0, name=None):
    """``x + value`` (the ``scale`` op, as the JAX package records it)."""
    return _scale(x, scale=1.0, bias=float(value))


@register("clip", inputs=("x",))
def _clip(x, *, min=None, max=None):
    if min is not None:
        x = torch.maximum(x, torch.full((), min, dtype=x.dtype,
                                        device=x.device))
    if max is not None:
        x = torch.minimum(x, torch.full((), max, dtype=x.dtype,
                                        device=x.device))
    return x


def clip(x, min=None, max=None, name=None):
    """``x`` clipped to ``[min, max]`` (either may be None)."""
    lo = float(min.item()) if isinstance(min, torch.Tensor) else min
    hi = float(max.item()) if isinstance(max, torch.Tensor) else max
    return _clip(x, min=lo, max=hi)


@register("add_n", inputs=("xs",))
def _add_n(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def add_n(inputs, name=None):
    """The sum of the tensors of ``inputs``, left to right."""
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    return _add_n(*inputs)


@register("cumsum", inputs=("x",))
def _cumsum(x, *, axis=None):
    return torch.cumsum(x.reshape(-1) if axis is None else x,
                        dim=0 if axis is None else axis)


@register("cumprod", inputs=("x",))
def _cumprod(x, *, axis=None):
    return torch.cumprod(x.reshape(-1) if axis is None else x,
                         dim=0 if axis is None else axis)


def cumsum(x, axis=None, dtype=None, name=None):
    """The running sum along ``axis`` (``None``: of the flattened
    ``x``)."""
    out = _cumsum(x, axis=None if axis is None else int(axis))
    return astype(out, dtype)


def cumprod(x, dim=None, dtype=None, name=None):
    """The running product along ``dim`` (``None``: of the flattened
    ``x``)."""
    out = _cumprod(x, axis=None if dim is None else int(dim))
    return astype(out, dtype)


@register("lerp", inputs=("x", "y", "w"))
def _lerp(x, y, w):
    return x + w * (y - x)


def lerp(x, y, weight, name=None):
    """``x + weight * (y - x)``."""
    return _lerp(x, y, tensor(weight, x))


@register("einsum", inputs=("xs",))
def _einsum(*xs, equation):
    return torch.einsum(equation, *xs)


def einsum(equation, *operands):
    """``torch.einsum``/``jnp.einsum`` over ``operands``."""
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return _einsum(*operands, equation=equation)


@register("kron", inputs=("x", "y"))
def _kron(x, y):
    return torch.kron(x, y)


def kron(x, y, name=None):
    """The Kronecker product of ``x`` and ``y``."""
    return _kron(x, y)


@register("trace_op", inputs=("x",))
def _trace(x, *, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    """The sum of ``x``'s diagonal ``offset`` over ``axis1``/``axis2``."""
    return _trace(x, offset=int(offset), axis1=int(axis1),
                  axis2=int(axis2))


@register("diag", inputs=("x",))
def _diag(x, *, offset=0):
    return torch.diag(x, offset)


def diag(x, offset=0, name=None):
    """A 1-d ``x`` on diagonal ``offset`` of a square matrix; a 2-d
    ``x``'s diagonal ``offset``."""
    return _diag(x, offset=int(offset))


@register("diagonal", inputs=("x",))
def _diagonal(x, *, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    """Diagonal ``offset`` of ``x`` over ``axis1``/``axis2``, as the last
    axis."""
    return _diagonal(x, offset=int(offset), axis1=int(axis1),
                     axis2=int(axis2))


@register("nan_to_num", inputs=("x",))
def _nan_to_num(x, *, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    """``x`` with NaN as ``nan`` and the infinities as ``posinf`` and
    ``neginf`` (default: the type's extremes)."""
    return _nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@register("stanh", inputs=("x",))
def _stanh(x, *, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    """``scale_b * tanh(scale_a * x)``."""
    return _stanh(x, scale_a=float(scale_a), scale_b=float(scale_b))


def _frac(x):
    return x - torch.trunc(x)


def _same_bool(fn):
    """``fn``, with a bool ``x`` given back as it is (jnp's ``abs``,
    ``floor``, ``ceil`` and ``trunc`` of a bool)."""
    return lambda x: x.clone() if x.dtype == torch.bool else fn(x)


# the unary table (``math.py:133-178``), under its registry names;
# ``tanh`` is ``ops.activation``'s
_UNARY = {
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "abs": _same_bool(torch.abs),
    "neg": torch.neg, "floor": _same_bool(torch.floor),
    "ceil": _same_bool(torch.ceil), "round": torch.round,
    "trunc": _same_bool(torch.trunc), "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan, "sinh": torch.sinh,
    "cosh": torch.cosh, "asinh": torch.asinh, "acosh": torch.acosh,
    "atanh": torch.atanh, "erf": torch.erf, "erfinv": torch.erfinv,
    "sign": torch.sign, "reciprocal": torch.reciprocal,
    "square": torch.square, "digamma": torch.digamma,
    "lgamma": torch.lgamma, "frac": _frac, "angle": torch.angle,
    "conj": torch.conj_physical, "deg2rad": torch.deg2rad,
    "rad2deg": torch.rad2deg, "isnan": torch.isnan, "isinf": torch.isinf,
    "isfinite": torch.isfinite,
}


def _unary(name, fn):
    def body(x):
        return fn(x)

    body.__name__ = f"_{name}"
    op_ = register(name, inputs=("x",))(body)

    def op(x, name=None):
        return op_(tensor(x))

    op.__name__ = name
    op.__doc__ = f"``{name}`` of ``x``, elementwise."
    return op


for _name, _fn in _UNARY.items():
    globals()[_name] = _unary(_name, _fn)
del _name, _fn
