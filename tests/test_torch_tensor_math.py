"""paddle_tpu_torch's tensor creation and math (``ops/creation.py``,
``ops/math.py``) against the JAX package's, one case a name, on the CPU
(``torch_tensor_parity``: the same ``RandomState(0)`` inputs through
both; tolerances there: float32 arithmetic rtol 1e-6, transcendental
and special functions 1e-5, integers exact; gradients held to the JAX
tape's).

The random makers cannot match the JAX key stream: each is held to the
JAX maker's shape, and to its own range, moments and repeatability
under a seed. Trap 9 (``empty`` is ``zeros``) and the integer
``floor_divide``/``remainder`` rule have cases of their own, each of
which the naive torch call fails. This file also holds the test that
every top-level name of ``paddle_tpu/__init__.py:84-125`` resolves on
``paddle_tpu_torch`` and has a case in the four tables.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import random as trandom

from torch_tensor_parity import (CPU, Case, c, check_case, close,
                                 covered_names, f, i, ids)

from torch_test_threads import torch_threads  # noqa: F401,E402

X = f(3, 4)
Y = f(3, 4)
POS = f(3, 4, lo=0.5, hi=2.0)
UNIT = f(3, 4, lo=-0.9, hi=0.9)
SPECIAL_VALUES = c([[np.nan, np.inf, -np.inf, 1.5], [0.0, -2.0, 3.0, 4.0]],
                   np.float32)

CREATION = [
    Case("zeros", lambda m, d: m.zeros([2, 3], **d), tol="exact"),
    Case("ones", lambda m, d: m.ones([2, 3], "int64", **d), tol="exact"),
    Case("full", lambda m, d: m.full([2, 3], 1.5, **d), tol="exact"),
    Case("empty", lambda m, d: m.empty([2, 3], **d), tol="exact"),
    Case("zeros_like", lambda m, d, x: m.zeros_like(x), [X], tol="exact"),
    Case("ones_like", lambda m, d, x: m.ones_like(x, "int32"), [X],
         tol="exact"),
    Case("full_like", lambda m, d, x: m.full_like(x, 2.5), [X],
         tol="exact"),
    Case("empty_like", lambda m, d, x: m.empty_like(x), [X], tol="exact"),
    Case("arange", lambda m, d: m.arange(5, **d), tol="exact"),
    Case("arange", lambda m, d: m.arange(0.5, 3.0, 0.5, **d),
         label="arange_float"),
    Case("linspace", lambda m, d: m.linspace(-1.0, 2.0, 7, **d)),
    Case("logspace", lambda m, d: m.logspace(0.0, 2.0, 5, **d),
         tol="special"),
    Case("eye", lambda m, d: m.eye(3, 4, **d), tol="exact"),
    Case("tril", lambda m, d, x: m.tril(x, 1), [X], grad=True),
    Case("triu", lambda m, d, x: m.triu(x, -1), [X], grad=True),
    Case("meshgrid", lambda m, d, x, y: m.meshgrid(x, y),
         [f(3), f(4)], tol="exact"),
    Case("diagflat", lambda m, d, x: m.diagflat(x, 1), [f(3)],
         tol="exact"),
    Case("assign", lambda m, d, x: m.assign(x), [X], grad=True),
    Case("clone", lambda m, d, x: m.clone(x), [X], grad=True),
    Case("fill_constant", lambda m, d: m.fill_constant([2, 2], "float32",
                                                       3.0, **d),
         tol="exact"),
]


def _binary(name, x=X, y=Y, tol="f32", grad=True):
    return Case(name, lambda m, d, a, b_: getattr(m, name)(a, b_), [x, y],
                tol=tol, grad=grad)


def _unary(name, x=X, tol="f32", grad=True):
    return Case(name, lambda m, d, a: getattr(m, name)(a), [x], tol=tol,
                grad=grad)


MATH = [
    _binary("add"), _binary("subtract"), _binary("multiply"),
    _binary("divide", y=POS),
    _binary("floor_divide", y=POS, grad=False),
    _binary("remainder", y=POS), _binary("mod", y=POS),
    _binary("pow", x=POS, tol="special"),
    _binary("maximum"), _binary("minimum"),
    _binary("atan2", tol="special"), _binary("logaddexp", tol="special"),
    Case("add", lambda m, d, x: m.add(x, 2.5), [X], grad=True,
         label="add_scalar"),
    Case("multiply", lambda m, d, x: m.multiply(x, 3), [i(-5, 5, 3, 4)],
         tol="exact", label="multiply_int_scalar"),
    Case("floor_divide", lambda m, d, x, y: m.floor_divide(x, y),
         [c([-3, 3, 7, -7]), c([2, -2, 2, -2])], tol="exact",
         label="floor_divide_int"),
    Case("remainder", lambda m, d, x, y: m.remainder(x, y),
         [c([-3, 3, 7, -7]), c([2, -2, 2, -2])], tol="exact",
         label="remainder_int"),
    Case("matmul", lambda m, d, x, y: m.matmul(x, y), [X, f(4, 2)],
         grad=True),
    Case("matmul", lambda m, d, x, y: m.matmul(x, y, transpose_y=True),
         [X, Y], grad=True, label="matmul_transpose_y"),
    Case("mm", lambda m, d, x, y: m.mm(x, y), [X, f(4, 2)], grad=True),
    Case("bmm", lambda m, d, x, y: m.bmm(x, y), [f(2, 3, 4), f(2, 4, 2)],
         grad=True),
    Case("dot", lambda m, d, x, y: m.dot(x, y), [X, Y], grad=True),
    Case("outer", lambda m, d, x, y: m.outer(x, y), [f(3), f(4)],
         grad=True),
    Case("inner", lambda m, d, x, y: m.inner(x, y), [X, f(2, 4)],
         grad=True),
    Case("mul", lambda m, d, x, y: m.mul(x, y, 1, 1),
         [f(2, 3, 4), f(12, 5)], grad=True),
    Case("scale", lambda m, d, x: m.scale(x, 2.0, 1.0), [X], grad=True),
    Case("scale", lambda m, d, x: m.scale(x, 2.0, 1.0, False), [X],
         grad=True, label="scale_bias_first"),
    Case("clip", lambda m, d, x: m.clip(x, -0.5, 0.5), [X], grad=True),
    Case("add_n", lambda m, d, x, y, z: m.add_n([x, y, z]), [X, Y, X],
         grad=True),
    Case("cumsum", lambda m, d, x: m.cumsum(x, axis=1), [X], grad=True),
    Case("cumsum", lambda m, d, x: m.cumsum(x), [X], grad=True,
         label="cumsum_flat"),
    Case("cumprod", lambda m, d, x: m.cumprod(x, dim=1), [X], grad=True),
    Case("lerp", lambda m, d, x, y: m.lerp(x, y, 0.3), [X, Y], grad=True),
    Case("einsum", lambda m, d, x, y: m.einsum("ij,kj->ik", x, y),
         [X, f(2, 4)], grad=True),
    Case("kron", lambda m, d, x, y: m.kron(x, y), [f(2, 2), f(2, 3)],
         grad=True),
    Case("trace", lambda m, d, x: m.trace(x, 1), [X], grad=True),
    Case("diag", lambda m, d, x: m.diag(x, -1), [f(3)], grad=True),
    Case("diag", lambda m, d, x: m.diag(x), [X], grad=True,
         label="diag_of_matrix"),
    Case("diagonal", lambda m, d, x: m.diagonal(x, 1), [X], grad=True),
    Case("nan_to_num", lambda m, d, x: m.nan_to_num(x, 0.5, 9.0, -9.0),
         [SPECIAL_VALUES]),
    Case("stanh", lambda m, d, x: m.stanh(x), [X], tol="special",
         grad=True),
    Case("increment", lambda m, d, x: m.increment(x, 2.0), [X], grad=True),
    *[_unary(n, tol="special") for n in (
        "exp", "expm1", "sin", "cos", "tan", "atan", "sinh", "cosh",
        "asinh", "erf", "tanh")],
    *[_unary(n, x=POS, tol="special") for n in (
        "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "digamma",
        "lgamma")],
    *[_unary(n, x=UNIT, tol="special") for n in (
        "asin", "acos", "atanh", "erfinv")],
    _unary("acosh", x=f(3, 4, lo=1.1, hi=3.0), tol="special"),
    *[_unary(n) for n in ("abs", "neg", "floor", "ceil", "round", "trunc",
                          "sign", "square")],
    _unary("reciprocal", x=POS),
    *[_unary(n, x=SPECIAL_VALUES, tol="exact", grad=False)
      for n in ("isnan", "isinf", "isfinite")],
]

# bool and integer operands promote as jnp promotes them (ROADMAP Queue 3,
# fault 1): bool as an int in integer arithmetic, as itself in abs and
# the roundings and in a product of bools
BOOLS = c([[True, False, True], [False, True, True]])
TRUES = c(np.ones((2, 3), bool))


def _promoted(name, call, inputs, tol="exact", label=None):
    return Case(name, call, inputs, tol=tol, label=label or f"{name}_bool",
                types=True)


PROMOTION = [
    *[_promoted(n, lambda m, d, x, y, n=n: getattr(m, n)(x, y),
                [BOOLS, TRUES]) for n in ("floor_divide", "remainder",
                                          "mod")],
    _promoted("pow", lambda m, d, x, y: m.pow(x, y), [BOOLS, BOOLS]),
    _promoted("logaddexp", lambda m, d, x, y: m.logaddexp(x, y),
              [c([[1, 2], [3, 4]], np.int64), c([[0, 5], [-1, 2]],
                                                 np.int64)],
              tol="special", label="logaddexp_int"),
    _promoted("logaddexp", lambda m, d, x, y: m.logaddexp(x, y),
              [BOOLS, TRUES], tol="special"),
    *[_promoted(n, lambda m, d, x, n=n: getattr(m, n)(x), [BOOLS])
      for n in ("abs", "floor", "ceil", "trunc")],
    _promoted("inner", lambda m, d, x, y: m.inner(x, y), [BOOLS, BOOLS]),
    _promoted("matmul", lambda m, d, x, y: m.matmul(x, y, transpose_y=True),
              [BOOLS, BOOLS]),
]

CASES = CREATION + MATH + PROMOTION


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_name_matches_the_jax_package(case):
    check_case(case)


# -- the random makers ----------------------------------------------------------

N = 20000

RANDOM = {
    "rand": (lambda m, d: m.rand([N], **d), (0.0, 1.0), 0.5, 1 / 12 ** 0.5),
    "randn": (lambda m, d: m.randn([N], **d), None, 0.0, 1.0),
    "standard_normal": (lambda m, d: m.standard_normal([N], **d), None,
                        0.0, 1.0),
    "uniform": (lambda m, d: m.uniform([N], min=-2.0, max=4.0, **d),
                (-2.0, 4.0), 1.0, 6 / 12 ** 0.5),
    "normal": (lambda m, d: m.normal(1.0, 2.0, [N], **d), None, 1.0, 2.0),
    "randint": (lambda m, d: m.randint(3, 9, [N], **d), (3, 8), 5.5,
                (35 / 12) ** 0.5),
    "randperm": (lambda m, d: m.randperm(N, **d), (0, N - 1), None, None),
    "bernoulli": (lambda m, d: m.bernoulli(m.full([N], 0.3, **d)), (0, 1),
                  0.3, (0.21) ** 0.5),
    "multinomial": (lambda m, d: m.multinomial(
        m.to_tensor(np.array([[0.2, 0.3, 0.5]] * (N // 4), np.float32))
        if m is jpt else torch.tensor([[0.2, 0.3, 0.5]] * (N // 4)), 2,
        False), (0, 2), None, None),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_maker_draws_the_distribution_repeatably(name):
    """Shape as the JAX maker's; range, mean and std within 4 standard
    errors (of N draws); the same seed draws the same numbers, the next
    draw others; the type is Paddle's (float32, int64 for the ints;
    the JAX package's ints are int32)."""
    call, span, mean, std = RANDOM[name]
    want = np.asarray(call(jpt, {})._data)
    trandom.seed(7)
    a = call(pt, CPU)
    again = call(pt, CPU)
    trandom.seed(7)
    b_ = call(pt, CPU)
    assert tuple(a.shape) == want.shape
    assert torch.equal(a, b_) and not torch.equal(a, again)
    assert a.dtype == (torch.int64 if want.dtype.kind == "i" else
                       torch.float32)
    v = a.double()
    if span is not None:
        assert span[0] <= float(v.min()) and float(v.max()) <= span[1]
    if name == "randperm":
        assert torch.equal(torch.sort(a).values, torch.arange(N))
    if name == "multinomial":
        assert bool((a[:, 0] != a[:, 1]).all())   # without replacement
    if mean is not None:
        se = std / N ** 0.5
        assert abs(float(v.mean()) - mean) < 4 * se, float(v.mean())
        assert abs(float(v.std()) - std) < 4 * std / (2 * N) ** 0.5 + 1e-3


def test_uniform_seed_repeats_and_takes_no_global_draw():
    """``uniform(seed=s)``: the same numbers for the same ``s`` whatever
    the global generator did, and the global generator untouched."""
    trandom.seed(3)
    first = pt.uniform([5], seed=11, device="cpu")
    nxt = pt.rand([5], device="cpu")
    trandom.seed(3)
    pt.rand([2], device="cpu")
    again = pt.uniform([5], seed=11, device="cpu")
    trandom.seed(3)
    assert torch.equal(first, again)
    assert torch.equal(pt.rand([5], device="cpu"), nxt)


# -- traps --------------------------------------------------------------------

def test_trap_9_empty_is_zeros_not_uninitialised():
    """``empty`` gives zeros, as the JAX package's does: with PyTorch's
    deterministic mode filling uninitialised memory with NaN, a plain
    ``torch.empty`` fails this check."""
    want = np.asarray(jpt.empty([4, 3])._data)
    on = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = pt.empty([4, 3], device="cpu").numpy()
        got_like = pt.empty_like(torch.ones(4, 3)).numpy()
        naive = torch.empty(4, 3).numpy()
    finally:
        torch.use_deterministic_algorithms(on)
    close(got, want, "exact", "empty")
    close(got_like, want, "exact", "empty_like")
    assert np.isnan(naive).all()


def test_floor_divide_and_remainder_follow_the_divisor_sign():
    """``[-3, 3]`` over ``[2, -2]``: ``[-2, -2]`` and ``[1, -1]`` in both
    packages; ``torch.fmod`` and truncating division give others."""
    x, y = np.array([-3, 3]), np.array([2, -2])
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jpt.to_tensor(x), jpt.to_tensor(y)
    assert pt.floor_divide(tx, ty).tolist() == [-2, -2] == \
        np.asarray(jpt.floor_divide(jx, jy)._data).tolist()
    assert pt.remainder(tx, ty).tolist() == [1, -1] == \
        np.asarray(jpt.remainder(jx, jy)._data).tolist()
    assert torch.fmod(tx, ty).tolist() != [1, -1]
    assert torch.div(tx, ty, rounding_mode="trunc").tolist() != [-2, -2]


def test_arange_and_makers_keep_paddles_types():
    """Trap 8: ``arange`` of ints is int64 (the JAX package's int32),
    of floats float32; the makers default to float32, as the JAX
    package's ``convert_dtype(None)``."""
    assert pt.arange(5, device="cpu").dtype == torch.int64
    assert np.asarray(jpt.arange(5)._data).dtype == np.int32
    assert pt.arange(0.0, 2.0, 0.5, device="cpu").dtype == torch.float32
    for name in ("zeros", "ones", "empty"):
        assert getattr(pt, name)([2], device="cpu").dtype == torch.float32
    assert pt.full([2], 3, device="cpu").dtype == torch.float32 == \
        getattr(torch, np.asarray(jpt.full([2], 3)._data).dtype.name)


def test_makers_default_to_the_card():
    """``device=None`` is the card (``_device.resolve_device``): without
    one, a maker raises rather than fall back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the makers run there")
    for make in (lambda: pt.zeros([2]), lambda: pt.arange(3),
                 lambda: pt.randn([2])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# -- the whole surface ----------------------------------------------------------

def test_every_top_level_name_resolves_and_has_a_case():
    """Every name ``paddle_tpu/__init__.py:84-125`` imports from its op
    modules resolves on ``paddle_tpu_torch`` (and ``ops``), callable,
    and has a case in one of the four tables; the port exports exactly
    those names."""
    from test_torch_tensor_linalg import CASES as LINALG
    from test_torch_tensor_manip import CASES as MANIP
    from test_torch_tensor_reduce import CASES as REDUCE

    names = covered_names()
    assert len(names) == len(set(names)) > 200
    cased = {case.name for case in CASES + REDUCE + MANIP + LINALG}
    cased |= set(RANDOM) | {"is_tensor"}
    missing = [n for n in names if not callable(getattr(pt, n, None))
               or not callable(getattr(pt.ops, n, None))]
    assert not missing, missing
    assert not [n for n in names if n not in cased]
    assert set(pt.ops.__all__) == set(names)
    assert not pt.is_tensor(np.ones(2)) and pt.is_tensor(torch.ones(2))
