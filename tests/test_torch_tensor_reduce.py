"""paddle_tpu_torch's reductions and comparisons (``ops/reduction.py``,
``ops/compare.py``) against the JAX package's, one case a name, on the
CPU (``torch_tensor_parity``: tolerances there). Traps 4 (``median`` of
an even count) and 5 (``mode`` and ``kthvalue``'s index under ties)
have cases of their own on the inputs the JAX package was checked on;
the naive torch call fails each.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt

from torch_tensor_parity import Case, b, c, check_case, f, i, ids, to_numpy

from torch_test_threads import torch_threads  # noqa: F401,E402

X = f(3, 4)
Y = f(3, 4)
X3 = f(2, 3, 4)
TIES = c([[2.0, 1.0, 1.0, 2.0, 3.0], [0.0, 4.0, 4.0, 0.0, 4.0]],
         np.float32)


def _red(name, call, x=X, tol="f32", grad=True, label=None):
    return Case(name, call, [x], tol=tol, grad=grad, label=label)


REDUCTION = [
    _red("sum", lambda m, d, x: m.sum(x)),
    _red("sum", lambda m, d, x: m.sum(x, axis=[0, 2], keepdim=True), X3,
         label="sum_axes_keepdim"),
    _red("sum", lambda m, d, x: m.sum(x, axis=1), i(-3, 4, 3, 4),
         tol="exact", grad=False, label="sum_int"),
    _red("mean", lambda m, d, x: m.mean(x, axis=-1)),
    _red("max", lambda m, d, x: m.max(x, axis=1)),
    _red("max", lambda m, d, x: m.max(x), TIES, label="max_ties"),
    _red("min", lambda m, d, x: m.min(x, axis=0, keepdim=True)),
    _red("amax", lambda m, d, x: m.amax(x, axis=[0, 1]), X3),
    _red("amin", lambda m, d, x: m.amin(x, axis=-1)),
    _red("prod", lambda m, d, x: m.prod(x, axis=1)),
    _red("prod", lambda m, d, x: m.prod(x, axis=[0, 2]), X3,
         label="prod_axes"),
    _red("all", lambda m, d, x: m.all(x, axis=1), b(3, 4), tol="exact",
         grad=False),
    _red("any", lambda m, d, x: m.any(x, axis=0), b(3, 4), tol="exact",
         grad=False),
    _red("logsumexp", lambda m, d, x: m.logsumexp(x, axis=1),
         tol="special"),
    _red("logsumexp", lambda m, d, x: m.logsumexp(x), tol="special",
         label="logsumexp_all"),
    _red("argmax", lambda m, d, x: m.argmax(x, axis=1), tol="exact",
         grad=False),
    _red("argmax", lambda m, d, x: m.argmax(x), TIES, tol="exact",
         grad=False, label="argmax_flat_ties"),
    _red("argmin", lambda m, d, x: m.argmin(x, axis=0, keepdim=True),
         tol="exact", grad=False),
    _red("std", lambda m, d, x: m.std(x, axis=1)),
    _red("std", lambda m, d, x: m.std(x, unbiased=False),
         label="std_biased"),
    _red("var", lambda m, d, x: m.var(x, axis=0)),
    _red("median", lambda m, d, x: m.median(x, axis=1)),
    _red("median", lambda m, d, x: m.median(x, axis=0), label="median_odd"),
    _red("median", lambda m, d, x: m.median(x), label="median_all"),
    _red("quantile", lambda m, d, x: m.quantile(x, 0.3, axis=1)),
    _red("quantile", lambda m, d, x: m.quantile(x, [0.25, 0.9], axis=0),
         label="quantile_list"),
    # the JAX tape keeps no gradient of an op with an index output
    # (test_jax_tape_drops_the_gradient_of_ops_with_an_index_output)
    _red("kthvalue", lambda m, d, x: m.kthvalue(x, 2, axis=1), grad=False),
    _red("kthvalue", lambda m, d, x: m.kthvalue(x, 3, axis=-1), TIES,
         grad=False, label="kthvalue_ties"),
    _red("mode_op", lambda m, d, x: m.mode_op(x, axis=1), TIES,
         grad=False),
    _red("count_nonzero", lambda m, d, x: m.count_nonzero(x, axis=1),
         i(-1, 2, 3, 4), tol="exact", grad=False),
    _red("nansum", lambda m, d, x: m.nansum(x, axis=1),
         c([[np.nan, 1.0, 2.0], [3.0, np.nan, np.nan]], np.float32)),
    _red("nanmean", lambda m, d, x: m.nanmean(x, axis=1),
         c([[np.nan, 1.0, 2.0], [3.0, np.nan, 4.0]], np.float32)),
]


def _cmp(name, x=X, y=Y):
    return Case(name, lambda m, d, a, b_: getattr(m, name)(a, b_), [x, y],
                tol="exact")


INTS = i(0, 8, 3, 4)
COMPARE = [
    *[_cmp(n, X, c(np.where(np.arange(12).reshape(3, 4) % 3 == 0, 0.0,
                            np.random.RandomState(0).randn(3, 4)),
                   np.float32))
      for n in ("equal", "not_equal", "less_than", "less_equal",
                "greater_than", "greater_equal")],
    Case("equal", lambda m, d, x: m.equal(x, 2), [INTS], tol="exact",
         label="equal_scalar"),
    *[_cmp(n, b(3, 4), b(3, 4)) for n in (
        "logical_and", "logical_or", "logical_xor")],
    Case("logical_not", lambda m, d, x: m.logical_not(x), [b(3, 4)],
         tol="exact"),
    Case("logical_and", lambda m, d, x, y: m.logical_and(x, y), [X, INTS],
         tol="exact", label="logical_and_numbers"),
    *[_cmp(n, INTS, i(0, 8, 3, 4)) for n in (
        "bitwise_and", "bitwise_or", "bitwise_xor")],
    Case("bitwise_not", lambda m, d, x: m.bitwise_not(x), [INTS],
         tol="exact"),
    Case("bitwise_not", lambda m, d, x: m.bitwise_not(x), [b(3, 4)],
         tol="exact", label="bitwise_not_bool"),
    Case("isclose", lambda m, d, x, y: m.isclose(x, y, 1e-2, 1e-3),
         [X, X], tol="exact"),
    Case("isclose", lambda m, d, x, y: m.isclose(x, y, equal_nan=True),
         [c([np.nan, 1.0, np.inf], np.float32),
          c([np.nan, 1.0 + 1e-7, np.inf], np.float32)], tol="exact",
         label="isclose_equal_nan"),
    Case("allclose", lambda m, d, x, y: m.allclose(x, y), [X, X],
         tol="exact"),
    Case("allclose", lambda m, d, x, y: m.allclose(x, y, equal_nan=True),
         [c([np.nan, 1.0], np.float32), c([np.nan, 1.0], np.float32)],
         tol="exact", label="allclose_equal_nan"),
    Case("equal_all", lambda m, d, x, y: m.equal_all(x, y), [INTS, INTS],
         tol="exact"),
    Case("equal_all", lambda m, d, x, y: m.equal_all(x, y),
         [INTS, i(0, 8, 3, 3)], tol="exact", label="equal_all_shapes"),
    Case("is_empty", lambda m, d, x: m.is_empty(x),
         [c(np.zeros((0, 3), np.float32))], tol="exact"),
    Case("is_empty", lambda m, d, x: m.is_empty(x), [X], tol="exact",
         label="is_empty_not"),
]

# integer and bool inputs promote as jnp promotes them (ROADMAP Queue 3,
# fault 1): float32 means and variances, bool arg-extremes
INTS22 = c([[1, 2], [3, 4]], np.int64)
BOOLS = c([[True, False, True], [False, True, True]])


def _promoted(name, call, x, tol="f32", label=None):
    return Case(name, call, [x], tol=tol, label=label, types=True)


PROMOTION = [
    *[_promoted(n, lambda m, d, x, n=n: getattr(m, n)(x), INTS22,
                label=f"{n}_int") for n in ("mean", "std", "var",
                                            "nanmean")],
    *[_promoted(n, lambda m, d, x, n=n: getattr(m, n)(x, axis=1), BOOLS,
                label=f"{n}_bool") for n in ("mean", "std", "var",
                                             "nanmean")],
    _promoted("argmax", lambda m, d, x: m.argmax(x, axis=1), BOOLS,
              tol="exact", label="argmax_bool"),
    _promoted("argmin", lambda m, d, x: m.argmin(x), BOOLS, tol="exact",
              label="argmin_bool"),
]

CASES = REDUCTION + COMPARE + PROMOTION


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_name_matches_the_jax_package(case):
    check_case(case)


def test_equal_all_and_is_empty_are_0d_tensors_on_the_device():
    x = torch.ones(2, 3)
    for out, want in ((pt.equal_all(x, x), True), (pt.is_empty(x), False),
                      (pt.allclose(x, x), True)):
        assert isinstance(out, torch.Tensor) and out.shape == ()
        assert out.dtype == torch.bool and bool(out) is want


def test_jax_tape_drops_the_gradient_of_ops_with_an_index_output():
    """The JAX package's eager tape records no op whose outputs are not
    all floats (``core/dispatch.py:227-230``): ``kthvalue``, ``mode`` and
    ``topk`` give their input no gradient there. The port's autograd
    sends each value's gradient to the element it came from. (A
    reference behaviour, not a port fault: ROADMAP.)"""
    a = np.array([[3.0, 1.0, 2.0], [0.5, 4.0, 4.0]], np.float32)
    g = np.array([2.0, 5.0], np.float32)
    for name, call, at in (
            ("kthvalue", lambda m, x: m.kthvalue(x, 2, axis=1)[0],
             [(0, 2), (1, 1)]),
            ("mode_op", lambda m, x: m.mode_op(x, axis=1)[0],
             [(0, 0), (1, 1)]),
            ("topk", lambda m, x: m.topk(x, 1, axis=1)[0][:, 0],
             [(0, 0), (1, 1)])):
        jx = jpt.to_tensor(a, stop_gradient=False)
        jpt.sum(jpt.multiply(call(jpt, jx), jpt.to_tensor(g))).backward()
        assert jx.grad is None or not np.asarray(jx.grad._data).any(), name
        tx = torch.from_numpy(a).requires_grad_()
        (call(pt, tx) * torch.from_numpy(g)).sum().backward()
        want = np.zeros_like(a)
        for (r, k), v in zip(at, g):
            want[r, k] = v
        np.testing.assert_array_equal(tx.grad.numpy(), want, err_msg=name)


def _jax(fn, *arrays):
    outs = fn(*[jpt.to_tensor(a) for a in arrays])
    return [to_numpy(o) for o in (outs if isinstance(outs, (tuple, list))
                                  else [outs])]


def test_trap_4_median_of_an_even_count_averages():
    """``[4, 1, 3, 2]``: 2.5 in both packages; ``torch.median`` takes the
    lower middle value, 2.0."""
    x = np.array([4.0, 1.0, 3.0, 2.0], np.float32)
    got = float(pt.median(torch.from_numpy(x)))
    assert got == float(_jax(jpt.median, x)[0]) == 2.5
    assert float(torch.median(torch.from_numpy(x))) == 2.0


def test_trap_5_mode_is_the_first_most_frequent_value():
    """``[2, 1, 1, 2, 3]``: ``(2.0, 0)`` in both packages (of the two
    values that occur twice, the one that occurs first); ``torch.mode``
    gives ``(1.0, 2)``."""
    x = np.array([2.0, 1.0, 1.0, 2.0, 3.0], np.float32)
    v, k = pt.mode_op(torch.from_numpy(x))
    jv, jk = _jax(jpt.mode_op, x)
    assert (float(v), int(k)) == (float(jv), int(jk)) == (2.0, 0)
    tv, tk = torch.mode(torch.from_numpy(x))
    assert (float(tv), int(tk)) == (1.0, 2)


def test_trap_5_kthvalue_index_under_ties_is_the_stable_sorts():
    """The 3rd smallest of ``[1, 0, 1, 0]`` is the first 1, index 0,
    in both packages (a stable sort); ``torch.kthvalue`` gives index 2
    on the CPU."""
    x = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    v, k = pt.kthvalue(torch.from_numpy(x), 3)
    jv, jk = _jax(lambda t: jpt.kthvalue(t, 3), x)
    assert (float(v), int(k)) == (float(jv), int(jk)) == (1.0, 0)
    assert int(torch.kthvalue(torch.from_numpy(x), 3).indices) == 2


def test_trap_8_indices_are_int64_where_the_jax_package_has_int32():
    x = torch.randn(3, 4)
    for out in (pt.argmax(x), pt.argmin(x, axis=1), pt.kthvalue(x, 2)[1],
                pt.mode_op(x)[1]):
        assert out.dtype == torch.int64
    assert _jax(jpt.argmax, x.numpy())[0].dtype == np.int32
