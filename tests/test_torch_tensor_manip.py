"""paddle_tpu_torch's shape, gather, scatter and sorting ops
(``ops/manipulation.py``) against the JAX package's, one case a name,
on the CPU (``torch_tensor_parity``: tolerances there; gathers and
layout ops are held exactly, their gradients too). Traps 1 (a repeated
index of ``scatter(overwrite=True)``: the last write wins, and only it
takes a gradient), 2 (descending ``argsort`` is the ascending stable
sort reversed) and 3 (``topk`` puts the lower index first among ties)
have cases of their own on the inputs the JAX package was checked on;
the naive torch call fails each. ``topk``'s gradient is not held to the
JAX tape's, which keeps none (``test_torch_tensor_reduce``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt

from torch_tensor_parity import (Case, b, c, check_case, f, i, ids,
                                 to_numpy)

from torch_test_threads import torch_threads  # noqa: F401,E402

X = f(3, 4)
X3 = f(2, 3, 4)
ROWS = c([2, 0, 2, 1])


def _m(name, call, inputs, tol="exact", grad=True, label=None):
    return Case(name, call, inputs, tol=tol, grad=grad, label=label)


SHAPE = [
    _m("reshape", lambda m, d, x: m.reshape(x, [4, -1]), [X3]),
    _m("transpose", lambda m, d, x: m.transpose(x, [2, 0, 1]), [X3]),
    _m("t", lambda m, d, x: m.t(x), [X]),
    _m("flatten", lambda m, d, x: m.flatten(x, 1, 2), [X3]),
    _m("squeeze", lambda m, d, x: m.squeeze(x, [0, 2]), [f(1, 3, 1, 2)]),
    _m("unsqueeze", lambda m, d, x: m.unsqueeze(x, [0, 2]), [X]),
    _m("concat", lambda m, d, x, y: m.concat([x, y], axis=1), [X, X]),
    _m("stack", lambda m, d, x, y: m.stack([x, y], axis=1), [X, X]),
    _m("split", lambda m, d, x: m.split(x, [1, -1], axis=1), [X]),
    _m("chunk", lambda m, d, x: m.chunk(x, 2, axis=1), [X]),
    _m("unbind", lambda m, d, x: m.unbind(x, 1), [X]),
    # the JAX package's slice ops raise (test_jax_slice_ops_raise): held
    # to numpy's slicing instead
    Case("slice", lambda m, d, x: m.slice(x, [1, 2], [1, -3], [10, 3]),
         [X3], jax=False, check=lambda got, _, a: np.testing.
         assert_array_equal(got[0], a[0][:, 1:10, -3:3])),
    Case("strided_slice", lambda m, d, x: m.strided_slice(
        x, [1, 2], [2, 0], [-4, 4], [-2, 3]), [X3], jax=False,
        check=lambda got, _, a: np.testing.assert_array_equal(
            got[0], a[0][:, 2:-4:-2, 0:4:3])),
    _m("tile", lambda m, d, x: m.tile(x, [2, 1, 3]), [X]),
    _m("expand", lambda m, d, x: m.expand(x, [2, -1, 4]), [f(3, 1)]),
    _m("broadcast_to", lambda m, d, x: m.broadcast_to(x, [2, 3, 4]),
       [f(1, 4)]),
    _m("expand_as", lambda m, d, x, y: m.expand_as(x, y), [f(3, 1), X]),
    _m("repeat_interleave", lambda m, d, x: m.repeat_interleave(x, 2, 1),
       [X]),
    _m("repeat_interleave", lambda m, d, x: m.repeat_interleave(x, 3),
       [X], label="repeat_interleave_flat"),
    _m("flip", lambda m, d, x: m.flip(x, [0, 2]), [X3]),
    _m("roll", lambda m, d, x: m.roll(x, [1, -2], [0, 1]), [X]),
    _m("roll", lambda m, d, x: m.roll(x, 5), [X], label="roll_flat"),
    _m("pad", lambda m, d, x: m.pad(x, [1, 2], mode="reflect"), [X3]),
    _m("moveaxis", lambda m, d, x: m.moveaxis(x, 0, -1), [X3]),
    _m("swapaxes", lambda m, d, x: m.swapaxes(x, 0, 2), [X3]),
    _m("rot90", lambda m, d, x: m.rot90(x, 3, [1, 2]), [X3]),
    _m("cast", lambda m, d, x: m.cast(x, "int32"), [f(3, 4, lo=-9, hi=9)],
       grad=False),
    _m("cast", lambda m, d, x: m.cast(x, "float32"), [i(0, 9, 3, 4)],
       grad=False, label="cast_int_to_float"),
    _m("as_real", lambda m, d, x: m.as_real(x),
       [c([1 + 2j, -3.5j, 4.0], np.complex64)], grad=False),
    _m("as_complex", lambda m, d, x: m.as_complex(x), [f(3, 2)],
       grad=False),
]

GATHER = [
    _m("gather", lambda m, d, x, k: m.gather(x, k, axis=1), [X, ROWS]),
    _m("gather", lambda m, d, x, k: m.gather(x, k), [X, c(2)],
       label="gather_0d_index"),
    _m("gather_nd", lambda m, d, x, k: m.gather_nd(x, k),
       [X3, c([[1, 2], [0, 0], [1, 2]])]),
    _m("take_along_axis", lambda m, d, x, k: m.take_along_axis(x, k, 1),
       [X, c([[0, 0, 3], [1, 1, 1], [2, 3, 2]])]),
    _m("index_select", lambda m, d, x, k: m.index_select(x, k, axis=0),
       [X, c([2, 2, 0])]),
    _m("index_sample", lambda m, d, x, k: m.index_sample(x, k),
       [X, c([[3, 3], [0, 1], [2, 2]])]),
    _m("scatter", lambda m, d, x, k, u: m.scatter(x, k, u),
       [X, c([2, 0, 2]), f(3, 4)]),
    _m("scatter", lambda m, d, x, k, u: m.scatter(x, k, u, overwrite=False),
       [X, c([2, 0, 2]), f(3, 4)], tol="f32", label="scatter_add"),
    _m("scatter_nd", lambda m, d, k, u: m.scatter_nd(k, u, [3, 4]),
       [c([[1], [2], [1]]), f(3, 4)], tol="f32"),
    _m("scatter_nd_add", lambda m, d, x, k, u: m.scatter_nd_add(x, k, u),
       [X, c([[1, 2], [0, 0], [1, 2]]), f(3)], tol="f32"),
    _m("put_along_axis", lambda m, d, x, k, v: m.put_along_axis(x, k, v, 1),
       [X, c([[0, 0], [3, 1], [2, 2]]), f(3, 2)]),
    _m("put_along_axis", lambda m, d, x, k, v: m.put_along_axis(
        x, k, v, 1, "add"), [X, c([[0, 0], [3, 1], [2, 2]]), f(3, 2)],
       tol="f32", label="put_along_axis_add"),
    # JAX has no gradient of a multiply at repeated indices
    _m("put_along_axis", lambda m, d, x, k, v: m.put_along_axis(
        x, k, v, 0, "multiply"), [X, c([[0, 2, 1, 0], [0, 2, 1, 1]]),
                                  f(2, 4)],
       tol="f32", grad=False, label="put_along_axis_multiply"),
    _m("where", lambda m, d, k, x, y: m.where(k, x, y), [b(3, 4), X, X]),
    _m("masked_fill", lambda m, d, x, k: m.masked_fill(x, k, -1.5),
       [X, b(3, 4)]),
    _m("one_hot", lambda m, d, k: m.one_hot(k, 5), [i(0, 5, 2, 3)],
       grad=False),
    _m("shard_index", lambda m, d, k: m.shard_index(k, 20, 4, 1),
       [i(0, 20, 3, 4)], grad=False),
]

SORTING = [
    _m("topk", lambda m, d, x: m.topk(x, 2, axis=1), [X], grad=False),
    _m("topk", lambda m, d, x: m.topk(x, 3, axis=0, largest=False), [X],
       grad=False, label="topk_smallest"),
    _m("sort", lambda m, d, x: m.sort(x, axis=1, descending=True), [X]),
    _m("sort", lambda m, d, x: m.sort(x, axis=0),
       [c([[3.0, 1.0], [1.0, 1.0], [3.0, 0.0]], np.float32)],
       label="sort_ties"),
    _m("argsort", lambda m, d, x: m.argsort(x, axis=1), [X], grad=False),
    _m("argsort", lambda m, d, x: m.argsort(x, descending=True),
       [c([[3.0, 1.0, 3.0, 2.0, 3.0]], np.float32)], grad=False,
       label="argsort_descending_ties"),
]

DATA_SHAPED = [
    _m("nonzero", lambda m, d, x: m.nonzero(x), [i(-1, 2, 3, 4)],
       grad=False),
    _m("nonzero", lambda m, d, x: m.nonzero(x, as_tuple=True),
       [i(-1, 2, 3, 4)], grad=False, label="nonzero_tuple"),
    _m("masked_select", lambda m, d, x, k: m.masked_select(x, k),
       [X, b(3, 4)], grad=False),
    _m("unique", lambda m, d, x: m.unique(x, True, True, True),
       [i(0, 5, 3, 4)], grad=False),
    _m("unique", lambda m, d, x: m.unique(x, True, True, True, axis=0),
       [c([[1, 2], [0, 1], [1, 2], [0, 0]])], grad=False,
       label="unique_axis"),
    _m("bincount", lambda m, d, x: m.bincount(x, minlength=7),
       [i(0, 5, 12)], grad=False),
    _m("bincount", lambda m, d, x, w: m.bincount(x, w),
       [c([0, 3, 3, 1, 3]), f(5)], tol="f32", grad=False,
       label="bincount_weights"),
    # a bool counts as 0 and 1, as jnp promotes it (ROADMAP Queue 3,
    # fault 1)
    Case("bincount", lambda m, d, x: m.bincount(x),
         [c([True, False, True, True])], tol="exact",
         label="bincount_bool", types=True),
]

CASES = SHAPE + GATHER + SORTING + DATA_SHAPED


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_name_matches_the_jax_package(case):
    check_case(case)


def _jax(fn, *arrays, grad_at=()):
    xs = [jpt.to_tensor(a, stop_gradient=k not in grad_at)
          for k, a in enumerate(arrays)]
    return fn(*xs), xs


def test_trap_1_scatter_keeps_the_last_of_a_repeated_index():
    """``scatter(zeros(4), [1, 1, 2], [5, 7, 9])`` is ``[0, 7, 9, 0]`` in
    both packages, and only the last update of index 1 takes a gradient
    (the JAX tape's: ``[0, g1, g2]``); a plain ``index_put`` sends the
    gradient to both updates of index 1."""
    x, k = np.zeros(4, np.float32), np.array([1, 1, 2])
    u = np.array([5.0, 7.0, 9.0], np.float32)
    g = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    out, (jx, _, ju) = _jax(jpt.scatter, x, k, u, grad_at=(0, 2))
    jpt.sum(jpt.multiply(out, jpt.to_tensor(g))).backward()
    tu = torch.from_numpy(u).requires_grad_()
    got = pt.scatter(torch.from_numpy(x), torch.from_numpy(k), tu)
    (got * torch.from_numpy(g)).sum().backward()
    assert got.tolist() == to_numpy(out).tolist() == [0.0, 7.0, 9.0, 0.0]
    assert tu.grad.tolist() == to_numpy(ju.grad).tolist() == [0.0, 2.0, 3.0]
    nu = torch.from_numpy(u).requires_grad_()
    naive = torch.zeros(4).index_put((torch.from_numpy(k),), nu)
    (naive * torch.from_numpy(g)).sum().backward()
    assert nu.grad.tolist() != [0.0, 2.0, 3.0]


def test_trap_2_descending_argsort_reverses_the_ascending_order():
    """``[3, 1, 3, 2, 3]``: ``[4, 2, 0, 3, 1]`` in both packages (the
    JAX package flips an ascending stable sort); torch's stable
    descending sort gives ``[0, 2, 4, 3, 1]``."""
    x = np.array([3.0, 1.0, 3.0, 2.0, 3.0], np.float32)
    got = pt.argsort(torch.from_numpy(x), descending=True).tolist()
    want = to_numpy(jpt.argsort(jpt.to_tensor(x), descending=True)).tolist()
    assert got == want == [4, 2, 0, 3, 1]
    assert torch.sort(torch.from_numpy(x), descending=True,
                      stable=True).indices.tolist() == [0, 2, 4, 3, 1]


def test_trap_3_topk_puts_the_lower_index_first_among_ties():
    """``topk`` of ``[3, 1, 3, 2, 3]`` with k 2 is ``[0, 2]``, and of
    ``[1, 0, 1, 0]`` smallest-first ``[1, 3]``, in both packages
    (``lax.top_k``). (``torch.topk`` gives no tie order on the card:
    ``test_torch_cuda.py`` holds the port there.)"""
    for x, largest, want in (([3.0, 1.0, 3.0, 2.0, 3.0], True, [0, 2]),
                             ([1.0, 0.0, 1.0, 0.0], False, [1, 3])):
        a = np.array(x, np.float32)
        got = pt.topk(torch.from_numpy(a), 2, largest=largest)[1].tolist()
        ref = to_numpy(jpt.topk(jpt.to_tensor(a), 2,
                                largest=largest)[1]).tolist()
        assert got == ref == want


def test_jax_slice_ops_raise():
    """The JAX package's ``slice`` and ``strided_slice`` raise
    ``TypeError``: their kernels build Python slices with ``slice(...)``,
    which the module's own ``slice`` op shadows
    (``ops/manipulation.py:149, 163``). The port's follow numpy's
    slicing (a reference behaviour, not a port fault: ROADMAP)."""
    x = jpt.to_tensor(np.zeros((2, 5), np.float32))
    with pytest.raises(TypeError, match="slice"):
        jpt.slice(x, [1], [1], [3])
    with pytest.raises(TypeError, match="slice"):
        jpt.strided_slice(x, [1], [4], [0], [-2])
    got = pt.strided_slice(torch.arange(10), [0], [8], [1], [-3])
    assert got.tolist() == list(range(10))[8:1:-3]


def test_gather_backwards_add_repeated_indices():
    """The gathers' gradients at a repeated index add up, as the JAX
    tape's do, through the port's deterministic ``index_put_``."""
    x = torch.randn(3, 4, requires_grad=True)
    pt.gather(x, torch.tensor([1, 1, 0, 1]), axis=1).sum().backward()
    assert x.grad[:, 1].tolist() == [3.0] * 3
    assert x.grad[:, 0].tolist() == [1.0] * 3
