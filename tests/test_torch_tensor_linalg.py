"""paddle_tpu_torch's linear algebra and control flow (``ops/linalg.py``,
``ops/control_flow.py``) against the JAX package's, on the CPU
(``torch_tensor_parity``: linalg within 1e-4 relative; decompositions
held by their invariants: the reconstruction, the singular values or
eigenvalues, ``|Q|`` and the columns of ``V`` up to sign).

Trap 6 (``svd`` returns ``V``, not ``Vᴴ``) and trap 7 (``lstsq`` is an
SVD solve that takes a rank-deficient system and returns the rank and
the singular values) have cases of their own; the naive torch call
fails each. Control flow: forward values against the JAX package run
eagerly and under its ``TrainStep``; gradients against its eager
``cond``; its ``TrainStep`` keeps a parameter trained through ``cond``
or ``scan`` where it was (trap 10, asserted so that a fix to the
reference shows); in a static Program the four branching ops raise in
both packages (trap 11).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu import optim as joptim
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, nn, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.nn import functional as F

from torch_tensor_parity import (Case, c, check_case, close, f, i, ids,
                                 spd, to_numpy)

from torch_test_threads import torch_threads  # noqa: F401,E402

X = f(3, 4)
SQ = f(4, 4)
SPD = spd(4)
UPPER = lambda r: (np.triu(r.randn(4, 4)) + 4 * np.eye(4)).astype(
    np.float32)


def _la(name, call, inputs, grad=True, tol="linalg", label=None,
        check=None):
    return Case(name, call, inputs, tol=tol, grad=grad, label=label,
                check=check)


def _sign_fixed(m):
    """Columns of ``m`` with the sign that makes the largest |entry|
    positive."""
    m = np.asarray(m, np.float64)
    k = np.argmax(np.abs(m), axis=0)
    return m * np.sign(m[k, np.arange(m.shape[1])])


def _svd_check(got, want, a):
    u, s, v = got
    a = a[0]
    assert v.shape == (a.shape[1], min(a.shape)), v.shape   # trap 6
    close(u @ np.diag(s) @ v.T, a, "linalg", "svd reconstruction")
    close(s, want[1], "linalg", "singular values")
    close(_sign_fixed(v), _sign_fixed(want[2]), "linalg", "V up to sign")


def _qr_check(got, want, a):
    q, r = got
    close(q @ r, a[0], "linalg", "qr reconstruction")
    close(np.abs(q), np.abs(want[0]), "linalg", "|Q|")
    close(np.abs(r), np.abs(want[1]), "linalg", "|R|")


def _eig_check(got, want, a):
    w, v = got
    close(np.sort_complex(w), np.sort_complex(want[0]), "linalg",
          "eigenvalues")
    close(a[0] @ v, v * w, "linalg", "A v = v diag(w)")


def _eigh_check(got, want, a):
    w, v = got
    close(w, want[0], "linalg", "eigenvalues")
    close(_sign_fixed(v), _sign_fixed(want[1]), "linalg", "V up to sign")


LINALG = [
    _la("norm", lambda m, d, x: m.norm(x), [X]),
    _la("norm", lambda m, d, x: m.norm(x, p=1, axis=1), [X],
        label="norm_p1"),
    _la("norm", lambda m, d, x: m.norm(x, p=float("inf"), axis=0), [X],
        label="norm_inf"),
    _la("norm", lambda m, d, x: m.norm(x, p=0, axis=1), [X], grad=False,
        label="norm_p0"),
    _la("norm", lambda m, d, x: m.norm(x, p=3, axis=[0, 1],
                                       keepdim=True), [X],
        label="norm_p3_axes"),
    _la("norm", lambda m, d, x: m.norm(x, p="fro", axis=[0, 1]), [X],
        label="norm_fro_axes"),
    _la("dist", lambda m, d, x, y: m.dist(x, y, 2.0), [X, X]),
    _la("cholesky", lambda m, d, x: m.cholesky(x), [SPD]),
    _la("cholesky", lambda m, d, x: m.cholesky(x, upper=True), [SPD],
        label="cholesky_upper"),
    _la("inverse", lambda m, d, x: m.inverse(x), [SPD]),
    _la("matrix_power", lambda m, d, x: m.matrix_power(x, 3), [SQ]),
    _la("pinv", lambda m, d, x: m.pinv(x), [X]),
    _la("svd", lambda m, d, x: m.svd(x), [f(2, 3)], grad=False,
        check=_svd_check),
    _la("svd", lambda m, d, x: m.svd(x), [X], grad=False, check=_svd_check,
        label="svd_3x4"),
    _la("qr", lambda m, d, x: m.qr(x), [f(4, 3)], grad=False,
        check=_qr_check),
    _la("eig", lambda m, d, x: m.eig(x), [SQ], grad=False,
        check=_eig_check),
    _la("eigvals", lambda m, d, x: m.eigvals(x), [SQ], grad=False,
        check=lambda got, want, a: close(
            np.sort_complex(got[0]), np.sort_complex(want[0]), "linalg",
            "eigenvalues")),
    _la("eigh", lambda m, d, x: m.eigh(x), [SPD], grad=False,
        check=_eigh_check),
    # the JAX package's decompositions are off its tape: values only
    _la("eigvalsh", lambda m, d, x: m.eigvalsh(x, "U"), [SPD], grad=False),
    _la("matrix_rank", lambda m, d, x: m.matrix_rank(x), [X], grad=False,
        tol="exact"),
    _la("matrix_rank", lambda m, d, x: m.matrix_rank(x, 0.5),
        [c(np.diag([4.0, 1.0, 1e-3]).astype(np.float32))], grad=False,
        tol="exact", label="matrix_rank_tol"),
    _la("det", lambda m, d, x: m.det(x), [SQ]),
    _la("slogdet", lambda m, d, x: m.slogdet(x), [SQ]),
    _la("cross", lambda m, d, x, y: m.cross(x, y), [f(2, 3), f(2, 3)]),
    _la("triangular_solve", lambda m, d, x, y: m.triangular_solve(x, y),
        [UPPER, f(4, 2)]),
    _la("triangular_solve", lambda m, d, x, y: m.triangular_solve(
        x, y, transpose=True, unitriangular=True), [UPPER, f(4, 2)],
        label="triangular_solve_transposed"),
    _la("cholesky_solve", lambda m, d, b_, L: m.cholesky_solve(b_, L),
        [f(4, 2), lambda r: np.linalg.cholesky(SPD(r)).astype(np.float32)]),
    _la("solve", lambda m, d, x, y: m.solve(x, y), [SPD, f(4, 2)]),
    _la("lstsq", lambda m, d, x, y: m.lstsq(x, y), [f(5, 3), f(5, 2)],
        grad=False),
    _la("histogram", lambda m, d, x: m.histogram(x, bins=5), [f(40)],
        grad=False, tol="exact"),
    _la("histogram", lambda m, d, x: m.histogram(x, 4, -1, 1), [f(40)],
        grad=False, tol="exact", label="histogram_range"),
    _la("mv", lambda m, d, x, v: m.mv(x, v), [X, f(4)]),
    _la("multi_dot", lambda m, d, x, y, z: m.multi_dot([x, y, z]),
        [f(2, 3), X, f(4, 2)]),
    _la("cov", lambda m, d, x: m.cov(x), [X]),
    _la("cov", lambda m, d, x: m.cov(x, rowvar=False, ddof=False), [X],
        label="cov_columns"),
    _la("corrcoef", lambda m, d, x: m.corrcoef(x), [X]),
]


# integer and bool matrices promote as jnp promotes them (ROADMAP Queue
# 3, fault 1): float32 decompositions and statistics, bool products
INTS23 = c([[1, 2, 3], [4, 6, 5]], np.int64)
BOOLS = c([[True, False, True], [False, True, True]])


def _promoted(name, call, inputs, tol="linalg", label=None):
    return Case(name, call, inputs, tol=tol, label=label, types=True)


PROMOTION = [
    *[_promoted(n, call, [x], label=f"{n}_{kind}")
      for kind, x in (("int", INTS23), ("bool", BOOLS))
      for n, call in (
          ("pinv", lambda m, d, x: m.pinv(x)),
          # values only where the vectors' signs are free
          ("svd", lambda m, d, x: m.svd(x)[1]),
          ("qr", lambda m, d, x: m.abs(m.qr(x)[1])),
          ("matrix_rank", lambda m, d, x: m.matrix_rank(x)))],
    # torch's cov takes integers, not bools
    _promoted("cov", lambda m, d, x: m.cov(x), [BOOLS], label="cov_bool"),
    _promoted("corrcoef", lambda m, d, x: m.corrcoef(x), [BOOLS],
              label="corrcoef_bool"),
    _promoted("lstsq", lambda m, d, x, y: m.lstsq(x, y)[0],
              [c([[1, 2], [3, 4], [5, 7]], np.int64),
               c([1, 2, 4], np.int64)], label="lstsq_int"),
    _promoted("lstsq", lambda m, d, x, y: m.lstsq(x, y)[0],
              [c([[True, False], [True, True], [False, True]]),
               c([True, False, True])], label="lstsq_bool"),
    _promoted("det", lambda m, d, x: m.det(x),
              [c([[1, 2], [3, 4]], np.int64)], label="det_int"),
    _promoted("mv", lambda m, d, x, v: m.mv(x, v),
              [BOOLS, c([False, True, False])], tol="exact",
              label="mv_bool"),
    _promoted("multi_dot", lambda m, d, x, y, z: m.multi_dot([x, y, z]),
              [BOOLS, c(np.array([[True, False], [False, False],
                                  [False, True]])), BOOLS],
              tol="exact", label="multi_dot_bool"),
]


def _pred(m, x):
    return m.less_than(m.sum(x), m.full([], 0.0, **(
        {"device": "cpu"} if m is pt else {})))


CONTROL = [
    Case("cond", lambda m, d, x: m.cond(_pred(m, x), lambda: x * 2.0,
                                        lambda: m.exp(x)), [X], grad=True,
         tol="special"),
    Case("cond", lambda m, d, x: m.cond(True, lambda: m.sum(x * x)),
         [X], grad=True, label="cond_python_predicate"),
    Case("while_loop", lambda m, d, k, x: m.while_loop(
        lambda n, s: m.less_than(n, m.full_like(n, 3)),
        lambda n, s: [n + 1, s * 2.0 + 1.0], [k, x]),
        [c(0), X], grad=True),
    Case("case", lambda m, d, x: m.case(
        [(m.greater_than(m.sum(x), m.full_like(m.sum(x), 100.0)),
          lambda: x * 0.0), (m.less_than(m.max(x), m.full_like(
              m.max(x), 100.0)), lambda: x * 3.0)],
        default=lambda: x), [X], grad=True),
    Case("switch_case", lambda m, d, k, x: m.switch_case(
        k, [lambda: x + 1.0, lambda: x * x, lambda: x]), [c(1), X],
         grad=True),
    Case("switch_case", lambda m, d, k, x: m.switch_case(
        k, {3: lambda: x * 4.0, 7: lambda: x}, default=lambda: -x),
         [c(5), X], grad=True, label="switch_case_dict_default"),
    # lax.scan's tape keeps no gradient: trap 10
    Case("scan", lambda m, d, x: m.scan(lambda cy, r: (cy + r, cy * r),
                                        x[0] * 0.0, x), [X]),
    Case("scan", lambda m, d, x: m.scan(lambda cy, r: (cy * 0.5 + r, cy),
                                        x[0], x, reverse=True), [X],
         label="scan_reverse"),
]

CASES = LINALG + CONTROL + PROMOTION


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_name_matches_the_jax_package(case):
    check_case(case)


def test_trap_6_svd_returns_v_not_vh():
    """For a (2, 3) input ``v`` is (3, 2) in both packages: ``x = U
    diag(S) Vᵀ``. ``torch.linalg.svd``'s third output is ``Vᴴ``,
    (2, 3)."""
    a = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    _, _, v = pt.svd(torch.from_numpy(a))
    jv = to_numpy(jpt.svd(jpt.to_tensor(a))[2])
    assert tuple(v.shape) == jv.shape == (3, 2)
    assert tuple(torch.linalg.svd(torch.from_numpy(a),
                                  full_matrices=False)[2].shape) == (2, 3)


def test_trap_7_lstsq_solves_a_rank_deficient_system():
    """A (5, 3) system of rank 2: the port gives the JAX package's
    minimum-norm solution, residuals, rank 2 and singular values; the
    ``gels`` driver (the only one ``torch.linalg.lstsq`` has on the card)
    gives another solution and no rank or singular values."""
    rng = np.random.RandomState(0)
    a = rng.randn(5, 2) @ rng.randn(2, 3)
    a = a.astype(np.float32)
    y = rng.randn(5, 2).astype(np.float32)
    got = [to_numpy(t) for t in pt.lstsq(torch.from_numpy(a),
                                         torch.from_numpy(y))]
    want = [to_numpy(t) for t in jpt.lstsq(jpt.to_tensor(a),
                                           jpt.to_tensor(y))]
    assert int(got[2]) == int(want[2]) == 2
    for k, what in enumerate(("solution", "residuals", "rank", "s")):
        close(got[k], want[k], "linalg", what)
    naive = torch.linalg.lstsq(torch.from_numpy(a), torch.from_numpy(y),
                               driver="gels")
    assert naive.rank.numel() == 0 and naive.singular_values.numel() == 0
    assert not np.allclose(naive.solution.numpy(), want[0], atol=1e-3)


def _linear_pair():
    jpt.seed(0)
    jl = jnn.Linear(4, 3)
    tl = nn.Linear(4, 3, device="cpu")
    tl.load_state_dict(convert.layer_params_from_jax(
        {k: np.asarray(v._data) for k, v in jl.state_dict().items()}, tl))
    return jl, tl


def _cond_loss(m, Fm):
    def loss(model, x, y):
        out = model(x)
        return m.cond(m.greater_than(m.sum(y), m.sum(y) * 0.0 - 1.0),
                      lambda: Fm.mse_loss(out, y),
                      lambda: Fm.mse_loss(out * 2.0, y))
    return loss


def _scan_loss(m, Fm):
    def loss(model, x, y):
        _, hs = m.scan(lambda cy, r: (cy, model(r)), x[0] * 0.0, x)
        return Fm.mse_loss(hs, y)
    return loss


def _batch():
    rng = np.random.RandomState(2)
    return (rng.randn(5, 4).astype(np.float32),
            rng.randn(5, 3).astype(np.float32))


@pytest.mark.parametrize("kind", ["cond", "scan"])
def test_trap_10_jax_trainstep_keeps_weights_through_control_flow(kind):
    """The JAX package's ``TrainStep`` traces ``cond``'s and ``scan``'s
    bodies through ``lax.cond``/``lax.scan``, where its tape sees none of
    their ops: the ``Linear`` gets no gradient and never moves, and the
    loss repeats. The port's ``TrainStep`` takes the same first loss
    (forward values held to the JAX package's) and moves the weights by
    autograd."""
    make = _cond_loss if kind == "cond" else _scan_loss
    jl, tl = _linear_pair()
    w0 = np.asarray(jl.weight._data).copy()
    jstep = jpt.TrainStep(jl, joptim.SGD(0.1, parameters=jl.parameters()),
                          make(jpt, JF))
    step = TrainStep(tl, optim.SGD(0.1, parameters=tl.named_parameters()),
                     make(pt, F))
    batch = _batch()
    jl_losses = [float(np.asarray(jstep(*batch)._data)) for _ in range(3)]
    t_losses = [float(step(*batch)) for _ in range(3)]
    assert jl_losses[0] == jl_losses[1] == jl_losses[2]
    np.testing.assert_array_equal(np.asarray(jl.weight._data), w0)
    np.testing.assert_allclose(t_losses[0], jl_losses[0], rtol=1e-6)
    assert t_losses[2] < t_losses[0]
    assert not np.array_equal(tl.weight.detach().numpy(), w0)


def test_cond_gradient_is_the_jax_eager_one():
    """Run eagerly (a concrete predicate), the JAX tape differentiates
    the branch ``cond`` took; the port's autograd gives the same
    gradients (and the forward loss)."""
    jl, tl = _linear_pair()
    x, y = _batch()
    jloss = _cond_loss(jpt, JF)(jl, jpt.to_tensor(x), jpt.to_tensor(y))
    jloss.backward()
    tloss = _cond_loss(pt, F)(tl, torch.from_numpy(x), torch.from_numpy(y))
    tloss.backward()
    close(float(tloss), float(np.asarray(jloss._data)), "f32", "loss")
    jp = dict(jl.named_parameters())
    for name, p in tl.named_parameters():
        close(p.grad.numpy(), np.asarray(jp[name].grad._data), "f32", name)
        assert np.abs(p.grad.numpy()).max() > 0.1


@pytest.mark.parametrize("op", ["cond", "while_loop", "case",
                                "switch_case"])
def test_trap_11_branching_on_a_static_variable_raises(op):
    """In a static Program the port refuses ``cond``, ``while_loop``,
    ``case`` and ``switch_case`` on a Variable with
    ``NotImplementedError``; the JAX package fails there too
    (``TypeError`` or ``AttributeError`` while it records)."""
    calls = {
        "cond": lambda m, v: m.cond(v, lambda: v, lambda: v),
        "while_loop": lambda m, v: m.while_loop(lambda s: v, lambda s: [s],
                                                [v]),
        "case": lambda m, v: m.case([(v, lambda: v)], default=lambda: v),
        "switch_case": lambda m, v: m.switch_case(v, [lambda: v]),
    }
    pt.enable_static()
    try:
        main = pt.static.Program()
        with pt.program_guard(main, pt.static.Program()):
            v = pt.static.data("p", [1], "bool")
            with pytest.raises(NotImplementedError, match="static"):
                calls[op](pt, v)
    finally:
        pt.disable_static()
    jpt.enable_static()
    try:
        main = jpt.static.Program()
        with jpt.program_guard(main, jpt.static.Program()):
            v = jpt.static.data("p", [1], "bool")
            with pytest.raises((TypeError, AttributeError)):
                calls[op](jpt, v)
    finally:
        jpt.disable_static()
