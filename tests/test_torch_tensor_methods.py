"""paddle_tpu_torch's ``Tensor``: the reference's method table, its
operators and its class surface, against the JAX package's on the CPU.

- every key of ``paddle_tpu.ops._METHODS``, every operator ``_rops``
  attaches and every public attribute of ``paddle_tpu.core.tensor
  .Tensor`` resolves on ``paddle_tpu_torch.Tensor``, and ``torch.Tensor``
  gains none of them;
- each of the 139 methods called as a method on both packages: a case of
  the tensor-API tables (``torch_tensor_parity.Case``, the first whose call
  reaches the method) run through the method spelling (``m.sum(x, 1)``
  as ``x.sum(1)``), held to its stated tolerance, its gradients and
  types where it says so;
- the names whose meaning in torch differs, each with inputs on which
  torch's own method gives another answer (or none);
- the class surface, on ``tests/test_tensor.py``'s cases;
- ``tools/paddle_gpt_script.py`` in method form at ``CONFIGS["tiny"]``:
  the 8-step loss trajectory within the functional script's 5e-5 of the
  JAX package's (the JAX script in method form too, dense), and the
  port's method form = its functional form bitwise;
- the boundaries: torch's own Python functions on a Paddle ``Tensor``
  keep torch's meanings; every layer class of ``test_torch_layers``'
  ``LAYERS`` and every model's forward give the same bits on Paddle
  ``Tensor`` inputs as on plain ones; a static ``Program`` records and
  runs the same from a Paddle ``Tensor`` feed.
"""
import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import paddle_tpu as jpt
import paddle_tpu.core.tensor as jtensor
import paddle_tpu.ops as jops
import paddle_tpu_torch as pt
import torch_tensor_parity as tp
from test_torch_layers import LAYERS, numpy_initializers  # noqa: F401
from test_torch_tensor_linalg import CASES as LINALG_CASES
from test_torch_tensor_manip import CASES as MANIP_CASES
from test_torch_tensor_math import CASES as MATH_CASES
from test_torch_tensor_reduce import CASES as REDUCE_CASES

from torch_test_threads import torch_threads  # noqa: F401,E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import paddle_gpt_script as S  # noqa: E402

Case, f, i = tp.Case, tp.f, tp.i
LOSS_TOL = 5e-5       # the functional script's (test_torch_to_static.py)


@pytest.fixture(autouse=True)
def on_the_cpu():
    place = pt._device.CURRENT[0]
    pt.set_device("cpu")
    try:
        yield
    finally:
        pt._device.CURRENT[0] = place


def _rops_names():
    """The operators ``paddle_tpu.ops._rops`` sets on the JAX Tensor."""
    src = inspect.getsource(jops._rops)
    return sorted({ln.split("Tensor.")[1].split(" ")[0]
                   for ln in src.splitlines() if "Tensor.__" in ln})


def _class_surface():
    """The public attributes of the JAX ``Tensor`` class itself."""
    return sorted(n for n, v in vars(jtensor.Tensor).items()
                  if not n.startswith("_")) + ["stop_gradient", "grad",
                                               "name", "persistable"]


# -- coverage -----------------------------------------------------------------


def test_every_reference_method_operator_and_attribute_resolves():
    assert len(jops._METHODS) == 139
    assert set(pt.ops._METHODS) == set(jops._METHODS)
    rops = _rops_names()
    assert len(rops) == 28
    x = pt.to_tensor([1.0, 2.0])
    for n in list(jops._METHODS) + rops:
        assert n in vars(pt.Tensor), n
        assert callable(getattr(x, n)), n
    for n in _class_surface():
        assert hasattr(x, n), n
    assert isinstance(x, pt.Tensor) and pt.Tensor is not torch.Tensor


def test_torch_tensor_gains_no_attribute():
    """Every Paddle name lives on the port's class, none on torch's: a
    plain tensor keeps torch's methods."""
    mine = set(vars(pt.Tensor)) - {"__module__", "__doc__", "__dict__",
                                   "__weakref__", "__hash__"}
    for n in mine:
        assert vars(torch.Tensor).get(n) is not vars(pt.Tensor)[n], n
    for n in ("astype", "stop_gradient", "clear_grad", "set_value",
              "numel", "persistable"):
        if n in vars(torch._C.TensorBase) or n in vars(torch.Tensor):
            continue
        assert not hasattr(torch.ones(1), n), n
    y = torch.ones(2, 3)
    assert y.transpose(0, 1).shape == (3, 2) and callable(y.size)
    assert type(y + 1) is torch.Tensor


# -- the 139 methods through the method spelling -----------------------------

EXTRA = {
    "mode": Case("mode", lambda m, d, x: m.mode(x, axis=-1),
                 [i(0, 3, 4, 6)], tol="exact"),
    "softmax": Case("softmax", lambda m, d, x: m.softmax(x, axis=0),
                    [f(3, 5)], grad=True),
    "sigmoid": Case("sigmoid", lambda m, d, x: m.sigmoid(x), [f(3, 5)],
                    tol="special", grad=True),
    "relu": Case("relu", lambda m, d, x: m.relu(x), [f(3, 5)], grad=True),
}


class Methods:
    """A package handle that spells ``m.name(x, ...)`` as ``x.name(...)``
    for the names of the method table (when ``x`` is the package's
    tensor), and records which it spelled so."""

    def __init__(self, mod, tensor_type):
        self._mod, self._type = mod, tensor_type
        self.spelled = set()

    def __getattr__(self, name):
        if name not in jops._METHODS:
            return getattr(self._mod, name)

        def call(*args, **kwargs):
            if args and isinstance(args[0], self._type):
                self.spelled.add(name)
                return getattr(args[0], name)(*args[1:], **kwargs)
            return getattr(self._mod, name)(*args, **kwargs)

        return call


def _case_for(name):
    for c in MATH_CASES + REDUCE_CASES + MANIP_CASES + LINALG_CASES:
        if c.name == name and c.jax and c.check is None:
            return c
    return EXTRA[name]


def _run(case, arrays, port):
    """The case through one package's method spelling: (outputs as
    numpy, input gradients, the handle, the outputs)."""
    grad_at = tp._floats(arrays) if case.grad else []
    if port:
        xs = [torch.Tensor._make_subclass(
            pt.Tensor, torch.from_numpy(np.array(a)), k in grad_at)
            for k, a in enumerate(arrays)]
        m = Methods(pt, pt.Tensor)
    else:
        xs = [jpt.to_tensor(a, stop_gradient=k not in grad_at)
              for k, a in enumerate(arrays)]
        m = Methods(jpt, jpt.Tensor)
    outs = tp.flat(case.call(m, tp.CPU if port else {}, *xs))
    got = [tp.to_numpy(o) for o in outs]
    grads = None
    if grad_at:
        loss = None
        for o, g in zip(outs, tp._cotangents(got)):
            if g is None:
                continue
            term = (o * (pt if port else jpt).to_tensor(g)).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        grads = [None if xs[k].grad is None else tp.to_numpy(xs[k].grad)
                 for k in grad_at]
    return got, grads, m, outs


@pytest.mark.parametrize("name", sorted(jops._METHODS))
def test_method_matches_the_jax_package(name):
    case = _case_for(name)
    arrays = tp.arrays_of(case)
    got, tgrads, tm, touts = _run(case, arrays, port=True)
    want, jgrads, jm, _ = _run(case, arrays, port=False)
    assert name in tm.spelled and name in jm.spelled, case.id
    assert all(isinstance(o, pt.Tensor) for o in touts
               if isinstance(o, torch.Tensor)), case.id
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        tp.close(g, w, case.tol, f"{case.id} output {k}")
        if case.types:
            tp.same_type(g, w, f"{case.id} output {k}")
    if case.grad:
        tol = "f32" if case.tol == "exact" else case.tol
        for k, (g, w) in enumerate(zip(tgrads, jgrads)):
            ref = arrays[tp._floats(arrays)[k]]
            g = np.zeros_like(ref) if g is None else g
            w = np.zeros_like(ref) if w is None else w
            tp.close(g, w, tol, f"{case.id} gradient {k}")


def test_operators_match_the_jax_package():
    """The 28 operators, the reference's promotion included: a Python
    scalar keeps the tensor's type (``tests/test_tensor.py:29``)."""
    rng = np.random.RandomState(0)
    a = rng.randn(3, 4).astype(np.float32)
    b = rng.rand(3, 4).astype(np.float32) + 0.5
    ia = rng.randint(-5, 5, (3, 4)).astype(np.int64)
    ib = rng.randint(1, 5, (3, 4)).astype(np.int64)
    bits = (rng.rand(3, 4) > 0.5, rng.rand(3, 4) > 0.5)
    sq = rng.randn(4, 4).astype(np.float32)

    def run(m):
        x, y = m.to_tensor(a), m.to_tensor(b)
        p, q = m.to_tensor(ia), m.to_tensor(ib)
        u, v = m.to_tensor(bits[0]), m.to_tensor(bits[1])
        s = m.to_tensor(sq)
        h = m.to_tensor(np.ones(3, np.float32)).astype("bfloat16")
        return [x + y, x - y, x * y, x / y, x // y, x % y, y ** x, s @ s,
                -x, abs(x), ~u, x == y, x != y, x < y, x <= y, x > y,
                x >= y, u & v, u | v, u ^ v, 2.0 + x, 2.0 - x, 3.0 * x,
                1.0 / y, 7.0 // y, 7.0 % y, 2.0 ** x, s.T @ s,
                p + 1, p * 2, p // q, p % q, h * 2, h + 1]

    got, want = run(pt), run(jpt)
    assert len(got) == 34
    for k, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, pt.Tensor), k
        gn, wn = tp.to_numpy(g), tp.to_numpy(w)
        tp.close(gn.astype(np.float32) if gn.dtype.kind == "V" else gn,
                 wn, "f32", f"operator {k}")
        tp.same_type(gn, wn, f"operator {k}") if wn.dtype.name != \
            "bfloat16" else None
    assert got[-1].dtype == got[-2].dtype == torch.bfloat16


# -- the names whose meaning differs from torch's -----------------------------


def _both(fn):
    """``fn(m, to)`` on both packages, ``to`` making the package's tensor:
    the port's and the JAX package's outputs as numpy."""
    def to_pt(a):
        return pt.to_tensor(a)

    out = []
    for m, to in ((pt, to_pt), (jpt, jpt.to_tensor)):
        v = fn(m, to)
        out.append([tp.to_numpy(o) for o in tp.flat(v)])
    return out


COLLIDING = {
    "transpose": (lambda m, to: to(np.arange(24.0).reshape(2, 3, 4))
                  .transpose([2, 0, 1]),
                  lambda x: torch.Tensor.transpose(x, [2, 0, 1])),
    "split": (lambda m, to: to(np.arange(24.0).reshape(6, 4))
              .split(3, axis=0),
              lambda x: torch.Tensor.split(x, 3)),
    "gather": (lambda m, to: to(np.arange(12.0).reshape(4, 3))
               .gather(to(np.array([2, 0])), axis=0),
               lambda x: torch.Tensor.gather(x, 0, torch.tensor([[2, 0]]))),
    "index_select": (lambda m, to: to(np.arange(12.0).reshape(4, 3))
                     .index_select(to(np.array([2, 0])), axis=1),
                     lambda x: torch.Tensor.index_select(
                         x, torch.tensor([2, 0]), 1)),
    "where": (lambda m, to: to(np.array([True, False, True]))
              .where(to(np.array([1.0, 2.0, 3.0])),
                     to(np.array([9.0, 8.0, 7.0]))),
              lambda x: torch.Tensor.where(
                  x, torch.tensor([True, False, True]),
                  torch.tensor([9.0, 8.0, 7.0]))),
    "sort": (lambda m, to: to(np.array([3.0, 1.0, 2.0])).sort(),
             lambda x: torch.Tensor.sort(x)),
    "max": (lambda m, to: to(np.array([[3.0, 1.0], [2.0, 5.0]])).max(axis=1),
            lambda x: torch.Tensor.max(x, 1)),
    "equal": (lambda m, to: to(np.array([1.0, 2.0])).equal(
        to(np.array([1.0, 3.0]))),
        lambda x: torch.Tensor.equal(x, torch.tensor([1.0, 3.0]))),
    "allclose": (lambda m, to: to(np.array([1.0, 2.0])).allclose(
        to(np.array([1.0, 2.0]))),
        lambda x: torch.Tensor.allclose(x, torch.tensor([1.0, 2.0]))),
    "dot": (lambda m, to: to(np.arange(6.0).reshape(2, 3)).dot(
        to(np.ones((2, 3)))),
        lambda x: torch.Tensor.dot(x, torch.ones(2, 3))),
    "unsqueeze": (lambda m, to: to(np.ones((2, 3))).unsqueeze([0, 2]),
                  lambda x: torch.Tensor.unsqueeze(x, [0, 2])),
    "cumsum": (lambda m, to: to(np.arange(6.0).reshape(2, 3)).cumsum(),
               lambda x: torch.Tensor.cumsum(x)),
    "size": (lambda m, to: np.asarray(to(np.ones((2, 3))).size),
             lambda x: torch.Tensor.size(x)),
}
_TORCH_INPUT = {
    "transpose": np.arange(24.0).reshape(2, 3, 4),
    "split": np.arange(24.0).reshape(6, 4),
    "gather": np.arange(12.0).reshape(4, 3),
    "index_select": np.arange(12.0).reshape(4, 3),
    "where": np.array([True, False, True]),
    "sort": np.array([3.0, 1.0, 2.0]),
    "max": np.array([[3.0, 1.0], [2.0, 5.0]]),
    "equal": np.array([1.0, 2.0]),
    "allclose": np.array([1.0, 2.0]),
    "dot": np.arange(6.0).reshape(2, 3),
    "unsqueeze": np.ones((2, 3)),
    "cumsum": np.arange(6.0).reshape(2, 3),
    "size": np.ones((2, 3)),
}


@pytest.mark.parametrize("name", sorted(COLLIDING))
def test_colliding_name_keeps_paddles_meaning(name):
    paddle, torchs = COLLIDING[name]
    got, want = _both(paddle)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        tp.close(g, w, "f32", name)
    # torch's own method on the same input answers otherwise, or not at all
    x = torch.from_numpy(_TORCH_INPUT[name]).float()
    try:
        theirs = torchs(x)
    except (TypeError, RuntimeError, IndexError):
        return
    theirs = [np.asarray(t) for t in tp.flat(theirs)] if isinstance(
        theirs, (tuple, list)) else [np.asarray(theirs)]
    assert (len(theirs) != len(got) or type(torchs(x)) in (bool, torch.Size)
            or any(np.shape(t) != np.shape(g) or
                   not np.array_equal(np.asarray(t, np.float64),
                                      np.asarray(g, np.float64))
                   for t, g in zip(theirs, got))), name


# -- the class surface (tests/test_tensor.py's cases) -------------------------

SURFACE = {
    "to_tensor_roundtrip": lambda m: (
        lambda x: [x.shape == [2, 2], x.numpy()])(
        m.to_tensor([[1.0, 2.0], [3.0, 4.0]])),
    "arithmetic_broadcast": lambda m: (
        m.ones([2, 3]) + m.arange(3, dtype="float32") * 2 - 1.0).numpy(),
    "matmul_and_T": lambda m: (lambda a, b: [(a @ b).shape, a.T.numpy(),
                                             (a @ b).numpy()])(
        m.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3)),
        m.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))),
    "getitem_setitem": lambda m: (lambda x: [
        x[1].numpy(), x[:, 1].numpy(),
        (x.__setitem__((0, 0), 100.0), x[0, 0].item())[1]])(
        m.arange(12, dtype="float32").reshape([3, 4])),
    "methods_attached": lambda m: (lambda x: [
        x.abs().sum().item(), x.mean(axis=0).numpy(), x.max().item(),
        x.argmax().item()])(m.to_tensor([[1.0, -2.0], [3.0, -4.0]])),
    "comparison_ops": lambda m: (lambda a, b: [
        (a < b).numpy(), (a == b).numpy(), m.allclose(a, a).item()])(
        m.to_tensor([1.0, 2.0, 3.0]), m.to_tensor([3.0, 2.0, 1.0])),
    "cast": lambda m: [str(m.ones([2]).astype("int32").numpy().dtype),
                       m.ones([2]).cast("float32").numpy()],
    "manipulation": lambda m: (lambda x: [
        x.transpose([2, 0, 1]).shape, x.flatten(1).shape,
        x.unsqueeze(0).squeeze(0).shape,
        [p.shape for p in x.split([1, 2], axis=1)]])(
        m.arange(24).reshape([2, 3, 4])),
    "where_topk_sort": lambda m: (lambda x: [
        x.topk(2)[0].numpy(), x.topk(2)[1].numpy(), x.sort().numpy(),
        (x > 1.5).where(x, x.zeros_like()).numpy()])(
        m.to_tensor([3.0, 1.0, 2.0])),
    "gather_scatter": lambda m: [
        m.arange(10, dtype="float32").gather(m.to_tensor([1, 3, 5]))
        .numpy(),
        m.zeros([5]).scatter(m.to_tensor([0, 2]), m.to_tensor([1.0, 2.0]))
        .numpy()],
    "linalg": lambda m: (lambda x: [
        x.inverse().numpy(), x.norm(p=2).item(),
        (x.cholesky() @ x.cholesky().T).numpy()])(
        m.to_tensor(np.array([[4.0, 2.0], [2.0, 3.0]], np.float32))),
    "properties": lambda m: (lambda x: [
        x.shape, x.ndim, x.size, x.numel(), x.item() if x.size == 1 else
        x.tolist(), len(x), [r.numpy() for r in x], float(x[0, 0]),
        int(x[1, 1]), bool(x[0, 0]), f"{x[0, 1]:.2f}", x.stop_gradient,
        x.persistable, x.detach().numpy(), x.clone().numpy(),
        np.asarray(x)])(m.to_tensor([[1.0, 2.0], [3.0, 4.0]])),
}


@pytest.mark.parametrize("name", sorted(SURFACE))
def test_class_surface_matches_the_jax_package(name):
    got, want = SURFACE[name](pt), SURFACE[name](jpt)

    def norm(v):
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        if isinstance(v, (torch.Tensor, jpt.Tensor)):
            return tp.to_numpy(v).tolist()
        if isinstance(v, np.ndarray):
            return v.astype(np.float64).tolist()
        if isinstance(v, np.generic):
            return v.item()
        return v

    assert norm(got) == norm(want), name


def test_autograd_surface_matches_the_jax_package():
    """``stop_gradient``, ``backward(grad_tensor)``, ``grad``,
    ``clear_grad``, ``register_hook``, ``numpy()`` of a tensor that
    requires a gradient, ``set_value``/``copy_`` and ``name``."""
    out = {}
    for m in (pt, jpt):
        x = m.to_tensor([1.0, -2.0, 3.0], stop_gradient=False)
        assert not x.stop_gradient
        seen = []
        x.register_hook(lambda g: seen.append(tp.to_numpy(g)))
        y = (x * 2.0).sum()
        y.backward()
        g1 = tp.to_numpy(x.grad)
        x.clear_grad()
        assert x.grad is None
        z = x * 3.0
        z.backward(m.to_tensor([1.0, 2.0, 3.0]))
        g2 = tp.to_numpy(x.grad)
        x.clear_gradient()
        w = m.to_tensor([0.0, 0.0, 0.0])
        w.set_value(np.array([5.0, 6.0, 7.0], np.float32))
        src = m.to_tensor([1.0, 1.0, 1.0])
        w2 = m.to_tensor([0.0, 0.0, 0.0]).copy_(src)
        src.set_value(np.zeros(3, np.float32))    # w2 holds its own copy
        t = m.Tensor(np.array([1.0, 2.0], np.float32), name="t0")
        out[m] = [g1, g2, seen[0], x.numpy(), w.numpy(), w2.numpy(),
                  t.name, t.stop_gradient, t.numpy()]
    got, want = out[pt], out[jpt]
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_allclose(g, w)
        else:
            assert g == w


def test_parameter_answers_the_paddle_surface():
    lin = pt.nn.Linear(3, 2)
    p = lin.weight
    assert isinstance(p, pt.Tensor) and isinstance(p, torch.nn.Parameter)
    assert p.shape == [3, 2] and p.size == 6 and p.size(0) == 3
    assert not p.stop_gradient and p.trainable and p.persistable
    assert p.name == lin.weight.name and p.name.endswith("_w_0")
    assert p.numpy().shape == (3, 2)
    assert isinstance(p.transpose([1, 0]), pt.Tensor)
    assert p.transpose([1, 0]).shape == [2, 3]
    assert p.astype("float16").dtype == torch.float16
    # torch's operators stay: an op on parameters alone is plain
    assert type(p * 2) is torch.Tensor and type(p[0]) is torch.Tensor
    p.set_value(np.ones((3, 2), np.float32))
    assert float(p.sum()) == 6.0
    (lin(pt.ones([4, 3])).sum()).backward()
    assert p.grad is not None
    p.clear_grad()
    assert p.grad is None
    q = torch.nn.Parameter(torch.ones(2))
    assert type(q * 2) is torch.Tensor and callable(q.size)


# -- the method-form script ---------------------------------------------------

CFG = S.CONFIGS["tiny"]
DATA = S.batches(CFG, steps=8)


@pytest.fixture(scope="module")
def script_runs(tmp_path_factory, numpy_initializers):
    """The port's script in method and in functional form, and the JAX
    package's in method form, each 8 steps from the JAX model's
    weights."""
    path = str(tmp_path_factory.mktemp("methods") / "gpt.pdparams")
    place = pt._device.CURRENT[0]
    pt.set_device("cpu")
    try:
        with jpt.utils.unique_name.guard():
            jm = S.make_model(jpt, CFG, methods=True)
        jpt.save(jm.state_dict(), path)
        runs = {}
        for methods in (True, False):
            with pt.utils.unique_name.guard():
                tm = S.make_model(pt, CFG, methods=methods)
            tm.set_state_dict(pt.load(path))
            losses, _ = S.train(pt, tm, DATA, CFG, methods=methods)
            runs[methods] = (losses, {k: v.clone() for k, v in
                                      tm.state_dict().items()})
        jlosses, _ = S.train(jpt, jm, DATA, CFG, methods=True)
        yield dict(port=runs[True], functional=runs[False], jax=jlosses)
    finally:
        pt._device.CURRENT[0] = place


def test_method_form_script_trajectory_matches_the_jax_package(script_runs):
    got, want = script_runs["port"][0], script_runs["jax"]
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=LOSS_TOL)


def test_method_form_script_is_the_functional_form_bitwise(script_runs):
    (ml, ms), (fl, fs) = script_runs["port"], script_runs["functional"]
    assert ml == fl
    assert list(ms) == list(fs)
    for k in ms:
        assert torch.equal(ms[k], fs[k]), k


# -- the boundaries -----------------------------------------------------------


def test_torch_functions_keep_torchs_meaning_on_a_paddle_tensor():
    a = np.arange(24, dtype=np.float32).reshape(6, 4)
    x = pt.to_tensor(a)
    parts = torch.split(x, 2)                       # chunks of 2 rows
    assert [tuple(p.shape) for p in parts] == [(2, 4)] * 3
    assert all(isinstance(p, pt.Tensor) for p in parts)
    parts = torch.Tensor.split(x, [1, 5])
    assert [p.shape for p in parts] == [[1, 4], [5, 4]]
    im = np.random.RandomState(0).randn(1, 2, 3, 3).astype(np.float32)
    up = TF.interpolate(pt.to_tensor(im), scale_factor=2, mode="bilinear",
                        align_corners=False)
    ref = TF.interpolate(torch.from_numpy(im), scale_factor=2,
                         mode="bilinear", align_corners=False)
    assert isinstance(up, pt.Tensor) and torch.equal(up, ref)
    w = pt.zeros([3, 4])
    out = torch.nn.init.normal_(w, generator=torch.Generator().manual_seed(0))
    assert out is w and float(w.abs().sum()) > 0
    torch.nn.init.xavier_uniform_(w)
    assert float(w.abs().max()) <= (6.0 / 7.0) ** 0.5
    assert torch.equal(x.sum(axis=0), torch.sum(torch.from_numpy(a), 0))
    assert torch.sum(x, 0).shape == [4] and torch.max(x, 1)[1].shape == [6]


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_layer_gives_the_same_bits_on_paddle_inputs(case):
    name, make, arrays = case
    torch.manual_seed(0)
    layer = make(pt.nn, dict(device="cpu"))
    if name.endswith("-eval"):
        layer.eval()
    plain = [torch.from_numpy(np.array(a)) for a in arrays]
    paddle = [pt.to_tensor(np.array(a)) for a in arrays]
    with torch.no_grad():
        want = layer(*plain)
        got = layer(*paddle)
    for g, w in zip(tp.flat(got), tp.flat(want)):
        assert isinstance(g, pt.Tensor) and type(w) is torch.Tensor
        assert torch.equal(g, w) or (
            torch.isnan(w).any() and torch.equal(torch.nan_to_num(g),
                                                 torch.nan_to_num(w))), name


def _models():
    from paddle_tpu_torch.models.nlp import (ConvSentiment, NGramLM,
                                             SkipGram, StackedLSTMSentiment,
                                             bert, gpt)
    from paddle_tpu_torch.models.nlp.transformer import WMTTransformer
    from paddle_tpu_torch.models.rec import DeepFM, TwoTowerRecommender
    from paddle_tpu_torch.models.vision import (LeNet, MobileNetV1,
                                                MobileNetV2, resnet, vgg)

    r = np.random.RandomState(0)
    ids = r.randint(0, 50, (2, 8)).astype(np.int64)
    img = r.randn(2, 3, 32, 32).astype(np.float32)
    cpu = dict(device="cpu")
    return {
        "gpt": (lambda: gpt.GPT(gpt.GPTConfig(
            vocab_size=64, hidden=32, layers=2, heads=2, max_seq=16,
            dropout=0.0), **cpu), [ids]),
        "bert": (lambda: bert.BertForPretraining(bert.bert_tiny(
            vocab_size=64, dropout=0.0), **cpu), [ids, ids % 2]),
        "wmt": (lambda: WMTTransformer(50, 50, d_model=16, nhead=2,
                                       num_layers=1, dim_feedforward=32,
                                       dropout=0.0, **cpu), [ids, ids]),
        "resnet": (lambda: resnet.ResNet(resnet.BottleneckBlock, [1, 1, 1, 1],
                                         num_classes=5, width=16, **cpu),
                   [img]),
        "lenet": (lambda: LeNet(**cpu),
                  [r.randn(2, 1, 28, 28).astype(np.float32)]),
        "mobilenet_v1": (lambda: MobileNetV1(num_classes=3, scale=0.25,
                                             **cpu), [img]),
        "mobilenet_v2": (lambda: MobileNetV2(num_classes=3, scale=0.25,
                                             **cpu), [img]),
        "vgg11": (lambda: vgg.vgg11(num_classes=3, dropout=0.0, **cpu),
                  [img]),
        "conv_sentiment": (lambda: ConvSentiment(50, 8, 4, dropout=0.0,
                                                 **cpu), [ids]),
        "lstm_sentiment": (lambda: StackedLSTMSentiment(
            50, 8, 8, num_layers=2, dropout=0.0, **cpu),
            [ids, np.array([8, 5], np.int64)]),
        "ngram": (lambda: NGramLM(50, 4, 8, **cpu), [ids[:, :4]]),
        "skipgram": (lambda: SkipGram(50, 4, **cpu), [ids[:, 0], ids]),
        "two_tower": (lambda: TwoTowerRecommender(40, 50, **cpu),
                      [ids[:, 0] % 40, ids[:, 1] % 2, ids[:, 2] % 7,
                       ids[:, 3] % 21, ids[:, 4], ids[:, 5] % 19]),
        "deepfm": (lambda: DeepFM([10, 20, 30], 8, (16, 16), **cpu),
                   [ids[:, 0] % 10, ids[:, 1] % 20, ids[:, 2] % 30]),
    }


@pytest.mark.parametrize("name", sorted(_models()))
def test_model_forward_gives_the_same_bits_on_paddle_inputs(name):
    make, arrays = _models()[name]
    pt.seed(0)
    model = make()
    model.eval()
    with torch.no_grad():
        want = model(*[torch.from_numpy(a) for a in arrays])
        got = model(*[pt.to_tensor(a) for a in arrays])
    want, got = tp.flat(want), tp.flat(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, pt.Tensor) and type(w) is torch.Tensor, name
        assert torch.equal(g, w), name


def test_static_program_records_and_runs_the_same_from_a_paddle_feed():
    from paddle_tpu_torch.static_ import program as tprog
    from paddle_tpu_torch.utils import unique_name as tun

    out = {}
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(4, 8).astype("float32")}
    for kind in ("numpy", "paddle"):
        with tun.guard(), pt.static.scope_guard(tprog.Scope()):
            pt.enable_static()
            try:
                main, startup = pt.static.Program(), pt.static.Program()
                with pt.program_guard(main, startup):
                    x = pt.static.data("x", [-1, 8], "float32")
                    pt.seed(0)
                    lin = pt.nn.Linear(8, 2, device="cpu")
                    bias = pt.to_tensor(np.full(2, 0.5, np.float32))
                    y = pt.nn.functional.relu(lin(x)) + bias
            finally:
                pt.disable_static()
            exe = pt.static.Executor(pt.CPUPlace())
            f = feed if kind == "numpy" else {
                "x": pt.to_tensor(feed["x"])}
            res, = exe.run(main, feed=f, fetch_list=[y])
            out[kind] = ([op.type for op in main.global_block.ops], res)
    assert out["numpy"][0] == out["paddle"][0] and out["numpy"][0]
    np.testing.assert_array_equal(out["numpy"][1], out["paddle"][1])


def test_save_load_and_state_dicts_take_paddle_tensors(tmp_path):
    """``save`` and ``set_state_dict`` take Paddle ``Tensor`` values;
    ``load`` gives back numpy arrays, as the reference's does."""
    lin = pt.nn.Linear(3, 2)
    sd = {k: pt.to_tensor(v.numpy()) for k, v in lin.state_dict().items()}
    assert all(isinstance(v, pt.Tensor) for v in sd.values())
    path = str(tmp_path / "linear.pdparams")
    pt.save(sd, path)
    back = pt.load(path)
    jpt.save({k: jpt.to_tensor(v.numpy()) for k, v in sd.items()},
             str(tmp_path / "jax.pdparams"))
    want = jpt.load(str(tmp_path / "jax.pdparams"))
    assert sorted(back) == sorted(want)
    for k in want:
        assert type(back[k]) is type(want[k]) is np.ndarray, k
        np.testing.assert_array_equal(back[k], want[k])
    fresh = pt.nn.Linear(3, 2)
    assert fresh.set_state_dict(sd) == ([], [])
    assert torch.equal(fresh.weight, lin.weight)
    assert torch.equal(fresh.bias, lin.bias)
