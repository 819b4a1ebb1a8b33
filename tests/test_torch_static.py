"""paddle_tpu_torch's static graph (``static_``) against the JAX package's.

The same program is recorded in both packages, each under a fresh
unique-name generator and Scope, so the two Programs name their
variables alike; the JAX Scope's values (parameters, then optimizer
slots) are copied into the port's with ``convert.scope_from_jax``, the
feeds come from ``RandomState(0)``, and both Executors run the program
(the JAX one jitted, as its own tests run it; the port's op by op on
the CPU). Tolerances, float32:

- LeNet's losses rtol 1e-5, its parameters atol 1e-5 after 8 steps
  (sums taken in another order: XLA's conv and dot against PyTorch's);
- ``gradients()`` atol 1e-6 (one step, no optimizer);
- the port against itself (``run_steps`` against sequential ``run``
  calls, the recorded LN/CE program against the eager modules): bitwise.

The data Variable ``y`` is declared ``int64``: the JAX package records
it as int32 (JAX without x64); every other variable has the same type.
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu import optim as joptim
from paddle_tpu.models.vision import LeNet as JLeNet
from paddle_tpu.optim import lr as jlr
from paddle_tpu.static_ import program as jprog
from paddle_tpu.utils import unique_name as jun

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, nn, optim
from paddle_tpu_torch.models.vision import LeNet
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optim import lr as tlr
from paddle_tpu_torch.static_ import program as tprog
from paddle_tpu_torch.utils import unique_name as tun

from torch_test_threads import torch_threads  # noqa: F401,E402

LENET_FWD = ["conv2d", "reshape", "add", "relu", "max_pool2d", "conv2d",
             "reshape", "add", "relu", "max_pool2d", "flatten", "linear",
             "relu", "linear", "relu", "linear", "cross_entropy_hard"]


@contextlib.contextmanager
def _recording(static, names, scope):
    """Static mode of one package, a fresh name generator and Scope."""
    with names.guard(), static.scope_guard(scope):
        pkg = jpt if static is jpt.static else pt
        pkg.enable_static()
        try:
            yield
        finally:
            pkg.disable_static()


def _batch(B):
    rng = np.random.RandomState(0)
    return (rng.randn(B, 1, 28, 28).astype("float32"),
            rng.randint(0, 10, (B,)).astype("int64"))


class Lenet:
    """bench_lenet_exec's program in one package (``jax`` or not)."""

    def __init__(self, jax, B, lr=0.01):
        self.jax = jax
        mod = jpt if jax else pt
        self.scope = (jprog.Scope if jax else tprog.Scope)()
        mod.seed(0)
        with _recording(mod.static, jun if jax else tun, self.scope):
            self.main, self.startup = mod.static.Program(), \
                mod.static.Program()
            with mod.program_guard(self.main, self.startup):
                xv = mod.static.data("x", [B, 1, 28, 28], "float32")
                yv = mod.static.data("y", [B], "int64")
                if jax:
                    model = JLeNet()
                    self.loss = JF.cross_entropy(model(xv), yv)
                    opt = joptim.Momentum(lr, 0.9,
                                          parameters=model.parameters())
                else:
                    model = LeNet(device="cpu")
                    self.loss = F.cross_entropy(model(xv), yv)
                    opt = optim.Momentum(lr, 0.9,
                                         parameters=model.parameters())
                _, self.params_grads = opt.minimize(self.loss)
        self.exe = (jpt.static.Executor() if jax
                    else pt.static.Executor("cpu"))
        self.run(self.startup)

    def run(self, program, **kw):
        static = jpt.static if self.jax else pt.static
        with static.scope_guard(self.scope):
            return self.exe.run(program, **kw)

    def step(self, x, y):
        return float(self.run(self.main, feed={"x": x, "y": y},
                              fetch_list=[self.loss])[0])

    def run_steps(self, feeds):
        static = jpt.static if self.jax else pt.static
        with static.scope_guard(self.scope):
            return self.exe.run_steps(self.main, feeds=feeds,
                                      fetch_list=[self.loss])[0]

    def values(self):
        return {n: np.asarray(v).copy() if self.jax
                else v.detach().numpy().copy()
                for n, v in self.scope._vars.items()}


def _port_from_jax(B):
    j, t = Lenet(True, B), Lenet(False, B)
    convert.scope_from_jax(j.values(), t.main, t.scope)
    return j, t


def _shape_dtype(v, jax):
    if jax:
        return list(v.shape), np.dtype(v._data.dtype).name
    with torch._C.DisableTorchFunction():
        return list(v.shape), str(v.dtype).replace("torch.", "")


def test_lenet_records_the_jax_program():
    j, t = Lenet(True, 4), Lenet(False, 4)
    jops, tops = j.main.global_block.ops, t.main.global_block.ops
    assert [op.type for op in tops] == [op.type for op in jops]
    assert [op.type for op in tops[:17]] == LENET_FWD
    assert len(tops) == 45 and tops[17].type == "fill_ones_like"
    assert sum(op.type.endswith("@grad") for op in tops) == 17
    assert [op.type for op in tops[-10:]] == ["optimize_momentum"] * 10
    assert [(op.input_names, op.output_names) for op in tops] == \
        [(op.input_names, op.output_names) for op in jops]
    # the forward ops' attributes, as an inference bundle saves them:
    # the bias's reshape carries its shape, conv2d its data_format
    assert [op.attrs for op in tops[:17]] == [op.attrs for op in jops[:17]]
    assert tops[1].attrs == {"shape": (1, -1, 1, 1)}
    assert tops[0].attrs["data_format"] == "NCHW"
    jv, tv = j.main.global_block.vars, t.main.global_block.vars
    assert list(tv) == list(jv)
    for n in jv:
        js, jd = _shape_dtype(jv[n], True)
        ts, td = _shape_dtype(tv[n], False)
        assert ts == js, n
        assert td == jd or (n == "y" and (jd, td) == ("int32", "int64")), n
        assert tv[n].persistable == jv[n].persistable, n
    assert [(p.name, g.name) for p, g in t.params_grads] == \
        [(p.name, g.name) for p, g in j.params_grads]


def test_lenet_eight_steps_match_jax():
    j, t = _port_from_jax(8)
    x, y = _batch(8)
    jl = [j.step(x, y) for _ in range(8)]
    tl = [t.step(x, y) for _ in range(8)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jv, tv = j.values(), t.values()
    assert set(tv) == set(jv)
    for n in jv:
        np.testing.assert_allclose(tv[n], jv[n], rtol=0, atol=1e-5,
                                   err_msg=n)


def test_lenet_bench_batch_first_losses_match_jax():
    """bench_lenet_exec's B = 256 from the JAX package's seed-0 weights."""
    j, t = _port_from_jax(256)
    x, y = _batch(256)
    jl = [j.step(x, y) for _ in range(4)]
    tl = [t.step(x, y) for _ in range(4)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[3] < tl[0]


def test_run_steps_equals_sequential_runs_bitwise():
    t = Lenet(False, 8)
    x, y = _batch(8)
    init = {n: v.clone() for n, v in t.scope._vars.items()}
    seq = [t.step(x + k, y) for k in range(4)]
    after = t.values()
    for n, v in init.items():
        t.scope.find_var(n).copy_(v)
    fused = t.run_steps([{"x": x + k, "y": y} for k in range(4)])
    assert fused.shape == (4,)
    assert fused.tolist() == seq
    for n, v in t.values().items():
        assert np.array_equal(v, after[n]), n


def test_cache_stats_and_dispatches_match_jax():
    j, t = _port_from_jax(4)
    x, y = _batch(4)
    for m in (j, t):
        for _ in range(3):
            m.step(x, y)
        for _ in range(2):
            m.run_steps([{"x": x, "y": y}] * 4)
        m.run(m.main, feed={"x": x, "y": y},
              fetch_list=[m.loss, m.params_grads[0][1]])
    assert t.exe.cache_stats() == j.exe.cache_stats() == \
        {"hits": 3, "misses": 3, "size": 3}
    assert t.exe.dispatches == j.exe.dispatches == 6


def _small(jax, names, scope, dropout=False, optimizer=None):
    """x (4, 8) -> Linear(8, 8) -> relu [-> dropout] -> Linear(8, 1) ->
    mean squared error against y; returns (main, startup, loss, model
    parameters' names, extras)."""
    mod, fn = (jpt, JF) if jax else (pt, F)
    with _recording(mod.static, names, scope):
        main, startup = mod.static.Program(), mod.static.Program()
        with mod.program_guard(main, startup):
            x = mod.static.data("x", [-1, 8], "float32")
            y = mod.static.data("y", [-1, 1], "float32")
            kw = {} if jax else {"device": "cpu"}
            l1, l2 = ((jnn if jax else nn).Linear(8, 8, **kw),
                      (jnn if jax else nn).Linear(8, 1, **kw))
            h = fn.relu(l1(x))
            if dropout:
                h = fn.dropout(h, 0.5)
            d = l2(h) - y
            loss = (d * d).mean()
            if optimizer is not None:
                optimizer(mod, [l1.weight, l1.bias, l2.weight,
                                l2.bias]).minimize(loss)
    return main, startup, loss


def _feed():
    rng = np.random.RandomState(1)
    return {"x": rng.randn(4, 8).astype("float32"),
            "y": rng.randn(4, 1).astype("float32")}


def test_gradients_match_jax():
    out = {}
    for jax in (True, False):
        mod, fn = (jpt, JF) if jax else (pt, F)
        names, scope = (jun, jprog.Scope()) if jax else (tun, tprog.Scope())
        with _recording(mod.static, names, scope):
            main = mod.static.Program()
            with mod.program_guard(main):
                x = mod.static.data("x", [4, 8], "float32")
                lin = (jnn if jax else nn).Linear(
                    8, 4, **({} if jax else {"device": "cpu"}))
                h = lin(x)
                z = (fn.relu(h) * h).sum()
                grads = mod.static.gradients([z], [h, lin.weight])
        out[jax] = (main, scope, grads)
    (jm, js, jg), (tm, ts, tg) = out[True], out[False]
    assert [g.name for g in tg] == [g.name for g in jg]
    assert [op.type for op in tm.global_block.ops] == \
        [op.type for op in jm.global_block.ops]
    convert.scope_from_jax({n: np.asarray(v) for n, v in js._vars.items()},
                           tm, ts)
    feed = {"x": np.random.RandomState(2).randn(4, 8).astype("float32")}
    with jpt.static.scope_guard(js):
        want = jpt.static.Executor().run(jm, feed=feed, fetch_list=jg)
    with pt.static.scope_guard(ts):
        got = pt.static.Executor("cpu").run(tm, feed=feed, fetch_list=tg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_clone_for_test_matches_jax():
    res = {}
    for jax in (True, False):
        names, scope = (jun, jprog.Scope()) if jax else (tun, tprog.Scope())
        main, _, loss = _small(jax, names, scope, dropout=True)
        res[jax] = (main.clone(for_test=True), scope, loss)
    (jt, js, jl), (tt, ts, tl) = res[True], res[False]
    assert [op.type for op in tt.global_block.ops] == \
        [op.type for op in jt.global_block.ops]
    drop = [op for op in tt.global_block.ops if op.type == "dropout"]
    assert drop and drop[0].attrs["p"] == 0.0
    convert.scope_from_jax({n: np.asarray(v) for n, v in js._vars.items()},
                           tt, ts)
    with jpt.static.scope_guard(js):
        jexe = jpt.static.Executor()
        want = jexe.run(jt, feed=_feed(), fetch_list=[jl.name])[0]
    with pt.static.scope_guard(ts):
        texe = pt.static.Executor("cpu")
        got = texe.run(tt, feed=_feed(), fetch_list=[tl.name])[0]
    np.testing.assert_allclose(got, want, rtol=1e-6)

    def counts(exe):
        return {name: {k: v for k, v in st.items() if k != "ms"}
                for name, st in exe.last_diagnostics.pass_stats.items()}

    assert counts(texe) == counts(jexe)
    assert counts(texe)["forward_identity"]["removed"] == 1


def test_step_decay_trajectory_matches_jax():
    res = {}
    for jax in (True, False):
        names, scope = (jun, jprog.Scope()) if jax else (tun, tprog.Scope())
        sched = (jlr if jax else tlr).StepDecay(0.1, step_size=2, gamma=0.5)

        def make(mod, params, sched=sched, jax=jax):
            return (joptim if jax else optim).SGD(sched, parameters=params)

        main, startup, loss = _small(jax, names, scope, optimizer=make)
        res[jax] = (main, scope, loss, sched)
    (jm, js, jl, jsch), (tm, ts, tl, tsch) = res[True], res[False]
    convert.scope_from_jax({n: np.asarray(v) for n, v in js._vars.items()},
                           tm, ts)
    jexe, texe = jpt.static.Executor(), pt.static.Executor("cpu")
    jloss, tloss = [], []
    for _ in range(6):
        with jpt.static.scope_guard(js):
            jloss.append(float(jexe.run(jm, feed=_feed(),
                                        fetch_list=[jl])[0]))
        with pt.static.scope_guard(ts):
            tloss.append(float(texe.run(tm, feed=_feed(),
                                        fetch_list=[tl])[0]))
        jsch.step()
        tsch.step()
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for n, v in js._vars.items():
        np.testing.assert_allclose(ts.find_var(n).numpy(), np.asarray(v),
                                   rtol=0, atol=1e-6, err_msg=n)


def _ln_ce(jax, names, scope, N=16, D=128, V=256):
    mod, fn = (jpt, JF) if jax else (pt, F)
    nnm = jnn if jax else nn
    kw = {} if jax else {"device": "cpu"}
    with _recording(mod.static, names, scope):
        main = mod.static.Program()
        with mod.program_guard(main):
            x = mod.static.data("x", [N, D], "float32")
            lab = mod.static.data("label", [N], "int64")
            l1, ln, l2 = (nnm.Linear(D, D, **kw), nnm.LayerNorm(D, **kw),
                          nnm.Linear(D, V, **kw))
            loss = fn.cross_entropy(l2(ln(l1(x))), lab)
            pg = mod.static.append_backward(loss)
    return main, loss, pg, (l1, ln, l2)


def test_ln_ce_program_records_one_op_each_and_equals_eager():
    """Phase 18(b)'s program at a small size: LayerNorm and the fused
    cross-entropy (its route holds: N % 8 == 0, V % 128 == 0) are one
    op each, as in the JAX package; on the CPU the kernels' plain
    versions run, and the loss and gradients equal the eager modules'
    bitwise."""
    jm = _ln_ce(True, jun, jprog.Scope())[0]
    scope = tprog.Scope()
    tm, loss, pg, layers = _ln_ce(False, tun, scope)
    fwd = [op.type for op in tm.global_block.ops
           if not op.type.endswith("@grad") and op.type != "fill_ones_like"]
    assert fwd == ["linear", "layer_norm", "linear", "cross_entropy_hard"]
    assert [op.type for op in tm.global_block.ops] == \
        [op.type for op in jm.global_block.ops]
    rng = np.random.RandomState(0)
    x = rng.randn(16, 128).astype("float32")
    lab = rng.randint(0, 256, 16).astype("int64")
    with pt.static.scope_guard(scope):
        got = pt.static.Executor("cpu").run(
            tm, feed={"x": x, "label": lab},
            fetch_list=[loss] + [g for _, g in pg])
    eager = [nn.Linear(128, 128, device="cpu"), nn.LayerNorm(128,
                                                             device="cpu"),
             nn.Linear(128, 256, device="cpu")]
    params = [(p, q) for m, e in zip(layers, eager)
              for p, q in ((m.weight, e.weight), (m.bias, e.bias))]
    with torch.no_grad():
        for p, q in params:
            q.copy_(scope.find_var(p.name))
    out = torch.from_numpy(x)
    for m in eager:
        out = m(out)
    el = F.cross_entropy(out, torch.from_numpy(lab))
    el.backward()
    assert got[0] == el.detach().numpy()
    grads = {p.name: g for (p, _), g in zip(pg, got[1:])}
    for p, q in params:
        assert np.array_equal(grads[p.name], q.grad.numpy()), p.name


def test_executor_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.static.Executor()


def test_unported_paths_raise_naming_their_item():
    t = Lenet(False, 4)
    with pytest.raises(NotImplementedError, match="item 6c"):
        pt.static.CompiledProgram(t.main).with_data_parallel()
    with pytest.raises(NotImplementedError, match="item 10"):
        t.exe.train_from_dataset(t.main)
    from paddle_tpu_torch.resilience import inject

    x, y = _batch(4)
    with inject.chaos("transient_execute"):
        with pytest.raises(NotImplementedError, match="item 7"):
            t.step(x, y)
