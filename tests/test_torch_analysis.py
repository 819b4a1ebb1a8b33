"""paddle_tpu_torch.analysis (the verifier and the compile passes)
against the JAX package's.

Every malformed Program of ``tests/test_analysis.py`` is built in both
packages (the same variables and ops, each op's function written in
its package's arrays) and must raise the same PTA codes; the passes
must leave the same number of ops at optimize levels 0, 1 and 2, and
keep the fetched values of the unoptimized replay bitwise.
"""
import contextlib
import gc
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.analysis as jana
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu import optim as joptim
from paddle_tpu.ops import _base as jbase
from paddle_tpu.static_ import program as jprog
from paddle_tpu.utils import unique_name as jun

import paddle_tpu_torch as pt
import paddle_tpu_torch.analysis as tana
from paddle_tpu_torch import nn, optim
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import _base as tbase
from paddle_tpu_torch.static_ import program as tprog
from paddle_tpu_torch.utils import unique_name as tun

from torch_test_threads import torch_threads  # noqa: F401,E402

JAX = types.SimpleNamespace(
    name="jax", pkg=jpt, prog=jprog, ana=jana, F=JF, nn=jnn, optim=joptim,
    names=jun, base=jbase, arr=jnp.asarray, maximum=jnp.maximum,
    exe=lambda: jpt.static.Executor(), nnkw={},
    value=lambda v: np.asarray(v))
PORT = types.SimpleNamespace(
    name="port", pkg=pt, prog=tprog, ana=tana, F=F, nn=nn, optim=optim,
    names=tun, base=tbase, arr=torch.as_tensor,
    maximum=lambda a, b: torch.clamp_min(a, b),
    exe=lambda: pt.static.Executor("cpu"), nnkw={"device": "cpu"},
    value=lambda v: v.numpy())
SIDES = [JAX, PORT]


@contextlib.contextmanager
def static(s):
    """Static mode of side ``s`` with a fresh name generator and Scope."""
    with s.names.guard(), s.prog.scope_guard(s.prog.Scope()):
        s.pkg.enable_static()
        try:
            yield
        finally:
            s.pkg.disable_static()


def _data_var(blk, name="x", shape=(2, 3)):
    return blk.create_var(name=name, shape=shape, dtype="float32",
                          is_data=True)


def _register(s, name, fn):
    if name not in s.base.OP_REGISTRY:
        if s is JAX:
            s.base.register(name)(fn)
        else:
            s.base.register(name, inputs=("v",))(fn)
    return s.base.OP_REGISTRY[name]


# -- verifier: one broken Program per diagnostic class ----------------------


def _dangling(s):
    p = s.prog.Program()
    blk = p.global_block
    _data_var(blk)
    blk.create_var(name="y", shape=(2, 3), dtype="float32")
    blk.append_op(s.prog.Operator("relu", lambda a: s.maximum(a, 0),
                                  ["nowhere"], ["y"], {}))
    return p, ("y",)


def _use_before_def(s):
    p = s.prog.Program()
    blk = p.global_block
    _data_var(blk)
    blk.create_var(name="tmp", shape=(2, 3), dtype="float32")
    blk.create_var(name="o", shape=(2, 3), dtype="float32")
    blk.append_op(s.prog.Operator("scale", lambda a: a * 2.0, ["tmp"],
                                  ["o"], {}))
    blk.append_op(s.prog.Operator("scale", lambda a: a * 0.5, ["x"],
                                  ["tmp"], {}))
    return p, ("o",)


def _duplicate_output(s):
    p = s.prog.Program()
    blk = p.global_block
    _data_var(blk)
    blk.create_var(name="y", shape=(2, 3), dtype="float32")
    blk.append_op(s.prog.Operator("twin", lambda a: (a, a * 2), ["x"],
                                  ["y", "y"], {}))
    return p, ()


def _shape_drift(s):
    p = s.prog.Program()
    blk = p.global_block
    _data_var(blk)
    blk.create_var(name="s", shape=(5, 7), dtype="float32")
    blk.append_op(s.prog.Operator("relu", lambda a: s.maximum(a, 0),
                                  ["x"], ["s"], {}))
    return p, ()


def _dtype_drift(s):
    p = s.prog.Program()
    blk = p.global_block
    _data_var(blk)
    blk.create_var(name="z", shape=(2, 3), dtype="int32")
    blk.append_op(s.prog.Operator("relu", lambda a: s.maximum(a, 0),
                                  ["x"], ["z"], {}))
    return p, ()


def _donated_then_read(s):
    p = s.prog.Program()
    blk = p.global_block
    _data_var(blk)
    blk.create_var(name="w@acc", shape=(2, 3), dtype="float32",
                   persistable=True)
    blk.create_var(name="r", shape=(2, 3), dtype="float32")
    blk.append_op(s.prog.Operator("axpy", lambda a, b: a + b,
                                  ["x", "w@acc"], ["w@acc"], {}))
    blk.append_op(s.prog.Operator("scale", lambda a: a * 2.0, ["w@acc"],
                                  ["r"], {}))
    return p, ("r",)


BROKEN = {"PTA002": _dangling, "PTA001": _use_before_def,
          "PTA003": _duplicate_output, "PTA005": _shape_drift,
          "PTA006": _dtype_drift, "PTA007": _donated_then_read}


@pytest.mark.parametrize("code", sorted(BROKEN))
def test_malformed_program_raises_the_jax_codes(code):
    got = {}
    for s in SIDES:
        p, fetch = BROKEN[code](s)
        rep = s.ana.verify_program(p, fetch_names=fetch,
                                   raise_on_error=False)
        got[s.name] = [(d.code, d.var) for d in rep.errors()]
        with pytest.raises(s.ana.ProgramVerificationError):
            s.ana.verify_program(p, fetch_names=fetch)
    assert got["port"] == got["jax"]
    assert code in [c for c, _ in got["port"]]


def test_waw_clobber_through_the_recorder_pta004():
    codes = {}
    for s in SIDES:
        with static(s):
            main = s.pkg.static.Program()
            with s.pkg.static.program_guard(main):
                x = s.pkg.static.data("x", [-1, 4], "float32")
                t = s.F.relu(x)             # nothing reads t ...
                t.set_value(x * 3.0)        # ... before assign_to clobbers it
                t * 1.0
            rep = s.ana.verify_program(main, raise_on_error=False)
            codes[s.name] = [d.code for d in rep.errors()]
            with pytest.raises(s.ana.ProgramVerificationError):
                s.exe().run(main, feed={"x": np.ones((2, 4), np.float32)},
                            fetch_list=[t])
    assert codes["port"] == codes["jax"] and "PTA004" in codes["port"]


def test_donation_through_the_executor_and_unheld_persistable():
    for s in SIDES:
        p, _ = _donated_then_read(s)
        with s.prog.scope_guard(s.prog.Scope()):
            s.prog.global_scope().set("w@acc",
                                      s.arr(np.ones((2, 3), np.float32)))
            with pytest.raises(s.ana.ProgramVerificationError):
                s.exe().run(p, feed={"x": np.ones((2, 3), np.float32)},
                            fetch_list=["r"])
    # a persistable the Scope does not hold is plain env state
    outs = []
    for s in SIDES:
        p = s.prog.Program()
        blk = p.global_block
        _data_var(blk)
        blk.create_var(name="stat", shape=(2, 3), dtype="float32",
                       persistable=True)
        blk.create_var(name="r2", shape=(2, 3), dtype="float32")
        blk.append_op(s.prog.Operator("copy", lambda a: a * 1.0, ["x"],
                                      ["stat"], {}))
        blk.append_op(s.prog.Operator("scale", lambda a: a * 2.0, ["stat"],
                                      ["r2"], {}))
        rep = s.ana.verify_program(p, fetch_names=("r2",), scope_names=set(),
                                   raise_on_error=False)
        assert rep.errors() == []
        with s.prog.scope_guard(s.prog.Scope()):
            outs.append(s.exe().run(
                p, feed={"x": np.ones((2, 3), np.float32)},
                fetch_list=["r2"])[0])
    np.testing.assert_array_equal(outs[1], outs[0])


def _regression(s, dropout=False, optimize=True, backward=False):
    """x (-1, 4) -> Linear(4, 8) -> relu [-> dropout] -> Linear(8, 1) ->
    mean squared error [-> SGD minimize | append_backward]."""
    main = s.pkg.static.Program()
    with s.pkg.static.program_guard(main, s.pkg.static.Program()):
        x = s.pkg.static.data("x", [-1, 4], "float32")
        y = s.pkg.static.data("y", [-1, 1], "float32")
        l1, l2 = s.nn.Linear(4, 8, **s.nnkw), s.nn.Linear(8, 1, **s.nnkw)
        h = s.F.relu(l1(x))
        if dropout:
            h = s.F.dropout(h, 0.5)
        d = l2(h) - y
        loss = (d * d).mean()
        if optimize:
            s.optim.SGD(0.1, parameters=[l1.weight, l1.bias, l2.weight,
                                         l2.bias]).minimize(loss)
        if backward:
            s.pkg.static.append_backward(loss)
    return main, loss


def test_clean_training_program_verifies_and_runs():
    types_ = {}
    feed = {"x": np.random.RandomState(0).randn(8, 4).astype(np.float32),
            "y": np.random.RandomState(1).randn(8, 1).astype(np.float32)}
    for s in SIDES:
        with static(s):
            main, loss = _regression(s)
            rep = s.ana.verify_program(main, fetch_names=(loss.name,),
                                       raise_on_error=False)
            assert rep.errors() == []
            out = s.exe().run(main, feed=feed, fetch_list=[loss])
            assert np.isfinite(out[0]).all()
        types_[s.name] = [op.type for op in main.global_block.ops]
    assert types_["port"] == types_["jax"]


def test_dynamic_dim_mask_and_static_dim_feed_warning():
    for s in SIDES:
        with static(s):
            main = s.pkg.static.Program()
            with s.pkg.static.program_guard(main):
                x = s.pkg.static.data("x", [-1, 3], "float32")
                s.F.relu(x)
        assert x.dynamic_dims == (0,)
        assert list(x.shape) == [1, 3]
        rep = s.ana.verify_program(main, feed_shapes={
            "x": ((64, 3), "float32")}, raise_on_error=False)
        assert not rep.has("PTA009")
        with pytest.warns(RuntimeWarning, match="declared static shape"):
            rep = s.ana.verify_program(main, feed_shapes={
                "x": ((64, 5), "float32")}, raise_on_error=False)
        assert rep.has("PTA009") and rep.errors() == []


def test_program_uid_monotonic_and_cache_keyed_on_uid():
    uids = [tprog.Program()._uid for _ in range(3)]
    assert uids == sorted(uids) and len(set(uids)) == 3
    p1 = tprog.Program()
    uid1 = p1._uid
    del p1
    gc.collect()
    assert tprog.Program()._uid > uid1
    with static(PORT):
        main = pt.static.Program()
        with pt.static.program_guard(main):
            x = pt.static.data("x", [-1, 4], "float32")
            out = F.relu(x)
        exe = pt.static.Executor("cpu")
        exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                fetch_list=[out])
    assert any(k.program_uid == main._uid for k in exe._cache)
    assert not any(k.program_uid == id(main) for k in exe._cache)


# -- optimization passes ----------------------------------------------------


def _pass_programs(s):
    """(program, fetch names) whose passes remove something: an eval
    clone with a neutered dropout and a dead grad chain, a duplicate
    pure op, a dead op."""
    main, loss = _regression(s, dropout=True, optimize=False, backward=True)
    out = [(main.clone(for_test=True), (loss.name,))]
    p = s.pkg.static.Program()
    with s.pkg.static.program_guard(p):
        x = s.pkg.static.data("x", [-1, 6], "float32")
        a, b = s.F.relu(x), s.F.relu(x)
        out.append((p, ((a + b).sum().name,)))
    p = s.pkg.static.Program()
    with s.pkg.static.program_guard(p):
        x = s.pkg.static.data("x", [-1, 4], "float32")
        x * 2.0
        out.append((p, (s.F.relu(x).name,)))
    return out


def test_pass_op_counts_match_jax_and_keep_fetches_bitwise():
    counts = {}
    feeds = [{"x": np.random.RandomState(0).randn(4, 4).astype(np.float32),
              "y": np.random.RandomState(1).randn(4, 1).astype(np.float32)},
             {"x": np.random.RandomState(2).randn(3, 6).astype(np.float32)},
             {"x": np.ones((2, 4), np.float32)}]
    for s in SIDES:
        with static(s):
            progs = _pass_programs(s)
            counts[s.name] = [[len(s.ana.run_compile_passes(
                p, fetch_list=list(f), optimize_level=level)[0])
                for level in (0, 1, 2)] for p, f in progs]
            if s is PORT:
                for (p, f), feed in zip(progs, feeds):
                    exe = s.exe()
                    ref = exe.run(p, feed=feed, fetch_list=list(f),
                                  optimize_level=0)
                    for level in (1, 2):
                        got = exe.run(p, feed=feed, fetch_list=list(f),
                                      optimize_level=level)
                        assert all(np.array_equal(a, b)
                                   for a, b in zip(got, ref))
    assert counts["port"] == counts["jax"]
    assert all(c[0] > c[2] for c in counts["port"])


def _cse_inplace(s):
    p = s.prog.Program()
    blk = p.global_block
    _data_var(blk, "x", (4,))
    for n in ("a", "b", "c"):
        blk.create_var(name=n, shape=(4,), dtype="float32")
    fn = _register(s, "t_double", lambda v: v * 2.0)
    blk.append_op(s.prog.Operator("t_double", fn, ["x"], ["a"], {}))
    blk.append_op(s.prog.Operator("assign_to", lambda v: v, ["a"], ["x"],
                                  {}))
    blk.append_op(s.prog.Operator("t_double", fn, ["x"], ["b"], {}))
    blk.append_op(s.prog.Operator("axpy", lambda u, v: u + v, ["a", "b"],
                                  ["c"], {}))
    return len(s.ana.CSEPass().rewrite(s.ana.PassContext(
        p, fetch_names=("c",))))


def _cse_clobbered(s):
    fn = _register(s, "t_exp", (lambda v: jnp.exp(v)) if s is JAX
                   else (lambda v: torch.exp(v)))
    p = s.prog.Program()
    blk = p.global_block
    _data_var(blk, "x", (2,))
    blk.create_var(name="c", shape=(2,), dtype="float32")
    p._constants["c"] = s.arr(np.asarray([7.0, 7.0], np.float32))
    for n in ("a", "b", "u", "y"):
        blk.create_var(name=n, shape=(2,), dtype="float32")
    blk.append_op(s.prog.Operator("t_exp", fn, ["x"], ["a"], {}))
    blk.append_op(s.prog.Operator("scale", lambda v: v * 1.0, ["a"], ["u"],
                                  {}))
    blk.append_op(s.prog.Operator("t_exp", fn, ["x"], ["b"], {}))
    blk.append_op(s.prog.Operator("assign_to", lambda v: v, ["c"], ["a"],
                                  {}))
    blk.append_op(s.prog.Operator("t_exp", fn, ["b"], ["y"], {}))
    return len(s.ana.CSEPass().rewrite(s.ana.PassContext(
        p, fetch_names=("u", "y"))))


def _dce_persistable(s):
    p = s.prog.Program()
    blk = p.global_block
    _data_var(blk, "x", (4,))
    blk.create_var(name="stat", shape=(4,), dtype="float32",
                   persistable=True)
    blk.create_var(name="o", shape=(4,), dtype="float32")
    blk.append_op(s.prog.Operator("upd", lambda a, b: a + b,
                                  ["x", "stat"], ["stat"], {}))
    blk.append_op(s.prog.Operator("id", lambda a: a * 1.0, ["x"], ["o"],
                                  {}))
    ops = s.ana.DeadOpEliminationPass().rewrite(s.ana.PassContext(
        p, fetch_names=("o",)))
    return [op.type for op in ops]


@pytest.mark.parametrize("case", [_cse_inplace, _cse_clobbered,
                                  _dce_persistable])
def test_guarded_rewrites_match_jax(case):
    assert case(PORT) == case(JAX)


def test_forward_identity_blocked_when_source_overwritten_later():
    p = tprog.Program()
    blk = p.global_block
    _data_var(blk, "x", (2,))
    blk.create_var(name="c", shape=(2,), dtype="float32")
    p._constants["c"] = torch.tensor([100.0, 100.0])
    blk.create_var(name="h", shape=(2,), dtype="float32")
    blk.create_var(name="y", shape=(2,), dtype="float32")
    blk.append_op(tprog.Operator(
        "dropout", tbase.OP_REGISTRY["dropout"], ["x"], ["h"],
        {"p": 0.0, "axis": None, "training": True,
         "mode": "upscale_in_train", "generator": None}))
    blk.append_op(tprog.Operator("assign_to", lambda v: v, ["c"], ["x"], {}))
    blk.append_op(tprog.Operator("scale", lambda a: a * 1.0, ["h"], ["y"],
                                 {}))
    exe = pt.static.Executor("cpu")
    feed = {"x": np.asarray([1.0, 2.0], np.float32)}
    ref = exe.run(p, feed=feed, fetch_list=["y"], optimize_level=0)[0]
    opt = exe.run(p, feed=feed, fetch_list=["y"], optimize_level=1)[0]
    np.testing.assert_array_equal(ref, opt)
    np.testing.assert_array_equal(ref, [1.0, 2.0])


def test_append_backward_runs_structural_verifier():
    for s in SIDES:
        with static(s):
            main = s.pkg.static.Program()
            with s.pkg.static.program_guard(main):
                x = s.pkg.static.data("x", [-1, 4], "float32")
                loss = s.nn.Linear(4, 4, **s.nnkw)(x).mean()
                main.global_block.append_op(s.prog.Operator(
                    "broken", lambda a: a, ["ghost_var"], [loss.name], {}))
                with pytest.raises(s.ana.ProgramVerificationError):
                    s.pkg.static.append_backward(loss)


def test_optimize_level_0_compiles_full_program():
    with static(PORT):
        main = pt.static.Program()
        with pt.static.program_guard(main):
            x = pt.static.data("x", [-1, 4], "float32")
            x * 2.0                 # dead at level >= 1
            out = F.relu(x)
        exe = pt.static.Executor("cpu")
        feed = {"x": np.ones((2, 4), np.float32)}
        exe.run(main, feed=feed, fetch_list=[out], optimize_level=0)
        assert exe.last_diagnostics.pass_stats == {}
        exe.run(main, feed=feed, fetch_list=[out], optimize_level=1)
        assert exe.last_diagnostics.pass_stats[
            "dead_op_elimination"]["removed"] == 1
