"""paddle_tpu_torch's static AMP (``amp.static_decorator``) against the
JAX package's.

The programs are recorded in both packages under fresh name generators
and Scopes (as ``tests/test_torch_static.py`` records them), the JAX
Scope's values copied in with ``convert.scope_from_jax`` (the loss
scale and its counters included), the feeds from ``RandomState(0)``;
the JAX Executor jitted, the port's op by op on the CPU.

- Phase 18(b)'s LN/CE program (Linear -> LayerNorm -> Linear ->
  cross-entropy; LN and CE black-listed, the Linears white) trained by
  SGD under ``decorate(dtype=...)``, 4 steps, the third with an inf in
  the input: the found-inf flags, ``@amp@scale``, ``@amp@good`` and
  ``@amp@bad`` exactly; the inf step leaves the parameters unchanged.
  A white-listed op's input gradients come back in the half type in
  both packages (the reference's vjp of the cast inputs), rounded from
  float32 sums taken in another order, so the parameters agree to two
  steps of the half type relative to each one's largest entry (float16
  2^-10, seen 4.6e-4 on a bias; bfloat16 2^-7, seen 3.6e-3), and the
  losses of the steps taken within 1e-4 (float16, seen 3.5e-5) or 2e-3
  (bfloat16, seen 7.8e-4) relative.
- bench_lenet_exec's LeNet: the same op list as the JAX program. With
  the default lists the JAX Executor cannot run it (its ``@grad`` op
  hands a float16 cotangent to a float32 op's vjp: ``ValueError``); the
  port runs it (from 2^7: at batch 8 LeNet's float16 gradients
  overflow at 2^15), and its 4 steps (the third with an inf pixel) keep
  the parameters through the inf step and follow the reference's scale
  rule. With ``conv2d`` and ``linear`` black-listed both run: losses
  within 1e-5 relative, parameters within 1e-5 of each one's largest
  entry, the scale state exactly.
- ``decorate``'s defaults are the reference's; the list-driven cast
  follows the lists, ``@grad`` ops their forward op's entry; a
  ``multi_precision`` update in a static program (float16 parameter,
  float32 master) equals the eager optimizer's bitwise.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu import optim as joptim
from paddle_tpu.amp import static_decorator as jsd
from paddle_tpu.amp.lists import AutoMixedPrecisionLists as JLists
from paddle_tpu.models.vision import LeNet as JLeNet
from paddle_tpu.static_ import program as jprog
from paddle_tpu.utils import unique_name as jun

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, nn, optim
from paddle_tpu_torch.amp import static_decorator as tsd
from paddle_tpu_torch.amp.lists import AutoMixedPrecisionLists as TLists
from paddle_tpu_torch.models.vision import LeNet
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.static_ import executor as texec
from paddle_tpu_torch.static_ import program as tprog
from paddle_tpu_torch.utils import unique_name as tun

from test_torch_static import _batch, _recording

from torch_test_threads import torch_threads  # noqa: F401,E402

STEPS = 4
INF_STEP = 2


class Prog:
    """One package's program under static AMP: ``kind`` "ln_ce" or
    "lenet"; ``lists`` the black list to add (None: the defaults)."""

    def __init__(self, jax, kind, dtype, black=None, **dec):
        self.jax = jax
        mod = jpt if jax else pt
        self.scope = (jprog.Scope if jax else tprog.Scope)()
        mod.seed(0)
        kw = {} if jax else {"device": "cpu"}
        lists = (JLists if jax else TLists)(custom_black_list=black) \
            if black else None
        sd = jsd if jax else tsd
        with _recording(mod.static, jun if jax else tun, self.scope):
            self.main = mod.static.Program()
            with mod.program_guard(self.main, mod.static.Program()):
                if kind == "lenet":
                    xv = mod.static.data("x", [8, 1, 28, 28], "float32")
                    yv = mod.static.data("y", [8], "int64")
                    model = JLeNet() if jax else LeNet(**kw)
                    self.loss = (JF if jax else F).cross_entropy(model(xv),
                                                                 yv)
                    opt = (joptim if jax else optim).Momentum(
                        0.01, 0.9, parameters=model.parameters())
                else:
                    xv = mod.static.data("x", [16, 128], "float32")
                    yv = mod.static.data("label", [16], "int64")
                    m = jnn if jax else nn
                    layers = (m.Linear(128, 128, **kw), m.LayerNorm(128, **kw),
                              m.Linear(128, 256, **kw))
                    h = xv
                    for layer in layers:
                        h = layer(h)
                    self.loss = (JF if jax else F).cross_entropy(h, yv)
                    opt = (joptim if jax else optim).SGD(
                        0.1, parameters=[p for layer in layers
                                         for p in layer.parameters()])
                self.opt = sd.decorate(opt, amp_lists=lists, dtype=dtype,
                                       **dec)
                self.opt.minimize(self.loss)
        self.exe = jpt.static.Executor() if jax else \
            pt.static.Executor("cpu")

    def step(self, feed):
        static = jpt.static if self.jax else pt.static
        with static.scope_guard(self.scope):
            loss, fi = self.exe.run(self.main, feed=feed,
                                    fetch_list=[self.loss, "@amp@found_inf"])
        return float(np.asarray(loss)), bool(np.asarray(fi))

    def values(self):
        return {n: np.asarray(v).copy() if self.jax
                else v.detach().float().numpy().copy()
                for n, v in self.scope._vars.items()}

    def scale_state(self):
        v = self.values()
        return tuple(v[k].item() for k in ("@amp@scale", "@amp@good",
                                             "@amp@bad"))


def _feeds(kind):
    if kind == "lenet":
        x, y = _batch(8)
        base = {"x": x, "y": y}
    else:
        rng = np.random.RandomState(0)
        base = {"x": rng.randn(16, 128).astype("float32"),
                "label": rng.randint(0, 256, 16).astype("int64")}
    out = []
    for i in range(STEPS):
        f = {k: v.copy() for k, v in base.items()}
        if i == INF_STEP:
            f["x"].reshape(-1)[0] = np.inf
        out.append(f)
    return out


def _pair(kind, dtype, black=None, **dec):
    j, t = Prog(True, kind, dtype, black, **dec), \
        Prog(False, kind, dtype, black, **dec)
    convert.scope_from_jax(j.values(), t.main, t.scope)
    return j, t


def _params(p):
    return {n: v for n, v in p.values().items() if not n.startswith("@")
            and "@OPT@" not in n}


def _run_both(j, t, kind):
    out = []
    for feed in _feeds(kind):
        before = _params(t)
        got, want = t.step(feed), j.step(feed)
        out.append((got, want, t.scale_state(), j.scale_state()))
        if got[1]:
            after = _params(t)
            assert all(np.array_equal(before[n], after[n]) for n in before)
    return out


def _check(out, loss_rtol):
    assert [o[0][1] for o in out] == [o[1][1] for o in out]
    assert [o[0][1] for o in out] == [i == INF_STEP for i in range(STEPS)]
    assert [o[2] for o in out] == [o[3] for o in out]
    taken = [o for o in out if not o[0][1]]
    np.testing.assert_allclose([o[0][0] for o in taken],
                               [o[1][0] for o in taken], rtol=loss_rtol)


@pytest.mark.parametrize("dtype, loss_rtol, param_tol", [
    ("float16", 1e-4, 2 * 2 ** -11), ("bfloat16", 2e-3, 2 * 2 ** -8)])
def test_ln_ce_program_matches_the_jax_executor(dtype, loss_rtol, param_tol):
    j, t = _pair("ln_ce", dtype, init_loss_scaling=2.0 ** 10,
                 incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
    assert [op.type for op in t.main.global_block.ops] == \
        [op.type for op in j.main.global_block.ops]
    out = _run_both(j, t, "ln_ce")
    _check(out, loss_rtol)
    # 2^10 grows at steps 1 and 2's ends... every 2 clean steps, shrinks
    # by 0.8 after the inf step
    assert [o[2][0] for o in out] == [1024.0, 2048.0, 1638.4000244140625,
                                      1638.4000244140625]
    jv, tv = _params(j), _params(t)
    assert sorted(jv) == sorted(tv)
    for n in jv:
        np.testing.assert_allclose(tv[n], jv[n], rtol=0,
                                   atol=param_tol * np.abs(jv[n]).max(),
                                   err_msg=n)


def test_lenet_records_the_jax_program():
    j = Prog(True, "lenet", "float16")
    t = Prog(False, "lenet", "float16")
    jops, tops = j.main.global_block.ops, t.main.global_block.ops
    assert [op.type for op in tops] == [op.type for op in jops]
    types = [op.type for op in tops]
    assert types[17:19] == ["amp_scale_loss", "fill_ones_like"]
    assert "amp_check_finite_and_unscale" in types
    assert types[-1] == "amp_update_loss_scaling"
    assert t.opt.get_scaled_loss().name.endswith("@SCALED")


def test_lenet_default_lists_run_where_the_jax_executor_cannot():
    # at batch 8 the float16 conv gradients overflow at 2^15: start lower
    j, t = _pair("lenet", "float16", init_loss_scaling=128.0)
    feeds = _feeds("lenet")
    with pytest.raises(ValueError, match="VJP"):
        j.step(feeds[0])
    out = []
    for feed in feeds:
        before = _params(t)
        loss, fi = t.step(feed)
        out.append((loss, fi, t.scale_state()))
        if fi:
            assert all(np.array_equal(before[n], v)
                       for n, v in _params(t).items())
    assert [o[1] for o in out] == [i == INF_STEP for i in range(STEPS)]
    assert all(np.isfinite(o[0]) for o in out if not o[1])
    # decr_every_n_nan_or_inf=2: one inf step leaves the scale
    assert [o[2] for o in out] == [(128.0, 1, 0), (128.0, 2, 0),
                                   (128.0, 0, 1), (128.0, 1, 0)]


def test_lenet_with_black_listed_products_matches_the_jax_executor():
    j, t = _pair("lenet", "float16", black=["conv2d", "linear"],
                 incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
    out = _run_both(j, t, "lenet")
    _check(out, 1e-5)
    jv, tv = _params(j), _params(t)
    for n in jv:
        np.testing.assert_allclose(tv[n], jv[n], rtol=0,
                                   atol=1e-5 * np.abs(jv[n]).max(),
                                   err_msg=n)


def test_decorate_defaults_are_the_references():
    t = tsd.decorate(optim.SGD(0.1, parameters=[]))
    j = jsd.decorate(joptim.SGD(0.1, parameters=[]))
    for obj in (t, j):
        s = obj._scaler
        assert (obj._init_loss_scaling, s.incr_every_n_steps,
                s.decr_every_n_nan_or_inf, s.incr_ratio, s.decr_ratio,
                obj._use_dynamic, obj._dtype) == \
            (2.0 ** 15, 1000, 2, 2.0, 0.8, True, "bfloat16")
    assert t.get_loss_scaling() == 2.0 ** 15


def test_cast_follows_the_lists_and_grad_ops_their_forward():
    cast = texec._amp_cast_fn({"dtype": "float16", "lists": TLists()})
    x, i = torch.ones(2), torch.ones(2, dtype=torch.int64)
    assert [a.dtype for a in cast("linear", [x, i, None])[:2]] == \
        [torch.float16, torch.int64]
    assert cast("linear@grad", [x])[0].dtype == torch.float16
    h = x.half()
    assert cast("layer_norm@grad", [h])[0].dtype == torch.float32
    assert cast("add", [h])[0].dtype == torch.float16
    assert texec._amp_cast_fn(None) is None


def test_static_multi_precision_update_equals_the_eager_one():
    torch.manual_seed(0)
    p = torch.randn(8, 8).half()
    g = torch.randn(8, 8).half()
    opt = optim.AdamW(parameters=[("w", p.clone().requires_grad_())],
                      learning_rate=1e-2, multi_precision=True)
    state = opt._init_state(p)
    state = {k: v.float() for k, v in state.items()}
    state["master"] = p.float()
    skeys = sorted(state)
    upd = texec._UpdateFn(opt, "w", None, 1.0, skeys, guarded=True)
    lr = torch.tensor(1e-2)
    new = upd(p, g, lr, torch.tensor(False), *[state[k] for k in skeys])
    eager = dict(opt._named_params)["w"]
    eager.grad = g.clone()
    opt.step()
    assert new[0].dtype == torch.float16
    assert torch.equal(new[0], eager)
    got = dict(zip(skeys, new[1:]))
    for k, v in opt._accumulators["w"].items():
        assert torch.equal(got[k], v), k
    skipped = upd(p, g, lr, torch.tensor(True), *[state[k] for k in skeys])
    assert torch.equal(skipped[0], p)
    assert all(torch.equal(a, state[k]) for a, k in zip(skipped[1:], skeys))
