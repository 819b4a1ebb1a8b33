"""paddle_tpu_torch's Ftrl, DecayedAdagrad, Dpsgd, LarsMomentum and
DGCMomentum, and the wrappers ExponentialMovingAverage, LookAhead,
ModelAverage, RecomputeOptimizer and PipelineOptimizer, against the JAX
package's (``paddle_tpu/optim/optimizer.py:394-699``).

- The rules: eight updates of a (64, 48) parameter from the same
  gradients. Float32 with the learning rate a float32 scalar, as the
  reference's ``TrainStep`` passes it (``jit.py:422``), and bfloat16
  with ``multi_precision`` (the update on a float32 master): the
  parameter, the master and every state value are the reference's bits
  wherever the rule is elementwise. Three operations are not:
  LarsMomentum's two norms and Dpsgd's clip norm are sums the two
  packages take in another order, and Ftrl's ``n ** -lr_power`` is
  XLA's ``pow`` in the reference, which its CPU backend does not round
  correctly (1 ulp off in ~0.06% of values at 0.5; the port takes the
  correctly rounded square root). Those cases agree to ``NORM_RTOL``
  1e-6 and an absolute ``NORM_ATOL`` of 2^-23 (seen: 1.5e-8 at most,
  Ftrl's parameter); Ftrl at ``lr_power = -1`` (an exact power) and
  Dpsgd with its norm under ``clip`` (a clip factor of exactly 1) are
  bitwise. bfloat16 without a master follows the reference's eager
  step (a Python learning rate, weak-typed): the rules round each scalar
  to bfloat16 first, as JAX does, and give its bits; DGCMomentum is the
  port's ``Momentum``, rounded by torch's rules, and the three cases
  above differ as in float32: those agree within ``BF16_TOL``, 2^-6 of
  each tensor's largest magnitude.
- Dpsgd at ``sigma = 0`` is bitwise SGD's update; its noise is checked
  apart: mean and standard deviation of a 128 x 256 draw, fresh at
  every step, the same from the same generator seed.
- The wrappers: LookAhead's 10-step trajectory over Momentum (float32,
  and bfloat16 with masters: the pull writes the parameter, not the
  master, as the reference does), ExponentialMovingAverage with and
  without ``thres_steps``, ModelAverage's window restarts at
  ``max_average_window``/``min_average_window`` and its early-``apply``
  error, all bitwise; ``apply()`` then ``restore()`` gives every
  parameter back bitwise.
- ``TrainStep``: 4 op-by-op steps of the GPT of
  ``tests/test_pallas_routing.py`` (vocab 512, hidden 128, 2 layers, 2
  heads, L 128, dropout 0; batch 4 x 128) with each rule against the
  JAX ``TrainStep``, losses within 5e-5 as
  ``tests/test_torch_jit.py`` (float32 sums in another order). The JAX
  ``TrainStep`` refuses Dpsgd (its update runs outside the step's key
  context, ``jit.py:115-121``, so ``Dpsgd._update`` raises), so the
  port's Dpsgd at sigma 0 and an unclipped norm is held to the JAX
  ``TrainStep`` under SGD, which is the same update.
- The static ``Optimizer.minimize``: 4 ``Executor.run`` calls of a small
  linear-regression program with each rule against the JAX Executor,
  parameters and slots within 1e-6, absolute as
  ``tests/test_torch_static.py`` and relative for Ftrl's accumulators
  (|values| ~50).
- ``state_dict``/``set_state_dict`` and ``convert.optimizer_state_from_jax``
  carry the new states: the next update is bitwise the uninterrupted one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jpt
from paddle_tpu import optim as joptim
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.models.nlp import gpt as jgpt
from paddle_tpu_torch import convert, core, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.nlp import gpt

from torch_test_threads import torch_threads  # noqa: F401,E402

LR = 1e-2
NORM_RTOL = 1e-6
NORM_ATOL = 2 ** -23
BF16_TOL = 2 ** -6
LOSS_TOL = 5e-5

# name: (JAX class, port class, keyword arguments, bitwise in float32)
RULES = {
    "ftrl": (joptim.Ftrl, optim.Ftrl,
             {"l1": 0.01, "l2": 0.02, "lr_power": -1.0}, True),
    "ftrl_sqrt": (joptim.Ftrl, optim.Ftrl, {"l1": 0.01, "l2": 0.02},
                  False),
    "decayed_adagrad": (joptim.DecayedAdagrad, optim.DecayedAdagrad,
                        {"decay": 0.9}, True),
    "dpsgd": (joptim.Dpsgd, optim.Dpsgd,
              {"clip": 1e3, "sigma": 0.0, "batch_size": 4.0}, True),
    "dpsgd_clipped": (joptim.Dpsgd, optim.Dpsgd,
                      {"clip": 0.5, "sigma": 0.0, "batch_size": 4.0},
                      False),
    "lars": (joptim.LarsMomentum, optim.LarsMomentum,
             {"momentum": 0.9, "lars_coeff": 0.01}, False),
    "dgc": (joptim.DGCMomentum, optim.DGCMomentum,
            {"momentum": 0.9, "rampup_begin_step": 2}, True),
}
# bfloat16 without a master: the reference's bits (every scalar rounded
# to bfloat16 first, as JAX does)
BF16_BITWISE = {"ftrl", "decayed_adagrad", "dpsgd"}


def _data(steps=8, seed=11, shape=(64, 48)):
    rng = np.random.RandomState(seed)
    p0 = (rng.randn(*shape) * 0.05).astype(np.float32)
    return p0, [(rng.randn(*shape) * 0.1).astype(np.float32)
                for _ in range(steps)]


def _reference_run(jcls, kw, p0, gs, mode):
    """The reference's update of one parameter: float32 (a float32 lr),
    bfloat16 on a float32 master (``optimizer.py:108-124``) or bfloat16
    alone with a Python lr (its eager ``step``)."""
    jopt = jcls(learning_rate=LR, parameters=[], **kw)
    dtype = jnp.float32 if mode == "float32" else jnp.bfloat16
    jp = jnp.asarray(p0).astype(dtype)
    js = jopt._init_state(jp)
    master = None
    if mode == "bfloat16-master":
        master = jp.astype(jnp.float32)
        js = {k: v.astype(jnp.float32) for k, v in js.items()}
    lr = LR if mode == "bfloat16" else jnp.float32(LR)
    for g in gs:
        jg = jnp.asarray(g).astype(dtype)
        if master is None:
            jp, js = jopt._update(jp, jg, js, lr)
        else:
            master, js = jopt._update(master, jg.astype(jnp.float32), js,
                                      lr)
            jp = master.astype(jnp.bfloat16)
    return jp, master, js


def _f32(a):
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("mode", ["float32", "bfloat16-master", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(RULES))
def test_rule_matches_the_reference(kind, mode):
    jcls, tcls, kw, bitwise = RULES[kind]
    p0, gs = _data()
    jp, jmaster, js = _reference_run(jcls, kw, p0, gs, mode)
    tdtype = torch.float32 if mode == "float32" else torch.bfloat16
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()).to(tdtype))
    opt = tcls(learning_rate=LR, parameters=[("w", p)],
               multi_precision=mode == "bfloat16-master", **kw)
    for g in gs:
        p.grad = torch.from_numpy(g.copy()).to(tdtype)
        opt.step()
    s = opt._accumulators["w"]
    assert p.dtype == tdtype
    assert sorted(k for k in s if k != "master") == sorted(js)
    pairs = [("param", p.detach().float().numpy(), _f32(jp))]
    pairs += [(k, s[k].float().numpy(), _f32(js[k])) for k in sorted(js)]
    if mode == "bfloat16-master":
        assert s["master"].dtype == torch.float32
        pairs.append(("master", s["master"].numpy(), _f32(jmaster)))
    else:
        assert "master" not in s
        for k in js:   # a state in the parameter's type stays in it
            assert s[k].dtype == (torch.float32 if js[k].dtype ==
                                  jnp.float32 else tdtype), k
    for name, a, b in pairs:
        if mode == "bfloat16" and kind not in BF16_BITWISE:
            np.testing.assert_allclose(
                a, b, rtol=0, atol=BF16_TOL * max(np.abs(b).max(), 1e-30),
                err_msg=name)
        elif bitwise or mode == "bfloat16":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=NORM_RTOL,
                                       atol=NORM_ATOL, err_msg=name)


def test_dpsgd_noise_is_fresh_gaussian_and_seeded():
    """From a zero parameter and gradient at lr 1 the update is minus the
    noise: N(0, (sigma * clip / batch_size)^2), 32768 draws (mean within
    5 standard errors, std within 2%), new at each step, the same after
    ``core.seed`` with the same seed."""
    sigma, clip, batch = 2.0, 1.5, 3.0
    std = sigma * clip / batch

    def run(seed, steps):
        core.seed(seed)
        p = torch.nn.Parameter(torch.zeros(128, 256))
        opt = optim.Dpsgd(1.0, clip=clip, batch_size=batch, sigma=sigma,
                          parameters=[p])
        out = []
        for _ in range(steps):
            before = p.detach().clone()
            p.grad = torch.zeros(128, 256)
            opt.step()
            out.append(before - p.detach())
        return out

    a, b = run(5, 2)
    for n in (a, b):
        assert abs(float(n.mean())) < 5 * std / np.sqrt(n.numel())
        assert abs(float(n.std()) / std - 1) < 0.02
    assert not torch.equal(a, b)
    a2, b2 = run(5, 2)
    assert torch.equal(a, a2) and torch.equal(b, b2)
    assert not torch.equal(run(6, 1)[0], a)


# -- the wrappers --------------------------------------------------------------


def _jax_param(p0, name="w"):
    return JParameter(jnp.asarray(p0), name=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16-master"])
def test_lookahead_trajectory_matches_the_reference(dtype):
    """10 steps of LookAhead(Momentum, alpha 0.5, k 3): the parameter
    after every step is the reference's bits (pulls at steps 3, 6, 9),
    and the inner master keeps its fast weights, as in the reference."""
    bf16 = dtype != "float32"
    p0, gs = _data(steps=10, seed=3, shape=(16, 8))
    jd = jnp.bfloat16 if bf16 else jnp.float32
    td = torch.bfloat16 if bf16 else torch.float32
    jparam = _jax_param(jnp.asarray(p0).astype(jd))
    jopt = joptim.LookAhead(joptim.Momentum(
        LR, 0.9, parameters=[jparam], multi_precision=bf16), 0.5, 3)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()).to(td))
    opt = optim.LookAhead(optim.Momentum(
        LR, 0.9, parameters=[("w", p)], multi_precision=bf16), 0.5, 3)
    for g in gs:
        jparam.grad = jpt.to_tensor(np.asarray(jnp.asarray(g).astype(jd)))
        jopt.step()
        p.grad = torch.from_numpy(g.copy()).to(td)
        opt.step()
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      _f32(jparam._data))
    if bf16:
        jm = jopt.inner._accumulators[jparam.name]["master"]
        np.testing.assert_array_equal(
            opt.inner._accumulators["w"]["master"].numpy(), _f32(jm))
    assert opt.state_dict().keys() == opt.inner.state_dict().keys()


def _walk(steps, shape=(16, 8), seed=4):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * 0.1).astype(np.float32)
            for _ in range(steps)]


@pytest.mark.parametrize("thres", [None, 1000], ids=["plain", "thres"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ema_matches_the_reference(dtype, thres):
    """Six updates after six parameter values: the shadows are the
    reference's bits (``thres_steps``: d = min(decay, (1+t)/(10+t)));
    ``apply()`` sets them, ``restore()`` gives the parameters back."""
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
              else (jnp.float32, torch.float32))
    vals = _walk(7)
    jparam = _jax_param(jnp.asarray(vals[0]).astype(jd))
    jema = joptim.ExponentialMovingAverage([jparam], decay=0.9,
                                           thres_steps=thres)
    p = torch.nn.Parameter(torch.from_numpy(vals[0]).to(td))
    ema = optim.ExponentialMovingAverage([("w", p)], decay=0.9,
                                         thres_steps=thres)
    for v in vals[1:]:
        jparam._replace(jnp.asarray(v).astype(jd))
        jema.update()
        with torch.no_grad():
            p.copy_(torch.from_numpy(v))
        ema.update()
        np.testing.assert_array_equal(ema._shadow["w"].float().numpy(),
                                      _f32(jema._shadow[jparam.name]))
    before = p.detach().clone()
    ema.apply()
    jema.apply()
    np.testing.assert_array_equal(p.detach().float().numpy(),
                                  _f32(jparam._data))
    ema.restore()
    assert torch.equal(p.detach(), before)


def test_model_average_restarts_and_refuses_an_early_apply():
    """max_average_window 3, min 2: after each of 8 steps the float32 sum
    and the count are the reference's, the window restarting at steps 4
    and 7; ``apply()`` sets sum / count, ``restore()`` gives the
    parameter back bitwise; ``apply()`` before a step raises in both."""
    vals = _walk(8, seed=5)
    jparam = _jax_param(vals[0])
    jma = joptim.ModelAverage(0.15, [jparam], min_average_window=2,
                              max_average_window=3)
    p = torch.nn.Parameter(torch.from_numpy(vals[0].copy()))
    ma = optim.ModelAverage(0.15, [("w", p)], min_average_window=2,
                            max_average_window=3)
    with pytest.raises(RuntimeError, match="before any step"):
        jma.apply()
    with pytest.raises(RuntimeError, match="before any step"):
        ma.apply()
    counts = []
    for v in vals:
        jparam._replace(jnp.asarray(v))
        jma.step()
        with torch.no_grad():
            p.copy_(torch.from_numpy(v))
        ma.step()
        counts.append(ma._count)
        assert ma._count == jma._count
        np.testing.assert_array_equal(ma._sum["w"].numpy(),
                                      _f32(jma._sum[jparam.name]))
    assert counts == [1, 2, 3, 1, 2, 3, 1, 2]
    before = p.detach().clone()
    ma.apply()
    jma.apply()
    np.testing.assert_array_equal(p.detach().numpy(), _f32(jparam._data))
    ma.restore()
    assert torch.equal(p.detach(), before)


@pytest.mark.parametrize("wrapper", ["recompute", "pipeline"])
def test_delegating_wrappers_step_the_inner_optimizer(wrapper):
    p0, gs = _data(steps=2, shape=(8, 4))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    q = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    inner = optim.Momentum(LR, 0.9, parameters=[("w", p)])
    opt = (optim.RecomputeOptimizer(inner) if wrapper == "recompute"
           else optim.PipelineOptimizer(inner, num_microbatches=2))
    plain = optim.Momentum(LR, 0.9, parameters=[("w", q)])
    x = torch.from_numpy(gs[0])
    opt.minimize((p * x).sum())
    (q * x).sum().backward()
    plain.step()
    assert torch.equal(p.detach(), q.detach())
    assert opt.get_lr() == LR and opt._global_step == 1
    assert opt.state_dict().keys() == plain.state_dict().keys()


def test_fluid_names_are_the_classes():
    assert optim.FtrlOptimizer is optim.Ftrl
    assert optim.LarsMomentumOptimizer is optim.LarsMomentum
    assert optim.LookaheadOptimizer is optim.LookAhead
    assert optim.DGCMomentumOptimizer is optim.DGCMomentum
    assert optim.DecayedAdagradOptimizer is optim.DecayedAdagrad
    assert optim.DpsgdOptimizer is optim.Dpsgd
    assert {n for n in joptim.__dict__ if n.endswith("Optimizer")} <= \
        set(optim.__dict__)


# -- state dicts and convert ---------------------------------------------------


@pytest.mark.parametrize("kind", ["ftrl", "decayed_adagrad", "lars", "dgc"])
def test_state_dict_round_trip_continues_bitwise(kind):
    _, tcls, kw, _ = RULES[kind]
    p0, gs = _data(steps=3, shape=(16, 8))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tcls(learning_rate=LR, parameters=[("w", p)], **kw)
    for g in gs[:2]:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    q = torch.nn.Parameter(p.detach().clone())
    other = tcls(learning_rate=LR, parameters=[("w", q)], **kw)
    other.set_state_dict({k: v.clone() if isinstance(v, torch.Tensor)
                          else v for k, v in opt.state_dict().items()})
    assert other._global_step == 2
    for t, opt_ in ((p, opt), (q, other)):
        t.grad = torch.from_numpy(gs[2].copy())
        opt_.step()
    assert torch.equal(p.detach(), q.detach())


@pytest.mark.parametrize("kind", ["ftrl", "decayed_adagrad", "lars",
                                  "dgc"])
def test_state_dict_from_the_reference_loads(kind):
    """The JAX optimizer's ``state_dict()`` after two updates, renamed by
    ``convert.optimizer_state_dict_from_jax``, loads into the port's: every
    slot the reference's bits; Dpsgd's (no state) carries its step."""
    jcls, tcls, kw, _ = RULES[kind]
    p0, gs = _data(steps=2, seed=13, shape=(16, 8))
    jparam = _jax_param(p0, "w_jax")
    jopt = jcls(learning_rate=LR, parameters=[jparam], **kw)
    for g in gs:
        jparam.grad = jpt.to_tensor(g)
        jopt.step()
    opt = tcls(learning_rate=LR, parameters=[("w", torch.nn.Parameter(
        torch.from_numpy(np.array(jparam._data))))], **kw)
    state = jopt.state_dict()
    opt.set_state_dict(convert.optimizer_state_dict_from_jax(state, opt))
    assert opt._global_step == 2
    for k, v in state.items():
        if not k.startswith("@"):
            np.testing.assert_array_equal(
                opt.state_dict()["w." + k.rsplit(".", 1)[1]].numpy(),
                _f32(v), err_msg=k)
    dp = optim.Dpsgd(parameters=[("w", torch.nn.Parameter(torch.zeros(2)))])
    dp.set_state_dict(convert.optimizer_state_dict_from_jax(
        {"@global_step": 3}, dp))
    assert dp._global_step == 3


@pytest.mark.parametrize("kind", ["ftrl", "decayed_adagrad", "dgc",
                                  "lookahead"])
def test_state_carried_from_the_reference_continues_bitwise(kind):
    """Two reference updates, then its state into the port's optimizer
    (``convert.optimizer_state_from_jax``, which unwraps LookAhead): the
    third update agrees."""
    p0, gs = _data(steps=3, seed=12, shape=(16, 8))
    jparam = _jax_param(p0, "w_jax")
    p = torch.nn.Parameter(torch.zeros(16, 8))
    if kind == "lookahead":
        jopt = joptim.LookAhead(joptim.DecayedAdagrad(
            LR, parameters=[jparam]), k=5)
        opt = optim.LookAhead(optim.DecayedAdagrad(
            LR, parameters=[("w", p)]), k=5)
    else:
        jcls, tcls, kw, _ = RULES[kind]
        jopt = jcls(learning_rate=LR, parameters=[jparam], **kw)
        opt = tcls(learning_rate=LR, parameters=[("w", p)], **kw)
    for g in gs[:2]:
        jparam.grad = jpt.to_tensor(g)
        jopt.step()
    with torch.no_grad():
        p.copy_(torch.from_numpy(np.array(jparam._data)))
    convert.optimizer_state_from_jax(jopt, opt)
    inner = getattr(opt, "inner", opt)
    assert inner._global_step == 2
    p.grad = torch.from_numpy(gs[2].copy())
    inner.step()
    jparam.grad = jpt.to_tensor(gs[2])
    getattr(jopt, "inner", jopt).step()
    np.testing.assert_array_equal(p.detach().numpy(), _f32(jparam._data))
    jinner = getattr(jopt, "inner", jopt)
    for k, v in jinner._accumulators[jparam.name].items():
        np.testing.assert_array_equal(inner._accumulators["w"][k].numpy(),
                                      _f32(v), err_msg=k)


# -- TrainStep -----------------------------------------------------------------

GPT_CFG = dict(vocab_size=512, hidden=128, layers=2, heads=2, max_seq=128,
               dropout=0.0)
# each rule at a learning rate that trains this GPT
TRAIN = {
    "ftrl": (joptim.Ftrl, optim.Ftrl, 1e-3, {"l1": 1e-4}),
    "decayed_adagrad": (joptim.DecayedAdagrad, optim.DecayedAdagrad, 1e-3,
                        {"decay": 0.9}),
    "lars": (joptim.LarsMomentum, optim.LarsMomentum, 0.5,
             {"momentum": 0.9, "lars_coeff": 0.01}),
    "dgc": (joptim.DGCMomentum, optim.DGCMomentum, 0.05,
            {"momentum": 0.9}),
    "dpsgd": (joptim.SGD, optim.Dpsgd, 0.05,
              {"clip": 1e6, "sigma": 0.0, "batch_size": 1.0}),
}


def _gpt_pair():
    jpt.seed(0)
    jm = jgpt.GPT(jgpt.GPTConfig(**GPT_CFG))
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    m = gpt.GPT(gpt.GPTConfig(**GPT_CFG), device="cpu")
    m.load_state_dict(convert.gpt_params_from_jax(sd))
    return jm, m


@pytest.mark.parametrize("kind", sorted(TRAIN))
def test_train_step_matches_the_reference(kind):
    jcls, tcls, lr, kw = TRAIN[kind]
    jm, m = _gpt_pair()
    jkw = {} if kind == "dpsgd" else kw
    jstep = jpt.TrainStep(jm, jcls(learning_rate=lr,
                                   parameters=jm.parameters(), **jkw),
                          jgpt.gpt_loss)
    step = TrainStep(m, tcls(learning_rate=lr,
                             parameters=m.named_parameters(), **kw),
                     gpt.gpt_loss)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, GPT_CFG["vocab_size"], (4, 128)).astype("int32")
    batch = (ids, np.roll(ids, -1, axis=1).astype("int32"))
    want = [float(np.asarray(jstep(*batch)._data)) for _ in range(4)]
    got = [float(step(*batch)) for _ in range(4)]
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=LOSS_TOL)
    assert all(np.isfinite(got)) and got[-1] < got[0]
    assert step.optimizer._global_step == 4


def test_the_reference_train_step_refuses_dpsgd():
    jm, _ = _gpt_pair()
    jstep = jpt.TrainStep(jm, joptim.Dpsgd(parameters=jm.parameters()),
                          jgpt.gpt_loss)
    ids = np.zeros((1, 128), "int32")
    with pytest.raises(RuntimeError, match="threaded PRNG key"):
        jstep(ids, ids)


# -- the static minimize -------------------------------------------------------


def _static_mlp(jax, make):
    from paddle_tpu.static_ import program as jprog
    from paddle_tpu.utils import unique_name as jun

    import paddle_tpu_torch as pt
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.static_ import program as tprog
    from paddle_tpu_torch.utils import unique_name as tun

    mod = jpt if jax else pt
    names, scope = (jun, jprog.Scope()) if jax else (tun, tprog.Scope())
    with names.guard(), mod.static.scope_guard(scope):
        mod.enable_static()
        try:
            main = mod.static.Program()
            with mod.program_guard(main, mod.static.Program()):
                x = mod.static.data("x", [-1, 8], "float32")
                y = mod.static.data("y", [-1, 1], "float32")
                kw = {} if jax else {"device": "cpu"}
                lin = (jnn if jax else nn).Linear(8, 1, **kw)
                d = lin(x) - y
                loss = (d * d).mean()
                make(jax, [lin.weight, lin.bias]).minimize(loss)
        finally:
            mod.disable_static()
    return main, scope, loss


@pytest.mark.parametrize("kind", ["ftrl", "decayed_adagrad", "lars",
                                  "dgc", "dpsgd"])
def test_static_minimize_matches_the_reference(kind):
    import paddle_tpu_torch as pt

    jcls, tcls, _, kw = TRAIN[kind]

    def make(jax, params):
        if jax:
            return jcls(learning_rate=0.05, parameters=params,
                        **({} if kind == "dpsgd" else kw))
        return tcls(learning_rate=0.05, parameters=params, **kw)

    jm, js, jl = _static_mlp(True, make)
    tm, ts, tl = _static_mlp(False, make)
    convert.scope_from_jax({n: np.asarray(v) for n, v in js._vars.items()},
                           tm, ts)
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(4, 8).astype("float32"),
            "y": rng.randn(4, 1).astype("float32")}
    jexe, texe = jpt.static.Executor(), pt.static.Executor("cpu")
    for _ in range(4):
        with jpt.static.scope_guard(js):
            jexe.run(jm, feed=feed, fetch_list=[jl])
        with pt.static.scope_guard(ts):
            texe.run(tm, feed=feed, fetch_list=[tl])
    for n, v in js._vars.items():
        np.testing.assert_allclose(ts.find_var(n).numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
