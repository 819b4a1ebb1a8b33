"""paddle_tpu_torch's loss scalers, ``TrainStep(scaler=...)`` and
``amp.decorate`` against the JAX package's.

- The scalers' state over a sequence of finite-check flags: scale, good
  and bad after every update are the reference's exactly (the same
  float32 products of powers of two and integer counts).
- ``GradScaler``'s eager protocol on a ``Linear(4, 1)`` with SGD, one
  overflowed step among clean ones: the scale exactly, the weights to
  rtol 1e-6 (a product of 8 rows summed in another order).
- ``TrainStep(scaler=DynamicLossScaler(2**15, incr_every_n_steps=2))``
  on a tiny GPT (as ``tests/test_torch_jit.py``), five steps, the third
  poisoned (a batch item of inf multiplies the loss): the scale
  trajectory and the per-step flags exactly; the finite losses to 5e-5
  (as ``tests/test_torch_jit.py``); float32 Momentum's parameters and
  velocities to rtol 1e-5 and an absolute 1e-5 of each one's largest
  entry (gradients agree to 1e-5 of the largest,
  ``tests/test_torch_gpt.py``; Momentum carries them linearly). In the
  port, the poisoned step leaves parameters, masters and optimizer state
  bitwise as they were (float32 Momentum, and bfloat16 AdamW with
  masters, whose losses agree to bfloat16's 3e-2 as
  ``tests/test_torch_gpt.py``'s bfloat16 trajectories).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optim as joptim
from paddle_tpu.models.nlp import gpt as jgpt
from paddle_tpu_torch import amp, convert, nn, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.nlp import gpt

from torch_test_threads import torch_threads  # noqa: F401,E402

CFG = dict(vocab_size=256, hidden=64, layers=2, heads=2, max_seq=32,
           dropout=0.0)
LOSS_TOL = 5e-5
BF16_LOSS_TOL = 3e-2
STATE_TOL = 1e-5

SCALERS = {
    "dynamic": dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2),
    "dynamic_slow": dict(init_loss_scaling=4.0, incr_ratio=3.0,
                         decr_ratio=0.25, incr_every_n_steps=3,
                         decr_every_n_nan_or_inf=2),
    "static": dict(init_loss_scaling=128.0),
}


@pytest.mark.parametrize("kind", sorted(SCALERS))
def test_scaler_state_matches_the_reference(kind):
    cls, jcls = ((amp.StaticLossScaler, jamp.StaticLossScaler)
                 if kind == "static" else
                 (amp.DynamicLossScaler, jamp.DynamicLossScaler))
    ts, js = cls(**SCALERS[kind]), jcls(**SCALERS[kind])
    t, j = ts.state("cpu"), js.state()
    assert sorted(t) == sorted(j)
    flags = np.random.RandomState(3).rand(40) < 0.3
    flags[20:26] = True                  # enough in a row to reach 1.0
    for f in flags:
        t = ts.update_state(t, torch.tensor(bool(f)))
        j = js.update_state(j, jnp.bool_(f))
        assert {k: v.item() for k, v in t.items()} == \
            {k: np.asarray(v).item() for k, v in j.items()}
    assert t["scale"].dtype == torch.float32
    assert all(t[k].dtype == torch.int32 for k in t if k != "scale")


def test_grad_scaler_eager_protocol_matches_the_reference():
    pt.seed(1)
    jl = jnn.Linear(4, 1)
    tl = nn.Linear(4, 1, device="cpu")
    tl.load_state_dict({k: torch.from_numpy(np.array(v._data))
                        for k, v in jl.state_dict().items()})
    jopt = joptim.SGD(0.1, parameters=jl.parameters())
    opt = optim.SGD(0.1, parameters=tl.named_parameters())
    kw = dict(init_loss_scaling=16.0, incr_every_n_steps=2)
    jsc, tsc = jamp.GradScaler(**kw), amp.GradScaler(**kw)
    rng = np.random.RandomState(4)
    for bad in (0.0, 1.0, 0.0, 0.0, 0.0):
        x = rng.randn(8, 4).astype(np.float32)
        y = rng.randn(8, 1).astype(np.float32)
        blow = np.float32(1.0 + bad * 1e38)
        jloss = ((jl(pt.to_tensor(x)) - pt.to_tensor(y)) ** 2).mean()
        jsc.scale(jloss * float(blow)).backward()
        jsc.step(jopt)
        jsc.update()
        jopt.clear_grad()
        tloss = ((tl(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
        tsc.scale(tloss * float(blow)).backward()
        tsc.step(opt)
        tsc.update()
        opt.clear_grad()
        assert tsc.state_dict()["scale"] == jsc.loss_scaling
        for name in ("weight", "bias"):
            np.testing.assert_allclose(
                getattr(tl, name).detach().numpy(),
                np.asarray(getattr(jl, name)._data), rtol=1e-6, atol=1e-7,
                err_msg=name)
    assert tsc.state_dict()["good_steps"] == 1
    tsc.load_state_dict({"scale": 64.0, "good_steps": 1})
    assert tsc.state_dict()["scale"] == 64.0


def _gpt_pair(dtype):
    pt.seed(0)
    jm = jgpt.GPT(jgpt.GPTConfig(**CFG))
    if dtype == "bfloat16":
        jm.bfloat16()
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    m = gpt.GPT(gpt.GPTConfig(**CFG, dtype=dtype), device="cpu")
    m.load_state_dict(convert.gpt_params_from_jax(sd))
    return jm, m


def _poisoned(loss_fn):
    return lambda model, ids, labels, poison: loss_fn(model, ids,
                                                      labels) * poison


def _snapshot(m, opt):
    return ([p.detach().clone() for p in m.parameters()],
            {n: {k: v.clone() for k, v in s.items()}
             for n, s in opt._accumulators.items()})


@pytest.mark.parametrize("recipe", ["momentum-float32",
                                    "adamw-bfloat16-master"])
def test_poisoned_step_is_skipped_as_in_the_reference(recipe):
    bf16 = recipe.endswith("master")
    jm, m = _gpt_pair("bfloat16" if bf16 else "float32")
    if bf16:
        jopt = joptim.AdamW(parameters=jm.parameters(), learning_rate=3e-3,
                            multi_precision=True)
        opt = optim.AdamW(parameters=m.named_parameters(),
                          learning_rate=3e-3, multi_precision=True)
    else:
        jopt = joptim.Momentum(parameters=jm.parameters(),
                               learning_rate=0.1)
        opt = optim.Momentum(parameters=m.named_parameters(),
                             learning_rate=0.1)
    kw = dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2)
    jstep = pt.TrainStep(jm, jopt, _poisoned(jgpt.gpt_loss),
                         scaler=jamp.DynamicLossScaler(**kw))
    step = TrainStep(m, opt, _poisoned(gpt.gpt_loss),
                     scaler=amp.DynamicLossScaler(**kw))
    rng = np.random.RandomState(5)
    want, got = [], []
    for i in range(5):
        ids = rng.randint(0, CFG["vocab_size"], (4, 32)).astype("int32")
        batch = (ids, np.roll(ids, -1, axis=1),
                 np.array(np.inf if i == 2 else 1.0, np.float32))
        before = _snapshot(m, opt)
        jl = float(np.asarray(jstep(*batch)._data))
        tl = float(step(*batch))
        want.append((jl, bool(jstep.last_found_inf),
                     float(np.asarray(jstep._scaler_state["scale"]))))
        got.append((tl, bool(step.last_found_inf),
                    float(step._scaler_state["scale"])))
        if i == 2:
            after = _snapshot(m, opt)
            assert all(torch.equal(a, b) for a, b in zip(before[0],
                                                         after[0]))
            assert all(torch.equal(before[1][n][k], after[1][n][k])
                       for n in after[1] for k in after[1][n])
    assert [g[1:] for g in got] == [w[1:] for w in want]
    assert [g[2] for g in got] == [2.0 ** 15, 2.0 ** 16, 2.0 ** 15,
                                   2.0 ** 15, 2.0 ** 16]
    assert [g[1] for g in got] == [False, False, True, False, False]
    finite = [i for i in range(5) if i != 2]
    np.testing.assert_allclose(
        [got[i][0] for i in finite], [want[i][0] for i in finite],
        atol=BF16_LOSS_TOL if bf16 else LOSS_TOL,
        rtol=0 if bf16 else LOSS_TOL)
    if bf16:
        return
    jparams = dict(jm.named_parameters())
    for n, p in m.named_parameters():
        jp = jparams[n]
        for a, b, what in (
                (p.detach().numpy(), np.asarray(jp._data), "param"),
                (opt._accumulators[n]["velocity"].numpy(),
                 np.asarray(jopt._accumulators[jp.name]["velocity"]),
                 "velocity")):
            np.testing.assert_allclose(a, b, rtol=STATE_TOL,
                                       atol=STATE_TOL * np.abs(b).max(),
                                       err_msg=f"{n} {what}")


def test_scaler_state_carried_from_the_reference():
    jm, m = _gpt_pair("float32")
    opt = optim.SGD(0.1, parameters=m.named_parameters())
    step = TrainStep(m, opt, gpt.gpt_loss,
                     scaler=amp.DynamicLossScaler(incr_every_n_steps=3))
    convert.scaler_state_from_jax(
        {"scale": jnp.float32(512.0), "good": jnp.int32(2),
         "bad": jnp.int32(0)}, step)
    ids = np.random.RandomState(6).randint(0, 256, (4, 32))
    step(ids, np.roll(ids, -1, axis=1))
    assert float(step._scaler_state["scale"]) == 1024.0
    with pytest.raises(ValueError):
        convert.scaler_state_from_jax({"scale": jnp.float32(1.0)}, step)


def test_decorate_o2_matches_the_reference():
    jl = jnn.Linear(8, 8)
    jopt = joptim.Adam(1e-3, parameters=jl.parameters())
    tl = nn.Linear(8, 8, device="cpu")
    opt = optim.Adam(1e-3, parameters=tl.named_parameters())
    w = tl.weight
    tl.weight.grad = torch.ones(8, 8)
    opt.step()
    assert opt._accumulators
    jl2, jopt2 = jamp.decorate(jl, jopt, level="O2", dtype="bfloat16")
    tl2, opt2 = amp.decorate(tl, opt, level="O2", dtype="bfloat16")
    assert tl2 is tl and opt2 is opt and tl.weight is w
    assert str(jl2.weight.dtype) == "bfloat16"
    assert tl.weight.dtype == torch.bfloat16
    assert jopt2._multi_precision and opt._multi_precision
    assert not opt._accumulators          # masters come at the next step
    tl.weight.grad = torch.ones(8, 8, dtype=torch.bfloat16)
    opt.step()
    assert opt._accumulators["weight"]["master"].dtype == torch.float32
    assert amp.decorate([tl], None) == [tl]
    # O1 casts nothing, in both packages (auto_cast does the work)
    jl1 = jnn.Linear(8, 8)
    t1 = nn.Linear(8, 8, device="cpu")
    assert jamp.decorate(jl1, level="O1") is jl1
    assert amp.decorate(t1, level="O1") is t1
    assert str(jl1.weight.dtype) == "float32"
    assert t1.weight.dtype == torch.float32
    with pytest.raises(ValueError):
        amp.decorate(tl, opt, level="O3")
