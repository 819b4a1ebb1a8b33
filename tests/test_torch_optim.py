"""paddle_tpu_torch's schedulers, optimizers and clips against the JAX
package's.

- Schedulers: every ``optim.lr`` scheduler's learning rate over 60
  ``step()`` calls (``ReduceOnPlateau`` fed one metric sequence) equals
  the JAX one's exactly: both are the same host arithmetic.
- Optimizers: one and eight updates of a (64, 48) parameter from the
  same gradients, float32 and bfloat16 with ``multi_precision``, the
  learning rate a float32 scalar as the reference's ``TrainStep`` passes
  it (``jit.py:422``). Every rule but Lamb is elementwise, so the
  parameter, the master and every state value are the reference's bits.
  Lamb's trust ratio divides two norms, sums that the two take in
  another order, so its parameter and master agree to rtol 1e-6 and an
  absolute LR * 2^-21, four float32 steps of an update of size LR (seen:
  3.5e-10 at most, on entries near zero; the trust ratio itself within
  one step); its moments, which the ratio does not touch, are the
  reference's bits.
- bfloat16 with ``multi_precision``: the reference makes the state with
  ``_init_state`` of the bfloat16 parameter (``zeros_like(p)``: bfloat16
  zeros, an Adagrad accumulator rounded to bfloat16) and it turns
  float32 at the first update; the port keeps it in float32 from the
  start, with the same values. The two differ in one place: the
  reference's first Adadelta update adds ``epsilon`` to its bfloat16
  zero in bfloat16, so with bfloat16(1e-6) (ROADMAP Queue 3). The
  reference's run here starts from its ``_init_state`` cast to float32,
  as the port's state is.
- Clips: ``ClipGradByValue`` is a clamp, exact; ``ClipGradByNorm``
  scales by a norm (a sum), rtol 1e-6, as ``ClipGradByGlobalNorm``.
- ``convert.optimizer_state_from_jax``: after two JAX updates the port's
  optimizer takes the JAX state, and a third update on both sides gives
  the same bits.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu import optim as joptim
from paddle_tpu.optim import lr as jlr
from paddle_tpu_torch import convert, optim
from paddle_tpu_torch.optim import lr as tlr

LR = 1e-2
F32_STEP = 2 ** -23
LAMB_RTOL = 1e-6
LAMB_ATOL = LR * 2 ** -21
NORM_RTOL = 1e-6


# -- schedulers ----------------------------------------------------------------

SCHEDULERS = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                  learning_rate=0.5),
    "exponential": lambda m: m.ExponentialDecay(0.1, gamma=0.93),
    "natural_exp": lambda m: m.NaturalExpDecay(0.1, gamma=0.05),
    "inverse_time": lambda m: m.InverseTimeDecay(0.1, gamma=0.3),
    "polynomial": lambda m: m.PolynomialDecay(0.1, decay_steps=25,
                                              end_lr=1e-3, power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=13, end_lr=1e-3, power=1.5, cycle=True),
    "piecewise": lambda m: m.PiecewiseDecay([5, 17, 40], [0.1, 0.05, 0.01,
                                                          0.002]),
    "cosine": lambda m: m.CosineAnnealingDecay(0.1, T_max=23, eta_min=1e-4),
    "warmup_float": lambda m: m.LinearWarmup(0.1, warmup_steps=7,
                                             start_lr=0.0, end_lr=0.1),
    "warmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=30), warmup_steps=9,
        start_lr=1e-3, end_lr=0.1),
    "step": lambda m: m.StepDecay(0.1, step_size=7, gamma=0.6),
    "multistep": lambda m: m.MultiStepDecay(0.1, [3, 11, 29], gamma=0.3),
    "lambda": lambda m: m.LambdaDecay(0.1, lambda e: 0.97 ** e + 1 / (e + 1)),
    "multiplicative": lambda m: m.MultiplicativeDecay(
        0.1, lambda e: 0.9 + 0.001 * e),
    "one_cycle_cos": lambda m: m.OneCycleLR(0.1, total_steps=50),
    "one_cycle_linear_3": lambda m: m.OneCycleLR(
        0.1, total_steps=40, anneal_strategy="linear", three_phase=True),
    "cyclic": lambda m: m.CyclicLR(1e-3, 0.1, step_size_up=7,
                                   step_size_down=4),
    "cyclic_triangular2": lambda m: m.CyclicLR(1e-3, 0.1, step_size_up=5,
                                               mode="triangular2"),
    "cyclic_exp_range": lambda m: m.CyclicLR(1e-3, 0.1, step_size_up=6,
                                             mode="exp_range",
                                             exp_gamma=0.98),
    "cyclic_scale_fn": lambda m: m.CyclicLR(
        1e-3, 0.1, step_size_up=6, scale_fn=lambda x: 1 / (1 + x),
        scale_mode="iterations"),
}


@pytest.mark.parametrize("kind", sorted(SCHEDULERS))
def test_scheduler_matches_the_reference(kind):
    want, got = SCHEDULERS[kind](jlr), SCHEDULERS[kind](tlr)
    seq_want, seq_got = [want()], [got()]
    for _ in range(60):
        want.step()
        got.step()
        seq_want.append(want())
        seq_got.append(got())
    assert seq_got == seq_want
    assert got.state_dict() == want.state_dict()


@pytest.mark.parametrize("mode, threshold_mode", [("min", "rel"),
                                                  ("max", "abs")])
def test_reduce_on_plateau_matches_the_reference(mode, threshold_mode):
    rng = np.random.RandomState(2)
    metrics = np.concatenate([np.linspace(1.0, 0.5, 15),
                              0.5 + 0.01 * rng.rand(30),
                              np.linspace(0.5, 0.2, 15)])
    if mode == "max":
        metrics = -metrics
    kw = dict(mode=mode, factor=0.5, patience=3, threshold=1e-3,
              threshold_mode=threshold_mode, cooldown=2, min_lr=1e-3)
    want = jlr.ReduceOnPlateau(0.1, **kw)
    got = tlr.ReduceOnPlateau(0.1, **kw)
    seq_want, seq_got = [], []
    for x in metrics:
        want.step(float(x))
        got.step(torch.tensor(float(x)))
        seq_want.append(want())
        seq_got.append(got())
    assert seq_got == seq_want
    assert len(set(seq_got)) > 2          # it reduced more than once


def test_optimizer_takes_a_scheduler():
    sched = tlr.StepDecay(0.1, step_size=2, gamma=0.5)
    p = torch.nn.Parameter(torch.ones(3))
    opt = optim.SGD(sched, parameters=[p])
    assert opt.get_lr() == 0.1
    sched.step()
    sched.step()
    assert opt.get_lr() == 0.05
    with pytest.raises(RuntimeError):
        opt.set_lr(0.2)
    plain = optim.SGD(0.1, parameters=[p])
    plain.set_lr(0.2)
    assert plain.get_lr() == 0.2
    with pytest.raises(TypeError):
        optim.SGD("0.1", parameters=[p])
    # the update reads float32(get_lr()) from its tensor
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(p.detach(), torch.full((3,), 1 - np.float32(0.05)))


# -- optimizers ----------------------------------------------------------------

OPTIMIZERS = {
    # name: (JAX class, port class, keyword arguments), LR everywhere
    "sgd": (joptim.SGD, optim.SGD, {}),
    "momentum": (joptim.Momentum, optim.Momentum, {"momentum": 0.9}),
    "nesterov": (joptim.Momentum, optim.Momentum,
                 {"momentum": 0.8, "use_nesterov": True}),
    "adagrad": (joptim.Adagrad, optim.Adagrad,
                {"initial_accumulator_value": 0.1}),
    "adadelta": (joptim.Adadelta, optim.Adadelta, {"rho": 0.9}),
    "rmsprop": (joptim.RMSProp, optim.RMSProp, {"momentum": 0.5}),
    "rmsprop_centered": (joptim.RMSProp, optim.RMSProp,
                         {"centered": True, "rho": 0.9}),
    "adamax": (joptim.Adamax, optim.Adamax, {}),
    "lamb": (joptim.Lamb, optim.Lamb, {"lamb_weight_decay": 0.02}),
}


def _reference_run(jcls, kw, p0, gs, dtype):
    """The reference's ``Optimizer.step`` on one parameter (with a master
    under ``multi_precision``, ``optimizer.py:108-124``), the lr a float32
    scalar: the parameter, the master (or None) and the state."""
    jopt = jcls(learning_rate=LR, parameters=[], **kw)
    jp = jnp.asarray(p0).astype(dtype)
    js = jopt._init_state(jp)
    master = None
    if dtype == jnp.bfloat16:
        master = jp.astype(jnp.float32)
        js = {k: v.astype(jnp.float32) for k, v in js.items()}
    for g in gs:
        jg = jnp.asarray(g).astype(dtype)
        if master is None:
            jp, js = jopt._update(jp, jg, js, jnp.float32(LR))
        else:
            master, js = jopt._update(master, jg.astype(jnp.float32), js,
                                      jnp.float32(LR))
            jp = master.astype(jnp.bfloat16)
    return jp, master, js


@pytest.mark.parametrize("steps", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16-master"])
@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_optimizer_matches_the_reference(kind, dtype, steps):
    jcls, tcls, kw = OPTIMIZERS[kind]
    rng = np.random.RandomState(11)
    p0 = (rng.randn(64, 48) * 0.05).astype(np.float32)
    gs = [(rng.randn(64, 48) * 0.1).astype(np.float32) for _ in range(steps)]
    bf16 = dtype != "float32"
    jp, jmaster, js = _reference_run(jcls, kw, p0, gs,
                                     jnp.bfloat16 if bf16 else jnp.float32)
    tdtype = torch.bfloat16 if bf16 else torch.float32
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()).to(tdtype))
    opt = tcls(learning_rate=LR, parameters=[("w", p)],
               multi_precision=bf16, **kw)
    for g in gs:
        p.grad = torch.from_numpy(g.copy()).to(tdtype)
        opt.step()
    s = opt._accumulators["w"]
    assert p.dtype == tdtype
    want = {k: np.asarray(v).astype(np.float32) for k, v in js.items()}
    got = {k: v.float().numpy() for k, v in s.items() if k != "master"}
    assert sorted(got) == sorted(want)
    pairs = [("param", p.detach().float().numpy(),
              np.asarray(jp).astype(np.float32))] + [
        (k, got[k], want[k]) for k in sorted(want)]
    if bf16:
        assert s["master"].dtype == torch.float32
        pairs.append(("master", s["master"].numpy(), np.asarray(jmaster)))
    for name, a, b in pairs:
        if kind == "lamb" and name in ("param", "master"):
            np.testing.assert_allclose(a, b, rtol=LAMB_RTOL, atol=LAMB_ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kind", ["momentum", "adagrad", "adamax"])
def test_state_carried_from_the_reference_continues_bitwise(kind):
    """Two reference updates, then its state into the port's optimizer
    (``convert.optimizer_state_from_jax``): the third update agrees."""
    import paddle_tpu as pt
    from paddle_tpu.core.tensor import Parameter

    jcls, tcls, kw = OPTIMIZERS[kind]
    rng = np.random.RandomState(12)
    p0 = (rng.randn(16, 8) * 0.05).astype(np.float32)
    gs = [(rng.randn(16, 8) * 0.1).astype(np.float32) for _ in range(3)]
    jparam = Parameter(jnp.asarray(p0), name="w_jax")
    jopt = jcls(learning_rate=LR, parameters=[jparam], **kw)
    for g in gs[:2]:
        jparam.grad = pt.to_tensor(g)
        jopt.step()
    p = torch.nn.Parameter(torch.from_numpy(np.array(jparam._data)))
    opt = tcls(learning_rate=LR, parameters=[("w", p)], **kw)
    convert.optimizer_state_from_jax(jopt, opt)
    assert opt._global_step == 2
    p.grad = torch.from_numpy(gs[2].copy())
    opt.step()
    jparam.grad = pt.to_tensor(gs[2])
    jopt.step()
    np.testing.assert_array_equal(p.detach().numpy(),
                                  np.asarray(jparam._data))
    for k, v in jopt._accumulators[jparam.name].items():
        np.testing.assert_array_equal(opt._accumulators["w"][k].numpy(),
                                      np.asarray(v), err_msg=k)
    bad = tcls(learning_rate=LR, parameters=[("w", torch.nn.Parameter(
        torch.zeros(8, 16)))], **kw)
    with pytest.raises(ValueError):
        convert.optimizer_state_from_jax(jopt, bad)


# -- clips ---------------------------------------------------------------------


@pytest.mark.parametrize("clip", ["value", "value_min", "norm",
                                  "norm_small"])
def test_clip_matches_the_reference(clip):
    jclip, tclip = {
        "value": (joptim.ClipGradByValue(0.05),
                  optim.ClipGradByValue(0.05)),
        "value_min": (joptim.ClipGradByValue(0.05, min=-0.01),
                      optim.ClipGradByValue(0.05, min=-0.01)),
        "norm": (joptim.ClipGradByNorm(0.5), optim.ClipGradByNorm(0.5)),
        "norm_small": (joptim.ClipGradByNorm(100.0),
                       optim.ClipGradByNorm(100.0)),
    }[clip]
    rng = np.random.RandomState(13)
    gs = [(rng.randn(*s) * 0.1).astype(np.float32)
          for s in ((40, 5), (7,), (3, 3))]
    want = jclip._apply([(None, jnp.asarray(g)) for g in gs])
    got = tclip([(None, torch.from_numpy(g)) for g in gs])
    for (_, a), (_, b) in zip(got, want):
        if clip.startswith("value"):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=NORM_RTOL)
    # a parameter with need_clip = False keeps its gradient
    p = torch.nn.Parameter(torch.zeros(3))
    p.need_clip = False
    g = torch.full((3,), 50.0)
    assert tclip([(p, g)])[0][1] is g


def test_lamb_trust_ratio_is_one_for_a_zero_parameter():
    p = torch.nn.Parameter(torch.zeros(4, 4))
    opt = optim.Lamb(learning_rate=0.1, parameters=[p])
    p.grad = torch.ones(4, 4)
    opt.step()
    # a zero parameter's norm is 0, so the trust ratio is 1 and the step
    # is lr times the first Adam ratio, 1 to within float32's bias
    # corrections of beta2 = 0.999 (~1e-5)
    assert math.isclose(float(p.detach()[0, 0]), -0.1, rel_tol=1e-4)
    assert torch.equal(p.detach(), p.detach()[0, 0].expand(4, 4))
