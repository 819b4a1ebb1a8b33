"""paddle_tpu_torch's guarded training (``resilience.GuardedStep``), its
chaos injectors, ``utils.nan_guard``, the journal's step records with
the MFU/goodput accounting, and ``GracefulShutdown``, against the JAX
package's.

The reference's eager-guard tests (``tests/test_resilience.py:99-212``:
raise; skip = the run that never saw the batch; rollback at unit and
coarse cadence; the first-step fallback; ``notify_skip``; the required
flag; the summary fields), its bounded backoff (``:249``) and injector
tests (``:698-722``), and ``GuardedStep`` counterparts of the
``GuardedExecutor`` retry tests (``:223``, ``:232``), on a ``Linear(4,
1)`` with SGD at 0.1 and a mean-squared loss, batches of 8 from
``RandomState(0)``, the port on the CPU (no graph there). Where a
policy promises equivalence the port is held to itself bitwise; each
policy's stats and losses are held to the JAX ``GuardedStep``'s on the
same weights and batches (losses rtol 1e-6: 8-element float32 sums in
another order).

``TrainStep(check_nan=True)`` raises ``NanInfError`` with the reference's
summary: on the same poisoned batch of a tiny GPT (as
``tests/test_torch_jit.py``) the summary equals the JAX package's.
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optim as joptim
from paddle_tpu import resilience as jres
from paddle_tpu.models.nlp import gpt as jgpt
from paddle_tpu.obs import journal as jjournal
from paddle_tpu.obs import mfu as jmfu
from paddle_tpu.utils import nan_guard as jnan_guard
from paddle_tpu_torch import amp, convert, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.nlp import gpt
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.obs import anomaly, journal, mfu
from paddle_tpu_torch.resilience import (PREEMPTED_EXIT_CODE,
                                         GracefulShutdown, GuardedStep,
                                         RecoveryPolicy, TransientError,
                                         graceful_shutdown, inject,
                                         retry_call)
from paddle_tpu_torch.utils import nan_guard

from torch_test_threads import torch_threads  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOSLEEP = dict(sleep=lambda s: None)
LOSS_RTOL = 1e-6


# -- helpers -----------------------------------------------------------------


def _jax_linear():
    pt.seed(0)
    return jnn.Linear(4, 1)


def _eager_step(lr=0.1, cls=TrainStep, **step_kw):
    """The port's Linear(4, 1) with the JAX one's initial weights, SGD
    and a TrainStep(check_nan=True) (or ``cls``)."""
    jm = _jax_linear()
    m = Linear(4, 1, device="cpu")
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(np.array(jm.weight._data)))
        m.bias.copy_(torch.from_numpy(np.array(jm.bias._data)))
    opt = optim.SGD(learning_rate=lr, parameters=m.named_parameters())
    return m, cls(m, opt, lambda model, x, y: ((model(x) - y) ** 2).mean(),
                  check_nan=True, **step_kw)


def _jax_step(lr=0.1):
    jm = _jax_linear()
    opt = joptim.SGD(learning_rate=lr, parameters=jm.parameters())
    return jm, pt.TrainStep(jm, opt, lambda model, x, y:
                            JF.mse_loss(model(x), y), check_nan=True)


def _batches(steps, batch=8, dim=4):
    rng = np.random.RandomState(0)
    return [(rng.randn(batch, dim).astype(np.float32),
             rng.randn(batch, 1).astype(np.float32)) for _ in range(steps)]


def _weights_after(skip_index=None, steps=6):
    """Un-faulted run, optionally omitting one batch."""
    m, step = _eager_step()
    for i, (x, y) in enumerate(_batches(steps)):
        if i != skip_index:
            step(x, y)
    return m.weight.detach().clone()


def _guarded_losses(guard, steps=6):
    return [None if (loss := guard(x, y)) is None else float(loss)
            for x, y in _batches(steps)]


# -- nonfinite step x each policy (nan_feed) ---------------------------------


def test_policy_raise_aborts():
    _, step = _eager_step()
    guard = GuardedStep(step, RecoveryPolicy(on_nonfinite="raise",
                                             **NOSLEEP))
    data = _batches(4)
    with inject.chaos("nan_feed", at=2, seed=7):
        guard(*data[0])
        with pytest.raises(nan_guard.NanInfError):
            guard(*data[1])


def test_policy_skip_matches_batch_omitted_run():
    m, step = _eager_step()
    guard = GuardedStep(step, RecoveryPolicy(on_nonfinite="skip_step",
                                             **NOSLEEP))
    with inject.chaos("nan_feed", at=3, seed=7):
        for x, y in _batches(6):
            guard(x, y)
    assert guard.stats.skipped == 1 and guard.stats.steps == 5
    assert torch.equal(m.weight, _weights_after(skip_index=2)), \
        "skip_step must be bitwise 'that batch never happened'"
    assert step.optimizer._global_step == 5


def test_policy_rollback_matches_with_unit_cadence():
    m, step = _eager_step()
    guard = GuardedStep(step, RecoveryPolicy(
        on_nonfinite="rollback", snapshot_every=1, **NOSLEEP))
    with inject.chaos("nan_feed", at=3, seed=7):
        for x, y in _batches(6):
            guard(x, y)
    assert guard.stats.rollbacks == 1
    assert torch.equal(m.weight, _weights_after(skip_index=2))


def test_rollback_on_first_step_falls_back_to_prestep_state():
    m, step = _eager_step()
    guard = GuardedStep(step, RecoveryPolicy(
        on_nonfinite="rollback", snapshot_every=3, **NOSLEEP))
    with inject.chaos("nan_feed", at=1, seed=7):
        for x, y in _batches(6):
            guard(x, y)
    assert guard.stats.rollbacks == 1
    assert torch.equal(m.weight, _weights_after(skip_index=0))


def test_policy_rollback_coarse_cadence_loses_to_last_snapshot():
    """snapshot_every=2: the rollback restores the older snapshot — the
    run completes and ends finite."""
    m, step = _eager_step()
    guard = GuardedStep(step, RecoveryPolicy(
        on_nonfinite="rollback", snapshot_every=2, **NOSLEEP))
    with inject.chaos("nan_feed", at=4, seed=7):
        for x, y in _batches(6):
            guard(x, y)
    assert guard.stats.rollbacks == 1
    assert bool(torch.isfinite(m.weight).all())


@pytest.mark.parametrize("policy,cfg", [
    ("skip_step", dict(snapshot_every=1)),
    ("rollback", dict(snapshot_every=1)),
    ("rollback", dict(snapshot_every=2)),
    ("rollback", dict(snapshot_every=3)),
], ids=["skip", "rollback-1", "rollback-2", "rollback-3"])
@pytest.mark.parametrize("at", [1, 3, 4])
def test_policy_matches_the_jax_guard(policy, cfg, at):
    """The same weights, batches and fault: the port's guard keeps the
    JAX guard's stats, skips the same calls and its losses agree."""
    _, step = _eager_step()
    guard = GuardedStep(step, RecoveryPolicy(on_nonfinite=policy, **cfg,
                                             **NOSLEEP))
    _, jstep = _jax_step()
    jguard = jres.GuardedStep(jstep, jres.RecoveryPolicy(
        on_nonfinite=policy, **cfg, **NOSLEEP))
    with inject.chaos("nan_feed", at=at, seed=7):
        got = _guarded_losses(guard)
    with jres.inject.chaos("nan_feed", at=at, seed=7):
        want = [None if (loss := jguard(x, y)) is None
                else float(np.asarray(loss._data)) for x, y in _batches(6)]
    assert guard.stats.as_dict() == jguard.stats.as_dict()
    assert [g is None for g in got] == [w is None for w in want]
    np.testing.assert_allclose([g for g in got if g is not None],
                               [w for w in want if w is not None],
                               rtol=LOSS_RTOL)


def test_guard_keeps_every_tensors_storage():
    """Snapshots and restores copy: parameters and optimizer state keep
    their ``data_ptr`` (a captured step's key), and the guard's own
    buffers are allocated once."""
    m, step = _eager_step()
    opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=0.1)
    step.optimizer = opt
    guard = GuardedStep(step, RecoveryPolicy(
        on_nonfinite="rollback", snapshot_every=1, **NOSLEEP))
    guard(*_batches(1)[0])
    before = [t.data_ptr() for t in guard._state()]
    snaps = (guard._pre, guard._last_good)
    copies = [t.data_ptr() for t in guard._pre.tensors]
    with inject.chaos("nan_feed", at=2, seed=7):
        for x, y in _batches(4):
            guard(x, y)
    assert guard.stats.rollbacks == 1
    assert [t.data_ptr() for t in guard._state()] == before
    assert (guard._pre, guard._last_good) == snaps
    assert [t.data_ptr() for t in guard._pre.tensors] == copies


def test_skipped_step_advances_gradscaler():
    sc = amp.GradScaler(init_loss_scaling=1024.0, decr_ratio=0.5,
                        decr_every_n_nan_or_inf=1)
    _, step = _eager_step()
    guard = GuardedStep(step, RecoveryPolicy(on_nonfinite="skip_step",
                                             **NOSLEEP), scaler=sc)
    with inject.chaos("nan_feed", at=1, seed=7):
        assert guard(*_batches(1)[0]) is None
    assert sc.state_dict()["scale"] == 512.0  # notify_skip shrank it
    assert sc.state_dict()["bad_steps"] == 0  # decr reset after shrink


def test_guard_requires_nonfinite_flag():
    m = Linear(4, 1, device="cpu")
    opt = optim.SGD(learning_rate=0.1, parameters=m.named_parameters())
    step = TrainStep(m, opt, lambda mm, x, y: ((mm(x) - y) ** 2).mean())
    with pytest.raises(ValueError, match="check_nan"):
        GuardedStep(step, RecoveryPolicy(on_nonfinite="skip_step"))


# -- nan_guard ---------------------------------------------------------------


@pytest.mark.parametrize("values", [
    [1.0, np.nan, -np.inf, 4.0],
    [np.inf, 2.0, 3.0],
    [1.0, 2.0],
    [np.nan, np.nan],
])
@pytest.mark.parametrize("kind", ["numpy", "tensor", "bfloat16"])
def test_nan_summary_fields_match_the_reference(values, kind):
    a = np.array(values, np.float32)
    want = jnan_guard.nonfinite_summary(a)
    if kind == "numpy":
        got = nan_guard.nonfinite_summary(a)
    else:
        t = torch.from_numpy(a)
        got = nan_guard.nonfinite_summary(
            t if kind == "tensor" else t.bfloat16())
        want["dtype"] = "float32" if kind == "tensor" else "bfloat16"
    assert got == want


def test_check_numerics_names_the_leaf():
    a = np.array([1.0, np.nan, -np.inf, 4.0], np.float32)
    with pytest.raises(nan_guard.NanInfError) as ei:
        nan_guard.check_numerics({"w": torch.ones(2), "g": [
            torch.from_numpy(a)]}, "grads")
    assert ei.value.summary["num_nan"] == 1
    assert "grads.g[0]" in str(ei.value)
    assert "first_bad_flat_index=1" in str(ei.value)
    assert nan_guard.check_numerics([torch.ones(3), np.arange(3)]) is not None


# -- the repaired TrainStep(check_nan=True) ----------------------------------

GPT_CFG = dict(vocab_size=256, hidden=64, layers=2, heads=2, max_seq=32,
               dropout=0.0)


def _gpt_pair():
    pt.seed(0)
    jm = jgpt.GPT(jgpt.GPTConfig(**GPT_CFG))
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    m = gpt.GPT(gpt.GPTConfig(**GPT_CFG), device="cpu")
    m.load_state_dict(convert.gpt_params_from_jax(sd))
    return jm, m


def _poisoned(loss_fn):
    return lambda model, ids, labels, poison: loss_fn(model, ids,
                                                      labels) * poison


@pytest.mark.parametrize("poison", [np.nan, np.inf])
def test_nan_inf_error_summary_matches_the_jax_package(poison):
    jm, m = _gpt_pair()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (4, 32)).astype("int32")
    batch = (ids, np.roll(ids, -1, axis=1).astype("int32"),
             np.array(poison, np.float32))
    jopt = joptim.AdamW(parameters=jm.parameters(), learning_rate=3e-3)
    jstep = pt.TrainStep(jm, jopt, _poisoned(jgpt.gpt_loss),
                         check_nan=True)
    opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=3e-3)
    step = TrainStep(m, opt, _poisoned(gpt.gpt_loss), check_nan=True)
    with pytest.raises(jnan_guard.NanInfError) as jei:
        jstep(*batch)
    with pytest.raises(nan_guard.NanInfError) as ei:
        step(*batch)
    assert isinstance(ei.value, FloatingPointError)
    assert ei.value.summary == jei.value.summary
    assert ei.value.summary["num_nan" if np.isnan(poison) else "num_inf"] \
        == 1
    assert str(ei.value).split(" (loss=")[0] == \
        str(jei.value).split(" (loss=")[0]


def test_gradient_only_overflow_attaches_no_summary():
    """A finite loss whose gradient is not: ``sqrt`` at 0 has an
    infinite derivative, times 0 is NaN. The error carries no summary,
    as the reference's (a zero-count one would mislead)."""
    m = Linear(4, 1, device="cpu")
    opt = optim.SGD(learning_rate=0.1, parameters=m.named_parameters())
    w = m.weight

    def loss_fn(model, x, y):
        return ((model(x) - y) ** 2).mean() + \
            0.0 * torch.sqrt(w[0, 0] - w[0, 0].detach())

    step = TrainStep(m, opt, loss_fn, check_nan=True)
    with pytest.raises(nan_guard.NanInfError) as ei:
        step(*_batches(1)[0])
    assert ei.value.summary == {}
    assert bool(step.last_found_inf)


def test_fused_window_raises_nan_inf_error():
    _, m = _gpt_pair()
    opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=3e-3)
    step = TrainStep(m, opt, gpt.gpt_loss, check_nan=True)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (4, 32)).astype("int32")
    with torch.no_grad():
        m.blocks[0].fc1.weight[0, 0] = float("nan")
    with pytest.raises(nan_guard.NanInfError, match=r"\[0, 1\] of 2"):
        step.run_fused([(ids, np.roll(ids, -1, axis=1))] * 2)


# -- transient retry ---------------------------------------------------------


def test_transient_execute_retry_matches_clean():
    _, clean_step = _eager_step()
    clean = _guarded_losses(GuardedStep(clean_step, RecoveryPolicy(
        **NOSLEEP)), steps=3)
    m, step = _eager_step()
    guard = GuardedStep(step, RecoveryPolicy(**NOSLEEP))
    with inject.chaos("transient_execute", times=2):
        faulted = _guarded_losses(guard, steps=3)
    assert faulted == clean
    assert guard.stats.retries == 2 and guard.stats.steps == 3


class _LosesItsSecondResult(TrainStep):
    """A step whose second call fails transiently AFTER its update."""

    calls = 0

    def __call__(self, *batch):
        out = super().__call__(*batch)
        self.calls += 1
        if self.calls == 2:
            raise TransientError("lost the result")
        return out


def test_retry_restores_the_pre_step_state():
    """A transient failure after the update was applied is retried from
    the restored pre-step state, not on top of it."""
    _, clean_step = _eager_step()
    clean = _guarded_losses(GuardedStep(clean_step, RecoveryPolicy(
        **NOSLEEP)), steps=3)
    _, step = _eager_step(cls=_LosesItsSecondResult)
    guard = GuardedStep(step, RecoveryPolicy(**NOSLEEP))
    assert _guarded_losses(guard, steps=3) == clean
    assert guard.stats.retries == 1
    assert step.optimizer._global_step == 3


def test_retry_budget_exhaustion_raises():
    _, step = _eager_step()
    guard = GuardedStep(step, RecoveryPolicy(max_retries=1, **NOSLEEP))
    with inject.chaos("transient_execute", times=10):
        with pytest.raises(inject.TransientChaosError):
            guard(*_batches(1)[0])


def test_retry_backoff_is_bounded_and_deterministic():
    pol = RecoveryPolicy(backoff=0.1, backoff_factor=2.0, max_backoff=0.25)
    assert [pol.backoff_for(i) for i in range(4)] == [0.1, 0.2, 0.25, 0.25]
    slept = []
    pol2 = RecoveryPolicy(max_retries=2, backoff=0.1, sleep=slept.append)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TransientError("flap")
        return "ok"

    out, attempts = retry_call(flaky, pol2)
    assert out == "ok" and attempts == 3 and len(slept) == 2


# -- injectors (tests/test_resilience.py:698-722) ----------------------------


def test_env_var_activation():
    pts = inject.install_from_env(
        "transient_execute:times=2; nan_feed:at=3,seed=1,var=x")
    try:
        assert sorted(pts) == ["nan_feed", "transient_execute"]
        assert inject.ACTIVE["transient_execute"].times == 2
        assert inject.ACTIVE["nan_feed"].cfg["var"] == "x"
    finally:
        inject.clear()
    assert not inject.ACTIVE


def test_unknown_point_rejected():
    with pytest.raises(KeyError, match="unknown chaos point"):
        with inject.chaos("nonexistent"):
            pass
    with pytest.raises(KeyError):
        inject.install_from_env("nonexistent:times=1")


@pytest.mark.parametrize("point", ["transient_execute", "ckpt_crash"])
def test_every_injector_is_deterministic_hit_counted(point):
    err = (inject.TransientChaosError if point == "transient_execute"
           else inject.SimulatedCrashError)
    with inject.chaos(point, at=2, times=1) as inj:
        inject.fire(point)  # hit 1: below `at`
        with pytest.raises(err):
            inject.fire(point)  # hit 2: fires
        inject.fire(point)  # hit 3: budget (times=1) spent
        assert inj.hits == 3 and inj.fired == 1


def test_nan_feed_budget_survives_uncorruptible_hits():
    with inject.chaos("nan_feed", var="X_typo", times=1) as inj:
        out = inject.fire("nan_feed", {"x": np.ones(3, np.float32)})
        assert np.isfinite(out["x"]).all() and inj.fired == 0
        inject.fire("nan_feed", {"i": np.arange(3)})  # int-only
        assert inj.fired == 0
    with inject.chaos("nan_feed", times=1) as inj:
        inject.fire("nan_feed", {"i": np.arange(3)})
        assert inj.fired == 0
        out = inject.fire("nan_feed", {"x": np.ones(3, np.float32)})
        assert inj.fired == 1 and np.isnan(out["x"]).sum() == 1


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_nan_feed_corrupts_a_copy_as_the_reference(kind):
    """The same (at, seed) poisons the same element as the JAX
    injector, in a copy; the caller's batch is never touched."""
    x, y = _batches(1)[0]
    batch = [x, y] if kind == "numpy" else [torch.from_numpy(x.copy()),
                                            torch.from_numpy(y.copy())]
    with inject.chaos("nan_feed", seed=11, kind="inf") as inj:
        out = inject.fire("nan_feed", list(batch))
    with jres.inject.chaos("nan_feed", seed=11, kind="inf"):
        want = jres.inject.fire("nan_feed", [x, y])
    assert inj.fired == 1
    np.testing.assert_array_equal(np.asarray(out[0]), want[0])
    assert np.isfinite(np.asarray(batch[0])).all()
    assert out[1] is batch[1]


def test_disabled_chaos_leaves_hot_path_alone(monkeypatch):
    """With nothing active the guard's hooks are one empty-dict test:
    ``inject.fire`` is never called."""
    assert not inject.ACTIVE

    def boom(*a, **k):
        raise AssertionError("fire() called with chaos inactive")

    monkeypatch.setattr(inject, "fire", boom)
    _, step = _eager_step()
    guard = GuardedStep(step, RecoveryPolicy(on_nonfinite="skip_step",
                                             **NOSLEEP))
    assert guard(*_batches(1)[0]) is not None


# -- the journal's step records and the accounting ---------------------------


_CALLS = [
    dict(loss=2.5, step_ms=10.0, examples=8, flops=1e9),
    dict(loss=2.25, step_ms=12.0, examples=8, flops=1e9,
         fetches=[np.float32(2.25), np.zeros((3, 2), np.float32)]),
    dict(loss=None, step_ms=11.0, skipped=True, nonfinite=True,
         source="guarded_step"),
    dict(loss=float("nan"), step_ms=9.0),
    dict(loss=2.0, examples=4),
    dict(loss=1.75, step_ms=10.5, steps_fused=4),
]


def _records(mod, run_dir, peak):
    j = mod.RunJournal(run_dir, peak=peak, detectors=[])
    j.start()
    recs = []
    for i, kw in enumerate(_CALLS):
        if i == 4:
            j.note_step_ms(7.5)
        j.event("resilience.retry", attempt=1) if i == 1 else None
        recs.append(dict(j.record_step(**kw)))
    out = j.summary()
    j.close()
    return recs, out


def test_record_step_matches_the_jax_journal(tmp_path):
    got, gsum = _records(journal, str(tmp_path / "t"), 1e12)
    want, wsum = _records(jjournal, str(tmp_path / "j"), 1e12)
    for g, w in zip(got, want):
        g.pop("ts"), w.pop("ts")
        for k in ("jit_cache", "queue_depth", "dl_wait_ms"):
            w.pop(k, None)      # the JAX executor's and data loader's
        assert g == w
    for k in ("productive_steps", "skipped_steps", "retries", "goodput",
              "mean_step_ms", "achieved_flops_per_s", "peak_flops_per_s",
              "mfu", "examples_per_s", "steps", "optimizer_steps"):
        assert gsum[k] == wsum[k], k
    assert gsum["goodput"] == 7 / 10


def test_mfu_accounting_matches_the_reference():
    got, want = mfu.MFUAccounting(peak=2e12), jmfu.MFUAccounting(peak=2e12)
    for acc in (got, want):
        acc.record(step_ms=10.0, flops=5e9, examples=16)
        acc.record(step_ms=20.0, examples=16, productive=False)
        acc.record(step_ms=5.0, flops=1e9, weight=4)
        acc.note_retry(2)
    wsum = want.summary()
    assert got.summary() == {k: wsum[k] for k in got.summary()}
    assert mfu.goodput(3, 1, 1) == jmfu.goodput(3, 1, 1) == 0.6
    assert mfu.goodput(0) is None


def test_peak_flops_override_env_and_host(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS", raising=False)
    assert mfu.peak_flops() is None    # the CPU: nothing known
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "5e14")
    assert mfu.peak_flops() == 5e14
    mfu.set_peak_flops(1e15)
    try:
        assert mfu.peak_flops() == 1e15
    finally:
        mfu.set_peak_flops(None)
    assert mfu.PEAK_FLOPS_BY_KIND["H100"] == 989e12


def test_guarded_step_journals_its_steps(tmp_path):
    _, step = _eager_step()
    guard = GuardedStep(step, RecoveryPolicy(on_nonfinite="skip_step",
                                             **NOSLEEP))
    with journal.RunJournal(str(tmp_path), detectors=[]) as j:
        with inject.chaos("nan_feed", at=2, seed=7):
            for x, y in _batches(4):
                guard(x, y)
        recs = list(j._last_steps)
        summary = j.summary()
    assert [r.get("skipped", False) for r in recs] == [False, True, False,
                                                       False]
    assert all(r["source"] == "guarded_step" for r in recs)
    assert recs[1]["nonfinite"] and recs[1]["loss"] is None
    assert summary["goodput"] == 0.75 and summary["skipped_steps"] == 1


def test_step_detectors_fire_on_step_records(tmp_path):
    """The step detectors see the journal's step records and fire as the
    JAX journal's do on the same stream."""
    from paddle_tpu.obs import anomaly as janomaly

    losses = [3.0, 2.9, float("nan"), float("nan"), float("nan"), 2.8,
              2.7] + [2.7] * 8 + [40.0]
    fired = []
    for mod, anom, d in ((journal, anomaly, "t"), (jjournal, janomaly,
                                                   "j")):
        with mod.RunJournal(str(tmp_path / d), detectors=[
                anom.NonfiniteStreak(threshold=2),
                anom.LossSpike(window=8, factor=4.0, min_steps=3)]) as j:
            for i, loss in enumerate(losses):
                j.record_step(loss=loss, step_ms=1.0)
            fired.append(list(j.anomalies.fired))
    assert fired[0] == fired[1]
    assert [f["name"] for f in fired[0]] == ["nonfinite_streak",
                                             "loss_spike"]


# -- preemption --------------------------------------------------------------


def test_graceful_shutdown_catches_sigterm_and_restores():
    prev = signal.getsignal(signal.SIGTERM)
    with GracefulShutdown(signals=(signal.SIGTERM,)) as sh:
        assert not sh.requested
        os.kill(os.getpid(), signal.SIGTERM)  # the preemption notice
        assert sh.requested and sh.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is prev
    with pytest.raises(SystemExit) as ei:
        sh.exit_preempted()
    assert ei.value.code == PREEMPTED_EXIT_CODE == 75


def test_graceful_shutdown_installs_sigterm_and_sigint():
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                             signal.SIGINT)}
    sh = graceful_shutdown()
    try:
        os.kill(os.getpid(), signal.SIGINT)
        assert sh.requested and sh.signum == signal.SIGINT
    finally:
        sh.uninstall()
    assert {s: signal.getsignal(s) for s in prev} == prev


# -- the chaos tool ----------------------------------------------------------


def test_torch_chaos_run_self_test():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_chaos_run.py"),
         "--self-test", "--device", "cpu"], capture_output=True, text=True,
        timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "self-test passed" in out.stdout
    for name in ("nan_feed", "transient_execute", "ckpt_truncate",
                 "ckpt_bitflip", "ckpt_crash", "ckpt_slow",
                 "replica_kill"):
        assert f"{name}" in out.stdout
