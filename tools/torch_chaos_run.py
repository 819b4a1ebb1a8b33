#!/usr/bin/env python3
"""torch_chaos_run: run a small training loop of ``paddle_tpu_torch``
under a named fault and report whether the resilience layer recovered
it — the port's counterpart of ``tools/chaos_run.py``.

Every registered injector in ``paddle_tpu_torch.resilience.inject`` has
a scenario here that (1) activates the fault, (2) runs a real guarded
train loop, checkpoint cycle or serve fleet through the port, and (3)
asserts the run COMPLETED and the recovery the policy promises happened:

- ``nan_feed``: a NaN batch at step 3 under ``GuardedStep``; the run
  equals, bitwise, one that never saw that batch (``--policy``);
- ``transient_execute``: two step invocations fail transiently; bounded
  retry heals them and the losses equal a clean run's bitwise;
- ``ckpt_truncate`` / ``ckpt_bitflip``: the newest checkpoint is
  corrupted on disk; ``load_checkpoint`` falls back to the intact one;
- ``ckpt_crash``: a save dies before its publish; the stale orphan is
  cleaned and the previous checkpoint loads;
- ``ckpt_slow``: a stalled async writer stays off the step path and
  publishes on completion;
- ``replica_kill``: a serve replica process dies mid-decode behind the
  fleet router; its requests requeue and finish oracle-identical
  (``serving.fleet.drill``, two worker processes).

Usage:
    python3 tools/torch_chaos_run.py nan_feed [--policy rollback]
    python3 tools/torch_chaos_run.py --list
    python3 tools/torch_chaos_run.py --self-test [--device cpu]

The loops run on the CUDA card unless ``--device cpu`` is given; without
a card they raise. ``--self-test`` also fails if an injector is
registered WITHOUT a scenario.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
import warnings

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), ".."))

SCENARIOS = {}


def scenario(name):
    def deco(fn):
        SCENARIOS[name] = fn
        return fn
    return deco


def _linear(device, seed=0, i=4, o=1):
    import torch

    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.nn import Linear

    dev = resolve_device(device)
    return Linear(i, o, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(seed))


def _loss_fn(model, x, y):
    return ((model(x) - y) ** 2).mean()


def _eager_parts(device, lr=0.1):
    from paddle_tpu_torch import optim
    from paddle_tpu_torch.framework import TrainStep

    m = _linear(device)
    opt = optim.SGD(learning_rate=lr, parameters=m.named_parameters())
    return m, TrainStep(m, opt, _loss_fn, check_nan=True)


def _batches(steps, batch=8, dim=4):
    rng = np.random.RandomState(0)
    return [(rng.randn(batch, dim).astype(np.float32),
             rng.randn(batch, 1).astype(np.float32)) for _ in range(steps)]


def _guarded_run(device, policy_name, steps=6, chaos_point=None,
                 chaos_cfg=None):
    """Train under GuardedStep; returns (final weight, losses, stats)."""
    from paddle_tpu_torch.resilience import (GuardedStep, RecoveryPolicy,
                                             inject)

    m, step = _eager_parts(device)
    guard = GuardedStep(step, RecoveryPolicy(
        on_nonfinite=policy_name, sleep=lambda s: None))
    losses = []

    def drive():
        for x, y in _batches(steps):
            loss = guard(x, y)
            losses.append(None if loss is None else float(loss))

    if chaos_point is None:
        drive()
    else:
        with inject.chaos(chaos_point, **(chaos_cfg or {})):
            drive()
    return m.weight.detach().clone(), losses, guard.stats


@scenario("nan_feed")
def run_nan_feed(device, policy="skip_step", steps=6):
    """NaN batch at step 3; the guarded run completes and matches an
    un-faulted run that never saw that batch."""
    import torch

    from paddle_tpu_torch.utils.nan_guard import NanInfError

    if policy == "raise":
        try:
            _guarded_run(device, policy, steps, "nan_feed",
                         {"at": 3, "seed": 7})
        except NanInfError as e:
            return f"aborted as requested by policy 'raise': {e}"
        raise AssertionError("policy 'raise' did not abort on the NaN step")
    w_f, _, stats = _guarded_run(device, policy, steps, "nan_feed",
                                 {"at": 3, "seed": 7})
    assert stats.nonfinite == 1 and stats.steps == steps - 1, stats
    m, step = _eager_parts(device)
    for i, (x, y) in enumerate(_batches(steps)):
        if i != 2:  # the batch chaos poisoned (at=3 => 3rd step)
            step(x, y)
    assert torch.equal(w_f, m.weight), \
        "skip_step must be bitwise 'that batch never happened'"
    return f"recovered: {stats}"


@scenario("transient_execute")
def run_transient_execute(device):
    """The first two step invocations die transiently; bounded retry
    heals them and the losses match an un-faulted run bitwise."""
    _, clean, _ = _guarded_run(device, "raise", steps=3)
    _, faulted, stats = _guarded_run(device, "raise", steps=3,
                                     chaos_point="transient_execute",
                                     chaos_cfg={"times": 2})
    assert faulted == clean, (faulted, clean)
    assert stats.retries == 2, stats
    return f"recovered after {stats.retries} retries; losses identical"


def _ckpt_cycle(device, tmpdir, chaos_point=None, chaos_cfg=None):
    import torch

    from paddle_tpu_torch import optim
    from paddle_tpu_torch.framework import load_checkpoint, save_checkpoint
    from paddle_tpu_torch.resilience import SimulatedCrashError, inject

    m = _linear(device, o=2)
    opt = optim.SGD(learning_rate=0.1, parameters=m.named_parameters())
    save_checkpoint(tmpdir, 1, model=m, optimizer=opt)
    w1 = m.weight.detach().clone()
    with torch.no_grad():
        m.weight += 1.0  # "train", then checkpoint again
    if chaos_point is None:
        save_checkpoint(tmpdir, 2, model=m, optimizer=opt)
    else:
        with inject.chaos(chaos_point, **(chaos_cfg or {})):
            try:
                save_checkpoint(tmpdir, 2, model=m, optimizer=opt)
            except SimulatedCrashError:
                pass  # the 'process died' mid-save
    m2 = _linear(device, seed=1, o=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        step = load_checkpoint(tmpdir, model=m2)
    return step, torch.equal(w1, m2.weight)


@scenario("ckpt_truncate")
def run_ckpt_truncate(device):
    """Newest checkpoint truncated on disk; the loader falls back to the
    intact previous one with bit-identical parameters."""
    with tempfile.TemporaryDirectory() as d:
        step, same = _ckpt_cycle(device, d, "ckpt_truncate")
    assert step == 1 and same, step
    return "fell back to intact step-1 checkpoint"


@scenario("ckpt_bitflip")
def run_ckpt_bitflip(device):
    """One bit of the newest checkpoint flips on disk; the manifest
    checksum catches it and the loader falls back to the intact one."""
    with tempfile.TemporaryDirectory() as d:
        step, same = _ckpt_cycle(device, d, "ckpt_bitflip", {"seed": 5})
    assert step == 1 and same, step
    return "checksum caught the flipped bit; fell back to step 1"


@scenario("ckpt_crash")
def run_ckpt_crash(device):
    """Save crashes before publish; once the orphan tmp dir goes stale
    it is cleaned, and the previous checkpoint loads."""
    from paddle_tpu_torch.framework import load_checkpoint

    with tempfile.TemporaryDirectory() as d:
        step, same = _ckpt_cycle(device, d, "ckpt_crash")
        # backdate the orphan past the concurrent-saver grace period
        t = time.time() - 3600
        for f in os.listdir(d):
            if f.startswith(".tmp_ckpt_"):
                p = os.path.join(d, f)
                for sub in [p] + [os.path.join(p, s) for s in os.listdir(p)]:
                    os.utime(sub, (t, t))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            step2 = load_checkpoint(d, model=_linear(device, seed=2, o=2))
        leftovers = [f for f in os.listdir(d) if f.startswith(".tmp_ckpt_")]
    assert step == 1 and same, step
    assert step2 == 1 and not leftovers, (step2, leftovers)
    return "stale orphan tmp cleaned; resumed from step 1"


@scenario("ckpt_slow")
def run_ckpt_slow(device):
    """The checkpoint writer stalls pre-publish; under ``async_=True``
    the stall runs on the writer thread so the step path never blocks,
    and ``ckpt_<step>`` only appears once the writer COMPLETED."""
    import torch

    from paddle_tpu_torch.framework import load_checkpoint, save_checkpoint
    from paddle_tpu_torch.resilience import inject

    m = _linear(device, o=2)
    with tempfile.TemporaryDirectory() as d:
        with inject.chaos("ckpt_slow", seconds=0.5):
            t0 = time.perf_counter()
            h = save_checkpoint(d, 1, model=m, async_=True)
            step_path_s = time.perf_counter() - t0
            published_early = os.path.exists(os.path.join(d, "ckpt_1"))
            path = h.result(timeout=30.0)
        assert step_path_s < 0.25, \
            f"async save held the step path {step_path_s:.3f}s"
        assert not published_early, "published before the writer finished"
        assert os.path.isdir(path), path
        m2 = _linear(device, seed=1, o=2)
        assert load_checkpoint(d, model=m2) == 1
        assert torch.equal(m.weight, m2.weight)
    return ("0.5s writer stall stayed off the step path "
            f"({step_path_s * 1e3:.1f} ms); publish-on-complete")


@scenario("replica_kill")
def run_replica_kill(device):
    """A serve replica hard-dies (``os._exit``) mid-decode behind the
    fleet router: its in-flight requests requeue in arrival order and
    finish token-for-token identical to the single-engine oracle, and
    the replica is relaunched (``serving.fleet.drill``, cached per
    process)."""
    from paddle_tpu_torch.serving.fleet import drill

    res = drill.drill_result(device=device)
    assert not res["failures"], res["failures"]
    st = res["stats"]
    assert st["requeued"] >= 1 and st["completed"] == len(
        res["requests"]), st
    return (f"replica kill mid-decode: {st['requeued']} requests "
            f"requeued in arrival order, all {st['completed']} finished "
            f"oracle-identical; relaunched ready in "
            f"{res['relaunch_ready_s']:.1f} s")


def self_test(device):
    from paddle_tpu_torch.resilience import INJECTORS

    missing = sorted(set(INJECTORS) - set(SCENARIOS))
    if missing:
        print(f"self-test FAILED: injectors with no recovery scenario: "
              f"{missing}")
        return 1
    failures = []
    for name in sorted(SCENARIOS):
        try:
            msg = SCENARIOS[name](device)
            print(f"  {name:20s} ok — {msg}")
        except Exception as e:
            print(f"  {name:20s} FAILED — {type(e).__name__}: {e}")
            failures.append(name)
    if failures:
        print(f"self-test FAILED: {failures}")
        return 1
    print("self-test passed: every registered injector's fault class ends "
          "in a completed, verified-correct run")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fault", nargs="?", help="scenario / injector name")
    ap.add_argument("--policy", default="skip_step",
                    choices=["raise", "skip_step", "rollback"],
                    help="nonfinite policy for the nan_feed scenario")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (default)")
    ap.add_argument("--list", action="store_true", help="list scenarios")
    ap.add_argument("--self-test", action="store_true",
                    help="run every registered injector's scenario")
    args = ap.parse_args(argv)
    if args.list:
        for name in sorted(SCENARIOS):
            doc = (SCENARIOS[name].__doc__ or "").strip().splitlines()
            print(f"{name:20s} {doc[0] if doc else ''}")
        return 0
    if args.self_test:
        return self_test(args.device)
    if not args.fault:
        ap.error("a fault name is required (or --list / --self-test)")
    if args.fault not in SCENARIOS:
        ap.error(f"unknown fault {args.fault!r}; --list shows scenarios")
    if args.fault == "nan_feed":
        msg = SCENARIOS[args.fault](args.device, policy=args.policy,
                                    steps=args.steps)
    else:
        msg = SCENARIOS[args.fault](args.device)
    print(f"{args.fault}: {msg}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
