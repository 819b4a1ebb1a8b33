"""Guards: turn a detected fault into a recovered run.

The port of ``paddle_tpu/resilience/guard.py``'s ``GuardStats`` and
``GuardedStep`` (:44-240). ``GuardedStep`` wraps a ``TrainStep``
(``framework/jit.py``). Detection is the step's on-device nonfinite flag
(``TrainStep(check_nan=True)`` raises ``NanInfError`` after the step; no
extra host sync is added). The policy then decides: re-raise, skip the
step (restore the pre-step snapshot — the step contributes nothing,
bitwise identical to a run that never saw that batch for RNG-free
models), or roll back to the last-good snapshot. Transient errors are
retried through ``policy.retry_call``, each retry restoring the
pre-step state first.

Snapshots live on the device, in buffers allocated once and refreshed
by copying into them; a restore copies them back. Parameters,
buffers, optimizer state and the loss scaler's state therefore keep
their storage, which the step's CUDA graph reads (its key holds every
``data_ptr``), so a guarded step goes on replaying one graph. A
snapshot covers every trainable parameter, every buffer, every
optimizer state value of those parameters (made first where it is
missing), the in-step scaler's state and ``_global_step``. For eager AMP
pass the ``amp.GradScaler`` so ``notify_skip()`` advances its dynamic
scale.

Not ported: ``GuardedExecutor``, which wraps the static ``Executor``
(``static_``, ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import time

import torch

from ..obs import journal as _journal
from ..obs import metrics as _metrics
from ..utils.nan_guard import NanInfError
from . import inject
from .policy import RecoveryPolicy, retry_call

__all__ = ["GuardedStep", "GuardStats"]


class GuardStats:
    """Counters a guard accumulates (one instance per guard). ``inc``
    mirrors into the process-wide ``obs.metrics`` registry under
    ``resilience.<name>`` so fleet-level dashboards see every guard's
    recoveries without holding guard references — EXCEPT ``retries``,
    which ``policy.retry_call`` (the chokepoint every guard funnels
    through) already ticks globally per actual retry."""

    _COUNTERS = ("steps", "nonfinite", "skipped", "rollbacks", "retries",
                 "degraded")

    def __init__(self, owner=None):
        self.owner = owner      # which guard kind journal events cite
        self.steps = 0          # committed (good) steps
        self.nonfinite = 0      # nonfinite detections
        self.skipped = 0        # steps discarded by skip_step
        self.rollbacks = 0      # last-good restores
        self.retries = 0        # transient retries that happened
        self.degraded = 0       # optimize_level degradations (static)

    def inc(self, name, n=1):
        setattr(self, name, getattr(self, name) + n)
        if n and name != "retries":
            _metrics.counter("resilience." + name).inc(n)
            # flight recorder: recoveries are journal events (committed
            # steps are step records, not events — they'd drown the log)
            if name != "steps" and _journal.ACTIVE is not None:
                _journal.ACTIVE.event("resilience." + name,
                                      source=self.owner)

    def as_dict(self):
        return {k: getattr(self, k) for k in self._COUNTERS}

    def __repr__(self):
        body = ", ".join(f"{k}={getattr(self, k)}" for k in self._COUNTERS)
        return f"GuardStats({body})"


class _Snapshot:
    """Device copies of a list of tensors, allocated once and refreshed
    by copying into them, plus the optimizer's step count. The copies run
    as one multi-tensor copy per (device, dtype): a ``copy_`` a tensor
    costs a launch each, and one ``_foreach_copy_`` over mixed dtypes
    falls back to that."""

    def __init__(self, tensors):
        self.source = tensors           # the live list it copies
        self.tensors = [t.detach().clone() for t in tensors]
        groups = {}
        for i, t in enumerate(tensors):
            groups.setdefault((t.device, t.dtype), []).append(i)
        self._groups = list(groups.values())
        self.gstep = 0

    @torch.no_grad()
    def _copy(self, dsts, srcs):
        for idx in self._groups:
            torch._foreach_copy_([dsts[i] for i in idx],
                                 [srcs[i] for i in idx])

    def take(self, tensors, gstep):
        self._copy(self.tensors, tensors)
        self.gstep = gstep

    def restore(self, tensors):
        if tensors is not self.source:
            raise RuntimeError("the guarded state's layout changed since "
                               "this snapshot was taken")
        self._copy(tensors, self.tensors)
        return self.gstep


class GuardedStep:
    """Policy wrapper over a ``TrainStep``.

    >>> step = TrainStep(model, opt, loss_fn, check_nan=True)
    >>> guarded = GuardedStep(step, RecoveryPolicy(on_nonfinite="skip_step"))
    >>> loss = guarded(x, y)      # None when the step was discarded

    ``scaler`` (optional ``amp.GradScaler``): a guard-discarded step
    advances the scaler's dynamic state machine via ``notify_skip()`` —
    bookkeeping that keeps a GradScaler used elsewhere recording the
    same skip history the guard observed. A TrainStep built WITH a
    scaler never reaches the guard's nonfinite path at all (its in-graph
    found_inf already freezes the update and shrinks the scale); the
    guard then only adds retry/stats.
    """

    def __init__(self, step, policy=None, scaler=None):
        self.step = step
        self.policy = policy or RecoveryPolicy()
        self.scaler = scaler
        self.stats = GuardStats(owner="guarded_step")
        self._pre = None
        self._last_good = None
        self._layout = self._tensors = None
        if self.policy.on_nonfinite != "raise" and not step.check_nan \
                and step.scaler is None:
            raise ValueError(
                "GuardedStep needs the step's on-device nonfinite flag: "
                "construct TrainStep(check_nan=True) (or attach a loss "
                "scaler, whose in-graph found_inf already skips updates)")

    # -- snapshot / restore of the step's entire mutable state ---------------
    def _state(self):
        """Every tensor a step writes, in a fixed order. The list is
        built once for each layout (the optimizer and which of its
        parameters train); the first build creates any missing optimizer
        state. Parameters, buffers and state are written in place and
        never rebound (the step's graph relies on that too), so the same
        list serves every later call."""
        st, opt = self.step, self.step.optimizer
        layout = (id(opt), id(opt._named_params),
                  tuple(p.requires_grad for _, p in opt._named_params))
        if layout != self._layout:
            trainable = [(n, p) for n, p in opt._named_params
                         if p.requires_grad]
            out = [p for _, p in trainable] + list(st.model.buffers())
            for n, p in trainable:
                out += list(opt._state_for(n, p).values())
            out += list((st._scaler_state or {}).values())
            self._layout, self._tensors = layout, out
        return self._tensors

    def _take(self, snap):
        """Refresh ``snap`` (a ``_Snapshot`` or None) from the live state;
        allocates it when there is none or the state's layout changed."""
        tensors = self._state()
        if snap is None or snap.source is not tensors:
            snap = _Snapshot(tensors)
        snap.take(tensors, self.step.optimizer._global_step)
        return snap

    def _restore(self, snap):
        self.step.optimizer._global_step = snap.restore(self._state())

    def __call__(self, *batch):
        pol = self.policy
        if inject.ACTIVE:
            batch = inject.fire("nan_feed", list(batch))
        t0 = time.perf_counter()
        # snapshot EVERY call: a retry restores it before each
        # re-attempt, skip_step restores it, and rollback falls back to
        # it before the first verified-good snapshot exists
        pre = self._pre = self._take(self._pre)

        def attempt():
            if inject.ACTIVE:
                inject.fire("transient_execute")
            return self.step(*batch)

        try:
            loss, attempts = retry_call(attempt, pol,
                                        before_retry=lambda:
                                        self._restore(pre))
        except NanInfError:
            self.stats.inc("nonfinite")
            if pol.on_nonfinite == "raise":
                raise
            if pol.on_nonfinite == "skip_step":
                self._restore(pre)
                self.stats.inc("skipped")
            else:
                self._restore(self._last_good if self._last_good
                              else pre)
                self.stats.inc("rollbacks")
            if self.scaler is not None:
                self.scaler.notify_skip(self.step._device())
            if _journal.ACTIVE is not None:
                _journal.ACTIVE.record_step(
                    loss=None, step_ms=(time.perf_counter() - t0) * 1e3,
                    skipped=True, nonfinite=True, source="guarded_step")
            return None
        self.stats.inc("retries", attempts - 1)
        self.stats.inc("steps")
        if pol.on_nonfinite == "rollback" and \
                self.stats.steps % pol.snapshot_every == 0:
            self._last_good = self._take(self._last_good)
        if _journal.ACTIVE is not None:
            # journaling reads the scalar loss to the host (one scalar
            # sync — the standard cost of logging a loss; an inactive
            # journal is the single None check above)
            _journal.ACTIVE.record_step(
                loss=loss, step_ms=(time.perf_counter() - t0) * 1e3,
                source="guarded_step")
        return loss
