"""Recovery policies: what a detected fault turns into.

The reference reacts to faults operationally (fleet restarts the trainer,
``FLAGS_check_nan_inf`` aborts, the PS heartbeat re-elects); here the
policy is an object its users interpret — the serve engine's page-
pressure relief reads the retry half; the training guards that read
the rest are not ported yet:

- ``on_nonfinite`` — what a NaN/Inf training step becomes:
  ``"raise"`` (abort, the reference flag's behavior), ``"skip_step"``
  (discard this step's updates and continue — the step contributes
  nothing, exactly as if its batch had been dropped), or ``"rollback"``
  (restore the last-good in-memory snapshot, taken every
  ``snapshot_every`` successful steps).
- bounded retry-with-backoff for transient compile/execute errors
  (``TransientError`` and injected ``TransientChaosError``): up to
  ``max_retries`` retries, sleeping ``backoff * backoff_factor**i``
  capped at ``max_backoff``, optionally spread by a seeded ``jitter``
  fraction (a pod's worth of workers retrying a shared service must
  not stampede it in lockstep) and bounded by a wall-clock
  ``deadline_s`` on ``retry_call`` (a retry loop must not outlive the
  preemption grace window it is racing).
- ``degrade_opt_level`` — when an optimized program
  (``optimize_level>0``) fails to compile/run but the unoptimized one
  succeeds, fall back to level 0 for the rest of the run instead of
  dying (a miscompiled pass must never kill a pod job).
"""
from __future__ import annotations

import time

from ..obs import metrics as _metrics
from .inject import TransientChaosError

__all__ = ["TransientError", "RecoveryPolicy", "retry_call",
           "NONFINITE_ACTIONS"]


class TransientError(RuntimeError):
    """A retryable infrastructure error (preempted RPC, flaky link).
    Raise (or subclass) this to opt an error into the retry path."""


NONFINITE_ACTIONS = ("raise", "skip_step", "rollback")


class RecoveryPolicy:
    def __init__(self, on_nonfinite="raise", max_retries=3, backoff=0.05,
                 backoff_factor=2.0, max_backoff=2.0, snapshot_every=1,
                 degrade_opt_level=True,
                 retryable=(TransientError, TransientChaosError),
                 sleep=None, jitter=0.0, jitter_seed=0):
        if on_nonfinite not in NONFINITE_ACTIONS:
            raise ValueError(
                f"on_nonfinite must be one of {NONFINITE_ACTIONS}, got "
                f"{on_nonfinite!r}")
        if not 0.0 <= float(jitter) <= 1.0:
            raise ValueError(f"jitter must be a fraction in [0, 1], got "
                             f"{jitter!r}")
        self.on_nonfinite = on_nonfinite
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.backoff_factor = float(backoff_factor)
        self.max_backoff = float(max_backoff)
        self.snapshot_every = max(1, int(snapshot_every))
        self.degrade_opt_level = bool(degrade_opt_level)
        self.retryable = tuple(retryable)
        self.jitter = float(jitter)
        self.jitter_seed = int(jitter_seed)
        self._sleep = sleep if sleep is not None else time.sleep

    def backoff_for(self, attempt):
        """Deterministic backoff for retry ``attempt`` (0-based):
        exponential, capped at ``max_backoff``, then spread by a
        ±``jitter`` fraction drawn from ``RandomState(jitter_seed +
        attempt)``. Seeding per (seed, attempt) keeps tests replayable
        while workers seeded with their rank de-synchronize — jitter is
        applied AFTER the cap on purpose: clamping the spread back to
        ``max_backoff`` would re-synchronize exactly the long retries
        that stampede hardest."""
        base = min(self.backoff * self.backoff_factor ** attempt,
                   self.max_backoff)
        if self.jitter:
            import numpy as np

            u = np.random.RandomState(
                self.jitter_seed + attempt).uniform(-1.0, 1.0)
            base *= 1.0 + self.jitter * u
        return max(0.0, base)

    def __repr__(self):
        return (f"RecoveryPolicy(on_nonfinite={self.on_nonfinite!r}, "
                f"max_retries={self.max_retries}, "
                f"degrade_opt_level={self.degrade_opt_level})")


def retry_call(fn, policy=None, describe="", before_retry=None,
               deadline_s=None, clock=None):
    """Call ``fn()`` with the policy's bounded retry-with-backoff.

    Returns ``(result, attempts)`` where attempts >= 1. Non-retryable
    exceptions propagate immediately; a retryable one propagates only
    after the retry budget is exhausted. ``before_retry`` (if given)
    runs before each re-attempt — the hook where a guard restores state
    a failed attempt may have consumed (e.g. donated device buffers).

    ``deadline_s`` additionally bounds the WALL CLOCK spent retrying:
    when the next backoff sleep would land past ``deadline_s`` seconds
    from the first attempt, the retryable error propagates even with
    retry budget left — a retry loop racing a preemption grace window
    must fail fast enough to still checkpoint. ``clock`` (default
    ``time.monotonic``) is injectable so deadline tests are
    deterministic.
    """
    policy = policy or RecoveryPolicy()
    clock = clock if clock is not None else time.monotonic
    start = clock()
    attempt = 0
    while True:
        try:
            return fn(), attempt + 1
        except policy.retryable as err:
            if attempt >= policy.max_retries:
                raise
            delay = policy.backoff_for(attempt)
            if deadline_s is not None and \
                    (clock() - start) + delay > float(deadline_s):
                raise
            # the one chokepoint every guard's transient recovery passes
            # through — the process-wide resilience.retries counter lives
            # here (GuardStats keeps the per-guard view)
            _metrics.counter("resilience.retries").inc()
            from ..obs import journal as _journal

            if _journal.ACTIVE is not None:
                _journal.ACTIVE.event(
                    "resilience.retry", attempt=attempt + 1,
                    error=f"{type(err).__name__}: {err}")
            policy._sleep(delay)
            if before_retry is not None:
                before_retry()
            attempt += 1
