"""Elastic replica supervision: the serve fleet's relaunch discipline.

The serving part of ``paddle_tpu.resilience.elastic``:

- workers write heartbeat files (:class:`Heartbeat`, path handed down
  via ``PADDLE_TPU_HEARTBEAT_FILE``) from their SERVE LOOP — not a
  background thread, so a wedged step stops the beacon and becomes
  visible to the pool's watchdog;
- the :class:`ReplicaSupervisor` owns each replica's restart budget and
  the seeded, jittered exponential backoff before a relaunch (one
  formula, ``RecoveryPolicy.backoff_for``).

Restarts land as ``resilience.*`` metrics and ``elastic.replica_*``
journal events.

Not here yet: the training gang's supervisor, graceful preemption,
the program-state adapter and the checkpoint resume they drive.
"""
from __future__ import annotations

import json
import os
import time

from ..obs import metrics as _metrics
from .policy import RecoveryPolicy as _RecoveryPolicy

__all__ = ["PREEMPTED_EXIT_CODE", "HEARTBEAT_ENV", "ATTEMPT_ENV",
           "ElasticBudgetError", "Heartbeat", "ReplicaSupervisor"]

# EX_TEMPFAIL: "transient failure, retry" — distinct from every code a
# crash produces, and stable across restarts of this module
PREEMPTED_EXIT_CODE = 75
HEARTBEAT_ENV = "PADDLE_TPU_HEARTBEAT_FILE"
ATTEMPT_ENV = "PADDLE_TPU_ELASTIC_ATTEMPT"

_M_RESTARTS = _metrics.counter("resilience.restarts")
_M_PREEMPTIONS = _metrics.counter("resilience.preemptions")


class ElasticBudgetError(RuntimeError):
    """A replica kept failing until its restart budget ran out. Carries
    the full attempt ``history`` so the operator sees every failure, not
    just the last one."""

    def __init__(self, msg, history=None):
        super().__init__(msg)
        self.history = list(history or [])


def _journal_event(kind, **fields):
    """Supervisor events into the flight recorder when one is active."""
    from ..obs import journal as _journal

    if _journal.ACTIVE is not None:
        _journal.ACTIVE.event(kind, **fields)


class Heartbeat:
    """Worker-side liveness beacon: an atomically-replaced JSON file
    whose MTIME is the signal (content — ts/pid/step — is diagnostics).
    ``beat()`` belongs in the serve loop, once per step: a hang that
    stops the loop must stop the beacon, which is exactly what the
    pool's watchdog keys on. With no path configured every call is a
    no-op, so loops can beat unconditionally."""

    def __init__(self, path=None):
        self.path = path
        self.beats = 0

    @classmethod
    def from_env(cls, env=None):
        """The beacon the pool configured for this worker (via
        ``PADDLE_TPU_HEARTBEAT_FILE``), or an inert one outside a
        supervised fleet."""
        return cls((env or os.environ).get(HEARTBEAT_ENV))

    def beat(self, step=None):
        if self.path is None:
            return
        payload = {"ts": time.time(), "pid": os.getpid()}
        if step is not None:
            payload["step"] = int(step)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)  # watchdog never reads a torn file
        self.beats += 1


class ReplicaSupervisor:
    """The relaunch discipline for INDEPENDENT serve replicas
    (``serving.fleet.ReplicaPool``): per-replica restart budget, a
    seeded capped-exponential + post-cap-jitter backoff schedule (one
    formula, owned by ``RecoveryPolicy``), and
    ``elastic.replica_restart`` journal events. Replicas share no
    collective, so a failed replica NEVER tears down its peers — the
    pool requeues the casualty's requests and relaunches it alone while
    the survivors keep serving. Preemption-style exits
    (``PREEMPTED_EXIT_CODE``) are budget-free."""

    def __init__(self, max_restarts=3, *, backoff_s=0.5,
                 backoff_factor=2.0, max_backoff_s=30.0, jitter=0.25,
                 seed=0, sleep=None):
        self.max_restarts = int(max_restarts)
        self._policy = _RecoveryPolicy(
            backoff=float(backoff_s), backoff_factor=float(backoff_factor),
            max_backoff=float(max_backoff_s), jitter=float(jitter),
            jitter_seed=int(seed))
        self._sleep = sleep if sleep is not None else time.sleep
        # per-replica budgets: one flapping replica must not spend the
        # healthy ones' relaunches
        self.restarts = {}     # replica_id -> budget-consuming restarts
        self.preemptions = {}  # replica_id -> budget-free relaunches
        self.history = []      # [{replica, kind, code, restarts}]

    def note_failure(self, replica_id, kind="crash", code=None,
                     defer=False):
        """Account one replica failure and SLEEP the backoff before the
        relaunch the caller is about to do. ``kind``: ``crash``/``hang``
        consume that replica's restart budget, ``preempt`` is free.
        Raises :class:`ElasticBudgetError` (with the failure history)
        when the budget is spent. Returns the backoff slept (s).
        ``defer=True`` skips the sleep and just returns the delay — for
        callers that schedule the relaunch themselves instead of
        blocking (the fleet pool's health sweep runs on the router's
        dispatch thread; sleeping there would stall the healthy
        replicas)."""
        rid = int(replica_id)
        free = kind == "preempt"
        if free:
            self.preemptions[rid] = self.preemptions.get(rid, 0) + 1
            n = self.preemptions[rid]
        else:
            self.restarts[rid] = self.restarts.get(rid, 0) + 1
            n = self.restarts[rid]
        self.history.append({"replica": rid, "kind": kind, "code": code,
                             "restarts": self.restarts.get(rid, 0)})
        if not free and n > self.max_restarts:
            _journal_event("elastic.replica_budget_exhausted",
                           replica=rid, restarts=n - 1, last_kind=kind,
                           last_code=code)
            raise ElasticBudgetError(
                f"replica {rid} failed {n} times, restart budget is "
                f"{self.max_restarts}: last failure {kind} "
                f"(exit {code})", self.history)
        delay = 0.0 if free else self._policy.backoff_for(n - 1)
        if not free:
            _M_RESTARTS.inc()
        else:
            _M_PREEMPTIONS.inc()
        _journal_event("elastic.replica_restart", replica=rid,
                       failure=kind, code=code,
                       restarts_used=self.restarts.get(rid, 0),
                       backoff_s=round(delay, 4))
        if delay and not defer:
            self._sleep(delay)
        return delay
