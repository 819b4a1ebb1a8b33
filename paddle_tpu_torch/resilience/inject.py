"""Deterministic fault injection: named chaos points.

The serve-loop part of ``paddle_tpu.resilience.inject``: a registry of
seed-driven injectors and the ``fire`` hook production code calls —

- ``replica_kill``  hard-kill a serve replica process mid-flight, fired
                    from ``ServeEngine.step()``'s boundary hook with the
                    engine's serve-step count and replica id.

Activation is explicit and scoped: the ``chaos("point", ...)`` context
manager. When nothing is active, ``ACTIVE`` is an empty dict and every
production hook is a single ``if not ACTIVE`` — no device sync, no
allocation, nothing on the hot path.

Determinism: an injector fires on hit indices ``at .. at+times-1`` of
its chaos point (hits are counted per activation, under a lock), so the
same (at, times) config always breaks the same run the same way.

Activation is also possible from env ``PADDLE_TPU_CHAOS`` (read at
import, or by ``install_from_env()``): a fleet worker inherits its kill
that way.

Not here yet: the training-side injectors (feeds, ops, compiles,
checkpoints, loader and gang workers).
"""
from __future__ import annotations

import contextlib
import os
import threading

__all__ = [
    "ChaosError", "TransientChaosError", "Injector", "INJECTORS",
    "ACTIVE", "ReplicaKillInjector", "register_injector", "chaos", "fire",
    "clear", "install_from_env",
]


class ChaosError(RuntimeError):
    """Base class for every injected fault."""


class TransientChaosError(ChaosError):
    """Injected fault that models a *retryable* infrastructure error:
    recovery layers treat it like ``resilience.policy.TransientError``."""


INJECTORS: dict[str, type] = {}  # point name -> injector class
ACTIVE: dict[str, "Injector"] = {}  # point name -> live injector


def register_injector(name):
    def deco(cls):
        cls.point = name
        INJECTORS[name] = cls
        return cls
    return deco


class Injector:
    """One configured fault. Fires on hit indices at..at+times-1."""

    point = None

    def __init__(self, at=1, times=1, seed=0, **cfg):
        self.at = int(at)
        self.times = int(times)
        self.seed = int(seed)
        self.cfg = cfg
        self.hits = 0
        self.fired = 0
        self._lock = threading.Lock()

    def should_fire(self):
        with self._lock:
            self.hits += 1
            if self.hits >= self.at and self.fired < self.times:
                self.fired += 1
                return True
            return False

    def fire(self, value=None, **ctx):  # pragma: no cover - overridden
        return value

    def __repr__(self):
        return (f"{type(self).__name__}(at={self.at}, times={self.times}, "
                f"seed={self.seed}, hits={self.hits}, fired={self.fired})")


def fire(point, value=None, **ctx):
    """Production-side hook: pass ``value`` through the active injector
    for ``point`` (which may corrupt it or raise), or return it untouched.
    Callers guard with ``if ACTIVE:`` so the disabled path is one empty-
    dict truthiness test."""
    inj = ACTIVE.get(point)
    if inj is None:
        return value
    return inj.fire(value, **ctx)


# -- injectors ---------------------------------------------------------------


class _WorkerFaultInjector(Injector):
    """Base for process-level faults fired from a loop's step boundary.

    Two firing modes:

    - ``at_step=N`` — fire when the step equals N, once per activation;
    - default hit-based ``at``/``times``.

    ``rank=R`` additionally gates either mode to one process."""

    def _worker_applies(self, step=None, rank=None):
        want_rank = self.cfg.get("rank")
        if want_rank is not None and rank is not None and \
                int(want_rank) != int(rank):
            return False
        at_step = self.cfg.get("at_step")
        if at_step is not None:
            if step is None or int(step) != int(at_step):
                return False
            with self._lock:
                self.hits += 1
                if self.fired >= self.times:
                    return False
                self.fired += 1
                return True
        return self.should_fire()


@register_injector("replica_kill")
class ReplicaKillInjector(_WorkerFaultInjector):
    """Hard-kill a SERVE replica process mid-flight via ``os._exit`` —
    the machine-loss fault for serving. Fired from
    ``ServeEngine.step()``'s boundary hook with the engine's serve-step
    count and replica id, so ``at=N`` means "die inside serve step N"
    and ``rank=R`` targets one replica. cfg: ``code`` (exit code,
    default 1)."""

    def fire(self, value=None, step=None, rank=None, **ctx):
        if self._worker_applies(step, rank):
            os._exit(int(self.cfg.get("code", 1)))
        return value


# -- activation --------------------------------------------------------------


def _journal_event(kind, **fields):
    """Chaos (de)activation lands in the run journal — a drill must be
    distinguishable from a real fault in the flight record."""
    from ..obs import journal as _journal

    if _journal.ACTIVE is not None:
        _journal.ACTIVE.event(kind, **fields)


@contextlib.contextmanager
def chaos(point, **cfg):
    """Activate one chaos point for the duration of the block.

    >>> with chaos("replica_kill", at=3, rank=1):
    ...     engine.run()
    """
    if point not in INJECTORS:
        raise KeyError(
            f"unknown chaos point '{point}' (registered: "
            f"{sorted(INJECTORS)})")
    inj = INJECTORS[point](**cfg)
    prev = ACTIVE.get(point)
    ACTIVE[point] = inj
    _journal_event("chaos.activate", point=point, cfg=dict(
        at=inj.at, times=inj.times, seed=inj.seed, **inj.cfg))
    try:
        yield inj
    finally:
        if prev is None:
            ACTIVE.pop(point, None)
        else:
            ACTIVE[point] = prev
        _journal_event("chaos.deactivate", point=point, fired=inj.fired)


def clear():
    """Deactivate every chaos point."""
    ACTIVE.clear()


def install_from_env(env=None):
    """Activate chaos points from ``PADDLE_TPU_CHAOS``.

    Format (shared ``utils.envspec`` grammar):
    ``"point:key=val,key=val;point2"`` — e.g.
    ``PADDLE_TPU_CHAOS="replica_kill:at=4,rank=1"``.
    Returns the list of activated points.
    """
    from ..utils.envspec import parse_spec

    spec = env if env is not None else os.environ.get("PADDLE_TPU_CHAOS", "")
    out = []
    for point, cfg in parse_spec(spec):
        if point not in INJECTORS:
            raise KeyError(
                f"PADDLE_TPU_CHAOS names unknown point '{point}' "
                f"(registered: {sorted(INJECTORS)})")
        ACTIVE[point] = INJECTORS[point](**cfg)
        out.append(point)
    for point in out:
        _journal_event("chaos.activate", point=point, source="env")
    return out


if os.environ.get("PADDLE_TPU_CHAOS"):
    install_from_env()
