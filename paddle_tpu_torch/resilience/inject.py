"""Deterministic fault injection: named chaos points.

The port of ``paddle_tpu.resilience.inject``: a registry of seed-driven
injectors and the ``fire`` hook production code calls —

- ``nan_feed``      corrupt one element of a fed batch (a copy of it) at
                    step N, fired by ``resilience.GuardedStep``
- ``transient_execute``
                    raise a retryable error from the guarded step's
                    invocation, N times then heal
- ``ckpt_crash``    die between writing a checkpoint and publishing it
                    (leaves an orphaned ``.tmp_ckpt_*`` dir)
- ``ckpt_truncate`` / ``ckpt_bitflip``
                    corrupt a published checkpoint file
- ``ckpt_slow``     stall the checkpoint writer between writing files and
                    the atomic publish (the window a killed writer leaves
                    only a tmp orphan, and the window an async save must
                    keep off the step path)
- ``replica_kill``  hard-kill a serve replica process mid-flight, fired
                    from ``ServeEngine.step()``'s boundary hook with the
                    engine's serve-step count and replica id.

Activation is explicit and scoped: the ``chaos("point", ...)`` context
manager, or env ``PADDLE_TPU_CHAOS`` (read at import, or by
``install_from_env()``): a fleet worker inherits its kill that way.
When nothing is active, ``ACTIVE`` is an empty dict and every production
hook is a single ``if not ACTIVE`` — no device sync, no allocation,
nothing on the hot path.

Determinism: an injector fires on hit indices ``at .. at+times-1`` of
its chaos point (hits are counted per activation, under a lock) and any
randomness (which element or bit to flip) comes from
``np.random.RandomState(seed + fired)``. The same (at, times, seed)
config always breaks the same run the same way.

Not here yet: ``nan_op`` (it needs the reference's eager dispatch hook,
which the port does not have), the compile injectors (no compile step
in the port) and the loader and gang-worker faults (``io_``, ``dist/``).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

import numpy as np
import torch

__all__ = [
    "ChaosError", "TransientChaosError", "SimulatedCrashError", "Injector",
    "INJECTORS", "ACTIVE", "register_injector", "chaos", "fire", "clear",
    "install_from_env",
]


class ChaosError(RuntimeError):
    """Base class for every injected fault."""


class TransientChaosError(ChaosError):
    """Injected fault that models a *retryable* infrastructure error:
    recovery layers treat it like ``resilience.policy.TransientError``."""


class SimulatedCrashError(ChaosError):
    """The process 'died' at the injection point (e.g. mid-checkpoint)."""


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

    def _eligible(self):
        """Count the hit but DON'T consume firing budget yet — for
        injectors whose fault may turn out inapplicable at this hit
        (see ``_commit_fire``). The window stays open until ``times``
        faults actually landed."""
        with self._lock:
            self.hits += 1
            return self.hits >= self.at and self.fired < self.times

    def _commit_fire(self):
        with self._lock:
            self.fired += 1

    def _rng(self):
        # per-firing stream: firing twice corrupts two different elements
        return np.random.RandomState(self.seed + self.fired)

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


def _bad_value(kind):
    return np.inf if str(kind) == "inf" else np.nan


def _is_float(a):
    if isinstance(a, torch.Tensor):
        return a.is_floating_point() and a.numel() > 0
    a = np.asarray(a)
    return a.dtype.kind == "f" and a.size > 0


@register_injector("nan_feed")
class NanFeedInjector(Injector):
    """Corrupt one element of one fed array (dict feed or batch list).

    cfg: ``var`` — feed name (dict) or positional index (list); defaults
    to the first sorted name / index 0. ``kind`` — "nan" (default) or
    "inf". Items are numpy arrays or torch tensors (any device). The
    corrupted container and item are copies; the caller's are never
    mutated.
    """

    def fire(self, value=None, **ctx):
        if value is None or not self._eligible():
            return value
        # locate the target FIRST: a hit whose feed has no corruptible
        # target (name typo, int-only feed, empty batch) must not consume
        # the firing budget — otherwise a drill can 'recover' from a
        # fault that was never injected
        if isinstance(value, dict):
            name = self.cfg.get("var")
            if name is None:
                # default target is a USER feed: '@'-prefixed names are
                # executor internals ('@lr'), and '@' sorts first
                users = sorted(n for n in value if not n.startswith("@"))
                name = users[0] if users else None
            if name not in value or not _is_float(value[name]):
                return value
            key = name
            container = dict(value)
        else:
            idx = int(self.cfg.get("var", 0))
            if not (0 <= idx < len(value)) or not _is_float(value[idx]):
                return list(value)
            key = idx
            container = list(value)
        self._commit_fire()
        kind = _bad_value(self.cfg.get("kind", "nan"))
        item = container[key]
        if isinstance(item, torch.Tensor):
            a = item.clone()
            a.view(-1)[int(self._rng().randint(a.numel()))] = float(kind)
        else:
            a = np.asarray(item).copy()
            a.ravel()[int(self._rng().randint(a.size))] = kind
        container[key] = a
        return container


@register_injector("transient_execute")
class TransientExecuteInjector(Injector):
    """The guarded step's invocation raises a retryable error."""

    def fire(self, value=None, **ctx):
        if self.should_fire():
            raise TransientChaosError(
                f"injected transient execute failure "
                f"(hit {self.hits}, firing {self.fired}/{self.times})")
        return value


@register_injector("ckpt_crash")
class CkptCrashInjector(Injector):
    """Die after writing checkpoint files but BEFORE the atomic publish:
    the orphaned ``.tmp_ckpt_*`` dir is exactly what a real mid-save
    crash leaves behind."""

    def fire(self, value=None, **ctx):
        if self.should_fire():
            raise SimulatedCrashError(
                f"simulated crash before checkpoint publish (tmp={value})")
        return value


class _CkptFileCorruptor(Injector):
    target_default = "model.pdparams"

    def _target(self, ckpt_dir):
        name = self.cfg.get("file", self.target_default)
        path = os.path.join(ckpt_dir, name)
        if not os.path.exists(path):
            for fn in sorted(os.listdir(ckpt_dir)):
                if fn != "manifest.json":
                    return os.path.join(ckpt_dir, fn)
        return path

    def corrupt(self, path, rng):  # pragma: no cover - overridden
        raise NotImplementedError

    def fire(self, value=None, **ctx):
        if value is None or not self.should_fire():
            return value
        path = self._target(value)
        if path and os.path.exists(path):
            self.corrupt(path, self._rng())
        return value


@register_injector("ckpt_truncate")
class CkptTruncateInjector(_CkptFileCorruptor):
    """Truncate a published checkpoint file to ``fraction`` of its size
    (default 0.5) — a torn write / out-of-quota artifact."""

    def corrupt(self, path, rng):
        size = os.path.getsize(path)
        frac = float(self.cfg.get("fraction", 0.5))
        with open(path, "r+b") as f:
            f.truncate(max(0, int(size * frac)))


@register_injector("ckpt_bitflip")
class CkptBitflipInjector(_CkptFileCorruptor):
    """Flip one seeded bit of a published checkpoint file — silent media
    corruption that only a checksum can catch."""

    def corrupt(self, path, rng):
        size = os.path.getsize(path)
        if size == 0:
            return
        off = int(rng.randint(size))
        bit = 1 << int(rng.randint(8))
        with open(path, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ bit]))


@register_injector("ckpt_slow")
class CkptSlowInjector(Injector):
    """Stall the checkpoint writer for ``seconds`` (default 0.5) between
    writing the checkpoint files and the atomic publish — a slow/remote
    filesystem. Under ``save_checkpoint(async_=True)`` the stall runs on
    the background writer thread; a process killed inside the stall
    leaves only the ``.tmp_ckpt_*`` orphan (publish never ran)."""

    def fire(self, value=None, **ctx):
        if self.should_fire():
            time.sleep(float(self.cfg.get("seconds", 0.5)))
        return value


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

    >>> with chaos("nan_feed", at=3, seed=7):
    ...     guarded(x, y)
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
    ``PADDLE_TPU_CHAOS="transient_execute:times=2;nan_feed:at=3,seed=1"``.
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
