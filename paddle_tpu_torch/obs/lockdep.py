"""Lockdep-style runtime lock-order validation for the host runtime.

The threaded host side (router/pool reader threads, the serve engine's
step lock, DataLoader workers, the async checkpoint writer, the run
journal) has a documented lock-ordering contract — router → pool →
replica, engine.step → scheduler → cache — but a contract nobody
*checks* is a deadlock waiting to happen. This module is the
runtime half of ``analysis/concurrency.py``'s static lint: the Linux
lockdep idea scaled down to the process — every instrumented lock
acquisition records, per thread, which lock *classes* (names, not
instances) were already held, building a process-wide acquisition-order
graph. The first edge that closes a cycle is the deadlock precondition
itself (an AB/BA pair needs only unlucky timing to hang), and it is
reported immediately — deterministically, on every run that merely
*exercises* both orders, long before the 1-in-10⁶ interleaving that
actually deadlocks:

- a **PTC004 diagnostic** with BOTH witness stacks (the acquisition
  that closed the cycle and the recorded stack of the reverse edge),
  raised as :class:`LockCycleError` (default) or warned
  (``PADDLE_TPU_LOCKDEP=warn``), journaled as a ``lockdep.cycle``
  event when a run journal is active, and kept in :func:`violations`
  so drills can assert emptiness;
- **held-time histograms** — ``lockdep.held_ms.<name>`` in the metrics
  registry — so a lock that quietly serializes the serve loop shows up
  in the same snapshot as every other SLO signal.

Zero overhead when off (the chaos/obs discipline): :func:`lock` /
:func:`rlock` are called once per lock *construction* and return plain
``threading.Lock()`` / ``RLock()`` unless lockdep is enabled — the
steady-state acquire path is untouched, no wrapper, no flag check.
Opt in per process with env ``PADDLE_TPU_LOCKDEP=1`` (raise on cycle)
or ``PADDLE_TPU_LOCKDEP=warn`` (record + warn), or at runtime with
:func:`enable` — runtime enabling instruments only locks constructed
afterwards, which is exactly what the drills want (scoped, no global
residue after :func:`disable` + :func:`reset`).

Lock classes are NAMES, not instances: every ``Scheduler`` shares the
class ``"serving.scheduler"``, so an ordering inversion between two
replicas' schedulers is caught even though the two runs touched
different objects — same-name nesting (two instances of one class) is
deliberately not an edge, mirroring lockdep's nested-class annotation
escape hatch.
"""
from __future__ import annotations

import os
import threading
import time
import traceback
import warnings

__all__ = [
    "LockCycleError", "enable", "disable", "enabled", "mode",
    "lock", "rlock", "violations", "order_graph", "held_names",
    "reset", "install_from_env",
]

MODE_RAISE = "raise"
MODE_WARN = "warn"

_mode = None           # None = off; MODE_RAISE | MODE_WARN

# process-wide order graph, guarded by a PLAIN lock (never instrumented:
# it is leaf-level by construction — nothing is acquired inside it)
_GRAPH_LOCK = threading.Lock()
_succ: dict = {}        # name -> set(names acquired while name held)
_edges: dict = {}       # (a, b) -> {"stack": [...], "thread": str, "count": n}
_violations: list = []  # PTC004 records, in detection order

_tls = threading.local()  # .held = [[name, lock_obj, t0, depth]], .busy


class LockCycleError(RuntimeError):
    """PTC004: a lock acquisition closed a cycle in the process-wide
    acquisition-order graph — the deadlock precondition. Carries the
    cycle (names, in order) and both witness stacks."""

    code = "PTC004"

    def __init__(self, cycle, new_stack, prev_stack, message):
        self.cycle = list(cycle)
        self.new_stack = new_stack
        self.prev_stack = prev_stack
        super().__init__(message)


def _held_stack():
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _stack(skip=3, limit=12):
    """Bounded, rendered acquisition stack (the witness): drop the
    lockdep frames themselves, keep the caller's."""
    frames = traceback.extract_stack()[:-skip]
    return traceback.format_list(frames[-limit:])


def _find_path(src, dst, succ):
    """DFS: a path src -> ... -> dst over the order graph (names), or
    None. Iterative — the graph is small but a serve process is not the
    place to bet on recursion depth."""
    if src == dst:
        return [src]
    seen = {src}
    stack = [(src, [src])]
    while stack:
        node, path = stack.pop()
        for nxt in sorted(succ.get(node, ())):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_edges(held_names_, name):
    """Record held -> name edges; returns a violation dict when one of
    them closed a cycle (graph mutation under _GRAPH_LOCK, everything
    observable — journal, metrics, raise — done by the CALLER outside
    it: emitting acquires instrumented locks, which would re-enter)."""
    viol = None
    new_stack = None
    with _GRAPH_LOCK:
        for h in held_names_:
            if h == name:
                continue  # same class nested: not an order edge
            key = (h, name)
            rec = _edges.get(key)
            if rec is not None:
                rec["count"] += 1
                continue
            if new_stack is None:
                new_stack = _stack(skip=4)
            # adding h -> name: a pre-existing path name -> ... -> h
            # means the new edge closes a cycle
            path = _find_path(name, h, _succ)
            _edges[key] = {"stack": new_stack,
                           "thread": threading.current_thread().name,
                           "count": 1}
            _succ.setdefault(h, set()).add(name)
            if path is not None and viol is None:
                prev = _edges.get((path[0], path[1])) if len(path) > 1 \
                    else None
                cycle = [h, name] + path[1:]
                viol = {
                    "code": "PTC004",
                    "cycle": cycle,
                    "new_edge": key,
                    "new_stack": new_stack,
                    "new_thread": threading.current_thread().name,
                    "prev_edge": (path[0], path[1])
                    if len(path) > 1 else None,
                    "prev_stack": (prev or {}).get("stack"),
                    "prev_thread": (prev or {}).get("thread"),
                }
                _violations.append(viol)
    return viol


def _emit_violation(viol):
    """Journal + metrics + warn/raise for one detected cycle. Runs with
    the edge-recording suppressed (the journal's own instrumented lock
    must not recurse into detection mid-report)."""
    from . import metrics as _metrics

    _metrics.counter("lockdep.cycles").inc()
    msg = ("[PTC004] lock-order cycle: "
           + " -> ".join(viol["cycle"])
           + f" (new edge {viol['new_edge'][0]} -> "
             f"{viol['new_edge'][1]} on thread "
             f"{viol['new_thread']})\n"
           + "acquisition closing the cycle:\n"
           + "".join(viol["new_stack"] or [])
           + "first recorded reverse-order acquisition"
           + (f" (thread {viol['prev_thread']}):\n" if
              viol.get("prev_thread") else ":\n")
           + "".join(viol.get("prev_stack") or ["  <unrecorded>\n"]))
    _tls.busy = True
    try:
        from . import journal as _journal

        if _journal.ACTIVE is not None:
            _journal.ACTIVE.event(
                "lockdep.cycle", cycle=viol["cycle"],
                new_edge=list(viol["new_edge"]),
                new_thread=viol["new_thread"],
                prev_thread=viol.get("prev_thread"))
    except Exception:
        pass
    finally:
        _tls.busy = False
    if _mode == MODE_WARN:
        warnings.warn(msg, RuntimeWarning, stacklevel=4)
        return
    raise LockCycleError(viol["cycle"], viol["new_stack"],
                         viol.get("prev_stack"), msg)


class _DebugLock:
    """Instrumented wrapper over one ``threading.Lock``/``RLock``: edge
    recording + cycle check BEFORE blocking on the inner acquire (so a
    would-be deadlock raises instead of hanging), held-time histogram
    on the outermost release."""

    __slots__ = ("name", "_inner", "_reentrant", "_hist")

    def __init__(self, name, reentrant=False):
        self.name = str(name)
        self._reentrant = bool(reentrant)
        self._inner = threading.RLock() if reentrant \
            else threading.Lock()
        self._hist = None  # lazy: metrics import stays off constructors

    def acquire(self, blocking=True, timeout=-1):
        held = _held_stack()
        entry = None
        if self._reentrant:
            for e in held:
                if e[1] is self:
                    entry = e
                    break
        if entry is None and not getattr(_tls, "busy", False):
            names = []
            for e in held:
                if e[0] not in names:
                    names.append(e[0])
            if names:
                viol = _note_edges(names, self.name)
                if viol is not None:
                    _emit_violation(viol)  # warn-mode falls through
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if entry is not None:
                entry[3] += 1
            else:
                held.append([self.name, self, time.perf_counter(), 1])
        return ok

    def release(self):
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] is self:
                held[i][3] -= 1
                if held[i][3] == 0:
                    t0 = held[i][2]
                    del held[i]
                    self._observe((time.perf_counter() - t0) * 1e3)
                break
        self._inner.release()

    def _observe(self, ms):
        h = self._hist
        if h is None:
            from . import metrics as _metrics

            h = self._hist = _metrics.histogram(
                "lockdep.held_ms." + self.name)
        h.observe(ms)

    def locked(self):
        # RLock has no locked() before 3.12; best-effort for plain Lock
        inner = self._inner
        return inner.locked() if hasattr(inner, "locked") else None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def __repr__(self):
        return f"_DebugLock({self.name!r}, reentrant={self._reentrant})"


# -- construction-time factories (the ONLY cost when off) --------------------

def lock(name):
    """A mutex for lock class ``name``: plain ``threading.Lock()`` when
    lockdep is off, an instrumented wrapper when on."""
    if _mode is None:
        return threading.Lock()
    return _DebugLock(name, reentrant=False)


def rlock(name):
    """A reentrant mutex for lock class ``name`` (same contract as
    :func:`lock`)."""
    if _mode is None:
        return threading.RLock()
    return _DebugLock(name, reentrant=True)


# -- control + introspection -------------------------------------------------

def enable(mode_=MODE_RAISE):
    """Instrument locks constructed from now on; ``mode_`` is
    ``"raise"`` (LockCycleError on the first cycle) or ``"warn"``."""
    global _mode
    if mode_ not in (MODE_RAISE, MODE_WARN):
        raise ValueError(f"lockdep mode must be raise|warn, got {mode_!r}")
    _mode = mode_


def disable():
    """Stop instrumenting NEW locks (already-wrapped ones keep
    recording; pair with :func:`reset` for a clean scoped window)."""
    global _mode
    _mode = None


def enabled():
    return _mode is not None


def mode():
    return _mode


def violations():
    """Every PTC004 cycle detected so far (list of dicts with the
    cycle, both edges, both witness stacks)."""
    with _GRAPH_LOCK:
        return list(_violations)


def order_graph():
    """{name: sorted successors} — the recorded acquisition order."""
    with _GRAPH_LOCK:
        return {a: sorted(bs) for a, bs in sorted(_succ.items())}


def held_names():
    """Lock classes the CURRENT thread holds, outermost first."""
    return [e[0] for e in _held_stack()]


def reset():
    """Clear the order graph and recorded violations (per-thread held
    stacks are live state and stay)."""
    with _GRAPH_LOCK:
        _succ.clear()
        _edges.clear()
        del _violations[:]


def install_from_env():
    """Adopt ``PADDLE_TPU_LOCKDEP`` (empty/0/false = off, ``warn`` =
    record+warn, anything else truthy = raise). Called at import."""
    v = os.environ.get("PADDLE_TPU_LOCKDEP", "").strip().lower()
    if v in ("", "0", "false", "off"):
        return
    enable(MODE_WARN if v == "warn" else MODE_RAISE)


install_from_env()
