"""Continuous-batching scheduler: admission, interleaving, preemption.

The serving control plane (the role Orca/vLLM's scheduler plays, and
the scenario template of the Gemma-on-TPU serving comparison, arXiv
2605.25645): requests arrive at any time, and every engine step serves
a *mixed* batch — new requests' prefills interleaved with in-flight
requests' decodes — rather than waiting for a static batch to drain.

Rules (each one is pinned exactly by tests/test_serving.py):

- **Admission under a token budget.** A step may process at most
  ``token_budget`` tokens: each in-flight decode costs 1, a prefill
  costs its prompt length. Decodes are budgeted first (in-flight
  requests never starve behind new arrivals), then queued requests
  admit in strict arrival order while budget AND KV pages last —
  FIFO admission is the no-starvation guarantee.
- **Preemption by page pressure.** When a decode needs a page and the
  pool is dry, the *youngest* running request (latest admission) is
  preempted: its pages are freed, its generated-so-far tokens fold
  into its prompt, and it requeues by its ORIGINAL arrival time — so
  a preempted request loses its cache, not its place. The oldest
  running request is never chosen (guaranteed forward progress).
- **Deterministic under an injectable clock.** Every timestamp comes
  from ``clock()`` (default ``time.monotonic``); tests drive a
  ``ManualClock`` so traces — admission order, preemption step,
  timestamps — are exact, not approximate.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

from ..obs import lockdep as _lockdep
from ..obs import metrics as _metrics
from .kv_cache import CachePressureError, PageAllocationError

__all__ = ["Request", "Batch", "Scheduler", "ManualClock",
           "QUEUED", "RUNNING", "PREEMPTED", "FINISHED", "CANCELLED"]

QUEUED, RUNNING, PREEMPTED, FINISHED, CANCELLED = (
    "QUEUED", "RUNNING", "PREEMPTED", "FINISHED", "CANCELLED")

_M_QUEUE = _metrics.gauge("serving.queue_depth")
_M_RUNNING = _metrics.gauge("serving.running")
_M_ADMITTED = _metrics.counter("serving.requests_admitted")
_M_PREEMPTED = _metrics.counter("serving.requests_preempted")
_M_REJECTED = _metrics.counter("serving.requests_rejected")

_rid_counter = itertools.count()


class ManualClock:
    """Deterministic test clock: ``clock()`` reads, ``advance`` moves."""

    def __init__(self, start=0.0):
        self.now = float(start)

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += float(dt)
        return self.now


@dataclass
class Request:
    """One generation request and its full lifecycle record."""

    prompt: list                     # token ids
    max_new_tokens: int = 16
    rid: str = None
    eos_id: int = None
    # billing identity: every request is owned by exactly one tenant
    # (None = the router's implicit "default" tenant); obs.usage charges
    # device-seconds and KV page-seconds to this key
    tenant: str = None
    state: str = QUEUED
    # lifecycle timestamps (scheduler clock)
    arrival_t: float = None
    admit_t: float = None
    first_token_t: float = None
    finish_t: float = None
    # progress
    generated: list = field(default_factory=list)
    preemptions: int = 0
    pages_peak: int = 0
    # request-scoped tracing (obs.reqtrace): the trace id minted at
    # Router.submit rides dispatch into this replica's Request; the
    # preempt/resume stamp pairs are what preemption-loss attribution
    # is computed from (every preempt_ts[i] pairs with resume_ts[i],
    # a final unpaired preempt pairs with finish_t)
    trace: str = None
    preempt_ts: list = field(default_factory=list)
    resume_ts: list = field(default_factory=list)

    def __post_init__(self):
        self.prompt = [int(t) for t in self.prompt]
        if not self.prompt:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(self.max_new_tokens)
        if self.max_new_tokens < 1:
            # the prefill unconditionally emits the first token, so a
            # zero-token request would still generate one — reject it
            raise ValueError("max_new_tokens must be >= 1")
        if self.rid is None:
            self.rid = f"req-{next(_rid_counter)}"

    @property
    def context(self):
        """prompt + generated: what a (re-)prefill must encode."""
        return self.prompt + self.generated

    @property
    def done(self):
        return len(self.generated) >= self.max_new_tokens or (
            self.eos_id is not None and self.generated
            and self.generated[-1] == self.eos_id)


@dataclass
class Batch:
    """One step's work: prefills (newly admitted / resumed) + decodes."""

    prefills: list = field(default_factory=list)
    decodes: list = field(default_factory=list)

    @property
    def tokens(self):
        return sum(len(r.context) for r in self.prefills) + \
            len(self.decodes)

    def __bool__(self):
        return bool(self.prefills or self.decodes)


class Scheduler:
    def __init__(self, cache, token_budget=256, max_batch=None,
                 clock=None):
        self.cache = cache
        self.token_budget = int(token_budget)
        self.max_batch = int(max_batch) if max_batch else None
        self.clock = clock if clock is not None else time.monotonic
        # page-second attribution (obs.usage) integrates pages x time
        # from cache stamps; those stamps must tick on the SAME clock
        # as the request lifecycle or the integrals drift off the
        # ManualClock-exact timeline tests pin
        if getattr(cache, "clock", None) is None:
            cache.clock = self.clock
        self._queue = []      # QUEUED/PREEMPTED, kept in arrival order
        self._running = []    # RUNNING, in admission order
        self.preemptions = 0
        # one reentrant lock over _queue/_running: submit()/cancel()
        # may arrive from other threads while the engine thread is
        # inside schedule() — an unlocked head pop racing a remove()
        # would silently discard (and permanently lose) a request.
        # Lock order is scheduler -> cache, everywhere (the journal's
        # lock nests under the scheduler's too — record_request fires
        # inside schedule(); journal is a leaf, it never calls back).
        # lockdep-instrumented under PADDLE_TPU_LOCKDEP, plain RLock
        # otherwise.
        self._lock = _lockdep.rlock("serving.scheduler")

    # -- intake --------------------------------------------------------------
    def submit(self, request):
        with self._lock:
            if request.arrival_t is None:
                request.arrival_t = self.clock()
            request.state = QUEUED
            self._enqueue(request)
            return request

    def _enqueue(self, request):
        """Insert keeping arrival order (a preempted request re-enters
        at its original arrival position — it lost its cache, not its
        place in line)."""
        i = len(self._queue)
        while i > 0 and self._queue[i - 1].arrival_t > request.arrival_t:
            i -= 1
        self._queue.insert(i, request)
        _M_QUEUE.set(len(self._queue))

    # -- the per-step decision -----------------------------------------------
    def schedule(self):
        """Build this step's Batch: decodes first (1 token each), then
        admissions in arrival order while token budget, batch slots,
        and KV pages remain."""
        with self._lock:
            batch = Batch()
            budget = self.token_budget
            for r in self._running:
                if budget <= 0:
                    break
                if self.max_batch and \
                        len(batch.decodes) >= self.max_batch:
                    break
                batch.decodes.append(r)
                budget -= 1
            while self._queue and budget > 0:
                if self.max_batch and len(batch.decodes) + \
                        len(batch.prefills) >= self.max_batch:
                    break
                nxt = self._queue[0]
                cost = len(nxt.context)
                if cost > self.cache.max_seq_len:
                    # scheduler-direct submission of an unservable prompt
                    # (ServeEngine.submit rejects these at the door):
                    # reject it terminally instead of letting cache.alloc
                    # ValueError out of schedule() — which would kill the
                    # serve loop and strand the popped request stateless.
                    # A terminal path must stay observable like every
                    # other: counter + journal request record
                    self._queue.pop(0)
                    nxt.state = CANCELLED
                    nxt.finish_t = self.clock()
                    _M_REJECTED.inc()
                    from ..obs import journal as _journal

                    if _journal.ACTIVE is not None:
                        _journal.ACTIVE.record_request(
                            rid=nxt.rid, state=CANCELLED,
                            arrival_t=nxt.arrival_t,
                            finish_t=nxt.finish_t,
                            prompt_tokens=len(nxt.prompt),
                            output_tokens=len(nxt.generated),
                            preemptions=nxt.preemptions,
                            tenant=nxt.tenant,
                            rejected="context exceeds max_seq_len")
                    continue
                if cost > budget:
                    break  # strict FIFO: never skip ahead of the blocked head
                # +1 token of headroom: don't admit a prompt that exactly
                # fills its pages into an instantly-stalling state — but
                # ONLY when the request will actually grow past `cost`
                # (a preemption-resumed context already at its deepest,
                # prompt + max_new - 1, needs no headroom; demanding it
                # would refuse a capacity-boundary request forever).
                # Best effort — the page is checked, not reserved, so a
                # later admission in this same loop may still consume it
                # (preemption then relieves the stall as usual)
                worst = len(nxt.prompt) + nxt.max_new_tokens - 1
                if not self.cache.can_alloc(cost + 1 if worst > cost
                                            else cost):
                    break
                self._queue.pop(0)
                self.cache.alloc(nxt.rid, cost)
                nxt.state = RUNNING
                resumed = nxt.admit_t is not None
                if not resumed:           # a preemption resume keeps the
                    nxt.admit_t = self.clock()  # original admission time
                else:
                    # close the open preempt interval: preemption-loss
                    # attribution pairs resume_ts[i] with preempt_ts[i]
                    nxt.resume_ts.append(self.clock())
                nxt.pages_peak = max(nxt.pages_peak,
                                     len(self.cache.page_table(nxt.rid)))
                self._running.append(nxt)
                batch.prefills.append(nxt)
                budget -= cost
                _M_ADMITTED.inc()
                from ..obs import journal as _journal

                if _journal.ACTIVE is not None:
                    # reqtrace lifecycle edge: scheduler admission (the
                    # journal lock nests under the scheduler's, leaf)
                    _journal.ACTIVE.event(
                        "req.admit", rid=nxt.rid, at=nxt.resume_ts[-1]
                        if resumed else nxt.admit_t, resumed=resumed)
            _M_QUEUE.set(len(self._queue))
            _M_RUNNING.set(len(self._running))
            return batch

    # -- growth + pressure ---------------------------------------------------
    def extend(self, request, n_tokens=1):
        """Grow ``request`` by ``n_tokens`` in the KV cache; page
        pressure surfaces as ``CachePressureError`` (retryable — the
        engine relieves it via ``preempt_for``)."""
        with self._lock:
            try:
                new = self.cache.extend(request.rid, n_tokens)
            except PageAllocationError as e:
                raise CachePressureError(str(e)) from e
            request.pages_peak = max(
                request.pages_peak,
                len(self.cache.page_table(request.rid)))
            return new

    def preempt_for(self, request):
        """Relieve page pressure for ``request``: preempt the YOUNGEST
        running request other than the requester — and never the
        oldest (the oldest always makes forward progress, which is
        what rules out preemption livelock). Returns the victim, or
        None when no one else is preemptable — the engine then
        self-preempts the requester (it IS the youngest)."""
        with self._lock:
            if not self._running:
                return None
            victims = [r for r in self._running[1:] if r is not request]
            if not victims:
                return None
            victim = victims[-1]
            self._preempt(victim)
            return victim

    def preempt(self, victim):
        """Preempt ``victim`` directly (the engine's last resort when
        relief for the victim itself ran out of budget)."""
        self._preempt(victim)

    def _preempt(self, victim):
        with self._lock:
            return self._preempt_locked(victim)

    def _preempt_locked(self, victim):
        self.cache.free(victim.rid)
        self._running.remove(victim)
        victim.state = PREEMPTED
        victim.preemptions += 1
        victim.preempt_ts.append(self.clock())
        self.preemptions += 1
        _M_PREEMPTED.inc()
        self._enqueue(victim)
        _M_RUNNING.set(len(self._running))
        from ..obs import journal as _journal

        if _journal.ACTIVE is not None:
            # reqtrace lifecycle edge: preemption start (the matching
            # resume is the req.admit event with resumed=True)
            _journal.ACTIVE.event("req.preempt", rid=victim.rid,
                                  at=victim.preempt_ts[-1],
                                  preemptions=victim.preemptions)

    # -- teardown ------------------------------------------------------------
    def finish(self, request, state=FINISHED):
        """Release a request's pages and drop it from the running set
        (normal completion, cancellation, or a chaos-killed request —
        one teardown path, so alloc==free holds in every exit)."""
        with self._lock:
            self.cache.free(request.rid)
            if request in self._running:
                self._running.remove(request)
            if request in self._queue:
                self._queue.remove(request)
            request.state = state
            request.finish_t = self.clock()
            _M_QUEUE.set(len(self._queue))
            _M_RUNNING.set(len(self._running))

    # -- introspection -------------------------------------------------------
    @property
    def queue_depth(self):
        with self._lock:
            return len(self._queue)

    @property
    def running(self):
        with self._lock:
            return list(self._running)

    @property
    def idle(self):
        with self._lock:
            return not self._queue and not self._running
