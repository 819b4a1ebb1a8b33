"""Load-aware request router over a pool of serve replicas.

The fleet control plane (the dispatch layer the Ragged Paged
Attention trajectory, arXiv 2604.15464, assumes above the per-replica
kernel). One ``Router`` fronts N
replicas — in-process ``ServeEngine``s or worker processes
(``pool.ReplicaPool``) — and decides, per request, WHICH replica
serves it:

- **Least-outstanding-tokens dispatch.** A request's load estimate is
  ``len(prompt) + max_new_tokens`` (the tokens the replica will hold
  and produce); it goes to the accepting replica with the smallest
  outstanding total, ties broken by LOWEST replica id — so dispatch
  traces are deterministic, not "whichever polled first".
- **Per-tenant fairness + rate limits**, layered ON TOP of each
  replica's token-budget scheduler: every tenant has an arrival-order
  queue; a token-bucket rate limit (injectable clock) holds a tenant's
  head back without blocking anyone else, and among rate-eligible
  tenants the one with the smallest served-tokens/weight deficit
  dispatches next (weighted deficit round-robin). One tenant flooding
  the fleet cannot starve another; within a tenant, arrival order is
  strict.
- **Requeue without losing your place.** When a replica dies (or is
  killed by the pool's heartbeat watchdog) its in-flight requests
  requeue by ORIGINAL arrival time, keeping their first-dispatch
  ``admit_t`` — the router-level mirror of the scheduler's preemption
  rule ("a preempted request loses its cache, not its place"). Decode
  is deterministic, so a re-dispatched request still finishes
  token-for-token identical to the single-engine oracle.
- **Admission control at the door.** Oversize / never-schedulable
  requests are rejected with the SAME semantics as
  ``ServeEngine.submit`` (vocab range, ``max_seq_len``,
  ``token_budget``) — an unservable request must not gridlock a
  replica's FIFO head.

Deterministic under an injectable clock: every timestamp and rate
decision comes from ``clock()`` (default ``time.monotonic``), so tests
drive a ``ManualClock`` and assert EXACT dispatch traces. Router truth
lands in ``fleet.router.*`` metrics, ``obs.export.router_lines``
gauges (scraped == ``stats()`` bitwise), and — when a run journal is
active — ``router.*`` events that ``obs.fleet.router_summary``
summarizes.

**Concurrency contract** (checked by ``obs.lockdep``): the Router itself
is single-threaded — one thread owns
``dispatch()``/``pump()``/``poll()``; it holds NO lock of its own. The
fleet lock order is **router → pool → replica**: the only lock on this
control plane is each ``ProcessReplica``'s events lock (class
``fleet.replica_events``), a leaf taken briefly by the router thread
(consume) and the replica's reader thread (produce). Never journal,
scrape, sleep, or call back into the pool while holding it.
"""
from __future__ import annotations

import itertools
import time
from collections import deque

from ...obs import journal as _journal
from ...obs import metrics as _metrics
from ..scheduler import CANCELLED, FINISHED, QUEUED

__all__ = ["FleetRequest", "TenantPolicy", "TokenBucket", "Router",
           "DISPATCHED", "REJECTED"]

DISPATCHED = "DISPATCHED"
REJECTED = "REJECTED"

# process-wide counters live under serving.router.* — the
# fleet_router_* exposition namespace belongs to obs.export.router_lines
# (per-Router truth); sharing one family name would put a counter and a
# gauge with different values under the same Prometheus family, which a
# real server rejects as an invalid exposition
_M_DISPATCHED = _metrics.counter("serving.router.dispatched")
_M_REQUEUED = _metrics.counter("serving.router.requeued")
_M_REJECTED = _metrics.counter("serving.router.rejected")
_M_COMPLETED = _metrics.counter("serving.router.completed")
_M_QUEUE = _metrics.gauge("serving.router.queue_depth")
_M_REPLICAS = _metrics.gauge("serving.router.replicas")
_M_SCALE_UP = _metrics.counter("serving.router.scale_ups")
_M_SCALE_DOWN = _metrics.counter("serving.router.scale_downs")

_frid_counter = itertools.count()
_trace_counter = itertools.count()


class FleetRequest:
    """One routed request: the router-level lifecycle record (the
    per-replica ``scheduler.Request`` is the replica's own view)."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_id", "tenant",
                 "state", "arrival_t", "admit_t", "first_token_t",
                 "finish_t", "replica_id", "tokens", "requeues",
                 "preemptions", "dispatches", "trace_id", "requeue_ts",
                 "rate_hold_t", "rate_wait")

    def __init__(self, prompt, max_new_tokens=16, rid=None, eos_id=None,
                 tenant="default", arrival_t=None):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.rid = rid if rid is not None else f"fr-{next(_frid_counter)}"
        self.eos_id = eos_id
        self.tenant = str(tenant)
        self.state = QUEUED
        self.arrival_t = arrival_t
        self.admit_t = None          # first dispatch; requeue keeps it
        self.first_token_t = None
        self.finish_t = None
        self.replica_id = None       # current / last replica
        self.tokens = []             # generated tokens once finished
        self.requeues = 0
        self.preemptions = 0         # in-replica preemptions, reported back
        self.dispatches = []         # [(t, replica_id)] — the trace
        # request-scoped tracing (obs.reqtrace): one trace id per
        # routed request, minted here and propagated through dispatch
        # into the replica's engine Request (both pool modes)
        self.trace_id = f"tr-{next(_trace_counter):06d}-{self.rid}"
        self.requeue_ts = []         # [t] — when a dead replica stranded it
        # tenant-bucket wait accounting: rate_hold_t is the open
        # hold's start (the head was rate-blocked at that clock),
        # rate_wait accumulates closed holds in seconds
        self.rate_hold_t = None
        self.rate_wait = 0.0

    @property
    def cost(self):
        """Outstanding-token load estimate: tokens the replica must
        hold + produce (prompt prefill + full decode budget)."""
        return len(self.prompt) + self.max_new_tokens

    def __repr__(self):
        return (f"FleetRequest({self.rid!r}, tenant={self.tenant!r}, "
                f"state={self.state}, replica={self.replica_id})")


class TenantPolicy:
    """Per-tenant dispatch policy: ``weight`` scales the fairness share
    (a weight-2 tenant gets 2x the tokens of a weight-1 tenant under
    contention); ``rate``/``burst`` bound its token throughput via a
    :class:`TokenBucket` (None = unlimited)."""

    def __init__(self, weight=1.0, rate=None, burst=None):
        self.weight = float(weight)
        if self.weight <= 0:
            raise ValueError("tenant weight must be > 0")
        self.rate = None if rate is None else float(rate)
        self.burst = burst

    def bucket(self, now):
        if self.rate is None:
            return None
        burst = self.burst if self.burst is not None else self.rate
        return TokenBucket(self.rate, burst, now=now)


class TokenBucket:
    """Deterministic token bucket on an injectable clock: starts full
    at ``burst`` tokens, refills at ``rate`` tokens/s."""

    def __init__(self, rate, burst, now=0.0):
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)
        self._last = float(now)

    def _refill(self, now):
        if now > self._last:
            self.level = min(self.burst,
                             self.level + (now - self._last) * self.rate)
            self._last = now

    def peek(self, n, now):
        self._refill(now)
        return self.level >= float(n)

    def take(self, n, now):
        self._refill(now)
        if self.level < float(n):
            return False
        self.level -= float(n)
        return True


class Router:
    """SLO-aware dispatch over a :class:`~.pool.ReplicaPool`.

    >>> pool = ReplicaPool(ReplicaSpec(...), replicas=2)
    >>> router = Router(pool)
    >>> r = router.submit([3, 1, 4], max_new_tokens=8)
    >>> router.run_until_drained()
    >>> r.tokens

    The driving loop is explicit (``dispatch``/``poll``/
    ``check_replicas`` — or the ``step()``/``run_until_drained()``
    conveniences) so tests can interleave clock advances with single
    decisions and assert exact traces.
    """

    def __init__(self, pool, clock=None, tenants=None,
                 max_outstanding_per_replica=None, autoscaler=None,
                 autoscale_interval_s=1.0, slo=None):
        self.pool = pool
        self.clock = clock if clock is not None \
            else getattr(pool, "default_clock", time.monotonic)
        self.tenants = dict(tenants or {})
        self.max_outstanding = (None if max_outstanding_per_replica
                                is None
                                else int(max_outstanding_per_replica))
        self.autoscaler = autoscaler
        # step() observes the autoscaler at most once per interval: an
        # observation costs a full exposition build — for process pools
        # one HTTP scrape per replica — which a per-step loop would pay
        # hundreds of times per cooldown window for guaranteed no-ops
        self.autoscale_interval_s = float(autoscale_interval_s)
        self._next_autoscale_t = None
        # live SLO engine (obs.slo.SLOEvaluator): fed on the SAME
        # throttled tick from the SAME exposition the autoscaler
        # consumes — attaching SLO evaluation adds ZERO scrapes. With
        # slo=None the serve loop never touches obs.slo/obs.timeseries
        # (the zero-overhead poison test pins it).
        self.slo = slo
        # bounded plain-data trail of scale/requeue decisions for the
        # live /statusz pane (the journal stays the durable record)
        self.recent_events = deque(maxlen=64)
        self._queues = {}      # tenant -> [FleetRequest] arrival order
        self._buckets = {}     # tenant -> ((rate, burst), TokenBucket|None)
        self._default_policy = TenantPolicy()
        self._served = {}      # tenant -> tokens dispatched
        # per-tenant outcome counters (obs.usage.router_tenant_usage
        # reads these pull-only for the chargeback/fairness rollup)
        self._rejected_by_tenant = {}    # tenant -> rejects
        self._rate_holds_by_tenant = {}  # tenant -> hold episodes
        self._requeued_by_tenant = {}    # tenant -> requeues
        self._inflight = {}    # rid -> FleetRequest
        self.completed = []    # FINISHED/CANCELLED FleetRequests
        self.trace = []        # [{"t", "rid", "replica", "tenant"}]
        self.dispatched = 0
        self.requeued = 0
        self.rejected = 0
        self.scale_ups = 0
        self.scale_downs = 0
        _M_REPLICAS.set(len(pool.active()))

    # -- intake --------------------------------------------------------------
    def _policy(self, tenant):
        return self.tenants.get(tenant) or self._default_policy

    def submit(self, prompt, max_new_tokens=16, rid=None, eos_id=None,
               tenant="default", arrival_t=None):
        """Queue one request. Raises ``ValueError`` with the single-
        engine ``ServeEngine.submit`` semantics for requests no replica
        could ever serve (and counts them as rejected)."""
        req = FleetRequest(prompt, max_new_tokens=max_new_tokens,
                           rid=rid, eos_id=eos_id, tenant=tenant,
                           arrival_t=arrival_t)
        if req.arrival_t is None:
            req.arrival_t = self.clock()
        spec = self.pool.spec
        try:
            if req.rid in self._inflight or any(
                    q.rid == req.rid for qs in self._queues.values()
                    for q in qs):
                # a second live 'x' would silently overwrite the first
                # in the in-flight book, stranding one request forever
                # and stamping the other with the wrong tokens
                raise ValueError(
                    f"rid {req.rid!r} is already queued or in flight")
            if not req.prompt:
                raise ValueError("empty prompt")
            if req.max_new_tokens < 1:
                raise ValueError("max_new_tokens must be >= 1")
            if any(not 0 <= t < spec.vocab_size for t in req.prompt):
                raise ValueError("prompt token out of vocab range")
            worst = len(req.prompt) + req.max_new_tokens - 1
            if worst > spec.effective_max_seq_len:
                raise ValueError(
                    f"request needs up to {worst} cached tokens > "
                    f"max_seq_len {spec.effective_max_seq_len}")
            if worst > spec.token_budget:
                raise ValueError(
                    f"request may re-prefill up to {worst} tokens > "
                    f"token_budget {spec.token_budget}: it could never "
                    "be (re-)admitted on any replica")
            pol = self._policy(req.tenant)
            if pol.rate is not None:
                burst = pol.burst if pol.burst is not None else pol.rate
                if req.cost > burst:
                    # the bucket caps at burst: a costlier request
                    # would sit at the tenant head FOREVER — the same
                    # silent-starvation class the token_budget check
                    # rejects, one layer up
                    raise ValueError(
                        f"request costs {req.cost} tokens > tenant "
                        f"{req.tenant!r} burst capacity {burst:g}: its "
                        "rate bucket could never afford it")
        except ValueError as e:
            req.state = REJECTED
            self.rejected += 1
            self._rejected_by_tenant[req.tenant] = \
                self._rejected_by_tenant.get(req.tenant, 0) + 1
            _M_REJECTED.inc()
            if _journal.ACTIVE is not None:
                _journal.ACTIVE.event("router.reject", rid=req.rid,
                                      tenant=req.tenant, reason=str(e))
            raise
        self._enqueue(req)
        if _journal.ACTIVE is not None:
            # reqtrace lifecycle edge: the routed request exists — the
            # anchor every later req.* event joins on (by rid)
            _journal.ACTIVE.event(
                "req.submit", rid=req.rid, at=req.arrival_t,
                tenant=req.tenant, trace=req.trace_id, cost=req.cost,
                prompt_tokens=len(req.prompt))
        return req

    def _enqueue(self, req):
        """Insert into the tenant queue keeping arrival order (a
        requeued request re-enters at its original arrival position)."""
        q = self._queues.setdefault(req.tenant, [])
        i = len(q)
        while i > 0 and q[i - 1].arrival_t > req.arrival_t:
            i -= 1
        q.insert(i, req)
        req.state = QUEUED
        _M_QUEUE.set(self.queue_depth)

    # -- the dispatch decision -----------------------------------------------
    def _eligible_tenants(self, now):
        out = []
        for tenant, q in self._queues.items():
            if not q:
                continue
            pol = self._policy(tenant)
            key = (pol.rate, pol.burst)
            cached = self._buckets.get(tenant)
            if cached is None or cached[0] != key:
                # rebuild on rate/burst CHANGE, not just first sight:
                # changing a live tenant's limits (new rate/burst,
                # unlimited <-> rated) must take effect, not serve a
                # stale bucket forever. Compared against a VALUE
                # snapshot taken at cache time — catching in-place
                # policy mutation as well as entry replacement — while
                # a config reloader rebuilding equal policies each
                # interval keeps the bucket level (no wiping the
                # tenant's accumulated rate debt)
                cached = (key, pol.bucket(now))
                self._buckets[tenant] = cached
            bucket = cached[1]
            if bucket is not None:
                # a queued request costlier than the bucket's capacity
                # can NEVER dispatch (the bucket caps at burst). The
                # submit-time burst guard only saw the policy of its
                # moment — a live rate-limit change (or a requeue into
                # a since-tightened tenant) can strand a head that
                # would gridlock the tenant forever: evict as rejected
                while q and q[0].cost > bucket.burst:
                    head = q.pop(0)
                    head.state = REJECTED
                    self.rejected += 1
                    self._rejected_by_tenant[tenant] = \
                        self._rejected_by_tenant.get(tenant, 0) + 1
                    _M_REJECTED.inc()
                    if _journal.ACTIVE is not None:
                        _journal.ACTIVE.event(
                            "router.reject", rid=head.rid,
                            tenant=tenant,
                            reason=f"cost {head.cost} > tenant burst "
                                   f"{bucket.burst:g} (policy changed "
                                   "after queue)")
                if not q:
                    continue
                head = q[0]
                if not bucket.peek(head.cost, now):
                    # tenant-bucket wait starts (once per queueing
                    # episode): the head is dispatchable but its
                    # tenant's rate bucket cannot yet afford it
                    if head.rate_hold_t is None:
                        head.rate_hold_t = now
                        self._rate_holds_by_tenant[tenant] = \
                            self._rate_holds_by_tenant.get(tenant, 0) + 1
                        if _journal.ACTIVE is not None:
                            _journal.ACTIVE.event(
                                "req.rate_hold", rid=head.rid, at=now,
                                tenant=tenant)
                    continue
                if head.rate_hold_t is not None:
                    # the bucket refilled: the hold closes HERE — time
                    # past this point (e.g. waiting for a replica slot)
                    # is router-queue wait, not rate-limit wait
                    head.rate_wait += now - head.rate_hold_t
                    head.rate_hold_t = None
            deficit = self._served.get(tenant, 0.0) / pol.weight
            out.append((deficit, tenant))
        return sorted(out)

    def _pick_replica(self, cost):
        """Accepting replica with the least outstanding tokens (and
        room under ``max_outstanding_per_replica``); lowest id on a
        tie — THE determinism rule the dispatch-trace tests pin."""
        best = None
        for rep in self.pool.active():
            if self.max_outstanding is not None and \
                    rep.outstanding_tokens + cost > self.max_outstanding:
                continue
            key = (rep.outstanding_tokens, rep.replica_id)
            if best is None or key < best[0]:
                best = (key, rep)
        return best[1] if best else None

    def dispatch(self, now=None):
        """Dispatch as many queued requests as policy allows; returns
        the ``(rid, replica_id)`` pairs dispatched, in order."""
        now = self.clock() if now is None else now
        out = []
        while True:
            cands = self._eligible_tenants(now)
            placed = False
            for _, tenant in cands:
                head = self._queues[tenant][0]
                rep = self._pick_replica(head.cost)
                if rep is None:
                    # no replica can take this head; a LARGER head
                    # elsewhere can't fit either, but a smaller one
                    # might — keep scanning tenants in deficit order
                    # (within a tenant, arrival order stays strict)
                    continue
                self._queues[tenant].pop(0)
                cached = self._buckets.get(tenant)
                bucket = cached[1] if cached else None
                if bucket is not None:
                    bucket.take(head.cost, now)
                self._served[tenant] = \
                    self._served.get(tenant, 0.0) + head.cost
                self._dispatch_one(head, rep, now)
                out.append((head.rid, rep.replica_id))
                placed = True
                break
            if not placed:
                break
        _M_QUEUE.set(self.queue_depth)
        return out

    def _dispatch_one(self, req, rep, now):
        req.state = DISPATCHED
        req.replica_id = rep.replica_id
        if req.admit_t is None:   # a requeue keeps the ORIGINAL admit
            req.admit_t = now
        if req.rate_hold_t is not None:   # belt-and-braces close
            req.rate_wait += now - req.rate_hold_t
            req.rate_hold_t = None
        req.dispatches.append((now, rep.replica_id))
        self._inflight[req.rid] = req
        self.dispatched += 1
        _M_DISPATCHED.inc()
        self.trace.append({"t": now, "rid": req.rid,
                           "replica": rep.replica_id,
                           "tenant": req.tenant})
        if _journal.ACTIVE is not None:
            # reqtrace lifecycle edge: dispatch segment N starts on
            # this replica's lane; rate_wait_ms is CUMULATIVE across
            # the request's queueing episodes (assembly reads the last)
            _journal.ACTIVE.event(
                "req.dispatch", rid=req.rid, at=now,
                replica=rep.replica_id, seq=len(req.dispatches),
                rate_wait_ms=req.rate_wait * 1e3, trace=req.trace_id)
        rep.submit(req)

    # -- completion + failure ------------------------------------------------
    def poll(self, now=None):
        """Collect finished requests from every replica; returns the
        newly completed ``FleetRequest``s. Also retires replicas whose
        scale-down drain just emptied."""
        done = []
        for rep in list(self.pool.replicas):
            for res in rep.poll():
                req = self._inflight.pop(res["rid"], None)
                if req is None:
                    continue  # cancelled/unknown: replica-side record
                req.state = res.get("state", FINISHED)
                req.tokens = list(res.get("tokens") or [])
                req.first_token_t = res.get("first_token_t")
                req.finish_t = res.get("finish_t")
                req.preemptions += int(res.get("preemptions") or 0)
                self.completed.append(req)
                _M_COMPLETED.inc()
                done.append(req)
            if rep.draining and rep.inflight_count == 0 and \
                    rep.state not in ("DEAD", "RETIRED"):
                self.pool.retire(rep)
                if _journal.ACTIVE is not None:
                    _journal.ACTIVE.event("router.scale",
                                          direction="down_complete",
                                          replica=rep.replica_id)
        _M_REPLICAS.set(len(self.pool.active()))
        return done

    def check_replicas(self, now=None):
        """Health-sweep the pool: a dead (or watchdog-killed hung)
        replica's in-flight requests requeue by original arrival, then
        the pool relaunches it warm (``ReplicaSupervisor`` budget +
        backoff) — unless it was a scale-down drain, which just
        retires. Returns ``[(replica_id, reason, n_requeued)]``."""
        now = self.clock() if now is None else now
        out = []
        for rep, reason in self.pool.check_health(now):
            stranded = [self._inflight.pop(r.rid)
                        for r in rep.take_inflight()
                        if r.rid in self._inflight]
            for req in sorted(stranded, key=lambda r: r.arrival_t):
                req.requeues += 1
                req.requeue_ts.append(now)
                self.requeued += 1
                self._requeued_by_tenant[req.tenant] = \
                    self._requeued_by_tenant.get(req.tenant, 0) + 1
                _M_REQUEUED.inc()
                self._enqueue(req)
                if _journal.ACTIVE is not None:
                    # reqtrace lifecycle edge: the dispatch segment on
                    # the dead replica ends here (per-rid twin of the
                    # aggregate router.requeue event below)
                    _journal.ACTIVE.event(
                        "req.requeue", rid=req.rid, at=now,
                        replica=rep.replica_id, reason=reason)
            if _journal.ACTIVE is not None:
                _journal.ACTIVE.event(
                    "router.requeue", replica=rep.replica_id,
                    reason=reason, rids=[r.rid for r in stranded])
            self.recent_events.append(
                {"t": now, "kind": "requeue",
                 "replica": rep.replica_id, "reason": reason,
                 "requeued": len(stranded)})
            if rep.draining:
                self.pool.retire(rep)
            else:
                self.pool.relaunch(rep)
            out.append((rep.replica_id, reason, len(stranded)))
        if out:
            _M_REPLICAS.set(len(self.pool.active()))
        return out

    # -- autoscaling ---------------------------------------------------------
    def exposition(self):
        """The fleet's live signal plane as ONE Prometheus exposition:
        router gauges + every replica's SLO gauges — same-process
        engines directly, worker processes scraped-and-merged from
        their per-replica exporters (``obs.export``'s multi-process
        path). This text IS what the autoscaler consumes."""
        from ...obs import export as _export

        texts = ["\n".join(_export.router_lines(self)) + "\n"]
        engines = self.pool.local_engines()
        texts.append("\n".join(
            _export.tenant_lines(router=self, engines=engines)) + "\n")
        if engines:
            texts.append(
                "\n".join(_export.slo_lines(engines=engines)) + "\n")
        for target in self.pool.scrape_targets():
            try:
                texts.append(_export.scrape(target))
            except Exception:
                continue  # a mid-restart replica just misses one tick
        return _export.merge_expositions(texts)

    def autoscale_tick(self, now=None, exposition=None):
        """One autoscaler observation over the live scrape: ``"up"``
        launches a warm replica, ``"down"`` DRAINS the least-loaded one
        (never kills mid-decode; ``poll`` retires it once empty).
        ``exposition`` lets ``step()`` hand in the text it already
        built for this tick (shared with the SLO evaluator) instead of
        paying a second scrape sweep."""
        if self.autoscaler is None:
            return None
        from .autoscale import Autoscaler

        now = self.clock() if now is None else now
        if exposition is None:
            exposition = self.exposition()
        signals = Autoscaler.signals_from_scrape(exposition)
        signals.setdefault("queue_depth", float(self.queue_depth))
        n = len(self.pool.active())
        # the pool's own max_replicas can sit BELOW the autoscaler's,
        # and its capacity counts STARTING/DRAINING replicas and
        # backoff-pending relaunches that n (accepting only) misses:
        # clamp INSIDE observe so a can't-scale tick is a clean hold —
        # no cooldown burned, no breach streak reset — instead of a
        # crash of the serve loop or a committed phantom "up"
        headroom = self.pool.headroom()
        decision = self.autoscaler.observe(
            signals, replicas=n, now=now,
            max_replicas=None if headroom is None else n + headroom)
        if decision == "up":
            rep = self.pool.scale_up(wait=False)
            self.scale_ups += 1
            _M_SCALE_UP.inc()
            _M_REPLICAS.set(len(self.pool.active()))
            if _journal.ACTIVE is not None:
                _journal.ACTIVE.event("router.scale", direction="up",
                                      replica=rep.replica_id,
                                      replicas=len(self.pool.active()))
            self.recent_events.append(
                {"t": now, "kind": "scale_up",
                 "replica": rep.replica_id})
        elif decision == "down":
            active = self.pool.active()
            if len(active) > 1:
                rep = min(active, key=lambda r: (r.outstanding_tokens,
                                                 r.replica_id))
                rep.drain()
                self.scale_downs += 1
                _M_SCALE_DOWN.inc()
                if _journal.ACTIVE is not None:
                    _journal.ACTIVE.event(
                        "router.scale", direction="down",
                        replica=rep.replica_id,
                        replicas=len(self.pool.active()))
                self.recent_events.append(
                    {"t": now, "kind": "scale_down",
                     "replica": rep.replica_id})
            else:
                decision = None  # never drain the last replica
        return decision

    # -- driving loops -------------------------------------------------------
    def step(self, now=None):
        """One router iteration: health sweep (requeue + relaunch),
        dispatch, pump in-process replicas one engine step, collect
        completions. Returns the newly completed requests."""
        now = self.clock() if now is None else now
        self.check_replicas(now)
        self.dispatch(now)
        self.pool.pump()
        done = self.poll(now)
        if (self.autoscaler is not None or self.slo is not None) \
                and (self._next_autoscale_t is None
                     or now >= self._next_autoscale_t):
            self._next_autoscale_t = now + self.autoscale_interval_s
            # ONE exposition per throttled tick, shared by the
            # autoscaler and the SLO evaluator: attaching SLO
            # monitoring must not change the scrape budget
            text = self.exposition()
            if self.autoscaler is not None:
                self.autoscale_tick(now, exposition=text)
            if self.slo is not None:
                # fairness rides the same throttled tick: tenant_hog
                # sees measured-vs-weight shares next to the latency
                # signals, at zero extra scrape cost
                from ...obs import usage as _usage
                self.slo.observe(text=text, now=now,
                                 extra=_usage.fairness_record(self))
        return done

    def run_until_drained(self, timeout_s=120.0, sleep_s=0.0):
        """Drive ``step()`` until every submitted request reached a
        terminal state (or ``timeout_s`` of wall time passed — the
        loop bound for process pools whose work happens elsewhere).
        Returns the number of requests completed."""
        deadline = time.monotonic() + float(timeout_s)
        n0 = len(self.completed)
        while self._inflight or self.queue_depth:
            self.step()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"router did not drain in {timeout_s}s: "
                    f"{len(self._inflight)} in flight, "
                    f"{self.queue_depth} queued")
            if sleep_s and (self._inflight or self.queue_depth):
                time.sleep(sleep_s)
        return len(self.completed) - n0

    # -- introspection -------------------------------------------------------
    @property
    def queue_depth(self):
        return sum(len(q) for q in self._queues.values())

    @property
    def inflight(self):
        return len(self._inflight)

    def stats(self):
        """Router truth (plain data): dispatch/requeue/reject counts,
        per-replica outstanding, per-tenant token shares, scale events,
        and exact latency percentiles over completed requests — the
        numbers ``obs.export.router_lines`` must reproduce bitwise."""
        from ...obs.metrics import exact_percentile

        served_total = sum(self._served.values())
        out = {
            "queue_depth": self.queue_depth,
            "inflight": len(self._inflight),
            "dispatched": self.dispatched,
            "requeued": self.requeued,
            "rejected": self.rejected,
            "completed": len(self.completed),
            "replicas": len(self.pool.active()),
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "per_replica": {
                rep.replica_id: {
                    "state": rep.state,
                    "outstanding_tokens": rep.outstanding_tokens,
                    "inflight": rep.inflight_count,
                }
                for rep in self.pool.replicas
            },
            "tenants": {
                t: {"served_tokens": served,
                    "share": (served / served_total) if served_total
                    else 0.0,
                    "weight": self._policy(t).weight,
                    "queued": len(self._queues.get(t) or [])}
                for t, served in sorted(self._served.items())
            },
        }
        fin = [r for r in self.completed if r.state == FINISHED]
        lat = {
            "ttft_ms": [(r.first_token_t - r.arrival_t) * 1e3
                        for r in fin if r.first_token_t is not None
                        and r.arrival_t is not None],
            "e2e_ms": [(r.finish_t - r.arrival_t) * 1e3 for r in fin
                       if r.finish_t is not None
                       and r.arrival_t is not None],
            "tpot_ms": [(r.finish_t - r.first_token_t) * 1e3 /
                        (len(r.tokens) - 1) for r in fin
                        if len(r.tokens) > 1
                        and r.first_token_t is not None
                        and r.finish_t is not None],
        }
        for name, xs in lat.items():
            if xs:
                out[name] = {"count": len(xs),
                             "p50": exact_percentile(xs, 50),
                             "p99": exact_percentile(xs, 99)}
        return out

    def journal_summary(self):
        """One ``router.summary`` event with the final truth (the
        record ``run_report``/``fleet_report`` render); last wins."""
        if _journal.ACTIVE is None:
            return
        st = self.stats()
        _journal.ACTIVE.event(
            "router.summary", dispatched=st["dispatched"],
            requeued=st["requeued"], rejected=st["rejected"],
            completed=st["completed"], replicas=st["replicas"],
            scale_ups=st["scale_ups"], scale_downs=st["scale_downs"],
            tenants={t: round(v["share"], 6)
                     for t, v in st["tenants"].items()},
            ttft_p99_ms=(st.get("ttft_ms") or {}).get("p99"))
        # full per-tenant rollup (weights, shares, outcomes, latency
        # percentiles) for the chargeback/fairness readers — a second
        # event so router.summary's shape (and every report pinned to
        # it) stays byte-compatible
        from ...obs import usage as _usage

        tu = _usage.router_tenant_usage(self)
        _journal.ACTIVE.event("tenant.summary",
                              served_total=tu["served_total"],
                              tenants=tu["tenants"])

    def close(self):
        """Journal the summary and shut the pool down (drain-free stop:
        callers wanting a graceful end drain first)."""
        self.journal_summary()
        if self.slo is not None:
            self.slo.journal_summary()
        self.pool.shutdown()
