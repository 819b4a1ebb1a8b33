"""Per-tenant usage metering, cost attribution, and fairness auditing.

The chargeback plane for serving: serving is priced in device-seconds
and KV-page occupancy — the capacity currency of Ragged Paged Attention
(arXiv 2604.15464) — so every request must answer "which tenant, how
many device-nanoseconds, how many page-nanoseconds?".

Attribution model (everything in **integer nanoseconds** — integer
addition is exact and associative, so per-tenant sums telescope to the
replica totals *bitwise*, which float accumulation cannot promise):

- **Device-seconds** (:class:`UsageMeter`, attached to every
  ``ServeEngine`` as ``engine.usage``): each prefill's wall span is
  charged to its request; each decode step's span is split across the
  batch's live lanes by ``divmod`` (the first ``remainder`` lanes get
  one extra nanosecond), so ``sum(tenant device_ns) == sum(request
  device_ns) == busy_ns`` is an identity, not an approximation. A
  decode pass that ends with zero live lanes (every lane preempted)
  charged nobody and is *not* busy time — busy is defined as
  attributed compute.
- **KV page-seconds** (``PagedKVCache`` stamps, same clock as the
  scheduler): the cache integrates pages-held x time per sequence
  between alloc/extend/free, closing the integral on free — so the
  integrals ACCUMULATE across preempt/re-admit incarnations and
  alloc==free closure is asserted by ``cache.verify()``.

Everything else here is a **pull-only reader** (the zero-overhead
contract: the serve path never calls into this module; poisoned
readers must not perturb a routed lifecycle): per-engine and
per-router rollups, the fairness audit (measured served-token share vs
configured weight share), journal-record rollups for a post-hoc
chargeback table, and per-tenant SLO slices via
``obs.slo.evaluate_run``.
"""
from __future__ import annotations

from .metrics import exact_percentile

__all__ = ["DEFAULT_TENANT", "DEFAULT_FAIRNESS_DRIFT_THRESHOLD",
           "TickingClock", "UsageMeter", "engine_tenant_usage",
           "router_tenant_usage", "fairness_audit", "fairness_record",
           "rollup_requests", "merge_tenant_rollups",
           "tenant_slo_slices"]

DEFAULT_TENANT = "default"

# fairness gate: |measured served-token share - configured weight
# share| above this absolute threshold is a drift violation (a
# weight-0.25 tenant measured at 0.5 drifts by 0.25 and fires)
DEFAULT_FAIRNESS_DRIFT_THRESHOLD = 0.2


class TickingClock:
    """A ManualClock that also advances itself by a fixed ``tick`` on
    every read — so spans *inside* one engine step (which a plain
    ManualClock renders zero-width: nobody calls ``advance`` mid-step)
    are non-zero and fully deterministic. The default tick is a dyadic
    multiple of 1/512 s, which is integral in nanoseconds
    (``1e9 / 512 == 1953125``), so ManualClock fixtures stay exact to
    the nanosecond after the int conversion."""

    def __init__(self, start=0.0, tick=1.0 / 512):
        self.now = float(start)
        self.tick = float(tick)

    def __call__(self):
        t = self.now
        self.now = t + self.tick
        return t

    def advance(self, dt):
        self.now += float(dt)
        return self.now


def _ns(span_s):
    """Seconds -> integer nanoseconds (round-half-even like round())."""
    return int(round(float(span_s) * 1e9))


class UsageMeter:
    """Per-replica device-second attribution in integer nanoseconds.

    The engine charges it from ``step()`` (always-on plain-dict
    arithmetic, the same cost class as the ``serving.step_ms``
    histogram observe); everything else reads it pull-only.

    Invariants (``verify()``):

    - ``busy_ns == prefill_ns + decode_ns``
    - ``busy_ns == sum(device_ns.values())`` (per-tenant telescoping)
    - ``busy_ns == sum(request_ns.values())`` (per-request telescoping)
    """

    def __init__(self, replica_id=None):
        self.replica_id = replica_id
        self.busy_ns = 0
        self.prefill_ns = 0
        self.decode_ns = 0
        self.device_ns = {}      # tenant -> int ns
        self.request_ns = {}     # rid -> int ns
        self.tenant_of = {}      # rid -> resolved tenant
        self.prefills = 0        # prefill spans charged
        self.decode_steps = 0    # decode spans charged (>=1 live lane)

    def _charge(self, rid, tenant, ns):
        self.device_ns[tenant] = self.device_ns.get(tenant, 0) + ns
        self.request_ns[rid] = self.request_ns.get(rid, 0) + ns
        self.tenant_of[rid] = tenant

    def charge_prefill(self, req, span_s):
        """Charge one prefill's wall span wholly to its request."""
        ns = _ns(span_s)
        self.busy_ns += ns
        self.prefill_ns += ns
        self.prefills += 1
        self._charge(req.rid, req.tenant or DEFAULT_TENANT, ns)

    def charge_decode(self, reqs, span_s):
        """Split one decode step's wall span across its live lanes:
        ``divmod(ns, k)`` — the first ``remainder`` lanes (survivor
        order) carry one extra nanosecond, so the split is exact by
        construction. A zero-lane span charges nothing (and is not
        busy time — nothing computed)."""
        k = len(reqs)
        if not k:
            return
        ns = _ns(span_s)
        self.busy_ns += ns
        self.decode_ns += ns
        self.decode_steps += 1
        share, rem = divmod(ns, k)
        for i, req in enumerate(reqs):
            self._charge(req.rid, req.tenant or DEFAULT_TENANT,
                         share + (1 if i < rem else 0))

    def verify(self):
        """Assert the telescoping identities; returns True."""
        assert self.busy_ns == self.prefill_ns + self.decode_ns, \
            "busy != prefill + decode"
        assert self.busy_ns == sum(self.device_ns.values()), \
            "per-tenant device-ns do not telescope to busy"
        assert self.busy_ns == sum(self.request_ns.values()), \
            "per-request device-ns do not telescope to busy"
        return True

    def snapshot(self):
        """Plain-data copy (the ``stats()``-style view)."""
        return {
            "replica": self.replica_id,
            "busy_ns": self.busy_ns,
            "prefill_ns": self.prefill_ns,
            "decode_ns": self.decode_ns,
            "prefills": self.prefills,
            "decode_steps": self.decode_steps,
            "device_ns": dict(self.device_ns),
            "request_ns": dict(self.request_ns),
        }


# -- rollup plumbing ----------------------------------------------------------
_ZERO = {"requests": 0, "completed": 0, "cancelled": 0, "rejected": 0,
         "rate_holds": 0, "requeued": 0, "preempted_requests": 0,
         "preemptions": 0, "prompt_tokens": 0, "decode_tokens": 0,
         "device_ns": 0, "page_ns": 0}


def _slot(tenants, tenant):
    s = tenants.get(tenant)
    if s is None:
        s = dict(_ZERO)
        s["_lat"] = {"queue_ms": [], "ttft_ms": [], "tpot_ms": [],
                     "e2e_ms": []}
        tenants[tenant] = s
    return s


def _finalize(tenants):
    """Turn collected latency sample lists into exact percentiles
    (``exact_percentile`` — the same definition ``ServeEngine.stats()``
    and ``Router.stats()`` use) and drop the scratch lists."""
    for s in tenants.values():
        lat = s.pop("_lat", None) or {}
        for name, xs in lat.items():
            if xs:
                s[name + "_count"] = len(xs)
                s[name + "_p50"] = exact_percentile(xs, 50)
                s[name + "_p99"] = exact_percentile(xs, 99)
    return tenants


def _observe_latency(s, arrival_t=None, admit_t=None, first_token_t=None,
                     finish_t=None, n_generated=0):
    lat = s["_lat"]
    if arrival_t is not None and admit_t is not None:
        lat["queue_ms"].append((admit_t - arrival_t) * 1e3)
    if arrival_t is not None and first_token_t is not None:
        lat["ttft_ms"].append((first_token_t - arrival_t) * 1e3)
    if first_token_t is not None and finish_t is not None \
            and n_generated > 1:
        lat["tpot_ms"].append(
            (finish_t - first_token_t) * 1e3 / (n_generated - 1))
    if arrival_t is not None and finish_t is not None:
        lat["e2e_ms"].append((finish_t - arrival_t) * 1e3)


# -- live readers -------------------------------------------------------------
def engine_tenant_usage(engine):
    """Per-tenant rollup for ONE live engine (pull-only): outcomes,
    tokens and latency percentiles from ``engine.finished`` (the
    ``stats()`` discipline — exact, per-instance), device-ns from the
    meter, page-ns from the cache's closed integrals."""
    meter = engine.usage
    pu = engine.cache.page_usage()
    tenants = {}
    for r in engine.finished:
        s = _slot(tenants, r.tenant or DEFAULT_TENANT)
        s["requests"] += 1
        s["completed"] += 1
        if r.preemptions:
            s["preempted_requests"] += 1
            s["preemptions"] += r.preemptions
        s["prompt_tokens"] += len(r.prompt)
        s["decode_tokens"] += len(r.generated)
        _observe_latency(s, arrival_t=r.arrival_t, admit_t=r.admit_t,
                         first_token_t=r.first_token_t,
                         finish_t=r.finish_t,
                         n_generated=len(r.generated))
    for rid, ns in meter.request_ns.items():
        s = _slot(tenants, meter.tenant_of.get(rid, DEFAULT_TENANT))
        s["device_ns"] += ns
    for rid, ns in pu["closed_ns"].items():
        s = _slot(tenants, meter.tenant_of.get(rid, DEFAULT_TENANT))
        s["page_ns"] += ns
    return {
        "replica": engine.replica_id,
        "busy_ns": meter.busy_ns,
        "prefill_ns": meter.prefill_ns,
        "decode_ns": meter.decode_ns,
        "page_bytes": engine.cache.page_bytes,
        "page_open": len(pu["open"]),
        "seq_allocs": pu["seq_allocs"],
        "seq_frees": pu["seq_frees"],
        "tenants": _finalize(tenants),
    }


def router_tenant_usage(router):
    """Per-tenant router truth (pull-only): configured weight + weight
    share, measured served-token share, outcome counters, tokens, and
    latency percentiles over completed requests. The universe is every
    tenant that showed DEMAND (served, queued, completed, rejected, or
    rate-held); a configured-but-idle tenant carries no entitlement in
    this window (weight shares normalize over active tenants only —
    the weighted-deficit scheduler is work-conserving)."""
    served = dict(router._served)
    served_total = sum(served.values())
    tenants = {}
    for t in served:
        _slot(tenants, t)
    for t, q in router._queues.items():
        if q:
            _slot(tenants, t)["queued"] = len(q)
    for t, n in getattr(router, "_rejected_by_tenant", {}).items():
        _slot(tenants, t)["rejected"] = n
    for t, n in getattr(router, "_rate_holds_by_tenant", {}).items():
        _slot(tenants, t)["rate_holds"] = n
    for t, n in getattr(router, "_requeued_by_tenant", {}).items():
        _slot(tenants, t)["requeued"] = n
    for r in router.completed:
        s = _slot(tenants, r.tenant)
        s["requests"] += 1
        if r.state == "FINISHED":
            s["completed"] += 1
            s["prompt_tokens"] += len(r.prompt)
            s["decode_tokens"] += len(r.tokens)
            _observe_latency(s, arrival_t=r.arrival_t,
                             admit_t=r.admit_t,
                             first_token_t=r.first_token_t,
                             finish_t=r.finish_t,
                             n_generated=len(r.tokens))
        else:
            s["cancelled"] += 1
        if r.preemptions:
            s["preempted_requests"] += 1
            s["preemptions"] += r.preemptions
    weights = {t: router._policy(t).weight for t in tenants}
    wtotal = sum(weights.values())
    for t, s in tenants.items():
        s.setdefault("queued", 0)
        s["weight"] = weights[t]
        s["weight_share"] = (weights[t] / wtotal) if wtotal else 0.0
        s["served_tokens"] = served.get(t, 0.0)
        s["share"] = (served.get(t, 0.0) / served_total) \
            if served_total else 0.0
    return {"served_total": served_total,
            "tenants": _finalize(tenants)}


def fairness_audit(tenants, threshold=DEFAULT_FAIRNESS_DRIFT_THRESHOLD):
    """Measured served-token share vs configured weight share, per
    tenant: ``drift = |share - weight_share|``. ``tenants`` is any
    rollup shaped like ``router_tenant_usage(...)["tenants"]`` (each
    value carrying ``share`` and ``weight_share``). With fewer than
    two tenants there is nothing to be unfair between — ``max_drift``
    is 0.0 and the audit passes."""
    drifts = {}
    for t, s in tenants.items():
        share = float(s.get("share") or 0.0)
        wshare = float(s.get("weight_share") or 0.0)
        drifts[t] = {"share": share, "weight_share": wshare,
                     "drift": abs(share - wshare)}
    if len(drifts) < 2:
        worst, max_drift = None, 0.0
    else:
        worst = max(drifts, key=lambda t: drifts[t]["drift"])
        max_drift = drifts[worst]["drift"]
    return {"tenants": drifts, "max_drift": max_drift,
            "worst_tenant": worst, "threshold": float(threshold),
            "ok": max_drift <= float(threshold)}


def fairness_record(router):
    """The per-tick fairness fields the router folds into its
    throttled SLO tick's anomaly record (``tenant_hog``'s signal):
    measured share vs weight share per tenant plus total served
    tokens. None until at least two tenants have demand and tokens
    have been served — a one-tenant fleet has nothing to hog."""
    tu = router_tenant_usage(router)
    if not tu["served_total"] or len(tu["tenants"]) < 2:
        return None
    return {
        "tenant_served_total": tu["served_total"],
        "tenant_shares": {
            t: {"share": d["share"], "weight_share": d["weight_share"]}
            for t, d in tu["tenants"].items()},
    }


# -- post-hoc (journal) rollups ----------------------------------------------
def rollup_requests(records):
    """Per-tenant rollup of journal request records (the post-hoc twin
    of :func:`engine_tenant_usage`): engine request records carry
    ``tenant``/``device_ns``/``page_ns`` extras plus the derived
    ``queue_ms``/``ttft_ms``/``tpot_ms``/``e2e_ms``, so the chargeback
    table reconstructs from journals alone — exact to the token and
    the nanosecond."""
    tenants = {}
    for rec in records:
        s = _slot(tenants, rec.get("tenant") or DEFAULT_TENANT)
        s["requests"] += 1
        state = rec.get("state")
        if state == "FINISHED":
            s["completed"] += 1
        elif state == "CANCELLED":
            s["cancelled"] += 1
        if rec.get("preemptions"):
            s["preempted_requests"] += 1
            s["preemptions"] += int(rec["preemptions"])
        s["prompt_tokens"] += int(rec.get("prompt_tokens") or 0)
        s["decode_tokens"] += int(rec.get("output_tokens") or 0)
        s["device_ns"] += int(rec.get("device_ns") or 0)
        s["page_ns"] += int(rec.get("page_ns") or 0)
        lat = s["_lat"]
        for name in ("queue_ms", "ttft_ms", "tpot_ms", "e2e_ms"):
            v = rec.get(name)
            if v is not None:
                lat[name].append(float(v))
    return _finalize(tenants)


def merge_tenant_rollups(rollups):
    """Merge per-replica/per-run tenant rollups: counters and int-ns
    integrals add exactly; percentile fields cannot be merged from
    percentiles and are dropped (re-derive them from pooled records
    via :func:`rollup_requests` when needed)."""
    out = {}
    for rollup in rollups:
        for t, s in (rollup or {}).items():
            dst = out.setdefault(t, dict(_ZERO))
            for k, v in s.items():
                if k in _ZERO:
                    dst[k] = dst.get(k, 0) + v
    return out


def tenant_slo_slices(run_dir, specs, duration_s=None):
    """Per-tenant SLO evaluation over a run's pooled journals: filter
    the pooled request records (and ``router.reject`` events) by
    tenant, then run the existing ``obs.slo.evaluate_run`` per slice —
    same ``SLOSpec`` objectives, one verdict per tenant."""
    from . import slo as _slo

    pooled = run_dir if isinstance(run_dir, dict) \
        else _slo.load_any(run_dir)
    by_tenant = {}
    for rec in pooled.get("requests") or []:
        by_tenant.setdefault(rec.get("tenant") or DEFAULT_TENANT,
                             []).append(rec)
    rejects = {}
    for ev in pooled.get("events") or []:
        if ev.get("kind") == "router.reject":
            rejects.setdefault(ev.get("tenant") or DEFAULT_TENANT,
                               []).append(ev)
    out = {}
    for tenant in sorted(set(by_tenant) | set(rejects)):
        sub = {"run_dir": pooled.get("run_dir"),
               "requests": by_tenant.get(tenant, []),
               "events": rejects.get(tenant, []),
               "runs": pooled.get("runs") or []}
        out[tenant] = _slo.evaluate_run(sub, specs,
                                        duration_s=duration_s)
    return out
