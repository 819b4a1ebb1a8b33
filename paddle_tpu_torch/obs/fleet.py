"""Cross-rank fleet observability: aggregate per-rank run journals.

The flight recorder (``obs.journal``) is per-process; an elastic gang
or a serve fleet is N processes, each journaling into its own
``<run_dir>/rank_NN/`` subdir (the supervisor's own events land in
``<run_dir>/supervisor/``). This module is the read side that turns
those N single-rank records back into ONE run:

- :func:`load_journal` — the canonical journal parser (header, steps,
  events, requests, anomalies, summary; torn-tail tolerant; steps
  annotated with their incarnation so elastic re-executions stay
  attributable).
- :func:`align_steps` / :func:`step_skew` — align step records across
  ranks by GLOBAL step and compute per-step max/median step time,
  slowest-rank attribution, and the slowest rank's ratio to the median
  of the others (the per-worker step-time skew the pod-scaling
  playbook of arXiv 1909.09756 treats as the first-order scaling
  diagnostic).
- :class:`StragglerDetector` — persistent-straggler detection in the
  ``obs.anomaly`` re-arm style: fires once per episode, a recovery
  re-arms it.
- :func:`stall_attribution` — hung-rank attribution for attempts the
  supervisor ended in a hang, from the JOURNALS (the rank whose record
  stream stops earliest), because the watchdog's kill rank is
  poll-granularity noisy: a gang stalled on a collective (or a barrier)
  goes heartbeat-quiet together.
- :func:`aggregate` — the fleet rollup: per-rank table, skew summary,
  stragglers, gang goodput/MFU/throughput totals, merged request
  percentiles across serve replicas, supervisor elasticity columns.
- :func:`merge_chrome_traces` — fuse per-rank Chrome traces into one
  Perfetto file with pid=rank lanes (device counter lanes are
  rank-namespaced inside the ``DEVICE_PID_BASE`` band so two ranks'
  device 0 never share a pid).

``obs.export`` serves the live-signal complement (Prometheus SLO
gauges); ``tools/torch_fleet_report.py`` is the CLI over this module.
"""
from __future__ import annotations

import json
import os
import re
import time

from .journal import (JOURNAL_FILE, ROUTER_DIR,  # noqa: F401
                      SUPERVISOR_DIR, TRACE_FILE, rank_subdir)
from .trace import DEVICE_PID_BASE, RANK_PID_STRIDE

__all__ = [
    "SUPERVISOR_DIR", "ROUTER_DIR", "SUPERVISOR_PID", "rank_dirs",
    "supervisor_dirs", "router_dir", "journal_files",
    "load_journal", "load_fleet", "align_steps", "step_skew",
    "StragglerDetector", "detect_stragglers", "stall_attribution",
    "request_summary", "merged_request_summary", "elastic_summary",
    "router_summary", "slo_summary", "tenant_summary",
    "merged_tenant_summary", "per_rank_summary", "aggregate",
    "heartbeat_ages", "merge_chrome_traces", "rank_subdir",
]

# the supervisor's merged-trace lane: above any plausible rank, below
# the device pid band
SUPERVISOR_PID = 1 << 16

_RANK_DIR_RE = re.compile(r"^rank_(\d+)$")


def _median(values):
    s = sorted(values)
    n = len(s)
    if not n:
        return None
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _pctl(xs, q):
    from .metrics import exact_percentile

    return exact_percentile(xs, q)


def _num(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


# -- loading -----------------------------------------------------------------


def journal_files(path):
    """The journal file(s) for one run: a file path as-is; a directory
    yields rotated parts (``journal.<n>.jsonl``, oldest first) then the
    live ``journal.jsonl`` tail."""
    if os.path.isfile(path):
        return [path]
    if not os.path.isdir(path):
        return []
    parts = []
    for fn in os.listdir(path):
        if fn.startswith("journal.") and fn.endswith(".jsonl") \
                and fn != JOURNAL_FILE:
            try:
                parts.append((int(fn.split(".")[1]), fn))
            except ValueError:
                pass
    out = [os.path.join(path, fn) for _, fn in sorted(parts)]
    live = os.path.join(path, JOURNAL_FILE)
    if os.path.exists(live):
        out.append(live)
    return out


def load_journal(path):
    """Parse one rank's (or process's) journal into ``{header, steps,
    events, anomalies, requests, run_starts, summary, parse_errors}``.
    Tolerates a torn final line (a crashed writer) — it lands in
    ``parse_errors``, everything before it loads.

    An elastic worker appends a fresh ``run_start`` per incarnation
    into the SAME per-rank dir; each step record is annotated with its
    1-based ``_incarnation`` ordinal (``run_starts[k-1]`` is that
    incarnation's header) so re-executed steps stay attributable to
    the attempt that ran them. ``header`` is the LAST incarnation's.
    """
    files = journal_files(path)
    if not files:
        raise FileNotFoundError(f"no {JOURNAL_FILE} under {path!r}")
    run = {"header": None, "steps": [], "events": [], "anomalies": [],
           "requests": [], "run_starts": [], "summary": None,
           "parse_errors": []}
    for fp in files:
        with open(fp, encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError as e:
                    run["parse_errors"].append(
                        f"{os.path.basename(fp)}:{lineno}: {e}")
                    continue
                t = rec.get("t")
                if t == "run_start":
                    run["header"] = rec
                    run["run_starts"].append(rec)
                elif t == "step":
                    rec["_incarnation"] = len(run["run_starts"])
                    run["steps"].append(rec)
                elif t == "anomaly":
                    run["anomalies"].append(rec)
                elif t == "run_end":
                    run["summary"] = rec.get("summary")
                elif t == "event":
                    rec["_incarnation"] = len(run["run_starts"])
                    run["events"].append(rec)
                elif t == "request":
                    run["requests"].append(rec)
    # keyed by (incarnation, step): an elastic resume re-executes step
    # numbers into the SAME file, and a correction event from one
    # incarnation must never flag a later incarnation's clean re-run
    by_step = {(s["_incarnation"], s.get("step")): s
               for s in run["steps"]}
    for e in run["events"]:
        if e.get("kind") == "backend" and run["header"] is not None:
            # backend identity is journaled lazily (first step) so the
            # run header never forces backend init; fold it back in
            for k in ("backend", "ndev", "device_kind",
                      "peak_flops_per_s"):
                if k in e:
                    run["header"].setdefault(k, e[k])
        step = e.get("reclassified_step")
        key = (e.get("_incarnation"), step)
        if step is not None and key in by_step:
            # the step's line was already durable when the guard
            # discarded it; the correction rides the event
            by_step[key]["skipped"] = True
    return run


def rank_dirs(run_dir):
    """``{rank: path}`` for every ``rank_NN`` subdir of ``run_dir``
    holding a journal. Empty when ``run_dir`` is single-process."""
    out = {}
    if not run_dir or not os.path.isdir(run_dir):
        return out
    for fn in os.listdir(run_dir):
        m = _RANK_DIR_RE.match(fn)
        if not m:
            continue
        p = os.path.join(run_dir, fn)
        if os.path.isfile(os.path.join(p, JOURNAL_FILE)):
            out[int(m.group(1))] = p
    return out


def supervisor_dirs(run_dir):
    """``{rank_base: path}`` for every supervisor journal under
    ``run_dir``: the single-node ``supervisor/`` is base 0; a
    multi-node launch adds one ``supervisor_NN/`` per non-zero node
    (NN = that node's first global rank — GangSupervisor's
    ``rank_base``)."""
    out = {}
    if not run_dir or not os.path.isdir(run_dir):
        return out
    for fn in os.listdir(run_dir):
        if fn == SUPERVISOR_DIR:
            base = 0
        elif fn.startswith(SUPERVISOR_DIR + "_"):
            try:
                base = int(fn[len(SUPERVISOR_DIR) + 1:])
            except ValueError:
                continue
        else:
            continue
        p = os.path.join(run_dir, fn)
        if os.path.isfile(os.path.join(p, JOURNAL_FILE)):
            out[base] = p
    return out


def router_dir(run_dir):
    """The serve-fleet router's journal dir under ``run_dir``
    (``router/``, written by ``serving.fleet.Router``'s host process),
    or None."""
    if not run_dir:
        return None
    p = os.path.join(str(run_dir), ROUTER_DIR)
    if os.path.isfile(os.path.join(p, JOURNAL_FILE)):
        return p
    return None


def load_fleet(run_dir):
    """Load every rank journal (+ every supervisor's and the serve
    router's, when present) under ``run_dir`` into ``{run_dir, ranks:
    {rank: run}, supervisors: {rank_base: run}, supervisor, router}``;
    ``supervisor`` stays the base-0 record for single-node callers."""
    ranks = rank_dirs(run_dir)
    if not ranks:
        raise FileNotFoundError(
            f"no rank_NN journals under {run_dir!r} — not a fleet run "
            "dir (single-process runs render via tools/run_report.py)")
    fleet = {"run_dir": str(run_dir),
             "ranks": {r: load_journal(p)
                       for r, p in sorted(ranks.items())},
             "supervisors": {}, "supervisor": None, "router": None}
    for base, p in sorted(supervisor_dirs(run_dir).items()):
        fleet["supervisors"][base] = load_journal(p)
    fleet["supervisor"] = fleet["supervisors"].get(0)
    rd = router_dir(run_dir)
    if rd:
        fleet["router"] = load_journal(rd)
    return fleet


# -- cross-rank alignment + skew ---------------------------------------------


def align_steps(fleet):
    """``[{step, by_rank: {rank: step-record}}]`` sorted by GLOBAL
    step. A step re-executed after an elastic resume keeps the LAST
    record per rank — the execution the final trajectory used."""
    by_step = {}
    for rank, run in fleet["ranks"].items():
        for rec in run["steps"]:
            s = rec.get("step")
            if isinstance(s, int):
                by_step.setdefault(s, {})[rank] = rec
    return [{"step": s, "by_rank": by_step[s]} for s in sorted(by_step)]


def step_skew(aligned):
    """Per aligned step with >= 2 ranks reporting a positive
    ``step_ms``: ``skew`` = max/median across ranks, the slowest rank
    (lowest rank wins a tie, deterministically), and
    ``slowest_vs_others`` = slowest over the median of the OTHER ranks
    — the per-rank straggler magnitude (2.0 reads "this rank ran the
    step at half the speed of the rest of the gang")."""
    rows = []
    for row in aligned:
        ms = {r: rec["step_ms"] for r, rec in row["by_rank"].items()
              if _num(rec.get("step_ms")) and rec["step_ms"] > 0}
        if len(ms) < 2:
            continue
        med = _median(ms.values())
        slowest = max(sorted(ms), key=lambda r: ms[r])
        others_med = _median([v for r, v in ms.items() if r != slowest])
        rows.append({
            "step": row["step"], "nranks": len(ms),
            "max_ms": ms[slowest], "median_ms": med,
            "skew": (ms[slowest] / med) if med else None,
            "slowest": slowest,
            "slowest_vs_others": (ms[slowest] / others_med)
            if others_med else None,
        })
    return rows


class StragglerDetector:
    """Persistent-straggler detection in the ``obs.anomaly`` re-arm
    style over :func:`step_skew` rows: fires ONCE per episode when the
    SAME rank is slowest for ``patience`` consecutive compared steps at
    >= ``factor`` x the median of the other ranks; a recovery (the
    ratio dropping under ``factor``, or the slowest rank changing)
    resets the streak and re-arms the detector for the next episode."""

    name = "persistent_straggler"

    def __init__(self, factor=1.5, patience=3):
        self.factor = float(factor)
        self.patience = max(1, int(patience))
        self._rank = None
        self._streak = 0
        self._first = None

    def update(self, row):
        ratio = row.get("slowest_vs_others")
        if ratio is None or ratio < self.factor:
            self._rank, self._streak, self._first = None, 0, None
            return None
        if row["slowest"] != self._rank:
            self._rank = row["slowest"]
            self._streak = 0
            self._first = row["step"]
        self._streak += 1
        if self._streak == self.patience:  # once per episode
            return {"rank": self._rank, "first_step": self._first,
                    "step": row["step"], "ratio": ratio,
                    "streak": self._streak}
        return None


def detect_stragglers(rows, factor=1.5, patience=3):
    """Every persistent-straggler episode in the skew rows, tagged
    ``kind="slow"``."""
    det = StragglerDetector(factor=factor, patience=patience)
    out = []
    for row in rows:
        fired = det.update(row)
        if fired:
            out.append(dict(fired, kind="slow"))
    return out


def _attempt_of(run, incarnation):
    """The supervisor attempt index a step's incarnation ran under
    (``PADDLE_TPU_ELASTIC_ATTEMPT`` from that incarnation's run_start
    env; ordinal fallback for unsupervised runs)."""
    if not incarnation or incarnation > len(run["run_starts"]):
        return None
    env = run["run_starts"][incarnation - 1].get("env") or {}
    try:
        return int(env.get("PADDLE_TPU_ELASTIC_ATTEMPT"))
    except (TypeError, ValueError):
        return incarnation - 1


def stall_attribution(fleet):
    """Hung-rank attribution, tagged ``kind="hang"``: for each attempt
    the supervisor restarted on a hang — and for a terminal hang that
    exhausted the restart budget — the rank whose journal stops at
    the LOWEST step in that attempt is the one that stopped making
    progress. The supervisor's ``elastic.watchdog_kill`` rank is NOT
    trusted for this: a rank hung at a barrier (or collective) stalls
    every other rank's heartbeat within one step, and the watchdog
    reports whichever stale beacon it polled first. ``ambiguous`` is
    set when the journals cannot separate the ranks (all stopped at the
    same step)."""
    sups = _supervisors(fleet)
    if not sups:
        return []
    out = []
    bases = sorted(sups)
    for i, base in enumerate(bases):
        # each supervisor's attempt counter is its OWN: scope its
        # events to the rank slice that node owns (base..next base),
        # or two nodes' identical attempt numbers would cross-match
        hi_base = bases[i + 1] if i + 1 < len(bases) else None
        node_ranks = {r: run for r, run in fleet["ranks"].items()
                      if r >= base and (hi_base is None or r < hi_base)}
        out += _stalls_for_supervisor(sups[base], node_ranks)
    return out


def _stalls_for_supervisor(sup, ranks):
    hang_attempts = [(ev["attempt"], ev.get("rank"))
                     for ev in sup["events"]
                     if ev.get("kind") == "elastic.restart"
                     and ev.get("failure") == "hang"
                     and ev.get("attempt") is not None]
    for ev in sup["events"]:
        # a hang that EXHAUSTS the restart budget gets no restart
        # event — and the terminal failure is exactly the one a
        # postmortem needs attributed. Its attempt index is the last
        # one any rank journaled.
        if ev.get("kind") == "elastic.budget_exhausted" and \
                ev.get("last_kind") == "hang":
            attempts = [a for run in ranks.values()
                        for a in (_attempt_of(run, i + 1)
                                  for i in range(len(run["run_starts"])))
                        if a is not None]
            if attempts:
                hang_attempts.append((max(attempts),
                                      ev.get("last_rank")))
    out = []
    for attempt, watchdog_rank in hang_attempts:
        last = {}
        for rank, run in ranks.items():
            steps = [s["step"] for s in run["steps"]
                     if isinstance(s.get("step"), int) and
                     _attempt_of(run, s.get("_incarnation")) == attempt]
            if steps:
                last[rank] = max(steps)
        if not last:
            continue
        lo, hi = min(last.values()), max(last.values())
        stalled = sorted(r for r, v in last.items() if v == lo)
        out.append({"kind": "hang", "attempt": attempt,
                    "rank": stalled[0], "ranks": stalled,
                    "last_step": lo, "gang_reached": hi,
                    "watchdog_rank": watchdog_rank,
                    "ambiguous": len(stalled) > 1 or lo == hi})
    return out


# -- summaries ---------------------------------------------------------------


def request_summary(run):
    """Serving columns over one run's ``request`` records: counts by
    state, total preemptions, exact p50/p99 TTFT/TPOT/e2e/queue (ms),
    and ``queue_share`` — the fraction of total TTFT spent in the
    arrival->admit queue (the reqtrace regression gate's signal: a
    p99 TTFT breach whose attribution shifted into queue wait moves
    this, a prefill regression doesn't). None when the run served
    nothing. (Canonical home of the summary ``tools/run_report.py``
    renders.)"""
    reqs = run.get("requests") or []
    if not reqs:
        return None
    out = {"requests": len(reqs),
           "finished": sum(1 for r in reqs
                           if r.get("state") == "FINISHED"),
           "cancelled": sum(1 for r in reqs
                            if r.get("state") == "CANCELLED"),
           "preemptions": sum(int(r.get("preemptions") or 0)
                              for r in reqs),
           "output_tokens": sum(int(r.get("output_tokens") or 0)
                                for r in reqs)}
    for key in ("ttft_ms", "tpot_ms", "e2e_ms", "queue_ms"):
        vals = [r[key] for r in reqs if _num(r.get(key))]
        if vals:
            out[f"{key}_p50"] = _pctl(vals, 50)
            out[f"{key}_p99"] = _pctl(vals, 99)
    both = [(r["queue_ms"], r["ttft_ms"]) for r in reqs
            if _num(r.get("queue_ms")) and _num(r.get("ttft_ms"))]
    ttft_total = sum(t for _, t in both)
    if both and ttft_total > 0:
        out["queue_share"] = sum(q for q, _ in both) / ttft_total
    return out


def merged_request_summary(fleet):
    """Request percentiles merged ACROSS serve replicas: the fleet's
    p50/p99 over every rank's request records pooled (per-replica
    percentiles don't average — the pool is the only correct merge)."""
    reqs = []
    for run in fleet["ranks"].values():
        reqs += run.get("requests") or []
    for sup in _supervisors(fleet).values():
        reqs += sup.get("requests") or []
    return request_summary({"requests": reqs})


def _supervisors(fleet):
    """Every supervisor run in the fleet dict (multi-node launches
    write one per node); tolerates pre-multi-node dicts carrying only
    the single ``supervisor`` slot."""
    sups = fleet.get("supervisors")
    if sups:
        return sups
    return {0: fleet["supervisor"]} if fleet.get("supervisor") else {}


def elastic_summary(run):
    """Elasticity columns over one run's ``elastic.*`` events (written
    by ``resilience.elastic.GangSupervisor``): restarts (budget-
    consuming crash/hang relaunches), budget-free preemptions, watchdog
    kills, resume-latency p50/max, the resume steps, and whether the
    restart budget was exhausted. None when the run was never
    supervised. (Canonical home of the summary ``tools/run_report.py``
    renders.)"""
    events = [e for e in run.get("events") or []
              if str(e.get("kind", "")).startswith("elastic.")]
    if not events:
        return None
    kinds = {}
    for e in events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    resume_ms = [e["resume_ms"] for e in events
                 if e.get("kind") == "elastic.resumed"
                 and _num(e.get("resume_ms"))]
    out = {
        "restarts": kinds.get("elastic.restart", 0),
        "preemptions": kinds.get("elastic.preempt", 0),
        "watchdog_kills": kinds.get("elastic.watchdog_kill", 0),
        "preempt_signals": kinds.get("elastic.preempt_signal", 0),
        "budget_exhausted": bool(kinds.get("elastic.budget_exhausted")),
        "completed": bool(kinds.get("elastic.done")),
        "resume_steps": [e.get("resume_step") for e in events
                         if e.get("kind") in ("elastic.restart",
                                              "elastic.preempt")],
    }
    if resume_ms:
        out["resume_ms_p50"] = _pctl(resume_ms, 50)
        out["resume_ms_max"] = max(resume_ms)
    return out


def router_summary(run):
    """Serve-router columns over a run's ``router.*`` events (written
    by ``serving.fleet.Router``): the LAST ``router.summary`` truth
    (dispatched/requeued/rejected/completed, per-tenant token shares,
    aggregate p99 TTFT) plus reject/requeue/scale event counts. None
    when the run never routed. (Canonical home of the line
    ``tools/run_report.py`` / ``tools/fleet_report.py`` render.)"""
    if not run:
        return None
    events = [e for e in run.get("events") or []
              if str(e.get("kind", "")).startswith("router.")]
    if not events:
        return None
    summary = None
    for e in events:
        if e.get("kind") == "router.summary":
            summary = e   # last wins: the final truth
    out = {
        "dispatched": None, "requeued": None, "rejected": None,
        "completed": None, "replicas": None, "scale_ups": None,
        "scale_downs": None, "tenants": {}, "ttft_p99_ms": None,
        "requeue_events": sum(1 for e in events
                              if e.get("kind") == "router.requeue"),
        "reject_events": sum(1 for e in events
                             if e.get("kind") == "router.reject"),
        "scale_events": sum(1 for e in events
                            if e.get("kind") == "router.scale"),
    }
    if summary is not None:
        for k in ("dispatched", "requeued", "rejected", "completed",
                  "replicas", "scale_ups", "scale_downs",
                  "ttft_p99_ms"):
            out[k] = summary.get(k)
        out["tenants"] = summary.get("tenants") or {}
    return out


def slo_summary(run):
    """SLO columns over a run's ``slo.*`` events (written by
    ``obs.slo.SLOEvaluator``): the chronological fire/clear timeline,
    per-alert (``objective/severity``) fire/clear counts, which alerts
    are still latched at end-of-run, and the LAST ``slo.summary`` truth
    (budget remaining, burn). None when the run was never evaluated.
    (Canonical home of the timeline ``tools/slo_report.py`` renders.)
    """
    if not run:
        return None
    events = [e for e in run.get("events") or []
              if str(e.get("kind", "")).startswith("slo.")]
    if not events:
        return None
    timeline = []
    per = {}
    for e in events:
        kind = e.get("kind")
        if kind not in ("slo.fire", "slo.clear"):
            continue
        obj = e.get("objective")
        # keyed per (objective, severity): the page clearing must not
        # mask a warn that is still latched on the same objective
        alert = f"{obj}/{e.get('severity')}"
        row = per.setdefault(alert, {"fires": 0, "clears": 0,
                                     "active": False})
        if kind == "slo.fire":
            row["fires"] += 1
            row["active"] = True
        else:
            row["clears"] += 1
            row["active"] = False
        timeline.append({
            "at": e.get("at"), "kind": kind, "objective": obj,
            "severity": e.get("severity"),
            "burn_short": e.get("burn_short"),
            "burn_long": e.get("burn_long"),
            "windows": f"{e.get('window_short')}+"
                       f"{e.get('window_long')}",
            "threshold": e.get("threshold"),
            "worst_replica": e.get("worst_replica"),
            "budget_remaining": e.get("budget_remaining"),
        })
    timeline.sort(key=lambda r: (r["at"] is None, r["at"]))
    summary = None
    for e in events:
        if e.get("kind") == "slo.summary":
            summary = e   # last wins: the final truth
    out = {
        "fires": sum(r["fires"] for r in per.values()),
        "clears": sum(r["clears"] for r in per.values()),
        "active_at_end": sorted(a for a, r in per.items()
                                if r["active"]),
        "alerts": per,
        "timeline": timeline,
        "summary": None if summary is None
        else summary.get("objectives"),
        "ticks": None if summary is None else summary.get("ticks"),
    }
    return out


def tenant_summary(run):
    """Per-tenant chargeback columns over ONE journal: the run's
    ``request`` records rolled up via ``obs.usage.rollup_requests``
    (tokens, device-ns, page-ns, exact latency percentiles), plus the
    LAST ``tenant.summary`` (router truth) and LAST ``tenant.usage``
    (engine truth — the final incarnation's device-second telescoping
    and page-second closure) events carried alongside, with the
    fairness audit when the run routed. None when the run carries no
    tenant signal."""
    if not run:
        return None
    from . import usage as _usage

    reqs = run.get("requests") or []
    router = engine = None
    for e in run.get("events") or []:
        k = e.get("kind")
        if k == "tenant.summary":
            router = e   # last wins: the final truth
        elif k == "tenant.usage":
            engine = e   # last wins: the final incarnation
    if not reqs and router is None and engine is None:
        return None
    out = {
        "tenants": _usage.rollup_requests(reqs),
        "router": None if router is None else {
            "served_total": router.get("served_total"),
            "tenants": router.get("tenants") or {}},
        "engine": None if engine is None else {
            k: engine.get(k)
            for k in ("replica", "busy_ns", "prefill_ns", "decode_ns",
                      "page_bytes", "page_open", "seq_allocs",
                      "seq_frees", "tenants")},
    }
    if router is not None:
        out["fairness"] = _usage.fairness_audit(
            router.get("tenants") or {})
    return out


def merged_tenant_summary(fleet):
    """Chargeback rolled up ACROSS the fleet: every rank's (and the
    supervisors'/router's) request records pooled through ONE
    ``obs.usage.rollup_requests`` pass (percentiles over the pool —
    per-replica percentiles don't average), per-replica engine truth
    from each rank's LAST ``tenant.usage`` event, and the router's
    final ``tenant.summary`` + fairness audit when the run routed.
    None when nothing in the fleet carries a tenant signal."""
    from . import usage as _usage

    reqs = []
    replicas = {}
    for rank, run in sorted(fleet["ranks"].items()):
        reqs += run.get("requests") or []
        last = None
        for e in run.get("events") or []:
            if e.get("kind") == "tenant.usage":
                last = e   # last wins: the final incarnation
        if last is not None:
            replicas[rank] = {
                "replica": last.get("replica"),
                "busy_ns": last.get("busy_ns"),
                "page_open": last.get("page_open"),
                "tenants": last.get("tenants") or {}}
    for sup in _supervisors(fleet).values():
        reqs += sup.get("requests") or []
    rsum = None
    router_run = fleet.get("router")
    if router_run:
        reqs += router_run.get("requests") or []
        for e in router_run.get("events") or []:
            if e.get("kind") == "tenant.summary":
                rsum = e   # last wins: the final truth
    if not reqs and not replicas and rsum is None:
        return None
    out = {
        "tenants": _usage.rollup_requests(reqs),
        "replicas": replicas,
        "router": None if rsum is None else {
            "served_total": rsum.get("served_total"),
            "tenants": rsum.get("tenants") or {}},
    }
    if rsum is not None:
        out["fairness"] = _usage.fairness_audit(
            rsum.get("tenants") or {})
    return out


def per_rank_summary(run):
    """One rank's row in the fleet table (plain data)."""
    steps = run["steps"]
    times = [s["step_ms"] for s in steps
             if _num(s.get("step_ms")) and s["step_ms"] > 0]
    comm = [s["comm"].get("total_bytes", 0) for s in steps
            if isinstance(s.get("comm"), dict)]
    summ = run.get("summary") or {}
    hdr = run.get("header") or {}
    return {
        "rank": hdr.get("rank"),
        "steps": len(steps),
        "optimizer_steps": sum(int(s.get("steps_fused") or 1)
                               for s in steps),
        "last_step": max([s["step"] for s in steps
                          if isinstance(s.get("step"), int)],
                         default=None),
        "mean_step_ms": (sum(times) / len(times)) if times else None,
        "p50_step_ms": _pctl(times, 50),
        "goodput": summ.get("goodput"),
        "mfu": summ.get("mfu"),
        "examples_per_s": summ.get("examples_per_s"),
        "achieved_flops_per_s": summ.get("achieved_flops_per_s"),
        "comm_share": summ.get("comm_share"),
        "comm_bytes_per_step": (sum(comm) / len(comm)) if comm
        else None,
        "run_starts": len(run["run_starts"]),
        "requests": len(run.get("requests") or []),
        "anomalies": len(run.get("anomalies") or []),
        "parse_errors": len(run["parse_errors"]),
    }


def heartbeat_ages(run_dir, now=None):
    """Per-rank liveness proxy (seconds since the rank's journal file
    last flushed): crash-robust, needs no extra plumbing, and exactly
    what a router/autoscaler should alarm on. None for a rank whose
    journal vanished mid-read."""
    now = time.time() if now is None else float(now)
    out = {}
    for rank, p in sorted(rank_dirs(run_dir).items()):
        try:
            out[rank] = max(
                0.0, now - os.path.getmtime(os.path.join(p,
                                                         JOURNAL_FILE)))
        except OSError:
            out[rank] = None
    return out


def aggregate(run_dir, straggler_factor=1.5, straggler_patience=3):
    """The fleet rollup over ``run_dir``'s rank journals: per-rank
    table, cross-rank skew summary, straggler/hang attribution, gang
    goodput/MFU/throughput totals, merged request percentiles, and the
    supervisor's elasticity columns. Accepts a pre-loaded
    :func:`load_fleet` dict or a path."""
    fleet = run_dir if isinstance(run_dir, dict) else load_fleet(run_dir)
    aligned = align_steps(fleet)
    rows = step_skew(aligned)
    stragglers = detect_stragglers(
        rows, factor=straggler_factor, patience=straggler_patience)
    stragglers += stall_attribution(fleet)
    per_rank = {r: per_rank_summary(run)
                for r, run in fleet["ranks"].items()}
    worst = max(rows, key=lambda r: r["skew"] or 0.0) if rows else None
    slowest_counts = {}
    for row in rows:
        slowest_counts[row["slowest"]] = \
            slowest_counts.get(row["slowest"], 0) + 1
    skews = [r["skew"] for r in rows if r["skew"]]
    goodputs = [v["goodput"] for v in per_rank.values()
                if _num(v["goodput"])]
    exps = [v["examples_per_s"] for v in per_rank.values()
            if _num(v["examples_per_s"])]
    flops = [v["achieved_flops_per_s"] for v in per_rank.values()
             if _num(v["achieved_flops_per_s"])]
    mfus = [v["mfu"] for v in per_rank.values() if _num(v["mfu"])]
    comms = [v["comm_bytes_per_step"] for v in per_rank.values()
             if _num(v["comm_bytes_per_step"])]
    out = {
        "run_dir": fleet.get("run_dir"),
        "ranks": sorted(fleet["ranks"]),
        "nranks": len(fleet["ranks"]),
        "aligned_steps": len(aligned),
        "per_rank": per_rank,
        "skew": {
            "steps_compared": len(rows),
            "max": worst["skew"] if worst else None,
            "max_step": worst["step"] if worst else None,
            "mean": (sum(skews) / len(skews)) if skews else None,
            "worst_rank": worst["slowest"] if worst else None,
            "worst_rank_ratio": worst["slowest_vs_others"]
            if worst else None,
            "slowest_counts": slowest_counts,
        },
        "stragglers": stragglers,
        "goodput_min": min(goodputs) if goodputs else None,
        "goodput_mean": (sum(goodputs) / len(goodputs))
        if goodputs else None,
        "examples_per_s_total": sum(exps) if exps else None,
        "achieved_flops_per_s_total": sum(flops) if flops else None,
        "mfu_mean": (sum(mfus) / len(mfus)) if mfus else None,
        # gang-wide collective volume: the per-rank per-step means
        # summed (each rank's executable moves its own share)
        "comm_bytes_per_step_total": sum(comms) if comms else None,
        "requests": merged_request_summary(fleet),
        # one elasticity rollup across EVERY node's supervisor (counts
        # sum; a multi-node launch writes one supervisor_NN per node)
        "supervisor": elastic_summary(
            {"events": [e for sup in _supervisors(fleet).values()
                        for e in sup.get("events") or []]}),
        # the serve router's own journal (serving.fleet drill/serve):
        # dispatch/requeue/scale truth next to the per-rank rollup
        "router": router_summary(fleet.get("router")),
        # per-tenant chargeback: pooled request rollup + per-replica
        # engine truth + the router's fairness audit
        "tenant_usage": merged_tenant_summary(fleet),
    }
    if not isinstance(run_dir, dict):
        out["heartbeat_age_s"] = heartbeat_ages(run_dir)
    return out


# -- merged Chrome traces ----------------------------------------------------


def _remap_pid(pid, lane, device_pids):
    """A rank's host spans land on pid=lane; its device counter lanes
    keep their in-band slot but move into the lane's namespace slice —
    idempotent whether or not the exporting process already
    rank-namespaced them (the slot is recovered mod RANK_PID_STRIDE).
    A pid counts as a device lane only when the SOURCE file used it for
    counter samples (``device_pids``), never by magnitude alone: on
    hosts with ``pid_max`` raised past ``DEVICE_PID_BASE`` an
    un-namespaced export's host OS pid can exceed the device band."""
    if pid in device_pids and isinstance(pid, (int, float)):
        local = int(pid) % RANK_PID_STRIDE if pid < DEVICE_PID_BASE \
            else (int(pid) - DEVICE_PID_BASE) % RANK_PID_STRIDE
        return DEVICE_PID_BASE + lane * RANK_PID_STRIDE + local
    return lane


def merge_chrome_traces(run_dir, out_path, include_supervisor=True,
                        include_requests=True):
    """Fuse the per-rank Chrome traces under ``run_dir`` (exported next
    to each rank journal on close/postmortem when ``PADDLE_TPU_TRACE``
    is on) into ONE Perfetto file: rank r's spans on pid=r, its device
    counter lanes inside ``DEVICE_PID_BASE + r*RANK_PID_STRIDE``, the
    supervisor's spans on ``SUPERVISOR_PID`` — every rank a distinct
    lane, no pid collisions by construction. ``include_requests``
    additionally renders ``obs.reqtrace`` request lanes from the
    JOURNALS (slices on pid=replica with flow arrows across requeues)
    — journal-derived, so they appear even when the workers ran with
    span tracing off and contributed zero trace files. Returns
    ``{sources, events, request_slices, path}``."""
    sources = [(int(rank), None, os.path.join(p, TRACE_FILE))
               for rank, p in sorted(rank_dirs(run_dir).items())]
    if include_supervisor:
        for base, p in sorted(supervisor_dirs(run_dir).items()):
            sources.append((None, base, os.path.join(p, TRACE_FILE)))
    events = []
    n_sources = 0
    for rank, sup_base, path in sources:
        if not os.path.isfile(path):
            continue
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except (ValueError, OSError):
            continue
        lane = SUPERVISOR_PID + sup_base if rank is None else rank
        n_sources += 1
        evs = data.get("traceEvents") or []
        # the pids THIS export used for device counter samples — the
        # only reliable device-lane marker (see _remap_pid)
        device_pids = {e.get("pid") for e in evs if e.get("ph") == "C"}
        for ev in evs:
            ev = dict(ev)
            new_pid = _remap_pid(ev.get("pid"), lane, device_pids)
            if ev.get("ph") == "M" and \
                    ev.get("name") == "process_name" and \
                    new_pid == lane:
                continue  # the host lane gets ONE fleet-level meta below
            ev["pid"] = new_pid
            events.append(ev)
        if rank is None:
            label = "supervisor" if not sup_base \
                else f"supervisor (ranks {sup_base}+)"
        else:
            label = f"rank {rank:02d}"
        events.append({
            "ph": "M", "pid": lane, "name": "process_name",
            "args": {"name": label}})
        events.append({"ph": "M", "pid": lane, "name":
                       "process_sort_index",
                       "args": {"sort_index": lane}})
    labeled = {e["pid"] for e in events
               if e.get("ph") == "M" and e.get("name") == "process_name"}
    request_slices = 0
    if include_requests:
        from . import reqtrace as _reqtrace

        try:
            tls = _reqtrace.assemble_run(run_dir)
        except (FileNotFoundError, OSError):
            tls = {}
        req_events = _reqtrace.request_lane_events(tls)
        request_slices = sum(1 for e in req_events if e["ph"] == "X")
        events += req_events
        for pid in sorted({e["pid"] for e in req_events}):
            if pid in labeled:
                continue  # the rank's own trace already named the lane
            events.append({
                "ph": "M", "pid": pid, "name": "process_name",
                "args": {"name": f"replica {pid}"}})
            events.append({
                "ph": "M", "pid": pid, "name": "process_sort_index",
                "args": {"sort_index": pid}})
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  default=str)
    return {"sources": n_sources, "events": len(events),
            "request_slices": request_slices, "path": out_path}
