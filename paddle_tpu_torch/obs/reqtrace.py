"""Request-scoped distributed tracing: per-request timelines and
tail-latency attribution across the serve fleet.

The write side is already in the serving stack — every lifecycle edge
journals one ``req.*`` event under the established ACTIVE guard (one
``is not None`` check when the flight recorder is off):

- ``req.submit`` / ``req.rate_hold`` / ``req.dispatch`` /
  ``req.requeue`` — the router's journal (``<run_dir>/router``), on
  the router clock; the trace id is minted at ``Router.submit()`` and
  rides dispatch into the replica on BOTH pool modes (in-process call
  and the worker's newline-JSON protocol).
- ``req.admit`` / ``req.preempt`` / ``req.decode_mark`` — each
  replica's journal (``<run_dir>/rank_NN``), on the engine clock, plus
  the terminal ``request`` record carrying the engine-side phase
  fields (``queue_ms``/``prefill_ms``/``preempt_ms``/``decode_ms``).

This module is the READ side: :func:`assemble_run` joins those
journals by rid into per-request timelines (one dispatch segment per
replica incarnation — a requeued request carries BOTH the victim's
segment and the re-dispatched one's); :func:`attribute` decomposes
TTFT and e2e into exact phase contributions::

    rate_limit_wait + router_queue + requeue + sched_queue + prefill
        == TTFT
    TTFT + preempt + decode == e2e

``prefill_ms`` and ``decode_ms`` are computed as remainders of the
stamped phases, so the telescope sums to e2e by construction — under
``ManualClock`` (dyadic timestamps) every phase is ALSO bitwise equal
to its direct stamp difference, which the self-test fixtures assert
to the nanosecond. :func:`tail_report` ranks the worst-percentile
requests by TTFT/e2e and names where their time went;
:func:`request_lane_events` renders timelines as Perfetto slices on
pid=replica lanes with flow arrows across requeues (merged into the
fleet trace by ``obs.fleet.merge_chrome_traces(include_requests=
True)``).
"""
from __future__ import annotations

import json
import os

from . import trace as _trace

__all__ = [
    "PHASES", "REQUEST_TID_BASE",
    "assemble", "assemble_run", "attribute", "attribute_run",
    "attribution_sum", "tail_report", "request_lane_events",
    "write_request_trace",
]

# canonical attribution order: summed left-to-right these telescope to
# e2e_ms (prefill and decode are remainders — see module docstring)
PHASES = ("rate_limit_wait_ms", "router_queue_ms", "requeue_ms",
          "sched_queue_ms", "prefill_ms", "preempt_ms", "decode_ms")

# request lanes use tids far above any plausible thread ident's low
# bits mattering — one tid per request, shared across the pid lanes it
# visits, so Perfetto reads a requeued request as ONE named row that
# crosses replica lanes
REQUEST_TID_BASE = 1 << 21


def _new_timeline(rid):
    return {
        "rid": rid, "trace": None, "tenant": None, "state": None,
        "arrival_t": None, "admit_t": None, "first_token_t": None,
        "finish_t": None, "prompt_tokens": None, "output_tokens": None,
        "preemptions": 0, "replica": None, "cost": None,
        "rate_wait_ms": 0.0, "rate_holds": [],
        "dispatches": [], "requeues": [],
        "admits": [], "preempts": [], "decode_marks": [],
        "segments": [], "record": None,
    }


def assemble(router_run=None, rank_runs=None):
    """Join one run's journals into ``{rid: timeline}``.

    ``router_run`` is the router's :func:`obs.fleet.load_journal` dict
    (or None for a router-less single-engine run); ``rank_runs`` maps
    replica id -> loaded journal (a plain single-process journal
    passes as ``{None: run}`` — the record's own ``replica`` field
    labels the lane). Timelines are plain dicts; ``segments`` is the
    finalized per-incarnation list ``[{replica, start, end, seq,
    requeue_reason}]`` the lane export and the drill assertions read.
    """
    tls = {}

    def tl(rid):
        t = tls.get(rid)
        if t is None:
            t = tls[rid] = _new_timeline(rid)
        return t

    def ingest(e, replica):
        kind = e.get("kind")
        if not str(kind or "").startswith("req."):
            return
        if kind == "req.decode_mark":
            for rid in e.get("rids") or []:
                tl(rid)["decode_marks"].append({
                    "t": e.get("at"), "step": e.get("step"),
                    "replica": e.get("replica", replica)})
            return
        rid = e.get("rid")
        if rid is None:
            return
        t = tl(rid)
        if kind == "req.submit":
            t["arrival_t"] = e.get("at")
            t["tenant"] = e.get("tenant")
            t["trace"] = e.get("trace") or t["trace"]
            t["cost"] = e.get("cost")
            if t["prompt_tokens"] is None:
                t["prompt_tokens"] = e.get("prompt_tokens")
        elif kind == "req.rate_hold":
            t["rate_holds"].append(e.get("at"))
        elif kind == "req.dispatch":
            t["dispatches"].append({
                "t": e.get("at"), "replica": e.get("replica"),
                "seq": e.get("seq"),
                "rate_wait_ms": e.get("rate_wait_ms") or 0.0})
            t["trace"] = e.get("trace") or t["trace"]
        elif kind == "req.requeue":
            t["requeues"].append({
                "t": e.get("at"), "replica": e.get("replica"),
                "reason": e.get("reason")})
        elif kind == "req.admit":
            t["admits"].append({
                "t": e.get("at"), "resumed": bool(e.get("resumed")),
                "replica": replica})
        elif kind == "req.preempt":
            t["preempts"].append(e.get("at"))

    for e in (router_run or {}).get("events") or []:
        ingest(e, None)
    for replica, run in (rank_runs or {}).items():
        # a shared single-process journal (mode="local" with one
        # recorder) carries the router-side req.* events too — ingest
        # handles every kind, whichever journal it landed in
        for e in run.get("events") or []:
            ingest(e, replica)
        for rec in run.get("requests") or []:
            rid = rec.get("rid")
            if rid is None:
                continue
            t = tl(rid)
            old = t["record"]
            # the FINAL incarnation's record wins (a requeued request
            # may leave a cancelled torso in the victim's journal)
            if old is None or (rec.get("finish_t") or 0.0) >= \
                    (old.get("finish_t") or 0.0):
                t["record"] = rec

    for t in tls.values():
        _finalize(t)
    return tls


def _finalize(t):
    rec = t["record"]
    if rec is not None:
        for k in ("state", "admit_t", "first_token_t", "finish_t",
                  "output_tokens", "replica", "trace"):
            if rec.get(k) is not None:
                t[k] = rec[k]
        for k in ("arrival_t", "prompt_tokens"):
            # router stamps win (fleet truth); fill from the record
            # only for router-less runs
            if t[k] is None and rec.get(k) is not None:
                t[k] = rec[k]
        t["preemptions"] = int(rec.get("preemptions") or 0)
    t["dispatches"].sort(key=lambda d: (d["t"] is None, d["t"]))
    t["requeues"].sort(key=lambda r: (r["t"] is None, r["t"]))
    t["admits"].sort(key=lambda a: (a["t"] is None, a["t"]))
    t["preempts"] = sorted(x for x in t["preempts"] if x is not None)
    t["decode_marks"].sort(key=lambda m: (m["t"] is None, m["t"]))
    if t["dispatches"]:
        # rate_wait_ms is CUMULATIVE on each dispatch event: the last
        # dispatch carries the request's total rate-limit wait
        t["rate_wait_ms"] = float(
            t["dispatches"][-1]["rate_wait_ms"] or 0.0)
        for i, d in enumerate(t["dispatches"]):
            rq = t["requeues"][i] if i < len(t["requeues"]) else None
            t["segments"].append({
                "replica": d["replica"], "start": d["t"],
                "end": rq["t"] if rq is not None else t["finish_t"],
                "seq": d.get("seq") or (i + 1),
                "requeue_reason": rq["reason"] if rq is not None
                else None})
    elif t["admit_t"] is not None:
        # router-less single-engine run: one segment, admission to
        # finish, on the record's own replica lane
        t["segments"].append({
            "replica": t["replica"] if t["replica"] is not None else 0,
            "start": t["admit_t"], "end": t["finish_t"], "seq": 1,
            "requeue_reason": None})


def assemble_run(run_dir):
    """Assemble every request timeline under ``run_dir``: the router
    journal (``router/``) plus every ``rank_NN`` replica journal; a
    directory that IS a single journal (no rank subdirs) loads as one
    replica. Raises ``FileNotFoundError`` when no journal exists."""
    from . import fleet as _fleet

    rd = _fleet.router_dir(run_dir)
    router_run = _fleet.load_journal(rd) if rd else None
    ranks = _fleet.rank_dirs(run_dir)
    rank_runs = {r: _fleet.load_journal(p)
                 for r, p in sorted(ranks.items())}
    if router_run is None and not rank_runs:
        rank_runs = {None: _fleet.load_journal(run_dir)}
    return assemble(router_run, rank_runs)


# -- attribution -------------------------------------------------------------


def attribute(t):
    """Decompose one finished timeline's TTFT and e2e into the exact
    phase contributions (ms) of :data:`PHASES`. None when the request
    never produced a first token + finish (attribution needs both).

    ``rate_limit_wait`` is the router's closed tenant-bucket holds;
    ``router_queue`` is time enqueued at the router beyond that;
    ``requeue`` is time lost on dead replicas (dispatch -> requeue,
    per victim incarnation); ``sched_queue`` is the final replica's
    dispatch -> scheduler admission; ``preempt`` is the final
    incarnation's paired preempt/resume loss (an unpaired tail preempt
    closes at finish). ``prefill = TTFT - (the four queue phases)``
    and ``decode = e2e - TTFT - preempt`` are remainders, so summing
    :data:`PHASES` left-to-right reproduces ``e2e_ms`` exactly."""
    a, ft, f = t["arrival_t"], t["first_token_t"], t["finish_t"]
    if a is None or ft is None or f is None:
        return None
    ttft = (ft - a) * 1e3
    e2e = (f - a) * 1e3
    disp, rqs = t["dispatches"], t["requeues"]
    rate = float(t["rate_wait_ms"]) if disp else 0.0
    router_q = 0.0
    requeue = 0.0
    if disp:
        # dispatch i leaves the router queue it re-entered at the
        # previous requeue (arrival for the first)
        starts = [a] + [r["t"] for r in rqs[:len(disp) - 1]]
        router_q = sum(d["t"] - s for d, s in zip(disp, starts)) \
            * 1e3 - rate
        requeue = sum(r["t"] - d["t"] for d, r in zip(disp, rqs)) * 1e3
        last_d = disp[-1]["t"]
    else:
        last_d = a
    m = t["admit_t"]
    sched_q = (m - last_d) * 1e3 if m is not None else 0.0
    pre = rate + router_q + requeue + sched_q
    prefill = ttft - pre
    # preemption loss inside the FINAL incarnation only: a victim
    # incarnation's preempts are already inside requeue_ms
    pts = [p for p in t["preempts"] if p >= last_d]
    rts = sorted(adm["t"] for adm in t["admits"]
                 if adm["resumed"] and adm["t"] is not None
                 and adm["t"] >= last_d)
    preempt = 0.0
    for i, p in enumerate(pts):
        end = rts[i] if i < len(rts) else f
        preempt += (end - p) * 1e3
    decode = e2e - ttft - preempt
    return {
        "rid": t["rid"], "trace": t["trace"], "tenant": t["tenant"],
        "state": t["state"],
        "replicas": [s["replica"] for s in t["segments"]],
        "dispatches": len(disp), "requeues": len(rqs),
        "preemptions": t["preemptions"],
        "ttft_ms": ttft, "e2e_ms": e2e,
        "rate_limit_wait_ms": rate, "router_queue_ms": router_q,
        "requeue_ms": requeue, "sched_queue_ms": sched_q,
        "prefill_ms": prefill, "preempt_ms": preempt,
        "decode_ms": decode,
    }


def attribute_run(timelines):
    """Every attributable timeline's decomposition, rid-sorted."""
    out = []
    for rid in sorted(timelines):
        att = attribute(timelines[rid])
        if att is not None:
            out.append(att)
    return out


def attribution_sum(att):
    """The canonical left-to-right phase sum — equals ``att["e2e_ms"]``
    exactly under ``ManualClock`` (the self-test invariant)."""
    s = 0.0
    for k in PHASES:
        s += att[k]
    return s


def tail_report(timelines, key="ttft_ms", pct=99.0, k=None):
    """Tail-latency attribution: the worst requests by ``key``
    (``ttft_ms`` or ``e2e_ms``) with their phase decompositions, plus
    fleet-wide phase totals/shares. ``k`` picks the K worst outright;
    otherwise every request at or above the exact ``pct`` percentile
    of ``key`` makes the list. None when nothing is attributable."""
    from .metrics import exact_percentile

    atts = attribute_run(timelines)
    if not atts:
        return None
    ranked = sorted(atts, key=lambda x: (-x[key], x["rid"]))
    if k is not None:
        worst = ranked[:max(0, int(k))]
        threshold = None
    else:
        threshold = exact_percentile([x[key] for x in atts], pct)
        worst = [x for x in ranked if x[key] >= threshold]
    totals = {p: 0.0 for p in PHASES}
    for x in atts:
        for p in PHASES:
            totals[p] += x[p]
    grand = sum(totals.values())
    shares = {p: (totals[p] / grand if grand > 0 else 0.0)
              for p in PHASES}
    return {"requests": len(atts), "key": key, "pct": pct, "k": k,
            "threshold": threshold, "worst": worst,
            "phase_totals_ms": totals, "phase_share": shares}


# -- Perfetto request lanes --------------------------------------------------


def request_lane_events(timelines, t0=None):
    """Render timelines as Chrome-trace events: one "X" slice per
    dispatch segment on ``pid=replica``, one tid per request (shared
    across lanes), and an "s"/"f" flow pair across every requeue — the
    arrow Perfetto draws from the victim replica's lane to the
    re-dispatched one's. ``t0`` anchors the time origin (defaults to
    the earliest segment start); timelines without segments are
    skipped. Thread-name metas label each request row."""
    tls = [timelines[rid] for rid in sorted(timelines)
           if timelines[rid]["segments"]]
    tls = [t for t in tls
           if any(s["start"] is not None for s in t["segments"])]
    if not tls:
        return []
    if t0 is None:
        t0 = min(s["start"] for t in tls for s in t["segments"]
                 if s["start"] is not None)
    events = []
    threads = {}
    flow_id = 0
    for idx, t in enumerate(tls):
        tid = REQUEST_TID_BASE + idx
        name = f"req {t['rid']}"
        prev = None
        for seg in t["segments"]:
            if seg["start"] is None:
                continue
            pid = seg["replica"] if seg["replica"] is not None else 0
            ts_us = (seg["start"] - t0) * 1e6
            end = seg["end"] if seg["end"] is not None else seg["start"]
            events.append({
                "ph": "X", "pid": pid, "tid": tid, "name": name,
                "cat": "req", "ts": ts_us,
                "dur": max(0.0, (end - seg["start"]) * 1e6),
                "args": {"rid": t["rid"], "trace": t["trace"],
                         "tenant": t["tenant"], "seq": seg["seq"],
                         "state": t["state"],
                         "requeue_reason": seg["requeue_reason"]}})
            threads[(pid, tid)] = name
            if prev is not None:
                # the requeue crossing: tail on the victim lane at the
                # segment's end, head on the new lane at re-dispatch
                flow_id += 1
                prev_pid, prev_end_us = prev
                events.append(_trace.flow_start(
                    name, flow_id, prev_pid, tid, prev_end_us,
                    rid=t["rid"]))
                events.append(_trace.flow_finish(
                    name, flow_id, pid, tid, ts_us, rid=t["rid"]))
            prev = (pid, (end - t0) * 1e6)
    for (pid, tid), name in sorted(threads.items()):
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": name}})
    return events


def write_request_trace(timelines, path):
    """Standalone Perfetto export of the request lanes (the merged
    fleet trace embeds the same events via ``obs.fleet.
    merge_chrome_traces(include_requests=True)``). Returns ``{events,
    slices, path}``."""
    events = request_lane_events(timelines)
    for pid in sorted({e["pid"] for e in events}):
        events.append({"ph": "M", "pid": pid, "name": "process_name",
                       "args": {"name": f"replica {pid}"}})
        events.append({"ph": "M", "pid": pid,
                       "name": "process_sort_index",
                       "args": {"sort_index": pid}})
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  default=str)
    return {"events": len(events),
            "slices": sum(1 for e in events if e["ph"] == "X"),
            "path": path}
