#!/usr/bin/env python3
"""torch_serve_bench: synthetic request traces through
``paddle_tpu_torch.serving`` — the port's counterpart of
``tools/serve_bench.py``.

An open-loop synthetic trace — Poisson arrivals, a mixed short/long
prompt and output length distribution, optionally split over weighted
tenants — goes through a ``ServeEngine`` over the built-in ``TinyLM``
(or through a ``serving.fleet`` Router over N in-process replicas), and
the report gives per-request latency percentiles (p50/p99 TTFT, TPOT,
end-to-end), aggregate tokens/s and preemption and KV-pressure counters.
``make_trace``, ``parse_tenants`` and the report functions give what the
JAX tool's give for the same arguments.

``bench_serve_leg`` runs ``bench.py:bench_serve``'s legs on the port:
the two-tenant trace through one engine, journaled and evaluated against
``SERVE_SLO_SPEC``; the live ``/metrics`` scrape over localhost of an
engine with requests in flight; and the trace through a two-replica
Router. Its cold-start leg waits for the AOT executable cache (ROADMAP
Queue 1 item 8) and is left out.

Usage:
    python3 tools/torch_serve_bench.py                      # default trace
    python3 tools/torch_serve_bench.py --requests 64 --rate 100 --json
    python3 tools/torch_serve_bench.py --pages 32 --page-size 8   # pressure
    python3 tools/torch_serve_bench.py --request-report 5         # tail blame
    python3 tools/torch_serve_bench.py --slo '{"ttft_p99_ms": 250}'
    python3 tools/torch_serve_bench.py --self-test [--device cpu]

Everything runs on the CUDA card unless ``--device cpu`` is given;
without a card it raises. ``--self-test`` asserts, with a deterministic
clock where timing matters:
- the paged decode kernel (its plain version on the CPU) matches the
  dense reference on ragged lengths crossing page boundaries;
- a hand-checked scheduler trace: token-budget admission order,
  page-pressure preemption with arrival-order requeue, no starvation;
- the engine's tokens equal the dense oracle's while preemptions occur,
  with hand-computed TTFT on the manual clock;
- the fleet router's dispatch trace (least-outstanding tie-break,
  tenant fairness, rate limits), the multi-tenant trace split and share
  math, and a live two-replica run's gates with its scraped router
  gauges bitwise equal to the router's stats.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), ".."))

# bench.py:300-301's ceilings for the serve leg's exit-time SLO evaluation
SERVE_SLO_SPEC = {"ttft_p99_ms": 30000.0, "tpot_p99_ms": 5000.0,
                  "availability": 0.9, "goodput_tps": 0.01}


def _pctl(xs, q):
    from paddle_tpu_torch.obs.metrics import exact_percentile

    return exact_percentile(xs, q)


def parse_tenants(spec):
    """Parse a ``--tenants`` spec: ``name:rate=R[,weight=W];...`` —
    per-tenant Poisson arrival rate (req/s, required) and fairness
    weight (default 1.0). E.g. ``a:rate=30,weight=3;b:rate=10``."""
    out = {}
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, kvs = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"empty tenant name in {spec!r}")
        d = {"rate": None, "weight": 1.0}
        for kv in kvs.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, eq, v = kv.partition("=")
            if not eq or k.strip() not in d:
                raise ValueError(
                    f"bad tenant field {kv!r} (want rate=/weight=)")
            d[k.strip()] = float(v)
        if d["rate"] is None or d["rate"] <= 0:
            raise ValueError(f"tenant {name!r} needs rate= > 0")
        if d["weight"] <= 0:
            raise ValueError(f"tenant {name!r} needs weight > 0")
        out[name] = d
    if not out:
        raise ValueError(f"empty --tenants spec {spec!r}")
    return out


def make_trace(n_requests, rate, seed=0, vocab=32, short_frac=0.7,
               short_len=(3, 12), long_len=(24, 48),
               out_len=(4, 24), tenants=None):
    """Synthetic open-loop trace: Poisson arrivals (exponential
    inter-arrival at ``rate`` req/s), 70/30 short/long prompt mix,
    uniform output lengths — deterministic in ``seed``.

    With ``tenants`` (a :func:`parse_tenants` dict) each tenant gets
    its OWN Poisson stream at its own ``rate`` (the global ``rate`` is
    ignored), ``n_requests`` split across tenants proportional to rate
    (largest-remainder, so the total is exact), and every item carries
    a ``"tenant"`` tag. The merged trace interleaves by arrival time —
    deterministic in ``seed`` and the tenant names."""
    import numpy as np

    if tenants:
        names = sorted(tenants)
        total_rate = sum(tenants[t]["rate"] for t in names)
        exact = {t: n_requests * tenants[t]["rate"] / total_rate
                 for t in names}
        counts = {t: int(exact[t]) for t in names}
        for t in sorted(names, key=lambda t: (exact[t] - counts[t], t),
                        reverse=True):
            if sum(counts.values()) >= n_requests:
                break
            counts[t] += 1
        trace = []
        for i, t in enumerate(names):
            sub = make_trace(counts[t], tenants[t]["rate"],
                             seed=seed + 7919 * (i + 1), vocab=vocab,
                             short_frac=short_frac,
                             short_len=short_len, long_len=long_len,
                             out_len=out_len)
            for item in sub:
                item["tenant"] = t
            trace += sub
        trace.sort(key=lambda r: r["arrival"])
        return trace
    rng = np.random.RandomState(seed)
    t = 0.0
    trace = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        lo, hi = short_len if rng.rand() < short_frac else long_len
        plen = int(rng.randint(lo, hi + 1))
        trace.append({
            "arrival": t,
            "prompt": [int(x) for x in rng.randint(0, vocab, plen)],
            "max_new_tokens": int(rng.randint(out_len[0],
                                              out_len[1] + 1)),
        })
    return trace


def _tenant_extras(rows, tenants):
    """Per-tenant latency/share extras from finished-request rows
    ``(tenant, tokens, ttft_ms, e2e_ms)``: served-token share vs the
    configured weight share, per-tenant p50/p99, and the headline
    ``tenant_share_err`` = max |share - weight_share| (0.0 with < 2
    tenants — nothing to be unfair between)."""
    wsum = sum(d["weight"] for d in tenants.values())
    by_t = {t: {"finished": 0, "tokens": 0, "_ttft": [], "_e2e": []}
            for t in tenants}
    for tenant, tokens, ttft_ms, e2e_ms in rows:
        d = by_t.setdefault(tenant, {"finished": 0, "tokens": 0,
                                     "_ttft": [], "_e2e": []})
        d["finished"] += 1
        d["tokens"] += int(tokens)
        if ttft_ms is not None:
            d["_ttft"].append(ttft_ms)
        if e2e_ms is not None:
            d["_e2e"].append(e2e_ms)
    total = sum(d["tokens"] for d in by_t.values())
    out, err = {}, 0.0
    for t in sorted(by_t):
        d = by_t[t]
        share = d["tokens"] / total if total else 0.0
        wshare = tenants[t]["weight"] / wsum if t in tenants and wsum \
            else 0.0
        if len(by_t) >= 2 and total:
            err = max(err, abs(share - wshare))
        out[t] = {
            "finished": d["finished"], "tokens": d["tokens"],
            "share": share, "weight_share": wshare,
            "ttft_p50_ms": _pctl(d["_ttft"], 50),
            "ttft_p99_ms": _pctl(d["_ttft"], 99),
            "e2e_p50_ms": _pctl(d["_e2e"], 50),
            "e2e_p99_ms": _pctl(d["_e2e"], 99),
        }
    return out, err


def run_bench(n_requests=32, rate=50.0, pages=128, page_size=8,
              seed=0, token_budget=512, heads=2, head_dim=8,
              vocab=32, tenants=None, device=None, trace_vocab=None,
              keep_engine=False):
    """Drive the trace through a real-clock engine on ``device``; returns
    the report dict (and the engine with ``keep_engine``). Open loop:
    requests are submitted when their arrival time passes, whether or
    not the engine kept up (so TTFT includes queue time under overload,
    as in a real serving SLO). ``tenants`` (a :func:`parse_tenants`
    dict) tags the trace per tenant and adds the per-tenant
    share/latency extras to the report. The trace's token ids are drawn
    below ``trace_vocab`` (default ``vocab``): the same trace can go
    through a model of another width."""
    from paddle_tpu_torch.serving import (PagedKVCache, Scheduler,
                                          ServeEngine, TinyLM)

    trace = make_trace(n_requests, rate, seed=seed,
                       vocab=trace_vocab or vocab, tenants=tenants)
    model = TinyLM(vocab_size=vocab, num_heads=heads, head_dim=head_dim,
                   seed=seed, device=device)
    cache = PagedKVCache(pages, page_size, heads, head_dim, device=device)
    eng = ServeEngine(model, cache,
                      scheduler=Scheduler(cache,
                                          token_budget=token_budget))
    t_start = time.monotonic()
    pending = list(trace)
    rejected = 0
    while pending or not eng.scheduler.idle:
        now = time.monotonic() - t_start
        while pending and pending[0]["arrival"] <= now:
            r = pending.pop(0)
            try:
                eng.submit(r["prompt"],
                           max_new_tokens=r["max_new_tokens"],
                           arrival_t=t_start + r["arrival"],
                           tenant=r.get("tenant"))
            except ValueError:
                # admission control: a request that can NEVER fit the
                # pool is refused at the door, not served truncated
                rejected += 1
        if eng.scheduler.idle:
            if pending:  # engine ahead of the trace: wait for arrival
                time.sleep(max(0.0, pending[0]["arrival"] - now))
            continue
        if not eng.step() and not pending:
            # gridlock: queued work the pool/budget can never admit
            # and no future arrival will change that — report what
            # finished instead of busy-spinning forever
            break
    wall = time.monotonic() - t_start
    rep = _report(eng, wall, n_requests, tenants=tenants)
    rep["rejected"] = rejected
    rep["stuck"] = eng.scheduler.queue_depth
    return (rep, eng) if keep_engine else rep


def replay_manual(eng, clock, trace, step_s=1e-3):
    """The trace through ``eng``, whose scheduler runs on the
    ``ManualClock`` ``clock``: each request is submitted once the clock
    reaches its arrival, and each engine step advances the clock by
    ``step_s`` (when the engine is idle, the clock jumps to the next
    arrival). Deterministic: the same trace gives the same steps,
    preemptions and tokens on every run, in either package's engine.
    Returns the submitted requests in trace order."""
    reqs = []
    pending = list(trace)
    while pending or not eng.scheduler.idle:
        while pending and pending[0]["arrival"] <= clock.now:
            r = pending.pop(0)
            reqs.append(eng.submit(r["prompt"],
                                   max_new_tokens=r["max_new_tokens"],
                                   arrival_t=r["arrival"],
                                   tenant=r.get("tenant")))
        if eng.scheduler.idle:
            clock.now = max(clock.now, pending[0]["arrival"])
            continue
        if not eng.step() and not pending:
            break
        clock.advance(step_s)
    return reqs


def request_report(run_dir, k):
    """Tail-latency attribution for a journaled bench run: the K
    worst-TTFT requests with their exact phase decompositions (see
    ``paddle_tpu_torch.obs.reqtrace``), plus the fleet-wide phase
    shares. Returns the ``tail_report`` dict (None when nothing is
    attributable — e.g. the run finished no requests)."""
    from paddle_tpu_torch.obs import reqtrace

    try:
        tls = reqtrace.assemble_run(run_dir)
    except (FileNotFoundError, OSError):
        return None
    return reqtrace.tail_report(tls, key="ttft_ms", k=k)


def _print_request_report(rep):
    from paddle_tpu_torch.obs.reqtrace import PHASES

    if rep is None:
        print("request report: no attributable requests")
        return
    # column labels for PHASES, in canonical order
    short = ("rate", "router", "requeue", "sched", "prefill",
             "preempt", "decode")
    print(f"worst {len(rep['worst'])} of {rep['requests']} requests "
          "by TTFT (phase ms):")
    print("  " + "rid".ljust(10) + "".join(
        c.rjust(12) for c in ("ttft", "e2e") + tuple(short)))
    for w in rep["worst"]:
        row = [w["ttft_ms"], w["e2e_ms"]] + [w[p] for p in PHASES]
        print("  " + str(w["rid"]).ljust(10)
              + "".join(f"{v:12.3f}" for v in row))
    share = rep["phase_share"]
    print("  phase share: " + "  ".join(
        f"{s}={share[p]:.1%}" for s, p in zip(short, PHASES)
        if share[p] > 0))


def _report(eng, wall_s, n_requests, tenants=None):
    fin = eng.finished
    ttft = [(r.first_token_t - r.arrival_t) * 1e3 for r in fin
            if r.first_token_t is not None]
    tpot = [(r.finish_t - r.first_token_t) * 1e3 / (len(r.generated) - 1)
            for r in fin if len(r.generated) > 1]
    e2e = [(r.finish_t - r.arrival_t) * 1e3 for r in fin]
    tokens = sum(len(r.generated) for r in fin)
    st = eng.cache.stats()
    rep = {
        "requests": n_requests, "finished": len(fin),
        "tokens": tokens, "wall_s": wall_s,
        "tokens_per_sec": tokens / wall_s if wall_s else None,
        "ttft_p50_ms": _pctl(ttft, 50), "ttft_p99_ms": _pctl(ttft, 99),
        "tpot_p50_ms": _pctl(tpot, 50), "tpot_p99_ms": _pctl(tpot, 99),
        "e2e_p50_ms": _pctl(e2e, 50), "e2e_p99_ms": _pctl(e2e, 99),
        "preemptions": eng.scheduler.preemptions,
        "engine_steps": eng.stats()["steps"],
        "kv_used_pages": st["used_pages"],
        "kv_fragmentation": st["fragmentation"],
    }
    if tenants:
        rows = [(r.tenant or "default", len(r.generated),
                 None if r.first_token_t is None
                 else (r.first_token_t - r.arrival_t) * 1e3,
                 None if r.finish_t is None
                 else (r.finish_t - r.arrival_t) * 1e3)
                for r in fin]
        rep["tenants"], rep["tenant_share_err"] = \
            _tenant_extras(rows, tenants)
    return rep


# -- fleet mode (--replicas N) ------------------------------------------------


def run_bench_fleet(n_requests=32, rate=50.0, replicas=2, pages=128,
                    page_size=8, seed=0, token_budget=512, heads=2,
                    head_dim=8, vocab=32, keep_router=False,
                    trace_kw=None, tenants=None, device=None,
                    trace_vocab=None):
    """The same open-loop Poisson trace through a ``serving.fleet``
    Router over N in-process replicas on ``device``: aggregate p50/p99
    TTFT/TPOT across the whole fleet, a per-replica breakdown, and
    ``router_overhead_ms`` — wall time spent inside the router's
    dispatch/poll/health decisions (NOT engine compute), the dispatch-
    layer tax the single-engine bench can't see. ``tenants`` (a
    :func:`parse_tenants` dict) additionally configures the router's
    weighted-deficit fairness (``TenantPolicy(weight=...)``), tags
    submissions per tenant, and adds the per-tenant share/latency
    extras to the report. (The JAX tool's ``aot_cache_dir`` waits for
    the AOT executable cache, ROADMAP Queue 1 item 8.)"""
    from paddle_tpu_torch.serving.fleet import (ReplicaPool, ReplicaSpec,
                                                Router, TenantPolicy)

    trace = make_trace(n_requests, rate, seed=seed,
                       vocab=trace_vocab or vocab, tenants=tenants,
                       **(trace_kw or {}))
    spec = ReplicaSpec(vocab_size=vocab, num_heads=heads,
                       head_dim=head_dim, seed=seed, pages=pages,
                       page_size=page_size, token_budget=token_budget,
                       warm=False, device=device)
    pool = ReplicaPool(spec, replicas=replicas, mode="local")
    router = Router(pool, tenants=None if not tenants else {
        t: TenantPolicy(weight=d["weight"])
        for t, d in tenants.items()})
    t_start = time.monotonic()
    pending = list(trace)
    rejected = 0
    router_s = 0.0
    while True:
        now = time.monotonic() - t_start
        while pending and pending[0]["arrival"] <= now:
            r = pending.pop(0)
            try:
                router.submit(r["prompt"],
                              max_new_tokens=r["max_new_tokens"],
                              arrival_t=t_start + r["arrival"],
                              tenant=r.get("tenant"))
            except ValueError:
                rejected += 1
        if not router.inflight and not router.queue_depth:
            if not pending:
                break
            time.sleep(max(0.0, pending[0]["arrival"] - now))
            continue
        t0 = time.perf_counter()
        router.check_replicas()
        router.dispatch()
        router_s += time.perf_counter() - t0
        pumped = pool.pump()
        t0 = time.perf_counter()
        router.poll()
        router_s += time.perf_counter() - t0
        if not pumped and not router.inflight and not pending:
            break  # gridlock: nothing dispatchable, nothing arriving
    wall = time.monotonic() - t_start
    rep = _fleet_report(router, wall, n_requests, tenants=tenants)
    rep["rejected"] = rejected
    rep["stuck"] = router.queue_depth
    rep["router_overhead_ms"] = router_s * 1e3
    if keep_router:
        return rep, router
    router.close()
    return rep


def _fleet_report(router, wall_s, n_requests, tenants=None):
    fin = [r for r in router.completed if r.state == "FINISHED"]
    ttft = [(r.first_token_t - r.arrival_t) * 1e3 for r in fin
            if r.first_token_t is not None]
    tpot = [(r.finish_t - r.first_token_t) * 1e3 / (len(r.tokens) - 1)
            for r in fin if len(r.tokens) > 1
            and r.first_token_t is not None]
    e2e = [(r.finish_t - r.arrival_t) * 1e3 for r in fin
           if r.finish_t is not None]
    tokens = sum(len(r.tokens) for r in fin)
    st = router.stats()
    per_replica = {}
    for r in fin:
        d = per_replica.setdefault(r.replica_id, {
            "finished": 0, "tokens": 0, "preemptions": 0,
            "requeues": 0})
        d["finished"] += 1
        d["tokens"] += len(r.tokens)
        d["preemptions"] += r.preemptions
        d["requeues"] += r.requeues
    rep = {
        "requests": n_requests, "finished": len(fin),
        "replicas": st["replicas"], "tokens": tokens, "wall_s": wall_s,
        "tokens_per_sec": tokens / wall_s if wall_s else None,
        "ttft_p50_ms": _pctl(ttft, 50), "ttft_p99_ms": _pctl(ttft, 99),
        "tpot_p50_ms": _pctl(tpot, 50), "tpot_p99_ms": _pctl(tpot, 99),
        "e2e_p50_ms": _pctl(e2e, 50), "e2e_p99_ms": _pctl(e2e, 99),
        "dispatched": st["dispatched"], "requeued": st["requeued"],
        "per_replica": per_replica,
    }
    if tenants:
        rows = [(r.tenant or "default", len(r.tokens),
                 None if r.first_token_t is None
                 else (r.first_token_t - r.arrival_t) * 1e3,
                 None if r.finish_t is None
                 else (r.finish_t - r.arrival_t) * 1e3)
                for r in fin]
        rep["tenants"], rep["tenant_share_err"] = \
            _tenant_extras(rows, tenants)
    return rep


# -- bench.py:bench_serve's legs ----------------------------------------------


def _export_leg(vocab, heads, head_dim, device):
    """bench.py:407-446: an engine with requests still in flight, its
    ``/metrics`` scraped once over localhost HTTP; the scraped running
    gauge must equal the engine's running set. Returns ``(scrape ms,
    gauge ok, the engine's decode steps)``."""
    import urllib.request

    from paddle_tpu_torch.obs import export
    from paddle_tpu_torch.serving import PagedKVCache, ServeEngine, TinyLM

    eng = ServeEngine(TinyLM(vocab_size=vocab, num_heads=heads,
                             head_dim=head_dim, seed=0, device=device),
                      PagedKVCache(32, 4, heads, head_dim, max_seq_len=32,
                                   device=device))
    for prompt in ([3, 1, 4], [1, 5], [9]):
        eng.submit(prompt, max_new_tokens=6)
    eng.run(max_steps=2)  # mid-run: decodes still in flight
    expected_running = float(len(eng.scheduler.running))
    exp = export.MetricsExporter(engines=[eng])
    port = exp.start()
    try:
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as resp:
            body = resp.read().decode("utf-8")
        scrape_ms = (time.perf_counter() - t0) * 1e3
    finally:
        exp.stop()
    vals = export.parse_prometheus_text(body)
    running = vals.get(f'paddle_tpu_serving_slo_running'
                       f'{{replica="{eng.replica_id}"}}')
    eng.run()  # drain
    ok = bool(running is not None and running == expected_running
              and expected_running >= 1.0)
    return scrape_ms, ok, eng.usage.decode_steps


def bench_serve_leg(requests=48, rate=100.0, pages=256, page_size=16,
                    vocab=32, heads=2, head_dim=8, device=None,
                    detail=None, journal_dir=None):
    """``bench.py:bench_serve`` (``:304-465``) on the port: the weighted
    two-tenant trace (rates 3:1, weights 3:1) through one engine,
    journaled and evaluated against ``SERVE_SLO_SPEC``; the export
    scrape leg; and the same trace class (``min(requests, 24)``
    requests) through a two-replica Router. Returns the keys the JAX
    leg returns, but the cold-start leg's (ROADMAP Queue 1 item 8).

    ``vocab``, ``heads`` and ``head_dim`` set every leg's TinyLM (bench's
    is 32, 2 x 8); the traces' token ids stay below 32 at any width.
    ``detail``, a dict when given, receives what the leg's checks read:
    ``engine`` and ``fleet`` (the two runs' full reports, with
    ``rejected`` and ``stuck``), ``requests`` (the engine run's finished
    requests as ``(prompt, max_new_tokens, generated)``), ``tokens``
    (each fleet request's prompt, max_new_tokens and tokens, in arrival
    order) and ``decode_steps`` of each engine (``engine``, ``export``,
    ``fleet``: one per replica). The engine leg journals into
    ``journal_dir`` when one is given, and leaves it there; else into a
    temporary directory it removes."""
    from paddle_tpu_torch.obs import journal
    from paddle_tpu_torch.obs.slo import evaluate_run

    width = dict(vocab=vocab, heads=heads, head_dim=head_dim,
                 device=device, trace_vocab=32)
    tenants = parse_tenants(
        f"a:rate={0.75 * rate:g},weight=3;b:rate={0.25 * rate:g},weight=1")
    slo_dir = journal_dir or tempfile.mkdtemp(prefix="pt_serve_slo_")
    try:
        journal.start_run(slo_dir)
        try:
            rep, eng = run_bench(n_requests=requests, rate=rate,
                                 pages=pages, page_size=page_size,
                                 tenants=tenants, keep_engine=True,
                                 **width)
        finally:
            journal.end_run()
        violations = evaluate_run(slo_dir, SERVE_SLO_SPEC,
                                  duration_s=rep["wall_s"])["violations"]
    finally:
        if journal_dir is None:
            shutil.rmtree(slo_dir, ignore_errors=True)
    out = {k: rep.get(k) for k in (
        "tokens_per_sec", "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
        "tpot_p99_ms", "requests", "finished", "preemptions",
        "kv_fragmentation", "tenant_share_err")}
    out["slo_violations"] = violations
    print("serve leg: the cold-start leg (bench.py:371-406) waits for the "
          "AOT executable cache (ROADMAP Queue 1 item 8)", file=sys.stderr)
    scrape_ms, gauge_ok, export_steps = _export_leg(
        vocab, heads, head_dim, device)
    out.update({"export_scrape_ms": scrape_ms, "export_gauge_ok": gauge_ok})
    rep2, router = run_bench_fleet(
        n_requests=min(requests, 24), rate=rate, replicas=2, pages=pages,
        page_size=page_size, tenants=tenants, keep_router=True, **width)
    try:
        fleet_steps = [e.usage.decode_steps
                       for e in router.pool.local_engines()]
        fleet_tokens = [(r.prompt, r.max_new_tokens, list(r.tokens))
                        for r in sorted(router.completed,
                                        key=lambda r: r.arrival_t)]
    finally:
        router.close()
    out.update({
        "replicas": rep2["replicas"],
        "router_overhead_ms": rep2["router_overhead_ms"],
        "fleet_tokens_per_sec": rep2["tokens_per_sec"],
        "fleet_ttft_p99_ms": rep2["ttft_p99_ms"],
        "fleet_requeued": rep2["requeued"],
        "fleet_tenant_share_err": rep2.get("tenant_share_err"),
    })
    if detail is not None:
        detail.update({
            "engine": rep, "fleet": rep2,
            "requests": [(r.prompt, r.max_new_tokens, list(r.generated))
                         for r in eng.finished],
            "tokens": fleet_tokens,
            "decode_steps": {"engine": eng.usage.decode_steps,
                             "export": export_steps,
                             "fleet": fleet_steps}})
    return out


# -- self-test ----------------------------------------------------------------


def _check(failures, cond, msg):
    if not cond:
        failures.append(msg)


def _test_paged_vs_dense(failures, device):
    """Kernel numerics: ragged lengths (1 token; exactly one page; a
    page-boundary crossing; multiple pages) through a SHUFFLED page
    assignment must match the dense masked reference in fp32."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops.kernels.paged_attention import (
        dense_decode_reference, paged_decode_attention)

    rng = np.random.RandomState(0)
    B, H, D, page, P, maxp = 4, 2, 16, 8, 32, 5
    lengths = np.array([1, 8, 9, 37], np.int32)
    L = maxp * page
    k_dense = rng.randn(B, L, H, D).astype(np.float32)
    v_dense = rng.randn(B, L, H, D).astype(np.float32)
    q = rng.randn(B, H, D).astype(np.float32)
    k_pages = np.zeros((P, page, H, D), np.float32)
    v_pages = np.zeros((P, page, H, D), np.float32)
    table = np.zeros((B, maxp), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        for p in range(-(-int(lengths[b]) // page)):
            pid = free.pop()
            table[b, p] = pid
            lo, hi = p * page, min((p + 1) * page, int(lengths[b]))
            k_pages[pid, :hi - lo] = k_dense[b, lo:hi]
            v_pages[pid, :hi - lo] = v_dense[b, lo:hi]

    def dev(a):
        return torch.from_numpy(a).to(device)

    out = paged_decode_attention(dev(q), dev(k_pages), dev(v_pages),
                                 dev(table), dev(lengths))
    ref = dense_decode_reference(dev(q), dev(k_dense), dev(v_dense),
                                 dev(lengths))
    err = float((out - ref).abs().max())
    _check(failures, err < 2e-5,
           f"paged kernel diverges from dense reference: max|Δ|={err}")


def _test_scheduler_trace(failures, device):
    """Hand-checked trace. Pool: 4 pages of 4 (3 usable). Budget 8.
    Three 4-token prompts arriving at t=0,1,2 must admit exactly
    [r1, r2] (budget exhausted), leave r3 queued on page headroom,
    then under decode growth r2 must self-preempt (r1, the oldest, is
    never a victim), requeue AHEAD of r3 (original arrival), and the
    pool must balance to zero."""
    from paddle_tpu_torch.serving import (ManualClock, PagedKVCache,
                                          Request, Scheduler)
    from paddle_tpu_torch.serving.kv_cache import CachePressureError

    clock = ManualClock()
    cache = PagedKVCache(4, 4, 1, 1, device=device)
    sched = Scheduler(cache, token_budget=8, clock=clock)
    reqs = []
    for i in range(3):
        clock.now = float(i)
        reqs.append(sched.submit(Request(prompt=[1, 2, 3, 4],
                                         rid=f"r{i + 1}")))
    r1, r2, r3 = reqs
    clock.now = 3.0
    b1 = sched.schedule()
    _check(failures, [r.rid for r in b1.prefills] == ["r1", "r2"],
           f"admission order {[r.rid for r in b1.prefills]} != [r1, r2]")
    _check(failures, not b1.decodes, "phantom decodes in first batch")
    _check(failures, r1.admit_t == 3.0 and r2.admit_t == 3.0,
           f"admit timestamps not from the injected clock: "
           f"{r1.admit_t}, {r2.admit_t}")
    _check(failures, sched.queue_depth == 1 and r3.state == "QUEUED",
           "r3 must stay queued (token budget spent, no page headroom)")
    # decode growth: r1 extends 4->5 tokens (takes the last free page);
    # r2's extend then hits pressure, and with r1 (oldest) protected
    # there is no victim — preempt_for returns None, r2 self-preempts
    sched.extend(r1, 1)
    hit_pressure = False
    try:
        sched.extend(r2, 1)
    except CachePressureError:
        hit_pressure = True
    _check(failures, hit_pressure, "r2's extend must hit page pressure")
    _check(failures, sched.preempt_for(r2) is None,
           "preempt_for(r2) must refuse to preempt the oldest (r1)")
    clock.now = 4.0
    sched.preempt(r2)
    _check(failures, r2.state == "PREEMPTED" and r2.preemptions == 1,
           f"r2 not preempted cleanly: {r2.state}, {r2.preemptions}")
    _check(failures, [r.rid for r in sched._queue] == ["r2", "r3"],
           f"requeue must keep arrival order, got "
           f"{[r.rid for r in sched._queue]}")
    b2 = sched.schedule()
    _check(failures, [r.rid for r in b2.decodes] == ["r1"],
           "only r1 should decode under pressure")
    _check(failures, not b2.prefills,
           "r2 cannot re-admit while r1 holds the pool")
    sched.finish(r1)
    b3 = sched.schedule()
    # r1's 2 pages return: budget 8 now admits BOTH 4-token prompts,
    # preempted r2 strictly before later-arrived r3
    _check(failures, [r.rid for r in b3.prefills] == ["r2", "r3"],
           f"re-admission must be [r2, r3] (arrival order, preempted "
           f"r2 first), got {[r.rid for r in b3.prefills]}")
    sched.finish(r2)
    sched.finish(r3)
    st = cache.stats()
    _check(failures, st["used_pages"] == 0 and cache.verify(),
           f"pool leaked pages after teardown: {st}")


def _test_engine_vs_oracle(failures, device):
    """End-to-end: a pressured engine (preemptions forced) must emit
    exactly the dense oracle's greedy tokens, with hand-computed TTFT
    from the manual clock and a balanced pool after a mid-flight
    cancellation."""
    import numpy as np

    from paddle_tpu_torch.serving import (ManualClock, PagedKVCache,
                                          Scheduler, ServeEngine, TinyLM)

    model = TinyLM(vocab_size=32, num_heads=2, head_dim=8, seed=0,
                   device=device)
    cache = PagedKVCache(6, 4, 2, 8, max_seq_len=16, device=device)
    clock = ManualClock()
    eng = ServeEngine(model, cache,
                      scheduler=Scheduler(cache, token_budget=64,
                                          clock=clock))
    rng = np.random.RandomState(7)
    prompts = [list(rng.randint(0, 32, 5)) for _ in range(3)]
    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    # a 4th request cancelled mid-flight: pages must still balance
    doomed = eng.submit(list(rng.randint(0, 32, 5)), max_new_tokens=8)
    clock.advance(1.0)
    eng.step()
    eng.cancel(doomed)
    eng.run(max_steps=300)
    _check(failures, len(eng.finished) == 3,
           f"{len(eng.finished)}/3 requests finished")
    for r, p in zip(reqs, prompts):
        ref = model.reference_generate(p, 8)
        _check(failures, r.generated == ref,
               f"{r.rid} tokens {r.generated} != oracle {ref} "
               f"(preemptions={r.preemptions})")
    _check(failures, eng.scheduler.preemptions >= 1,
           "pool was sized to force >=1 preemption; got none "
           "(pressure path untested)")
    st = cache.stats()
    _check(failures, st["used_pages"] == 0 and cache.verify(),
           f"pool leaked after cancel+finish: {st}")
    # TTFT = first_token_t - arrival_t on the injected clock: every
    # request arrives at t=0.0 and the ones admitted in the FIRST step
    # (admit_t == 1.0) emit their first token inside it, so their TTFT
    # is exactly 1.0 — and at least one request MUST match, or this
    # check would be vacuous
    checked = 0
    for r in reqs:
        if r.first_token_t is not None and r.admit_t == 1.0:
            checked += 1
            _check(failures,
                   abs((r.first_token_t - r.arrival_t) - 1.0) < 1e-12,
                   f"{r.rid} TTFT {r.first_token_t - r.arrival_t} != "
                   "1.0 on the manual clock")
    _check(failures, checked >= 1,
           "TTFT check matched no request (first-step admissions "
           "should exist) — the assertion went vacuous")


def _test_router_trace(failures, device):
    """Hand-checked fleet dispatch on a ManualClock: least-outstanding-
    tokens with lowest-id tie-break, weighted-deficit tenant fairness,
    and a token-bucket rate limit that holds ONE tenant back without
    blocking the other."""
    from paddle_tpu_torch.serving import ManualClock
    from paddle_tpu_torch.serving.fleet import (ReplicaPool, ReplicaSpec,
                                                Router, TenantPolicy)

    clock = ManualClock()
    spec = ReplicaSpec(vocab_size=32, pages=64, page_size=4,
                       max_seq_len=32, token_budget=128, device=device)
    pool = ReplicaPool(spec, replicas=2, mode="local", clock=clock)
    router = Router(pool, clock=clock, tenants={
        "a": TenantPolicy(weight=1.0),
        "b": TenantPolicy(weight=1.0),
        "lim": TenantPolicy(weight=1.0, rate=1.0, burst=4.0),
    })
    # least-loaded + tie-break: costs 8, 4, 2 -> rep0 (tie: lowest id),
    # rep1 (0 < 8), rep1 again (4 < 8)
    for plen, new in ((4, 4), (2, 2), (1, 1)):
        router.submit([1] * plen, max_new_tokens=new, tenant="a")
    pairs = router.dispatch()
    _check(failures, [p[1] for p in pairs] == [0, 1, 1],
           f"least-outstanding trace {pairs} != replicas [0, 1, 1]")
    # fairness: a floods 4 x cost-4, b queues 2 x cost-4 — deficit
    # round-robin must interleave a/b, not serve a's flood first
    clock.advance(1.0)
    for i in range(4):
        router.submit([1, 2], max_new_tokens=2, tenant="a", rid=f"a{i}")
    for i in range(2):
        router.submit([3, 4], max_new_tokens=2, tenant="b", rid=f"b{i}")
    order = [rid for rid, _ in router.dispatch()]
    _check(failures, order == ["b0", "b1", "a0", "a1", "a2", "a3"],
           f"fairness order {order}: b (behind on served tokens) must "
           "catch up before a's flood continues")
    # rate limit: burst 4 admits one cost-4 request; the next waits for
    # the bucket (1 token/s), while an unlimited tenant sails past
    clock.advance(1.0)
    router.submit([5, 6], max_new_tokens=2, tenant="lim", rid="l0")
    router.submit([5, 6], max_new_tokens=2, tenant="lim", rid="l1")
    router.submit([7, 8], max_new_tokens=2, tenant="a", rid="a4")
    order = [rid for rid, _ in router.dispatch()]
    _check(failures, order == ["l0", "a4"],
           f"rate-limit trace {order} != ['l0', 'a4'] (l1 must wait "
           "for the bucket, a4 must not be blocked by it)")
    _check(failures, router.queue_depth == 1,
           f"l1 should still be queued, depth={router.queue_depth}")
    clock.advance(4.0)   # bucket refills 4 tokens
    order = [rid for rid, _ in router.dispatch()]
    _check(failures, order == ["l1"],
           f"after refill {order} != ['l1']")
    # rejection mirrors ServeEngine.submit: oversize at the door
    try:
        router.submit(list(range(20)), max_new_tokens=20)
        _check(failures, False, "oversize request not rejected")
    except ValueError:
        pass
    _check(failures, router.stats()["rejected"] == 1,
           "rejection not counted in router stats")
    router.close()


def _test_tenant_trace(failures, device):
    """Deterministic multi-tenant trace + share math: the spec parser,
    largest-remainder count split (total exact), arrival-sorted merge,
    and hand-computed ``tenant_share_err`` from ``_tenant_extras``."""
    tn = parse_tenants("a:rate=30,weight=3;b:rate=10")
    _check(failures,
           tn == {"a": {"rate": 30.0, "weight": 3.0},
                  "b": {"rate": 10.0, "weight": 1.0}},
           f"parse_tenants mis-parsed: {tn}")
    for bad in ("", "a:weight=2", "a:rate=0", "a:rate=5,burst=1"):
        try:
            parse_tenants(bad)
            _check(failures, False,
                   f"parse_tenants accepted bad spec {bad!r}")
        except ValueError:
            pass
    trace = make_trace(8, 999.0, seed=3, tenants=tn)
    counts = {}
    for r in trace:
        counts[r["tenant"]] = counts.get(r["tenant"], 0) + 1
    _check(failures, counts == {"a": 6, "b": 2},
           f"rate-proportional split {counts} != {{'a': 6, 'b': 2}} "
           "(8 requests at 30:10)")
    _check(failures,
           all(trace[i]["arrival"] <= trace[i + 1]["arrival"]
               for i in range(len(trace) - 1)),
           "merged tenant trace not sorted by arrival")
    _check(failures, trace == make_trace(8, 999.0, seed=3, tenants=tn),
           "tenant trace not deterministic in seed")
    # hand-computed shares: a serves 60 of 100 tokens (share 0.6) vs
    # weight share 0.75, b 0.4 vs 0.25 -> share_err = 0.15 both ways
    rows = [("a", 60, 1.0, 2.0), ("b", 40, 3.0, 4.0)]
    per, err = _tenant_extras(rows, tn)
    _check(failures, abs(err - 0.15) < 1e-12,
           f"tenant_share_err {err} != hand-computed 0.15")
    _check(failures,
           per["a"]["share"] == 0.6 and per["a"]["weight_share"] == 0.75
           and per["b"]["share"] == 0.4
           and per["b"]["weight_share"] == 0.25,
           f"share math off: {per}")
    _check(failures,
           per["a"]["ttft_p99_ms"] == 1.0
           and per["b"]["e2e_p99_ms"] == 4.0,
           f"per-tenant percentiles off: {per}")
    # < 2 tenants: no counterpart to be unfair to
    _, err1 = _tenant_extras([("a", 60, 1.0, 2.0)],
                             {"a": {"rate": 1.0, "weight": 1.0}})
    _check(failures, err1 == 0.0,
           f"single-tenant share_err {err1} != 0.0")


def _test_fleet_bench_gates(failures, device):
    """A real 2-replica fleet run: aggregate-percentile gates,
    per-replica breakdown consistency, oracle-identical tokens, and a
    LIVE HTTP scrape of the router metrics endpoint matching
    ``router.stats()`` BITWISE."""
    import urllib.request

    from paddle_tpu_torch.obs.export import (MetricsExporter,
                                             parse_prometheus_text)
    from paddle_tpu_torch.serving import TinyLM

    trace_kw = dict(short_frac=1.0, out_len=(4, 10))
    tenants = parse_tenants("a:rate=100,weight=1;b:rate=100,weight=1")
    rep, router = run_bench_fleet(n_requests=12, rate=200.0,
                                  replicas=2, pages=64, page_size=8,
                                  token_budget=256, keep_router=True,
                                  trace_kw=trace_kw, tenants=tenants,
                                  device=device)
    try:
        _check(failures, rep["replicas"] == 2,
               f"fleet bench ran {rep['replicas']} replicas, want 2")
        _check(failures,
               rep["finished"] + rep["rejected"] == rep["requests"],
               f"requests lost: {rep['finished']} finished + "
               f"{rep['rejected']} rejected != {rep['requests']}")
        for q in ("ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
                  "tpot_p99_ms"):
            _check(failures, rep[q] is not None and rep[q] > 0.0,
                   f"aggregate gate {q} missing/non-positive: {rep[q]}")
        _check(failures, rep["ttft_p99_ms"] >= rep["ttft_p50_ms"],
               f"p99 {rep['ttft_p99_ms']} < p50 {rep['ttft_p50_ms']}")
        per = rep["per_replica"]
        _check(failures,
               sum(d["finished"] for d in per.values())
               == rep["finished"] and len(per) == 2,
               f"per-replica breakdown {per} does not partition "
               f"{rep['finished']} finished requests over 2 replicas")
        # oracle identity across the whole fleet (the trace is sized
        # to reject nothing; a reject would misalign the zip)
        _check(failures, rep["rejected"] == 0 and rep["finished"] == 12,
               f"fleet run should finish all 12: {rep['finished']} "
               f"finished, {rep['rejected']} rejected")
        model = TinyLM(vocab_size=32, num_heads=2, head_dim=8, seed=0,
                       device=device)
        trace = make_trace(12, 200.0, seed=0, vocab=32,
                           tenants=tenants, **trace_kw)
        by_arrival = sorted(router.completed,
                            key=lambda r: r.arrival_t)
        if len(by_arrival) == len(trace):
            for r, t in zip(by_arrival, trace):
                ref = model.reference_generate(t["prompt"],
                                               t["max_new_tokens"])
                _check(failures, r.tokens == ref,
                       f"{r.rid} (replica {r.replica_id}) tokens != "
                       "single-engine oracle")
        # per-tenant extras from the live routed run: shares partition
        # the served tokens and the headline share_err is their
        # measured-vs-weight gap (weights are equal here, so it is
        # |share_a - 0.5| twice over)
        per_t = rep.get("tenants") or {}
        _check(failures, set(per_t) == {"a", "b"},
               f"fleet tenant extras missing tenants: {sorted(per_t)}")
        _check(failures,
               sum(d["tokens"] for d in per_t.values())
               == rep["tokens"],
               f"tenant token shares do not partition the total: "
               f"{per_t} vs {rep['tokens']}")
        if per_t:
            want = abs(per_t["a"]["share"] - 0.5)
            _check(failures,
                   abs(rep.get("tenant_share_err", -1.0) - want)
                   < 1e-12,
                   f"tenant_share_err {rep.get('tenant_share_err')} "
                   f"!= |share_a - 0.5| = {want}")
        # scrapeable router endpoint, gauges == stats bitwise
        st = router.stats()
        exp = MetricsExporter(engines=[], router=router)
        port = exp.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics",
                    timeout=10) as resp:
                body = resp.read().decode("utf-8")
        finally:
            exp.stop()
        vals = parse_prometheus_text(body)
        pre = "paddle_tpu_fleet_router_"
        for key in ("dispatched", "completed", "requeued", "rejected",
                    "queue_depth", "replicas"):
            _check(failures, vals.get(pre + key) == float(st[key]),
                   f"scraped {key}={vals.get(pre + key)} != router "
                   f"truth {st[key]} (bitwise gate)")
        for key in ("ttft_ms", "tpot_ms", "e2e_ms"):
            if st.get(key):
                for q in ("p50", "p99"):
                    skey = pre + key + '{q="' + q + '"}'
                    _check(
                        failures, vals.get(skey) == st[key][q],
                        f"scraped {key} {q} != stats bitwise: "
                        f"{vals.get(skey)} vs {st[key][q]}")
    finally:
        router.close()


def self_test(device=None):
    failures = []
    for test in (_test_paged_vs_dense, _test_scheduler_trace,
                 _test_engine_vs_oracle, _test_router_trace,
                 _test_tenant_trace, _test_fleet_bench_gates):
        test(failures, device)
    for line in failures:
        print(f"  FAILED — {line}")
    if failures:
        print(f"self-test FAILED: {len(failures)} check(s)")
        return 1
    print("self-test passed: paged decode matches the dense reference "
          "on ragged page-crossing batches, the hand-checked scheduler "
          "trace holds exactly (budget admission, oldest-protected "
          "preemption, arrival-order requeue, zero-leak teardown), "
          "the pressured engine reproduces the dense oracle's tokens "
          "with manual-clock-exact TTFT, the fleet router's dispatch "
          "trace is hand-exact (least-outstanding tie-break, tenant "
          "fairness, rate limits), the multi-tenant trace splits "
          "rate-proportionally with hand-exact share math, and a live "
          "2-replica run passes the aggregate-percentile gates with "
          "per-tenant shares partitioning the served tokens and the "
          "scraped router gauges bitwise-equal to router truth")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--pages", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--token-budget", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="N>1 routes the trace through a "
                         "serving.fleet Router over N replicas")
    ap.add_argument("--tenants", type=str, default=None, metavar="SPEC",
                    help="weighted multi-tenant trace: "
                         "'name:rate=R[,weight=W];...' (per-tenant "
                         "Poisson rate in req/s; weight drives the "
                         "router's fairness in --replicas mode). Adds "
                         "per-tenant p50/p99 + served-token share and "
                         "the tenant_share_err extra to the report")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--request-report", type=int, default=0,
                    metavar="K",
                    help="journal the run and print the K worst-TTFT "
                         "requests with exact phase attribution")
    ap.add_argument("--slo", type=str, default=None, metavar="SPEC",
                    help="evaluate the run against an SLO spec at "
                         "exit (inline JSON or @path); exit 1 on "
                         "violation")
    ap.add_argument("--self-test", action="store_true",
                    help="deterministic kernel/scheduler/engine checks")
    args = ap.parse_args(argv)
    if args.self_test:
        return self_test(args.device)
    tenants = None if args.tenants is None else \
        parse_tenants(args.tenants)
    slo_specs = None
    if args.slo is not None:
        from paddle_tpu_torch.obs.slo import parse_spec_arg

        slo_specs = parse_spec_arg(args.slo)
    run_dir = None
    if args.request_report > 0 or slo_specs is not None:
        from paddle_tpu_torch.obs import journal

        run_dir = tempfile.mkdtemp(prefix="pt_serve_bench_req_")
        journal.start_run(run_dir)
    try:
        if args.replicas > 1:
            rep = run_bench_fleet(
                n_requests=args.requests, rate=args.rate,
                replicas=args.replicas, pages=args.pages,
                page_size=args.page_size, seed=args.seed,
                token_budget=args.token_budget, tenants=tenants,
                device=args.device)
        else:
            rep = run_bench(n_requests=args.requests, rate=args.rate,
                            pages=args.pages,
                            page_size=args.page_size, seed=args.seed,
                            token_budget=args.token_budget,
                            tenants=tenants, device=args.device)
    finally:
        if run_dir is not None:
            journal.end_run()
    req_rep = None
    slo_rep = None
    if run_dir is not None:
        if args.request_report > 0:
            req_rep = request_report(run_dir, args.request_report)
        if slo_specs is not None:
            from paddle_tpu_torch.obs.slo import evaluate_run

            slo_rep = evaluate_run(run_dir, slo_specs,
                                   duration_s=rep.get("wall_s"))
            rep["slo_violations"] = slo_rep["violations"]
        shutil.rmtree(run_dir, ignore_errors=True)
    if args.json:
        if req_rep is not None:
            rep["request_report"] = req_rep
        if slo_rep is not None:
            rep["slo"] = slo_rep["objectives"]
        print(json.dumps(rep, sort_keys=True))
    else:
        for k in sorted(rep):
            v = rep[k]
            if isinstance(v, (dict, list)):
                print(f"{k:<20} {json.dumps(v, sort_keys=True)}")
            elif isinstance(v, float):
                print(f"{k:<20} {v:.4g}")
            else:
                print(f"{k:<20} {v}")
        if args.request_report > 0:
            _print_request_report(req_rep)
        if slo_rep is not None:
            for row in slo_rep["objectives"]:
                tgt = row.get("threshold_ms",
                              row.get("floor", row.get("target")))
                verdict = {True: "ok", False: "VIOLATED",
                           None: "no-data"}[row["ok"]]
                val = "-" if row["value"] is None \
                    else f"{row['value']:.4g}"
                print(f"slo {row['name']:<16} value={val} "
                      f"target={tgt:g} {verdict}")
    if slo_rep is not None and slo_rep["violations"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
