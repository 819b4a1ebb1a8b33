#!/usr/bin/env python3
"""torch_run_report: render, diff, and self-test ``paddle_tpu_torch`` run
journals — the port's counterpart of ``tools/run_report.py``, with its
CLI and output.

The operational front door for ``paddle_tpu_torch.obs.journal``: render
one run's flight record (training steps from ``TrainStep``, the static
``Executor``, the ``Predictor``, ``GuardedStep``; serving requests and
router events) as a table or JSON, or diff two runs as a regression
gate — step-time, loss-curve, and collective-traffic (all-reduce
bytes/step) deltas against thresholds, exit code 1 when any regresses.

Usage:
    python3 tools/torch_run_report.py RUN_DIR                 # table
    python3 tools/torch_run_report.py RUN_DIR --json
    python3 tools/torch_run_report.py --diff BASE_DIR NEW_DIR \\
        [--step-time-threshold 0.25] [--loss-threshold 0.05]
    python3 tools/torch_run_report.py --self-test      # synthetic 2-run
        # pair: asserts the diff flags the injected regression and the
        # anomaly detectors fire
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DEFAULT_STEP_TIME_THRESHOLD = 0.25   # mean step_ms may grow 25%
DEFAULT_LOSS_THRESHOLD = 0.05        # final loss may grow 5% (relative)
DEFAULT_COMM_THRESHOLD = 0.10        # all-reduce bytes/step may grow 10%
DEFAULT_PLAN_MISMATCH_THRESHOLD = 0.10  # planner predicted-vs-measured
DEFAULT_MEMORY_DRIFT_THRESHOLD = 0.15   # static peak-HBM prediction vs
#                                         the executable's memory_analysis()
DEFAULT_QUEUE_SHARE_THRESHOLD = 0.10    # serving queue share of TTFT may
#                                         grow 10 points (absolute)
DEFAULT_FAIRNESS_DRIFT_THRESHOLD = 0.20  # |served share - weight share|
#                 (absolute; mirrors obs.usage.DEFAULT_FAIRNESS_DRIFT_THRESHOLD)


# -- loading -----------------------------------------------------------------


def _journal_files(path):
    """The journal file(s) for a run (delegates to the canonical
    ``obs.fleet`` parser — one loader for this CLI and the fleet
    aggregator)."""
    from paddle_tpu_torch.obs import fleet as _fleet

    return _fleet.journal_files(path)


def load_run(path):
    """Parse a run's journal into {header, steps, events, anomalies,
    summary, parse_errors}. Tolerates a torn final line (a crashed
    writer) — it lands in parse_errors, everything before it loads.
    Delegates to ``obs.fleet.load_journal``, the one canonical journal
    parser (the fleet aggregator reads rank subdirs through the same
    code)."""
    from paddle_tpu_torch.obs import fleet as _fleet

    return _fleet.load_journal(path)


def _finite_losses(run):
    return [s["loss"] for s in run["steps"]
            if isinstance(s.get("loss"), (int, float))
            and math.isfinite(s["loss"]) and not s.get("skipped")]


def _step_times(run):
    return [s["step_ms"] for s in run["steps"]
            if isinstance(s.get("step_ms"), (int, float))
            and s["step_ms"] > 0]


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def _comm_bytes_per_step(run, key="all_reduce_bytes"):
    """Mean collective bytes over the steps that carry a comm record
    (the journal attributes comm once the entry's lazy analysis lands);
    None when no step was attributed."""
    vals = [s["comm"].get(key, 0) for s in run["steps"]
            if isinstance(s.get("comm"), dict)]
    return _mean(vals)


def _pctl(xs, q):
    """Exact percentile over the raw per-request values (the journal
    keeps every request record, unlike the bounded-bucket serving
    histograms) — ONE shared definition with tools/serve_bench.py."""
    from paddle_tpu_torch.obs.metrics import exact_percentile

    return exact_percentile(xs, q)


def request_summary(run):
    """Serving columns over the run's ``request`` records (canonical
    implementation: ``obs.fleet.request_summary``, which also merges
    them across replicas): counts by state, total preemptions, and
    exact p50/p99 TTFT/TPOT/e2e (ms). None when the run served
    nothing."""
    from paddle_tpu_torch.obs import fleet as _fleet

    return _fleet.request_summary(run)


def elastic_summary(run):
    """Elasticity columns over the run's ``elastic.*`` events (written
    by ``resilience.elastic.GangSupervisor``; canonical implementation
    in ``obs.fleet``): restarts, budget-free preemptions, watchdog
    kills, resume-latency p50/max, resume steps, budget exhaustion.
    None when the run was never supervised."""
    from paddle_tpu_torch.obs import fleet as _fleet

    return _fleet.elastic_summary(run)


def router_summary(run):
    """Serve-fleet router columns over the run's ``router.*`` events
    (written by ``serving.fleet.Router``; canonical implementation in
    ``obs.fleet``): dispatched/requeued/rejected counts, per-tenant
    token shares, scale events, aggregate p99 TTFT. None when the run
    never routed."""
    from paddle_tpu_torch.obs import fleet as _fleet

    return _fleet.router_summary(run)


def render_router_line(rsum):
    """One render line for a run that routed a serve fleet."""
    line = (f"router       dispatched={rsum['dispatched']} "
            f"requeued={rsum['requeued']} rejected={rsum['rejected']} "
            f"completed={rsum['completed']}")
    if rsum.get("replicas") is not None:
        line += f" replicas={rsum['replicas']}"
    if rsum.get("scale_events"):
        line += (f" scale_events={rsum['scale_events']} "
                 f"(+{rsum.get('scale_ups') or 0}/"
                 f"-{rsum.get('scale_downs') or 0})")
    if rsum.get("tenants"):
        line += " tenants " + " ".join(
            f"{t}:{s:.2f}" for t, s in sorted(rsum["tenants"].items()))
    if rsum.get("ttft_p99_ms") is not None:
        line += f" ttft_p99={rsum['ttft_p99_ms']:.1f}ms"
    return line


def tenant_summary(run):
    """Per-tenant chargeback columns over the run's request records and
    ``tenant.*`` events (canonical implementation:
    ``obs.fleet.tenant_summary``): tokens, device-ns, page-ns, exact
    latency percentiles per tenant, plus the router's fairness audit.
    None when the run carries no tenant signal."""
    from paddle_tpu_torch.obs import fleet as _fleet

    return _fleet.tenant_summary(run)


def render_tenant_table(tsum):
    """Render lines for a per-tenant chargeback rollup (one line per
    tenant + the fairness verdict; shared with tools/fleet_report.py
    and tools/torch_usage_report.py via ``_load_sibling``)."""
    lines = []
    for t, d in sorted((tsum.get("tenants") or {}).items()):
        line = (f"tenant {t:<10} req={d.get('requests', 0)} "
                f"done={d.get('completed', 0)} "
                f"tok={d.get('prompt_tokens', 0)}"
                f"+{d.get('decode_tokens', 0)} "
                f"dev_ms={(d.get('device_ns') or 0) / 1e6:.3f} "
                f"page_s={(d.get('page_ns') or 0) / 1e9:.3f}")
        if d.get("preemptions"):
            line += f" preempt={d['preemptions']}"
        for key, label in (("ttft_ms_p99", "ttft_p99"),
                           ("e2e_ms_p99", "e2e_p99")):
            if d.get(key) is not None:
                line += f" {label}={d[key]:.1f}ms"
        lines.append(line)
    fair = tsum.get("fairness")
    if fair and fair.get("tenants"):
        line = (f"fairness     max_drift={fair['max_drift']:.3f} "
                f"threshold={fair['threshold']:.3f}")
        if fair.get("worst_tenant") is not None:
            line += f" worst={fair['worst_tenant']}"
        line += " ok" if fair.get("ok") else " DRIFT"
        lines.append(line)
    return lines


def fleet_summary(path):
    """The cross-rank rollup when ``path`` holds per-rank journal
    subdirs (``rank_NN/``, written by GangSupervisor / ``dist.launch``
    workers): ``obs.fleet.aggregate`` — per-rank table, skew,
    straggler/hang attribution, merged request percentiles. None for a
    single-process run dir. ``tools/fleet_report.py`` renders the full
    table; this feeds the one-line render below."""
    from paddle_tpu_torch.obs import fleet as _fleet

    if not _fleet.rank_dirs(path):
        return None
    return _fleet.aggregate(path)


def render_fleet_line(agg):
    """One render line for a fleet run dir (the per-rank detail lives
    in tools/fleet_report.py)."""
    skew = agg["skew"]
    line = (f"fleet        {agg['nranks']} ranks, "
            f"{agg['aligned_steps']} aligned steps")
    if skew["max"] is not None:
        line += (f", skew max={skew['max']:.3g}x @step {skew['max_step']}"
                 f" (slowest rank {skew['worst_rank']})")
    stragglers = agg.get("stragglers") or []
    if stragglers:
        line += ", stragglers: " + ", ".join(
            f"rank {s['rank']} ({s['kind']})" for s in stragglers[:4])
    return line


def plan_summary(run):
    """Auto-parallel columns over the run's ``plan`` events (one per
    ``fleet.auto_parallel`` compile): plan count, the meshes chosen,
    and the worst predicted-vs-measured wire-byte mismatch — the number
    the planner's cost model is accountable to. None when the run never
    auto-parallelized."""
    events = [e for e in run.get("events") or []
              if e.get("kind") == "plan"]
    if not events:
        return None
    mismatches = [e["mismatch"] for e in events
                  if isinstance(e.get("mismatch"), (int, float))]
    axes = []
    for e in events:
        a = e.get("axes")
        if a and a not in axes:
            axes.append(a)
    return {
        "plans": len(events),
        "axes": axes,
        "predicted_wire_bytes": [e.get("predicted_wire_bytes")
                                 for e in events],
        "measured_wire_bytes": [e.get("measured_wire_bytes")
                                for e in events],
        "max_mismatch": max(mismatches) if mismatches else None,
    }


def memory_summary(run):
    """Static-memory columns over the run's ``memory`` events (one
    predicted-only event per Executor compile, re-journaled with the
    executable's ``memory_analysis()`` total once the lazy entry
    analysis lands): entries measured, predicted/measured byte lists,
    and the worst predicted-vs-measured drift — the number the
    analysis.memory liveness walk is accountable to. None when the run
    journaled no memory events."""
    events = [e for e in run.get("events") or []
              if e.get("kind") == "memory"]
    if not events:
        return None
    measured = [e for e in events
                if isinstance(e.get("measured_peak_bytes"), (int, float))]
    drifts = [e["drift"] for e in measured
              if isinstance(e.get("drift"), (int, float))]
    return {
        "entries": len(events),
        "measured_entries": len(measured),
        "predicted_peak_bytes": [e.get("predicted_peak_bytes")
                                 for e in measured or events],
        "measured_peak_bytes": [e.get("measured_peak_bytes")
                                for e in measured],
        "max_drift": max(drifts) if drifts else None,
    }


def gate_summary(run):
    """Perf-gate columns over the run's ``perf_gate`` events (written by
    ``tools/perf_gate.journal_gates``): entries gated, failure count,
    and the failure strings — so a donation/fusion/call-count gate
    regression rides the journal into the --diff regression gate. None
    when no gates were recorded."""
    events = [e for e in run.get("events") or []
              if e.get("kind") == "perf_gate"]
    if not events:
        return None
    failures = []
    for e in events:
        failures += list(e.get("failures") or [])
    return {"entries": len(events),
            "failed_entries": sum(1 for e in events if not e.get("passed",
                                                                 True)),
            "failures": failures}


def aot_summary(run):
    """Cold-start columns over the run's ``compile`` events' AOT
    provenance (``via``: "xla" = compiled in-process, "aot_disk" =
    hydrated from the executable cache, ``runtime.aot``): entries
    hydrated vs compiled, total deserialize time, and the compile time
    the cache avoided (each hydrated event carries the ORIGINAL
    compile's wall ms from the envelope). ``engaged`` is True when an
    AOT cache actually participated (something hydrated, or an eager
    miss-compile was published) — plain lazy-jit runs also tag
    ``via="xla"`` but stay ``engaged=False`` so the render line only
    appears for AOT runs. None when no compile event carries
    provenance."""
    events = [e for e in run.get("events") or []
              if e.get("kind") == "compile"
              and e.get("via") in ("xla", "aot_disk")]
    if not events:
        return None
    hydrated = [e for e in events if e["via"] == "aot_disk"]
    compiled = [e for e in events if e["via"] == "xla"]
    des = [e["deserialize_ms"] for e in hydrated
           if isinstance(e.get("deserialize_ms"), (int, float))]
    avoided = [e["compile_ms_avoided"] for e in hydrated
               if isinstance(e.get("compile_ms_avoided"), (int, float))]
    eager = [e for e in compiled
             if isinstance(e.get("xla_compile_ms"), (int, float))]
    return {
        "entries": len(events),
        "hydrated": len(hydrated),
        "compiled": len(compiled),
        "deserialize_ms": sum(des) if des else 0.0,
        "compile_ms_avoided": sum(avoided) if avoided else None,
        "engaged": bool(hydrated or eager),
    }


def _final_loss(run, k=5):
    """Median of the last k finite losses — robust to one noisy tail
    step."""
    tail = sorted(_finite_losses(run)[-k:])
    return tail[len(tail) // 2] if tail else None


# -- render ------------------------------------------------------------------


def render_run(run, as_json=False):
    if as_json:
        return json.dumps(run, indent=1, default=str, sort_keys=True)
    hdr = run["header"] or {}
    times = _step_times(run)
    losses = _finite_losses(run)
    lines = [
        f"run_dir      {hdr.get('run_dir', '?')}",
        f"backend      {hdr.get('backend')} x{hdr.get('ndev')} "
        f"({hdr.get('device_kind', '?')})",
        f"steps        {len(run['steps'])} "
        f"({sum(1 for s in run['steps'] if s.get('skipped'))} skipped)",
    ]
    # fused windows (steps_fused=K) journal as one record per dispatch;
    # show the optimizer-step total so a fused run reads comparably
    opt_steps = sum(int(s.get("steps_fused") or 1) for s in run["steps"])
    if opt_steps != len(run["steps"]):
        lines[-1] += f", {opt_steps} optimizer steps (fused windows)"
    if losses:
        lines.append(f"loss         first={losses[0]:.6g} "
                     f"last={losses[-1]:.6g} min={min(losses):.6g}")
    if times:
        st = sorted(times)
        lines.append(
            f"step_ms      mean={_mean(times):.3f} "
            f"p50={st[len(st) // 2]:.3f} max={st[-1]:.3f}")
    comm = _comm_bytes_per_step(run)
    if comm is not None:
        total = _comm_bytes_per_step(run, "total_bytes")
        lines.append(f"comm/step    all-reduce={comm:.4g}B "
                     f"total={total:.4g}B")
    summ = run["summary"]
    if summ:
        for k in ("goodput", "mfu", "achieved_flops_per_s",
                  "examples_per_s", "steps_per_s", "comm_share"):
            if summ.get(k) is not None:
                v = summ[k]
                lines.append(f"{k:<12} "
                             f"{v:.4g}" if isinstance(v, float) else
                             f"{k:<12} {v}")
    rsum = request_summary(run)
    if rsum:
        lines.append(
            f"requests     {rsum['requests']} "
            f"({rsum['finished']} finished, {rsum['cancelled']} "
            f"cancelled, {rsum['preemptions']} preemptions, "
            f"{rsum['output_tokens']} tokens)")
        for key, label in (("ttft_ms", "ttft_ms"), ("tpot_ms", "tpot_ms"),
                           ("e2e_ms", "e2e_ms"),
                           ("queue_ms", "queue_ms")):
            if rsum.get(f"{key}_p50") is not None:
                lines.append(
                    f"{label:<12} p50={rsum[f'{key}_p50']:.3f} "
                    f"p99={rsum[f'{key}_p99']:.3f}")
    psum = plan_summary(run)
    if psum:
        mism = psum["max_mismatch"]
        lines.append(
            f"plan         {psum['plans']} auto-parallel compile(s), "
            f"axes={psum['axes']}"
            + (f", predicted-vs-measured mismatch max={mism:.1%}"
               if mism is not None else ", unverified"))
    msum = memory_summary(run)
    if msum:
        drift = msum["max_drift"]
        lines.append(
            f"memory       {msum['entries']} entries "
            f"({msum['measured_entries']} measured)"
            + (f", predicted-vs-measured drift max={drift:.1%}"
               if drift is not None else ", unmeasured"))
    gsum = gate_summary(run)
    if gsum:
        lines.append(f"perf_gates   {gsum['entries']} entries, "
                     f"{gsum['failed_entries']} failed"
                     + (f": {'; '.join(gsum['failures'][:3])}"
                        if gsum["failures"] else ""))
    asum = aot_summary(run)
    if asum and asum["engaged"]:
        line = (f"aot          {asum['hydrated']} hydrated / "
                f"{asum['compiled']} compiled")
        if asum["hydrated"]:
            line += f", deserialize {asum['deserialize_ms']:.1f}ms"
        if asum["compile_ms_avoided"]:
            line += f", compile avoided {asum['compile_ms_avoided']:.1f}ms"
        lines.append(line)
    rtsum = router_summary(run)
    if rtsum:
        lines.append(render_router_line(rtsum))
    tsum = tenant_summary(run)
    if tsum and (tsum.get("tenants") or tsum.get("fairness")):
        lines += render_tenant_table(tsum)
    esum = elastic_summary(run)
    if esum:
        line = (f"elastic      restarts={esum['restarts']} "
                f"preemptions={esum['preemptions']} "
                f"watchdog_kills={esum['watchdog_kills']}")
        if esum.get("resume_ms_p50") is not None:
            line += (f" resume_ms p50={esum['resume_ms_p50']:.0f} "
                     f"max={esum['resume_ms_max']:.0f}")
        if esum["budget_exhausted"]:
            line += " BUDGET-EXHAUSTED"
        lines.append(line)
    kinds = {}
    for e in run["events"]:
        kinds[e.get("kind")] = kinds.get(e.get("kind"), 0) + 1
    if kinds:
        lines.append("events       " + ", ".join(
            f"{k}={n}" for k, n in sorted(kinds.items())))
    if run["anomalies"]:
        lines.append("anomalies    " + ", ".join(
            f"{a['name']}@step{a.get('step')}" for a in run["anomalies"]))
    if run["parse_errors"]:
        lines.append(f"parse_errors {len(run['parse_errors'])} "
                     "(torn tail line from a crashed writer?)")
    return "\n".join(lines)


# -- diff (the regression gate) ----------------------------------------------


def diff_runs(base, new,
              step_time_threshold=DEFAULT_STEP_TIME_THRESHOLD,
              loss_threshold=DEFAULT_LOSS_THRESHOLD,
              comm_threshold=DEFAULT_COMM_THRESHOLD,
              queue_share_threshold=DEFAULT_QUEUE_SHARE_THRESHOLD,
              fairness_drift_threshold=DEFAULT_FAIRNESS_DRIFT_THRESHOLD):
    """Compare two loaded runs; regression flags flip when NEW is worse
    than BASE beyond the thresholds. Returns a plain-data report."""
    bt, nt = _mean(_step_times(base)), _mean(_step_times(new))
    bl, nl = _final_loss(base), _final_loss(new)
    bc, nc = _comm_bytes_per_step(base), _comm_bytes_per_step(new)
    out = {
        "base_mean_step_ms": bt, "new_mean_step_ms": nt,
        "step_time_ratio": (nt / bt if bt and nt else None),
        "step_time_regression": bool(
            bt and nt and nt > bt * (1.0 + step_time_threshold)),
        "base_final_loss": bl, "new_final_loss": nl,
        "loss_regression": False,
        "base_ar_bytes_per_step": bc, "new_ar_bytes_per_step": nc,
        "comm_ratio": (nc / bc if bc and nc else None),
        # a step suddenly moving >10% more all-reduce bytes is a
        # sharding/partitioner regression even when wall time hides it
        # (e.g. a bigger overlap window) — gate it like throughput.
        # A zero-all-reduce base (e.g. all-gather/reduce-scatter-only
        # TP) regressing to ANY all-reduce is the starkest case, so 0
        # is a valid baseline here, unlike step time
        "comm_regression": bool(
            bc is not None and nc is not None and
            (nc > bc * (1.0 + comm_threshold) if bc else nc > 0)),
        "base_comm_share": (base["summary"] or {}).get("comm_share"),
        "new_comm_share": (new["summary"] or {}).get("comm_share"),
        "base_anomalies": len(base["anomalies"]),
        "new_anomalies": len(new["anomalies"]),
    }
    # perf-gate fold (tools/perf_gate.journal_gates events): NEW failing
    # more structural gates than BASE — donation lost, scan unrolled,
    # call counts blown — is a regression even when wall time hides it
    bg, ng = gate_summary(base), gate_summary(new)
    bfail = (bg or {}).get("failed_entries", 0)
    nfail = (ng or {}).get("failed_entries", 0)
    out["base_gate_failures"] = bfail if bg else None
    out["new_gate_failures"] = nfail if ng else None
    out["gate_regression"] = bool(ng and nfail > bfail)
    if out["gate_regression"]:
        out["gate_failure_detail"] = (ng or {}).get("failures")
    # auto-parallel plan-mismatch column (fleet planner accountability):
    # NEW's cost model drifting >threshold off the HLO-measured bytes —
    # and off whatever BASE achieved — means the planner is choosing
    # layouts on wrong numbers, a regression even when this run's wall
    # time looks fine
    bp, np_ = plan_summary(base), plan_summary(new)
    bmis = (bp or {}).get("max_mismatch")
    nmis = (np_ or {}).get("max_mismatch")
    out["base_plan_mismatch"] = bmis
    out["new_plan_mismatch"] = nmis
    out["plan_regression"] = bool(
        nmis is not None and nmis > DEFAULT_PLAN_MISMATCH_THRESHOLD and
        (bmis is None or nmis > bmis))
    # static-memory drift (analysis.memory vs memory_analysis()): NEW's
    # peak-HBM prediction drifting >15% off the executable's own number
    # — and off whatever BASE achieved — means the planner's
    # activation-memory term (and its hbm_budget rejections) run on
    # wrong bytes, a regression even when this run's wall time is fine
    bm, nm = memory_summary(base), memory_summary(new)
    bmd = (bm or {}).get("max_drift")
    nmd = (nm or {}).get("max_drift")
    out["base_memory_drift"] = bmd
    out["new_memory_drift"] = nmd
    out["memory_regression"] = bool(
        nmd is not None and nmd > DEFAULT_MEMORY_DRIFT_THRESHOLD and
        (bmd is None or nmd > bmd))
    # AOT cold-start fold (runtime.aot provenance on compile events):
    # BASE warm-started from the executable cache but NEW compiles
    # more entries from scratch — a replica's cold start regressed
    # (cache key drifted, serialization broke, warmup stopped shipping)
    # even when this run's wall time hides it behind lazy compiles
    ba, na = aot_summary(base), aot_summary(new)
    out["base_aot_hydrated"] = (ba or {}).get("hydrated")
    out["new_aot_hydrated"] = (na or {}).get("hydrated")
    # NEW journaling no provenance at all reads as every base-hydrated
    # entry gone cold (base is the older format only when it never
    # hydrated, and then the gate is off anyway)
    new_compiled = na["compiled"] if na else \
        (ba["hydrated"] if ba else 0)
    out["aot_regression"] = bool(
        ba and ba["hydrated"] and new_compiled > ba["compiled"])
    # serving queue-share fold (reqtrace attribution signal): the
    # fraction of fleet TTFT spent in the arrival->admit queue growing
    # by more than the threshold (ABSOLUTE points) means latency
    # shifted into queueing — an admission/dispatch regression even
    # when the p99 TTFT column alone can't say WHERE the time went
    brs, nrs = request_summary(base), request_summary(new)
    bqs = (brs or {}).get("queue_share")
    nqs = (nrs or {}).get("queue_share")
    out["base_queue_share"] = bqs
    out["new_queue_share"] = nqs
    out["queue_share_regression"] = bool(
        nqs is not None and
        nqs > (bqs or 0.0) + queue_share_threshold)
    # fairness-drift fold (obs.usage fairness audit over the router's
    # tenant.summary truth): NEW's worst |served-share - weight-share|
    # exceeding the absolute threshold — and whatever drift BASE ran at
    # — means the weighted scheduler stopped honoring the configured
    # shares (a tenant is being starved or hogging), a regression even
    # when every aggregate latency column is clean. The
    # worse-than-base clause keeps A-vs-A diffs clean by construction.
    btn, ntn = tenant_summary(base), tenant_summary(new)
    bfd = ((btn or {}).get("fairness") or {}).get("max_drift")
    nfd = ((ntn or {}).get("fairness") or {}).get("max_drift")
    out["base_fairness_drift"] = bfd
    out["new_fairness_drift"] = nfd
    out["fairness_drift_regression"] = bool(
        nfd is not None and nfd > fairness_drift_threshold and
        (bfd is None or nfd > bfd))
    if out["fairness_drift_regression"]:
        out["fairness_worst_tenant"] = \
            (ntn.get("fairness") or {}).get("worst_tenant")
    if bl is not None and nl is not None:
        margin = loss_threshold * max(abs(bl), 1e-12)
        out["loss_delta"] = nl - bl
        out["loss_regression"] = bool(nl - bl > margin)
    out["regression"] = out["step_time_regression"] or \
        out["loss_regression"] or out["comm_regression"] or \
        out["gate_regression"] or out["plan_regression"] or \
        out["memory_regression"] or out["aot_regression"] or \
        out["queue_share_regression"] or \
        out["fairness_drift_regression"]
    return out


def render_diff(rep, as_json=False):
    if as_json:
        return json.dumps(rep, indent=1, default=str, sort_keys=True)

    def fmt(v):
        return f"{v:.6g}" if isinstance(v, float) else str(v)

    lines = []
    for k in ("base_mean_step_ms", "new_mean_step_ms", "step_time_ratio",
              "step_time_regression", "base_final_loss", "new_final_loss",
              "loss_delta", "loss_regression", "base_ar_bytes_per_step",
              "new_ar_bytes_per_step", "comm_ratio", "comm_regression",
              "base_comm_share", "new_comm_share",
              "base_gate_failures", "new_gate_failures",
              "gate_regression", "gate_failure_detail",
              "base_plan_mismatch", "new_plan_mismatch",
              "plan_regression",
              "base_memory_drift", "new_memory_drift",
              "memory_regression",
              "base_aot_hydrated", "new_aot_hydrated",
              "aot_regression",
              "base_queue_share", "new_queue_share",
              "queue_share_regression",
              "base_fairness_drift", "new_fairness_drift",
              "fairness_drift_regression", "fairness_worst_tenant",
              "base_anomalies", "new_anomalies", "regression"):
        if rep.get(k) is not None:
            lines.append(f"{k:<22} {fmt(rep[k])}")
    return "\n".join(lines)


# -- self-test ---------------------------------------------------------------


class _FixturePlan:
    """The plan of the reference's fixture (a (2, 4) data x model mesh,
    ``tools/run_report.py:664-674``) as its ``event_fields()`` gives it:
    the planner is ROADMAP Queue 1 item 6c, ``record_plan`` takes any
    object with ``event_fields()``."""

    def __init__(self, predicted, measured):
        self.predicted, self.measured = predicted, measured

    def event_fields(self):
        return {"mesh_shape": [2, 4], "roles": ["data", "model"],
                "axes": {"data": 2, "model": 4}, "source": "program",
                "predicted_wire_bytes": self.predicted,
                "measured_wire_bytes": self.measured,
                "mismatch": (abs(self.predicted - self.measured)
                             / self.measured if self.measured else None),
                "peak_bytes_per_device": None}


def _write_run(run_dir, losses, step_ms, flops=1e9, nonfinite_at=(),
               comm_bytes=None, gate_failures=(), plan_bytes=None,
               memory_bytes=None, aot=None):
    """Drive the REAL RunJournal API to produce one synthetic run."""
    from paddle_tpu_torch.obs import journal as J

    comm = None
    if comm_bytes:
        comm = {"all_reduce_bytes": comm_bytes,
                "total_bytes": comm_bytes,
                "wire_bytes": int(comm_bytes * 1.75)}
    j = J.RunJournal(run_dir, flush_every=4)
    j.start()
    if aot is not None:
        # (hydrated, compiled) AOT-provenance compile events, the shape
        # Executor._compile writes with an executable cache active
        hyd, cmp_ = aot
        for _ in range(hyd):
            j.event("compile", uid=1, version=1, ms=2.0,
                    source="aot_disk", via="aot_disk",
                    deserialize_ms=2.0, compile_ms_avoided=40.0)
        for _ in range(cmp_):
            j.event("compile", uid=1, version=1, ms=45.0,
                    source="xla", via="xla", xla_compile_ms=40.0)
    if memory_bytes is not None:
        # one measured memory event through the real record_memory
        # path; (predicted, measured) inject the drift under test
        pred, meas = memory_bytes
        j.record_memory(predicted_bytes=pred, measured_bytes=meas,
                        entry_uid=1)
    # one perf_gate event per run (the shape journal_gates writes);
    # gate_failures injects a structural regression for the diff to flag
    j.event("perf_gate", entry_uid=1, steps_fused=None, donated=4,
            while_ops=0, fusion_ops=3, failures=list(gate_failures),
            passed=not gate_failures, compiles=1, dispatches=30)
    if plan_bytes is not None:
        # one auto-parallel plan event through the real record_plan
        # path; (predicted, measured) inject the mismatch under test
        pred, meas = plan_bytes
        j.record_plan(_FixturePlan(pred, meas))
    for i, loss in enumerate(losses):
        if i in nonfinite_at:
            j.record_step(loss=float("nan"), step_ms=step_ms,
                          skipped=True, source="self_test")
        else:
            j.record_step(loss=loss, step_ms=step_ms, flops=flops,
                          examples=32, comm=comm, source="self_test")
    j.close()
    return j


def self_test():
    from paddle_tpu_torch.obs import mfu

    failures = []
    mfu.set_peak_flops(2e11)  # synthetic peak so MFU is computable
    try:
        with tempfile.TemporaryDirectory() as d:
            a_dir, b_dir = os.path.join(d, "a"), os.path.join(d, "b")
            # run A: healthy — loss decays 1.0 -> ~0.1, 10ms steps,
            # 1 MiB of all-reduce per step
            _write_run(a_dir, [1.0 * (0.93 ** i) for i in range(30)],
                       step_ms=10.0, comm_bytes=1 << 20,
                       plan_bytes=(100_000, 101_000),
                       memory_bytes=(1_000_000, 980_000),
                       aot=(2, 0))
            # run B: regressed — 3x slower steps, a loss spike after
            # which the loss never recovers, a 3-step nonfinite
            # streak, and 2x the all-reduce traffic (a partitioner
            # regression the comm gate must flag)
            losses = [1.0 * (0.93 ** i) for i in range(30)]
            losses[20] = 50.0  # spike...
            for i in range(21, 30):
                losses[i] = 0.5  # ...then stuck well above run A's tail
            # run B also carries a planner whose predicted bytes drifted
            # 50% off the HLO-measured truth (plan-mismatch regression)
            # run B's static peak-HBM prediction also drifted 25% off
            # the executable's measured bytes (memory regression)
            # run B also COLD-compiles the entries run A hydrated from
            # the AOT executable cache (warm-start regression)
            _write_run(b_dir, losses, step_ms=30.0,
                       nonfinite_at=(12, 13, 14), comm_bytes=2 << 20,
                       gate_failures=("donated buffers 0 < required 4",),
                       plan_bytes=(100_000, 200_000),
                       memory_bytes=(1_000_000, 800_000),
                       aot=(0, 2))

            a, b = load_run(a_dir), load_run(b_dir)
            if a["parse_errors"] or b["parse_errors"]:
                failures.append(f"synthetic journals failed to parse: "
                                f"{a['parse_errors'] + b['parse_errors']}")
            if a["summary"] is None or not a["summary"].get("mfu"):
                failures.append("run A summary missing MFU (accounting "
                                "broke)")
            if a["summary"] and a["summary"].get("goodput") != 1.0:
                failures.append("healthy run A must have goodput 1.0, "
                                f"got {a['summary'].get('goodput')}")
            bsum = b["summary"] or {}
            if not (bsum.get("goodput") or 1.0) < 1.0:
                failures.append("run B's skipped steps must lower "
                                f"goodput, got {bsum.get('goodput')}")

            fired = {x["name"] for x in b["anomalies"]}
            for want in ("loss_spike", "nonfinite_streak"):
                if want not in fired:
                    failures.append(f"detector {want!r} did not fire on "
                                    f"the injected run-B fault (fired: "
                                    f"{sorted(fired)})")
            if {x["name"] for x in a["anomalies"]}:
                failures.append("healthy run A fired anomalies: "
                                f"{a['anomalies']}")

            rep = diff_runs(a, b)
            if not rep["step_time_regression"]:
                failures.append("diff missed the 3x step-time regression")
            if not rep["loss_regression"]:
                failures.append("diff missed the loss regression")
            if not rep["comm_regression"]:
                failures.append("diff missed the 2x all-reduce-bytes "
                                "regression")
            if rep["comm_ratio"] is None or \
                    abs(rep["comm_ratio"] - 2.0) > 1e-9:
                failures.append(f"comm_ratio {rep['comm_ratio']} != 2.0")
            if not rep["gate_regression"]:
                failures.append("diff missed the injected perf-gate "
                                "(donation) failure")
            if not rep["plan_regression"]:
                failures.append("diff missed the 50% plan predicted-vs-"
                                "measured mismatch")
            if abs((rep["new_plan_mismatch"] or 0) - 0.5) > 1e-9:
                failures.append(f"plan mismatch {rep['new_plan_mismatch']}"
                                " != hand-computed 0.5")
            if not rep["aot_regression"]:
                failures.append("diff missed the AOT warm-start "
                                "regression (base hydrated 2, new "
                                "cold-compiled 2)")
            asum = aot_summary(a)
            if not (asum and asum["hydrated"] == 2
                    and asum["compile_ms_avoided"] == 80.0):
                failures.append(f"aot_summary lost the hydration "
                                f"accounting: {asum}")
            if "aot          2 hydrated" not in render_run(a):
                failures.append("render_run lost the aot cold-start line")
            if not rep["memory_regression"]:
                failures.append("diff missed the 25% memory "
                                "predicted-vs-measured drift")
            if abs((rep["new_memory_drift"] or 0) - 0.25) > 1e-9:
                failures.append(f"memory drift {rep['new_memory_drift']}"
                                " != hand-computed 0.25 "
                                "(|1e6 - 8e5| / 8e5)")
            if "plan" not in render_run(a):
                failures.append("render_run lost the plan line")
            if "drift" not in render_run(a):
                failures.append("render_run lost the memory line")
            if "donated buffers" not in " ".join(
                    rep.get("gate_failure_detail") or ()):
                failures.append("gate_failure_detail lost the failure "
                                f"string: {rep.get('gate_failure_detail')}")
            self_rep = diff_runs(a, a)
            if self_rep["regression"]:
                failures.append(f"A-vs-A diff false-positived: {self_rep}")

        # a fleet run dir (rank_NN subdirs, no top-level journal) gets
        # the cross-rank rollup line instead of a FileNotFoundError
        from paddle_tpu_torch.obs import journal as J2

        with tempfile.TemporaryDirectory() as d:
            for rank, ms in ((0, 10.0), (1, 20.0)):
                jj = J2.RunJournal(d, rank=rank)
                jj.start()
                for _ in range(4):
                    jj.record_step(loss=1.0, step_ms=ms)
                jj.close()
            agg = fleet_summary(d)
            if not agg or agg["nranks"] != 2:
                failures.append(f"fleet_summary missed the rank "
                                f"subdirs: {agg}")
            elif not render_fleet_line(agg).startswith(
                    "fleet        2 ranks"):
                failures.append("render_fleet_line lost the fleet line: "
                                f"{render_fleet_line(agg)}")
            if fleet_summary(os.path.join(d, "rank_00")) is not None:
                failures.append("fleet_summary false-positived on a "
                                "plain single-rank dir")

        # serving request records round-trip with EXACT percentile
        # columns (hand-computed: TTFT = 100*(i+1) ms for i in 0..9,
        # so p50 = 500 ms, p99 = 1000 ms)
        from paddle_tpu_torch.obs import journal as J

        with tempfile.TemporaryDirectory() as d:
            j = J.RunJournal(d)
            j.start()
            for i in range(10):
                j.record_request(
                    rid=f"r{i}", state="FINISHED", arrival_t=0.0,
                    admit_t=0.01, first_token_t=0.1 * (i + 1),
                    finish_t=2.0, prompt_tokens=5, output_tokens=5,
                    pages_peak=2, preemptions=1 if i == 0 else 0)
            j.close()
            rs = request_summary(load_run(d))
            if rs is None:
                failures.append("request records did not round-trip")
            else:
                if rs["requests"] != 10 or rs["finished"] != 10:
                    failures.append(f"request counts wrong: {rs}")
                if rs["preemptions"] != 1:
                    failures.append(
                        f"preemptions {rs['preemptions']} != 1")
                if abs(rs["ttft_ms_p50"] - 500.0) > 1e-9 or \
                        abs(rs["ttft_ms_p99"] - 1000.0) > 1e-9:
                    failures.append(
                        f"ttft percentiles off hand-computed values: "
                        f"p50={rs['ttft_ms_p50']} p99={rs['ttft_ms_p99']}")
                # journal-derived TPOT: (finish - first_token)/(n-1);
                # request 0 = (2.0 - 0.1)/4 s = 475 ms exactly
                tpots = [r["tpot_ms"] for r in load_run(d)["requests"]]
                if abs(min(tpots) - 250.0) > 1e-6 or \
                        abs(max(tpots) - 475.0) > 1e-6:
                    failures.append(
                        f"tpot_ms derivation off: min={min(tpots)} "
                        f"(want 250: req 9 = (2.0-1.0)/4 s) "
                        f"max={max(tpots)} (want 475)")
                # queue_ms = (admit - arrival) = 10 ms on EVERY record,
                # so both percentiles are exactly 10.0; queue_share =
                # sum(queue)/sum(ttft) = 100/5500 = 1/55
                if rs.get("queue_ms_p50") != 10.0 or \
                        rs.get("queue_ms_p99") != 10.0:
                    failures.append(
                        f"queue_ms percentiles off hand-computed 10.0: "
                        f"p50={rs.get('queue_ms_p50')} "
                        f"p99={rs.get('queue_ms_p99')}")
                if abs((rs.get("queue_share") or 0) - 100.0 / 5500.0) \
                        > 1e-12:
                    failures.append(
                        f"queue_share {rs.get('queue_share')} != "
                        "hand-computed 100/5500")
                if "queue_ms" not in render_run(load_run(d)):
                    failures.append("render_run lost the queue_ms line")

        # the queue-share regression gate: BASE serves with 10% of TTFT
        # queued, NEW with 80% (same p99 TTFT class — only the
        # attribution shifted into queueing); the diff must flag it,
        # and NEW-vs-NEW must stay clean
        with tempfile.TemporaryDirectory() as d:
            qa, qb = os.path.join(d, "qa"), os.path.join(d, "qb")
            for path, admit in ((qa, 0.01), (qb, 0.08)):
                j = J.RunJournal(path)
                j.start()
                for i in range(8):
                    j.record_request(
                        rid=f"q{i}", state="FINISHED", arrival_t=0.0,
                        admit_t=admit, first_token_t=0.1, finish_t=0.2,
                        prompt_tokens=4, output_tokens=4)
                j.close()
            qrep = diff_runs(load_run(qa), load_run(qb))
            if not qrep["queue_share_regression"]:
                failures.append(
                    "diff missed the queue-share shift (base 10% -> "
                    f"new 80% of TTFT queued): {qrep}")
            if abs((qrep["base_queue_share"] or 0) - 0.1) > 1e-9 or \
                    abs((qrep["new_queue_share"] or 0) - 0.8) > 1e-9:
                failures.append(
                    f"queue shares off hand-computed 0.1/0.8: "
                    f"{qrep['base_queue_share']}/"
                    f"{qrep['new_queue_share']}")
            if not qrep["regression"]:
                failures.append("queue-share regression did not fold "
                                "into the top-level regression flag")
            qself = diff_runs(load_run(qb), load_run(qb))
            if qself["regression"]:
                failures.append(
                    f"NEW-vs-NEW queue diff false-positived: {qself}")

        # serve-router events round-trip into the router line (the
        # hand-computed 2-replica fixture: 9 dispatched = 8 arrivals +
        # 1 requeued re-dispatch, tenant shares 0.75/0.25)
        with tempfile.TemporaryDirectory() as d:
            j = J.RunJournal(d)
            j.start()
            j.event("router.reject", rid="r9", tenant="a",
                    reason="oversize")
            j.event("router.requeue", replica=1, reason="exit",
                    rids=["r3"])
            j.event("router.scale", direction="up", replica=2,
                    replicas=3)
            j.event("router.summary", dispatched=9, requeued=1,
                    rejected=1, completed=8, replicas=3, scale_ups=1,
                    scale_downs=0, tenants={"a": 0.75, "b": 0.25},
                    ttft_p99_ms=123.5)
            j.close()
            rsum = router_summary(load_run(d))
            if rsum is None:
                failures.append("router events did not round-trip")
            elif rsum["dispatched"] != 9 or rsum["requeued"] != 1 or \
                    rsum["requeue_events"] != 1 or \
                    rsum["scale_events"] != 1 or \
                    rsum["reject_events"] != 1 or \
                    rsum["tenants"] != {"a": 0.75, "b": 0.25}:
                failures.append(f"router_summary columns wrong: {rsum}")
            else:
                line = render_router_line(rsum)
                for want in ("dispatched=9", "requeued=1", "a:0.75",
                             "ttft_p99=123.5ms"):
                    if want not in line:
                        failures.append(
                            f"router render line lost {want!r}: {line}")

        # the fairness-drift regression gate: BASE serves tenants a/b
        # exactly at their weight shares, NEW serves weight-0.25 tenant
        # a at DOUBLE its entitlement (share 0.5 — the 2x violation) so
        # max_drift = 0.25 > the 0.2 default; the diff must flag it,
        # with the worst tenant attributed, and A-vs-A must stay clean
        with tempfile.TemporaryDirectory() as d:
            fa, fb = os.path.join(d, "fa"), os.path.join(d, "fb")
            for path, share_a in ((fa, 0.25), (fb, 0.5)):
                j = J.RunJournal(path)
                j.start()
                j.record_request(
                    rid="t0", state="FINISHED", tenant="a",
                    arrival_t=0.0, admit_t=0.01, first_token_t=0.1,
                    finish_t=0.2, prompt_tokens=4, output_tokens=4,
                    device_ns=2_000_000, page_ns=5_000_000)
                j.event(
                    "tenant.summary", served_total=100,
                    tenants={
                        "a": {"share": share_a, "weight_share": 0.25,
                              "served_tokens": 100 * share_a},
                        "b": {"share": 1.0 - share_a,
                              "weight_share": 0.75,
                              "served_tokens": 100 * (1 - share_a)}})
                j.close()
            frep = diff_runs(load_run(fa), load_run(fb))
            if not frep["fairness_drift_regression"]:
                failures.append(
                    "diff missed the 2x fairness violation (weight "
                    f"share 0.25 served at 0.5): {frep}")
            if abs((frep["new_fairness_drift"] or 0) - 0.25) > 1e-12:
                failures.append(
                    f"fairness drift {frep['new_fairness_drift']} != "
                    "hand-computed 0.25")
            if frep.get("fairness_worst_tenant") not in ("a", "b"):
                failures.append(
                    "fairness regression lost the worst tenant: "
                    f"{frep.get('fairness_worst_tenant')}")
            if not frep["regression"]:
                failures.append("fairness drift did not fold into the "
                                "top-level regression flag")
            fself = diff_runs(load_run(fb), load_run(fb))
            if fself["regression"]:
                failures.append(
                    f"A-vs-A fairness diff false-positived: {fself}")
            rendered = render_run(load_run(fb))
            if "tenant a" not in rendered or "DRIFT" not in rendered:
                failures.append(
                    "render_run lost the tenant chargeback/fairness "
                    f"lines:\n{rendered}")
            if "dev_ms=2.000" not in rendered or \
                    "page_s=0.005" not in rendered:
                failures.append(
                    "tenant table lost the device/page attribution "
                    f"columns:\n{rendered}")
    finally:
        mfu.set_peak_flops(None)

    for line in failures:
        print(f"  FAILED — {line}")
    if failures:
        print(f"self-test FAILED: {len(failures)} check(s)")
        return 1
    print("self-test passed: journal round-trip, MFU/goodput summary, "
          "loss_spike + nonfinite_streak detectors, the diff gate "
          "flagged the injected step-time, loss, all-reduce-bytes, "
          "perf-gate (lost donation), plan-mismatch, memory-drift AND "
          "AOT warm-start "
          "regressions (and only them), serving request records "
          "round-trip with hand-computed TTFT/TPOT/queue percentile "
          "columns and the diff flagged the injected queue-share "
          "shift, "
          "rank-subdir run dirs render the fleet rollup line, "
          "serve-router events render the dispatched/requeued/tenant-"
          "share line, and the diff flagged the injected 2x fairness "
          "violation (A-vs-A clean)")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="run dir (render) or two run dirs with --diff")
    ap.add_argument("--diff", action="store_true",
                    help="diff two runs; exit 1 on regression")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--step-time-threshold", type=float,
                    default=DEFAULT_STEP_TIME_THRESHOLD,
                    help="allowed relative mean-step-time growth")
    ap.add_argument("--loss-threshold", type=float,
                    default=DEFAULT_LOSS_THRESHOLD,
                    help="allowed relative final-loss growth")
    ap.add_argument("--comm-threshold", type=float,
                    default=DEFAULT_COMM_THRESHOLD,
                    help="allowed relative all-reduce-bytes/step growth")
    ap.add_argument("--queue-share-threshold", type=float,
                    default=DEFAULT_QUEUE_SHARE_THRESHOLD,
                    help="allowed absolute growth in the serving "
                         "queue share of TTFT")
    ap.add_argument("--fairness-drift-threshold", type=float,
                    default=DEFAULT_FAIRNESS_DRIFT_THRESHOLD,
                    help="allowed absolute |served share - weight "
                         "share| fairness drift per tenant")
    ap.add_argument("--self-test", action="store_true",
                    help="synthetic 2-run pair: diff must flag the "
                         "injected regression, detectors must fire")
    args = ap.parse_args(argv)
    if args.self_test:
        return self_test()
    if args.diff:
        if len(args.paths) != 2:
            ap.error("--diff needs exactly two run dirs")
        rep = diff_runs(load_run(args.paths[0]), load_run(args.paths[1]),
                        step_time_threshold=args.step_time_threshold,
                        loss_threshold=args.loss_threshold,
                        comm_threshold=args.comm_threshold,
                        queue_share_threshold=args.queue_share_threshold,
                        fairness_drift_threshold=args
                        .fairness_drift_threshold)
        print(render_diff(rep, as_json=args.json))
        return 1 if rep["regression"] else 0
    if len(args.paths) != 1:
        ap.error("need one run dir (or --diff A B / --self-test)")
    path = args.paths[0]
    try:
        run = load_run(path)
    except FileNotFoundError:
        # a fleet run dir has no top-level journal: the supervisor's
        # record (when present) is the closest single-run view, plus
        # the cross-rank rollup line
        agg = fleet_summary(path)
        if agg is None:
            raise
        if args.json:
            print(json.dumps(agg, indent=1, default=str,
                             sort_keys=True))
            return 0
        from paddle_tpu_torch.obs.fleet import SUPERVISOR_DIR
        sup = os.path.join(path, SUPERVISOR_DIR)
        try:
            print(render_run(load_run(sup)))
        except FileNotFoundError:
            pass
        print(render_fleet_line(agg))
        return 0
    print(render_run(run, as_json=args.json))
    if not args.json:
        agg = fleet_summary(path)
        if agg is not None:
            print(render_fleet_line(agg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
