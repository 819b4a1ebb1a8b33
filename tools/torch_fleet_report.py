#!/usr/bin/env python3
"""torch_fleet_report: render, diff, and self-test cross-rank fleet runs
of ``paddle_tpu_torch`` — the port's counterpart of
``tools/fleet_report.py``, with its CLI and output.

The operational front door for ``paddle_tpu_torch.obs.fleet``: a fleet
run dir holds one ``rank_NN/`` journal per worker (or one per replica of
a serving fleet, beside the router's ``router/`` journal) plus a
supervisor's own ``supervisor/`` record. This CLI renders the per-rank
table and cross-rank skew summary (per-step max/median step time,
slowest-rank attribution, persistent-straggler and hung-rank detection),
fuses the per-rank Chrome traces into one Perfetto file with pid=rank
lanes, and gates skew regressions between two runs.

Usage:
    python3 tools/torch_fleet_report.py RUN_DIR            # table + skew
    python3 tools/torch_fleet_report.py RUN_DIR --json
    python3 tools/torch_fleet_report.py RUN_DIR --trace-out merged.json
    python3 tools/torch_fleet_report.py --diff BASE_DIR NEW_DIR \\
        [--skew-threshold 0.25]                     # exit 1 on regression
    python3 tools/torch_fleet_report.py --self-test        # canned 2-rank
        # fixtures (exact skew/straggler/percentile numbers)

The reference's self-test also runs a two-worker ``GangSupervisor``
drill with an injected ``worker_hang``; here ``_selftest_drill`` raises
``NotImplementedError`` naming ROADMAP Queue 1 item 6d, and the
self-test reports it as not run. Imports only ``paddle_tpu_torch``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


DEFAULT_SKEW_THRESHOLD = 0.25  # max cross-rank skew may grow 25%
DEFAULT_TTFT_THRESHOLD = 0.25  # merged p99 TTFT may grow 25%
DEFAULT_FAIRNESS_DRIFT_THRESHOLD = 0.20  # |served share - weight share|
#                 (absolute; mirrors obs.usage.DEFAULT_FAIRNESS_DRIFT_THRESHOLD)


THIS_DIR = os.path.dirname(os.path.abspath(__file__))


def _load_sibling(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(THIS_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fmt(v, nd=3):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


# -- render ------------------------------------------------------------------


def render_fleet(agg, as_json=False):
    if as_json:
        return json.dumps(agg, indent=1, default=str, sort_keys=True)
    lines = [f"fleet run    {agg.get('run_dir', '?')}",
             f"ranks        {agg['nranks']} "
             f"({agg['aligned_steps']} aligned steps"
             + (", supervised" if agg.get("supervisor") else "") + ")"]
    hdr = (f"{'rank':>4} {'steps':>6} {'last':>5} {'mean_ms':>8} "
           f"{'p50_ms':>7} {'goodput':>8} {'mfu':>7} {'ex/s':>8} "
           f"{'starts':>6} {'reqs':>5}")
    lines.append(hdr)
    hb = agg.get("heartbeat_age_s") or {}
    for rank in agg["ranks"]:
        r = agg["per_rank"][rank]
        lines.append(
            f"{rank:>4} {r['steps']:>6} {_fmt(r['last_step']):>5} "
            f"{_fmt(r['mean_step_ms']):>8} {_fmt(r['p50_step_ms']):>7} "
            f"{_fmt(r['goodput']):>8} {_fmt(r['mfu']):>7} "
            f"{_fmt(r['examples_per_s']):>8} {r['run_starts']:>6} "
            f"{r['requests']:>5}")
    skew = agg["skew"]
    if skew["max"] is not None:
        counts = ", ".join(f"rank {r}: {n}" for r, n in
                           sorted(skew["slowest_counts"].items()))
        lines.append(
            f"skew         max={skew['max']:.3g}x @step "
            f"{skew['max_step']} mean={_fmt(skew['mean'])}x over "
            f"{skew['steps_compared']} steps; slowest rank "
            f"{skew['worst_rank']} at {_fmt(skew['worst_rank_ratio'])}x "
            f"the others (slowest-per-step: {counts})")
    for s in agg.get("stragglers") or []:
        if s["kind"] == "slow":
            lines.append(
                f"straggler    rank {s['rank']} SLOW "
                f"{s['ratio']:.3g}x the gang from step "
                f"{s['first_step']} ({s['streak']} consecutive steps)")
        else:
            lines.append(
                f"straggler    rank {s['rank']} HUNG in attempt "
                f"{s['attempt']} (stopped at step {s['last_step']}, "
                f"gang reached {s['gang_reached']})"
                + (" [ambiguous]" if s.get("ambiguous") else ""))
    req = agg.get("requests")
    if req:
        lines.append(
            f"requests     {req['requests']} merged across ranks "
            f"({req['finished']} finished, {req['preemptions']} "
            f"preemptions)")
        for key in ("ttft_ms", "tpot_ms", "e2e_ms"):
            if req.get(f"{key}_p50") is not None:
                lines.append(f"{key:<12} p50={req[f'{key}_p50']:.3f} "
                             f"p99={req[f'{key}_p99']:.3f}")
    rt = agg.get("router")
    if rt:
        # ONE router-line format: run_report owns it (both tools render
        # the same obs.fleet.router_summary dict — a second
        # hand-maintained copy here had already drifted)
        lines.append(_load_sibling("torch_run_report").render_router_line(rt))
    tu = agg.get("tenant_usage")
    if tu and (tu.get("tenants") or tu.get("fairness")):
        # ONE tenant-table format: run_report owns it (same
        # single-owner discipline as the router line above)
        lines += _load_sibling("torch_run_report").render_tenant_table(tu)
    sup = agg.get("supervisor")
    if sup:
        line = (f"supervisor   restarts={sup['restarts']} "
                f"preemptions={sup['preemptions']} "
                f"watchdog_kills={sup['watchdog_kills']}")
        if sup.get("resume_ms_p50") is not None:
            line += (f" resume_ms p50={sup['resume_ms_p50']:.0f} "
                     f"max={sup['resume_ms_max']:.0f}")
        if sup["budget_exhausted"]:
            line += " BUDGET-EXHAUSTED"
        lines.append(line)
    if hb:
        lines.append("heartbeats   " + ", ".join(
            f"rank {r}: {_fmt(a)}s" for r, a in sorted(hb.items())))
    rollup = []
    for key in ("goodput_min", "examples_per_s_total", "mfu_mean"):
        if agg.get(key) is not None:
            rollup.append(f"{key}={_fmt(agg[key])}")
    if rollup:
        lines.append("gang         " + " ".join(rollup))
    return "\n".join(lines)


# -- diff (the skew-regression gate) -----------------------------------------


def diff_fleets(base, new, skew_threshold=DEFAULT_SKEW_THRESHOLD,
                ttft_threshold=DEFAULT_TTFT_THRESHOLD,
                fairness_drift_threshold=(
                    DEFAULT_FAIRNESS_DRIFT_THRESHOLD)):
    """Compare two fleet aggregates; regression flips when NEW's
    cross-rank skew (or straggler count) is worse than BASE beyond the
    threshold. A perfectly balanced base (skew 1.0) regressing to ANY
    persistent straggler is flagged regardless of ratio. Serve fleets:
    the MERGED (cross-replica pooled) p99 TTFT gates the same way —
    the aggregate serving-SLO axis a per-rank skew number can't see —
    and NEW's fairness drift (worst |served share - weight share| from
    the router's tenant.summary) exceeding the absolute threshold AND
    base's own drift flags a weighted-scheduling regression (the
    worse-than-base clause keeps A-vs-A clean by construction)."""
    bs, ns = base["skew"]["max"], new["skew"]["max"]
    b_slow = sum(1 for s in base.get("stragglers") or []
                 if s["kind"] == "slow")
    n_slow = sum(1 for s in new.get("stragglers") or []
                 if s["kind"] == "slow")
    b_hang = sum(1 for s in base.get("stragglers") or []
                 if s["kind"] == "hang")
    n_hang = sum(1 for s in new.get("stragglers") or []
                 if s["kind"] == "hang")
    out = {
        "base_skew_max": bs, "new_skew_max": ns,
        "skew_ratio": (ns / bs) if bs and ns else None,
        "skew_regression": bool(
            bs is not None and ns is not None and
            ns > bs * (1.0 + skew_threshold)),
        "base_stragglers": b_slow, "new_stragglers": n_slow,
        "straggler_regression": n_slow > b_slow,
        "base_hangs": b_hang, "new_hangs": n_hang,
        "hang_regression": n_hang > b_hang,
    }
    bt = (base.get("requests") or {}).get("ttft_ms_p99")
    nt = (new.get("requests") or {}).get("ttft_ms_p99")
    out["base_ttft_p99_ms"] = bt
    out["new_ttft_p99_ms"] = nt
    out["ttft_ratio"] = (nt / bt) if bt and nt else None
    out["ttft_regression"] = bool(
        bt is not None and nt is not None and
        nt > bt * (1.0 + ttft_threshold))
    bfd = ((base.get("tenant_usage") or {}).get("fairness")
           or {}).get("max_drift")
    nfd = ((new.get("tenant_usage") or {}).get("fairness")
           or {}).get("max_drift")
    out["base_fairness_drift"] = bfd
    out["new_fairness_drift"] = nfd
    out["fairness_drift_regression"] = bool(
        nfd is not None and nfd > fairness_drift_threshold and
        (bfd is None or nfd > bfd))
    if out["fairness_drift_regression"]:
        out["fairness_worst_tenant"] = \
            ((new.get("tenant_usage") or {}).get("fairness")
             or {}).get("worst_tenant")
    out["regression"] = out["skew_regression"] or \
        out["straggler_regression"] or out["hang_regression"] or \
        out["ttft_regression"] or out["fairness_drift_regression"]
    return out


def render_diff(rep, as_json=False):
    if as_json:
        return json.dumps(rep, indent=1, default=str, sort_keys=True)
    return "\n".join(f"{k:<22} {_fmt(v, 6)}"
                     for k, v in rep.items() if v is not None)


# -- self-test ---------------------------------------------------------------


def _write_rank(run_dir, rank, step_ms, n_steps=10, requests=(),
                tenant=None):
    """One canned rank journal through the REAL RunJournal API."""
    from paddle_tpu_torch.obs import journal as J

    j = J.RunJournal(run_dir, rank=rank, flush_every=1)
    j.start()
    for i in range(1, n_steps + 1):
        j.sync_step(i)
        j.record_step(loss=1.0 / i, step_ms=step_ms, examples=8,
                      source="self_test")
    for i, ttft_ms in enumerate(requests):
        j.record_request(
            rid=f"r{rank}_{i}", state="FINISHED", arrival_t=0.0,
            admit_t=0.001, first_token_t=ttft_ms / 1e3, finish_t=2.0,
            prompt_tokens=4, output_tokens=5,
            **({"tenant": tenant} if tenant else {}))
    j.close()
    return j


def _selftest_fixtures(failures):
    from paddle_tpu_torch.obs import fleet as F

    with tempfile.TemporaryDirectory() as d:
        skewed = os.path.join(d, "skewed")
        # rank 1 is a KNOWN 2x straggler: 20 ms steps vs rank 0's 10 ms
        # (skew = max/median-of-ranks = 20/15; straggler ratio =
        # slowest/median-of-OTHERS = 20/10 = 2.0 exactly).
        # Requests: rank 0 TTFT 100..500 ms, rank 1 600..1000 ms, so
        # the MERGED pool is 100..1000 and nearest-rank p50/p99 are
        # hand-computable: p50 = 500 ms, p99 = 1000 ms.
        _write_rank(skewed, 0, 10.0,
                    requests=[100.0, 200.0, 300.0, 400.0, 500.0])
        _write_rank(skewed, 1, 20.0,
                    requests=[600.0, 700.0, 800.0, 900.0, 1000.0])
        agg = F.aggregate(skewed)
        if agg["nranks"] != 2 or agg["aligned_steps"] != 10:
            failures.append(f"fixture alignment wrong: {agg['nranks']} "
                            f"ranks, {agg['aligned_steps']} steps")
        if abs((agg["skew"]["max"] or 0) - 20.0 / 15.0) > 1e-12:
            failures.append(f"skew max {agg['skew']['max']} != exact "
                            f"20/15")
        if agg["skew"]["worst_rank"] != 1 or \
                abs((agg["skew"]["worst_rank_ratio"] or 0) - 2.0) > 1e-12:
            failures.append(
                f"straggler attribution wrong: rank "
                f"{agg['skew']['worst_rank']} at "
                f"{agg['skew']['worst_rank_ratio']}x (want rank 1 at "
                f"2.0x)")
        if agg["skew"]["slowest_counts"] != {1: 10}:
            failures.append(f"slowest-per-step counts "
                            f"{agg['skew']['slowest_counts']} != "
                            "{1: 10}")
        slow = [s for s in agg["stragglers"] if s["kind"] == "slow"]
        if len(slow) != 1 or slow[0]["rank"] != 1 or \
                abs(slow[0]["ratio"] - 2.0) > 1e-12 or \
                slow[0]["first_step"] != 1:
            failures.append(f"persistent-straggler episode wrong: "
                            f"{slow}")
        req = agg["requests"]
        if not req or req["requests"] != 10:
            failures.append(f"merged requests lost records: {req}")
        elif abs(req["ttft_ms_p50"] - 500.0) > 1e-9 or \
                abs(req["ttft_ms_p99"] - 1000.0) > 1e-9:
            failures.append(
                f"merged percentiles off hand-computed values: "
                f"p50={req['ttft_ms_p50']} (want 500) "
                f"p99={req['ttft_ms_p99']} (want 1000)")

        # detector re-arm: a recovered episode re-fires on the next one
        rows = F.step_skew(F.align_steps(F.load_fleet(skewed)))
        det = F.StragglerDetector(factor=1.5, patience=3)
        fired = [det.update(r) for r in rows]
        if sum(1 for f in fired if f) != 1:
            failures.append("detector fired more than once per episode")
        healthy_row = dict(rows[0], slowest_vs_others=1.0)
        det2 = F.StragglerDetector(factor=1.5, patience=2)
        seq = [rows[0], rows[1], healthy_row, rows[2], rows[3]]
        refires = sum(1 for r in seq if det2.update(r))
        if refires != 2:
            failures.append(f"re-arm failed: {refires} firings across "
                            "two separated episodes (want 2)")

        # the balanced baseline: same gang, no skew
        balanced = os.path.join(d, "balanced")
        _write_rank(balanced, 0, 10.0)
        _write_rank(balanced, 1, 10.0)
        bal = F.aggregate(balanced)
        if bal["stragglers"]:
            failures.append(f"balanced fixture false-positived: "
                            f"{bal['stragglers']}")
        rep = diff_fleets(bal, agg)
        if not rep["skew_regression"] or not rep["straggler_regression"]:
            failures.append(f"diff missed the injected 2x skew "
                            f"regression: {rep}")
        self_rep = diff_fleets(agg, agg)
        if self_rep["regression"]:
            failures.append(f"A-vs-A diff false-positived: {self_rep}")
        if "straggler    rank 1 SLOW 2x" not in render_fleet(agg):
            failures.append("render lost the straggler line:\n"
                            + render_fleet(agg))

        # serve-fleet axes: a run whose merged p99 TTFT doubled
        # (rank 0: 200..1000 ms, rank 1: 1200..2000 ms -> pooled p99 =
        # 2000 ms exactly, 2x the skewed fixture's 1000 ms) must trip
        # the TTFT gate — and ONLY it (same step times as balanced)
        slower = os.path.join(d, "slower")
        _write_rank(slower, 0, 10.0,
                    requests=[200.0, 400.0, 600.0, 800.0, 1000.0])
        _write_rank(slower, 1, 10.0,
                    requests=[1200.0, 1400.0, 1600.0, 1800.0, 2000.0])
        slow_agg = F.aggregate(slower)
        trep = diff_fleets(agg, slow_agg)
        if not trep["ttft_regression"] or \
                abs((trep["ttft_ratio"] or 0) - 2.0) > 1e-9:
            failures.append(
                f"diff missed the 2x merged-p99-TTFT regression: "
                f"{trep}")
        if trep["skew_regression"] or trep["straggler_regression"]:
            failures.append(
                f"TTFT fixture false-positived a skew/straggler "
                f"regression: {trep}")

        # a router journal under <run>/router joins the aggregate and
        # renders the dispatch/requeue line
        from paddle_tpu_torch.obs import journal as J

        rj = J.RunJournal(os.path.join(skewed, J.ROUTER_DIR),
                          rank=None, flush_every=1)
        rj.start()
        rj.event("router.summary", dispatched=12, requeued=2,
                 rejected=1, completed=10, replicas=2, scale_ups=0,
                 scale_downs=0, tenants={"default": 1.0},
                 ttft_p99_ms=1000.0)
        rj.close()
        ragg = F.aggregate(skewed)
        rt = ragg.get("router")
        if not rt or rt["dispatched"] != 12 or rt["requeued"] != 2:
            failures.append(f"aggregate lost the router journal: {rt}")
        elif "router       dispatched=12 requeued=2" not in \
                render_fleet(ragg):
            failures.append("render lost the router line:\n"
                            + render_fleet(ragg))

        # the fairness-drift gate: CLEAN serves weight-0.25 tenant a
        # exactly at its entitlement, VIOL serves it at DOUBLE (share
        # 0.5 — the 2x violation, max_drift 0.25 > the 0.2 default);
        # the diff must flag it — and ONLY it — and A-vs-A stays clean
        fclean, fviol = os.path.join(d, "fclean"), os.path.join(d,
                                                                "fviol")
        for path, share_a in ((fclean, 0.25), (fviol, 0.5)):
            _write_rank(path, 0, 10.0, requests=[100.0], tenant="a")
            rj2 = J.RunJournal(os.path.join(path, J.ROUTER_DIR),
                               rank=None, flush_every=1)
            rj2.start()
            rj2.event(
                "tenant.summary", served_total=100,
                tenants={
                    "a": {"share": share_a, "weight_share": 0.25,
                          "served_tokens": 100 * share_a},
                    "b": {"share": 1.0 - share_a, "weight_share": 0.75,
                          "served_tokens": 100 * (1 - share_a)}})
            rj2.close()
        aggv = F.aggregate(fviol)
        frep = diff_fleets(F.aggregate(fclean), aggv)
        if not frep["fairness_drift_regression"]:
            failures.append(
                "diff missed the 2x fairness violation (weight share "
                f"0.25 served at 0.5): {frep}")
        if abs((frep["new_fairness_drift"] or 0) - 0.25) > 1e-12:
            failures.append(
                f"fairness drift {frep['new_fairness_drift']} != "
                "hand-computed 0.25")
        if frep["skew_regression"] or frep["straggler_regression"] or \
                frep["ttft_regression"]:
            failures.append(
                f"fairness fixture false-positived another gate: "
                f"{frep}")
        if not frep["regression"]:
            failures.append("fairness drift did not fold into the "
                            "top-level fleet regression flag")
        fself = diff_fleets(aggv, aggv)
        if fself["regression"]:
            failures.append(
                f"A-vs-A fairness diff false-positived: {fself}")
        rendered = render_fleet(aggv)
        if "tenant a" not in rendered or "DRIFT" not in rendered:
            failures.append("render lost the tenant/fairness lines:\n"
                            + rendered)
    print("  fixtures       ok — exact 20/15 skew, rank-1-at-2.0x "
          "attribution, merged p50=500/p99=1000, re-arm, diff gate, "
          "2x-TTFT gate, router line, 2x-fairness-violation gate "
          "(A-vs-A clean)"
          if not failures else
          f"  fixtures       FAILED ({len(failures)})")
    return failures


def _selftest_drill(failures):
    """The reference's acceptance drill (``tools/fleet_report.py``): a
    real two-worker ``GangSupervisor`` run with an injected
    ``worker_hang``, whose journals must name the hung rank. The gang
    supervisor (``resilience.elastic``) is not ported yet."""
    raise NotImplementedError(
        "fleet_report's hang_drill needs resilience.elastic's "
        "GangSupervisor, which is not ported to paddle_tpu_torch yet "
        "(ROADMAP Queue 1 item 6d)")


def self_test():
    failures = []
    failures = _selftest_fixtures(failures)
    if not failures:
        try:
            failures = _selftest_drill(failures)
        except NotImplementedError as e:
            print(f"  hang_drill     not run: {e}")
    if failures:
        for f in failures:
            print(f"  FAILED — {f}")
        print(f"self-test FAILED: {len(failures)} check(s)")
        return 1
    print("self-test passed: canned 2-rank fixtures reproduce exact "
          "skew/straggler/percentile numbers (incl. the 2x merged-p99-"
          "TTFT serve gate and the router summary line); the hang drill "
          "waits for the gang supervisor")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="fleet run dir (render) or two with --diff")
    ap.add_argument("--diff", action="store_true",
                    help="diff two fleet runs; exit 1 on skew/"
                         "straggler regression")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="write the merged per-rank Chrome trace here")
    ap.add_argument("--skew-threshold", type=float,
                    default=DEFAULT_SKEW_THRESHOLD,
                    help="allowed relative cross-rank skew growth "
                         "(--diff)")
    ap.add_argument("--ttft-threshold", type=float,
                    default=DEFAULT_TTFT_THRESHOLD,
                    help="allowed relative merged-p99-TTFT growth "
                         "(--diff, serve fleets)")
    ap.add_argument("--fairness-drift-threshold", type=float,
                    default=DEFAULT_FAIRNESS_DRIFT_THRESHOLD,
                    help="allowed absolute |served share - weight "
                         "share| fairness drift per tenant (--diff, "
                         "serve fleets)")
    ap.add_argument("--self-test", action="store_true")
    args = ap.parse_args(argv)
    from paddle_tpu_torch.obs import fleet as F

    if args.self_test:
        return self_test()
    if args.diff:
        if len(args.paths) != 2:
            ap.error("--diff needs exactly two fleet run dirs")
        rep = diff_fleets(F.aggregate(args.paths[0]),
                          F.aggregate(args.paths[1]),
                          skew_threshold=args.skew_threshold,
                          ttft_threshold=args.ttft_threshold,
                          fairness_drift_threshold=args
                          .fairness_drift_threshold)
        print(render_diff(rep, as_json=args.json))
        return 1 if rep["regression"] else 0
    if len(args.paths) != 1:
        ap.error("need one fleet run dir (or --diff A B / --self-test)")
    agg = F.aggregate(args.paths[0])
    print(render_fleet(agg, as_json=args.json))
    if args.trace_out:
        merged = F.merge_chrome_traces(args.paths[0], args.trace_out)
        print(f"merged trace {merged['path']} "
              f"({merged['sources']} rank traces, "
              f"{merged['events']} events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
