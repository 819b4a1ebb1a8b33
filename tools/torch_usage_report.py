#!/usr/bin/env python3
"""torch_usage_report: per-tenant chargeback tables and fairness gates
over ``paddle_tpu_torch`` journals — the port's counterpart of
``tools/usage_report.py``, with its CLI and output.

The post-hoc front door for ``paddle_tpu_torch.obs.usage`` (the
chargeback twin of tools/torch_run_report.py): pool every journal under
a run dir (top-level single-engine, ``router/``, ``rank_NN/``) and
render the per-tenant bill — requests, prompt/decode tokens, attributed
device-milliseconds (integer-nanosecond device-second integrals that
telescope bitwise to replica busy time), KV page-MB-seconds (the
page-seconds integral scaled by the cache's bytes/page), and exact
p99 latency columns — next to the router's fairness audit
(measured served-token share vs configured weight share).

Usage:
    python3 tools/torch_usage_report.py RUN_DIR              # table
    python3 tools/torch_usage_report.py RUN_DIR --json
    python3 tools/torch_usage_report.py --diff BASE_DIR NEW_DIR \\
        [--fairness-drift-threshold 0.2] [--p99-threshold 0.25]
        # exit 1 when NEW drifted past the fairness threshold (and past
        # BASE's own drift — A-vs-A is clean by construction) or a
        # tenant's p99 regressed
    python3 tools/torch_usage_report.py --self-test [--device cpu]
        # hand-computed ManualClock fixtures, exact to the token and
        # the nanosecond; the engine run on the card, or on the host
        # with --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DEFAULT_FAIRNESS_DRIFT_THRESHOLD = 0.20  # |served share - weight share|
#                 (absolute; mirrors obs.usage.DEFAULT_FAIRNESS_DRIFT_THRESHOLD)
DEFAULT_P99_THRESHOLD = 0.25  # a tenant's p99 TTFT/e2e may grow 25%


# -- loading -----------------------------------------------------------------


def load_usage(run_dir):
    """Pool every journal under ``run_dir`` (``obs.slo.load_any``: the
    same loader the SLO evaluator uses, so single-engine and routed
    fleet runs bill identically) into one chargeback view: the
    per-tenant rollup over every request record, the router's final
    ``tenant.summary`` (+ fairness audit), and each replica's final
    ``tenant.usage`` engine truth."""
    from paddle_tpu_torch.obs import slo as _slo
    from paddle_tpu_torch.obs import usage as _usage

    pooled = run_dir if isinstance(run_dir, dict) else \
        _slo.load_any(run_dir)
    rollup = _usage.rollup_requests(pooled["requests"])
    rsum = None
    replicas = {}
    for e in pooled["events"]:
        kind = e.get("kind")
        if kind == "tenant.summary":
            rsum = e   # last wins: the final truth
        elif kind == "tenant.usage":
            # keyed by replica: a relaunched incarnation's later event
            # supersedes the killed one's (which never journals anyway)
            replicas[e.get("replica")] = e
    page_bytes = None
    for e in replicas.values():
        if isinstance(e.get("page_bytes"), (int, float)):
            page_bytes = e["page_bytes"]
    out = {
        "run_dir": pooled.get("run_dir"),
        "tenants": rollup,
        "router": None if rsum is None else {
            "served_total": rsum.get("served_total"),
            "tenants": rsum.get("tenants") or {}},
        "replicas": {
            rep: {k: e.get(k)
                  for k in ("busy_ns", "prefill_ns", "decode_ns",
                            "page_bytes", "page_open", "seq_allocs",
                            "seq_frees", "tenants")}
            for rep, e in sorted(replicas.items(),
                                 key=lambda kv: str(kv[0]))},
        "page_bytes": page_bytes,
        "fairness": None if rsum is None else _usage.fairness_audit(
            rsum.get("tenants") or {}),
    }
    return out


def page_mb_s(page_ns, page_bytes):
    """KV page-MB-seconds: the pages-held x time integral (int
    pages-nanoseconds) scaled by the cache's bytes per page. None when
    the run journaled no ``tenant.usage`` event to learn the page
    geometry from."""
    if page_bytes is None or page_ns is None:
        return None
    return (page_ns / 1e9) * (page_bytes / 1e6)


# -- render ------------------------------------------------------------------


def _fmt(v, nd=3):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def render_usage(u, as_json=False):
    """The chargeback table: one row per tenant, a totals row, the
    fairness verdict, and each replica's busy/attribution closure."""
    if as_json:
        return json.dumps(u, indent=1, default=str, sort_keys=True)
    lines = [f"run_dir      {u.get('run_dir', '?')}"]
    hdr = (f"{'tenant':<12} {'reqs':>5} {'done':>5} {'prompt':>7} "
           f"{'decode':>7} {'preempt':>7} {'device_ms':>10} "
           f"{'page_MB_s':>10} {'queue_p99':>9} {'ttft_p99':>9} "
           f"{'tpot_p99':>9} {'e2e_p99':>9}")
    lines.append(hdr)
    tenants = u.get("tenants") or {}
    tot = {"requests": 0, "completed": 0, "prompt_tokens": 0,
           "decode_tokens": 0, "preemptions": 0, "device_ns": 0,
           "page_ns": 0}
    for t in sorted(tenants):
        d = tenants[t]
        for k in tot:
            tot[k] += int(d.get(k) or 0)
        lines.append(
            f"{t:<12} {d.get('requests', 0):>5} "
            f"{d.get('completed', 0):>5} "
            f"{d.get('prompt_tokens', 0):>7} "
            f"{d.get('decode_tokens', 0):>7} "
            f"{d.get('preemptions', 0):>7} "
            f"{_fmt((d.get('device_ns') or 0) / 1e6):>10} "
            f"{_fmt(page_mb_s(d.get('page_ns'), u.get('page_bytes'))):>10} "
            f"{_fmt(d.get('queue_ms_p99')):>9} "
            f"{_fmt(d.get('ttft_ms_p99')):>9} "
            f"{_fmt(d.get('tpot_ms_p99')):>9} "
            f"{_fmt(d.get('e2e_ms_p99')):>9}")
    if tenants:
        lines.append(
            f"{'TOTAL':<12} {tot['requests']:>5} {tot['completed']:>5} "
            f"{tot['prompt_tokens']:>7} {tot['decode_tokens']:>7} "
            f"{tot['preemptions']:>7} "
            f"{_fmt(tot['device_ns'] / 1e6):>10} "
            f"{_fmt(page_mb_s(tot['page_ns'], u.get('page_bytes'))):>10} "
            f"{'':>9} {'':>9} {'':>9} {'':>9}")
    fair = u.get("fairness")
    if fair and fair.get("tenants"):
        line = (f"fairness     max_drift={fair['max_drift']:.3f} "
                f"threshold={fair['threshold']:.3f}")
        if fair.get("worst_tenant") is not None:
            line += f" worst={fair['worst_tenant']}"
        line += " ok" if fair.get("ok") else " DRIFT"
        lines.append(line)
    for rep, e in (u.get("replicas") or {}).items():
        attributed = sum(int(d.get("device_ns") or 0)
                         for d in (e.get("tenants") or {}).values())
        busy = e.get("busy_ns")
        closed = (busy == attributed) if busy is not None else None
        line = (f"replica {rep:<4} busy_ms="
                f"{_fmt((busy or 0) / 1e6)} "
                f"attributed_ms={_fmt(attributed / 1e6)} "
                + ("TELESCOPED" if closed
                   else f"LEAK {busy} != {attributed}"))
        if e.get("page_open"):
            line += f" OPEN-PAGES={e['page_open']}"
        lines.append(line)
    return "\n".join(lines)


# -- diff (the chargeback regression gate) -----------------------------------


def diff_usage(base, new,
               fairness_drift_threshold=DEFAULT_FAIRNESS_DRIFT_THRESHOLD,
               p99_threshold=DEFAULT_P99_THRESHOLD):
    """Compare two chargeback views: the fairness gate flips when NEW's
    max drift exceeds the absolute threshold AND base's own drift (so
    A-vs-A is clean by construction); the per-tenant p99 gate flips
    when a tenant served in BOTH runs regressed its p99 TTFT/e2e by
    more than ``p99_threshold`` (relative) — the per-tenant SLO axis an
    aggregate p99 column dilutes away."""
    bfd = ((base.get("fairness") or {}).get("max_drift"))
    nfd = ((new.get("fairness") or {}).get("max_drift"))
    out = {
        "base_fairness_drift": bfd,
        "new_fairness_drift": nfd,
        "fairness_drift_regression": bool(
            nfd is not None and nfd > fairness_drift_threshold and
            (bfd is None or nfd > bfd)),
    }
    if out["fairness_drift_regression"]:
        out["fairness_worst_tenant"] = \
            (new.get("fairness") or {}).get("worst_tenant")
    p99_regressions = []
    bt, nt = base.get("tenants") or {}, new.get("tenants") or {}
    for tenant in sorted(set(bt) & set(nt)):
        for key in ("ttft_ms_p99", "e2e_ms_p99"):
            bv, nv = bt[tenant].get(key), nt[tenant].get(key)
            if isinstance(bv, (int, float)) and \
                    isinstance(nv, (int, float)) and bv > 0 and \
                    nv > bv * (1.0 + p99_threshold):
                p99_regressions.append(
                    {"tenant": tenant, "metric": key,
                     "base": bv, "new": nv, "ratio": nv / bv})
    out["p99_regressions"] = p99_regressions
    out["p99_regression"] = bool(p99_regressions)
    out["regression"] = out["fairness_drift_regression"] or \
        out["p99_regression"]
    return out


def render_diff(rep, as_json=False):
    if as_json:
        return json.dumps(rep, indent=1, default=str, sort_keys=True)
    lines = []
    for k in ("base_fairness_drift", "new_fairness_drift",
              "fairness_drift_regression", "fairness_worst_tenant",
              "p99_regression", "regression"):
        if rep.get(k) is not None:
            v = rep[k]
            lines.append(f"{k:<26} "
                         + (f"{v:.6g}" if isinstance(v, float)
                            else str(v)))
    for r in rep.get("p99_regressions") or []:
        lines.append(f"  tenant {r['tenant']} {r['metric']} "
                     f"{r['base']:.3f} -> {r['new']:.3f} "
                     f"({r['ratio']:.2f}x)")
    return "\n".join(lines)


# -- self-test ---------------------------------------------------------------


def _selftest_meter(failures):
    """Attribution arithmetic, exact to the nanosecond: the divmod
    decode split (10 ns over 3 lanes -> 4,3,3 in survivor order) and
    the telescoping invariant busy == sum(per-tenant) ==
    sum(per-request), bitwise."""
    from types import SimpleNamespace

    from paddle_tpu_torch.obs.usage import UsageMeter

    m = UsageMeter(replica_id=7)
    reqs = [SimpleNamespace(rid=f"r{i}", tenant=t)
            for i, t in enumerate(("a", "a", "b"))]
    m.charge_prefill(reqs[0], 5e-9)           # 5 ns, tenant a
    m.charge_decode(reqs, 10e-9)              # 10 ns over 3 lanes
    if [m.request_ns[f"r{i}"] for i in range(3)] != [4 + 5, 3, 3]:
        failures.append(
            f"divmod split off: {m.request_ns} (want r0=5+4, r1=3, "
            "r2=3 — first rem lanes get the extra ns, survivor order)")
    if m.device_ns != {"a": 12, "b": 3}:
        failures.append(f"per-tenant device-ns {m.device_ns} != "
                        "{'a': 12, 'b': 3}")
    if m.busy_ns != 15 or m.prefill_ns != 5 or m.decode_ns != 10:
        failures.append(f"busy accounting off: busy={m.busy_ns} "
                        f"prefill={m.prefill_ns} decode={m.decode_ns}")
    try:
        m.verify()
    except AssertionError as e:
        failures.append(f"meter verify failed on exact fixture: {e}")
    m.charge_decode([], 1.0)  # zero survivors: charges nothing
    if m.busy_ns != 15:
        failures.append("an all-preempted (empty) decode pass must "
                        f"not count as busy: busy={m.busy_ns}")
    print("  meter          ok — 10ns/3 lanes -> 4,3,3; busy == "
          "sum(tenant) == sum(request) bitwise; empty pass not busy"
          if not failures else
          f"  meter          FAILED ({len(failures)})")
    return failures


def _selftest_pages(failures, device=None):
    """The hand-computed page-second integral: alloc 2 pages at t=0,
    extend to 3 pages at t=2, free at t=5 under a ManualClock ->
    2 pages x 2 s + 3 pages x 3 s = 13e9 pages-ns, exactly, with
    alloc==free closure."""
    from paddle_tpu_torch.serving.kv_cache import PagedKVCache
    from paddle_tpu_torch.serving.scheduler import ManualClock

    clk = ManualClock()
    cache = PagedKVCache(9, 8, 1, 4, max_seq_len=64, device=device)
    cache.clock = clk
    cache.alloc("s0", 16)     # 2 pages @ t=0
    clk.advance(2.0)
    cache.extend("s0", 8)     # +1 page @ t=2 (16 -> 24 tokens)
    clk.advance(3.0)
    cache.free("s0")          # close @ t=5
    got = cache.closed_page_ns("s0")
    if got != 13_000_000_000:
        failures.append(f"page integral {got} != hand-computed 13e9 "
                        "(2 pages x 2s + 3 pages x 3s)")
    pu = cache.page_usage()
    if pu["open"] or pu["seq_allocs"] != 1 or pu["seq_frees"] != 1:
        failures.append(f"alloc==free closure broken: {pu}")
    try:
        cache.verify()
    except AssertionError as e:
        failures.append(f"cache verify failed after closure: {e}")
    print("  pages          ok — 2p x 2s + 3p x 3s = 13e9 pages-ns "
          "exact, alloc==free closed"
          if not failures else
          f"  pages          FAILED ({len(failures)})")
    return failures


def _selftest_engine(failures, device=None):
    """A real TickingClock engine run billed end-to-end: every charged
    nanosecond lands on exactly one tenant (busy telescopes bitwise),
    every page-second interval closes, and the journal round-trips the
    bill token- and nanosecond-exact into the chargeback table."""
    from paddle_tpu_torch.obs import journal as J
    from paddle_tpu_torch.obs import usage as U
    from paddle_tpu_torch.serving.engine import ServeEngine, TinyLM
    from paddle_tpu_torch.serving.kv_cache import PagedKVCache
    from paddle_tpu_torch.serving.scheduler import Scheduler

    with tempfile.TemporaryDirectory() as d:
        with J.RunJournal(d, flush_every=1):
            clk = U.TickingClock()
            cache = PagedKVCache(16, 4, 2, 8, max_seq_len=32,
                                 device=device)
            eng = ServeEngine(
                TinyLM(device=device), cache,
                scheduler=Scheduler(cache, token_budget=64, clock=clk))
            ra = eng.submit([3, 1, 4], max_new_tokens=4, tenant="a")
            rb = eng.submit([2, 7], max_new_tokens=3, tenant="b")
            eng.run()
        if len(ra.generated) != 4 or len(rb.generated) != 3:
            failures.append(
                f"fixture run token counts off: a={len(ra.generated)} "
                f"(want 4) b={len(rb.generated)} (want 3)")
        eng.usage.verify()
        eu = U.engine_tenant_usage(eng)
        if sum(t["device_ns"] for t in eu["tenants"].values()) != \
                eng.usage.busy_ns:
            failures.append("engine_tenant_usage lost nanoseconds: "
                            f"{eu}")
        if eu["page_open"]:
            failures.append(f"open page intervals after drain: {eu}")
        u = load_usage(d)
        for tenant, want_dev, want_page in (
                ("a", eng.usage.device_ns["a"],
                 cache.closed_page_ns(ra.rid)),
                ("b", eng.usage.device_ns["b"],
                 cache.closed_page_ns(rb.rid))):
            row = (u["tenants"] or {}).get(tenant)
            if row is None:
                failures.append(f"journal lost tenant {tenant}")
                continue
            if row["device_ns"] != want_dev:
                failures.append(
                    f"journal round-trip lost nanoseconds for "
                    f"{tenant}: {row['device_ns']} != {want_dev}")
            if row["page_ns"] != want_page:
                failures.append(
                    f"journal round-trip lost page-ns for {tenant}: "
                    f"{row['page_ns']} != {want_page}")
        arow, brow = u["tenants"].get("a"), u["tenants"].get("b")
        if arow and (arow["prompt_tokens"] != 3
                     or arow["decode_tokens"] != 4):
            failures.append(f"tenant a tokens off: {arow}")
        if brow and (brow["prompt_tokens"] != 2
                     or brow["decode_tokens"] != 3):
            failures.append(f"tenant b tokens off: {brow}")
        total_dev = sum(t["device_ns"] for t in u["tenants"].values())
        if total_dev != eng.usage.busy_ns:
            failures.append(
                f"chargeback total {total_dev} != replica busy "
                f"{eng.usage.busy_ns} (telescoping broke in the "
                "journal)")
        table = render_usage(u)
        if "tenant" not in table or not any(
                ln.startswith("a ") for ln in table.splitlines()):
            failures.append(f"chargeback table lost tenants:\n{table}")
    print("  engine         ok — TickingClock run billed bitwise "
          "(journal device-ns == meter, pages closed, tokens exact)"
          if not failures else
          f"  engine         FAILED ({len(failures)})")
    return failures


def _selftest_fairness(failures):
    """The fairness-drift gate on journal fixtures: the 2x violation
    (weight-0.25 tenant served at share 0.5, drift 0.25 > 0.2) fires;
    A-vs-A is clean; a 2x per-tenant p99 regression fires the p99
    gate."""
    from paddle_tpu_torch.obs import journal as J

    with tempfile.TemporaryDirectory() as d:
        runs = {}
        for name, share_a, ttft_a in (("clean", 0.25, 0.1),
                                      ("viol", 0.5, 0.1),
                                      ("slow", 0.25, 0.2)):
            path = os.path.join(d, name)
            j = J.RunJournal(path, flush_every=1)
            j.start()
            for i in range(4):
                j.record_request(
                    rid=f"ra{i}", state="FINISHED", tenant="a",
                    arrival_t=0.0, admit_t=0.01, first_token_t=ttft_a,
                    finish_t=0.5, prompt_tokens=4, output_tokens=4,
                    device_ns=1_000_000, page_ns=2_000_000)
                j.record_request(
                    rid=f"rb{i}", state="FINISHED", tenant="b",
                    arrival_t=0.0, admit_t=0.01, first_token_t=0.1,
                    finish_t=0.5, prompt_tokens=4, output_tokens=4,
                    device_ns=1_000_000, page_ns=2_000_000)
            j.event(
                "tenant.summary", served_total=100,
                tenants={
                    "a": {"share": share_a, "weight_share": 0.25,
                          "served_tokens": 100 * share_a},
                    "b": {"share": 1.0 - share_a, "weight_share": 0.75,
                          "served_tokens": 100 * (1 - share_a)}})
            j.close()
            runs[name] = load_usage(path)
        rep = diff_usage(runs["clean"], runs["viol"])
        if not rep["fairness_drift_regression"] or not rep["regression"]:
            failures.append(
                f"diff missed the 2x fairness violation: {rep}")
        if abs((rep["new_fairness_drift"] or 0) - 0.25) > 1e-12:
            failures.append(
                f"fairness drift {rep['new_fairness_drift']} != "
                "hand-computed 0.25")
        if rep["p99_regression"]:
            failures.append(
                f"fairness fixture false-positived the p99 gate: {rep}")
        self_rep = diff_usage(runs["viol"], runs["viol"])
        if self_rep["regression"]:
            failures.append(f"A-vs-A diff false-positived: {self_rep}")
        prep = diff_usage(runs["clean"], runs["slow"])
        if not prep["p99_regression"] or not prep["regression"]:
            failures.append(
                f"diff missed tenant a's 2x TTFT p99 regression: "
                f"{prep}")
        if any(r["tenant"] != "a" for r in prep["p99_regressions"]):
            failures.append(
                "p99 regression misattributed (only tenant a slowed): "
                f"{prep['p99_regressions']}")
        if prep["fairness_drift_regression"]:
            failures.append(
                f"p99 fixture false-positived the fairness gate: "
                f"{prep}")
        rendered = render_usage(runs["viol"])
        if "DRIFT" not in rendered:
            failures.append(
                f"render lost the fairness verdict:\n{rendered}")
        drep = render_diff(rep)
        if "fairness_drift_regression" not in drep:
            failures.append(f"render_diff lost the gate line:\n{drep}")
    print("  fairness       ok — 2x violation fires (drift exactly "
          "0.25), A-vs-A clean, per-tenant 2x p99 gate fires"
          if not failures else
          f"  fairness       FAILED ({len(failures)})")
    return failures


def self_test(device=None):
    failures = []
    failures = _selftest_meter(failures)
    failures = _selftest_pages(failures, device)
    failures = _selftest_engine(failures, device)
    failures = _selftest_fairness(failures)
    if failures:
        for f in failures:
            print(f"  FAILED — {f}")
        print(f"self-test FAILED: {len(failures)} check(s)")
        return 1
    print("self-test passed: divmod decode split (10ns/3 -> 4,3,3) "
          "and busy telescoping bitwise, 13e9 pages-ns integral with "
          "alloc==free closure, a TickingClock engine run billed "
          "token- and nanosecond-exact through the journal into the "
          "chargeback table, and the diff gates fire on the injected "
          "2x fairness violation and 2x per-tenant p99 regression "
          "(A-vs-A clean)")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="run dir (render) or two run dirs with --diff")
    ap.add_argument("--diff", action="store_true",
                    help="diff two runs' chargeback views; exit 1 on "
                         "fairness drift or per-tenant p99 regression")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--fairness-drift-threshold", type=float,
                    default=DEFAULT_FAIRNESS_DRIFT_THRESHOLD,
                    help="allowed absolute |served share - weight "
                         "share| fairness drift per tenant")
    ap.add_argument("--p99-threshold", type=float,
                    default=DEFAULT_P99_THRESHOLD,
                    help="allowed relative per-tenant p99 TTFT/e2e "
                         "growth (--diff)")
    ap.add_argument("--self-test", action="store_true",
                    help="hand-computed ManualClock chargeback "
                         "fixtures, exact to the token and nanosecond")
    ap.add_argument("--device", default=None,
                    help="the self-test engine's device (default: the "
                         "CUDA card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    if args.self_test:
        return self_test(args.device)
    if args.diff:
        if len(args.paths) != 2:
            ap.error("--diff needs exactly two run dirs")
        rep = diff_usage(
            load_usage(args.paths[0]), load_usage(args.paths[1]),
            fairness_drift_threshold=args.fairness_drift_threshold,
            p99_threshold=args.p99_threshold)
        print(render_diff(rep, as_json=args.json))
        return 1 if rep["regression"] else 0
    if len(args.paths) != 1:
        ap.error("need one run dir (or --diff A B / --self-test)")
    print(render_usage(load_usage(args.paths[0]), as_json=args.json))
    return 0


if __name__ == "__main__":
    sys.exit(main())
