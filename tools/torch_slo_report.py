#!/usr/bin/env python3
"""torch_slo_report: render, gate, and self-test serving SLO compliance
of ``paddle_tpu_torch`` runs — the port's counterpart of
``tools/slo_report.py``, with its CLI and output.

The operational front door for ``paddle_tpu_torch.obs.slo`` (the SLO
complement of tools/torch_request_report.py): a serve run dir's
journals (top-level single-engine, ``router/``, ``rank_NN/``) carry the
evaluator's latched ``slo.fire``/``slo.clear`` events, the final
``slo.summary`` truth, and the raw per-request records. This CLI
renders the alert timeline and per-objective budget, re-evaluates a
finished run against a declarative spec (the same exact percentile
math ``torch_serve_bench --slo`` gates on), and diffs two runs as an
SLO regression gate.

Usage:
    python3 tools/torch_slo_report.py RUN_DIR               # timeline
    python3 tools/torch_slo_report.py RUN_DIR --json
    python3 tools/torch_slo_report.py RUN_DIR \\
        --spec '{"ttft_p99_ms": 250, "availability": 0.999}'
        # also accepts --spec @spec.json; exit 1 on violation
    python3 tools/torch_slo_report.py --diff BASE_DIR NEW_DIR \\
        [--spec SPEC] [--latency-threshold 0.25]     # exit 1 on regression
    python3 tools/torch_slo_report.py --self-test
        # ManualClock burn-rate fixture (host only): the 14.4x fast-burn
        # page fires at the hand-computed instant, clears on recovery,
        # never double-fires while latched; the scraped slo_burn_rate
        # gauge is bitwise-equal to the evaluator's float; the journal
        # timeline reconstructs the evaluator's alert log; A-vs-A diffs
        # clean.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DEFAULT_LATENCY_THRESHOLD = 0.25  # p99 latency may grow 25% (--diff)


def _fmt(v, nd=4):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


# -- render ------------------------------------------------------------------


def report(run_dir, specs=None):
    """Everything this CLI knows about one run: the pooled journal's
    SLO timeline (``fleet.slo_summary``) plus, with a spec, the
    post-hoc ``slo.evaluate_run`` verdict."""
    from paddle_tpu_torch.obs import fleet as F
    from paddle_tpu_torch.obs import slo as S

    pooled = S.load_any(run_dir)
    merged = {"events": pooled["events"],
              "requests": pooled["requests"]}
    rep = {"run_dir": pooled["run_dir"],
           "slo": F.slo_summary(merged),
           "requests": len(pooled["requests"]),
           "evaluation": None}
    if specs is not None:
        rep["evaluation"] = S.evaluate_run(pooled, specs)
    return rep


def render(rep, as_json=False):
    if as_json:
        return json.dumps(rep, indent=1, default=str, sort_keys=True)
    lines = [f"slo run      {rep.get('run_dir', '?')}",
             f"requests     {rep.get('requests', 0)}"]
    slo = rep.get("slo")
    if slo is None:
        lines.append("no slo.* events in this run's journals "
                     "(evaluator not installed?)")
    else:
        lines.append(f"alerts       {slo['fires']} fired / "
                     f"{slo['clears']} cleared"
                     + (f" / still firing: "
                        f"{', '.join(slo['active_at_end'])}"
                        if slo["active_at_end"] else ""))
        if slo.get("summary"):
            lines.append(f"{'objective':<16} {'budget_left':>11} "
                         f"{'burn_5m':>8} {'fires':>6}")
            for name, row in sorted(slo["summary"].items()):
                lines.append(
                    f"{name:<16} "
                    f"{_fmt(row.get('budget_remaining')):>11} "
                    f"{_fmt(row.get('burn_5m')):>8} "
                    f"{row.get('fires', 0):>6}")
        if slo["timeline"]:
            lines.append("timeline:")
            for t in slo["timeline"]:
                verb = "FIRE " if t["kind"] == "slo.fire" else "clear"
                who = f" worst={t['worst_replica']}" \
                    if t.get("worst_replica") is not None else ""
                lines.append(
                    f"  t={_fmt(t['at'], 6):>8} {verb} "
                    f"{t['objective']}/{t['severity']} "
                    f"burn {_fmt(t['burn_short'])}|"
                    f"{_fmt(t['burn_long'])} over {t['windows']} "
                    f"(>= {_fmt(t['threshold'])}){who}")
    ev = rep.get("evaluation")
    if ev is not None:
        lines.append(f"{'objective':<16} {'kind':<13} {'value':>9} "
                     f"{'target':>9} ok")
        for row in ev["objectives"]:
            tgt = row.get("threshold_ms", row.get("floor",
                                                  row.get("target")))
            ok = {True: "yes", False: "VIOLATED",
                  None: "no-data"}[row["ok"]]
            lines.append(f"{row['name']:<16} {row['kind']:<13} "
                         f"{_fmt(row['value']):>9} {_fmt(tgt):>9} {ok}")
        if ev["violations"]:
            lines.append("VIOLATIONS: " + ", ".join(ev["violations"]))
    return "\n".join(lines)


# -- diff (regression gate) --------------------------------------------------


def diff_runs(base, new, specs=None,
              latency_threshold=DEFAULT_LATENCY_THRESHOLD):
    """SLO regression verdict between two runs: a regression is a new
    objective violation the base didn't have, more alert fires than
    the base, or (with a spec) a latency objective whose measured
    value grew more than ``latency_threshold`` relative to the base.
    A-vs-A always diffs clean."""
    brep = report(base, specs)
    nrep = report(new, specs)
    checks = []

    bf = (brep["slo"] or {}).get("fires", 0)
    nf = (nrep["slo"] or {}).get("fires", 0)
    checks.append({"check": "alert_fires", "base": bf, "new": nf,
                   "regressed": nf > bf})
    if specs is not None:
        bviol = set(brep["evaluation"]["violations"])
        nviol = set(nrep["evaluation"]["violations"])
        fresh = sorted(nviol - bviol)
        checks.append({"check": "new_violations", "base": sorted(bviol),
                       "new": sorted(nviol), "regressed": bool(fresh)})
        bvals = {r["name"]: r["value"]
                 for r in brep["evaluation"]["objectives"]}
        for row in nrep["evaluation"]["objectives"]:
            if row["kind"] != "latency":
                continue
            bv, nv = bvals.get(row["name"]), row["value"]
            if bv is None or nv is None or bv <= 0:
                continue
            growth = nv / bv - 1.0
            checks.append({"check": f"{row['name']}_growth",
                           "base": bv, "new": nv, "growth": growth,
                           "regressed": growth > latency_threshold})
    return {"base": brep["run_dir"], "new": nrep["run_dir"],
            "checks": checks,
            "regression": any(c["regressed"] for c in checks)}


def render_diff(rep, as_json=False):
    if as_json:
        return json.dumps(rep, indent=1, default=str, sort_keys=True)
    lines = [f"slo diff     {rep['base']} -> {rep['new']}"]
    for c in rep["checks"]:
        flag = "REGRESSED" if c["regressed"] else "ok"
        extra = f" (+{c['growth']:.1%})" if "growth" in c else ""
        lines.append(f"  {c['check']:<22} {_fmt(c['base'])} -> "
                     f"{_fmt(c['new'])}{extra}  {flag}")
    lines.append("REGRESSION" if rep["regression"] else "clean")
    return "\n".join(lines)


# -- self-test ---------------------------------------------------------------


def _burn_fixture(run_dir, clock):
    """Drive the canonical availability fixture under a journal:
    target 0.99, 60 s ticks, 100 requests/tick; 40 clean warmup ticks,
    20 bad ticks at 50% rejects, 30 clean recovery ticks. Returns the
    evaluator plus the tick indices where each alert fired/cleared.

    Hand computation (exact because 60 s ticks align with the window
    edges): during the bad phase the 5m window (5 ticks) saturates at
    bad fraction 0.5 -> burn 50 >= 14.4 from bad tick 5; the 30m
    window (30 ticks) holds k bad ticks out of 30 after bad tick k, so
    burn_30m = (50k/3000)/0.01 = 5k/3 >= 14.4 first at k = 9 -> the
    page (needing BOTH) fires at bad tick 9. The warn's 3h window
    falls back to full history (40+k ticks): burn_3h =
    50k/(4000+100k)/0.01 >= 6 first at k = 6 (burn_30m = 10 >= 6
    there already) -> the warn fires at bad tick 6. In recovery the
    5m window holds 5-m bad ticks after clean tick m: burn_5m =
    10(5-m) < 14.4 first at m = 4 -> the page clears at clean tick 4;
    the 30m window still holds 30-m bad ticks until m = 20, then
    shrinks -- burn_30m = 5(30-m)/3 < 6 first at m = 27 -> the warn
    clears at clean tick 27 (its 3h burn is still ~11.5x: the long
    window is the evidence, the short one the fast clear)."""
    from paddle_tpu_torch.obs import journal as J
    from paddle_tpu_torch.obs.slo import SLOEvaluator

    ev = SLOEvaluator({"availability": 0.99}, clock=clock,
                      interval_s=60.0, include_registry=False)
    journal = J.start_run(run_dir)
    rej, disp = [0], [0]

    def snap():
        return {"serving.router.rejected": ("counter", float(rej[0])),
                "serving.router.dispatched":
                    ("counter", float(disp[0]))}

    def tick(n_rej, n_disp):
        rej[0] += n_rej
        disp[0] += n_disp
        clock.advance(60.0)
        return ev.observe(text=snap(), now=clock())

    marks = {}   # ("page"/"warn", "fire"/"clear") -> tick index
    fire_count = 0
    for _ in range(40):
        tick(0, 100)
    for k in range(1, 21):
        for t in tick(50, 50):
            sev = t["severity"]
            if t["kind"] == "slo.fire":
                if sev == "page":
                    fire_count += 1
                marks.setdefault((sev, "fire"), k)
    for m in range(1, 31):
        for t in tick(0, 100):
            marks.setdefault((t["severity"], "clear"), m)
    ev.journal_summary()
    journal.close()
    return ev, marks, fire_count


def self_test():
    from paddle_tpu_torch.obs import export as ex
    from paddle_tpu_torch.obs import fleet as F
    from paddle_tpu_torch.serving import ManualClock

    failures = []

    def check(name, cond, detail=""):
        if not cond:
            failures.append(f"{name}: {detail}")
            print(f"  FAIL {name} {detail}")
        else:
            print(f"  ok   {name}")

    with tempfile.TemporaryDirectory() as td:
        run_dir = os.path.join(td, "run")
        clock = ManualClock()
        ev, marks, fires = _burn_fixture(run_dir, clock)

        # 1. exact fire/clear instants (see _burn_fixture docstring)
        for sev, kind, want in (("page", "fire", 9),
                                ("page", "clear", 4),
                                ("warn", "fire", 6),
                                ("warn", "clear", 27)):
            got = marks.get((sev, kind))
            check(f"{sev}_{kind}s_at_hand_computed_tick", got == want,
                  f"{sev} {kind}d at tick {got}, expected {want}")
        check("page_latches_once", fires == 1,
              f"{fires} fires while latched, expected exactly 1")

        # 2. the scraped burn gauge is bitwise the evaluator's float
        vals = ex.parse_prometheus_text(ex.prometheus_text(slo=ev))
        for label in ("5m", "30m"):
            key = (f'paddle_tpu_slo_burn_rate{{objective='
                   f'"availability",window="{label}"}}')
            check(f"scraped_burn_{label}_bitwise",
                  vals.get(key) == ev.burn[("availability", label)],
                  f"{vals.get(key)!r} != "
                  f"{ev.burn[('availability', label)]!r}")
        bkey = ('paddle_tpu_slo_budget_remaining'
                '{objective="availability"}')
        check("scraped_budget_bitwise",
              vals.get(bkey) == ev.budget_left["availability"],
              f"{vals.get(bkey)!r} != "
              f"{ev.budget_left['availability']!r}")

        # 3. the journal reconstructs the evaluator's alert log
        rep = report(run_dir)
        slo = rep["slo"]
        check("journal_has_slo_events", slo is not None)
        if slo is not None:
            check("timeline_matches_alert_log",
                  [(t["at"], t["kind"], t["objective"], t["severity"])
                   for t in slo["timeline"]] ==
                  [(t["at"], t["kind"], t["objective"], t["severity"])
                   for t in ev.alert_log],
                  f"{len(slo['timeline'])} journaled vs "
                  f"{len(ev.alert_log)} in-memory transitions")
            check("summary_budget_matches_evaluator",
                  slo["summary"] is not None and
                  slo["summary"]["availability"]["budget_remaining"]
                  == ev.budget_left["availability"])
            check("nothing_firing_at_end", slo["active_at_end"] == [])

        # 4. evaluate_run on the same journal: no requests were served,
        # so availability has no signal -> no-data, not a violation
        evaluated = report(run_dir, specs={"availability": 0.99})
        row = evaluated["evaluation"]["objectives"][0]
        check("no_data_is_not_a_violation",
              row["ok"] is None and
              evaluated["evaluation"]["violations"] == [])

        # 5. A-vs-A diffs clean
        d = diff_runs(run_dir, run_dir, specs={"availability": 0.99})
        check("a_vs_a_diffs_clean", not d["regression"],
              render_diff(d))
        print(render(rep))

    if failures:
        print(f"self-test FAILED: {len(failures)} check(s)")
        return 1
    print("self-test passed: the 14.4x fast-burn page fires/clears at "
          "the hand-computed instants, scrapes bitwise, and the "
          "journal timeline reconstructs the evaluator's alert log")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="serve run dir (render) or two with --diff")
    ap.add_argument("--spec", type=str, default=None,
                    help="SLO spec: inline JSON or @path "
                         '(e.g. \'{"ttft_p99_ms": 250}\'); '
                         "exit 1 on violation")
    ap.add_argument("--diff", action="store_true",
                    help="diff two runs; exit 1 on SLO regression")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--latency-threshold", type=float,
                    default=DEFAULT_LATENCY_THRESHOLD,
                    help="allowed relative p99 latency growth (--diff "
                         "with --spec)")
    ap.add_argument("--self-test", action="store_true")
    args = ap.parse_args(argv)

    if args.self_test:
        return self_test()
    from paddle_tpu_torch.obs import slo as S

    specs = None if args.spec is None else S.parse_spec_arg(args.spec)
    if args.diff:
        if len(args.paths) != 2:
            ap.error("--diff needs exactly two run dirs")
        rep = diff_runs(args.paths[0], args.paths[1], specs=specs,
                        latency_threshold=args.latency_threshold)
        print(render_diff(rep, as_json=args.json))
        return 1 if rep["regression"] else 0
    if len(args.paths) != 1:
        ap.error("need one run dir (or --diff A B / --self-test)")
    rep = report(args.paths[0], specs=specs)
    print(render(rep, as_json=args.json))
    if rep["evaluation"] is not None and \
            rep["evaluation"]["violations"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
