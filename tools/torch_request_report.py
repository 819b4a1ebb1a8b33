#!/usr/bin/env python3
"""torch_request_report: per-request timelines and tail-latency
attribution from a ``paddle_tpu_torch`` run's journals — the port's
counterpart of ``tools/request_report.py``, with its CLI and output.

The CLI front door for ``paddle_tpu_torch.obs.reqtrace`` (the read side
of the ``req.*`` lifecycle events the serving stack journals): assemble
one run's router + replica journals into per-request timelines, print
each request's exact phase decomposition (rate-limit wait / router
queue / requeue loss / scheduler queue / prefill / preemption loss /
decode — the telescope sums to e2e by construction), rank the
worst-percentile tail, and export the timelines as Perfetto request
lanes (one row per request, flow arrows across requeues).

Usage:
    python3 tools/torch_request_report.py RUN_DIR              # table
    python3 tools/torch_request_report.py RUN_DIR --json
    python3 tools/torch_request_report.py RUN_DIR --worst 5 --key e2e_ms
    python3 tools/torch_request_report.py RUN_DIR --trace-out req.json
    python3 tools/torch_request_report.py --self-test [--device cpu]

--self-test asserts on a ManualClock:
- a REAL pressured ServeEngine run (on the card, or on the host with
  ``--device cpu``): every attribution sums bitwise to its e2e, and
  preemption loss matches the engine's own stamp pairs;
- a hand-written routed fixture (router + 2 replica journals, one
  requeue + one rate-limit hold + one preemption): every phase equals
  its hand-computed value to the nanosecond, the timeline carries BOTH
  dispatch segments, and the exported lanes draw the cross-replica
  flow arrow.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# column labels for reqtrace.PHASES, in canonical order
PHASE_LABELS = ("rate", "router", "requeue", "sched", "prefill",
                "preempt", "decode")


def render_table(atts):
    """Fixed-width attribution table, one row per request."""
    from paddle_tpu_torch.obs.reqtrace import PHASES

    lines = ["  " + "rid".ljust(12) + "st".rjust(3) + "dsp".rjust(4)
             + "rq".rjust(3) + "pre".rjust(4)
             + "".join(c.rjust(10) for c in
                       ("ttft", "e2e") + PHASE_LABELS)]
    for a in atts:
        row = [a["ttft_ms"], a["e2e_ms"]] + [a[p] for p in PHASES]
        lines.append(
            "  " + str(a["rid"]).ljust(12)
            + str((a["state"] or "?")[:2]).rjust(3)
            + str(a["dispatches"]).rjust(4)
            + str(a["requeues"]).rjust(3)
            + str(a["preemptions"]).rjust(4)
            + "".join(f"{v:10.3f}" for v in row))
    return "\n".join(lines)


def render_tail(rep):
    from paddle_tpu_torch.obs.reqtrace import PHASES

    head = (f"worst {len(rep['worst'])} of {rep['requests']} by "
            f"{rep['key']}")
    if rep["threshold"] is not None:
        head += f" (p{rep['pct']:g} >= {rep['threshold']:.3f} ms)"
    share = rep["phase_share"]
    lines = [head, render_table(rep["worst"]),
             "  phase share: " + "  ".join(
                 f"{s}={share[p]:.1%}"
                 for s, p in zip(PHASE_LABELS, PHASES)
                 if share[p] > 0)]
    return "\n".join(lines)


# -- self-test ----------------------------------------------------------------


def _check(failures, cond, msg):
    if not cond:
        failures.append(msg)


def _test_pressured_engine(failures, run_dir, device=None):
    """A REAL engine run under page pressure: journal-derived
    attribution must sum bitwise to e2e, with the preemption loss
    matching the engine's own stamp arithmetic."""
    from paddle_tpu_torch.obs import journal, reqtrace
    from paddle_tpu_torch.serving import (ManualClock, PagedKVCache,
                                    Scheduler, ServeEngine, TinyLM)
    from paddle_tpu_torch.serving.engine import preempt_loss_ms

    clock = ManualClock()
    journal.start_run(run_dir)
    try:
        cache = PagedKVCache(8, 2, 2, 8, max_seq_len=8, device=device)
        eng = ServeEngine(TinyLM(num_heads=2, head_dim=8, device=device),
                          cache,
                          scheduler=Scheduler(cache, token_budget=64,
                                              clock=clock))
        reqs = [eng.submit([1, 2], max_new_tokens=6,
                           arrival_t=clock())
                for _ in range(4)]
        for _ in range(200):
            if eng.scheduler.idle:
                break
            eng.step()
            clock.advance(0.015625)  # dyadic: float sums stay exact
        _check(failures, len(eng.finished) == 4,
               f"{len(eng.finished)}/4 requests finished")
        _check(failures, eng.scheduler.preemptions >= 1,
               "pool was sized to force >=1 preemption; got none")
    finally:
        journal.end_run()
    tls = reqtrace.assemble_run(run_dir)
    _check(failures, len(tls) == 4,
           f"assembled {len(tls)} timelines, want 4")
    preempted = 0
    for rid in sorted(tls):
        att = reqtrace.attribute(tls[rid])
        if att is None:
            failures.append(f"{rid}: finished but unattributable")
            continue
        s = reqtrace.attribution_sum(att)
        _check(failures, s == att["e2e_ms"],
               f"{rid}: phase sum {s!r} != e2e {att['e2e_ms']!r} "
               "(must be bitwise on the manual clock)")
        if att["preempt_ms"] > 0:
            preempted += 1
            req = next(r for r in reqs if r.rid == rid)
            _check(failures, att["preempt_ms"] == preempt_loss_ms(req),
                   f"{rid}: journal-derived preempt_ms "
                   f"{att['preempt_ms']!r} != engine stamps "
                   f"{preempt_loss_ms(req)!r}")
    _check(failures, preempted >= 1,
           "no request showed nonzero preemption loss under pressure")


def _test_routed_fixture(failures, run_dir, trace_path):
    """A hand-written routed run: one request rate-held 250 ms,
    dispatched to replica 0, requeued (replica death), re-dispatched
    to replica 1, preempted once mid-decode. Every phase is
    hand-computed; the timeline must span both replicas and the lane
    export must draw the cross-pid flow arrow."""
    from paddle_tpu_torch.obs import journal as J
    from paddle_tpu_torch.obs import reqtrace

    router = J.RunJournal(os.path.join(run_dir, J.ROUTER_DIR),
                          flush_every=1)
    router.start()
    router.event("req.submit", rid="fx-1", at=1.0, tenant="t0",
                 trace="tr-fx", cost=8, prompt_tokens=4)
    router.event("req.rate_hold", rid="fx-1", at=1.0, tenant="t0")
    router.event("req.dispatch", rid="fx-1", at=1.5, replica=0, seq=1,
                 rate_wait_ms=250.0, trace="tr-fx")
    router.event("req.requeue", rid="fx-1", at=2.0, replica=0,
                 reason="replica_exit")
    router.event("req.dispatch", rid="fx-1", at=2.25, replica=1, seq=2,
                 rate_wait_ms=250.0, trace="tr-fx")
    router.close()
    # replica 0: the victim incarnation — admitted, then died before
    # finishing (no terminal record, a torso the final record outranks)
    r0 = J.RunJournal(os.path.join(run_dir, J.rank_subdir(0)), rank=0,
                      flush_every=1)
    r0.start()
    r0.event("req.admit", rid="fx-1", at=1.75, resumed=False)
    r0.close()
    # replica 1: the final incarnation — admit 2.5, first token 2.75,
    # one decode preemption 3.0 -> resume 3.25, finish 4.0
    r1 = J.RunJournal(os.path.join(run_dir, J.rank_subdir(1)), rank=1,
                      flush_every=1)
    r1.start()
    r1.event("req.admit", rid="fx-1", at=2.5, resumed=False)
    r1.event("req.preempt", rid="fx-1", at=3.0, preemptions=1)
    r1.event("req.admit", rid="fx-1", at=3.25, resumed=True)
    r1.record_request(rid="fx-1", state="FINISHED", arrival_t=1.0,
                      admit_t=2.5, first_token_t=2.75, finish_t=4.0,
                      prompt_tokens=4, output_tokens=5, preemptions=1,
                      replica=1, trace="tr-fx")
    r1.close()

    tls = reqtrace.assemble_run(run_dir)
    t = tls.get("fx-1")
    if t is None:
        failures.append("fixture timeline did not assemble")
        return
    segs = t["segments"]
    _check(failures, [s["replica"] for s in segs] == [0, 1],
           f"segments must span replicas [0, 1]: {segs}")
    _check(failures,
           segs and segs[0]["start"] == 1.5 and segs[0]["end"] == 2.0
           and segs[1]["start"] == 2.25 and segs[1]["end"] == 4.0,
           f"segment bounds off the hand-written stamps: {segs}")
    att = reqtrace.attribute(t)
    if att is None:
        failures.append("fixture request unattributable")
        return
    # hand-computed (all dyadic, so EXACT float equality):
    #   ttft = (2.75 - 1.0) s = 1750 ms     e2e = 3000 ms
    #   rate    = 250  (the router's closed hold)
    #   router  = (1.5-1.0 + 2.25-2.0) s - rate = 750 - 250 = 500
    #   requeue = (2.0 - 1.5) s = 500       sched = (2.5 - 2.25) = 250
    #   prefill = 1750 - 1500 = 250  (== first_token - admit)
    #   preempt = (3.25 - 3.0) s = 250      decode = 3000-1750-250
    want = {"ttft_ms": 1750.0, "e2e_ms": 3000.0,
            "rate_limit_wait_ms": 250.0, "router_queue_ms": 500.0,
            "requeue_ms": 500.0, "sched_queue_ms": 250.0,
            "prefill_ms": 250.0, "preempt_ms": 250.0,
            "decode_ms": 1000.0}
    for k, v in sorted(want.items()):
        _check(failures, att[k] == v,
               f"fixture {k} {att[k]!r} != hand-computed {v!r}")
    _check(failures,
           reqtrace.attribution_sum(att) == att["e2e_ms"],
           "fixture phase telescope broke")
    _check(failures, att["trace"] == "tr-fx" and att["tenant"] == "t0",
           f"trace/tenant lost in assembly: {att}")

    out = reqtrace.write_request_trace(tls, trace_path)
    _check(failures, out["slices"] == 2,
           f"lane export {out['slices']} slices != 2 segments")
    with open(trace_path, encoding="utf-8") as f:
        evs = json.load(f)["traceEvents"]
    starts = [e for e in evs if e.get("ph") == "s"]
    ends = [e for e in evs if e.get("ph") == "f"]
    _check(failures, len(starts) == 1 and len(ends) == 1,
           f"want exactly one flow pair, got s={len(starts)} "
           f"f={len(ends)}")
    if starts and ends:
        _check(failures,
               starts[0]["pid"] == 0 and ends[0]["pid"] == 1
               and starts[0]["id"] == ends[0]["id"],
               f"flow arrow must cross pid 0 -> 1 with a shared id: "
               f"{starts[0]}, {ends[0]}")
    rep = reqtrace.tail_report(tls, key="e2e_ms", k=1)
    _check(failures, rep and rep["worst"][0]["rid"] == "fx-1",
           "tail report lost the fixture request")
    _check(failures,
           rep and abs(sum(rep["phase_share"].values()) - 1.0) < 1e-12,
           "phase shares must sum to 1")


def self_test(device=None):
    failures = []
    with tempfile.TemporaryDirectory() as d:
        _test_pressured_engine(failures, os.path.join(d, "engine"),
                               device)
        _test_routed_fixture(failures, os.path.join(d, "routed"),
                             os.path.join(d, "req_trace.json"))
    for line in failures:
        print(f"  FAILED — {line}")
    if failures:
        print(f"self-test FAILED: {len(failures)} check(s)")
        return 1
    print("self-test passed: a real pressured-engine run attributes "
          "every request's phases bitwise-exactly to its e2e on the "
          "manual clock (preemption loss matching the engine's own "
          "stamps), and the hand-written routed fixture reproduces "
          "every hand-computed phase to the nanosecond with the "
          "requeued timeline spanning both replicas and the exported "
          "request lanes drawing the cross-replica flow arrow")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", help="run dir (router/ + "
                    "rank_NN/ subdirs, or a single journal dir)")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--worst", type=int, default=0, metavar="K",
                    help="print only the K worst requests by --key")
    ap.add_argument("--key", default="ttft_ms",
                    choices=("ttft_ms", "e2e_ms"),
                    help="tail-ranking metric")
    ap.add_argument("--pct", type=float, default=99.0,
                    help="tail percentile when --worst is not given")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="also write the Perfetto request lanes here")
    ap.add_argument("--self-test", action="store_true",
                    help="ManualClock-exact attribution fixtures")
    ap.add_argument("--device", default=None,
                    help="the self-test engine's device (default: the "
                         "CUDA card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    if args.self_test:
        return self_test(args.device)
    if not args.path:
        ap.error("need a run dir (or --self-test)")
    from paddle_tpu_torch.obs import reqtrace

    tls = reqtrace.assemble_run(args.path)
    if args.trace_out:
        out = reqtrace.write_request_trace(tls, args.trace_out)
        print(f"request lanes: {out['slices']} slices "
              f"({out['events']} events) -> {out['path']}",
              file=sys.stderr)
    if args.worst or args.json:
        rep = reqtrace.tail_report(
            tls, key=args.key, pct=args.pct,
            k=args.worst if args.worst else None)
        if rep is None:
            print("no attributable requests", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(rep, sort_keys=True))
        else:
            print(render_tail(rep))
        return 0
    atts = reqtrace.attribute_run(tls)
    if not atts:
        print("no attributable requests", file=sys.stderr)
        return 1
    print(f"{len(atts)} attributed request(s) "
          f"({len(tls)} timelines):")
    print(render_table(atts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
