"""Elastic-serving chaos drill: kill a replica mid-decode, lose nothing.

The fleet's acceptance drill: N=2 ``worker`` processes behind a
:class:`~.router.Router`, sharing one fleet journal root, each on
``device`` (default the CUDA card, so every replica's decode goes
through the paged decode kernel). The ``replica_kill`` injector
hard-kills replica 1 inside serve step ``KILL_STEP`` (``os._exit`` — no
flush, no goodbye: machine loss). The drill then proves, end to end:

1. **No request is lost.** Every submitted request reaches FINISHED —
   the victims requeue through the router and finish elsewhere (or on
   the relaunched replica).
2. **Token-for-token oracle identity.** Every request's output equals
   the single-engine dense oracle (``TinyLM.reference_generate``) —
   re-dispatch re-prefills the original prompt and greedy decode is
   deterministic, so a kill is invisible in the tokens.
3. **Requeue keeps arrival order.** The stranded requests re-dispatch
   in their ORIGINAL arrival order (the router-level mirror of the
   scheduler's preemption rule).
4. **The victim was relaunched.** Its rank journal holds two
   incarnations (one ``run_start`` each). The JAX drill also proves the
   relaunch AOT-warm (zero ``via=="xla"`` compiles, at least two
   ``via=="aot_disk"`` hydrations); those two checks wait for the AOT
   executable cache, which is not ported.
5. **Zero lock-order cycles**, router side and worker side.
6. **Request timelines** span both replicas for every requeued request,
   and the merged Perfetto trace carries a cross-pid flow.

The router journal records when the victim's death was detected and
each rank journal's ``backend`` event (written just before the worker's
``ready`` line) when an incarnation came up, so the result also holds
the time from the kill's detection to the relaunched replica's ready
(``relaunch_ready_s``).

The default run (the tiny spec, on ``device``) is cached once per
process (``drill_result``), so a test suite pays for ONE drill.
``run_drill(geometry=..., trace=...)`` runs it at another width, as the
chip smoke does at gpt_small's.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

__all__ = ["run_drill", "drill_result", "KILL_STEP", "GEOMETRY"]

KILL_STEP = 4      # serve step the victim dies in (mid-decode)
VICTIM = 1
N_REQUESTS = 6     # split ~3/3; max_new=5 means nothing finishes
MAX_NEW = 5        # before the step-4 kill — every strand is mid-decode
# the drill's replica spec: the JAX drill's, with its warm bound 4 — the
# requeue routes the ≤3 stranded requests to one replica, so no decode
# batch exceeds 4 lanes anywhere and warming past that would only slow
# every incarnation's start
GEOMETRY = dict(vocab_size=32, num_heads=2, head_dim=8, seed=0,
                pages=16, page_size=4, max_seq_len=16, token_budget=64,
                max_batch=4)

_RESULT = {}


def _requests(vocab, n=N_REQUESTS, seed=7):
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        plen = int(rng.randint(4, 7))
        out.append(([int(x) for x in rng.randint(0, vocab, plen)],
                    MAX_NEW))
    return out


def _segments(rank_dir):
    """A rank journal's records split into incarnations (relaunches
    append to the same file; segments split on ``run_start``; the
    records before the first header are dropped)."""
    path = os.path.join(rank_dir, "journal.jsonl")
    segments = [[]]
    with open(path, encoding="utf-8") as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail from the os._exit kill
            if rec.get("t") == "run_start":
                segments.append([])
            segments[-1].append(rec)
    return segments[1:]


def _events(records, kind):
    return [r for r in records
            if r.get("t") == "event" and r.get("kind") == kind]


def _scan_lockdep_cycles(run_dir):
    """Every ``lockdep.cycle`` event journaled under ``run_dir`` (any
    rank / the router journal) — the worker-side PTC004 witness."""
    cycles = []
    for dirpath, _dirnames, filenames in os.walk(run_dir):
        for fn in filenames:
            if not fn.endswith(".jsonl"):
                continue
            with open(os.path.join(dirpath, fn),
                      encoding="utf-8") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail from the kill
                    if rec.get("t") == "event" and \
                            rec.get("kind") == "lockdep.cycle":
                        cycles.append(rec.get("cycle"))
    return cycles


def run_drill(root=None, keep=False, device=None, geometry=None,
              trace=None):
    """Run the 2-replica kill drill; returns the result dict (with a
    ``failures`` list — empty on success). ``device`` is every
    replica's (and the oracle's); ``geometry`` overrides ``GEOMETRY``;
    ``trace`` is a list of ``(prompt, max_new_tokens)`` (default: six
    short prompts of ``MAX_NEW`` tokens each)."""
    from ..engine import TinyLM
    from ...obs import journal as _journal
    from .pool import ReplicaPool, ReplicaSpec
    from .router import Router

    from ...obs import lockdep as _lockdep

    failures = []
    own_root = root is None
    root = root or tempfile.mkdtemp(prefix="pt_fleet_drill_")
    run_dir = os.path.join(root, "run")
    geo = dict(GEOMETRY, **(geometry or {}))
    spec = ReplicaSpec(
        **geo, warm=True, device=device,
        run_dir=run_dir, metrics_port=0,
        env={"PADDLE_TPU_TRACE": "",
             "PADDLE_TPU_CHAOS": "",
             # every worker runs the lockdep runtime in raise mode: a
             # lock-order cycle anywhere in the serve loop crashes the
             # replica, strands its requests, and fails the drill —
             # the acceptance gate for the PTC004 class
             "PADDLE_TPU_LOCKDEP": "1"},
        env_for_replica=lambda rid, attempt: (
            {"PADDLE_TPU_CHAOS":
             f"replica_kill:at={KILL_STEP},rank={VICTIM}"}
            if rid == VICTIM and attempt == 0 else {}),
        hang_timeout_s=120.0, startup_timeout_s=300.0)

    model = TinyLM(vocab_size=spec.vocab_size, num_heads=spec.num_heads,
                   head_dim=spec.head_dim, seed=spec.seed, device=device)
    trace = trace if trace is not None else _requests(spec.vocab_size)
    oracle = [model.reference_generate(p, m) for p, m in trace]
    del model   # the oracle's weights need not stay beside the replicas'

    from ...resilience.elastic import ReplicaSupervisor

    # lockdep on the PARENT side too (scoped): the router journal's and
    # each ProcessReplica's locks are constructed below, so they come
    # out instrumented; the router thread's consume path and the reader
    # threads' produce path both feed the order graph. Raise mode — a
    # cycle aborts the drill into `failures`.
    prev_lockdep = _lockdep.mode()
    _lockdep.enable(_lockdep.MODE_RAISE)
    lockdep_before = len(_lockdep.violations())

    prev_active = _journal.ACTIVE
    router_journal = _journal.RunJournal(
        os.path.join(run_dir, _journal.ROUTER_DIR), rank=None,
        flush_every=1)
    router_journal.start()
    _journal.ACTIVE = router_journal
    pool = None
    router = None
    try:
        pool = ReplicaPool(
            spec, replicas=2, mode="process",
            supervisor=ReplicaSupervisor(max_restarts=2,
                                         backoff_s=0.05, jitter=0.0))
        from .router import TenantPolicy

        # every submission rides tenant "drill": the chargeback plane
        # (obs.usage) gets exercised under replica loss, and the gauge
        # check below proves the scraped tenant_* series equal router
        # truth bitwise on this live 2-replica run
        router = Router(pool,
                        tenants={"drill": TenantPolicy(weight=1.0)})
        t0 = time.time()
        reqs = [router.submit(p, max_new_tokens=m,
                              arrival_t=t0 + i * 1e-3,
                              tenant="drill")
                for i, (p, m) in enumerate(trace)]
        router.run_until_drained(timeout_s=300.0, sleep_s=0.02)
        # the victim's relaunch is deferred behind its supervisor
        # backoff (never slept on the router thread): the survivor can
        # finish every stranded request before the spawn fires, so
        # drive the health sweep until it does and the relaunched
        # incarnation is READY — the journal assertions below read its
        # records, and a stop sent mid-warm could outlast the pool's
        # grace and kill it before it journals anything
        spawn_deadline = time.time() + spec.startup_timeout_s
        while (pool._pending or any(r.state == "STARTING"
                                    for r in pool.replicas)) \
                and time.time() < spawn_deadline:
            router.check_replicas()
            time.sleep(0.01)
        stats = router.stats()
        dispatch_trace = list(router.trace)
        # tenant chargeback gauges, live: scrape the router's
        # tenant_* exposition and parse it back — every series must
        # equal the obs.usage rollup BITWISE (repr round-trip), on a
        # fleet that just survived a replica kill with requeues
        from ...obs import export as _export
        from ...obs import usage as _usage

        tenant_usage = _usage.router_tenant_usage(router)
        scraped = _export.parse_prometheus_text(
            "\n".join(_export.tenant_lines(router=router)))
        for tenant, d in tenant_usage["tenants"].items():
            for key in ("weight_share", "served_tokens", "share",
                        "requests", "completed", "requeued",
                        "preemptions", "prompt_tokens",
                        "decode_tokens"):
                skey = (f'paddle_tpu_tenant_{key}'
                        f'{{tenant="{tenant}"}}')
                if scraped.get(skey) != float(d.get(key, 0)):
                    failures.append(
                        f"tenant gauge {skey}={scraped.get(skey)} != "
                        f"router truth {d.get(key, 0)} (bitwise gate)")
        if not tenant_usage["served_total"]:
            failures.append(
                "tenant metering saw zero served tokens — the drill's "
                "tenant='drill' stamps went missing")
        # graceful stop BEFORE the journal assertions: the live
        # workers' buffered tails flush on their way out
        router.close()
        router = None

        # 1. nothing lost
        for r in reqs:
            if r.state != "FINISHED":
                failures.append(f"{r.rid} ended {r.state}, not FINISHED")
        # 2. oracle identity
        for r, ref in zip(reqs, oracle):
            if r.tokens != ref:
                failures.append(
                    f"{r.rid} tokens {r.tokens} != oracle {ref} "
                    f"(requeues={r.requeues})")
        # the kill actually stranded someone (else the drill is vacuous)
        requeued = [r for r in reqs if r.requeues]
        if stats["requeued"] < 1 or not requeued:
            failures.append(
                f"kill at step {KILL_STEP} stranded no request "
                f"(requeued={stats['requeued']}) — drill vacuous")
        # 3. requeued re-dispatches follow original arrival order
        requeued_rids = {r.rid for r in requeued}
        redis = [e["rid"] for e in dispatch_trace
                 if e["rid"] in requeued_rids][len(requeued_rids):]
        arrival_order = [r.rid for r in
                         sorted(requeued, key=lambda r: r.arrival_t)]
        if redis != arrival_order:
            failures.append(
                f"requeued dispatch order {redis} != arrival order "
                f"{arrival_order}")
        # 4. the victim was relaunched (the JAX drill's two AOT checks
        # on the relaunch's compile events wait for the AOT cache)
        segments = _segments(os.path.join(
            run_dir, _journal.rank_subdir(VICTIM)))
        incarnations = len(segments)
        if incarnations < 2:
            failures.append(
                f"victim journal shows {incarnations} "
                "incarnation(s) — was it relaunched at all?")
        relaunch_ready_s = None
        dead = _events([r for seg in _segments(os.path.join(
            run_dir, _journal.ROUTER_DIR)) for r in seg],
            "fleet.replica_dead")
        up = _events(segments[-1], "backend") if segments else []
        if dead and up and incarnations >= 2:
            relaunch_ready_s = up[0]["ts"] - dead[0]["ts"]
        backends = {}
        for rank in (0, VICTIM):
            for seg in _segments(os.path.join(
                    run_dir, _journal.rank_subdir(rank))):
                backends.setdefault(rank, []).extend(
                    _events(seg, "backend"))
        # 5. zero lock-order cycles, parent AND workers: parent-side
        # from the live graph, worker-side from journaled
        # lockdep.cycle events (a worker in raise mode also crashes,
        # which assertions 1-2 already catch — this names the cause)
        parent_cycles = _lockdep.violations()[lockdep_before:]
        worker_cycles = _scan_lockdep_cycles(run_dir)
        if parent_cycles:
            failures.append(
                f"lockdep: {len(parent_cycles)} PTC004 cycle(s) on "
                f"the router side: "
                f"{[v['cycle'] for v in parent_cycles]}")
        if worker_cycles:
            failures.append(
                f"lockdep: {len(worker_cycles)} PTC004 cycle(s) "
                f"journaled by workers: {worker_cycles}")
        # 6. request timelines (obs.reqtrace): every requeued request's
        # assembled timeline spans BOTH replica incarnations — the
        # victim's dispatch segment AND the re-dispatched one's — and
        # the merged Perfetto export carries the cross-pid flow arrow.
        # Workers run with span tracing OFF, so the request lanes are
        # journal-derived by construction (zero trace-file sources).
        from ...obs import fleet as obs_fleet
        from ...obs import reqtrace as _reqtrace

        timelines = _reqtrace.assemble_run(run_dir)
        attribution = {a["rid"]: a
                       for a in _reqtrace.attribute_run(timelines)}
        for rid in sorted(requeued_rids):
            segs = (timelines.get(rid) or {}).get("segments") or []
            seg_reps = {s["replica"] for s in segs}
            if len(segs) < 2 or len(seg_reps) < 2:
                failures.append(
                    f"reqtrace: {rid} requeued but its timeline has "
                    f"{len(segs)} segment(s) on replicas "
                    f"{sorted(seg_reps)} — expected the victim's AND "
                    "the re-dispatched replica's")
            att = attribution.get(rid)
            if att is None or not att["requeue_ms"] > 0:
                failures.append(
                    f"reqtrace: {rid} requeued but its attribution "
                    f"shows no requeue loss: {att}")
        merged = obs_fleet.merge_chrome_traces(
            run_dir, os.path.join(root, "merged_trace.json"))
        with open(merged["path"], encoding="utf-8") as f:
            merged_events = json.load(f).get("traceEvents") or []
        flow_pairs = {}
        for ev in merged_events:
            if ev.get("ph") in ("s", "f"):
                flow_pairs.setdefault(ev.get("id"), {})[ev["ph"]] = ev
        cross_flows = [fl for fl in flow_pairs.values()
                       if "s" in fl and "f" in fl
                       and fl["s"].get("pid") != fl["f"].get("pid")]
        cross_flow_rids = sorted(
            {(fl["s"].get("args") or {}).get("rid")
             for fl in cross_flows})
        if requeued_rids and not cross_flows:
            failures.append(
                "reqtrace: merged trace carries no cross-pid flow "
                "event — a requeued request should visibly cross "
                "from the victim's lane to the re-dispatched one's")
        result = {
            "failures": failures, "run_dir": run_dir, "root": root,
            "stats": stats, "trace": dispatch_trace,
            "requeued_rids": sorted(requeued_rids),
            "incarnations": incarnations,
            "relaunch_ready_s": relaunch_ready_s,
            "backends": backends,
            "kernel_launches": {
                rank: [e for seg in _segments(os.path.join(
                    run_dir, _journal.rank_subdir(rank)))
                    for e in _events(seg, "kernel.launches")]
                for rank in (0, VICTIM)},
            "oracle": oracle,
            "requests": [{"rid": r.rid, "state": r.state,
                          "tokens": r.tokens, "requeues": r.requeues,
                          "arrival_t": r.arrival_t,
                          "admit_t": r.admit_t} for r in reqs],
            "lockdep": {"mode": "raise",
                        "parent_cycles": parent_cycles,
                        "worker_cycles": worker_cycles},
            "request_timelines": {rid: tl["segments"]
                                  for rid, tl in timelines.items()},
            "request_attribution": attribution,
            "merged_trace": merged,
            "cross_flow_rids": cross_flow_rids,
            "tenant_usage": tenant_usage,
        }
    except Exception as e:  # a harness crash is a drill failure too
        failures.append(f"drill harness raised {type(e).__name__}: {e}")
        result = {"failures": failures, "run_dir": run_dir,
                  "root": root, "stats": None, "trace": [],
                  "requeued_rids": [], "incarnations": 0,
                  "relaunch_ready_s": None, "backends": {},
                  "kernel_launches": {}, "oracle": oracle,
                  "requests": [],
                  "lockdep": {"mode": "raise",
                              "parent_cycles":
                              _lockdep.violations()[lockdep_before:],
                              "worker_cycles": []},
                  "request_timelines": {}, "request_attribution": {},
                  "merged_trace": None, "cross_flow_rids": [],
                  "tenant_usage": None}
    finally:
        if prev_lockdep is not None:
            _lockdep.enable(prev_lockdep)
        else:
            _lockdep.disable()
        try:
            if router is not None:
                router.close()
            elif pool is not None:
                pool.shutdown()
        except Exception:
            pass
        try:
            router_journal.close()
        except Exception:
            pass
        if _journal.ACTIVE is None and prev_active is not None \
                and not prev_active.closed:
            _journal.ACTIVE = prev_active
    if own_root and not keep and not failures:
        import atexit
        import shutil

        # keep a FAILED drill's artifacts for the postmortem; clean
        # successful ones at exit (a caller may still read the journals
        # until then)
        atexit.register(shutil.rmtree, root, ignore_errors=True)
    return result


def drill_result(refresh=False, device=None):
    """The process-cached default drill on ``device`` — every reader in
    a process shares ONE execution per device."""
    key = str(device)
    if key not in _RESULT or refresh:
        _RESULT[key] = run_drill(device=device)
    return _RESULT[key]
