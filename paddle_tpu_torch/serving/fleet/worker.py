"""Serve-replica worker: ``python -m paddle_tpu_torch.serving.fleet.worker``.

One replica of a :class:`~.pool.ReplicaPool` in ``mode="process"``: a
``ServeEngine`` on ``--device`` (default the CUDA card) behind a
newline-JSON stdin/stdout protocol —

- **Warm start**: ``--warm`` runs every prefill/decode bucket once on
  the device (``ServeEngine.warm``) BEFORE the ``ready`` line, so a
  relaunched or scaled-up replica's first request pays no first launch.
- **Per-rank journal**: with ``PADDLE_TPU_RUN_DIR`` set (the pool sets
  it to this replica's ``rank_NN`` subdir) the worker starts the flight
  recorder; compile, request, ``backend`` and ``tenant.usage`` records
  land there for ``obs.fleet``, and a ``kernel.launches`` event at stop
  holds the kernel launch counts at ready and at stop beside the
  engine's decode steps.
- **Heartbeat**: beats from the SERVE LOOP via
  ``PADDLE_TPU_HEARTBEAT_FILE`` — a wedged engine stops the beacon and
  the pool's watchdog SIGKILLs + relaunches.
- **Live SLO export**: ``--metrics-port`` serves this replica's
  ``/metrics``; the router scrapes-and-merges every replica's endpoint
  into the fleet exposition the autoscaler reads.
- **Chaos** (``replica_kill`` injector): activated from an inherited
  ``PADDLE_TPU_CHAOS`` spec and fired from the engine's step boundary,
  so it kills this replica mid-decode deterministically.

Protocol (one JSON object per line):

parent -> worker
    ``{"op": "submit", "rid", "prompt", "max_new_tokens", "eos_id",
    "arrival_t", "trace", "tenant"}`` | ``{"op": "cancel", "rid"}`` |
    ``{"op": "drain"}``
    | ``{"op": "stats"}`` | ``{"op": "stop"}``
worker -> parent
    ``{"t": "ready", "replica", "pid", "metrics_port", "compiles",
    "warmed"}`` | ``{"t": "done", "rid", "state", "tokens", ...}`` |
    ``{"t": "rejected", "rid", "reason"}`` | ``{"t": "drained"}`` |
    ``{"t": "stats", ...}`` | ``{"t": "bye"}``

Timestamps use the WALL clock (``time.time``): the router lives in
another process, and monotonic clocks don't compare across processes.
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time

__all__ = ["main"]


def _emit(obj):
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _reader(q):
    for line in sys.stdin:
        q.put(line)
    q.put(None)   # EOF: the parent is gone — shut down


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0])
    ap.add_argument("--replica-id", type=int, required=True)
    ap.add_argument("--vocab-size", type=int, default=32)
    ap.add_argument("--num-heads", type=int, default=2)
    ap.add_argument("--head-dim", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pages", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=None)
    ap.add_argument("--token-budget", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="-1 disables the exporter, 0 = ephemeral")
    ap.add_argument("--warm", action="store_true",
                    help="run every bucket once on the device before "
                    "ready")
    ap.add_argument("--device", default=None,
                    help="the replica's device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ...obs import journal as _journal

    # the journal first, so the chaos point an inherited
    # PADDLE_TPU_CHAOS activates (at the engine's import) is journaled
    if _journal.ACTIVE is None and os.environ.get("PADDLE_TPU_RUN_DIR"):
        _journal.start_run()

    import torch

    from ... import _device
    from ...obs.export import MetricsExporter
    from ...ops import kernels as _kernels
    from ...resilience.elastic import Heartbeat
    from ..engine import ServeEngine, TinyLM
    from ..kv_cache import PagedKVCache
    from ..scheduler import CANCELLED, Scheduler

    device = _device.resolve_device(args.device)
    if device.type == "cpu":
        # CPU replicas share the host with their peers and the router:
        # one intra-op thread each, so N replicas don't oversubscribe it
        torch.set_num_threads(1)
    if _journal.ACTIVE is not None:
        # per-record flush (the elastic_run drill workers' discipline):
        # a replica_kill is os._exit — no atexit, no flush — so a
        # buffered journal would lose the kill incarnation's compile
        # and request records; and the drill reads the RELAUNCHED
        # incarnation's records while this worker is still serving
        _journal.ACTIVE.flush_every = 1

    hb = Heartbeat.from_env()
    hb.beat(0)

    model = TinyLM(vocab_size=args.vocab_size,
                   num_heads=args.num_heads, head_dim=args.head_dim,
                   seed=args.seed, device=device)
    cache = PagedKVCache(args.pages, args.page_size, args.num_heads,
                         args.head_dim, max_seq_len=args.max_seq_len,
                         device=device)
    eng = ServeEngine(
        model, cache,
        scheduler=Scheduler(cache, token_budget=args.token_budget,
                            clock=time.time),
        replica_id=args.replica_id)
    warmed = eng.warm(max_batch=args.max_batch) if args.warm else 0
    hb.beat(0)

    exporter = None
    port = None
    if args.metrics_port >= 0:
        exporter = MetricsExporter(engines=[eng],
                                   port=args.metrics_port)
        port = exporter.start()

    launches_ready = _kernels.launches()
    if _journal.ACTIVE is not None:
        _journal.ACTIVE.note_backend()
    _emit({"t": "ready", "replica": args.replica_id,
           "pid": os.getpid(), "metrics_port": port,
           "warmed": warmed, "compiles": eng._compiles})

    cmds = queue.Queue()
    threading.Thread(target=_reader, args=(cmds,), daemon=True).start()

    reqs = {}          # rid -> engine Request
    done_mark = 0
    draining = False
    drained_said = False
    stop = False
    while not stop:
        # drain every pending command first: submits must join the
        # NEXT engine step, not wait a full idle tick
        try:
            block = eng.scheduler.idle  # nothing to decode: wait
            line = cmds.get(block=block, timeout=0.05 if block
                            else None)
        except queue.Empty:
            line = False
        while line is not False:
            if line is None:
                stop = True
                break
            line = line.strip()
            if line:
                try:
                    msg = json.loads(line)
                except ValueError:
                    msg = {}
                op = msg.get("op")
                if op == "submit":
                    rid = msg.get("rid")
                    if draining:
                        _emit({"t": "rejected", "rid": rid,
                               "reason": "draining"})
                    else:
                        try:
                            reqs[rid] = eng.submit(
                                msg["prompt"],
                                max_new_tokens=msg.get(
                                    "max_new_tokens", 16),
                                rid=rid, eos_id=msg.get("eos_id"),
                                arrival_t=msg.get("arrival_t"),
                                trace=msg.get("trace"),
                                tenant=msg.get("tenant"))
                        except ValueError as e:
                            _emit({"t": "rejected", "rid": rid,
                                   "reason": str(e)})
                elif op == "cancel":
                    r = reqs.get(msg.get("rid"))
                    if r is not None:
                        eng.cancel(r)
                        if r.state == CANCELLED:
                            _emit(_done_record(r))
                            reqs.pop(r.rid, None)
                elif op == "drain":
                    draining = True
                elif op == "stats":
                    _emit({"t": "stats", **eng.stats()})
                elif op == "stop":
                    stop = True
                    break
            try:
                line = cmds.get_nowait()
            except queue.Empty:
                break
        if stop:
            break
        if not eng.scheduler.idle:
            eng.step()   # fires replica_kill chaos at its boundary
        hb.beat(eng._steps)
        # report completions in finish order
        fin = eng.finished
        while done_mark < len(fin):
            r = fin[done_mark]
            done_mark += 1
            _emit(_done_record(r))
            reqs.pop(r.rid, None)
        if draining and not drained_said and eng.scheduler.idle \
                and not reqs:
            drained_said = True
            _emit({"t": "drained", "replica": args.replica_id})
    if exporter is not None:
        exporter.stop()
    if _journal.ACTIVE is not None:
        # final per-tenant usage truth for this incarnation: the
        # device-ns telescoping and page-second closure land in the
        # rank journal, so the fleet rollup (obs.fleet.tenant_summary)
        # and the drill can assert them post-mortem. A chaos-killed
        # incarnation (os._exit) never reaches here — its stranded
        # requests' usage re-accrues on whichever replica re-serves
        # them.
        from ...obs import usage as _usage

        _journal.ACTIVE.event("tenant.usage",
                              **_usage.engine_tenant_usage(eng))
        _journal.ACTIVE.event("kernel.launches", ready=launches_ready,
                              stop=_kernels.launches(),
                              decode_steps=eng.usage.decode_steps)
    _emit({"t": "bye", "replica": args.replica_id,
           "steps": eng._steps})
    return 0


def _done_record(r):
    return {"t": "done", "rid": r.rid, "state": r.state,
            "tokens": list(r.generated), "arrival_t": r.arrival_t,
            "admit_t": r.admit_t, "first_token_t": r.first_token_t,
            "finish_t": r.finish_t, "preemptions": r.preemptions,
            "prompt_tokens": len(r.prompt)}


if __name__ == "__main__":
    sys.exit(main())
