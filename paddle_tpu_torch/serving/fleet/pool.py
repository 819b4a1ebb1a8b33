"""ReplicaPool: launch, watch, drain, and relaunch serve replicas.

The fleet data plane under the :class:`~.router.Router`. One
:class:`ReplicaSpec` describes a replica (model, KV pool, token
budget, device, journal root); the pool materializes N of them in one
of two modes:

- ``mode="local"`` — in-process :class:`~..engine.ServeEngine`s on a
  shared (injectable) clock: the deterministic substrate for dispatch-
  trace tests.
- ``mode="process"`` — one ``serving.fleet.worker`` subprocess per
  replica, speaking newline-JSON over stdin/stdout, heartbeating
  (``PADDLE_TPU_HEARTBEAT_FILE``), journaling per-rank under
  ``<run_dir>/rank_NN``, exporting its own ``/metrics`` endpoint, and
  running every prefill/decode bucket once on its device before it
  reports ready (``ServeEngine.warm``). Each worker on the card is its
  own CUDA context; its engine's decode goes through the paged decode
  kernel.

Every replica runs on ``spec.device`` — ``None`` is the CUDA card, as
for every entry point of the package; ``"cpu"`` only when asked for.
The JAX package's shared AOT executable cache (``aot_cache_dir``) has
no counterpart here yet: a spec that names one raises.

Replica health rides the heartbeat/watchdog pattern: a dead process is
reaped, a wedged one (stale heartbeat) is SIGKILLed, and either way
the pool hands the router the casualty's in-flight requests to requeue
and relaunches the replica under the
:class:`~...resilience.elastic.ReplicaSupervisor`'s per-replica
restart budget + seeded backoff. Scale-down goes through ``drain()``:
the replica stops accepting, finishes its in-flight decodes, and only
then retires — never killed mid-decode.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ...obs import journal as _journal
from ...obs import lockdep as _lockdep
from ...resilience.elastic import HEARTBEAT_ENV, ATTEMPT_ENV, \
    ReplicaSupervisor

__all__ = ["ReplicaSpec", "LocalReplica", "ProcessReplica",
           "ReplicaPool",
           "STARTING", "READY", "DRAINING", "DEAD", "RETIRED"]

STARTING, READY, DRAINING, DEAD, RETIRED = (
    "STARTING", "READY", "DRAINING", "DEAD", "RETIRED")


def _journal_event(kind, **fields):
    if _journal.ACTIVE is not None:
        _journal.ACTIVE.event(kind, **fields)


@dataclass
class ReplicaSpec:
    """Everything needed to build one replica (and rebuild it warm)."""

    vocab_size: int = 32
    num_heads: int = 2
    head_dim: int = 8
    seed: int = 0
    pages: int = 64
    page_size: int = 8
    max_seq_len: int = None
    token_budget: int = 256
    max_batch: int = 8          # warm() bound = deepest decode bucket
    warm: bool = True
    aot_cache_dir: str = None   # not supported yet: must stay None
    device: str = None          # None = the CUDA card; "cpu" if asked
    run_dir: str = None         # fleet journal root (rank_NN per replica)
    metrics_port: int = None    # None = no exporter; 0 = ephemeral
    env: dict = field(default_factory=dict)
    env_for_replica: object = None   # (replica_id, attempt) -> dict
    hang_timeout_s: float = 60.0
    startup_timeout_s: float = 180.0

    def __post_init__(self):
        if self.aot_cache_dir is not None:
            raise NotImplementedError(
                "ReplicaSpec.aot_cache_dir: the shared AOT executable "
                "cache (runtime.aot) is not ported yet; leave it None")

    @property
    def effective_max_seq_len(self):
        cap = (int(self.pages) - 1) * int(self.page_size)
        return min(int(self.max_seq_len), cap) if self.max_seq_len \
            else cap

    def build_engine(self, replica_id, clock=None):
        """One in-process replica: model + paged pool + scheduler +
        engine, all from this spec (the worker process runs the same
        construction — one recipe, two substrates)."""
        from ..engine import ServeEngine, TinyLM
        from ..kv_cache import PagedKVCache
        from ..scheduler import Scheduler

        model = TinyLM(vocab_size=self.vocab_size,
                       num_heads=self.num_heads,
                       head_dim=self.head_dim, seed=self.seed,
                       device=self.device)
        cache = PagedKVCache(self.pages, self.page_size, self.num_heads,
                             self.head_dim,
                             max_seq_len=self.effective_max_seq_len,
                             device=self.device)
        sched = Scheduler(cache, token_budget=self.token_budget,
                          clock=clock if clock is not None
                          else time.monotonic)
        return ServeEngine(model, cache, scheduler=sched,
                           replica_id=replica_id)

    def worker_argv(self, replica_id):
        return [
            sys.executable, "-m", "paddle_tpu_torch.serving.fleet.worker",
            "--replica-id", str(replica_id),
            "--vocab-size", str(self.vocab_size),
            "--num-heads", str(self.num_heads),
            "--head-dim", str(self.head_dim),
            "--seed", str(self.seed),
            "--pages", str(self.pages),
            "--page-size", str(self.page_size),
            "--max-seq-len", str(self.effective_max_seq_len),
            "--token-budget", str(self.token_budget),
            "--max-batch", str(self.max_batch),
            "--metrics-port", str(-1 if self.metrics_port is None
                                  else self.metrics_port),
        ] + (["--warm"] if self.warm else []) + \
            (["--device", str(self.device)] if self.device is not None
             else [])


class _BaseReplica:
    """The router-side replica handle: a submit/poll surface plus the
    outstanding-token ledger the dispatch decision reads."""

    def __init__(self, replica_id, attempt=0):
        self.replica_id = int(replica_id)
        self.attempt = int(attempt)
        self.state = STARTING
        self.last_failure = None      # "exit" | "hung" once DEAD
        self._ledger = {}             # rid -> FleetRequest in flight

    @property
    def accepting(self):
        return self.state == READY

    @property
    def draining(self):
        return self.state == DRAINING

    @property
    def outstanding_tokens(self):
        return sum(r.cost for r in self._ledger.values())

    @property
    def inflight_count(self):
        return len(self._ledger)

    def take_inflight(self):
        """Strand-recovery: the requests this replica still owed, in
        arrival order; the ledger empties (they belong to the router's
        requeue now)."""
        out = sorted(self._ledger.values(),
                     key=lambda r: (r.arrival_t, r.rid))
        self._ledger.clear()
        return out

    def drain(self):
        if self.state == READY:
            self.state = DRAINING

    # subclass surface -------------------------------------------------------
    def submit(self, req):  # pragma: no cover - abstract
        raise NotImplementedError

    def poll(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def health(self, now):
        """None when healthy, else the failure kind ("exit"/"hung")."""
        return None

    def kill(self):
        self.state = DEAD
        self.last_failure = "exit"

    def close(self):
        if self.state not in (DEAD,):
            self.state = RETIRED


class LocalReplica(_BaseReplica):
    """In-process replica: a ServeEngine stepped by ``pool.pump()``."""

    def __init__(self, spec, replica_id, clock=None, attempt=0):
        super().__init__(replica_id, attempt)
        self.spec = spec
        # in-process replicas warm only from an AOT cache in the JAX
        # package; without one there is nothing to warm here either
        self.engine = spec.build_engine(replica_id, clock=clock)
        self._done_mark = 0
        self._crashed = False
        self.state = READY

    def submit(self, req):
        try:
            self.engine.submit(req.prompt,
                               max_new_tokens=req.max_new_tokens,
                               rid=req.rid, eos_id=req.eos_id,
                               arrival_t=req.arrival_t,
                               trace=req.trace_id, tenant=req.tenant)
        except ValueError:
            # the router pre-validates with the same rules, so this is
            # a spec drift bug — surface it, don't strand the request
            raise
        self._ledger[req.rid] = req

    def pump(self, steps=1):
        if self._crashed or self.state in (DEAD, RETIRED):
            return 0
        n = 0
        for _ in range(steps):
            if self.engine.scheduler.idle:
                break
            if not self.engine.step():
                break
            n += 1
        return n

    def poll(self):
        out = []
        fin = self.engine.finished
        while self._done_mark < len(fin):
            r = fin[self._done_mark]
            self._done_mark += 1
            if r.rid not in self._ledger:
                continue
            self._ledger.pop(r.rid, None)
            out.append({
                "rid": r.rid, "state": r.state,
                "tokens": list(r.generated),
                "arrival_t": r.arrival_t, "admit_t": r.admit_t,
                "first_token_t": r.first_token_t,
                "finish_t": r.finish_t,
                "preemptions": r.preemptions,
            })
        return out

    def kill(self):
        """Simulated machine loss (tests): the engine stops serving
        but — like a real dead machine — the pool only notices at the
        next health sweep, which requeues the stranded ledger."""
        self._crashed = True

    def close(self):
        # mirror the process-mode worker's before-bye emission so a
        # local-mode run dir bills the same way: final per-tenant
        # engine truth into the shared journal. A killed local
        # replica skips it — machine loss loses its meter, as billed.
        if not self._crashed and self.state not in (DEAD,) \
                and _journal.ACTIVE is not None:
            from ...obs import usage as _usage

            _journal_event("tenant.usage",
                           **_usage.engine_tenant_usage(self.engine))
        super().close()

    def health(self, now=None):
        return "exit" if self._crashed else None


class ProcessReplica(_BaseReplica):
    """One ``serving.fleet.worker`` subprocess, newline-JSON protocol:

    parent -> worker: ``{"op": "submit"|"cancel"|"drain"|"stats"|"stop",
    ...}``; worker -> parent: ``{"t": "ready"|"done"|"rejected"|
    "drained"|"stats", ...}``. A reader thread drains stdout so the
    worker never blocks on a full pipe; ``poll()`` consumes the
    buffered events on the router thread."""

    def __init__(self, spec, replica_id, hb_path, env, attempt=0):
        super().__init__(replica_id, attempt)
        self.spec = spec
        self.hb_path = hb_path
        self.metrics_url = None
        self.pid = None
        self.spawned_at = time.monotonic()
        self._events = deque()
        # guards _events between the reader thread (producer) and the
        # router thread (consumer). Leaf of the fleet control-plane
        # order router -> pool -> replica: the reader thread holds it
        # only around deque ops, never while journaling or touching
        # the pool.
        self._lock = _lockdep.lock("fleet.replica_events")
        self._drained = False
        try:  # a stale beacon from the previous incarnation must not
            os.remove(hb_path)  # read as liveness
        except OSError:
            pass
        self.proc = subprocess.Popen(
            spec.worker_argv(replica_id), env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            bufsize=1)
        self.pid = self.proc.pid
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"pt-replica-{replica_id}",
                                        daemon=True)
        self._reader.start()

    def _read_loop(self):
        try:
            for line in self.proc.stdout:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue  # stray print from a library
                with self._lock:
                    self._events.append(ev)
        except Exception:
            pass

    def _mark_ready(self, ev):
        port = ev.get("metrics_port")
        if port:
            self.metrics_url = f"http://127.0.0.1:{port}/metrics"
        if self.state == STARTING:
            self.state = READY

    def scan_ready(self):
        """Non-blocking readiness check: consume the worker's buffered
        ``ready`` event if it arrived, promoting STARTING -> READY.
        Returns the event, or None. (The pool's health sweep calls this
        so a background-warming relaunch joins service on its own
        schedule — the router thread never blocks on a warm.)"""
        with self._lock:
            for ev in list(self._events):
                if ev.get("t") == "ready":
                    self._events.remove(ev)
                    self._mark_ready(ev)
                    return ev
        return None

    def wait_ready(self, timeout_s=None):
        """Block until the worker's ``ready`` line (post-warm, exporter
        bound). Raises on worker death or timeout."""
        timeout_s = self.spec.startup_timeout_s if timeout_s is None \
            else timeout_s
        deadline = time.monotonic() + float(timeout_s)
        while True:
            ev = self.scan_ready()
            if ev is not None:
                return ev
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"replica {self.replica_id} died before ready "
                    f"(exit {self.proc.returncode})")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replica {self.replica_id} not ready in "
                    f"{timeout_s}s")
            time.sleep(0.02)

    def _send(self, msg):
        try:
            self.proc.stdin.write(json.dumps(msg) + "\n")
            self.proc.stdin.flush()
            return True
        except (OSError, ValueError):
            return False  # dead pipe: the health sweep reaps it

    def submit(self, req):
        self._ledger[req.rid] = req
        self._send({"op": "submit", "rid": req.rid,
                    "prompt": req.prompt,
                    "max_new_tokens": req.max_new_tokens,
                    "eos_id": req.eos_id,
                    "arrival_t": req.arrival_t,
                    "trace": req.trace_id,
                    "tenant": req.tenant})

    def drain(self):
        super().drain()
        self._send({"op": "drain"})

    def poll(self):
        out = []
        with self._lock:
            evs, self._events = list(self._events), deque()
        for ev in evs:
            t = ev.get("t")
            if t == "ready":
                # a background relaunch's ready line can land between
                # the health sweep's scan_ready and this poll; it must
                # promote here too, not vanish with the batch — dropped,
                # the replica would sit STARTING forever (fresh
                # heartbeat, so never flagged unhealthy either)
                self._mark_ready(ev)
            elif t == "done":
                if ev.get("rid") in self._ledger:
                    self._ledger.pop(ev["rid"], None)
                    out.append(ev)
            elif t == "rejected":
                self._ledger.pop(ev.get("rid"), None)
            elif t == "drained":
                self._drained = True
            # anything else ("stats"/"bye") has no parent-side reader:
            # poll() is the stream's terminal consumer and drops it
        return out

    def health(self, now=None):
        if self.state not in (READY, DRAINING, STARTING):
            return None
        rc = self.proc.poll()
        if rc is not None:
            # a drain-complete worker exiting 0 is a clean retirement,
            # not a failure
            if self._drained and rc == 0 and not self._ledger:
                return None
            return "exit"
        if self.state == STARTING:
            # the worker beats once at boot and then warms WITHOUT
            # beating (serve-loop beats start post-ready), so heartbeat
            # age says nothing here: the whole STARTING window gets the
            # startup grace, not the steady-state hang timeout — else a
            # slow warm is SIGKILLed mid-hydration and relaunched in a
            # loop until the supervisor budget burns out
            if time.monotonic() - self.spawned_at > \
                    self.spec.startup_timeout_s:
                return "hung"
            return None
        try:
            age = time.time() - os.path.getmtime(self.hb_path)
        except OSError:
            if time.monotonic() - self.spawned_at > \
                    self.spec.startup_timeout_s:
                return "hung"
            return None
        if age > self.spec.hang_timeout_s:
            return "hung"
        return None

    def kill(self):
        try:
            self.proc.kill()
            self.proc.wait(timeout=10)
        except OSError:
            pass
        super().kill()

    def stop(self, timeout_s=15.0):
        """Graceful stop: the worker flushes its journal and exits."""
        if self.proc.poll() is None:
            self._send({"op": "stop"})
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.close()

    def close(self):
        super().close()
        for f in (self.proc.stdin, self.proc.stdout):
            try:
                f.close()
            except Exception:
                pass


class ReplicaPool:
    """N replicas of one :class:`ReplicaSpec` plus their lifecycle."""

    def __init__(self, spec, replicas=1, mode="local", clock=None,
                 supervisor=None, max_replicas=None):
        if mode not in ("local", "process"):
            raise ValueError(f"mode must be local|process, got {mode!r}")
        self.spec = spec
        self.mode = mode
        self.clock = clock
        # process replicas timestamp on the WALL clock (worker and
        # router are different processes; monotonic clocks don't
        # compare across them), local ones on whatever the tests inject
        self.default_clock = (clock if clock is not None else
                              (time.time if mode == "process"
                               else time.monotonic))
        self.supervisor = supervisor or ReplicaSupervisor()
        self.max_replicas = max_replicas
        self.replicas = []        # live (READY/DRAINING/STARTING)
        self.retired = []
        # replica_id -> {"attempt", "not_before"}: relaunches waiting
        # out their supervisor backoff (spawned by the health sweep)
        self._pending = {}
        self._next_id = 0
        self._hb_dir = None
        if mode == "process":
            self._hb_dir = tempfile.mkdtemp(prefix="pt_fleet_hb_")
        for _ in range(int(replicas)):
            self.scale_up()

    # -- spawning ------------------------------------------------------------
    def _worker_env(self, replica_id, attempt):
        env = dict(os.environ)
        env.update(self.spec.env or {})
        if attempt > 0:
            # inherited chaos is an attempt-0 drill config: a relaunch
            # that re-fired the same kill would never heal (the
            # at_step-keyed gang injectors solve this with global
            # steps; serve steps restart at 0 every incarnation)
            env["PADDLE_TPU_CHAOS"] = ""
        if self.spec.run_dir:
            env["PADDLE_TPU_RUN_DIR"] = os.path.join(
                self.spec.run_dir, _journal.rank_subdir(replica_id))
            env[_journal.RANK_ENV] = str(replica_id)
        env[HEARTBEAT_ENV] = self._hb_path(replica_id)
        env[ATTEMPT_ENV] = str(attempt)
        # the worker imports paddle_tpu_torch from THIS checkout
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        if self.spec.env_for_replica is not None:
            env.update(self.spec.env_for_replica(replica_id, attempt)
                       or {})
        return env

    def _hb_path(self, replica_id):
        return os.path.join(self._hb_dir or tempfile.gettempdir(),
                            f"hb_replica_{replica_id}.json")

    def _spawn(self, replica_id, attempt, wait=True):
        if self.mode == "local":
            rep = LocalReplica(self.spec, replica_id, clock=self.clock,
                               attempt=attempt)
        else:
            rep = ProcessReplica(self.spec, replica_id,
                                 self._hb_path(replica_id),
                                 self._worker_env(replica_id, attempt),
                                 attempt=attempt)
            if wait:
                rep.wait_ready()
        _journal_event("fleet.replica_spawn", replica=replica_id,
                       attempt=attempt, mode=self.mode,
                       pid=getattr(rep, "pid", None))
        return rep

    def headroom(self):
        """Remaining replica slots under ``max_replicas`` (None =
        unbounded). Live replicas in any non-terminal state — STARTING
        and DRAINING still hold host capacity — AND backoff-pending
        relaunches count: a pending relaunch WILL respawn
        unconditionally, so ignoring it would let a scale-up overshoot
        the cap."""
        if self.max_replicas is None:
            return None
        live = sum(1 for r in self.replicas
                   if r.state not in (DEAD, RETIRED))
        return max(0, self.max_replicas - live - len(self._pending))

    def at_capacity(self):
        return self.headroom() == 0

    def scale_up(self, wait=True):
        """Launch one more replica. ``wait=False`` returns a STARTING
        process replica that warms in the background (the health
        sweep promotes it) — the autoscaler's mode, so an "up" never
        stalls the dispatch loop for a whole boot+warm."""
        if self.at_capacity():
            raise RuntimeError(
                f"pool already at max_replicas={self.max_replicas}")
        rep = self._spawn(self._next_id, attempt=0, wait=wait)
        self._next_id += 1
        self.replicas.append(rep)
        return rep

    def relaunch(self, rep):
        """Replace a DEAD replica (supervisor budget + backoff first —
        raises ``ElasticBudgetError`` when a replica flaps past its
        budget). The new incarnation keeps the replica id, so journals
        and SLO labels read as one replica's history. Nothing here
        blocks the router thread: the backoff is NOT slept (the pool
        records a not-before time on its clock and a later health
        sweep does the spawn), and process-mode spawns return a
        STARTING replica that warms in the BACKGROUND, promoted to
        READY when its ``ready`` line lands — a relaunch blocking the
        dispatch loop for a backoff or a warm would stall the healthy
        fleet, exactly what replica isolation exists to prevent.
        Returns the fresh replica, or None when the spawn is deferred
        behind its backoff."""
        kind = "hang" if rep.last_failure == "hung" else "crash"
        delay = self.supervisor.note_failure(rep.replica_id, kind=kind,
                                             defer=True)
        if delay > 0:
            self.replicas = [r for r in self.replicas if r is not rep]
            self._pending[rep.replica_id] = {
                "attempt": rep.attempt + 1,
                "not_before": self.default_clock() + delay}
            return None
        fresh = self._spawn(rep.replica_id, attempt=rep.attempt + 1,
                            wait=False)
        self.replicas = [fresh if r is rep else r
                         for r in self.replicas]
        return fresh

    def _spawn_pending(self, now):
        """Launch every backoff-deferred relaunch whose not-before time
        has passed (pool clock)."""
        for rid in sorted(self._pending):
            p = self._pending[rid]
            if now >= p["not_before"]:
                del self._pending[rid]
                fresh = self._spawn(rid, attempt=p["attempt"],
                                    wait=False)
                self.replicas.append(fresh)

    # -- health --------------------------------------------------------------
    def check_health(self, now=None):
        """Sweep for newly failed replicas: reap exits, SIGKILL stale-
        heartbeat hangs. Marks them DEAD and returns
        ``[(replica, reason)]`` — the router requeues their in-flight
        requests before asking for a relaunch. Also launches relaunches
        whose supervisor backoff just expired."""
        self._spawn_pending(self.default_clock() if now is None
                            else now)
        out = []
        for rep in list(self.replicas):
            if rep.state == STARTING and \
                    isinstance(rep, ProcessReplica):
                rep.scan_ready()   # background warm done -> READY
            if rep.state not in (READY, DRAINING, STARTING):
                continue
            reason = rep.health(now)
            if reason is None:
                continue
            if reason == "hung":
                rep.kill()  # SIGTERM can't help a wedged serve loop
            rep.state = DEAD
            rep.last_failure = reason
            _journal_event("fleet.replica_dead", replica=rep.replica_id,
                           reason=reason,
                           inflight=rep.inflight_count)
            out.append((rep, reason))
        return out

    # -- router surface ------------------------------------------------------
    def active(self):
        return [r for r in self.replicas if r.accepting]

    def topology(self):
        """The fleet's live shape as plain data: one row per replica
        (current AND retired) with id, state, incarnation (the
        supervisor attempt — a relaunch bumps it), load, and the last
        failure reason. The /statusz fleet table (``obs.export``)
        renders exactly this."""
        rows = []
        for rep in list(self.replicas) + list(self.retired):
            rows.append({
                "replica": rep.replica_id, "state": rep.state,
                "incarnation": rep.attempt,
                "outstanding_tokens": rep.outstanding_tokens,
                "inflight": rep.inflight_count,
                "mode": ("process" if isinstance(rep, ProcessReplica)
                         else "local"),
                "last_failure": getattr(rep, "last_failure", None),
            })
        rows.sort(key=lambda r: (r["replica"], r["incarnation"]))
        return rows

    def local_engines(self):
        return [r.engine for r in self.replicas
                if isinstance(r, LocalReplica)
                and r.state in (READY, DRAINING)]

    def scrape_targets(self):
        return [r.metrics_url for r in self.replicas
                if isinstance(r, ProcessReplica) and r.metrics_url
                and r.state in (READY, DRAINING)]

    def pump(self, steps=1):
        """Step every live in-process engine (process replicas pump
        themselves)."""
        n = 0
        for rep in self.replicas:
            if isinstance(rep, LocalReplica):
                n += rep.pump(steps)
        return n

    def retire(self, rep):
        """Remove a drained (or dead-while-draining) replica from
        service."""
        if isinstance(rep, ProcessReplica):
            rep.stop()
        else:
            rep.close()
        if rep in self.replicas:
            self.replicas.remove(rep)
        self.retired.append(rep)
        _journal_event("fleet.replica_retired", replica=rep.replica_id)

    def shutdown(self):
        self._pending.clear()
        for rep in list(self.replicas):
            if isinstance(rep, ProcessReplica):
                rep.stop()
            else:
                rep.close()
        self.replicas = []
        if self._hb_dir:
            import shutil

            shutil.rmtree(self._hb_dir, ignore_errors=True)
            self._hb_dir = None
