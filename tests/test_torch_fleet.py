"""paddle_tpu_torch.serving.fleet against paddle_tpu.serving.fleet, on
the CPU.

The same request trace and tenants, on the same ``ManualClock`` steps,
go through the JAX package's ``Router`` (local replicas, its Pallas
decode kernel in interpret mode, ``aot_cache_dir=None``) and the port's
(``device="cpu"``, so the paged kernel's plain version). Everything
compared here is host code with the same integer and float64
arithmetic, so the tolerance is exact equality: dispatch traces,
tokens, states, timestamps, router stats, the ``router_lines`` /
``tenant_lines`` / ``slo_lines`` expositions (parsed, bitwise), the
router-side journal events, the live SLO evaluator's burn and alerts,
the kill/requeue and drain paths, autoscaler decisions,
``ReplicaSupervisor`` budgets and backoffs, the ``Heartbeat`` beacon
and ``ServeEngine.warm``'s count. Where a field differs by design it is
named and left out below, with the reason beside it.

The process-mode kill drill runs once per process through the port's
own ``drill_result(device="cpu")``; the JAX drill is never run here.

Every process-wide piece of the JAX package these tests touch (its
journal, lockdep mode and graph, chaos points, metrics registry and the
module counters that mint replica, request and trace ids) is put back
after each test by ``_jax_globals``, so the JAX package's own tests
that share an xdist worker with this file see what they would alone.
"""
import contextlib
import functools
import itertools
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from paddle_tpu.obs import export as jexport
from paddle_tpu.obs import journal as jjournal
from paddle_tpu.obs import lockdep as jlockdep
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu.obs import slo as jslo
from paddle_tpu.resilience import elastic as jelastic
from paddle_tpu.resilience import inject as jinject
from paddle_tpu.serving import ManualClock as JManualClock
from paddle_tpu.serving import TinyLM as JTinyLM
from paddle_tpu.serving import engine as jengine
from paddle_tpu.serving import fleet as jfleet
from paddle_tpu.serving.fleet import router as jrouter
from paddle_tpu_torch.obs import export, journal, metrics, slo
from paddle_tpu_torch.resilience import elastic
from paddle_tpu_torch.serving import ManualClock, TinyLM
from paddle_tpu_torch.serving import fleet
from paddle_tpu_torch.serving.fleet import drill

from torch_test_threads import torch_threads  # noqa: F401,E402

# the tiny fleet geometry of tests/test_serve_fleet.py
SPEC = dict(vocab_size=32, pages=64, page_size=4, max_seq_len=32,
            token_budget=128, warm=False)


# -- the JAX package's process-wide state ------------------------------------


def _count_at(counter):
    """The next value an ``itertools.count`` will yield, unconsumed."""
    return int(repr(counter)[len("count("):-1])


def _metric_state(inst):
    """An instrument's values (its slots but the lock), copied."""
    names = [k for cls in type(inst).__mro__
             for k in getattr(cls, "__slots__", ()) if k != "_lock"]
    return {k: (list(v) if isinstance(v, list) else v)
            for k in names for v in [getattr(inst, k)]}


@contextlib.contextmanager
def registry_restored(reg):
    """Run a block, then put a metrics registry's values back (an
    instrument first made in the block is zeroed: module code keeps
    references to it)."""
    metric_state = {n: _metric_state(reg.get(n)) for n in reg.names()}
    try:
        yield
    finally:
        for name in reg.names():
            inst = reg.get(name)
            if name in metric_state:
                for k, v in metric_state[name].items():
                    setattr(inst, k, v)
            else:
                inst._reset()


@contextlib.contextmanager
def jax_globals_restored():
    """Run a block, then put back every process-wide piece of the JAX
    package that driving its fleet can change."""
    engines = list(jengine._ENGINES)
    counters = {(jengine, "_REPLICA_IDS"): _count_at(jengine._REPLICA_IDS),
                (jrouter, "_frid_counter"):
                    _count_at(jrouter._frid_counter),
                (jrouter, "_trace_counter"):
                    _count_at(jrouter._trace_counter)}
    active = jjournal.ACTIVE
    chaos = dict(jinject.ACTIVE)
    mode = jlockdep.mode()
    with jlockdep._GRAPH_LOCK:
        graph = ({a: set(b) for a, b in jlockdep._succ.items()},
                 dict(jlockdep._edges), list(jlockdep._violations))
    try:
        with registry_restored(jmetrics.REGISTRY):
            yield
    finally:
        if jjournal.ACTIVE is not None and jjournal.ACTIVE is not active:
            jjournal.ACTIVE.close()
        jjournal.ACTIVE = active
        jinject.ACTIVE.clear()
        jinject.ACTIVE.update(chaos)
        if mode is None:
            jlockdep.disable()
        else:
            jlockdep.enable(mode)
        with jlockdep._GRAPH_LOCK:
            jlockdep._succ.clear()
            jlockdep._succ.update(graph[0])
            jlockdep._edges.clear()
            jlockdep._edges.update(graph[1])
            jlockdep._violations[:] = graph[2]
        for (mod, name), n in counters.items():
            setattr(mod, name, itertools.count(n))
        # the live-engine registry the exporter discovers replicas
        # through: an engine built here must not join another test's
        # scrape while a reference cycle keeps it alive
        with jengine._ENGINES_LOCK:
            jengine._ENGINES[:] = engines


@pytest.fixture(autouse=True)
def _jax_globals():
    with jax_globals_restored():
        yield
    for mod in (journal,):
        if mod.ACTIVE is not None:
            mod.ACTIVE.close()
        mod.ACTIVE = None


# -- builders -----------------------------------------------------------------


def _jax_fleet(n=2, clock=None, **kw):
    # aot_cache_dir stays None (the ReplicaSpec default); the pool hands
    # every engine an explicit replica id
    clock = clock or JManualClock()
    spec = jfleet.ReplicaSpec(**dict(SPEC, **kw))
    pool = jfleet.ReplicaPool(
        spec, replicas=n, mode="local", clock=clock,
        supervisor=jelastic.ReplicaSupervisor(sleep=lambda s: None))
    return pool, clock


def _port_fleet(n=2, clock=None, **kw):
    clock = clock or ManualClock()
    spec = fleet.ReplicaSpec(**dict(SPEC, device="cpu", **kw))
    pool = fleet.ReplicaPool(
        spec, replicas=n, mode="local", clock=clock,
        supervisor=elastic.ReplicaSupervisor(sleep=lambda s: None))
    return pool, clock


def _requests(n=12, seed=0, tenants=("a", "b")):
    """(rid, prompt, max_new_tokens, tenant) from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        plen = int(rng.randint(2, 9))
        out.append((f"q{i:02d}",
                    [int(t) for t in rng.randint(0, 32, plen)],
                    int(rng.randint(2, 7)), tenants[i % len(tenants)]))
    return out


def _request_view(r):
    return {k: getattr(r, k) for k in (
        "rid", "state", "tokens", "tenant", "replica_id", "arrival_t",
        "admit_t", "first_token_t", "finish_t", "requeues",
        "preemptions", "dispatches", "requeue_ts", "rate_wait",
        "rate_hold_t")}


def _lines(mod, router, engines):
    parse = mod.parse_prometheus_text
    return {"router": parse("\n".join(mod.router_lines(router))),
            "tenant": parse("\n".join(mod.tenant_lines(router=router,
                                                       engines=engines))),
            "slo": parse("\n".join(mod.slo_lines(engines=engines)))}


# router-side journal events: every key but the wall-clock ``ts``. The
# engines' own records are compared elsewhere (test_torch_serving.py);
# their ``compile`` events differ by design (the JAX engine's carry its
# AOT provenance) and the port journals a ``backend`` event the JAX
# serving path does not.
_ROUTER_KINDS = ("router.", "req.submit", "req.dispatch", "req.requeue",
                 "req.rate_hold", "fleet.", "tenant.summary", "slo.",
                 "elastic.")


def _router_events(path):
    out = []
    with open(os.path.join(path, "journal.jsonl"), encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("t") == "event" and \
                    rec["kind"].startswith(_ROUTER_KINDS):
                rec.pop("ts")
                out.append(rec)
    return out


def _run(router, clock, steps_out, max_iters=400, dt=0.01, each=None):
    for i in range(max_iters):
        if each is not None:
            each(i)
        done = router.step()
        steps_out.append(sorted(r.rid for r in done))
        clock.advance(dt)
        if not router.inflight and not router.queue_depth:
            return
    raise AssertionError("fleet did not drain")


def _scenario_side(side, root):
    """One side of the main parity scenario: 2 replicas (the autoscaler
    may add a third), tenants "a" (weight 1) and "b" (weight 2,
    rate-limited to 60 tokens a second, burst 16), twelve requests, an
    SLO evaluator and the autoscaler on the router's tick, a run
    journal. Returns plain data."""
    jax_side = side == "jax"
    ex = jexport if jax_side else export
    slo_mod = jslo if jax_side else slo
    Fleet = jfleet if jax_side else fleet
    jmod = jjournal if jax_side else journal
    pool, clock = (_jax_fleet if jax_side else _port_fleet)(n=2)
    tenants = {"a": Fleet.TenantPolicy(weight=1.0),
               "b": Fleet.TenantPolicy(weight=2.0, rate=60.0,
                                       burst=16.0)}
    # the evaluator reads each package's own registry beside the
    # router's exposition: both start from zero here (the caller puts
    # the values back), so both hold this scenario's samples only
    (jmetrics if jax_side else metrics).reset()
    ev = slo_mod.SLOEvaluator(
        {"ttft_p99_ms": {"threshold_ms": 20.0, "target": 0.9},
         "availability": 0.99},
        clock=clock, interval_s=0.05)
    asc = Fleet.Autoscaler(min_replicas=1, max_replicas=3, queue_high=4.0,
                           queue_low=1.0, ttft_p99_slo_ms=30.0,
                           breach_patience=1, low_patience=2,
                           cooldown_s=0.1, clock=clock)
    jdir = os.path.join(root, side)
    j = jmod.RunJournal(jdir, rank=None, flush_every=1)
    j.start()
    jmod.ACTIVE = j
    router = Fleet.Router(pool, clock=clock, tenants=tenants,
                          autoscaler=asc, slo=ev,
                          autoscale_interval_s=0.05)
    reqs = [router.submit(p, max_new_tokens=m, rid=rid, tenant=t)
            for rid, p, m, t in _requests()]
    rejects = []

    def reject_some(i):
        # mid-run, so the availability objective's windows see them
        if i != 20:
            return
        for prompt, new in (([1] * 30, 8), ([99], 1), ([1] * 20, 1)):
            with pytest.raises(ValueError) as e:
                router.submit(prompt, max_new_tokens=new,
                              rid=f"bad{new}", tenant="b")
            rejects.append(str(e.value))
    completions = []
    _run(router, clock, completions, each=reject_some)
    out = {
        "requests": [_request_view(r) for r in reqs],
        "trace": list(router.trace),
        "completions": completions,
        "stats": router.stats(),
        "lines": _lines(ex, router, pool.local_engines()),
        "exposition": Fleet.Autoscaler.signals_from_scrape(
            router.exposition()),
        "rejects": rejects,
        "slo": {"burn": dict(ev.burn), "budget": dict(ev.budget_left),
                "alerts": list(ev.alert_log),
                "replica_slo": dict(ev.replica_slo),
                "ticks": ev.ticks, "status": ev.status()},
        "decisions": list(asc.decisions),
        "topology": pool.topology(),
    }
    router.close()
    j.close()
    jmod.ACTIVE = None
    out["events"] = _router_events(jdir)
    return out


@functools.lru_cache(maxsize=None)
def _scenario():
    root = tempfile.mkdtemp(prefix="pt_torch_fleet_")
    with jax_globals_restored():
        jx = _scenario_side("jax", root)
    with registry_restored(metrics.REGISTRY):
        pt = _scenario_side("port", root)
    return jx, pt


# -- the main scenario --------------------------------------------------------


def test_scenario_dispatch_trace_tokens_and_states():
    jx, pt = _scenario()
    assert pt["trace"] == jx["trace"]
    assert pt["completions"] == jx["completions"]
    assert pt["requests"] == jx["requests"]
    # the scenario is not vacuous: both tenants served, the rate limit
    # held tenant b, every request finished with tokens
    assert {r["state"] for r in pt["requests"]} == {"FINISHED"}
    assert all(r["tokens"] for r in pt["requests"])
    assert any(r["rate_wait"] > 0 for r in pt["requests"])
    assert {e["tenant"] for e in pt["trace"]} == {"a", "b"}


def test_scenario_router_summary_and_rejections():
    jx, pt = _scenario()
    assert pt["stats"] == jx["stats"]
    assert pt["rejects"] == jx["rejects"] and len(pt["rejects"]) == 3
    assert pt["topology"] == jx["topology"]
    summary = [e for e in pt["events"] if e["kind"] == "router.summary"]
    assert len(summary) == 1 and summary[0]["rejected"] == 3


@pytest.mark.parametrize("family", ["router", "tenant", "slo"])
def test_scenario_expositions_parse_bitwise_equal(family):
    jx, pt = _scenario()
    assert pt["lines"][family], family
    assert pt["lines"][family] == jx["lines"][family]


def test_scenario_router_journal_events():
    jx, pt = _scenario()
    assert [e["kind"] for e in pt["events"]] == \
        [e["kind"] for e in jx["events"]]
    for a, b in zip(pt["events"], jx["events"]):
        if a["kind"] in ("req.submit", "req.dispatch"):
            # the trace id embeds each package's process-wide
            # counter, which other tests in the process have moved
            a, b = dict(a), dict(b)
            assert a.pop("trace").endswith(b.pop("trace")[9:])
        assert a == b


def test_scenario_slo_evaluator_and_autoscaler():
    jx, pt = _scenario()
    assert pt["slo"] == jx["slo"]
    assert pt["slo"]["ticks"] >= 10
    assert {a["objective"] for a in pt["slo"]["alerts"]} == \
        {"ttft_p99_ms", "availability"}
    assert pt["exposition"] == jx["exposition"]
    assert pt["decisions"] == jx["decisions"]


# -- kill and requeue, drain versus kill --------------------------------------


def _kill_side(side):
    pool, clock = (_jax_fleet() if side == "jax" else _port_fleet())
    Fleet = jfleet if side == "jax" else fleet
    router = Fleet.Router(pool, clock=clock)
    for rid, p, m, _t in _requests(n=6, seed=3):
        router.submit(p, max_new_tokens=m, rid=rid)
        clock.advance(1 / 1024)          # distinct arrivals
    router.dispatch()
    clock.advance(0.5)
    router.step()                        # prefill + a first decode
    victim = pool.replicas[1]
    victim.kill()
    clock.advance(0.25)
    t_kill = clock()
    requeued = router.check_replicas()
    pending = [q.rid for q in router._queues.get("default", [])]
    done = []
    _run(router, clock, done)
    reqs = {r.rid: _request_view(r) for r in router.completed}
    out = {"requeued": requeued, "pending": pending, "t_kill": t_kill,
           "trace": list(router.trace), "requests": reqs,
           "stats": router.stats(), "topology": pool.topology(),
           "supervisor": (dict(pool.supervisor.restarts),
                          list(pool.supervisor.history))}
    router.close()
    return out


def test_kill_requeues_in_arrival_order_keeping_admit_time():
    with jax_globals_restored():
        jx = _kill_side("jax")
    pt = _kill_side("port")
    assert pt == jx
    (rep, reason, n), = pt["requeued"]
    assert (rep, reason) == (1, "exit") and n >= 1
    stranded = [r for r in pt["requests"].values() if r["requeues"]]
    assert sorted(r["rid"] for r in stranded) == sorted(pt["pending"])
    # re-dispatched in original arrival order, first admit kept
    redispatch = [e["rid"] for e in pt["trace"][6:]]
    assert redispatch == [r["rid"] for r in sorted(
        stranded, key=lambda r: r["arrival_t"])]
    for r in stranded:
        assert r["admit_t"] == r["dispatches"][0][0] < r["dispatches"][1][0]
        assert r["requeue_ts"] == [pt["t_kill"]]
    # and the tokens are the dense oracle's
    model = TinyLM(vocab_size=32, device="cpu")
    for rid, p, m, _t in _requests(n=6, seed=3):
        assert pt["requests"][rid]["tokens"] == \
            model.reference_generate(p, m)


def _drain_side(side):
    pool, clock = (_jax_fleet() if side == "jax" else _port_fleet())
    Fleet = jfleet if side == "jax" else fleet
    router = Fleet.Router(pool, clock=clock)
    a = router.submit([1, 2, 3], max_new_tokens=4, rid="a")
    b = router.submit([4, 5, 6], max_new_tokens=4, rid="b")
    router.dispatch()
    pool.replicas[1].drain()
    c = router.submit([7, 8], max_new_tokens=2, rid="c")
    router.dispatch()
    done = []
    _run(router, clock, done)
    out = {"requests": [_request_view(r) for r in (a, b, c)],
           "trace": list(router.trace), "stats": router.stats(),
           "topology": pool.topology(),
           "active": [r.replica_id for r in pool.active()]}
    router.close()
    return out


def test_drain_finishes_in_place_where_kill_requeues():
    with jax_globals_restored():
        jx = _drain_side("jax")
    pt = _drain_side("port")
    assert pt == jx
    a, b, c = pt["requests"]
    assert (b["replica_id"], b["requeues"], b["state"]) == \
        (1, 0, "FINISHED")
    assert c["replica_id"] == 0 and pt["active"] == [0]
    assert pt["stats"]["requeued"] == 0
    assert [r["state"] for r in pt["topology"]] == ["READY", "RETIRED"]


# -- autoscaler, supervisor, heartbeat ----------------------------------------


def _signal_sequence():
    rng = np.random.RandomState(5)
    seq = []
    for i in range(60):
        sig = {"queue_depth": float(rng.choice([0, 0.5, 2, 9, 12]))}
        if i % 3:
            sig["ttft_p99_ms"] = float(rng.choice([5.0, 80.0, 400.0]))
        if i % 4 == 1:
            sig["tpot_p99_ms"] = float(rng.choice([2.0, 60.0]))
        seq.append((sig, int(rng.randint(1, 5)), float(i) * 7.5))
    return seq


@pytest.mark.parametrize("kw", [
    dict(min_replicas=1, max_replicas=3, queue_high=8.0, queue_low=1.0,
         ttft_p99_slo_ms=100.0, breach_patience=2, low_patience=3,
         cooldown_s=10.0),
    dict(min_replicas=2, max_replicas=4, tpot_p99_slo_ms=50.0,
         breach_patience=1, low_patience=1, cooldown_s=0.0),
])
def test_autoscaler_decisions_from_the_same_signals(kw):
    ja = jfleet.Autoscaler(clock=JManualClock(), **kw)
    pa = fleet.Autoscaler(clock=ManualClock(), **kw)
    got = [(ja.observe(s, replicas=n, now=t, max_replicas=n + 1),
            pa.observe(s, replicas=n, now=t, max_replicas=n + 1))
           for s, n, t in _signal_sequence()]
    assert [g[1] for g in got] == [g[0] for g in got]
    assert pa.decisions == ja.decisions and pa.decisions


def test_autoscaler_reads_the_same_scrape():
    text = "\n".join([
        "# TYPE paddle_tpu_fleet_router_queue_depth gauge",
        "paddle_tpu_fleet_router_queue_depth 7",
        'paddle_tpu_serving_slo_ttft_ms{replica="0",q="p99"} 12.5',
        'paddle_tpu_serving_slo_ttft_ms{replica="1",q="p99"} 40.25',
        'paddle_tpu_serving_slo_tpot_ms{replica="1",q="p50"} 3.5',
        'paddle_tpu_serving_slo_running{replica="0"} 2',
        'paddle_tpu_serving_slo_running{replica="1"} 1',
        'paddle_tpu_serving_slo_queue_depth{replica="1"} 4'])
    assert fleet.Autoscaler.signals_from_scrape(text) == \
        jfleet.Autoscaler.signals_from_scrape(text) == \
        {"queue_depth": 7.0, "ttft_p99_ms": 40.25, "replicas": 2}
    from paddle_tpu.serving.fleet.autoscale import \
        per_replica_slo_from_scrape as jper
    from paddle_tpu_torch.serving.fleet.autoscale import \
        per_replica_slo_from_scrape as per
    assert per(text) == jper(text) and per(text)


@pytest.mark.parametrize("kw", [
    dict(max_restarts=2, backoff_s=0.05, jitter=0.0),
    dict(max_restarts=3, backoff_s=0.5, backoff_factor=3.0,
         max_backoff_s=2.0, jitter=0.25, seed=11),
])
def test_replica_supervisor_budget_and_backoff(kw):
    slept = {"jax": [], "port": []}
    sides = {"jax": jelastic.ReplicaSupervisor(
                 sleep=slept["jax"].append, **kw),
             "port": elastic.ReplicaSupervisor(
                 sleep=slept["port"].append, **kw)}
    seq = [(0, "crash", 1), (1, "hang", None), (0, "preempt", 75),
           (0, "crash", 137), (1, "crash", 1), (0, "hang", None),
           (0, "crash", 1), (1, "preempt", 75)]
    out = {}
    for name, sup in sides.items():
        rows = []
        for rid, kind, code in seq:
            try:
                rows.append(("ok", sup.note_failure(
                    rid, kind=kind, code=code, defer=(rid == 1))))
            except (jelastic.ElasticBudgetError,
                    elastic.ElasticBudgetError) as e:
                rows.append(("exhausted", str(e), e.history))
        out[name] = (rows, sup.restarts, sup.preemptions, sup.history)
    assert out["port"] == out["jax"]
    assert slept["port"] == slept["jax"] and slept["port"]
    assert any(r[0] == "exhausted" for r in out["port"][0])


def test_heartbeat_beacon(tmp_path, monkeypatch):
    for mod in (jelastic, elastic):
        path = tmp_path / f"{mod.__name__}.json"
        monkeypatch.setenv(mod.HEARTBEAT_ENV, str(path))
        hb = mod.Heartbeat.from_env()
        hb.beat(3)
        hb.beat()
        rec = json.loads(path.read_text())
        assert rec["pid"] == os.getpid() and "step" not in rec
        assert hb.beats == 2
        monkeypatch.delenv(mod.HEARTBEAT_ENV)
        inert = mod.Heartbeat.from_env()
        inert.beat(1)
        assert inert.path is None and inert.beats == 0
    assert (elastic.HEARTBEAT_ENV, elastic.ATTEMPT_ENV) == \
        (jelastic.HEARTBEAT_ENV, jelastic.ATTEMPT_ENV)


# -- weights, warm, spec ------------------------------------------------------


@pytest.mark.parametrize("vocab,heads,dim,seed", [
    (32, 2, 8, 0), (64, 4, 16, 7)])
def test_tinylm_weights_equal_the_jax_models(vocab, heads, dim, seed):
    jm = JTinyLM(vocab_size=vocab, num_heads=heads, head_dim=dim,
                 seed=seed)
    tm = TinyLM(vocab_size=vocab, num_heads=heads, head_dim=dim,
                seed=seed, device="cpu")
    for name in TinyLM.PARAMS:
        a = np.asarray(getattr(jm, name))
        b = getattr(tm, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("geo,max_batch", [
    (dict(pages=16, page_size=4, max_seq_len=16), 4),
    (dict(pages=64, page_size=8, max_seq_len=40), 8),
    (dict(pages=9, page_size=4, max_seq_len=None), 1),
])
def test_warm_count_equals_the_jax_engines(geo, max_batch):
    spec = dict(vocab_size=32, token_budget=64, **geo)
    jeng = jfleet.ReplicaSpec(**spec).build_engine(0)
    peng = fleet.ReplicaSpec(device="cpu", **spec).build_engine(0)
    n = peng.warm(max_batch=max_batch)
    assert n == jeng.warm(max_batch=max_batch) > 0
    # the port counts each warmed shape as the JAX engine counts a
    # compile; warming twice adds no shape and warms the same count
    assert peng._compiles == n == peng.warm(max_batch=max_batch)
    assert peng._compiles == n
    # warm touched no sequence: the pool balances, the meter is idle,
    # and a request afterwards decodes as the oracle does
    assert peng.cache.verify() and peng.cache.stats()["used_pages"] == 0
    assert peng.usage.busy_ns == 0 and peng._steps == 0
    req = peng.submit([3, 1, 4], max_new_tokens=3)
    peng.run()
    assert req.generated == peng.model.reference_generate([3, 1, 4], 3)


def test_replica_spec_port_idiom():
    with pytest.raises(NotImplementedError, match="aot_cache_dir"):
        fleet.ReplicaSpec(aot_cache_dir="/nonexistent")
    spec = fleet.ReplicaSpec(device="cpu")
    argv = spec.worker_argv(3)
    assert argv[1:3] == ["-m", "paddle_tpu_torch.serving.fleet.worker"]
    assert argv[argv.index("--device") + 1] == "cpu"
    assert "--device" not in fleet.ReplicaSpec().worker_argv(0)
    # the JAX spec's argv and the port's name the same flags otherwise
    jargv = jfleet.ReplicaSpec().worker_argv(3)
    pargv = fleet.ReplicaSpec().worker_argv(3)
    assert pargv[3:] == jargv[3:]
    # no device: the card, which this host may not have
    if torch.cuda.is_available():
        assert fleet.ReplicaSpec().build_engine(0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet.ReplicaSpec().build_engine(0)


# -- the process-mode kill drill ----------------------------------------------


def test_kill_drill_on_the_cpu():
    res = drill.drill_result(device="cpu")
    assert res["failures"] == []
    assert res["incarnations"] == 2 and res["requeued_rids"]
    assert res["cross_flow_rids"] == res["requeued_rids"]
    assert res["stats"]["requeued"] == len(res["requeued_rids"])
    assert [r["tokens"] for r in res["requests"]] == res["oracle"]
    assert res["relaunch_ready_s"] > 0
    # every incarnation that came up journaled its device; the kill
    # incarnation's backend event precedes its death
    assert {b["platform"] for bs in res["backends"].values()
            for b in bs} == {"cpu"}
    assert len(res["backends"][drill.VICTIM]) == 2
    # the survivor's launch record: its decode steps after ready
    (launch,) = res["kernel_launches"][0]
    assert launch["decode_steps"] > 0
    assert launch["stop"] == launch["ready"]   # CPU: plain versions
