"""paddle_tpu_torch.obs's fleet readers against paddle_tpu.obs, on the
CPU: ``timeseries``, ``slo``, ``anomaly``, ``reqtrace``, ``fleet``,
``export`` and ``usage.tenant_slo_slices`` over the SAME inputs.

The journal records come from runs of the port on the CPU — a routed
two-replica local fleet on a ``ManualClock`` (one journal, exact
timestamps) and the port's process-mode kill drill (a router journal
and two rank journals, one holding two incarnations and the torn tail
of an ``os._exit``) — and both packages' readers parse the same files.
Synthetic series (expositions, histogram payloads, step and SLO tick
records) go through both packages' stateful evaluators in the same
order. Host code with the same integer and float64 arithmetic, so the
tolerance is exact equality; the one field left out is named where it
is dropped.

The JAX package's process-wide state that its evaluators touch (the
metrics registry its anomaly engine ticks, its journal) is put back
after each test.
"""
import json
import os
import tempfile
import urllib.request

import numpy as np
import pytest

from paddle_tpu.obs import anomaly as janomaly
from paddle_tpu.obs import export as jexport
from paddle_tpu.obs import fleet as jobs_fleet
from paddle_tpu.obs import journal as jjournal
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu.obs import reqtrace as jreqtrace
from paddle_tpu.obs import slo as jslo
from paddle_tpu.obs import timeseries as jtimeseries
from paddle_tpu.obs import usage as jusage
from paddle_tpu.utils import envspec as jenvspec
from paddle_tpu_torch.obs import (anomaly, export, journal, metrics,
                                  reqtrace, slo, timeseries, usage)
from paddle_tpu_torch.obs import fleet as obs_fleet
from paddle_tpu_torch.serving import ManualClock
from paddle_tpu_torch.serving import fleet
from paddle_tpu_torch.serving.fleet import drill
from paddle_tpu_torch.resilience import elastic
from paddle_tpu_torch.utils import envspec

from torch_test_threads import torch_threads  # noqa: F401,E402

SPECS = {"ttft_p99_ms": {"threshold_ms": 30.0, "target": 0.9},
         "tpot_p99_ms": {"threshold_ms": 12.0, "target": 0.5},
         "availability": 0.95}


def _metric_state(reg):
    out = {}
    for name in reg.names():
        inst = reg.get(name)
        out[name] = {k: (list(getattr(inst, k))
                         if isinstance(getattr(inst, k), list)
                         else getattr(inst, k))
                     for cls in type(inst).__mro__
                     for k in getattr(cls, "__slots__", ())
                     if k != "_lock"}
    return out


@pytest.fixture(autouse=True)
def _jax_globals():
    """Put back the JAX package's metrics and journal (the anomaly
    engine ticks ``anomaly.<name>`` counters in its registry)."""
    saved = {id(reg): _metric_state(reg)
             for reg in (jmetrics.REGISTRY, metrics.REGISTRY)}
    active = (jjournal.ACTIVE, journal.ACTIVE)
    yield
    for reg in (jmetrics.REGISTRY, metrics.REGISTRY):
        state = saved[id(reg)]
        for name in reg.names():
            inst = reg.get(name)
            if name in state:
                for k, v in state[name].items():
                    setattr(inst, k, v)
            else:
                inst._reset()
    jjournal.ACTIVE, journal.ACTIVE = active


# -- the journals -------------------------------------------------------------


_LOCAL_RUN = {}


def local_run():
    """A routed two-replica port fleet on a ManualClock, journaled into
    one directory: two tenants (one rate-limited), a mid-run reject, a
    replica killed mid-decode and relaunched. Made once per process."""
    if "dir" in _LOCAL_RUN:
        return _LOCAL_RUN["dir"]
    root = tempfile.mkdtemp(prefix="pt_torch_fleet_obs_")
    clock = ManualClock()
    spec = fleet.ReplicaSpec(vocab_size=32, pages=64, page_size=4,
                             max_seq_len=32, token_budget=128, warm=False,
                             device="cpu")
    pool = fleet.ReplicaPool(
        spec, replicas=2, mode="local", clock=clock,
        supervisor=elastic.ReplicaSupervisor(sleep=lambda s: None,
                                             backoff_s=0.05, jitter=0.0))
    j = journal.RunJournal(root, rank=None, flush_every=1)
    j.start()
    journal.ACTIVE = j
    try:
        router = fleet.Router(
            pool, clock=clock,
            tenants={"a": fleet.TenantPolicy(weight=1.0),
                     "b": fleet.TenantPolicy(weight=3.0, rate=80.0,
                                             burst=16.0)})
        rng = np.random.RandomState(4)
        for i in range(10):
            router.submit([int(t) for t in rng.randint(0, 32, 3 + i % 5)],
                          max_new_tokens=2 + i % 4, rid=f"r{i}",
                          tenant="ab"[i % 2])
            clock.advance(1 / 256)
        for i in range(300):
            if i == 3:
                pool.replicas[1].kill()
            if i == 5:
                with pytest.raises(ValueError):
                    router.submit([1] * 40, max_new_tokens=1, rid="big",
                                  tenant="a")
            router.step()
            clock.advance(1 / 64)
            if not router.inflight and not router.queue_depth \
                    and not pool._pending:
                break
        assert router.stats()["requeued"] >= 1
        router.close()
    finally:
        j.close()
        journal.ACTIVE = None
    _LOCAL_RUN["dir"] = root
    return root


def drill_run():
    res = drill.drill_result(device="cpu")
    assert res["failures"] == []
    return res["run_dir"]


RUNS = {"local": local_run, "drill": drill_run}


# -- obs.fleet ----------------------------------------------------------------


@pytest.mark.parametrize("run", sorted(RUNS))
def test_fleet_load_and_summaries(run):
    run_dir = RUNS[run]()
    if run == "drill":
        fl = jobs_fleet.load_fleet(run_dir), obs_fleet.load_fleet(run_dir)
        assert fl[1] == fl[0] and len(fl[1]["ranks"]) == 2
        for name in ("merged_request_summary", "merged_tenant_summary",
                     "align_steps", "stall_attribution"):
            a, b = getattr(jobs_fleet, name)(fl[0]), \
                getattr(obs_fleet, name)(fl[1])
            assert b == a, name
        # aggregate over the loaded dict: a path would add the
        # heartbeat ages, which read the wall clock at the call
        assert obs_fleet.aggregate(fl[1]) == jobs_fleet.aggregate(fl[0])
        assert obs_fleet.heartbeat_ages(run_dir, now=2e9) == \
            jobs_fleet.heartbeat_ages(run_dir, now=2e9)
        assert obs_fleet.router_summary(fl[1]["router"]) == \
            jobs_fleet.router_summary(fl[0]["router"])
        assert obs_fleet.router_summary(fl[1]["router"])["requeued"] >= 1
        runs = list(fl[1]["ranks"].values())
        jruns = list(fl[0]["ranks"].values())
    else:
        runs = [obs_fleet.load_journal(run_dir)]
        jruns = [jobs_fleet.load_journal(run_dir)]
        assert runs == jruns
    for jr, pr in zip(jruns, runs):
        for name in ("request_summary", "router_summary", "slo_summary",
                     "tenant_summary", "elastic_summary",
                     "per_rank_summary"):
            assert getattr(obs_fleet, name)(pr) == \
                getattr(jobs_fleet, name)(jr), name
    # every request of the run, each journaled once where it finished
    assert sum(len(r["requests"]) for r in runs) == \
        (10 if run == "local" else drill.N_REQUESTS)


def test_merged_chrome_trace_with_request_lanes():
    run_dir = drill_run()
    out = tempfile.mkdtemp(prefix="pt_torch_fleet_trace_")
    ja = jobs_fleet.merge_chrome_traces(run_dir,
                                        os.path.join(out, "jax.json"))
    pa = obs_fleet.merge_chrome_traces(run_dir,
                                       os.path.join(out, "port.json"))
    assert {k: v for k, v in pa.items() if k != "path"} == \
        {k: v for k, v in ja.items() if k != "path"}
    with open(ja["path"]) as f, open(pa["path"]) as g:
        assert json.load(g) == json.load(f)
    assert pa["request_slices"] > 0


# -- obs.reqtrace -------------------------------------------------------------


@pytest.mark.parametrize("run", sorted(RUNS))
def test_reqtrace_timelines_and_attribution(run):
    run_dir = RUNS[run]()
    jt, pt = jreqtrace.assemble_run(run_dir), reqtrace.assemble_run(run_dir)
    assert pt == jt and pt
    ja, pa = jreqtrace.attribute_run(jt), reqtrace.attribute_run(pt)
    assert pa == ja
    assert [reqtrace.attribution_sum(a) for a in pa] == \
        [jreqtrace.attribution_sum(a) for a in ja]
    for key in ("ttft_ms", "e2e_ms"):
        assert reqtrace.tail_report(pt, key=key, pct=90.0, k=3) == \
            jreqtrace.tail_report(jt, key=key, pct=90.0, k=3)
    assert reqtrace.request_lane_events(pt) == \
        jreqtrace.request_lane_events(jt)
    requeued = [a for a in pa if a.get("requeue_ms")]
    assert requeued, "the run requeued nothing"
    if run == "local":
        # ManualClock stamps are dyadic: every request's phases sum to
        # its e2e exactly
        for a in pa:
            if a.get("e2e_ms") is not None:
                assert reqtrace.attribution_sum(a) == a["e2e_ms"]


# -- obs.slo and usage.tenant_slo_slices --------------------------------------


@pytest.mark.parametrize("run", sorted(RUNS))
def test_slo_evaluate_run_and_tenant_slices(run):
    run_dir = RUNS[run]()
    assert slo.load_any(run_dir) == jslo.load_any(run_dir)
    rep = slo.evaluate_run(run_dir, SPECS)
    assert rep == jslo.evaluate_run(run_dir, SPECS)
    assert {o["name"] for o in rep["objectives"]} == set(SPECS)
    assert slo.evaluate_run(run_dir, SPECS, duration_s=2.5) == \
        jslo.evaluate_run(run_dir, SPECS, duration_s=2.5)
    slices = usage.tenant_slo_slices(run_dir, SPECS)
    assert slices == jusage.tenant_slo_slices(run_dir, SPECS)
    assert set(slices) >= ({"a", "b"} if run == "local" else {"drill"})


def _hist(buckets, flat):
    cum, c = [], 0
    for n in flat:
        c += n
        cum.append(c)
    return ("histogram", (tuple(buckets), tuple(cum), c, float(c) * 3.5))


def _ticks():
    """60 SLO ticks of 10 s: clean, then a TTFT excursion and a reject
    burst, then recovery — the exposition-dict form the evaluator's
    ``observe(text=...)`` takes."""
    lat = (5.0, 10.0, 25.0, 50.0, 100.0, 1000.0)
    ttft, tpot = [0] * 7, [0] * 7
    rej = disp = tok = 0.0
    out = []
    for i in range(60):
        bad = 25 <= i < 40
        ttft[4 if bad else 1] += 9
        ttft[0] += 1
        tpot[2 if bad and i % 2 else 1] += 10
        rej += 6 if 30 <= i < 36 else 0
        disp += 10
        tok += 0 if bad else 80
        out.append({
            "serving.ttft_ms": _hist(lat, tuple(ttft)),
            "serving.tpot_ms": _hist(lat, tuple(tpot)),
            "serving.router.rejected": ("counter", rej),
            "serving.router.dispatched": ("counter", disp),
            "serving.tokens_generated": ("counter", tok),
            "serving.router.queue_depth": ("gauge", float(i % 7)),
        })
    return out


def _evaluate(slo_mod, anomaly_mod, clock_cls):
    clock = clock_cls()
    eng = anomaly_mod.AnomalyEngine(
        detectors=anomaly_mod.serving_detectors("ttft_spike:factor=3"))
    ev = slo_mod.SLOEvaluator(
        dict(SPECS, goodput_tps={"floor": 5.0, "target": 0.9}),
        clock=clock,
        interval_s=10.0, include_registry=False, anomaly_engine=eng)
    fired = []
    for i, text in enumerate(_ticks()):
        clock.advance(10.0)
        extra = {"tenant_shares": {
            "a": {"share": 0.3 + 0.01 * i, "weight_share": 0.25},
            "b": {"share": 0.7 - 0.01 * i, "weight_share": 0.75}},
            "tenant_served_total": 64.0 * i}
        fired.append(ev.observe(text=text, now=clock(), extra=extra))
    return ev, eng, fired


def test_slo_evaluator_burn_alerts_and_exposition():
    from paddle_tpu.serving import ManualClock as JManualClock

    jev, jeng, jfired = _evaluate(jslo, janomaly, JManualClock)
    pev, peng, pfired = _evaluate(slo, anomaly, ManualClock)
    assert pfired == jfired
    assert pev.burn == jev.burn and pev.budget_left == jev.budget_left
    assert pev.alert_log == jev.alert_log and pev.alert_log
    assert pev.status() == jev.status()
    assert pev.active_alerts() == jev.active_alerts()
    assert peng.fired == jeng.fired
    assert {f["name"] for f in peng.fired} >= {"ttft_spike", "tenant_hog"}
    for obj in SPECS:
        for win in ("1m", "5m", "30m", "3h"):
            assert pev.burn_rate(obj, win) == jev.burn_rate(obj, win)
        assert pev.budget_remaining(obj) == jev.budget_remaining(obj)
    lines = export.parse_prometheus_text(
        "\n".join(export.slo_engine_lines(pev)))
    assert lines == jexport.parse_prometheus_text(
        "\n".join(jexport.slo_engine_lines(jev)))
    # the scraped burn gauge parses back bitwise equal to the float
    key = ('paddle_tpu_slo_burn_rate{objective="availability",'
           'window="5m"}')
    assert lines[key] == pev.burn[("availability", "5m")]


# -- obs.timeseries -----------------------------------------------------------


def test_timeseries_store_windows():
    jstore = jtimeseries.SeriesStore(interval_s=1.0, horizon_s=3600.0,
                                     clock=lambda: 0.0)
    pstore = timeseries.SeriesStore(interval_s=1.0, horizon_s=3600.0,
                                    clock=lambda: 0.0)
    for i, text in enumerate(_ticks()):
        snap = dict(text)
        if i == 33:    # a counter reset (a restarted replica)
            snap["serving.router.dispatched"] = ("counter", 3.0)
        jstore.observe(snap, now=10.0 * i)
        pstore.observe(snap, now=10.0 * i)
    assert pstore.names() == jstore.names()
    now = 590.0
    for win in (60.0, 300.0, 1800.0):
        for name in ("serving.router.dispatched",
                     "serving.tokens_generated"):
            assert pstore.counter_delta(name, win, now=now) == \
                jstore.counter_delta(name, win, now=now)
            assert pstore.counter_rate(name, win, now=now) == \
                jstore.counter_rate(name, win, now=now)
        g = "serving.router.queue_depth"
        assert pstore.gauge_last(g, now=now) == jstore.gauge_last(g, now=now)
        assert pstore.gauge_delta(g, win, now=now) == \
            jstore.gauge_delta(g, win, now=now)
        for h in ("serving.ttft_ms", "serving.tpot_ms"):
            assert pstore.hist_window(h, win, now=now) == \
                jstore.hist_window(h, win, now=now)
            for q in (50, 99):
                assert pstore.percentile(h, q, win, now=now) == \
                    jstore.percentile(h, q, win, now=now)
            assert pstore.fraction_above(h, 20.0, win, now=now) == \
                jstore.fraction_above(h, 20.0, win, now=now)
    buckets, counts = (1.0, 2.0, 4.0), (3, 0, 5, 2)
    for q in (0, 10, 50, 90, 99, 100):
        assert timeseries.percentile_from_buckets(buckets, counts, q) == \
            jtimeseries.percentile_from_buckets(buckets, counts, q)


def test_exposition_and_registry_snapshots():
    text = _local_exposition()
    assert timeseries.exposition_snapshot(text) == \
        jtimeseries.exposition_snapshot(text)
    # the same instruments, fed the same values, in a private registry
    # on each side
    regs = (jmetrics.Registry(), metrics.Registry())
    for reg in regs:
        reg.counter("c.x").inc(7)
        reg.gauge("g.y").set(2.5)
        h = reg.histogram("h.z", buckets=(1.0, 10.0))
        for v in (0.5, 3.0, 30.0, 7.0):
            h.observe(v)
    assert timeseries.registry_snapshot(regs[1]) == \
        jtimeseries.registry_snapshot(regs[0])
    assert export.registry_lines(regs[1]) == \
        jexport.registry_lines(regs[0])


def _local_exposition():
    return "\n".join([
        "# TYPE paddle_tpu_serving_ttft_ms histogram",
        'paddle_tpu_serving_ttft_ms_bucket{le="10"} 4',
        'paddle_tpu_serving_ttft_ms_bucket{le="100"} 9',
        'paddle_tpu_serving_ttft_ms_bucket{le="+Inf"} 10',
        "paddle_tpu_serving_ttft_ms_sum 123.5",
        "paddle_tpu_serving_ttft_ms_count 10",
        "# TYPE paddle_tpu_fleet_router_rejected gauge",
        "paddle_tpu_fleet_router_rejected 2",
        'paddle_tpu_serving_slo_ttft_ms{replica="0",q="p99"} 0.1',
        'paddle_tpu_serving_slo_running{replica="0"} 3'])


# -- obs.anomaly, utils.envspec -----------------------------------------------


def _steps():
    rng = np.random.RandomState(2)
    out = []
    for s in range(1, 121):
        loss = 3.0 - 0.01 * s + 0.01 * rng.randn()
        if s == 60:
            loss = 40.0
        if 70 <= s < 75:
            loss = float("nan")
        out.append({"step": s, "loss": loss,
                    "skipped": 70 <= s < 75,
                    "step_ms": 100.0 + (400.0 if 90 <= s < 96 else 0.0)
                    + rng.rand(),
                    "dl_wait_ms": 80.0 if 100 <= s < 110 else 1.0})
    return out


@pytest.mark.parametrize("spec", [
    "", "loss_spike:factor=4;loss_plateau:window=20,rel_eps=0.05",
    "throughput_drop:factor=2;dataloader_starvation:ratio=0.3", "off"])
def test_anomaly_detectors_on_the_same_records(spec):
    jeng = janomaly.AnomalyEngine(janomaly.default_detectors(spec))
    peng = anomaly.AnomalyEngine(anomaly.default_detectors(spec))
    for rec in _steps():
        assert peng.observe(dict(rec)) == jeng.observe(dict(rec))
    assert peng.fired == jeng.fired
    assert bool(peng.fired) == (spec != "off")
    with pytest.raises(KeyError):
        anomaly.default_detectors("no_such_detector")
    assert [d.name for d in anomaly.serving_detectors("loss_spike")] == \
        [d.name for d in janomaly.serving_detectors("loss_spike")]


@pytest.mark.parametrize("spec", [
    "", "a", "a:x=1,y=2.5;b", " r:at=4 , rank = 1 ;; q:name=z ",
    "replica_kill:at=4,rank=1"])
def test_envspec_grammar(spec):
    assert envspec.parse_spec(spec) == jenvspec.parse_spec(spec)


# -- obs.export ---------------------------------------------------------------


def test_merge_expositions_and_parse():
    a = ("# TYPE paddle_tpu_serving_tokens_generated counter\n"
         "paddle_tpu_serving_tokens_generated 10\n"
         'paddle_tpu_serving_slo_running{replica="0"} 2\n')
    b = ("# TYPE paddle_tpu_serving_tokens_generated counter\n"
         "paddle_tpu_serving_tokens_generated 32\n"
         'paddle_tpu_serving_slo_running{replica="1"} 1\n')
    merged = export.merge_expositions([a, b, _local_exposition()])
    assert merged == jexport.merge_expositions([a, b, _local_exposition()])
    vals = export.parse_prometheus_text(merged)
    assert vals == jexport.parse_prometheus_text(merged)
    assert vals["paddle_tpu_serving_tokens_generated"] == 42.0


def test_exporter_serves_metrics_and_statusz(tmp_path):
    """The port's live exporter over a local fleet: ``/metrics`` scraped
    over HTTP parses equal to ``render()``, ``/statusz?format=json``
    holds the pool's topology, the textfile equals the render."""
    clock = ManualClock()
    pool = fleet.ReplicaPool(
        fleet.ReplicaSpec(vocab_size=32, pages=32, page_size=4,
                          max_seq_len=16, token_budget=64, warm=False,
                          device="cpu"),
        replicas=2, mode="local", clock=clock)
    ev = slo.SLOEvaluator({"availability": 0.99}, clock=clock,
                          interval_s=0.5, include_registry=False)
    router = fleet.Router(pool, clock=clock, slo=ev,
                          autoscale_interval_s=0.5)
    for i in range(4):
        router.submit([1, 2, i], max_new_tokens=3, rid=f"x{i}")
    while router.inflight or router.queue_depth:
        router.step()
        clock.advance(0.25)
    ex = export.MetricsExporter(engines=pool.local_engines(), port=0,
                                router=router, slo=ev)
    port = ex.start()
    try:
        body = export.scrape(f"http://127.0.0.1:{port}/metrics")
        assert export.parse_prometheus_text(body) == \
            export.parse_prometheus_text(ex.render())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/statusz?format=json",
                timeout=10) as r:
            status = json.loads(r.read().decode())
        assert [row["replica"] for row in status["fleet"]] == [0, 1]
        path = str(tmp_path / "m.prom")
        ex.write_textfile(path)
        with open(path) as f:
            assert export.parse_prometheus_text(f.read()) == \
                export.parse_prometheus_text(ex.render())
    finally:
        ex.stop()
        router.close()
