"""tools/torch_serve_bench.py against tools/serve_bench.py, on the CPU.

- ``parse_tenants``, ``make_trace`` and ``_tenant_extras`` give what the
  JAX tool's give for the same arguments, exactly;
- one two-tenant trace replayed on a ``ManualClock`` through the JAX
  package's engine (its Pallas decode kernel in interpret mode) and the
  port's (``device="cpu"``: the paged kernel's plain version), over a
  pool small enough to force preemptions: the same tokens, engine steps
  and preemptions, and the two tools' ``_report`` of the runs equal
  (every latency is a difference of manual-clock times, so exact);
- ``--self-test --device cpu`` passes;
- ``bench_serve_leg`` (``bench.py:bench_serve``'s legs) returns the JAX
  leg's keys but the cold-start leg's, finishes every request with the
  dense oracle's tokens, and meets ``SERVE_SLO_SPEC``.
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from paddle_tpu import serving as jserving
from paddle_tpu_torch import serving
from test_torch_fleet import jax_globals_restored

from torch_test_threads import torch_threads  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jsb = _tool("serve_bench")
tsb = _tool("torch_serve_bench")

TENANTS = "a:rate=75,weight=3;b:rate=25,weight=1"


@pytest.mark.parametrize("spec", [
    TENANTS, "a:rate=30,weight=3;b:rate=10", " x:rate=1.5 ; y:rate=2,"])
def test_parse_tenants_matches_jax(spec):
    assert tsb.parse_tenants(spec) == jsb.parse_tenants(spec)


@pytest.mark.parametrize("bad", ["", "a:weight=2", "a:rate=0",
                                 "a:rate=5,burst=1", ":rate=1"])
def test_parse_tenants_rejects_as_jax(bad):
    with pytest.raises(ValueError):
        jsb.parse_tenants(bad)
    with pytest.raises(ValueError):
        tsb.parse_tenants(bad)


@pytest.mark.parametrize("args", [
    dict(n_requests=48, rate=100.0, tenants=TENANTS),
    dict(n_requests=24, rate=100.0, tenants=TENANTS),
    dict(n_requests=32, rate=50.0, seed=3, vocab=50304),
    dict(n_requests=12, rate=200.0, short_frac=1.0, out_len=(4, 10),
         tenants="a:rate=100,weight=1;b:rate=100,weight=1"),
])
def test_make_trace_matches_jax(args):
    kw = dict(args)
    if "tenants" in kw:
        kw["tenants"] = jsb.parse_tenants(kw["tenants"])
    assert tsb.make_trace(**kw) == jsb.make_trace(**kw)


def test_bench_trace_facts():
    """bench_serve's trace (48 requests at 100 req/s, tenants 3:1)."""
    trace = tsb.make_trace(48, 100.0, tenants=tsb.parse_tenants(TENANTS))
    assert round(trace[-1]["arrival"], 3) == 0.370
    assert sum(r["max_new_tokens"] for r in trace) == 667
    assert sum(len(r["prompt"]) for r in trace) == 644
    assert max(len(r["prompt"]) for r in trace) == 40


def test_tenant_extras_match_jax():
    tn = jsb.parse_tenants("a:rate=30,weight=3;b:rate=10")
    rows = [("a", 60, 1.0, 2.0), ("b", 40, 3.0, 4.0), ("a", 7, 5.5, 9.0),
            ("c", 3, None, None)]
    assert tsb._tenant_extras(rows, tn) == jsb._tenant_extras(rows, tn)
    assert tsb._tenant_extras(rows[:1], {"a": tn["a"]}) == \
        jsb._tenant_extras(rows[:1], {"a": tn["a"]})


def _replay(pkg, sb, trace, tenants):
    """The trace through one package's engine on a ManualClock: 10
    pages of 8 force preemptions."""
    clock = pkg.ManualClock()
    kw = {} if pkg is jserving else {"device": "cpu"}
    model = pkg.TinyLM(vocab_size=32, num_heads=2, head_dim=8, seed=0, **kw)
    cache = pkg.PagedKVCache(10, 8, 2, 8, **kw)
    eng = pkg.ServeEngine(model, cache, scheduler=pkg.Scheduler(
        cache, token_budget=64, clock=clock))
    reqs = tsb.replay_manual(eng, clock, trace, step_s=0.004)
    return eng, reqs, sb._report(eng, clock.now, len(trace),
                                 tenants=tenants)


def test_manual_clock_trace_matches_jax_engine():
    tenants = tsb.parse_tenants(TENANTS)
    trace = tsb.make_trace(10, 100.0, short_frac=1.0, out_len=(4, 12),
                           tenants=tenants)
    # the JAX engine's registry, replica ids and metrics are put back
    # for the JAX package's tests that share this worker
    with jax_globals_restored():
        jeng, jreqs, jrep = _replay(jserving, jsb, trace, tenants)
    teng, treqs, trep = _replay(serving, tsb, trace, tenants)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    assert teng.stats()["steps"] == jeng.stats()["steps"]
    assert trep["preemptions"] >= 1      # the pressure path ran
    assert trep["finished"] == 10
    assert trep == jrep
    for r, t in zip(treqs, trace):
        assert r.generated == teng.model.reference_generate(
            t["prompt"], t["max_new_tokens"])


def test_self_test_passes_on_the_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_serve_bench.py"),
         "--self-test", "--device", "cpu"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "self-test passed" in out.stdout


# bench.py:bench_serve's keys (:339-350, :370, :441-444, :454-461) but
# the cold-start leg's (cold_start_ms, warm_start_ms, aot_hits)
BENCH_SERVE_KEYS = {
    "tokens_per_sec", "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
    "tpot_p99_ms", "requests", "finished", "preemptions",
    "kv_fragmentation", "tenant_share_err", "slo_violations",
    "export_scrape_ms", "export_gauge_ok", "replicas",
    "router_overhead_ms", "fleet_tokens_per_sec", "fleet_ttft_p99_ms",
    "fleet_requeued", "fleet_tenant_share_err"}


def test_bench_serve_leg_on_the_cpu():
    detail = {}
    out = tsb.bench_serve_leg(device="cpu", detail=detail)
    assert set(out) == BENCH_SERVE_KEYS
    assert out["requests"] == out["finished"] == 48
    assert out["slo_violations"] == [] and out["export_gauge_ok"] is True
    assert out["replicas"] == 2
    eng, fleet = detail["engine"], detail["fleet"]
    assert (eng["rejected"], eng["stuck"]) == (0, 0)
    assert (fleet["finished"], fleet["rejected"], fleet["stuck"]) == \
        (24, 0, 0)
    model = serving.TinyLM(vocab_size=32, num_heads=2, head_dim=8, seed=0,
                           device="cpu")
    runs = detail["requests"] + detail["tokens"]
    assert len(runs) == 48 + 24
    for prompt, new, tokens in runs:
        assert tokens == model.reference_generate(prompt, new)
    steps = detail["decode_steps"]
    assert steps["engine"] > 0 and steps["export"] > 0
    assert len(steps["fleet"]) == 2 and all(steps["fleet"])
    print(json.dumps(out))
