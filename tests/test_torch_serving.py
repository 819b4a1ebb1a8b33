"""paddle_tpu_torch.serving against paddle_tpu.serving, on the CPU.

The same request trace, with the same weights (carried from the JAX
``TinyLM`` by ``convert.tinylm_params_from_jax``) and the same
deterministic clock, goes through the JAX engine (its Pallas decode
kernel in interpret mode, as ``auto_interpret`` picks on the CPU) and
the port's engine (``device="cpu"``, so the paged kernel's plain
version). The two must agree exactly where the contract is discrete —
generated tokens, preemption counts, finish order, page accounting,
usage integrals, journal records — and to 1e-5 (atol and rtol) on
float32 activations, where only summation order differs.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import serving as jserving
from paddle_tpu.resilience import policy as jpolicy
from paddle_tpu.obs import journal as jjournal
from paddle_tpu.obs import trace as jtrace
from paddle_tpu.obs import usage as jusage
from paddle_tpu.obs.usage import TickingClock as JTickingClock
from paddle_tpu_torch import convert
from paddle_tpu_torch.obs import journal, lockdep, trace, usage
from paddle_tpu_torch.obs.usage import TickingClock
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.resilience import inject, policy
from paddle_tpu_torch.serving import (CANCELLED, FINISHED, ManualClock,
                                      PagedKVCache, Scheduler, ServeEngine,
                                      TinyLM, live_engines, write_tokens)

ACT_TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_global_journals():
    yield
    for mod in (journal, jjournal):
        if mod.ACTIVE is not None:
            mod.ACTIVE.close()
        mod.ACTIVE = None


def _jax_params(model):
    return {k: np.asarray(getattr(model, k)) for k in TinyLM.PARAMS}


class _Rows:
    """``sample_fn`` that keeps every logits row it is given (in emit
    order) and picks the argmax as the engines' default does."""

    def __init__(self):
        self.rows = []

    def __call__(self, row):
        row = np.array(row, np.float32)
        self.rows.append(row)
        return int(np.argmax(row))


def _engines(pages=6, page_size=4, max_seq_len=16, budget=64, vocab=32,
             ticking=True, seed=0):
    """One JAX and one port engine of the ``_pressured_engine`` geometry
    of tests/test_serving.py, same weights, clocks in lockstep. Each
    engine's ``sample_fn`` (a ``_Rows``) keeps the logits it chose from:
    tokens alone barely depend on attention in this model (the tied
    embedding's residual dominates the argmax), its logits do."""
    jm = jserving.TinyLM(vocab_size=vocab, num_heads=2, head_dim=8,
                         seed=seed)
    tm = TinyLM(vocab_size=vocab, num_heads=2, head_dim=8, seed=seed + 1,
                device="cpu")
    tm.load_state_dict(convert.tinylm_params_from_jax(_jax_params(jm)))
    out = []
    for pkg, model, clock in (
            (jserving, jm, JTickingClock() if ticking else
             jserving.ManualClock()),
            (None, tm, TickingClock() if ticking else ManualClock())):
        if pkg is None:
            cache = PagedKVCache(pages, page_size, 2, 8,
                                 max_seq_len=max_seq_len, device="cpu")
            eng = ServeEngine(model, cache, scheduler=Scheduler(
                cache, token_budget=budget, clock=clock), sample_fn=_Rows())
        else:
            cache = pkg.PagedKVCache(pages, page_size, 2, 8,
                                     max_seq_len=max_seq_len)
            eng = pkg.ServeEngine(model, cache, scheduler=pkg.Scheduler(
                cache, token_budget=budget, clock=clock), sample_fn=_Rows())
        out.append((eng, clock))
    return out


def _submit_both(engines, prompts, max_new, gap=0.01, **kw):
    reqs = ([], [])
    for i, prompt in enumerate(prompts):
        for side, (eng, clock) in enumerate(engines):
            reqs[side].append(eng.submit(prompt, max_new_tokens=max_new,
                                         rid=f"r{i}", **kw))
        for _, clock in engines:
            clock.advance(gap)
    return reqs


def _stats(eng):
    st = eng.stats()
    st["usage"] = dict(st["usage"], replica=None)
    return st


def _run_lockstep(engines, max_steps=300):
    """Step both engines together; their stats must agree every step,
    and every logits row they chose a token from must agree."""
    (je, jc), (te, tc) = engines
    for _ in range(max_steps):
        if je.scheduler.idle and te.scheduler.idle:
            break
        jb, tb = je.step(), te.step()
        assert [r.rid for r in jb.prefills] == [r.rid for r in tb.prefills]
        assert [r.rid for r in jb.decodes] == [r.rid for r in tb.decodes]
        assert _stats(je) == _stats(te)
        jc.advance(0.01)
        tc.advance(0.01)
    assert je.scheduler.idle and te.scheduler.idle
    jrows, trows = je.sample_fn.rows, te.sample_fn.rows
    assert len(trows) == len(jrows) > 0
    np.testing.assert_allclose(np.stack(trows), np.stack(jrows),
                               atol=ACT_TOL, rtol=ACT_TOL)


# -- model + weights ---------------------------------------------------------


class TestTinyLM:
    def test_seeded_weights_equal_the_jax_models(self):
        jm = jserving.TinyLM(vocab_size=40, num_heads=3, head_dim=4,
                             seed=7)
        tm = TinyLM(vocab_size=40, num_heads=3, head_dim=4, seed=7,
                    device="cpu")
        carried = convert.tinylm_params_from_jax(_jax_params(jm))
        state = tm.state_dict()
        assert list(state) == list(TinyLM.PARAMS)
        for k in TinyLM.PARAMS:
            assert torch.equal(state[k], carried[k]), k
            assert not state[k].requires_grad

    def test_convert_rejects_bad_params(self):
        jm = jserving.TinyLM(seed=0)
        params = _jax_params(jm)
        with pytest.raises(ValueError, match="expected arrays"):
            convert.tinylm_params_from_jax(dict(params, extra=params["wq"]))
        with pytest.raises(ValueError, match="wo has shape"):
            convert.tinylm_params_from_jax(
                dict(params, wo=params["wo"][:, :3]))

    def test_forward_matches_jax(self):
        jm = jserving.TinyLM(seed=1)
        tm = TinyLM(seed=1, device="cpu")
        ids = np.random.RandomState(0).randint(0, 32, 9)
        jout = jm.qkv(jnp.asarray(ids, jnp.int32))
        with torch.inference_mode():
            tout = tm.qkv(torch.from_numpy(ids).long())
            tlog = tm.head(tout[3], tout[0])
        for a, b in zip(jout, tout):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       atol=ACT_TOL, rtol=ACT_TOL)
        np.testing.assert_allclose(tlog.numpy(),
                                   np.asarray(jm.head(jout[3], jout[0])),
                                   atol=ACT_TOL, rtol=ACT_TOL)

    @pytest.mark.parametrize("seed", [0, 5])
    def test_dense_oracle_matches_jax(self, seed):
        jm = jserving.TinyLM(seed=seed)
        tm = TinyLM(seed=seed, device="cpu")
        prompt = list(np.random.RandomState(seed).randint(0, 32, 11))
        assert tm.reference_generate(prompt, 8) == \
            jm.reference_generate(prompt, 8)


# -- kv cache ----------------------------------------------------------------


class TestPagedKVCache:
    def test_pools_are_torch_tensors_on_the_requested_device(self):
        c = PagedKVCache(9, 4, 2, 8, dtype="bfloat16", device="cpu")
        assert c.k_pages.shape == (1, 9, 4, 2, 8)
        assert c.k_pages.dtype == torch.bfloat16
        assert c.k_pages.device.type == "cpu"
        assert c.page_bytes == 2 * 4 * 2 * 8 * 2
        with pytest.raises(ValueError, match="unsupported dtype"):
            PagedKVCache(9, 4, 2, 8, dtype="float16", device="cpu")

    def test_write_tokens_matches_jax_scatter_in_place(self):
        rng = np.random.RandomState(0)
        k0 = rng.randn(1, 8, 4, 2, 3).astype(np.float32)
        v0 = rng.randn(1, 8, 4, 2, 3).astype(np.float32)
        kn = rng.randn(3, 2, 3).astype(np.float32)
        vn = rng.randn(3, 2, 3).astype(np.float32)
        pages = np.array([5, 2, 7], np.int32)
        offs = np.array([0, 3, 1], np.int32)
        jk, jv = jserving.write_tokens(
            jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(kn),
            jnp.asarray(vn), jnp.asarray(pages), jnp.asarray(offs))
        tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
        rk, rv = write_tokens(tk, tv, torch.from_numpy(kn),
                              torch.from_numpy(vn), torch.from_numpy(pages),
                              torch.from_numpy(offs))
        assert rk is tk and rv is tv                   # in place
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    def test_set_pools_is_the_only_checked_swap(self):
        c = PagedKVCache(4, 4, 1, 2, device="cpu")
        k, v = torch.ones_like(c.k_pages), torch.ones_like(c.v_pages)
        c.set_pools(k, v)
        assert c.k_pages is k and c.v_pages is v
        with pytest.raises(ValueError, match="pool must be"):
            c.set_pools(k[:, :2], v)
        with pytest.raises(ValueError, match="pool must be"):
            c.set_pools(k.double(), v)

    def test_allocator_matches_jax_cache(self):
        jc = jserving.PagedKVCache(9, 4, 2, 8)
        tc = PagedKVCache(9, 4, 2, 8, device="cpu")
        for c in (jc, tc):
            c.clock = ManualClock()
        ops = [("alloc", "a", 5), ("alloc", "b", 4), ("extend", "a", 1),
               ("extend", "a", 3), ("free", "b"), ("alloc", "c", 9),
               ("extend", "c", 4), ("free", "a")]
        for op in ops:
            outs = [getattr(c, op[0])(*op[1:]) for c in (jc, tc)]
            assert outs[0] == outs[1], op
            for c in (jc, tc):
                c.clock.advance(0.5)
            assert jc.stats() == tc.stats()
            assert jc.page_usage() == tc.page_usage()
        np.testing.assert_array_equal(
            jc.padded_page_tables(["c"], width=4),
            tc.padded_page_tables(["c"], width=4))
        assert [a.tolist() for a in jc.write_slots(["c"])] == \
            [a.tolist() for a in tc.write_slots(["c"])]
        assert jc.verify() and tc.verify()


# -- the slice: the same trace through both engines --------------------------


class TestEngineMatchesJaxEngine:
    def test_same_tokens_on_the_oracle_trace(self):
        engines = _engines(pages=64, max_seq_len=64)
        rng = np.random.RandomState(1)
        prompts = [list(rng.randint(0, 32, rng.randint(3, 20)))
                   for _ in range(5)]
        jreqs, treqs = _submit_both(engines, prompts, 10)
        _run_lockstep(engines)
        for j, t in zip(jreqs, treqs):
            assert t.state == FINISHED and t.generated == j.generated
        te = engines[1][0]
        for t, prompt in zip(treqs, prompts):
            assert t.generated == te.model.reference_generate(prompt, 10)
        assert te.cache.verify() and te.usage.verify()

    def test_same_tokens_under_forced_preemption(self):
        engines = _engines()               # 6 pages of 4: pressure
        rng = np.random.RandomState(2)
        prompts = [list(rng.randint(0, 32, 5)) for _ in range(3)]
        jreqs, treqs = _submit_both(engines, prompts, 8)
        _run_lockstep(engines)
        (je, _), (te, _) = engines
        assert te.scheduler.preemptions >= 1
        assert te.scheduler.preemptions == je.scheduler.preemptions
        assert [r.rid for r in te.finished] == [r.rid for r in je.finished]
        assert [r.rid for r in te.finished] == [r.rid for r in treqs]
        for j, t in zip(jreqs, treqs):
            assert t.generated == j.generated
            assert t.preemptions == j.preemptions
            assert t.preempt_ts == j.preempt_ts
            assert t.resume_ts == j.resume_ts
        for t, prompt in zip(treqs, prompts):
            assert t.generated == te.model.reference_generate(prompt, 8)
        assert te.cache.stats() == je.cache.stats()
        assert te.cache.stats()["used_pages"] == 0 and te.cache.verify()
        assert te.cache.page_usage() == je.cache.page_usage()
        # usage telescopes: busy == sum over tenants == sum over requests
        assert te.usage.verify()
        assert te.usage.busy_ns == sum(te.usage.device_ns.values()) > 0
        assert te.usage.snapshot()["device_ns"] == \
            je.usage.snapshot()["device_ns"]

    def test_chaos_killed_request_leaks_nothing(self):
        engines = _engines(pages=16, ticking=False)
        jreqs, treqs = _submit_both(
            engines, [[1, 2, 3, 4, 5], [6, 7, 8]], 8, gap=0.0)
        for eng, _ in engines:
            eng.step()                               # both prefilled
        for (eng, _), reqs in zip(engines, (jreqs, treqs)):
            eng.cancel(reqs[0])
            assert reqs[0].state == CANCELLED
            eng.cancel(reqs[0])                      # idempotent
        _run_lockstep(engines, max_steps=50)
        assert treqs[1].state == FINISHED
        assert treqs[1].generated == jreqs[1].generated
        st = engines[1][0].cache.stats()
        assert st["used_pages"] == 0 and st["sequences"] == 0
        assert engines[1][0].cache.verify()

    def test_eos_stops_decode(self):
        engines = _engines(pages=64, max_seq_len=64)
        te = engines[1][0]
        ref = te.model.reference_generate([3, 1, 4], 10)
        eos = ref[3]
        jreqs, treqs = _submit_both(engines, [[3, 1, 4]], 10, eos_id=eos)
        _run_lockstep(engines)
        assert treqs[0].generated == jreqs[0].generated == \
            ref[:ref.index(eos) + 1]

    def test_journal_records_match_the_jax_schema(self, tmp_path):
        engines = _engines()
        rng = np.random.RandomState(2)
        prompts = [list(rng.randint(0, 32, 5)) for _ in range(3)]
        recs = []
        for (eng, clock), mod, d in ((engines[0], jjournal, "jax"),
                                     (engines[1], journal, "torch")):
            mod.start_run(str(tmp_path / d))
            for i, prompt in enumerate(prompts):
                eng.submit(prompt, max_new_tokens=8, rid=f"r{i}",
                           tenant="t1" if i % 2 else None)
                clock.advance(0.01)
            eng.run(max_steps=300)
            mod.end_run()
            with open(tmp_path / d / mod.JOURNAL_FILE) as f:
                recs.append([json.loads(line) for line in f])
        jrecs, trecs = recs

        def requests(rs):
            return [{k: v for k, v in r.items()
                     if k not in ("ts", "replica")}
                    for r in rs if r["t"] == "request"]

        assert requests(trecs) == requests(jrecs)
        assert len(requests(trecs)) == 3

        def kinds(rs):
            return [r["kind"] for r in rs if r["t"] == "event"
                    and r["kind"] != "backend"]

        assert kinds(trecs) == kinds(jrecs)
        # the chargeback table rebuilds identically from either journal,
        # and matches the live per-tenant rollup of the port's engine
        treqs = [r for r in trecs if r["t"] == "request"]
        assert usage.rollup_requests(treqs) == jusage.rollup_requests(
            [r for r in jrecs if r["t"] == "request"])
        live = usage.engine_tenant_usage(engines[1][0])
        jlive = jusage.engine_tenant_usage(engines[0][0])
        assert {k: v for k, v in live.items() if k != "replica"} == \
            {k: v for k, v in jlive.items() if k != "replica"}
        merged = usage.merge_tenant_rollups([usage.rollup_requests(treqs)])
        assert {t: s["device_ns"] for t, s in merged.items()} == \
            {t: s["device_ns"] for t, s in live["tenants"].items()}
        backend = [r for r in trecs if r.get("kind") == "backend"]
        assert len(backend) == 1 and backend[0]["backend"] in ("cpu",
                                                               "cuda")
        assert trecs[-1]["t"] == "run_end"
        assert trecs[-1]["summary"]["requests"] == 3


# -- the port engine on its own ----------------------------------------------


def _port_engine(pages=6, page_size=4, max_seq_len=16, budget=64,
                 **kw):
    model = TinyLM(vocab_size=32, num_heads=2, head_dim=8, seed=0,
                   device="cpu")
    cache = PagedKVCache(pages, page_size, 2, 8, max_seq_len=max_seq_len,
                         device="cpu")
    clock = ManualClock()
    eng = ServeEngine(model, cache, scheduler=Scheduler(
        cache, token_budget=budget, clock=clock), **kw)
    return model, cache, clock, eng


class TestPortEngine:
    def test_matches_its_own_oracle_and_counts_no_launch_on_cpu(self):
        model, cache, clock, eng = _port_engine(pages=64, max_seq_len=64)
        rng = np.random.RandomState(3)
        pairs = []
        for _ in range(6):
            prompt = list(rng.randint(0, 32, rng.randint(2, 30)))
            pairs.append((eng.submit(prompt, max_new_tokens=9), prompt))
            clock.advance(0.01)
        kernels.reset_launches()
        eng.run()
        assert kernels.launches() == dict.fromkeys(kernels.KERNELS, 0)
        assert eng.usage.decode_steps > 0
        for r, prompt in pairs:
            assert r.generated == model.reference_generate(prompt, 9)
        st = eng.stats()
        assert st["finished"] == 6 and st["kv"]["used_pages"] == 0
        assert st["compiles"] == len(eng._shapes) > 1

    def test_registered_as_a_live_engine(self):
        model, cache, clock, eng = _port_engine()
        assert any(e is eng for e in live_engines())

    def test_retry_call_retries_transient_errors_within_budget(self):
        model, cache, clock, eng = _port_engine()
        pol = eng.policy                 # what page-pressure relief uses
        assert isinstance(pol, policy.RecoveryPolicy)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise policy.TransientError("pressure")
            return "ok"

        assert policy.retry_call(flaky, pol) == ("ok", 3)
        with pytest.raises(policy.TransientError):
            policy.retry_call(lambda: (_ for _ in ()).throw(
                policy.TransientError("always")), pol)

    def test_sample_fn_picks_the_token(self):
        model, cache, clock, eng = _port_engine(
            pages=64, max_seq_len=64, sample_fn=lambda row: 7)
        r = eng.submit([1, 2, 3], max_new_tokens=4)
        eng.run()
        assert r.generated == [7, 7, 7, 7]

    def test_rejects_mismatched_geometry_and_scheduler(self):
        model = TinyLM(num_heads=2, head_dim=8, device="cpu")
        with pytest.raises(ValueError, match="geometry"):
            ServeEngine(model, PagedKVCache(8, 4, 2, 4, device="cpu"))
        a = PagedKVCache(8, 4, 2, 8, device="cpu")
        b = PagedKVCache(8, 4, 2, 8, device="cpu")
        with pytest.raises(ValueError, match="different PagedKVCache"):
            ServeEngine(model, a, scheduler=Scheduler(b))
        with pytest.raises(ValueError, match="max_seq_len"):
            ServeEngine(model, a).submit([1] * 40, max_new_tokens=2)

    def test_lock_order_holds_under_lockdep(self):
        lockdep.reset()
        lockdep.enable("raise")
        try:
            model, cache, clock, eng = _port_engine()
            for i in range(3):
                eng.submit([1 + i, 2, 3, 4, 5], max_new_tokens=8)
                clock.advance(0.01)
            eng.run(max_steps=300)
            assert eng.scheduler.preemptions >= 1
            graph = lockdep.order_graph()
        finally:
            lockdep.disable()
            lockdep.reset()
        assert not lockdep.violations()
        assert "serving.scheduler" in graph["serving.engine.step"]
        assert "serving.kv_cache" in graph["serving.scheduler"]
        assert "serving.engine.step" not in graph.get("serving.kv_cache",
                                                      [])

    def test_replica_kill_point_is_gated_by_replica(self):
        model, cache, clock, eng = _port_engine(pages=64, max_seq_len=64)
        eng.submit([1, 2, 3], max_new_tokens=3)
        with inject.chaos("replica_kill", rank=eng.replica_id + 1) as inj:
            eng.run()
        assert inj.fired == 0 and not inject.ACTIVE
        with pytest.raises(KeyError, match="unknown chaos point"):
            with inject.chaos("nan_op"):    # not ported: no dispatch hook
                pass


# -- the copied host-side pieces agree with the JAX package's ----------------


class _StubRouter:
    """Just the router state the usage readers pull (no fleet yet)."""

    class _Done:
        def __init__(self, tenant, state, prompt, tokens, t0, pre):
            self.tenant, self.state, self.prompt = tenant, state, prompt
            self.tokens, self.preemptions = tokens, pre
            self.arrival_t, self.admit_t = t0, t0 + 0.5
            self.first_token_t, self.finish_t = t0 + 1.0, t0 + 3.0

    class _Policy:
        def __init__(self, weight):
            self.weight = weight

    def __init__(self):
        self._served = {"a": 30.0, "b": 10.0}
        self._queues = {"a": [], "b": [1, 2], "c": [3]}
        self._rejected_by_tenant = {"c": 2}
        self._rate_holds_by_tenant = {"b": 1}
        self._requeued_by_tenant = {"a": 1}
        self.completed = [
            self._Done("a", "FINISHED", [1, 2, 3], [4, 5], 0.0, 1),
            self._Done("b", "FINISHED", [1], [2, 3, 4], 1.0, 0),
            self._Done("a", "CANCELLED", [7], [], 2.0, 0)]

    def _policy(self, tenant):
        return self._Policy({"a": 1.0, "b": 3.0}.get(tenant, 1.0))


def test_router_rollup_and_fairness_audit_match_jax():
    router = _StubRouter()
    got = usage.router_tenant_usage(router)
    assert got == jusage.router_tenant_usage(router)
    assert usage.fairness_audit(got["tenants"]) == \
        jusage.fairness_audit(got["tenants"])
    assert usage.fairness_record(router) == jusage.fairness_record(router)
    assert usage.fairness_audit(got["tenants"])["ok"] is False


def test_trace_events_match_jax():
    assert trace.flow_start("req", 3, 1, 2, 10.5, rid="r") == \
        jtrace.flow_start("req", 3, 1, 2, 10.5, rid="r")
    assert trace.flow_finish("req", 3, 1, 2, 11.0) == \
        jtrace.flow_finish("req", 3, 1, 2, 11.0)
    was = trace.tracing_enabled()
    trace.enable_tracing()
    try:
        trace.clear_trace()
        with trace.span("serving.step", decodes=2):
            pass
        trace.device_counter(0, "hbm_bytes", 5.0, label="gpu 0")
        assert [e["name"] for e in trace.trace_events()] == \
            ["serving.step"]
    finally:
        if not was:
            trace.disable_tracing()
        trace.clear_trace()


def test_recovery_policy_matches_jax():
    for kw in ({}, {"jitter": 0.5, "jitter_seed": 3, "backoff": 0.1}):
        a, b = policy.RecoveryPolicy(**kw), jpolicy.RecoveryPolicy(**kw)
        assert [a.backoff_for(i) for i in range(5)] == \
            [b.backoff_for(i) for i in range(5)]
    for bad in ({"on_nonfinite": "ignore"}, {"jitter": 2.0}):
        with pytest.raises(ValueError):
            policy.RecoveryPolicy(**bad)


# -- device resolution and the JAX-free import -------------------------------


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        assert TinyLM().embedding.device.type == "cuda"
        assert PagedKVCache(4, 4, 1, 2).k_pages.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TinyLM()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(4, 4, 1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TinyLM(device="cuda:0")
    assert TinyLM(device="cpu").embedding.device.type == "cpu"


_JAX_FREE = r"""
import sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")) or \
                name == "paddle_tpu" or name.startswith("paddle_tpu."):
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, _Refuse())
sys.path.insert(0, sys.argv[1])
import numpy as np
import paddle_tpu_torch
from paddle_tpu_torch import convert, obs, resilience
from paddle_tpu_torch.serving import (ManualClock, PagedKVCache,
                                      Scheduler, ServeEngine, TinyLM)
model = TinyLM(device="cpu")
cache = PagedKVCache(6, 4, 2, 8, max_seq_len=16, device="cpu")
clock = ManualClock()
eng = ServeEngine(model, cache, scheduler=Scheduler(cache, 64, clock=clock))
reqs = [eng.submit([1 + i, 2, 3, 4, 5], max_new_tokens=8)
        for i in range(3)]
eng.run(max_steps=300)
assert eng.scheduler.preemptions >= 1
for i, r in enumerate(reqs):
    assert r.generated == model.reference_generate([1 + i, 2, 3, 4, 5], 8)
assert cache.verify()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
print("JAX-FREE OK")
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _JAX_FREE, REPO],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX-FREE OK" in out.stdout
