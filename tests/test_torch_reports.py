"""The port's report tools (``tools/torch_{run,fleet,request,slo,usage}
_report.py``) and ``obs/report.py`` against the JAX package's.

- The same journal directories, written by the JAX package's own fixture
  writers (each JAX tool's ``_write_*`` or fixture function, through the
  JAX ``RunJournal``), give the same ``--json`` output, and the same
  ``--diff`` output and exit code, from the JAX tool and from the
  port's: the five tools read journals alike. The one field left out is
  the fleet report's ``heartbeat_age_s``, each rank's age at the time
  of rendering.
- Journals the port writes on the CPU render: a static ``Executor``'s
  ``run`` and ``run_steps`` and a ``Predictor``'s ``run`` (one step
  record each, ``steps_fused`` on the window, the Predictor's batch as
  its examples), and a ``ServeEngine`` trace, which the usage report
  bills as the JAX engine's run of the same trace on the same
  ``TickingClock``: the same tokens and device and page nanoseconds per
  tenant, exactly.
- Each port tool's ``--self-test`` passes on the CPU; the fleet
  report's hang drill raises ``NotImplementedError`` naming ROADMAP
  Queue 1 item 6d.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from test_torch_fleet import jax_globals_restored

from torch_test_threads import torch_threads  # noqa: F401,E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _jax_globals():
    """The JAX package's journal, metrics, engine registry and counters
    put back after each test, as ``tests/test_torch_fleet.py`` does."""
    with jax_globals_restored():
        yield


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_report_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return {n: (_tool(f"{n}_report"), _tool(f"torch_{n}_report"))
            for n in ("run", "fleet", "request", "slo", "usage")}


def _both(capsys, pair, argv):
    """``(rc, stdout)`` of the JAX tool's ``main(argv)`` and the port's."""
    out = []
    for mod in pair:
        rc = mod.main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


# read against the wall clock at render time, not from the journal
NOW = ("heartbeat_age_s",)


def _stable(rep):
    if isinstance(rep, dict):
        return {k: _stable(v) for k, v in rep.items() if k not in NOW}
    if isinstance(rep, list):
        return [_stable(v) for v in rep]
    return rep


def _same_json(capsys, pair, argv):
    (jrc, jout), (trc, tout) = _both(capsys, pair, argv)
    assert trc == jrc
    assert _stable(json.loads(tout)) == _stable(json.loads(jout))
    return json.loads(tout), trc


# -- the same journals, written by the JAX package ----------------------------


def test_run_report_reads_the_jax_journals_alike(tools, tmp_path, capsys):
    jtool = tools["run"][0]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jtool._write_run(a, [0.93 ** i for i in range(30)], step_ms=10.0,
                     comm_bytes=1 << 20, plan_bytes=(100_000, 101_000),
                     memory_bytes=(1_000_000, 980_000), aot=(2, 0))
    jtool._write_run(b, [0.95 ** i for i in range(30)], step_ms=14.0,
                     comm_bytes=3 << 20, plan_bytes=(100_000, 200_000),
                     memory_bytes=(1_000_000, 800_000), aot=(0, 2),
                     nonfinite_at=(7,), gate_failures=("lost donation",))
    rep, _ = _same_json(capsys, tools["run"], [a, "--json"])
    assert rep["steps"]
    diff, rc = _same_json(capsys, tools["run"], ["--diff", a, b, "--json"])
    assert rc == 1 and diff["regression"]
    (_, jtext), (_, ttext) = _both(capsys, tools["run"], [a])
    assert ttext == jtext


def test_fleet_report_reads_the_jax_journals_alike(tools, tmp_path, capsys):
    jtool = tools["fleet"][0]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for rank, ms in ((0, 10.0), (1, 10.0)):
        jtool._write_rank(a, rank, ms, requests=(100.0, 200.0),
                          tenant="t0")
    for rank, ms in ((0, 10.0), (1, 20.0)):
        jtool._write_rank(b, rank, ms, requests=(300.0, 400.0))
    _same_json(capsys, tools["fleet"], [a, "--json"])
    diff, rc = _same_json(capsys, tools["fleet"],
                          ["--diff", a, b, "--json"])
    assert rc == 1


def test_request_report_reads_the_jax_journals_alike(tools, tmp_path,
                                                     capsys):
    run = str(tmp_path / "routed")
    failures = []
    tools["request"][0]._test_routed_fixture(
        failures, run, str(tmp_path / "jax_trace.json"))
    assert failures == []
    rep, _ = _same_json(capsys, tools["request"], [run, "--json"])
    assert rep
    (_, jtext), (_, ttext) = _both(capsys, tools["request"],
                                   [run, "--worst", "1", "--key", "e2e_ms"])
    assert ttext == jtext


def test_slo_report_reads_the_jax_journals_alike(tools, tmp_path, capsys):
    from paddle_tpu.serving import ManualClock

    run = str(tmp_path / "burn")
    tools["slo"][0]._burn_fixture(run, ManualClock())
    rep, _ = _same_json(capsys, tools["slo"], [run, "--json"])
    assert rep["slo"]["timeline"]
    _same_json(capsys, tools["slo"],
               [run, "--json", "--spec", '{"availability": 0.99}'])
    _same_json(capsys, tools["slo"], ["--diff", run, run, "--json"])


def _usage_fixture(path, share_a, ttft_a):
    """The JAX usage tool's fairness fixture (``tools/usage_report.py``
    ``_selftest_fairness``), through the JAX ``RunJournal``."""
    from paddle_tpu.obs import journal as J

    j = J.RunJournal(path, flush_every=1, compute_flops=False)
    j.start()
    for i in range(4):
        for tenant, ttft in (("a", ttft_a), ("b", 0.1)):
            j.record_request(
                rid=f"r{tenant}{i}", state="FINISHED", tenant=tenant,
                arrival_t=0.0, admit_t=0.01, first_token_t=ttft,
                finish_t=0.5, prompt_tokens=4, output_tokens=4,
                device_ns=1_000_000 + i, page_ns=2_000_000 + 7 * i)
    j.event("tenant.summary", served_total=100, tenants={
        "a": {"share": share_a, "weight_share": 0.25,
              "served_tokens": 100 * share_a},
        "b": {"share": 1 - share_a, "weight_share": 0.75,
              "served_tokens": 100 * (1 - share_a)}})
    j.close()


def test_usage_report_reads_the_jax_journals_alike(tools, tmp_path, capsys):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _usage_fixture(a, 0.25, 0.1)
    _usage_fixture(b, 0.5, 0.2)
    rep, _ = _same_json(capsys, tools["usage"], [a, "--json"])
    assert set(rep["tenants"]) == {"a", "b"}
    diff, rc = _same_json(capsys, tools["usage"],
                          ["--diff", a, b, "--json"])
    assert rc == 1
    (_, jtext), (_, ttext) = _both(capsys, tools["usage"], [b])
    assert ttext == jtext


# -- journals the port writes -------------------------------------------------


def _static_program():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optim
    from paddle_tpu_torch.static_ import program as tprog
    from paddle_tpu_torch.utils import unique_name

    scope = tprog.Scope()
    with unique_name.guard(), pt.static.scope_guard(scope):
        pt.enable_static()
        try:
            main = pt.static.Program()
            with pt.program_guard(main, pt.static.Program()):
                x = pt.static.data("x", [8, 4], "float32")
                y = pt.static.data("y", [8, 1], "float32")
                lin = nn.Linear(4, 1, device="cpu")
                pred = lin(x)
                d = pred - y
                loss = (d * d).mean()
                optim.SGD(0.1, parameters=[]).minimize(loss)
        finally:
            pt.disable_static()
    return main, scope, x, pred, loss


def test_port_executor_and_predictor_journals_render(tools, tmp_path,
                                                    capsys):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.framework import io
    from paddle_tpu_torch.obs import journal

    main, scope, x, pred, loss = _static_program()
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(8, 4).astype("float32"),
            "y": rng.randn(8, 1).astype("float32")}
    run = str(tmp_path / "run")
    exe = pt.static.Executor("cpu")
    with pt.static.scope_guard(scope):
        exe.run(main, feed=feed, fetch_list=[loss])     # no journal
        journal.start_run(run)
        try:
            losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                      for _ in range(3)]
            fused = exe.run_steps(main, feeds=[feed] * 2,
                                  fetch_list=[loss])
            lazy = exe.run(main, feed=feed, fetch_list=[loss],
                           return_numpy=False)
            io.save_inference_model(str(tmp_path / "m"), [x], [pred],
                                    program=main)
            p = inference.Predictor(inference.Config(str(tmp_path / "m"),
                                                     device="cpu"))
            p.run({"x": feed["x"][:5]})
        finally:
            journal.end_run()
    assert isinstance(lazy[0], torch.Tensor)
    rec = [json.loads(ln) for ln in open(os.path.join(run,
                                                      "journal.jsonl"))]
    steps = [r for r in rec if r["t"] == "step"]
    assert [s["source"] for s in steps] == ["executor"] * 5 + ["predictor"]
    assert [s["loss"] for s in steps[:3]] == losses
    assert steps[3]["steps_fused"] == 2 and steps[3]["examples"] == 16
    assert steps[3]["loss"] == float(fused[0][-1])
    # a lazy fetch on the host is read as the reference reads host values
    assert steps[4]["loss"] == float(lazy[0])
    assert steps[5]["examples"] == 5 and "flops" not in steps[5]
    compiles = [r for r in rec if r.get("kind") == "compile"]
    # the run's first compile came before the journal: run_steps' only
    assert [c["source"] for c in compiles] == ["executor", "predictor"]
    assert compiles[0]["steps_fused"] == 2
    assert tools["run"][1].main([run]) == 0
    text = capsys.readouterr().out
    assert "steps" in text
    assert tools["run"][1].main([run, "--json"]) == 0
    assert len(json.loads(capsys.readouterr().out)["steps"]) == 6


def _engine_run(jax, run_dir):
    """One trace through the JAX or the port's ``ServeEngine`` on a
    ``TickingClock`` under a journal: two tenants, a pool small enough
    to preempt."""
    if jax:
        from paddle_tpu.obs import journal as J
        from paddle_tpu.obs import usage as U
        from paddle_tpu.serving import (PagedKVCache, Scheduler,
                                        ServeEngine, TinyLM)
        kw = {}
    else:
        from paddle_tpu_torch.obs import journal as J
        from paddle_tpu_torch.obs import usage as U
        from paddle_tpu_torch.serving import (PagedKVCache, Scheduler,
                                              ServeEngine, TinyLM)
        kw = {"device": "cpu"}
    with J.RunJournal(run_dir, flush_every=1,
                      **({"compute_flops": False} if jax else {})):
        clk = U.TickingClock()
        cache = PagedKVCache(7, 4, 2, 8, max_seq_len=24, **kw)
        eng = ServeEngine(TinyLM(**kw), cache, scheduler=Scheduler(
            cache, token_budget=64, clock=clk))
        reqs = [eng.submit(p, max_new_tokens=n, tenant=t)
                for p, n, t in (([3, 1, 4], 6, "a"), ([2, 7], 5, "b"),
                                ([5, 9, 2, 6], 7, "a"), ([1], 4, "b"))]
        eng.run()
    return [list(r.generated) for r in reqs], eng


def test_port_engine_journal_bills_the_reference_trace(tools, tmp_path,
                                                       capsys):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jtok, jeng = _engine_run(True, jdir)
    ttok, teng = _engine_run(False, tdir)
    assert ttok == jtok
    assert teng.scheduler.preemptions == jeng.scheduler.preemptions > 0
    usage = tools["usage"][1]
    got, want = usage.load_usage(tdir), usage.load_usage(jdir)
    assert got["tenants"] and set(got["tenants"]) == {"a", "b"}
    for t, row in want["tenants"].items():
        for k in ("requests", "prompt_tokens", "decode_tokens",
                  "device_ns", "page_ns"):
            assert got["tenants"][t][k] == row[k], (t, k)
    assert sum(r["device_ns"] for r in got["tenants"].values()) == \
        teng.usage.busy_ns
    for name in ("usage", "request", "slo", "run"):
        assert tools[name][1].main([tdir]) == 0, name
        assert capsys.readouterr().out.strip(), name


# -- self-tests -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["run", "fleet", "request", "slo",
                                  "usage"])
def test_port_tool_self_test_passes(tools, name, capsys):
    argv = ["--self-test"] + (["--device", "cpu"]
                              if name in ("request", "usage") else [])
    assert tools[name][1].main(argv) == 0
    out = capsys.readouterr().out
    assert "self-test passed" in out
    if name == "fleet":
        assert "item 6d" in out
        with pytest.raises(NotImplementedError, match="item 6d"):
            tools["fleet"][1]._selftest_drill([])


def test_obs_report_renders_the_registry_as_the_reference():
    from paddle_tpu.obs import report as jreport
    from paddle_tpu_torch.obs import metrics, report

    snap = {"executor.dispatches": 3, "executor.run_ms": {
        "count": 2, "mean": 1.5, "p50": 1.0, "p90": 2.0, "p99": 2.0,
        "max": 2.0}, "serve.idle": {"count": 0}, "zz.gauge": 0.25}
    assert report.render(snap) == jreport.render(snap)
    assert report.render_json(snap) == jreport.render_json(snap)
    assert report.render({}) == jreport.render({})
    metrics.counter("reports.test").inc()
    assert "reports.test" in report.report()
    assert json.loads(report.report(as_json=True))["reports.test"] >= 1
