"""paddle_tpu_torch's inference bundles, Predictor and analysis API against
the JAX package's, on the CPU.

``bench.py:bench_int8_predictor``'s program (LeNet + ``softmax``, seed 0)
is recorded in both packages, each under a fresh name generator and
Scope, so the two Programs name their variables alike; the JAX Scope's
weights go into the port's with ``convert.scope_from_jax``. Each package
saves its bundle (and its int8 copy, ``quantize_inference_model``), and
each bundle runs in both packages' Predictors. Tolerances, float32:

- the two packages' outputs on one bundle: atol 1e-5 (softmax
  probabilities; XLA's conv and dot sum in another order than
  PyTorch's);
- the saved files: the ``.pdmodel`` descs equal field by field, the
  ``.npz`` arrays byte-equal;
- the port against itself (Predictor against ``Executor.run``): bitwise;
  a bucket-padded batch against the unpadded one: 1e-6, as the JAX
  package's ``tests/test_inference.py`` holds it.
"""
import contextlib
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework import io as jio
from paddle_tpu.inference import AnalysisConfig as JAnalysisConfig
from paddle_tpu.inference import Predictor as JPredictor
from paddle_tpu.inference import create_paddle_predictor as jcreate
from paddle_tpu.models.vision import LeNet as JLeNet
from paddle_tpu.quant import quantize_inference_model as jquantize
from paddle_tpu.static_ import program as jprog
from paddle_tpu.utils import unique_name as jun

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import convert
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.inference import (AnalysisConfig, Config,
                                        PaddleTensor, Predictor,
                                        create_paddle_predictor,
                                        create_predictor)
from paddle_tpu_torch.models.vision import LeNet
from paddle_tpu_torch.ops.conv import _conv2d
from paddle_tpu_torch.quant import quantize_inference_model
from paddle_tpu_torch.static_ import program as tprog
from paddle_tpu_torch.utils import unique_name as tun

B = 8
TOL = 1e-5


@contextlib.contextmanager
def _static(jax, scope):
    mod = jpt if jax else pt
    with (jun if jax else tun).guard(), mod.static.scope_guard(scope):
        mod.enable_static()
        try:
            yield
        finally:
            mod.disable_static()


def lenet_prob(jax, batch=B):
    """bench_int8_predictor's program in one package: ``(main, prob,
    scope)``, the startup run in the program's own Scope."""
    mod = jpt if jax else pt
    scope = (jprog.Scope if jax else tprog.Scope)()
    mod.seed(0)
    with _static(jax, scope):
        main, startup = mod.static.Program(), mod.static.Program()
        with mod.program_guard(main, startup):
            xv = mod.static.data("x", [batch, 1, 28, 28], "float32")
            model = JLeNet() if jax else LeNet(device="cpu")
            prob = (JF if jax else F).softmax(model(xv), axis=-1)
    exe = jpt.static.Executor() if jax else pt.static.Executor("cpu")
    with mod.static.scope_guard(scope):
        exe.run(startup)
    return main, prob, scope


def jax_values(scope):
    return {n: np.asarray(v) for n, v in scope._vars.items()}


def images(n=B, seed=0):
    return np.random.RandomState(seed).randn(n, 1, 28, 28).astype("float32")


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The JAX-saved and the port-saved bundle of one set of weights, each
    with its int8 copy: ``{"jax": prefix, "port": prefix, ...}``."""
    d = tmp_path_factory.mktemp("bundles")
    jmain, jprob, jscope = lenet_prob(True)
    tmain, tprob, tscope = lenet_prob(False)
    convert.scope_from_jax(jax_values(jscope), tmain, tscope)
    out = {"jax": str(d / "jax" / "lenet"), "port": str(d / "port" / "lenet"),
           "tmain": tmain, "tprob": tprob, "tscope": tscope,
           "jvalues": jax_values(jscope)}
    with jprog.scope_guard(jscope):
        jio.save_inference_model(out["jax"], ["x"], [jprob], program=jmain,
                                 aot_warm=False)
    with tprog.scope_guard(tscope):
        io.save_inference_model(out["port"], ["x"], [tprob], program=tmain)
    out["jq"] = jquantize(out["jax"])
    out["tq"] = quantize_inference_model(out["port"])
    return out


def jax_predict(prefix, x):
    with jprog.scope_guard(jprog.Scope()):
        return np.asarray(JPredictor(prefix).run({"x": x})[0])


def port_predictor(prefix, **kw):
    with tprog.scope_guard(tprog.Scope()):
        return Predictor(Config(prefix, device="cpu", **kw))


def npz_arrays(path):
    data = np.load(path)
    return {k: data[k] for k in data.files}


# -- the files ----------------------------------------------------------------


def test_bundle_files_match_jax(bundles):
    """The two packages' bundles of the same weights: descs equal field by
    field (17 ops with their attributes, every variable's shape and numpy
    dtype name), the npz arrays byte-equal; and so their int8 copies."""
    for suffix in ("", "_int8"):
        j, t = bundles["jax"] + suffix, bundles["port"] + suffix
        with open(j + ".pdmodel", "rb") as f:
            jd = pickle.load(f)
        with open(t + ".pdmodel", "rb") as f:
            td = pickle.load(f)
        assert list(td) == list(jd)
        for key in jd:
            assert td[key] == jd[key], key
        assert [op[0] for op in td["ops"]] == [
            "conv2d", "reshape", "add", "relu", "max_pool2d", "conv2d",
            "reshape", "add", "relu", "max_pool2d", "flatten", "linear",
            "relu", "linear", "relu", "linear", "softmax"]
        assert all(dtype == "float32" for _, dtype in td["vars"].values())
        ja, ta = npz_arrays(j + ".pdiparams.npz"), \
            npz_arrays(t + ".pdiparams.npz")
        assert set(ta) == set(ja)
        for k in ja:
            assert (ta[k].dtype, ta[k].shape) == (ja[k].dtype, ja[k].shape), k
            assert ta[k].tobytes() == ja[k].tobytes(), k
    # the npz's key order follows each save's order of the weights (the
    # JAX package walks a set), and the returned list follows the npz
    assert sorted(bundles["tq"]) == sorted(bundles["jq"])


@pytest.mark.parametrize("suffix", ["", "_int8"])
def test_jax_bundle_runs_in_the_port(bundles, suffix):
    x = images()
    want = jax_predict(bundles["jax"] + suffix, x)
    got, = port_predictor(bundles["jax"] + suffix).run({"x": x})
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("suffix", ["", "_int8"])
def test_port_bundle_runs_in_the_jax_predictor(bundles, suffix):
    x = images()
    want, = port_predictor(bundles["port"] + suffix).run({"x": x})
    got = jax_predict(bundles["port"] + suffix, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_int8_bundle_loads_as_dequantize_ops(bundles):
    """``load_inference_model`` puts one ``dequantize_weight`` op for each
    int8 weight before the program's ops, reading ``@INT8``/``@SCALE``
    persistables, as the JAX loader does."""
    with jprog.scope_guard(jprog.Scope()):
        jp, _, _ = jio.load_inference_model(bundles["port"] + "_int8")
    with tprog.scope_guard(tprog.Scope()):
        tp, feeds, fetches = io.load_inference_model(
            bundles["port"] + "_int8", device="cpu")
        scope = tprog.global_scope()
        q = scope.find_var("linear_0_w_0@INT8")
        s = scope.find_var("linear_0_w_0@SCALE")
    assert (feeds, fetches) == (["x"], ["softmax.out_0"])
    jops, tops = jp.global_block.ops, tp.global_block.ops
    assert [(o.type, o.input_names, o.output_names, o.attrs) for o in tops] \
        == [(o.type, o.input_names, o.output_names, o.attrs) for o in jops]
    assert [o.type for o in tops[:4]] == ["dequantize_weight"] * 4
    assert (q.dtype, s.dtype) == (torch.int8, torch.float32)
    assert sorted(n for n, v in tp.global_block.vars.items()
                  if v.persistable) == sorted(
        n for n, v in jp.global_block.vars.items() if v.persistable)


# -- the Predictor (tests/test_inference.py's cases) --------------------------


def test_predictor_equals_the_executor_bitwise(bundles):
    x = images()
    with tprog.scope_guard(bundles["tscope"]):
        ref, = pt.static.Executor("cpu").run(
            bundles["tmain"], feed={"x": x}, fetch_list=[bundles["tprob"]])
    pred = port_predictor(bundles["port"])
    assert pred.get_input_names() == ["x"]
    assert pred.get_output_names() == ["softmax.out_0"]
    out, = pred.run({"x": x})
    assert np.array_equal(out, ref)
    out2, = pred([x])
    assert np.array_equal(out2, ref)
    t, = create_predictor(Config(bundles["port"], device="cpu")).run(
        {"x": x}, return_numpy=False)
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), ref)


def test_batch_bucketing_and_cache_stats_match_jax(bundles):
    """Batches of 5 and 7 pad to the bucket of 8 (one signature), the
    fetches come back unpadded; hits, misses and size count as the JAX
    Predictor's over the same calls."""
    x = images()
    ref, = port_predictor(bundles["port"]).run({"x": x})
    pred = port_predictor(bundles["port"])
    calls = [x[:5], x[:7], x[:5]]
    outs = [pred.run({"x": xs})[0] for xs in calls]
    for xs, out in zip(calls, outs):
        assert out.shape[0] == len(xs)
        np.testing.assert_allclose(out, ref[:len(xs)], rtol=1e-5, atol=1e-6)
    with jprog.scope_guard(jprog.Scope()):
        jpred = JPredictor(bundles["port"])
        for xs in calls:
            jpred.run({"x": xs})
    assert pred.cache_stats() == jpred.cache_stats() == \
        {"hits": 2, "misses": 1, "size": 1}
    assert pred.dispatches == jpred.dispatches == 3
    st = pred.cache_stats(per_entry=True)
    assert st["captures"] == 0          # no graph on the CPU
    assert st["entries"][0]["flops"] is None
    assert st["entries"][0]["feed_names"] == ["x"]


def test_bucketing_disabled_compiles_per_shape(bundles):
    cfg = Config(bundles["port"], device="cpu")
    cfg.disable_batch_bucketing()
    with tprog.scope_guard(tprog.Scope()):
        pred = Predictor(cfg)
    x = images()
    pred.run({"x": x[:3]})
    pred.run({"x": x[:5]})
    assert len(pred._compiled) == 2
    cfg.set_buckets([4, 2])
    assert cfg.buckets == (2, 4)


def test_missing_feed_raises(bundles):
    with pytest.raises(KeyError):
        port_predictor(bundles["port"]).run({})


def test_weights_isolated_from_scope(bundles):
    """A later write to the global scope does not reach the Predictor's
    snapshot."""
    x = images()
    with tprog.scope_guard(tprog.Scope()):
        pred = Predictor(Config(bundles["port"], device="cpu"))
        ref, = pred.run({"x": x})
        for n in pred._weight_names:
            tprog.global_scope().find_var(n).zero_()
        out, = pred.run({"x": x})
    assert np.array_equal(out, ref)


# -- the analysis API (tests/test_analysis_predictor.py's cases) ---------------


def test_analysis_config_knobs():
    cfg = AnalysisConfig("/nonexistent")
    assert cfg.use_gpu()                 # the card unless asked otherwise
    cfg.disable_gpu()
    cfg.switch_use_feed_fetch_ops(False)
    cfg.enable_memory_optim()
    cfg.set_cpu_math_library_num_threads(4)
    assert cfg.cpu_math_library_num_threads() == 4
    assert not cfg.use_gpu()
    cfg.enable_use_gpu(100, 1)
    assert cfg.use_gpu() and cfg.gpu_device_id() == 1
    with pytest.raises(NotImplementedError):
        cfg.enable_tensorrt_engine()


def _analysis(prefix):
    config = AnalysisConfig(prefix)
    config.disable_gpu()
    config.switch_use_feed_fetch_ops(False)
    with tprog.scope_guard(tprog.Scope()):
        return create_paddle_predictor(config)


def test_zero_copy_protocol_matches_jax(bundles):
    x = images()
    with jprog.scope_guard(jprog.Scope()):
        jpred = jcreate(JAnalysisConfig(bundles["jax"]))
        jin = jpred.get_input_tensor("x")
        jin.reshape([B, 1, 28, 28])
        jin.copy_from_cpu(x.ravel())
        assert jpred.zero_copy_run()
        want = jpred.get_output_tensor("softmax.out_0").copy_to_cpu()
    pred = _analysis(bundles["jax"])
    names = pred.get_input_names()
    assert names == ["x"]
    inp = pred.get_input_tensor(names[0])
    inp.reshape([B, 1, 28, 28])
    inp.copy_from_cpu(x.ravel())
    assert inp.shape() == [B, 1, 28, 28]
    assert np.array_equal(inp.copy_to_cpu(), x)
    assert pred.zero_copy_run()
    out_t = pred.get_output_tensor(pred.get_output_names()[0])
    out = out_t.copy_to_cpu()
    np.testing.assert_allclose(out, want, rtol=0, atol=TOL)
    assert out_t.shape() == [B, 10]


def test_paddle_tensor_run_path(bundles):
    x = images()
    want, = port_predictor(bundles["port"]).run({"x": x})
    (out,) = _analysis(bundles["port"]).run([PaddleTensor(x, name="x")])
    assert isinstance(out, PaddleTensor)
    assert np.array_equal(out.as_ndarray(), want)


def test_dir_and_pdmodel_resolution(bundles, tmp_path):
    d = os.path.dirname(bundles["port"])
    assert _analysis(bundles["port"] + ".pdmodel").get_input_names() == ["x"]
    # the port's directory holds the fp32 and the int8 bundle
    with pytest.raises(ValueError, match="multiple bundles"):
        _analysis(d)
    with pytest.raises(ValueError, match="no .pdmodel"):
        _analysis(str(tmp_path))
    one = tmp_path / "one"
    one.mkdir()
    for ext in (".pdmodel", ".pdiparams.npz"):
        with open(bundles["port"] + ext, "rb") as src, \
                open(one / ("m" + ext), "wb") as dst:
            dst.write(src.read())
    assert _analysis(str(one)).get_input_names() == ["x"]


def test_analysis_errors(bundles):
    pred = _analysis(bundles["port"])
    with pytest.raises(KeyError):
        pred.get_input_tensor("bogus")
    with pytest.raises(KeyError):
        pred.get_output_tensor("bogus")
    with pytest.raises(ValueError):
        pred.zero_copy_run()  # nothing staged
    with pytest.raises(RuntimeError):
        pred.get_output_tensor("softmax.out_0").copy_to_cpu()
    with pytest.raises(ValueError):
        pred.get_output_tensor("softmax.out_0").copy_from_cpu(images())


# -- program-level variable I/O -------------------------------------------------


def test_program_vars_and_footprint_match_jax(bundles):
    jmain, _, jscope = lenet_prob(True)
    tmain, tscope = bundles["tmain"], bundles["tscope"]
    jnames = [v.name for v in jio.get_program_parameter(jmain)]
    assert [v.name for v in io.get_program_parameter(tmain)] == jnames
    assert [v.name for v in io.get_program_persistable_vars(tmain)] == \
        [v.name for v in jio.get_program_persistable_vars(jmain)]
    jf = jio.persistable_footprint(jmain, jscope)
    tf = io.persistable_footprint(tmain, tscope)
    assert tf == jf
    assert tf["total_bytes"] == 4 * sum(
        a.size for a in bundles["jvalues"].values())


def test_params_and_persistables_cross_load(bundles, tmp_path):
    """The JAX package's ``save_persistables`` loads into the port's scope
    (into its tensors, whose storage stays); the port's ``save_params``
    reads back in the JAX package byte-equal; ``load_program_state``
    reads a dirname, an npz and a ``save()`` pickle."""
    jmain, _, jscope = lenet_prob(True)
    with jprog.scope_guard(jscope):
        jio.save_persistables(None, str(tmp_path / "j"), jmain)
    tmain, _, tscope = lenet_prob(False)
    ptrs = {n: t.data_ptr() for n, t in tscope._vars.items()}
    with tprog.scope_guard(tscope):
        io.load_persistables(None, str(tmp_path / "j"), tmain)
        io.save_params(None, str(tmp_path / "t"), tmain)
    assert {n: t.data_ptr() for n, t in tscope._vars.items()} == ptrs
    for n, a in bundles["jvalues"].items():
        assert tscope.find_var(n).numpy().tobytes() == a.tobytes(), n
    state = jio.load_program_state(str(tmp_path / "t"))
    assert set(state) == set(bundles["jvalues"])
    for n, a in state.items():
        assert a.tobytes() == bundles["jvalues"][n].tobytes(), n
    got = io.load_program_state(str(tmp_path / "t" / "__params__.npz"),
                                var_list=["linear_0_w_0"])
    assert list(got) == ["linear_0_w_0"]
    io.save(dict(bundles["jvalues"]), str(tmp_path / "state.pdparams"))
    got = io.load_program_state(str(tmp_path / "state.pdparams"))
    assert all(np.array_equal(got[n], a)
               for n, a in bundles["jvalues"].items())
    with pytest.raises(ValueError, match="missing"):
        io.load_program_state(str(tmp_path / "t"), var_list=["nope"])
    with pytest.raises(FileNotFoundError):
        io.load_program_state(str(tmp_path / "nowhere"))


def test_save_and_set_vars(bundles, tmp_path):
    tmain, _, tscope = lenet_prob(False)
    with tprog.scope_guard(tscope):
        path = io.save_vars(None, str(tmp_path), tmain,
                            vars=["linear_2_b_0"], filename="b")
        assert path.endswith("b.npz")
        ptr = tscope.find_var("linear_2_b_0").data_ptr()
        io.set_program_state(tmain, {"linear_2_b_0": np.ones(10, "float32")})
        assert tscope.find_var("linear_2_b_0").data_ptr() == ptr
        assert float(tscope.find_var("linear_2_b_0").sum()) == 10.0
        io.load_vars(None, str(tmp_path), tmain, vars=["linear_2_b_0"],
                     filename="b")
        assert float(tscope.find_var("linear_2_b_0").sum()) == 0.0
        with pytest.raises(ValueError, match="missing"):
            io.load_vars(None, str(tmp_path), tmain, vars=["linear_2_w_0"],
                         filename="b")
        with pytest.raises(ValueError, match="no value"):
            io.save_vars(None, str(tmp_path), tmain, vars=["nope"])


# -- what the port raises -----------------------------------------------------------


def test_saving_an_unregistered_op_raises(tmp_path):
    """A torch call the recorder took as a closure has no registered
    counterpart: the save names it and writes no pickle of it."""
    scope = tprog.Scope()
    with _static(False, scope):
        main = pt.static.Program()
        with pt.program_guard(main, pt.static.Program()):
            x = pt.static.data("x", [2, 3], "float32")
            y = x * 2.0
    with pytest.raises(ValueError, match="multiply"):
        io.save_inference_model(str(tmp_path / "m"), ["x"], [y],
                                program=main)
    assert not os.path.exists(str(tmp_path / "m.pdmodel"))


def test_unported_and_foreign_paths_raise(bundles, tmp_path):
    with pytest.raises(NotImplementedError, match="item 8"):
        io.save_inference_model(str(tmp_path / "m"), ["x"],
                                [bundles["tprob"]], program=bundles["tmain"],
                                aot_warm=str(tmp_path))
    cfg = Config(bundles["port"], device="cpu")
    cfg.aot_cache_dir = None
    with pytest.raises(NotImplementedError, match="item 8"):
        cfg.aot_cache_dir = str(tmp_path)
    # a bundle's NHWC conv op (HWIO weight) loads and runs: the JAX op's
    # result on the same arrays
    rng = np.random.RandomState(0)
    x, w = rng.randn(1, 5, 5, 2), rng.randn(3, 3, 2, 4)
    x, w = x.astype(np.float32), w.astype(np.float32)
    attrs = dict(stride=(1, 1), padding=[(1, 0), (0, 1)], dilation=(1, 1),
                 groups=1, data_format="NHWC")
    want = jpt.ops.OP_REGISTRY["conv2d"](x, w, **attrs)
    got = _conv2d(torch.from_numpy(x), torch.from_numpy(w), **attrs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with open(bundles["port"] + ".pdmodel", "rb") as f:
        desc = pickle.load(f)
    desc["ops"][0] = ("no_such_op",) + tuple(desc["ops"][0][1:])
    with open(tmp_path / "bad.pdmodel", "wb") as f:
        pickle.dump(desc, f)
    with open(bundles["port"] + ".pdiparams.npz", "rb") as src, \
            open(tmp_path / "bad.pdiparams.npz", "wb") as dst:
        dst.write(src.read())
    with pytest.raises(ValueError, match="no_such_op"):
        with tprog.scope_guard(tprog.Scope()):
            io.load_inference_model(str(tmp_path / "bad"), device="cpu")


def test_predictor_needs_a_card_unless_asked_for_the_cpu(bundles):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(bundles["port"])
    cfg = AnalysisConfig(bundles["port"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_paddle_predictor(cfg)
