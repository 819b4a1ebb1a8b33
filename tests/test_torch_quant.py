"""paddle_tpu_torch.quant against paddle_tpu.quant, on the CPU.

The same numpy inputs, and weights copied from the JAX package's layers,
go through both packages' fake quantization, int8 layers, calibration,
QAT wrappers and model passes; the inference-bundle pass runs on one
JAX-saved LeNet bundle in both. Tolerances:

- ``quantize_abs_max`` and ``quantize_inference_model``: byte-equal
  arrays and files (both are the same numpy);
- fake quantization and dequantization: bitwise (the same float32
  operations in the same order);
- layer outputs, gradients, activation and output scales: atol 1e-5
  (float32 matmuls and convs summing in another order);
- ``bench.py:bench_int8_predictor``'s ``max_prob_diff`` at B = 256 from
  the JAX package's seed-0 weights: within 1e-5 of the JAX package's
  0.011483907699584961 on the CPU.

The JAX package's own cases (``tests/test_quant.py``) are mirrored on
the port: the straight-through gradient, per-channel scales, PTQ
accuracy and calibration, the state-dict round trip, QAT training and
conversion, and the int8 static bundle.
"""
import contextlib
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import quant as jquant
from paddle_tpu.framework import io as jio
from paddle_tpu.models.vision import LeNet as JLeNet
from paddle_tpu.quant import passes as jpasses
from paddle_tpu.static_ import program as jprog
from paddle_tpu.utils import unique_name as jun

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import nn, optim, quant
from paddle_tpu_torch.framework import TrainStep, io
from paddle_tpu_torch.inference import Config, Predictor
from paddle_tpu_torch.models.vision import LeNet
from paddle_tpu_torch.nn import ParamAttr
from paddle_tpu_torch.nn.layers.common import create_parameter
from paddle_tpu_torch.quant import passes
from paddle_tpu_torch.static_ import program as tprog
from paddle_tpu_torch.utils import unique_name as tun

from torch_test_threads import torch_threads  # noqa: F401,E402

TOL = 1e-5
# bench_int8_predictor(B=256) in the JAX package on the CPU
JAX_MAX_PROB_DIFF = 0.011483907699584961


def _classifiers(seed=0):
    """The JAX test's classifier in both packages, the port's with the JAX
    one's weights."""
    jpt.seed(seed)
    j = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 4))
    t = nn.Sequential(nn.Linear(16, 32, device="cpu"), nn.ReLU(),
                      nn.Linear(32, 4, device="cpu"))
    io.set_state_dict(t, {k: np.asarray(v.numpy())
                          for k, v in j.state_dict().items()})
    return j, t


def _convs():
    jpt.seed(1)
    j = jnn.Conv2D(3, 8, 3, stride=2, padding=1)
    t = nn.Conv2D(3, 8, 3, stride=2, padding=1, device="cpu")
    io.set_state_dict(t, {k: np.asarray(v.numpy())
                          for k, v in j.state_dict().items()})
    return j, t


def _data(n=256, seed=0):
    rng = np.random.RandomState(seed)
    means = rng.randn(4, 16).astype("float32") * 2.0
    y = rng.randint(0, 4, n)
    x = (means[y] + rng.randn(n, 16) * 0.4).astype("float32")
    return x, y.astype("int64")


def _train(model, x, y, steps=40, lr=5e-3):
    opt = optim.Adam(lr, parameters=model.parameters())
    step = TrainStep(model, opt, lambda m, a, b: F.cross_entropy(m(a), b))
    return [float(step(x, y)) for _ in range(steps)]


def _acc(model, x, y):
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(x)).numpy()
    return (logits.argmax(-1) == y).mean()


def _jout(model, x):
    return np.asarray(model(jpt.to_tensor(x)).numpy())


def _tout(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


# -- fake quantization ---------------------------------------------------------


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_fake_quant_equals_jax_bitwise(axis):
    x = np.random.RandomState(0).randn(64, 32).astype("float32")
    want = np.asarray(jquant.fake_quantize_abs_max(
        jpt.to_tensor(x), bits=8, channel_axis=axis).numpy())
    got = quant.fake_quantize_abs_max(torch.from_numpy(x), bits=8,
                                      channel_axis=axis).numpy()
    assert np.array_equal(got, want)
    if axis is None:
        step = np.abs(x).max() / 127
        assert np.abs(got - x).max() <= step / 2 + 1e-6


def test_straight_through_gradient():
    """All of x lies within its own abs-max scale: the gradient passes
    everywhere, as the JAX package's custom_vjp passes it; with a
    scale below some |x| (a QAT wrapper's weight under a narrower
    channel scale cannot occur, so the Function is called directly) the
    gradient is 0 there."""
    xs = np.linspace(-1, 1, 11).astype("float32")
    x = torch.from_numpy(xs).requires_grad_()
    quant.fake_quantize_abs_max(x, bits=8).sum().backward()
    jx = jpt.to_tensor(xs)
    jx.stop_gradient = False
    jquant.fake_quantize_abs_max(jx, bits=8).sum().backward()
    assert np.array_equal(x.grad.numpy(), np.asarray(jx.grad.numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(11, "float32"))
    x.grad = None
    quant._FakeQuant.apply(x, torch.tensor(0.5), 127.0).sum().backward()
    assert x.grad.tolist() == [0.0] * 3 + [1.0] * 5 + [0.0] * 3


@pytest.mark.parametrize("shape,axis", [((4, 2), 1), ((16, 6, 5, 5), 0),
                                        ((120, 84), 1), ((7, 9), None)])
def test_quantize_abs_max_byte_equal_to_jax(shape, axis):
    w = np.random.RandomState(3).randn(*shape).astype("float32")
    if shape == (4, 2):   # channels that differ 100x
        w = np.stack([np.ones(4, "float32"), 100 * np.ones(4, "float32")],
                     axis=1)
    jq, js = jquant.quantize_abs_max(w, bits=8, channel_axis=axis)
    tq, ts = quant.quantize_abs_max(torch.from_numpy(w), bits=8,
                                    channel_axis=axis)
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    assert tq.tobytes() == jq.tobytes() and ts.tobytes() == js.tobytes()
    deq = quant.dequantize(tq, ts).numpy()
    assert np.array_equal(deq, np.asarray(jquant.dequantize(jq, js)))
    np.testing.assert_allclose(deq, w, rtol=1e-2, atol=np.abs(w).max() / 127)


# -- int8 layers, PTQ and calibration ------------------------------------------


def test_quantized_layers_match_jax():
    j, t = _classifiers()
    jc, tc = _convs()
    x = _data(8)[0]
    img = np.random.RandomState(2).randn(2, 3, 9, 9).astype("float32")
    jquant.quantize_model(j)
    quant.quantize_model(t)
    assert isinstance(t[0], quant.QuantizedLinear)
    assert t[0].qweight.dtype == torch.int8
    assert t[0].wscale.dtype == torch.float32
    assert t[0].qweight.numpy().tobytes() == \
        np.asarray(j[0].qweight.numpy()).tobytes()
    np.testing.assert_allclose(_tout(t, x), _jout(j, x), rtol=0, atol=TOL)
    jq, tq = jquant.QuantizedConv2D(jc), quant.QuantizedConv2D(tc)
    np.testing.assert_allclose(_tout(tq, img), _jout(jq, img), rtol=0,
                               atol=TOL)


def test_weight_only_accuracy_close():
    x, y = _data()
    _, model = _classifiers()
    _train(model, x, y)
    fp_acc = _acc(model, x, y)
    quant.quantize_model(model)
    assert isinstance(model[0], quant.QuantizedLinear)
    q_acc = _acc(model, x, y)
    assert fp_acc > 0.9
    assert q_acc >= fp_acc - 0.05, (fp_acc, q_acc)
    assert model[0].qweight.dtype == torch.int8


@pytest.mark.parametrize("algo", ["abs_max", "avg"])
def test_calibration_matches_jax(algo):
    """The activation scales of two calibration batches, from the same
    weights and batches in both packages."""
    x, y = _data(64)
    loader = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    j, t = _classifiers()
    jm = jquant.PostTrainingQuantization(j, loader, batch_nums=2,
                                         algo=algo).quantize()
    tm = quant.PostTrainingQuantization(t, loader, batch_nums=2,
                                        algo=algo).quantize()
    tl = [m for _, m in tm.named_modules()
          if isinstance(m, quant.QuantizedLinear)]
    jl = [m for _, m in jm.named_sublayers()
          if isinstance(m, jquant.QuantizedLinear)]
    assert len(tl) == len(jl) == 2
    for a, b in zip(tl, jl):
        assert a.act_scale > 0
        np.testing.assert_allclose(a.act_scale, b.act_scale, rtol=TOL)
    with pytest.raises(NotImplementedError):
        quant.PostTrainingQuantization(t, loader, algo="KL")


def test_state_dict_roundtrip_after_quant():
    x, y = _data(32)
    _, model = _classifiers()
    _train(model, x, y, steps=5)
    quant.quantize_model(model)
    model2 = quant.quantize_model(_classifiers(seed=1)[1])
    io.set_state_dict(model2, model.state_dict())
    np.testing.assert_allclose(_tout(model, x[:4]), _tout(model2, x[:4]),
                               atol=1e-6)


# -- QAT -------------------------------------------------------------------------


def test_qat_forward_and_gradients_match_jax():
    j, t = _classifiers()
    jquant.QAT(bits=8).quantize(j)
    quant.QAT(bits=8).quantize(t)
    assert isinstance(t[0], quant.QATLinear)
    x = _data(8)[0]
    jo = j(jpt.to_tensor(x))
    jo.sum().backward()
    to = t(torch.from_numpy(x))
    to.sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo.numpy()),
                               rtol=0, atol=TOL)
    for ji, ti in ((0, 0), (2, 2)):
        np.testing.assert_allclose(
            t[ti].inner.weight.grad.numpy(),
            np.asarray(j[ji].inner.weight.grad.numpy()), rtol=0, atol=TOL)
    jc, tc = _convs()
    img = np.random.RandomState(2).randn(2, 3, 9, 9).astype("float32")
    np.testing.assert_allclose(
        _tout(quant.QATConv2D(tc), img), _jout(jquant.QATConv2D(jc), img),
        rtol=0, atol=TOL)


def test_qat_trains_and_converts():
    x, y = _data()
    _, model = _classifiers()
    qat = quant.QAT(bits=8)
    qat.quantize(model)
    losses = _train(model, x, y, steps=50)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    qat_acc = _acc(model, x, y)
    qat.convert(model)
    assert isinstance(model[0], quant.QuantizedLinear)
    int8_acc = _acc(model, x, y)
    assert qat_acc > 0.9
    assert int8_acc >= qat_acc - 0.05, (qat_acc, int8_acc)


# -- the model passes -----------------------------------------------------------


def test_passes_rewrite_as_jax():
    j, t = _classifiers()
    x = _data(8)[0]
    jpasses.QuantizationTransformPass().apply(j)
    passes.QuantizationTransformPass().apply(t)
    assert isinstance(t[0], quant.QATLinear)
    jtrain, ttrain = (jpasses.OutScaleForTrainingPass(),
                      passes.OutScaleForTrainingPass())
    jtrain.apply(j)
    ttrain.apply(t)
    for _ in range(2):
        _jout(j, x)
        _tout(t, x)
    # a QAT wrapper calls F.linear itself, so only the wrappers observe
    assert set(ttrain.out_scales) == set(jtrain.out_scales) == {"0", "2"}
    for k, v in jtrain.out_scales.items():
        np.testing.assert_allclose(ttrain.out_scales[k], v, rtol=TOL)
    ttrain.remove()
    passes.OutScaleForInferencePass(training_pass=ttrain).apply(t)
    assert t._out_threshold == ttrain.out_scales
    passes.QuantizationFreezePass().apply(t)
    assert isinstance(t[2], quant.QuantizedLinear)
    _, t2 = _classifiers()
    tr = passes.QuantizeTranspiler()
    tr.convert_to_int8(t2)
    assert isinstance(t2[0], quant.QuantizedLinear)
    assert passes.TransformForMobilePass().apply(t2) is t2
    with pytest.raises(TypeError, match="quantize_inference_model"):
        passes.ConvertToInt8Pass().apply(object())


# -- the static int8 bundle (save -> quantize_inference_model -> Predictor) ------


@contextlib.contextmanager
def _static(jax, scope):
    mod = jpt if jax else pt
    with (jun if jax else tun).guard(), mod.static.scope_guard(scope):
        mod.enable_static()
        try:
            yield
        finally:
            mod.disable_static()


def _lenet_bundle(jax, path, B):
    """bench_int8_predictor's LeNet + softmax bundle, saved at batch B by
    one package, seed 0."""
    mod = jpt if jax else pt
    scope = (jprog.Scope if jax else tprog.Scope)()
    mod.seed(0)
    with _static(jax, scope):
        main, startup = mod.static.Program(), mod.static.Program()
        with mod.program_guard(main, startup):
            xv = mod.static.data("x", [B, 1, 28, 28], "float32")
            model = JLeNet() if jax else LeNet(device="cpu")
            prob = (JF if jax else F).softmax(model(xv), axis=-1)
    with mod.static.scope_guard(scope):
        if jax:
            jpt.static.Executor().run(startup)
            jio.save_inference_model(path, ["x"], [prob], program=main,
                                     aot_warm=False)
        else:
            io.save_inference_model(path, ["x"], [prob], program=main)
    return main, prob, scope


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    """The JAX package's bundle at bench's B = 256."""
    prefix = str(tmp_path_factory.mktemp("jb") / "lenet")
    _lenet_bundle(True, prefix, 256)
    return prefix


def _predict(prefix, x):
    with tprog.scope_guard(tprog.Scope()):
        pred = Predictor(Config(prefix, device="cpu"))
        return pred, pred.run({"x": x})[0]


def test_quantize_inference_model_byte_equal_to_jax(jax_bundle, tmp_path):
    """One bundle through both passes: the same pdmodel bytes, the same
    npz entries in the same order with the same bytes."""
    outs = {}
    for name, fn in (("jax", jquant.quantize_inference_model),
                     ("port", quant.quantize_inference_model)):
        d = tmp_path / name
        d.mkdir()
        for ext in (".pdmodel", ".pdiparams.npz"):
            shutil.copy(jax_bundle + ext, d / ("m" + ext))
        outs[name] = (fn(str(d / "m")), str(d / "m_int8"))
    (jq, jp), (tq, tp) = outs["jax"], outs["port"]
    assert tq == jq
    assert sorted(tq) == ["conv2_d_1_w_0", "linear_0_w_0", "linear_1_w_0",
                          "linear_2_w_0"]
    with open(jp + ".pdmodel", "rb") as a, open(tp + ".pdmodel", "rb") as b:
        assert a.read() == b.read()
    ja, ta = np.load(jp + ".pdiparams.npz"), np.load(tp + ".pdiparams.npz")
    assert ta.files == ja.files
    for k in ja.files:
        assert (ta[k].dtype, ta[k].shape) == (ja[k].dtype, ja[k].shape), k
        assert ta[k].tobytes() == ja[k].tobytes(), k


def test_max_prob_diff_matches_jax(jax_bundle, tmp_path):
    """bench_int8_predictor's number from the JAX package's weights, fp32
    and int8 Predictors of the port at B = 256."""
    prefix = str(tmp_path / "lenet")
    for ext in (".pdmodel", ".pdiparams.npz"):
        shutil.copy(jax_bundle + ext, prefix + ext)
    quant.quantize_inference_model(prefix)
    x = np.random.RandomState(0).randn(256, 1, 28, 28).astype("float32")
    _, o32 = _predict(prefix, x)
    _, o8 = _predict(prefix + "_int8", x)
    diff = float(np.abs(o32 - o8).max())
    assert abs(diff - JAX_MAX_PROB_DIFF) < TOL, diff


def test_int8_predictor_accuracy_and_storage(tmp_path):
    prefix = str(tmp_path / "lenet")
    _lenet_bundle(False, prefix, 8)
    quantized = quant.quantize_inference_model(prefix, bits=8)
    assert any("conv" in n for n in quantized), quantized
    assert any("linear" in n for n in quantized), quantized
    xs = np.random.RandomState(0).randn(8, 1, 28, 28).astype("float32")
    _, ref = _predict(prefix, xs)
    pred, out = _predict(prefix + "_int8", xs)
    assert np.abs(out - ref).max() < 2e-2, np.abs(out - ref).max()
    assert np.argmax(out, -1).tolist() == np.argmax(ref, -1).tolist()
    wdtypes = {n: w.dtype for n, w in zip(pred._weight_names,
                                          pred._weights)}
    assert all(wdtypes[n + "@INT8"] == torch.int8 for n in quantized)
    assert not any(n in wdtypes for n in quantized)
    orig = os.path.getsize(prefix + ".pdiparams.npz")
    q = os.path.getsize(prefix + "_int8.pdiparams.npz")
    assert q < 0.5 * orig, (orig, q)


def test_int8_bundle_runs_through_executor(tmp_path):
    prefix = str(tmp_path / "lenet")
    _lenet_bundle(False, prefix, 8)
    quant.quantize_inference_model(prefix)
    xs = np.random.RandomState(0).randn(8, 1, 28, 28).astype("float32")
    pred, want = _predict(prefix + "_int8", xs)
    exe = pt.static.Executor("cpu")
    with tprog.scope_guard(tprog.Scope()):
        program, feeds, fetches = io.load_inference_model(
            prefix + "_int8", exe)
        out, = exe.run(program, feed={feeds[0]: xs}, fetch_list=fetches)
    assert np.array_equal(out, want)


def test_small_weights_stay_fp32_and_requantizing_is_refused(tmp_path):
    prefix = str(tmp_path / "lenet")
    _lenet_bundle(False, prefix, 8)
    assert quant.quantize_inference_model(prefix, min_elems=10 ** 9) == []
    data = np.load(prefix + "_int8.pdiparams.npz")
    assert not [k for k in data.files if k.startswith("q!")]
    quant.quantize_inference_model(prefix)
    with pytest.raises(ValueError, match="already an int8 bundle"):
        quant.quantize_inference_model(prefix + "_int8")


def test_biasfree_linear_weight_quantizes(tmp_path):
    """F.linear with bias=None records as 'linear_nobias' (the LM-head
    shape) and must still quantize."""
    scope = tprog.Scope()
    pt.seed(0)
    with _static(False, scope):
        main = pt.static.Program()
        with pt.program_guard(main, pt.static.Program()):
            x = pt.static.data("x", [4, 32], "float32")
            w = create_parameter([32, 64], attr=ParamAttr(name="head_w"),
                                 device="cpu")
            out = F.linear(x, w)
    assert main.global_block.ops[-1].type == "linear_nobias"
    xs = np.random.RandomState(1).randn(4, 32).astype("float32")
    with tprog.scope_guard(scope):
        ref, = pt.static.Executor("cpu").run(main, feed={"x": xs},
                                             fetch_list=[out])
        io.save_inference_model(str(tmp_path / "head"), ["x"], [out],
                                program=main)
    quantized = quant.quantize_inference_model(str(tmp_path / "head"))
    assert quantized == ["head_w"]
    _, got = _predict(str(tmp_path / "head_int8"), xs)
    np.testing.assert_allclose(got, ref, rtol=0.02, atol=0.02)
