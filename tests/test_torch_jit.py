"""paddle_tpu_torch's ``TrainStep.run_fused`` and a scheduled trajectory
against the JAX package's ``TrainStep``.

A tiny GPT (vocab 256, hidden 64, 2 layers, 2 heads, 32 positions,
dropout 0) from the JAX package's seed, its weights carried across with
``convert.gpt_params_from_jax``, batches of 4 x 32 ids from
``RandomState``, AdamW at 3e-3 with global-norm clip 1.0, the port on
the CPU (the kernels' plain versions; there is no graph on the CPU).

Tolerances: losses atol and rtol 5e-5, as
``tests/test_torch_gpt.py::test_train_step_trajectory_matches`` (float32
sums in another order; AdamW's first steps carry tiny gradient
differences into the later losses); learning rates exactly (the same
host arithmetic). The port's ``run_fused`` and K calls of the port's
step run the same operations in the same order, so their losses and
parameters are the same bits.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optim as joptim
from paddle_tpu.models.nlp import gpt as jgpt
from paddle_tpu.optim import lr as jlr
from paddle_tpu_torch import convert, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.nlp import gpt
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.optim import lr as tlr

CFG = dict(vocab_size=256, hidden=64, layers=2, heads=2, max_seq=32,
           dropout=0.0)
LOSS_TOL = 5e-5
LR = 3e-3


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, CFG["vocab_size"], (4, 32)).astype("int32")
        out.append((ids, np.roll(ids, -1, axis=1).astype("int32")))
    return out


def _model():
    """A JAX GPT from seed 0 and the port's (CPU) with its weights."""
    pt.seed(0)
    jm = jgpt.GPT(jgpt.GPTConfig(**CFG))
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    m = gpt.GPT(gpt.GPTConfig(**CFG), device="cpu")
    m.load_state_dict(convert.gpt_params_from_jax(sd))
    return jm, m


def _steps(lr=LR):
    """The JAX TrainStep and the port's, AdamW with global-norm clip 1.0
    at ``lr`` (a float, or a pair of schedulers: JAX's, the port's)."""
    jm, m = _model()
    jlr_, tlr_ = lr if isinstance(lr, tuple) else (lr, lr)
    jopt = joptim.AdamW(parameters=jm.parameters(), learning_rate=jlr_,
                        grad_clip=joptim.ClipGradByGlobalNorm(1.0))
    opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=tlr_,
                      grad_clip=optim.ClipGradByGlobalNorm(1.0))
    return (pt.TrainStep(jm, jopt, jgpt.gpt_loss),
            TrainStep(m, opt, gpt.gpt_loss))


def test_run_fused_matches_the_reference_and_four_calls():
    batches = _batches(8)
    jstep, step = _steps()
    want = np.concatenate([
        np.asarray(jstep.run_fused(batches[:4])._data),
        np.asarray(jstep.run_fused(batches[4:])._data)])
    got = torch.cat([step.run_fused(batches[:4]),
                     step.run_fused(batches[4:])])
    assert got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), want, atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert step.optimizer._global_step == 8
    assert step.last_found_inf_per_step.shape == (4,)
    assert not bool(step.last_found_inf)
    # four calls of the step: the same operations, the same bits
    _, calls = _steps()
    one = torch.stack([calls(*b) for b in batches])
    assert torch.equal(one, got)
    for (n, a), (_, b) in zip(step.model.named_parameters(),
                              calls.model.named_parameters()):
        assert torch.equal(a, b), n


def test_run_fused_takes_a_pre_stacked_window():
    batches = _batches(4)
    _, step = _steps()
    stacked = tuple(np.stack([b[i] for b in batches]) for i in range(2))
    got = step.run_fused(stacked, steps=4)
    _, seq = _steps()
    assert torch.equal(got, seq.run_fused(batches))


@pytest.mark.parametrize("case", ["unsized", "count", "shapes", "stacked",
                                  "zero", "accumulate"])
def test_run_fused_rejects_what_the_reference_rejects(case):
    batches = _batches(4)
    _, step = _steps()
    ids, labels = batches[0]
    args, kw, err = {
        "unsized": ((iter(batches),), {}, ValueError),
        "count": ((batches,), {"steps": 3}, ValueError),
        "shapes": ((batches[:3] + [(ids[:2], labels[:2])],), {},
                   ValueError),
        "stacked": (((np.stack([ids] * 3), np.stack([labels] * 3)),),
                    {"steps": 4}, ValueError),
        "zero": ((batches,), {"steps": 0}, ValueError),
        "accumulate": ((batches,), {"accumulate_steps": 2},
                       NotImplementedError),
    }[case]
    with pytest.raises(err):
        step.run_fused(*args, **kw)
    assert step.optimizer._global_step == 0


def test_run_fused_check_nan_raises_after_the_window():
    batches = _batches(4)
    jm, m = _model()
    opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=LR)
    step = TrainStep(m, opt, gpt.gpt_loss, check_nan=True)
    step.run_fused(batches)
    with torch.no_grad():
        m.blocks[0].fc1.weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"\[0, 1, 2, 3\] of 4"):
        step.run_fused(batches)
    assert step.last_found_inf_per_step.tolist() == [True] * 4


def test_scheduled_trajectory_matches_the_reference():
    """8 steps under ``LinearWarmup`` into ``CosineAnnealingDecay``, the
    scheduler stepped after each: the learning rates each step used are
    the JAX package's exactly, the losses agree."""
    def sched(m):
        return m.LinearWarmup(m.CosineAnnealingDecay(LR, T_max=8),
                              warmup_steps=3, start_lr=3e-4, end_lr=LR)

    js, ts = sched(jlr), sched(tlr)
    jstep, step = _steps((js, ts))
    want, got, lrs = [], [], []
    for b in _batches(8):
        lrs.append((jstep.optimizer.get_lr(), step.optimizer.get_lr()))
        want.append(float(np.asarray(jstep(*b)._data)))
        got.append(float(step(*b)))
        js.step()
        ts.step()
    assert [a for a, _ in lrs] == [b for _, b in lrs]
    assert len(set(b for _, b in lrs)) == 8
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=LOSS_TOL)
    assert got[-1] < got[0]


def test_add_launches_counts_a_replay():
    kernels.reset_launches()
    kernels.add_launches({"layer_norm_fwd": 5, "softmax_ce_bwd": 1})
    kernels.add_launches({"layer_norm_fwd": -2})
    got = kernels.launches()
    assert got["layer_norm_fwd"] == 3 and got["softmax_ce_bwd"] == 1
    kernels.reset_launches()


_JAX_FREE = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from paddle_tpu_torch import amp, convert, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.nlp import gpt
from paddle_tpu_torch.optim import lr
m = gpt.GPT(gpt.GPTConfig(vocab_size=256, hidden=64, layers=1, heads=2,
                          max_seq=16, dropout=0.1), device="cpu")
sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=4), 2, 0.0, 1e-3)
opt = optim.Momentum(sched, parameters=m.named_parameters(),
                     grad_clip=optim.ClipGradByNorm(1.0))
step = TrainStep(m, opt, gpt.gpt_loss, scaler=amp.GradScaler())
ids = np.random.RandomState(0).randint(0, 256, (4, 16))
losses = step.run_fused([(ids, np.roll(ids, -1, 1))] * 2)
assert losses.shape == (2,) and np.isfinite(losses.numpy()).all()
import paddle_tpu_torch as pt
from paddle_tpu_torch import analysis, static_
from paddle_tpu_torch.models.vision import LeNet
from paddle_tpu_torch.nn import functional as F
pt.enable_static()
try:
    main = static_.Program()
    with static_.program_guard(main, static_.Program()):
        x = static_.data("x", [2, 1, 28, 28], "float32")
        y = static_.data("y", [2], "int64")
        loss = F.cross_entropy(LeNet(device="cpu")(x), y)
        optim.SGD(0.1, parameters=[]).minimize(loss)
finally:
    pt.disable_static()
exe = static_.Executor("cpu")
out = exe.run_steps(main, feeds=[{"x": np.ones((2, 1, 28, 28), np.float32),
                                  "y": np.zeros(2, np.int64)}] * 2,
                    fetch_list=[loss])
assert np.isfinite(out[0]).all() and exe.last_diagnostics.errors() == []
import importlib.util
import os
import tempfile
from paddle_tpu_torch import inference, quant
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.quant import passes
with tempfile.TemporaryDirectory() as d:
    io.save_inference_model(os.path.join(d, "m"), ["x"], [loss],
                            program=main)
    quant.quantize_inference_model(os.path.join(d, "m"))
    pred = inference.Predictor(inference.Config(os.path.join(d, "m_int8"),
                                                device="cpu"))
spec = importlib.util.spec_from_file_location(
    "torch_serve_bench", os.path.join(sys.argv[1], "tools",
                                      "torch_serve_bench.py"))
sb = importlib.util.module_from_spec(spec)
spec.loader.exec_module(sb)
assert len(sb.make_trace(4, 10.0)) == 4
import torch
from paddle_tpu_torch import amp
from paddle_tpu_torch.amp import static_decorator
from paddle_tpu_torch.framework import recompute as _rc
from paddle_tpu_torch.models.nlp import gpt
m = gpt.GPT(gpt.gpt_tiny(dropout=0.1, use_recompute=True), device="cpu")
ids = torch.zeros(1, 8, dtype=torch.int64)
with amp.auto_cast(dtype="float16"):
    gpt.gpt_loss(m, ids, ids).backward()
assert static_decorator.decorate(optim.SGD(0.1, parameters=[]))
from paddle_tpu_torch.nn import initializer
from paddle_tpu_torch.obs import report
p = torch.nn.Parameter(initializer.Orthogonal()((4, 4), device="cpu"))
for rule in (optim.Ftrl(0.1, parameters=[p]),
             optim.DecayedAdagrad(0.1, parameters=[p]),
             optim.Dpsgd(0.1, parameters=[p]),
             optim.LarsMomentum(0.1, parameters=[p]),
             optim.DGCMomentum(0.1, 0.9, parameters=[p])):
    p.grad = torch.ones(4, 4)
    rule.step()
for wrapper in (optim.ExponentialMovingAverage([p]),
                optim.ModelAverage(0.1, [p])):
    getattr(wrapper, "update", getattr(wrapper, "step", None))()
    wrapper.apply()
    wrapper.restore()
assert report.render({}) and optim.LookAhead(optim.SGD(0.1, parameters=[p]))
for tool in ("run", "fleet", "request", "slo", "usage"):
    spec = importlib.util.spec_from_file_location(
        f"torch_{tool}_report", os.path.join(
            sys.argv[1], "tools", f"torch_{tool}_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if tool in ("run", "slo"):     # host-only: every module they read
        assert mod.main(["--self-test"]) == 0
from paddle_tpu_torch.models.nlp import StackedLSTMSentiment
from paddle_tpu_torch.nn.layers import (activation, common, conv, loss,
                                        norm, pooling, rnn)
from paddle_tpu_torch.ops import reduction
sent = StackedLSTMSentiment(50, 8, 8, num_layers=2, device="cpu")
logits = sent(torch.ones(2, 5, dtype=torch.int64), torch.tensor([5, 2]))
assert logits.shape == (2, 2) and bool(torch.isfinite(logits).all())
import paddle_tpu_torch as pt_api
from paddle_tpu_torch.models.rec import DeepFM
from paddle_tpu_torch.models.nlp import NGramLM
from paddle_tpu_torch.ops import control_flow, linalg
fm = DeepFM([5, 7], embed_dim=4, hidden=(8,), device="cpu")
assert fm(torch.tensor([1, 2]), torch.tensor([3, 6])).shape == (2,)
assert NGramLM(11, 4, 8, device="cpu")(torch.ones(2, 4, dtype=torch.int64))\
    .shape == (2, 11)
assert pt_api.topk(torch.tensor([3.0, 1.0, 3.0]), 2)[1].tolist() == [0, 2]
assert float(pt_api.dist(torch.ones(3), torch.zeros(3))) ** 2 > 2.99
import paddle_tpu_torch.tensor.math
from paddle_tpu_torch import modules_compat
from paddle_tpu_torch.core import autograd, device, dtype, tensor
from paddle_tpu_torch.nn import layer
pt_api.set_device("cpu")
spec = importlib.util.spec_from_file_location(
    "paddle_gpt_script", os.path.join(sys.argv[1], "tools",
                                      "paddle_gpt_script.py"))
script = importlib.util.module_from_spec(spec)
spec.loader.exec_module(script)
cfg = dict(script.CONFIGS["tiny"], layers=1, seq=4, batch=1)
net = script.make_model(pt_api, cfg)
ids, labels = script.batches(cfg, 1)[0]
assert float(script.loss_fn(pt_api, net, pt_api.to_tensor(ids),
                            pt_api.to_tensor(labels))) > 0
assert pt_api.to_static(net)(ids).shape == (1, 4, 256)
for name in ("optimizer", "static", "device", "distributed", "regularizer",
             "TrainStep", "save", "jit", "nn", "amp", "serving"):
    getattr(pt_api, name)
from paddle_tpu_torch.models.vision import MobileNetV1, MobileNetV2, vgg16
from paddle_tpu_torch.models.vision import mobilenet, vgg
from paddle_tpu_torch.ops import conv, misc, norm_ops
net = MobileNetV1(num_classes=3, scale=0.25, device="cpu")
assert net(torch.zeros(2, 3, 32, 32)).shape == (2, 3)
assert pt_api.ops.hash(torch.tensor([[1, 2]]), 7).shape == (1, 1)
assert pt_api.ops.conv2d(torch.ones(1, 4, 4, 2), torch.ones(3, 3, 2, 1),
                         padding=1, data_format="NHWC").shape == (1, 4, 4, 1)
assert callable(convert.vgg_params_from_jax) and callable(
    convert.mobilenet_params_from_jax)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
print("JAX-FREE OK")
"""


def test_step_modules_import_neither_jax_nor_the_jax_package():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _JAX_FREE, repo],
                         capture_output=True, text=True, timeout=120,
                         cwd=repo, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX-FREE OK" in out.stdout
