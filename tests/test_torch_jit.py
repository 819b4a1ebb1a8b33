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
