"""paddle_tpu_torch's ResNet training step against the JAX package's.

``ResNet(BottleneckBlock, [1, 1, 1, 1], width=8, num_classes=10)`` and
its ``BasicBlock`` twin, in float32 and cast to bfloat16 as
``bench.py:bench_resnet50`` casts ResNet-50 (``bfloat16()``; on the
JAX side the same rounding done in numpy, ``_jax_bfloat16``). The JAX
model's weights and BatchNorm buffers go to the port through
``convert.resnet_params_from_jax``; the same numpy batch (4 x 3 x 64 x
64 images, 4 labels of 10 classes, from ``RandomState(0)``) goes
through both, with the loss of ``bench_resnet50``:
``cross_entropy(model(x.astype(dtype)).astype(float32), y)``; the port
runs on the CPU.

The images are 64 x 64, not 32 x 32: at 32 x 32 the last stage's maps
are 1 x 1, so its BatchNorms normalise 4 values a channel, and the two
frameworks' float32 roundings part to 1.8e-2 in the Bottleneck's
8-step losses (1.9e-4 of a gradient's largest entry after one
backward; with the JAX package's own draws); at 64 x 64 (2 x 2 maps,
16 values), to at most 2.3e-4.

The JAX side runs jitted with XLA's excess precision off
(``xla_allow_excess_precision=False``, a compiler option of the jit):
with it on, XLA keeps bfloat16 intermediates in float32 inside a jitted
step, which the JAX package's own op-by-op forward does not (the Basic
net at 32 x 32 with the JAX package's own draws: a first bfloat16 loss
of 2.7473 jitted against 2.7399 op by op); with it off the jitted step
rounds as the op-by-op one does, to the bit there. The JAX
``TrainStep`` runs the 8-step trajectory, its step compiled with that
option and made to return the first step's logits too; the first
step's loss, logits, velocities (its gradients) and buffers are the
references of the one-step tests.

Tolerances (seen: the largest difference of the four nets, here):

- logits: float32 atol and rtol 1e-5 of the largest |logit| (seen
  1.6e-6); bfloat16 2^-5 of it, four bfloat16 steps there (17
  convolutions of bfloat16 activations; a sum near a rounding boundary
  rounds the other way in the other framework; seen 7.1e-3);
- every gradient after one backward: float32 1e-5 of each gradient's
  largest entry, and rtol 1e-5 (seen 5.5e-6); bfloat16 a relative L2
  error of at most 2^-2 (seen: the Bottleneck net's median 0.116, at
  most 0.173; the Basic net's at most 7.2e-3). At batch 4 on 2 x 2 maps
  BatchNorm's backward amplifies each bfloat16 rounding of a cotangent:
  the JAX package's own bfloat16 gradients differ from its float32 ones
  by a median of 0.31 in the Bottleneck net. A wrong padding or a
  transposed weight is an error of order 1;
- the BatchNorm buffers after one step: float32 rtol 1e-5 and 1e-6 of
  the buffer's largest |value| (seen 1.1e-6 of it); bfloat16 rtol 2^-7
  and 2^-8 of the largest |value|, two rounding steps (the same rounding
  chain, float32 statistics rounded to bfloat16 and the update in
  bfloat16, of conv outputs that differ by a rounding here and there;
  seen: 363 of 2416 values apart, by at most 6.9e-3 of the largest);
- the 8-step trajectories, Momentum(0.01, 0.9, multi_precision): float32
  losses within 1e-3 (seen 2.3e-4: BatchNorm at batch 4 amplifies a
  rounding difference step by step); bfloat16 within 5e-2 (seen
  1.3e-2: from the second step on, a bfloat16 rounding of a gradient
  that falls the other way moves the weights).
"""
import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.functional as JF
import paddle_tpu.nn.initializer as JI
from paddle_tpu import optim as joptim
from paddle_tpu.models.vision import resnet as jres
from paddle_tpu_torch import convert, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.vision import resnet
from paddle_tpu_torch.nn import functional as F

B, SIZE, CLASSES = 4, 64, 10
LR = 0.01
# XLA's options for the JAX side's jits: excess precision off (below);
# LLVM's expensive passes off, which halves the compile time (16 s to 7 s
# for the Bottleneck net's step) and leaves the roundings where they are
# (sums may be taken in another order: the gradients' sum moved by 6e-8)
NO_EXCESS = {"xla_allow_excess_precision": False,
             "xla_llvm_disable_expensive_passes": True}
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-5
BF16_GRAD_L2 = 2 ** -2
LOSS_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
BF16_LOGIT_STEPS = 2 ** -5
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BLOCKS = {"bottleneck": (jres.BottleneckBlock, resnet.BottleneckBlock),
          "basic": (jres.BasicBlock, resnet.BasicBlock)}
CASES = pytest.mark.parametrize("case", [
    (b, d) for b in BLOCKS for d in ("float32", "bfloat16")],
    ids=lambda c: "-".join(c))


def _batch():
    rng = np.random.RandomState(0)
    x = rng.randn(B, 3, SIZE, SIZE).astype(np.float32)
    y = rng.randint(0, CLASSES, (B,)).astype(np.int32)
    return x, y


@contextlib.contextmanager
def _numpy_initializers(seed=0):
    """The JAX package's initializers (``Constant``, ``Normal``,
    ``XavierUniform``: all a ResNet uses) drawing from
    ``RandomState(seed)`` while a model is built: the same distributions,
    without compiling a JAX random op for every parameter shape (18 s for
    the tiny Bottleneck ResNet, 17 s for ResNet-50, here)."""
    rng = np.random.RandomState(seed)

    def draw(init, shape, dtype="float32", key=None):
        shape = tuple(int(s) for s in shape)
        if isinstance(init, JI.Constant):
            a = np.full(shape, init.value)
        elif isinstance(init, JI.Normal):
            a = rng.normal(init.mean, init.std, shape)
        elif isinstance(init, JI.XavierUniform):
            fan_in, fan_out = JI._fans(shape)
            limit = init.gain * math.sqrt(6.0 / (fan_in + fan_out))
            a = rng.uniform(-limit, limit, shape)
        else:
            raise TypeError(f"no numpy draw for {type(init).__name__}")
        return jnp.asarray(a.astype(np.dtype(dtype)))

    real = JI.Initializer.__call__
    JI.Initializer.__call__ = draw
    try:
        yield
    finally:
        JI.Initializer.__call__ = real


def _jax_bfloat16(jm):
    """``jm.bfloat16()``, each floating parameter and buffer rounded to
    bfloat16 in numpy (to nearest, ties to even, as XLA's convert does)
    instead of by a JAX op compiled for every shape."""
    for layer in jm.sublayers(include_self=True):
        layer._dtype = jnp.bfloat16
    for _, t in list(jm.named_parameters()) + list(jm.named_buffers()):
        t._replace(jnp.asarray(np.asarray(t._data).astype(jnp.bfloat16)))


def _pair(block, dtype):
    """A JAX ``ResNet`` with weights from seed 0 and the port's (CPU) with
    its weights and buffers, both in ``dtype``."""
    jblock, tblock = BLOCKS[block]
    with _numpy_initializers():
        jm = jres.ResNet(jblock, [1, 1, 1, 1], width=8, num_classes=CLASSES)
    m = resnet.ResNet(tblock, [1, 1, 1, 1], width=8, num_classes=CLASSES,
                      device="cpu")
    if dtype == "bfloat16":
        _jax_bfloat16(jm)
        m.bfloat16()
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    m.load_state_dict(convert.resnet_params_from_jax(sd))
    return jm, m


def _jax_momentum(jm):
    """The JAX ``Momentum(LR, 0.9, multi_precision=True)`` over ``jm``, its
    state made in numpy: velocities of float32 zeros and, for bfloat16
    parameters, float32 masters. The JAX optimizer makes the same values
    with a JAX op compiled for every shape (its velocities start in the
    parameters' type and leave the first step in float32: float32 from
    the start, as the port's, gives the same steps with one compile)."""
    opt = joptim.Momentum(learning_rate=LR, momentum=0.9,
                          parameters=jm.parameters(), multi_precision=True)
    for p in jm.parameters():
        a = np.asarray(p._data)
        state = {"velocity": jnp.asarray(np.zeros(a.shape, np.float32))}
        if a.dtype != np.float32:
            state["master"] = jnp.asarray(a.astype(np.float32))
        opt._accumulators[p.name] = state
    return opt


def _jax_loss(dtype, logits=None):
    def loss_fn(m, x, y):
        out = m(x.astype(dtype))
        if logits is not None:
            logits.append(out._data)
        return JF.cross_entropy(out.astype("float32"), y)
    return loss_fn


def _port_loss(dtype):
    def loss_fn(m, x, y):
        return F.cross_entropy(m(x.to(TORCH[dtype])).float(), y)
    return loss_fn


def _np(t):
    return np.asarray(t).astype(np.float32)


@pytest.fixture(scope="module")
def jax_runs():
    """For each (block, dtype), computed once, from 8 steps of the JAX
    ``TrainStep`` under ``Momentum(LR, 0.9, multi_precision)`` (one
    compile): the first step's logits and loss, its gradients (by
    parameter name: each velocity after the first step, ``0.9 * 0 + g``,
    is the gradient exactly), the buffers (by name) after it, and the 8
    losses."""
    x, y = _batch()
    sig = ((x.shape, str(x.dtype)), (y.shape, str(y.dtype)))
    out = {}

    def run(block, dtype):
        jm, _ = _pair(block, dtype)
        opt = _jax_momentum(jm)
        box = []
        step = pt.TrainStep(jm, opt, _jax_loss(dtype, box))
        pure = step._make_pure()

        def with_logits(*args):
            box.clear()
            return pure(*args), box[0]

        compiled = jax.jit(with_logits, donate_argnums=(0, 1, 2),
                           compiler_options=NO_EXCESS)
        logits = []

        def call(*args):
            result, first = compiled(*args)
            logits.append(first)
            return result

        step._compiled[sig] = call
        losses = [float(np.asarray(step(x, y)._data))]
        one = dict(loss=losses[0], logits=_np(logits[0]),
                   grads={n: _np(opt._accumulators[p.name]["velocity"])
                          for n, p in jm.named_parameters()},
                   buffers={n: _np(b._data) for n, b in jm.named_buffers()})
        losses += [float(np.asarray(step(x, y)._data)) for _ in range(7)]
        one["losses"] = losses
        return one

    def get(block, dtype):
        if (block, dtype) not in out:
            out[block, dtype] = run(block, dtype)
        return out[block, dtype]

    return get


def _port_once(block, dtype):
    """The port's model after one forward and backward: (logits, loss,
    gradients by name, buffers by name)."""
    _, m = _pair(block, dtype)
    x, y = _batch()
    logits = m(torch.from_numpy(x).to(TORCH[dtype]))
    loss = F.cross_entropy(logits.float(), torch.from_numpy(y))
    loss.backward()
    return (logits.detach().float().numpy(), float(loss.detach()),
            {n: p.grad.float().numpy() for n, p in m.named_parameters()},
            {n: b.float().numpy() for n, b in m.named_buffers()})


@CASES
def test_logits_match(jax_runs, case):
    want = jax_runs(*case)
    logits, loss, _, _ = _port_once(*case)
    assert logits.shape == (B, CLASSES)
    if case[1] == "float32":
        scale = np.abs(want["logits"]).max()
        np.testing.assert_allclose(logits, want["logits"], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL * scale)
        np.testing.assert_allclose(loss, want["loss"], rtol=LOGIT_TOL)
    else:
        scale = np.abs(want["logits"]).max()
        np.testing.assert_allclose(logits, want["logits"], rtol=0,
                                   atol=BF16_LOGIT_STEPS * scale)


@CASES
def test_every_gradient_matches(jax_runs, case):
    want = jax_runs(*case)["grads"]
    _, _, got, _ = _port_once(*case)
    assert sorted(got) == sorted(want)
    for n in want:
        if case[1] == "float32":
            scale = np.abs(want[n]).max()
            np.testing.assert_allclose(got[n], want[n], rtol=GRAD_TOL,
                                       atol=GRAD_TOL * scale, err_msg=n)
        else:
            err = np.linalg.norm(got[n] - want[n]) / np.linalg.norm(want[n])
            assert err <= BF16_GRAD_L2, (n, err)


@CASES
def test_batch_norm_buffers_after_one_step(jax_runs, case):
    want = jax_runs(*case)["buffers"]
    _, _, _, got = _port_once(*case)
    assert sorted(got) == sorted(want)
    assert len(want) == (34 if case[0] == "bottleneck" else 24)
    _, m = _pair(*case)
    before = {n: b.float().numpy() for n, b in m.named_buffers()}
    for n in want:
        assert not np.array_equal(got[n], before[n]), n
        if case[1] == "float32":
            np.testing.assert_allclose(got[n], want[n], rtol=1e-5,
                                       atol=1e-6 * np.abs(want[n]).max(),
                                       err_msg=n)
        else:
            np.testing.assert_allclose(got[n], want[n], rtol=2 ** -7,
                                       atol=2 ** -8 * np.abs(want[n]).max(),
                                       err_msg=n)


@CASES
def test_train_step_trajectory_matches(jax_runs, case):
    block, dtype = case
    want = jax_runs(block, dtype)["losses"]
    _, m = _pair(block, dtype)
    opt = optim.Momentum(LR, 0.9, parameters=m.named_parameters(),
                         multi_precision=True)
    step = TrainStep(m, opt, _port_loss(dtype))
    x, y = _batch()
    got = [float(step(x, y)) for _ in range(8)]
    np.testing.assert_allclose(got, want, atol=LOSS_TOL[dtype], rtol=0)
    assert got[-1] < got[0] - 1.0          # it learns
    assert all(p.dtype == TORCH[dtype] for p in m.parameters())
    assert all(b.dtype == TORCH[dtype] for b in m.buffers())


def test_resnet50_state_has_the_reference_names_and_shapes():
    """``resnet50()``'s state dict (parameters and BatchNorm buffers)
    against the JAX one's, built only; and the JAX one's loads through
    ``convert``."""
    with _numpy_initializers():
        want = {k: tuple(v.shape) for k, v in
                jres.resnet50().state_dict().items()}
    m = resnet.resnet50(device="cpu")
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert got == want
    assert "layers.0.0.conv1.conv.weight" in got and "stem.bn._mean" in got
    assert sum(p.numel() for p in m.parameters()) == 25557032
    sd = {k: np.zeros(s, np.float32) for k, s in want.items()}
    m.load_state_dict(convert.resnet_params_from_jax(sd))
    # N(0, 2 / fan_in) convs without a bias; BatchNorm 1 and 0, 0 and 1
    w = resnet.resnet50(device="cpu").stem.conv.weight
    assert abs(float(w.std()) - (2.0 / (3 * 49)) ** 0.5) < 0.01
    assert m.stem.conv.bias is None


def test_resnet_params_from_jax_rejects_what_does_not_fit():
    jm, _ = _pair("bottleneck", "float32")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    assert set(convert.resnet_params_from_jax(sd)) == set(sd)
    missing = {k: v for k, v in sd.items()
               if k != "layers.1.0.downsample.bn._variance"}
    extra = dict(sd, **{"fc.extra": np.zeros(3, np.float32)})
    bad = dict(sd, **{"layers.2.0.conv2.conv.weight":
                      np.zeros((32, 32, 1, 1), np.float32)})
    gap = {k.replace("layers.3.", "layers.4."): v for k, v in sd.items()}
    no_fc = {k: v for k, v in sd.items() if k != "fc.weight"}
    for wrong in (missing, extra, bad, gap, no_fc):
        with pytest.raises(ValueError):
            convert.resnet_params_from_jax(wrong)


def test_resnet_params_from_jax_keeps_bfloat16():
    jm, m = _pair("basic", "bfloat16")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    assert {str(a.dtype) for a in sd.values()} == {"bfloat16"}
    got = convert.resnet_params_from_jax(sd)
    assert {t.dtype for t in got.values()} == {torch.bfloat16}
    for k, t in got.items():
        np.testing.assert_array_equal(t.float().numpy(),
                                      sd[k].astype(np.float32), err_msg=k)


def test_a_rebound_buffer_changes_the_graph_key():
    """A CUDA graph replays into the storage it captured: a BatchNorm
    buffer given new storage between calls must make a new key."""
    _, m = _pair("basic", "float32")
    opt = optim.Momentum(LR, 0.9, parameters=m.named_parameters())
    step = TrainStep(m, opt, _port_loss("float32"))
    x, y = _batch()
    batch = [torch.from_numpy(x), torch.from_numpy(y)]
    step(x, y)
    key = step._key(batch, None)
    assert key == step._key(batch, None)
    m.stem.bn._variance.mul_(1.0)            # in place: the same key
    assert step._key(batch, None) == key
    m.stem.bn._variance = m.stem.bn._variance.clone()   # rebound
    assert step._key(batch, None) != key


def test_resnet_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet.resnet18()
