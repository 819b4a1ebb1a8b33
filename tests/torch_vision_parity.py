"""The parity of paddle_tpu_torch's VGG and MobileNet V1/V2 training
steps with the JAX package's, on the CPU: the models, their state, the
JAX references and the checks that ``test_torch_vision_models.py``
(MobileNetV1), ``test_torch_vision_mobilenet_v2.py`` and
``test_torch_vision_vgg.py`` run, one model a module.

``MobileNetV1(scale=0.25)`` and ``MobileNetV2(scale=0.25)`` at batch 4
of 64 x 64 images (at 32 x 32 their last maps are 1 x 1, and BatchNorm
over the batch's 4 values there makes a trajectory part within a step or
two), ``vgg11`` at batch 2 of 32 x 32 images (its full classifier: the
512 x 7 x 7 -> 4096 -> 4096 head does not shrink with the images), 10
classes, float32 and cast to bfloat16 as ``bench.py:bench_resnet50``
casts ResNet-50, dropout 0 (the two packages' random streams differ),
``Momentum(lr, 0.9, multi_precision=True)`` at ``MODELS``' learning
rates. The MobileNets: 1e-5 in float32 (at 1e-4 their 4-step float32
trajectories part from the JAX package's by more than the JAX package's
own part under a one-rounding-step nudge of the images), 1e-4 in
bfloat16 (at 1e-5 the update hardly moves a bfloat16 weight, and the
losses move by less than the packages' bfloat16 spread). VGG-11: 1e-5,
as its 120M-weight head fits the two images in one step at 1e-3, after
which its losses are a thousandth and hold nothing.

The JAX models are built with the reference's initializers drawing from
a numpy generator (a JAX random op would compile for every parameter
shape) and their Momentum state made in numpy; the weights and
BatchNorm buffers go to the port through ``convert.mobilenet_params_
from_jax`` and ``convert.vgg_params_from_jax`` (the port's models built
with zeros once a module, as their state is replaced); the same numpy
batch from ``RandomState(0)`` goes through both, with bench_resnet50's
loss. Each JAX reference comes from one jitted ``TrainStep`` a (model,
type), excess precision off as ``test_torch_resnet`` runs it, computed
once a module: the first step's logits, loss, gradients (its
velocities) and buffers, and STEPS losses.

Limits. Float32: logits within 2^-12 of the largest |logit|; each
gradient within 2^-11 of its own largest entry, or, where it parts by
more, within twice as far as the JAX package's own leaf moves when its
images move by one rounding step either way; a leaf whose reference
gradient is rounding residue (its exact value is zero, as for a bias
before BatchNorm or a BatchNorm scale whose output the next BatchNorm
normalises away: below 2^-12 of the model's largest gradient entry)
within that band; each buffer within 1e-4 of the largest |value| of its
kind. Bfloat16: the JAX package's own bfloat16 error at this size, its
bfloat16 run against its float32 run (logits' largest difference, the
gradients' relative L2 distance, each buffer kind's largest difference).
Losses: each step within 1e-3 (bfloat16: twice the JAX package's own
bfloat16 logits error), the reference's loss at some step moved by more
than that, so that a step that updates nothing fails; where that does
not hold, both with each step's limit twice as far as the JAX package's
own loss at that step moves under the same nudge. Both
packages' float32 gradients are a few per cent from a float64
evaluation at batch 16 of these nets (BatchNorm over channels of nearly
no variance): the batch is kept at 4, where they are not.
"""
import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn.initializer as JI
from paddle_tpu import optim as joptim
from paddle_tpu.models.vision import mobilenet as jmb, vgg as jvgg
from paddle_tpu.utils import unique_name as jun
from paddle_tpu_torch import convert, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.vision import MobileNetV1, MobileNetV2, vgg11
from paddle_tpu_torch.nn import initializer as PI

from test_torch_resnet import NO_EXCESS, TORCH, _jax_loss, _np, _port_loss

CLASSES, STEPS = 10, 4
F32_LOGITS = 2 ** -12   # of the largest |logit|
F32_GRADS = 2 ** -11    # of the leaf's own largest |entry|
F32_RESIDUE = 2 ** -12  # of the model's largest gradient entry
F32_BUFFERS = 1e-4      # of the largest |value| of the buffer's kind
F32_LOSSES = 1e-3
# name: (JAX model, port model, keywords, (batch, image size), Momentum's
# learning rate by type, converter)
MOBILENET_LR = {"float32": 1e-5, "bfloat16": 1e-4}
MODELS = {
    "mobilenet_v1": (jmb.MobileNetV1, MobileNetV1, dict(scale=0.25),
                     (4, 64), MOBILENET_LR, convert.mobilenet_params_from_jax),
    "mobilenet_v2": (jmb.MobileNetV2, MobileNetV2,
                     dict(scale=0.25, dropout=0.0), (4, 64), MOBILENET_LR,
                     convert.mobilenet_params_from_jax),
    "vgg11": (jvgg.vgg11, vgg11, dict(dropout=0.0), (2, 32),
              {"float32": 1e-5, "bfloat16": 1e-5},
              convert.vgg_params_from_jax),
}


@pytest.fixture(scope="module")
def one_torch_thread():
    """The port's side on one thread while a module runs, for a module
    (the MobileNets') to use as an autouse fixture: their many small ops
    on a thread a core wait on each other when other test processes hold
    the cores (a MobileNet trajectory took 60-80 s beside five other
    pytest workers, 1-3 s alone). VGG-11's few large ops keep every
    thread: its 4 bfloat16 steps take 10.7 s on one, 2.9 s on eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(name, nudge=0, dtype="float32"):
    """The model's numpy batch, the images scaled by 1 + ``nudge``
    rounding steps of ``dtype`` (2^-23, bfloat16 2^-8)."""
    B, size = MODELS[name][3]
    rng = np.random.RandomState(0)
    x = rng.randn(B, 3, size, size).astype(np.float32)
    y = rng.randint(0, CLASSES, (B,)).astype(np.int32)
    ulp = 2 ** -23 if dtype == "float32" else 2 ** -8
    return x * np.float32(1 + nudge * ulp), y


@contextlib.contextmanager
def _patched(cls, call):
    real = cls.__call__
    cls.__call__ = call
    try:
        yield
    finally:
        cls.__call__ = real


def _numpy_initializers():
    """The JAX package's initializers (``Constant``, ``Normal``,
    ``XavierUniform``: all these models use) drawing float32 from
    ``np.random.default_rng(0)`` while a model is built."""
    rng = np.random.default_rng(0)

    def draw(init, shape, dtype="float32", key=None):
        shape = tuple(int(s) for s in shape)
        if isinstance(init, JI.Constant):
            a = np.full(shape, init.value, np.float32)
        elif isinstance(init, JI.Normal):
            a = rng.standard_normal(shape, np.float32) * np.float32(
                init.std) + np.float32(init.mean)
        elif isinstance(init, JI.XavierUniform):
            fan_in, fan_out = JI._fans(shape)
            limit = np.float32(init.gain * np.sqrt(6.0 / (fan_in + fan_out)))
            a = (rng.random(shape, np.float32) * 2 - 1) * limit
        else:
            raise TypeError(f"no numpy draw for {type(init).__name__}")
        return jnp.asarray(a.astype(np.dtype(dtype)))

    return _patched(JI.Initializer, draw)


def _zero_initializers():
    """The JAX initializers filling zeros (no draw, no compile): for a
    model whose state is replaced next, or read only for its names and
    shapes."""
    def zeros(init, shape, dtype="float32", key=None):
        return jnp.asarray(np.zeros(tuple(int(s) for s in shape),
                                    np.dtype(dtype)))

    return _patched(JI.Initializer, zeros)


def _port_zero_initializers():
    """The port's drawing initializers filling zeros, for a model whose
    state is replaced next or read only for its names and shapes (VGG's
    heads take seconds to draw)."""
    def zeros(init, shape, dtype=torch.float32, device=None,
              generator=None):
        return torch.zeros(tuple(int(s) for s in shape), dtype=dtype,
                           device=device)

    return _patched(PI.Initializer, zeros)


@functools.lru_cache(maxsize=None)
def _state(name, dtype):
    """The JAX model's parameters and buffers as drawn by the reference's
    initializers, in ``dtype`` (bfloat16 rounded in numpy, to nearest,
    ties to even, as XLA's convert does), made once a module: callers
    read it and do not change it."""
    if dtype == "bfloat16":
        return {k: v.astype(jnp.bfloat16)
                for k, v in _state(name, "float32").items()}
    jmake, _, kw, _, _, _ = MODELS[name]
    with _numpy_initializers():
        jm = jmake(num_classes=CLASSES, **kw)
    return {k: np.asarray(v._data) for k, v in jm.state_dict().items()}


def _jax_model(name, dtype):
    """The JAX model holding ``_state(name, dtype)``: built with zeros,
    then its parameters and buffers replaced."""
    jmake, _, kw, _, _, _ = MODELS[name]
    # the same parameter names for every build: a jitted step reads them
    with jun.guard(), _zero_initializers():
        jm = jmake(num_classes=CLASSES, **kw)
    if dtype == "bfloat16":
        for layer in jm.sublayers(include_self=True):
            layer._dtype = jnp.bfloat16
    sd = _state(name, dtype)
    for n, t in list(jm.named_parameters()) + list(jm.named_buffers()):
        t._replace(jnp.asarray(sd[n]))
    return jm


@functools.lru_cache(maxsize=None)
def _port_template(name):
    """The port's float32 model (CPU), built with zeros once a module."""
    _, tmake, kw, _, _, _ = MODELS[name]
    with _port_zero_initializers():
        return tmake(num_classes=CLASSES, device="cpu", **kw)


def _port_model(name, dtype):
    """A fresh copy of the port's model in ``dtype`` holding
    ``_state(name, dtype)`` through the converter."""
    m = copy.deepcopy(_port_template(name))
    if dtype == "bfloat16":
        m.bfloat16()
    m.load_state_dict(MODELS[name][5](_state(name, dtype)))
    return m


def _jax_momentum(jm, lr):
    """The JAX ``Momentum(lr, 0.9, multi_precision=True)`` over ``jm``,
    its state made in numpy (``test_torch_resnet._jax_momentum``'s, at
    another learning rate)."""
    opt = joptim.Momentum(learning_rate=lr, momentum=0.9,
                          parameters=jm.parameters(), multi_precision=True)
    for p in jm.parameters():
        a = np.asarray(p._data)
        state = {"velocity": jnp.asarray(np.zeros(a.shape, np.float32))}
        if a.dtype != np.float32:
            state["master"] = jnp.asarray(a.astype(np.float32))
        opt._accumulators[p.name] = state
    return opt


@pytest.fixture(scope="module")
def jax_runs():
    """``get(name, dtype)``: from STEPS steps of the JAX ``TrainStep``
    under ``Momentum(lr, 0.9, multi_precision)``, computed once, the
    first step's logits and loss, its gradients (each velocity after the
    first step is the gradient), the buffers after it, and the losses;
    ``get(name, dtype, nudge)`` the same from ``_batch(name, nudge,
    dtype)``, with the same compiled step."""
    out, steps = {}, {}

    def run(name, dtype, nudge):
        x, y = _batch(name, nudge, dtype)
        sig = ((x.shape, str(x.dtype)), (y.shape, str(y.dtype)))
        jm = _jax_model(name, dtype)
        opt = _jax_momentum(jm, MODELS[name][4][dtype])
        box = []
        step = jpt.TrainStep(jm, opt, _jax_loss(dtype, box))
        if (name, dtype) not in steps:
            pure = step._make_pure()

            def with_logits(*args):
                box.clear()
                return pure(*args), box[0]

            steps[name, dtype] = jax.jit(with_logits, donate_argnums=(0, 1, 2),
                                         compiler_options=NO_EXCESS)
        compiled = steps[name, dtype]
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
        losses += [float(np.asarray(step(x, y)._data))
                   for _ in range(STEPS - 1)]
        one["losses"] = np.asarray(losses)
        return one

    def get(name, dtype, nudge=0):
        if (name, dtype, nudge) not in out:
            out[name, dtype, nudge] = run(name, dtype, nudge)
        return out[name, dtype, nudge]

    get.own = {}        # _own_bf16_error's, by model
    return get


@pytest.fixture(scope="module")
def port_once():
    """The port's model after one forward and backward, once a (model,
    dtype): (logits, loss, gradients by name, buffers by name, buffers
    before)."""
    out = {}

    def get(name, dtype):
        if (name, dtype) not in out:
            m = _port_model(name, dtype)
            before = {n: b.float().numpy().copy()
                      for n, b in m.named_buffers()}
            x, y = _batch(name)
            logits = m(torch.from_numpy(x).to(TORCH[dtype]))
            loss = torch.nn.functional.cross_entropy(
                logits.float(), torch.from_numpy(y).long())
            loss.backward()
            out[name, dtype] = (
                logits.detach().float().numpy(), float(loss.detach()),
                {n: p.grad.float().numpy() for n, p in m.named_parameters()},
                {n: b.float().numpy() for n, b in m.named_buffers()},
                before)
        return out[name, dtype]

    return get


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _cat(grads):
    return np.concatenate([grads[n].ravel() for n in sorted(grads)])


def _own_bf16_error(jax_runs, name):
    """The JAX package's own bfloat16 error at this size: how far its
    bfloat16 run is from its float32 run (logits' largest difference,
    the gradients' relative L2 distance, each buffer kind's largest
    difference); computed once a module."""
    if name not in jax_runs.own:
        w16, w32 = jax_runs(name, "bfloat16"), jax_runs(name, "float32")
        jax_runs.own[name] = dict(
            logits=np.abs(w16["logits"] - w32["logits"]).max(),
            grads=_rel_l2(_cat(w16["grads"]), _cat(w32["grads"])),
            buffers={k: max(np.abs(w16["buffers"][n]
                                   - w32["buffers"][n]).max()
                            for n in w16["buffers"] if n.endswith(k))
                     for k in ("_mean", "_variance")})
    return jax_runs.own[name]


def logits_match(jax_runs, port_once, case):
    want = jax_runs(*case)
    logits, loss, _, _, _ = port_once(*case)
    assert logits.shape == (MODELS[case[0]][3][0], CLASSES)
    if case[1] == "float32":
        scale = np.abs(want["logits"]).max()
        np.testing.assert_allclose(logits, want["logits"], rtol=0,
                                   atol=F32_LOGITS * scale)
        np.testing.assert_allclose(loss, want["loss"], rtol=F32_LOGITS)
    else:
        own = _own_bf16_error(jax_runs, case[0])["logits"]
        assert np.abs(logits - want["logits"]).max() <= own


def _nudge_spread(jax_runs, name, dtype, key):
    """How far the JAX package's own ``key`` ("grads": each leaf's, or
    "losses") moves, entry by entry, when its images move by one rounding
    step either way: the largest move of the two."""
    want = jax_runs(name, dtype)[key]
    moved = [jax_runs(name, dtype, n)[key] for n in (1, -1)]
    if key == "losses":
        return np.max([np.abs(m - want) for m in moved], axis=0)
    return {k: max(np.abs(m[k] - g).max() for m in moved)
            for k, g in want.items()}


def every_gradient_matches(jax_runs, port_once, case):
    """Float32: each leaf within 2^-11 of its own largest entry or, where
    it parts by more, within twice as far as the JAX package's own leaf
    moves under a one-rounding-step nudge of the images (a ReLU's input
    near zero can change side); a leaf whose reference gradient is
    rounding residue (below F32_RESIDUE of the model's largest entry)
    within that band. Bfloat16: the gradients' relative L2 error within
    the JAX package's own."""
    name, dtype = case
    want = jax_runs(*case)["grads"]
    got = port_once(*case)[2]
    assert sorted(got) == sorted(want)
    if dtype == "bfloat16":
        err = _rel_l2(_cat(got), _cat(want))
        assert err <= _own_bf16_error(jax_runs, name)["grads"], err
        return
    largest = {n: np.abs(g).max() for n, g in want.items()}
    residue = F32_RESIDUE * max(largest.values())
    real = {n for n, v in largest.items() if v >= residue}
    assert len(real) > len(want) // 2
    atol = {n: F32_GRADS * largest[n] if n in real else residue
            for n in want}
    err = {n: np.abs(got[n] - g).max() for n, g in want.items()}
    if any(err[n] > atol[n] for n in want):
        spread = _nudge_spread(jax_runs, name, dtype, "grads")
        atol = {n: max(a, 2 * spread[n]) for n, a in atol.items()}
    for n in want:
        assert err[n] <= atol[n], (n, err[n], atol[n])


def batch_norm_buffers_after_one_step(jax_runs, port_once, case):
    want = jax_runs(*case)["buffers"]
    _, _, _, got, before = port_once(*case)
    assert sorted(got) == sorted(want)
    assert len(want) == {"mobilenet_v1": 54, "mobilenet_v2": 104,
                         "vgg11": 16}[case[0]]
    own = (_own_bf16_error(jax_runs, case[0])["buffers"]
           if case[1] == "bfloat16" else None)
    for kind in ("_mean", "_variance"):
        names = [n for n in want if n.endswith(kind)]
        scale = max(np.abs(want[n]).max() for n in names)
        for n in names:
            assert not np.array_equal(got[n], before[n]), n
            # bfloat16: at least one rounding step of the largest value
            atol = F32_BUFFERS * scale if case[1] == "float32" else max(
                own[kind], 2 ** -7 * scale)
            np.testing.assert_allclose(got[n], want[n], rtol=0, atol=atol,
                                       err_msg=n)


def _port_losses(name, dtype):
    """STEPS losses of the port's ``TrainStep`` from ``_state``."""
    m = _port_model(name, dtype)
    opt = optim.Momentum(MODELS[name][4][dtype], 0.9,
                         parameters=m.named_parameters(),
                         multi_precision=True)
    step = TrainStep(m, opt, _port_loss(dtype))
    x, y = _batch(name)
    losses = np.asarray([float(step(x, y)) for _ in range(STEPS)])
    assert all(p.dtype == TORCH[dtype] for p in m.parameters())
    return losses


def train_step_trajectory_matches(jax_runs, case):
    """The port's STEPS losses from the same state as the JAX package's,
    each within F32_LOSSES (bfloat16: twice the JAX package's own
    bfloat16 error of the logits, which bounds a cross-entropy's), with
    the reference's loss at some step moved from its first by more than
    that, so that a step that updates nothing fails. Where that does not
    hold, the limit of each step is twice as far as the JAX package's own
    loss there moves when its images move by one rounding step either way
    (at least F32_LOSSES): BatchNorm over a few values makes a trajectory
    chaotic within a few steps, and bfloat16 more so."""
    name, dtype = case
    want = jax_runs(name, dtype)["losses"]
    got = _port_losses(name, dtype)
    limit = np.full(STEPS, F32_LOSSES if dtype == "float32" else max(
        F32_LOSSES, 2 * _own_bf16_error(jax_runs, name)["logits"]))

    def holds():
        return ((np.abs(got - want) <= limit).all()
                and (np.abs(want - want[0]) > limit).any())

    if not holds():
        limit = np.maximum(F32_LOSSES, 2 * _nudge_spread(
            jax_runs, name, dtype, "losses"))
    assert (np.abs(got - want) <= limit).all(), (got, want, limit)
    assert (np.abs(want - want[0]) > limit).any(), (want, limit)


def parity_tests(name):
    """The four parity tests of model ``name`` in float32 and bfloat16,
    for a test module to bind as ``test_*`` names (with the fixtures
    ``jax_runs`` and ``port_once`` imported beside them): each model's
    JAX references take seconds to compile, and a module a model keeps
    each module's time short."""
    cases = pytest.mark.parametrize("case", [
        (name, d) for d in ("float32", "bfloat16")],
        ids=lambda c: "-".join(c))

    @cases
    def test_logits(jax_runs, port_once, case):
        logits_match(jax_runs, port_once, case)

    @cases
    def test_gradients(jax_runs, port_once, case):
        every_gradient_matches(jax_runs, port_once, case)

    @cases
    def test_buffers(jax_runs, port_once, case):
        batch_norm_buffers_after_one_step(jax_runs, port_once, case)

    @cases
    def test_trajectory(jax_runs, case):
        train_step_trajectory_matches(jax_runs, case)

    return test_logits, test_gradients, test_buffers, test_trajectory
