"""paddle_tpu_torch's GPT training step against the JAX package's.

The configuration of ``tests/test_pallas_routing.py`` (vocab 512, hidden
128, 2 layers, 2 heads, seq 128, batch 8, AdamW at 3e-3, global-norm
clip 1.0, dropout 0): the JAX ``GPT``'s weights go to the port through
``convert.gpt_params_from_jax``, the same numpy token ids go through
both, and the port (on the CPU: the kernels' plain versions) is held to
the JAX package on the logits, every parameter's gradient after one
backward, and the 8-step ``TrainStep`` loss trajectory — with the JAX
package's dense paths and with its Pallas kernels (interpret mode,
``pallas.set_enabled(True)``) as its live path.

Tolerances (atol and rtol): logits 1e-5 (float32, |logit| < 2; the two
differ in summation order only); gradients 1e-5 relative to the
largest entry of each (float32 sums over 1024 tokens); losses 5e-5 over
8 steps (AdamW's first steps turn tiny gradient differences into
parameter steps of ~lr, which the later losses carry; the observed gap
is ~5e-6).

The same configuration in bfloat16 (``model.bfloat16()`` on the JAX
side, ``GPTConfig(dtype="bfloat16")`` on the port's) with
``multi_precision`` AdamW, bench_gpt's recipe. At dropout 0 both sides
take their flash paths (the JAX kernel in interpret mode under the
``pallas`` fixture). The two frameworks round bfloat16 at different
places (the JAX package rounds after each elementwise op, torch after
each fused one), so the tolerances are bfloat16's: logits 2^-6, two
bfloat16 steps at the largest |logit| (1.79; seen: one step, 2^-7, on
both JAX paths); losses 3e-2 absolute over 8 steps at lr 3e-3 (seen:
<= 1.8e-2; the JAX package's own dense and Pallas paths differ from each
other by up to 2.2e-2 over the same 8 steps). Given the same bfloat16
parameters and gradients, the optimizers agree exactly on the bfloat16
parameters, and on the float32 masters to one float32 step. With the
root correctly rounded on both sides (``optim/optimizer.py`` ``_sqrt``)
the model's 478,720 masters agree bitwise on the CPU; in the AdamW case
of the optimizer test below 1 of 3072 differs by one step, since that
test hands the reference's update a Python float lr, so it decays by
f32(lr * coeff) where the port decays by f32(lr) * f32(coeff) (ROADMAP,
"Decoupled-decay rounding").
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
from paddle_tpu.ops import pallas as pk
from paddle_tpu_torch import convert, core, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.nlp import gpt
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn.functional import sdpa_bhld
from paddle_tpu_torch.ops import kernels

from torch_test_threads import torch_threads  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=512, hidden=128, layers=2, heads=2, max_seq=128,
           dropout=0.0)
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-5
LOSS_TOL = 5e-5
BF16_LOGIT_TOL = 2 ** -6
BF16_LOSS_TOL = 3e-2
F32_STEP = 2 ** -23    # one float32 step, relative


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, CFG["vocab_size"], (8, 128)).astype("int32")
    return ids, np.roll(ids, -1, axis=1).astype("int32")


def _pair(seed=0, dtype="float32"):
    """A JAX GPT from ``seed`` and the port's GPT (CPU) with its weights,
    both in ``dtype`` (the JAX model cast with ``bfloat16()``, as
    ``bench.py:bench_gpt`` does)."""
    pt.seed(seed)
    jm = jgpt.GPT(jgpt.GPTConfig(**CFG))
    if dtype == "bfloat16":
        jm.bfloat16()
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    m = gpt.GPT(gpt.GPTConfig(**CFG, dtype=dtype), device="cpu")
    m.load_state_dict(convert.gpt_params_from_jax(sd))
    return jm, m


@pytest.fixture(scope="module")
def port_runs():
    """The port's side of each comparison, computed once a module: it does
    not depend on the path the JAX side takes (dense or Pallas), so a
    test's two ``pallas`` cases share it. Keyed by the test."""
    return {}


def _once(cache, key, fn):
    if key not in cache:
        cache[key] = fn()
    return cache[key]


@pytest.fixture(params=[False, True], ids=["jax-dense", "jax-pallas"])
def pallas(request):
    pk.set_enabled(request.param)
    yield request.param
    pk.set_enabled(None)


def test_logits_match(pallas, port_runs):
    jm, m = _pair()
    ids, _ = _batch()
    want = np.asarray(jm(pt.to_tensor(ids))._data)

    def port():
        with torch.no_grad():
            return m(torch.from_numpy(ids)).numpy()

    got = _once(port_runs, "logits", port)
    assert got.shape == (8, 128, CFG["vocab_size"])
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_every_gradient_matches(pallas, port_runs):
    jm, m = _pair()
    ids, labels = _batch()
    jl = jgpt.gpt_loss(jm, pt.to_tensor(ids), pt.to_tensor(labels))
    jl.backward()
    want = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}

    def port():
        loss = gpt.gpt_loss(m, torch.from_numpy(ids),
                            torch.from_numpy(labels))
        loss.backward()
        return float(loss.detach()), {n: p.grad.numpy()
                                      for n, p in m.named_parameters()}

    loss, got = _once(port_runs, "grads", port)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(loss, float(np.asarray(jl._data)),
                               rtol=LOGIT_TOL)
    for n in want:
        scale = np.abs(want[n]).max()
        np.testing.assert_allclose(got[n], want[n], rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, err_msg=n)


def test_train_step_trajectory_matches(pallas, port_runs):
    jm, m = _pair()
    ids, labels = _batch()
    jopt = joptim.AdamW(parameters=jm.parameters(), learning_rate=3e-3,
                        grad_clip=joptim.ClipGradByGlobalNorm(1.0))
    jstep = pt.TrainStep(jm, jopt, jgpt.gpt_loss)
    want = [float(np.asarray(jstep(ids, labels)._data)) for _ in range(8)]

    def port():
        opt = optim.AdamW(parameters=m.named_parameters(),
                          learning_rate=3e-3,
                          grad_clip=optim.ClipGradByGlobalNorm(1.0))
        step = TrainStep(m, opt, gpt.gpt_loss)
        got = [float(step(ids, labels)) for _ in range(8)]
        return got, bool(step.last_found_inf)

    got, found_inf = _once(port_runs, "trajectory", port)
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=LOSS_TOL)
    assert got[-1] < got[0] - 0.5          # it learns
    assert not found_inf


def test_bf16_logits_match(pallas, port_runs):
    jm, m = _pair(dtype="bfloat16")
    ids, _ = _batch()
    want = np.asarray(jm(pt.to_tensor(ids))._data)

    def port():
        with torch.no_grad():
            return m(torch.from_numpy(ids))

    got = _once(port_runs, "bf16 logits", port)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               atol=BF16_LOGIT_TOL, rtol=0)


def test_bf16_multi_precision_trajectory_matches(pallas, port_runs):
    jm, m = _pair(dtype="bfloat16")
    ids, labels = _batch()
    jopt = joptim.AdamW(parameters=jm.parameters(), learning_rate=3e-3,
                        multi_precision=True,
                        grad_clip=joptim.ClipGradByGlobalNorm(1.0))
    jstep = pt.TrainStep(jm, jopt, jgpt.gpt_loss)
    want = [float(np.asarray(jstep(ids, labels)._data)) for _ in range(8)]

    def port():
        opt = optim.AdamW(parameters=m.named_parameters(),
                          learning_rate=3e-3, multi_precision=True,
                          grad_clip=optim.ClipGradByGlobalNorm(1.0))
        step = TrainStep(m, opt, gpt.gpt_loss)
        got = [float(step(ids, labels)) for _ in range(8)]
        return got, m, opt

    got, m, opt = _once(port_runs, "bf16 trajectory", port)
    np.testing.assert_allclose(got, want, atol=BF16_LOSS_TOL, rtol=0)
    assert got[-1] < got[0] - 0.5          # it learns
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    masters = [s["master"] for s in opt._accumulators.values()]
    assert len(masters) == len(list(m.parameters()))
    assert all(t.dtype == torch.float32 for t in masters)


def test_bf16_masters_match_from_the_same_gradients():
    """One clipped multi_precision AdamW step on both sides from the JAX
    model's own bfloat16 gradients: the same inputs, so the same bfloat16
    parameters and (to one float32 step) the same float32 masters."""
    jm, m = _pair(dtype="bfloat16")
    ids, labels = _batch()
    jgpt.gpt_loss(jm, pt.to_tensor(ids), pt.to_tensor(labels)).backward()
    jparams = dict(jm.named_parameters())
    for n, p in m.named_parameters():
        p.grad = torch.from_numpy(np.asarray(
            jparams[n].grad._data).astype(np.float32)).to(torch.bfloat16)
    jopt = joptim.AdamW(parameters=jm.parameters(), learning_rate=3e-3,
                        multi_precision=True,
                        grad_clip=joptim.ClipGradByGlobalNorm(1.0))
    opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=3e-3,
                      multi_precision=True,
                      grad_clip=optim.ClipGradByGlobalNorm(1.0))
    jopt.step()
    opt.step()
    for n, p in m.named_parameters():
        jp = jparams[n]
        want = np.asarray(jopt._accumulators[jp.name]["master"])
        got = opt._accumulators[n]["master"].numpy()
        np.testing.assert_allclose(got, want, rtol=F32_STEP, atol=0,
                                   err_msg=n)
        np.testing.assert_array_equal(
            p.detach().float().numpy(),
            np.asarray(jp._data).astype(np.float32), err_msg=n)


def test_train_step_runs_no_kernel_on_the_cpu():
    _, m = _pair()
    ids, labels = _batch()
    opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=3e-3)
    kernels.reset_launches()
    TrainStep(m, opt, gpt.gpt_loss)(ids, labels)
    assert set(kernels.launches().values()) == {0}


def test_check_nan_flags_and_raises():
    _, m = _pair()
    ids, labels = _batch()
    opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=3e-3)
    step = TrainStep(m, opt, gpt.gpt_loss, check_nan=True)
    step(ids, labels)
    assert not bool(step.last_found_inf)
    with torch.no_grad():
        m.blocks[0].fc1.weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError):
        step(ids, labels)
    assert bool(step.last_found_inf)


# -- optimizer and clip against the JAX package ------------------------------


def _grads(rng, shapes, scale):
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("clip_norm, scale", [(1.0, 1.0), (100.0, 0.01)])
def test_clip_by_global_norm_matches(clip_norm, scale):
    rng = np.random.RandomState(3)
    gs = _grads(rng, [(4, 5), (7,), (3, 3)], scale)
    want = joptim.ClipGradByGlobalNorm(clip_norm)._apply(
        [(None, pt.to_tensor(g)._data) for g in gs])
    got = optim.ClipGradByGlobalNorm(clip_norm)(
        [(None, torch.from_numpy(g)) for g in gs])
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


class _Named:
    """A parameter as the reference's AdamW hands it to ``lr_ratio``
    (``optimizer.py:327-328``): an object with the parameter's ``.name``."""

    def __init__(self, name):
        self.name = name


@pytest.mark.parametrize("kind", ["adam_l2", "adamw", "adamw_excluded",
                                  "adamw_lr_ratio"])
def test_optimizer_update_matches(kind):
    """Three updates of two parameters through each update rule. The
    ``lr_ratio`` case passes one callable to both packages: it reads the
    parameter's ``.name``, as reference recipes do, and gives the two
    parameters different ratios."""
    import jax.numpy as jnp

    names = ("ln.bias", "fc.weight")
    rng = np.random.RandomState(4)
    p0s = [rng.randn(6, 5).astype(np.float32) for _ in names]
    gs = [_grads(rng, [(6, 5)] * len(names), 0.1) for _ in range(3)]
    ps = [torch.nn.Parameter(torch.from_numpy(p0.copy())) for p0 in p0s]
    named = list(zip(names, ps))
    kw = {}
    if kind == "adam_l2":
        jopt = joptim.Adam(learning_rate=0.01, parameters=[],
                           weight_decay=0.1)
        opt = optim.Adam(learning_rate=0.01, parameters=named,
                         weight_decay=0.1)
    else:
        if kind == "adamw_excluded":
            kw["apply_decay_param_fun"] = lambda n: n != "ln.bias"
        if kind == "adamw_lr_ratio":
            kw["lr_ratio"] = lambda prm: (0.5 if prm.name.endswith("bias")
                                          else 2.0)
        jopt = joptim.AdamW(learning_rate=0.01, parameters=[],
                            weight_decay=0.05, **kw)
        opt = optim.AdamW(learning_rate=0.01, parameters=named,
                          weight_decay=0.05, **kw)
    jps = [jnp.asarray(p0) for p0 in p0s]
    jss = [jopt._init_state(jp) for jp in jps]
    for step_gs in gs:
        for i, (name, g) in enumerate(zip(names, step_gs)):
            jopt._current_param = _Named(name)
            jg = jnp.asarray(g)
            if kind == "adam_l2":
                jg = jopt._regularization(jps[i], jg)
            jps[i], jss[i] = jopt._update(jps[i], jg, jss[i], 0.01)
            ps[i].grad = torch.from_numpy(g.copy())
        opt.step()
    for name, p, jp in zip(names, ps, jps):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_float32_step_is_the_reference_bitwise(kind):
    """One float32 Adam / AdamW step of a (256, 256) parameter: the
    moments and the parameter are the reference's bits. The square root
    is correctly rounded on both sides (``optim/optimizer.py`` ``_sqrt``;
    torch's CPU float32 ``sqrt`` alone differs from it in about one
    value in six on some hosts)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(6)
    p0 = (rng.randn(256, 256) * 0.02).astype(np.float32)
    g = (rng.randn(256, 256) * 1e-3).astype(np.float32)
    cls, tcls = ((joptim.Adam, optim.Adam) if kind == "adam"
                 else (joptim.AdamW, optim.AdamW))
    kw = {} if kind == "adam" else {"weight_decay": 0.01}
    jopt = cls(learning_rate=1e-3, parameters=[], **kw)
    jopt._current_param = _Named("w")
    # lr as a float32 scalar, as the reference's TrainStep passes it
    # (jit.py:422), whose decay the port follows (ROADMAP, "Decoupled-decay
    # rounding": with a Python float the eager step decays by f32(lr*coeff))
    jp, js = jopt._update(jnp.asarray(p0), jnp.asarray(g),
                          jopt._init_state(jnp.asarray(p0)),
                          jnp.float32(1e-3))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tcls(learning_rate=1e-3, parameters=[("w", p)], **kw)
    p.grad = torch.from_numpy(g.copy())
    opt.step()
    s = opt._accumulators["w"]
    for key in ("moment1", "moment2"):
        np.testing.assert_array_equal(s[key].numpy(), np.asarray(js[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jp))


@pytest.mark.parametrize("layer", ["Linear", "ColumnParallelLinear",
                                   "RowParallelLinear"])
def test_linear_without_bias_has_none(layer):
    """``bias_attr=False`` makes no bias, as the reference's
    ``create_parameter`` returns None for it (``nn/layer.py:78-80``; its
    tensor-parallel layers say ``has_bias=False``): the state dicts have
    the same keys, and from copied weights one AdamW step gives the same
    output. Tolerance 1e-6: float32 products summed in another order."""
    from paddle_tpu import nn as jnn
    from paddle_tpu.dist import tp_layers as jtp
    from paddle_tpu_torch import dist as tdist
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.nn.initializer import Constant

    pt.seed(0)
    if layer == "Linear":
        jl, cls = jnn.Linear(8, 4, bias_attr=False), tnn.Linear
    else:
        jl = getattr(jtp, layer)(8, 4, has_bias=False)
        cls = getattr(tdist, layer)
    tl = cls(8, 4, weight_attr=Constant(0.0), bias_attr=False,
             device="cpu")
    assert tl.bias is None
    assert sorted(tl.state_dict()) == sorted(jl.state_dict()) == ["weight"]
    tl.load_state_dict({k: torch.from_numpy(np.array(v._data))
                        for k, v in jl.state_dict().items()})
    rng = np.random.RandomState(8)
    x, g = rng.randn(5, 8).astype(np.float32), rng.randn(5, 4).astype(
        np.float32)
    (jl(pt.to_tensor(x)) * pt.to_tensor(g)).sum().backward()
    joptim.AdamW(parameters=jl.parameters(), learning_rate=0.1).step()
    (tl(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    optim.AdamW(parameters=tl.named_parameters(), learning_rate=0.1).step()
    assert [n for n, _ in tl.named_parameters()] == ["weight"]
    with torch.no_grad():
        got = tl(torch.from_numpy(x)).numpy()
    want = np.asarray(jl(pt.to_tensor(x))._data)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("multi_precision", [False, True],
                         ids=["bf16", "bf16-master"])
@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_bf16_update_rounds_as_the_reference(kind, multi_precision):
    """Three updates of a bfloat16 parameter. Without ``multi_precision``
    the reference rounds the Adam step to bfloat16 and AdamW rounds again
    after its decay (``optimizer.py:305``, ``:333-335``): the parameters
    must be the same bits. With it, the update runs on a float32 master
    and the parameter is the master rounded."""
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    p0 = (rng.randn(64, 48) * 0.02).astype(np.float32)
    gs = [(rng.randn(64, 48) * 0.1).astype(np.float32) for _ in range(3)]
    cls, tcls = ((joptim.Adam, optim.Adam) if kind == "adam"
                 else (joptim.AdamW, optim.AdamW))
    kw = {} if kind == "adam" else {"weight_decay": 0.05}
    jopt = cls(learning_rate=1e-3, parameters=[],
               multi_precision=multi_precision, **kw)
    jopt._current_param = _Named("w")
    jp = jnp.asarray(p0).astype(jnp.bfloat16)
    js = jopt._init_state(jp)
    master = jp.astype(jnp.float32)
    p = torch.nn.Parameter(torch.from_numpy(
        np.array(jp.astype(jnp.float32))).to(torch.bfloat16))
    if multi_precision:
        kw["multi_precision"] = True
    opt = tcls(learning_rate=1e-3, parameters=[("w", p)], **kw)
    for g in gs:
        jg = jnp.asarray(g).astype(jnp.bfloat16)
        if multi_precision:     # Optimizer.step with a master
            master, js = jopt._update(master, jg.astype(jnp.float32), js,
                                      1e-3)
            jp = master.astype(jnp.bfloat16)
        else:
            jp, js = jopt._update(jp, jg, js, 1e-3)
        p.grad = torch.from_numpy(
            np.array(jg.astype(jnp.float32))).to(torch.bfloat16)
        opt.step()
    assert p.dtype == torch.bfloat16
    np.testing.assert_array_equal(p.detach().float().numpy(),
                                  np.asarray(jp.astype(jnp.float32)))
    if multi_precision:
        np.testing.assert_allclose(opt._accumulators["w"]["master"].numpy(),
                                   np.asarray(master), rtol=F32_STEP, atol=0)
    else:
        assert "master" not in opt._accumulators["w"]


# -- weights, dropout, device ------------------------------------------------


def test_gpt_params_from_jax_rejects_what_does_not_fit():
    jm, _ = _pair()
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    assert set(convert.gpt_params_from_jax(sd)) == set(sd)
    missing = dict(sd)
    del missing["blocks.1.fc2.bias"]
    extra = dict(sd, **{"blocks.1.extra": np.zeros(3, np.float32)})
    bad = dict(sd, **{"blocks.0.attn.qkv.weight": np.zeros((128, 128),
                                                           np.float32)})
    gap = {k.replace("blocks.1.", "blocks.2."): v for k, v in sd.items()}
    for wrong in (missing, extra, bad, gap):
        with pytest.raises(ValueError):
            convert.gpt_params_from_jax(wrong)


def test_gpt_params_from_jax_keeps_bfloat16():
    jm, m = _pair(dtype="bfloat16")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    assert {str(a.dtype) for a in sd.values()} == {"bfloat16"}
    got = convert.gpt_params_from_jax(sd)
    assert {t.dtype for t in got.values()} == {torch.bfloat16}
    for k, t in got.items():
        np.testing.assert_array_equal(t.float().numpy(),
                                      sd[k].astype(np.float32), err_msg=k)
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    # a float32 model takes the same weights exactly
    f32 = gpt.GPT(gpt.GPTConfig(**CFG), device="cpu")
    f32.load_state_dict(got)
    assert torch.equal(f32.wte.weight, got["wte.weight"].float())


def test_dropout_is_reproducible_from_one_seed_and_off_in_eval():
    cfg = gpt.GPTConfig(**dict(CFG, dropout=0.1))
    ids, labels = (torch.from_numpy(a) for a in _batch())

    def losses(seed):
        core.seed(seed)
        m = gpt.GPT(cfg, device="cpu")
        opt = optim.AdamW(parameters=m.named_parameters(),
                          learning_rate=3e-3)
        step = TrainStep(m, opt, gpt.gpt_loss)
        return [float(step(ids, labels)) for _ in range(2)], m

    a, m = losses(5)
    b, _ = losses(5)
    c, _ = losses(6)
    assert a == b and a != c
    m.eval()
    x = torch.randn(4, 8)
    assert Dropout(0.5).eval()(x) is x
    with torch.no_grad():
        # eval takes the flash path's plain version on the CPU: no
        # dropout, same logits
        assert torch.equal(m(ids[:1]), m(ids[:1]))


def test_attention_dropout_applies_to_the_weights():
    q, k, v = (torch.randn(2, 3, 16, 8, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3))
    out = sdpa_bhld(q, k, v, is_causal=True, dropout_p=0.25,
                    generator=torch.Generator().manual_seed(9))
    scores = torch.matmul(q, k.transpose(-1, -2)) / 8 ** 0.5
    causal = torch.ones(16, 16, dtype=torch.bool).tril()
    w = torch.softmax(scores.masked_fill(~causal, -1e30), dim=-1)
    keep = torch.rand(w.shape, generator=torch.Generator().manual_seed(9)) \
        < 0.75
    want = torch.matmul(torch.where(keep, w / 0.75, torch.zeros(())), v)
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)
    # in eval, or at p = 0, the same call is plain attention
    plain = torch.matmul(w, v)
    torch.testing.assert_close(
        sdpa_bhld(q, k, v, is_causal=True, dropout_p=0.25, training=False),
        plain, atol=1e-6, rtol=1e-6)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt.GPT(gpt.GPTConfig(**CFG))


@pytest.mark.parametrize("entry", ["Normal", "Constant",
                                   "default_generator"])
def test_initializers_and_generator_default_to_the_card(entry):
    """``Normal``, ``Constant`` and ``core.default_generator`` resolve
    no device to ``cuda`` like every other entry point: without a card
    the no-argument call raises, and ``device="cpu"`` still works."""
    from paddle_tpu_torch.core import default_generator
    from paddle_tpu_torch.nn.initializer import Constant, Normal

    call = {"Normal": lambda **kw: Normal(0.0, 0.02)((4, 3), **kw),
            "Constant": lambda **kw: Constant(1.5)((4, 3), **kw),
            "default_generator": lambda **kw: default_generator(**kw)}[entry]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert call(device="cpu").device.type == "cpu"


def test_gpt_on_the_cpu_draws_from_the_cpu_generator():
    """``GPT(cfg, device="cpu")`` builds the same weights as before the
    initializers' default moved to the card: its first parameter is the
    first draw of the seeded CPU generator, and a rebuild after the same
    seed is equal parameter by parameter."""
    cfg = gpt.GPTConfig(**CFG)
    core.seed(5)
    m = gpt.GPT(cfg, device="cpu")
    z = torch.randn(cfg.vocab_size, cfg.hidden,
                    generator=torch.Generator().manual_seed(5))
    assert torch.equal(m.wte.weight, z * cfg.initializer_range + 0.0)
    core.seed(5)
    again = gpt.GPT(cfg, device="cpu")
    for (name, a), (_, b) in zip(m.state_dict().items(),
                                 again.state_dict().items()):
        assert torch.equal(a, b), name


_JAX_FREE = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from paddle_tpu_torch import convert, core, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.nlp import gpt
from paddle_tpu_torch.nn import functional
from paddle_tpu_torch.ops import kernels, norm_ops, random_ops, activation
from paddle_tpu_torch.dist import tp_layers
from paddle_tpu_torch.models.nlp import bert
from paddle_tpu_torch.nn import ParamAttr, initializer, param_attr
from paddle_tpu_torch.nn.layers import transformer
from paddle_tpu_torch.optim import regularizer
core.seed(0)
m = gpt.GPT(gpt.GPTConfig(vocab_size=256, hidden=128, layers=1, heads=2,
                          max_seq=16, dropout=0.1), device="cpu")
opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=1e-3,
                  grad_clip=optim.ClipGradByGlobalNorm(1.0))
ids = np.random.RandomState(0).randint(0, 256, (8, 16))
loss = TrainStep(m, opt, gpt.gpt_loss)(ids, np.roll(ids, -1, 1))
assert np.isfinite(float(loss))
b = bert.BertForPretraining(bert.bert_tiny(layers=1, vocab_size=256),
                            device="cpu")
opt = optim.Adam(parameters=b.named_parameters(), learning_rate=1e-3,
                 weight_decay=regularizer.L2Decay(0.01))
z = np.zeros((8, 16), "int64")
loss = TrainStep(b, opt, bert.bert_pretrain_loss)(
    ids, z, np.ones((8, 16)), np.where(ids % 7 == 0, ids, -100), z[:, 0])
assert np.isfinite(float(loss))
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
print("JAX-FREE OK")
"""


def test_training_modules_import_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _JAX_FREE, REPO],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX-FREE OK" in out.stdout


# -- the smaller modules of the BERT slice against the JAX package -----------


@pytest.mark.parametrize("kind", ["XavierUniform", "XavierNormal"])
@pytest.mark.parametrize("shape, kw", [
    ((512, 256), {}),                       # Linear (in, out)
    ((128, 64, 4, 4), {}),                  # conv (out, in, kh, kw)
    ((131072,), {}),                        # 1-D: fan_in = fan_out
    ((512, 256), {"fan_in": 100, "fan_out": 50, "gain": 2.0}),
])
def test_xavier_initializers_match_the_reference_law(kind, shape, kw):
    """Fans as the reference's ``_fans`` (a Linear weight is ``(in,
    out)``), the bound of a uniform draw, and the law of a large draw:
    the standard deviation of 131,072 samples within 1% of the formula's
    (sampling error ~0.2%) on both sides, and the two samples' deciles
    within 2% of it of each other."""
    from paddle_tpu.nn import initializer as jinit
    from paddle_tpu_torch.nn import initializer as tinit

    fi, fo = tinit._fans(shape)
    assert (fi, fo) == jinit._fans(shape)
    fi, fo = kw.get("fan_in", fi), kw.get("fan_out", fo)
    gain = kw.get("gain", 1.0)
    pt.seed(3)
    want = np.asarray(getattr(jinit, kind)(**kw)(shape)).ravel()
    got = getattr(tinit, kind)(**kw)(
        shape, device="cpu", generator=torch.Generator().manual_seed(3))
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    got = got.numpy().ravel()
    if kind == "XavierUniform":
        limit = gain * np.sqrt(6.0 / (fi + fo))
        std = limit / np.sqrt(3.0)
        for s in (got, want):
            assert np.abs(s).max() <= limit and np.abs(s).max() > 0.99 * limit
    else:
        std = gain * np.sqrt(2.0 / (fi + fo))
    for s in (got, want):
        np.testing.assert_allclose(s.std(), std, rtol=1e-2)
    deciles = np.linspace(0.1, 0.9, 9)
    np.testing.assert_allclose(np.quantile(got, deciles),
                               np.quantile(want, deciles), atol=2e-2 * std)


@pytest.mark.parametrize("arg", ["none", "false", "name", "initializer",
                                 "attr"])
def test_param_attr_to_attr_matches_the_reference(arg):
    from paddle_tpu.nn import initializer as jinit
    from paddle_tpu.nn.param_attr import ParamAttr as JAttr
    from paddle_tpu_torch.nn import ParamAttr
    from paddle_tpu_torch.nn import initializer as tinit

    jarg, targ = {
        "none": (None, None), "false": (False, False),
        "name": ("w0", "w0"),
        "initializer": (jinit.Constant(2.0), tinit.Constant(2.0)),
        "attr": (JAttr(learning_rate=0.5, need_clip=False),
                 ParamAttr(learning_rate=0.5, need_clip=False))}[arg]
    want, got = JAttr._to_attr(jarg), ParamAttr._to_attr(targ)
    if arg == "false":
        assert want is False and got is False
        return
    assert isinstance(got, ParamAttr)
    for a in ("name", "learning_rate", "regularizer", "trainable",
              "need_clip"):
        assert getattr(got, a) == getattr(want, a), a
    assert (got.initializer is None) == (want.initializer is None)
    if arg == "initializer":
        assert got.initializer is targ
    if arg == "attr":
        assert got is targ
    assert ParamAttr._to_attr([None, False])[1] is False
    with pytest.raises(TypeError):
        ParamAttr._to_attr(3.0)


def test_linear_without_weight_attr_is_the_reference_default():
    """``Linear(in, out)``: a Xavier-uniform weight, a zero bias, and the
    reference's parameter attributes."""
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import nn as tnn

    pt.seed(0)
    jl = jnn.Linear(256, 64)
    tl = tnn.Linear(256, 64, device="cpu")
    assert sorted(tl.state_dict()) == sorted(jl.state_dict())
    limit = np.sqrt(6.0 / (256 + 64))
    for w in (tl.weight.detach().numpy(), np.asarray(jl.weight._data)):
        assert np.abs(w).max() <= limit and w.std() > 0.5 * limit
    assert not tl.bias.detach().any() and not np.asarray(jl.bias._data).any()
    for tp, jp in ((tl.weight, jl.weight), (tl.bias, jl.bias)):
        assert tp.optimize_attr == jp.optimize_attr
        assert (tp.regularizer, tp.need_clip, tp.requires_grad) == (
            jp.regularizer, jp.need_clip, jp.trainable)


def test_embedding_padding_idx_matches_the_reference():
    """``padding_idx=-1`` is the last row: 0 at init, and every lookup of
    it 0 with no gradient to it, even after the row was loaded nonzero."""
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import nn as tnn

    pt.seed(0)
    je = jnn.Embedding(10, 4, padding_idx=-1)
    te = tnn.Embedding(10, 4, padding_idx=-1, device="cpu")
    assert not te.weight[9].any()
    assert not np.asarray(je.weight._data)[9].any()
    w = np.random.RandomState(2).randn(10, 4).astype(np.float32)
    je.weight._replace(pt.to_tensor(w)._data)
    te.load_state_dict({"weight": torch.from_numpy(w)})
    ids = np.array([[9, 1, 9], [3, 9, 0]], np.int64)
    g = np.random.RandomState(3).randn(2, 3, 4).astype(np.float32)
    jout = je(pt.to_tensor(ids))
    (jout * pt.to_tensor(g)).sum().backward()
    tout = te(torch.from_numpy(ids))
    (tout * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(tout.detach().numpy(),
                                  np.asarray(jout._data))
    assert not tout[ids == 9].any()
    np.testing.assert_array_equal(te.weight.grad.numpy(),
                                  np.asarray(je.weight.grad._data))
    assert not te.weight.grad[9].any()


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_axis_and_mode_match_the_reference(mode):
    """``axis=1``: one keep decision per index of axis 1, broadcast along
    the others; kept values scaled by 1/(1-p) (upscale) or not
    (downscale); in eval the identity (upscale) or ``x * (1-p)``
    (downscale), equal to the reference's output."""
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import nn as tnn

    x = np.random.RandomState(4).rand(4, 64, 5).astype(np.float32) + 0.5
    jd, td = jnn.Dropout(0.25, axis=1, mode=mode), tnn.Dropout(
        0.25, axis=1, mode=mode)
    scale = 1 / 0.75 if mode == "upscale_in_train" else 1.0
    for out in (td(torch.from_numpy(x)).numpy(),
                np.asarray(jd(pt.to_tensor(x))._data)):
        ratio = out / x
        kept = ratio[0, :, 0] != 0
        np.testing.assert_allclose(ratio, np.where(kept, scale, 0.0)[
            None, :, None] * np.ones_like(ratio), rtol=1e-6)
        assert 0 < kept.sum() < 64
    td.eval()
    jd.eval()
    got = td(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jd(pt.to_tensor(x))._data))
    np.testing.assert_array_equal(got, x if scale != 1.0 else x * 0.75)


@pytest.mark.parametrize("which", ["no-bias", "no-weight", "neither"])
def test_layer_norm_without_parameters_matches_the_reference(which):
    """``weight_attr``/``bias_attr=False`` make no parameter. The
    reference routes a LayerNorm without a weight to its no-affine op,
    which reads no bias either; without a bias its forward raises
    (``bias.ndim`` of None), so the port's is held to the reference's
    LayerNorm with the same weight and its zero bias. The port takes the
    dense path there: tolerance 1e-6 (float32 statistics in another
    summation order)."""
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import nn as tnn

    kw = {"no-bias": {"bias_attr": False},
          "no-weight": {"weight_attr": False},
          "neither": {"weight_attr": False, "bias_attr": False}}[which]
    rng = np.random.RandomState(5)
    x = (rng.randn(8, 128) * 2 + 0.5).astype(np.float32)
    w = rng.randn(128).astype(np.float32)
    tl = tnn.LayerNorm(128, device="cpu", **kw)
    jl = jnn.LayerNorm(128, **({} if which == "no-bias" else kw))
    assert (tl.weight is None) == ("weight_attr" in kw)
    assert (tl.bias is None) == ("bias_attr" in kw)
    if which == "no-bias":
        jl.weight._replace(pt.to_tensor(w)._data)
        with torch.no_grad():
            tl.weight.copy_(torch.from_numpy(w))
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jl(pt.to_tensor(x))._data),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_soft_label_cross_entropy_matches_the_reference(reduction,
                                                        smoothing):
    """Loss and its gradient by the logits, float32 within 1e-6."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as TF

    rng = np.random.RandomState(6)
    x = (rng.randn(16, 40) * 3).astype(np.float32)
    e = np.exp(rng.randn(16, 40))
    lab = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    jx = pt.to_tensor(x)
    jx.stop_gradient = False
    want = JF.cross_entropy(jx, pt.to_tensor(lab), soft_label=True,
                            reduction=reduction, label_smoothing=smoothing)
    want.sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    got = TF.cross_entropy(tx, torch.from_numpy(lab), soft_label=True,
                           reduction=reduction, label_smoothing=smoothing)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._data),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._data),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["learning_rate", "l2decay", "need_clip",
                                  "trainable", "adamw_learning_rate"])
def test_param_attrs_reach_the_optimizer_as_in_the_reference(case):
    """Three steps of the reference's eager ``Optimizer.step`` and the
    port's on a ``Linear(6, 5)`` whose weight has a ``ParamAttr``: a
    learning-rate multiplier of 0.5 (Adam and AdamW), its own
    ``L2Decay(0.1)`` beside the optimizer's ``weight_decay`` 0.01 (the
    bias's), ``need_clip=False`` under a global-norm clip of 0.01 that
    clips the bias, or ``trainable=False``. Tolerance rtol 1e-6 as
    ``test_optimizer_update_matches``."""
    from paddle_tpu import nn as jnn
    from paddle_tpu.nn.param_attr import ParamAttr as JAttr
    from paddle_tpu.optim.regularizer import L2Decay as JL2
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.nn import ParamAttr

    attr, jattr, okw, jokw = {
        "learning_rate": ({"learning_rate": 0.5}, None, {}, {}),
        "l2decay": ({"regularizer": optim.L2Decay(0.1)},
                    {"regularizer": JL2(0.1)},
                    {"weight_decay": 0.01}, {"weight_decay": 0.01}),
        "need_clip": ({"need_clip": False}, None,
                      {"grad_clip": optim.ClipGradByGlobalNorm(0.01)},
                      {"grad_clip": joptim.ClipGradByGlobalNorm(0.01)}),
        "trainable": ({"trainable": False}, None, {}, {}),
        "adamw_learning_rate": ({"learning_rate": 0.5}, None, {}, {}),
    }[case]
    jattr = jattr or attr
    pt.seed(0)
    jl = jnn.Linear(6, 5, weight_attr=JAttr(**jattr))
    tl = tnn.Linear(6, 5, weight_attr=ParamAttr(**attr), device="cpu")
    tl.load_state_dict({k: torch.from_numpy(np.array(v._data))
                        for k, v in jl.state_dict().items()})
    w0 = tl.weight.detach().clone()
    cls, tcls = ((joptim.AdamW, optim.AdamW) if case.startswith("adamw")
                 else (joptim.Adam, optim.Adam))
    jopt = cls(learning_rate=0.01, parameters=jl.parameters(), **jokw)
    topt = tcls(learning_rate=0.01, parameters=tl.named_parameters(), **okw)
    rng = np.random.RandomState(7)
    for _ in range(3):
        x, g = rng.randn(4, 6).astype(np.float32), rng.randn(4, 5).astype(
            np.float32)
        (jl(pt.to_tensor(x)) * pt.to_tensor(g)).sum().backward()
        jopt.step()
        jopt.clear_grad()
        (tl(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
        topt.step()
        topt.clear_grad()
    for name in ("weight", "bias"):
        np.testing.assert_allclose(
            getattr(tl, name).detach().numpy(),
            np.asarray(getattr(jl, name)._data), rtol=1e-6, atol=1e-7,
            err_msg=name)
    assert torch.equal(tl.weight.detach(), w0) == (case == "trainable")
