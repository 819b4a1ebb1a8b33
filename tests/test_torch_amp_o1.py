"""paddle_tpu_torch's ``auto_cast`` (level O1) and float16 training
against the JAX package's.

- The lists: ``WHITE_LIST``/``BLACK_LIST`` equal the reference's, and
  custom lists resolve the same way (an op in both raises).
- Which listed op computes in which type: one forward and backward of a
  tiny GPT and of ``bert_tiny`` under ``auto_cast``, recorded in the JAX
  package through a test-time patch of its ``cast_op_inputs`` and in the
  port through its own; the two sequences of (listed op name, input
  types) are equal (labels' integer width apart: the JAX package has no
  int64). A planted fault (``matmul`` left uncast) changes the
  sequence.
- A tiny GPT (float32 parameters, dropout 0) under ``auto_cast`` in
  float16 and bfloat16, the JAX side once dense (L 32) and once through
  its Pallas kernels in interpret mode at the smallest shape that routes
  to all three (L 128, D 64; LN at D 128, CE at V 512): logits in the
  same type, within two steps of the half type at the largest |logit|
  (float16 2^-9 x 2; bfloat16 2^-6 x 2; seen one step on both paths),
  the loss within 1e-3 (seen 8e-6 float16, 1e-4 bfloat16), every
  gradient (float32, as the reference's vjp gives it) within 2e-2
  (float16; seen 2.3e-3) or 5e-2 (bfloat16; seen 2.0e-2) of the largest
  entry of each. The planted fault fails the logits' type.
- An 8-step ``TrainStep`` trajectory at O1 float16 under
  ``DynamicLossScaler(2^24, incr_every_n_steps=2)``: the same steps are
  skipped (the scaled float16 gradients overflow until the scale is low
  enough, then the scale grows and overflows again), and the scale, good
  and bad counts equal exactly after every step; the losses of the
  steps taken within 1e-3.
- O2 float16 (``amp.decorate(level="O2", dtype="float16")``, the model
  in float16 with float32 masters): logits within two float16 steps,
  the loss within 2e-3 and gradients (float16) within 2e-2 of the
  largest entry of each, against the JAX model cast the same way.
"""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jpt
from paddle_tpu import amp as jamp
from paddle_tpu import optim as joptim
from paddle_tpu.amp import autocast as jac
from paddle_tpu.core import dispatch as jdispatch
from paddle_tpu.models.nlp import bert as jbert
from paddle_tpu.models.nlp import gpt as jgpt
from paddle_tpu.ops import pallas as pk
from paddle_tpu_torch import amp, convert, optim
from paddle_tpu_torch.amp import autocast as tac
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.nlp import bert, gpt

from torch_test_threads import torch_threads  # noqa: F401,E402

# D = 64, LN's D = 128 and CE's V = 512 route to the kernels at L = 128
CFG = dict(vocab_size=512, hidden=128, layers=2, heads=2, max_seq=128,
           dropout=0.0)
HALF_STEP = {"float16": 2 ** -10, "bfloat16": 2 ** -7}
GRAD_TOL = {"float16": 2e-2, "bfloat16": 5e-2}
LOSS_TOL = 1e-3


def test_lists_are_the_references():
    assert amp.WHITE_LIST == jamp.WHITE_LIST
    assert amp.BLACK_LIST == jamp.BLACK_LIST


@pytest.mark.parametrize("white, black", [
    (None, None), (["softmax"], None), (None, ["matmul", "gelu"]),
    (["layer_norm", "foo"], ["linear"])])
def test_custom_lists_resolve_as_the_reference(white, black):
    t = amp.AutoMixedPrecisionLists(white, black)
    j = jamp.AutoMixedPrecisionLists(white, black)
    assert (t.white_list, t.black_list) == (j.white_list, j.black_list)


def test_an_op_in_both_lists_raises():
    with pytest.raises(ValueError, match="both"):
        amp.AutoMixedPrecisionLists(["matmul"], ["matmul"])
    with pytest.raises(ValueError, match="both"):
        jamp.AutoMixedPrecisionLists(["matmul"], ["matmul"])


def test_state_is_per_thread_and_nests():
    seen = []
    assert amp.amp_state() is None
    with amp.auto_cast(dtype="float16"):
        assert amp.amp_state().dtype == torch.float16
        with amp.auto_cast(custom_black_list=["linear"]):
            st = amp.amp_state()
            assert st.dtype == torch.bfloat16
            assert "linear" in st.lists.black_list
        t = threading.Thread(target=lambda: seen.append(amp.amp_state()))
        t.start()
        t.join()
        assert amp.amp_state().dtype == torch.float16
    assert seen == [None] and amp.amp_state() is None
    with amp.auto_cast(enable=False):
        assert amp.amp_state() is None
    with pytest.raises(ValueError):
        with amp.auto_cast(level="O3"):
            pass
    assert amp.amp_guard is amp.auto_cast


def test_casts_follow_the_lists_and_gradients_keep_their_type():
    from paddle_tpu_torch.nn import functional as F

    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 8, requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    with amp.auto_cast(dtype="float16"):
        y = F.linear(x, w, b)
        z = F.cross_entropy(y, torch.tensor([0, 1, 2, 3]))
    assert y.dtype == torch.float16 and z.dtype == torch.float32
    z.backward()
    assert x.grad.dtype == w.grad.dtype == b.grad.dtype == torch.float32


def _record(monkeypatch, side, seen):
    """Record (listed op, input types) through the package's
    ``cast_op_inputs``."""
    mod = jac if side == "jax" else tac
    real = mod.cast_op_inputs

    def spy(name, arrays):
        out = real(name, arrays)
        st = mod.amp_state()
        if name in st.lists.white_list or name in st.lists.black_list:
            seen.append((name, tuple(
                str(a.dtype).replace("torch.", "").replace("int64", "int32")
                for a in out if hasattr(a, "dtype"))))
        return out

    monkeypatch.setattr(mod, "cast_op_inputs", spy)
    if side == "jax":
        jdispatch._lazy_hooks()
        monkeypatch.setattr(jdispatch, "_cast_op_inputs", spy)


def _tiny_batch(V, B=2, L=16):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, V, (B, L)).astype("int64")
    mlm = np.where(rng.rand(B, L) < 0.2, rng.randint(0, V, (B, L)),
                   -100).astype("int64")
    return ids, mlm


def _sequences(monkeypatch, model, dtype, sides=("jax", "port")):
    """The (listed op, input types) sequence of one forward of ``model``
    under ``auto_cast(dtype)`` in each of ``sides`` (the backward runs
    no op through the policy in either package)."""
    out = {}
    for side in sides:
        seen = []
        with monkeypatch.context() as mp:
            _record(mp, side, seen)
            if model == "gpt_tiny":
                ids, _ = _tiny_batch(1024)
                if side == "jax":
                    jpt.seed(0)
                    m = jgpt.GPT(jgpt.gpt_tiny(dropout=0.0))
                    with jamp.auto_cast(dtype=dtype):
                        loss = jgpt.gpt_loss(m, jpt.to_tensor(ids),
                                             jpt.to_tensor(ids))
                else:
                    m = gpt.GPT(gpt.gpt_tiny(dropout=0.0), device="cpu")
                    with amp.auto_cast(dtype=dtype):
                        loss = gpt.gpt_loss(m, torch.from_numpy(ids),
                                            torch.from_numpy(ids))
            else:
                ids, mlm = _tiny_batch(1024)
                tt, am = np.zeros_like(ids), np.ones(ids.shape, "float32")
                nsp = np.array([0, 1], "int64")
                batch = (ids, tt, am, mlm, nsp)
                if side == "jax":
                    jpt.seed(0)
                    m = jbert.BertForPretraining(jbert.bert_tiny(
                        dropout=0.0))
                    with jamp.auto_cast(dtype=dtype):
                        loss = jbert.bert_pretrain_loss(
                            m, *[jpt.to_tensor(a) for a in batch])
                else:
                    m = bert.BertForPretraining(bert.bert_tiny(
                        dropout=0.0), device="cpu")
                    with amp.auto_cast(dtype=dtype):
                        loss = bert.bert_pretrain_loss(
                            m, *[torch.from_numpy(a) for a in batch])
        assert loss.dtype in (torch.float32, jnp.float32)
        out[side] = seen
    return out


@pytest.mark.parametrize("model", ["gpt_tiny", "bert_tiny"])
def test_listed_ops_compute_in_the_references_types(monkeypatch, model):
    seqs = _sequences(monkeypatch, model, "float16")
    assert seqs["port"] == seqs["jax"]
    names = {n for n, _ in seqs["port"]}
    assert {"layer_norm", "linear", "sdpa", "matmul",
            "cross_entropy_hard"} <= names
    # a planted fault: the logits' matmul left uncast
    real = tac.cast_op_inputs
    monkeypatch.setattr(tac, "cast_op_inputs", lambda name, arrays: (
        arrays if name == "matmul" else real(name, arrays)))
    planted = _sequences(monkeypatch, model, "float16", ("port",))
    assert planted["port"] != seqs["jax"]


def _pair(dtype="float32"):
    jpt.seed(0)
    jm = jgpt.GPT(jgpt.GPTConfig(**CFG))
    if dtype != "float32":
        jm.astype(dtype)
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    m = gpt.GPT(gpt.GPTConfig(**CFG, dtype=dtype), device="cpu")
    m.load_state_dict(convert.gpt_params_from_jax(sd))
    return jm, m


def _jax_side(jm, ids, amp_dtype):
    """Logits' type, logits, loss and every gradient of the JAX model on
    ``ids`` (labels: the ids rolled by one), under ``auto_cast(amp_dtype)``
    unless it is None."""
    labels = np.roll(ids, -1, axis=1)
    with jamp.auto_cast(dtype=amp_dtype, enable=amp_dtype is not None):
        jlog = jm(jpt.to_tensor(ids))
        jl = jgpt.gpt_loss(jm, jpt.to_tensor(ids), jpt.to_tensor(labels))
    jl.backward()
    return (str(jlog._data.dtype), np.asarray(jlog._data).astype(np.float32),
            float(np.asarray(jl._data)),
            {n: np.asarray(p.grad._data).astype(np.float32)
             for n, p in jm.named_parameters()})


def _port_side(m, ids, amp_dtype):
    labels = np.roll(ids, -1, axis=1)
    with amp.auto_cast(dtype=amp_dtype or "float16",
                       enable=amp_dtype is not None):
        tlog = m(torch.from_numpy(ids))
        tl = gpt.gpt_loss(m, torch.from_numpy(ids), torch.from_numpy(labels))
    tl.backward()
    return (str(tlog.dtype).replace("torch.", ""),
            tlog.detach().float().numpy(), float(tl.detach()),
            {n: p.grad.float().numpy() for n, p in m.named_parameters()})


def _errors(want, got):
    """(logit types, logit error, largest |logit|, loss error, largest
    gradient error relative to each gradient's largest entry)."""
    (jt, jlog, jl, jg), (tt, tlog, tl, tg) = want, got
    assert sorted(tg) == sorted(jg)
    grad = max(np.abs(tg[n] - jg[n]).max() / np.abs(jg[n]).max()
               for n in jg)
    return (jt, tt), np.abs(tlog - jlog).max(), np.abs(jlog).max(), \
        abs(tl - jl), grad


@pytest.fixture(params=[False, True], ids=["jax-dense", "jax-pallas"])
def pallas(request):
    pk.set_enabled(request.param)
    yield request.param
    pk.set_enabled(None)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_tiny_gpt_under_auto_cast_matches_jax(pallas, dtype, monkeypatch):
    ids = np.random.RandomState(1).randint(
        0, CFG["vocab_size"], (1, 128 if pallas else 32)).astype("int32")
    jm, m = _pair()
    want = _jax_side(jm, ids, dtype)
    types, logit, largest, loss, grad = _errors(want, _port_side(m, ids,
                                                                 dtype))
    assert types == (dtype, dtype)
    assert logit <= 2 * HALF_STEP[dtype] * 2 ** np.ceil(np.log2(largest))
    assert loss <= LOSS_TOL and grad <= GRAD_TOL[dtype]
    assert all(p.dtype == torch.float32 for p in m.parameters())
    if not pallas or dtype != "float16":
        return
    # a planted fault: the logits' matmul left uncast
    real = tac.cast_op_inputs
    monkeypatch.setattr(tac, "cast_op_inputs", lambda name, arrays: (
        arrays if name == "matmul" else real(name, arrays)))
    _, m = _pair()
    types, *_ = _errors(want, _port_side(m, ids, dtype))
    assert types == (dtype, "float32")


def _o1_loss(jax):
    if jax:
        def f(model, ids, labels):
            with jamp.auto_cast(dtype="float16"):
                return jgpt.gpt_loss(model, ids, labels)
    else:
        def f(model, ids, labels):
            with amp.auto_cast(dtype="float16"):
                return gpt.gpt_loss(model, ids, labels)
    return f


def test_float16_trajectory_skips_the_references_steps():
    jm, m = _pair()
    kw = dict(init_loss_scaling=2.0 ** 24, incr_every_n_steps=2)
    jopt = joptim.AdamW(parameters=jm.parameters(), learning_rate=3e-3)
    opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=3e-3)
    jstep = jpt.TrainStep(jm, jopt, _o1_loss(True),
                          scaler=jamp.DynamicLossScaler(**kw))
    step = TrainStep(m, opt, _o1_loss(False),
                     scaler=amp.DynamicLossScaler(**kw))
    rng = np.random.RandomState(2)
    want, got = [], []
    for _ in range(8):
        ids = rng.randint(0, CFG["vocab_size"], (2, 32)).astype("int32")
        batch = (ids, np.roll(ids, -1, axis=1))
        jl = float(np.asarray(jstep(*batch)._data))
        tl = float(step(*batch))
        want.append((bool(jstep.last_found_inf), {
            k: np.asarray(v).item() for k, v in jstep._scaler_state.items()},
            jl))
        got.append((bool(step.last_found_inf), {
            k: v.item() for k, v in step._scaler_state.items()}, tl))
    assert [g[:2] for g in got] == [w[:2] for w in want]
    flags = [g[0] for g in got]
    assert any(flags) and not all(flags)
    taken = [i for i, f in enumerate(flags) if not f]
    np.testing.assert_allclose([got[i][2] for i in taken],
                               [want[i][2] for i in taken], atol=LOSS_TOL)


def test_o2_float16_matches_jax():
    jm, m = _pair()
    jopt = joptim.AdamW(parameters=jm.parameters(), learning_rate=3e-3)
    opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=3e-3)
    jm, jopt = jamp.decorate(jm, jopt, level="O2", dtype="float16")
    m2, opt2 = amp.decorate(m, opt, level="O2", dtype="float16")
    assert m2 is m and opt2._multi_precision
    assert all(p.dtype == torch.float16 for p in m.parameters())
    ids = np.random.RandomState(3).randint(
        0, CFG["vocab_size"], (2, 32)).astype("int32")
    types, logit, largest, loss, grad = _errors(
        _jax_side(jm, ids, None), _port_side(m, ids, None))
    assert types == ("float16", "float16")
    assert logit <= 2 * HALF_STEP["float16"] * 2 ** np.ceil(np.log2(largest))
    assert loss <= 2 * LOSS_TOL and grad <= GRAD_TOL["float16"]
    opt2.step()
    master = opt2._accumulators["wte.weight"]["master"]
    assert master.dtype == torch.float32
    assert torch.equal(master.half(), m.wte.weight.detach())
