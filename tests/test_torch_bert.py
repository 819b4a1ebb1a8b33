"""paddle_tpu_torch's BERT pretraining step against the JAX package's.

``bert_tiny`` (2 layers, 128 wide, 2 heads, FFN 512, dropout 0) at two
vocabularies: 1024, a multiple of 128, whose MLM loss both packages send
to the fused cross-entropy kernel, and 1000, which takes the dense path
in both, as ``bert_base``'s 30522 does. The JAX model's weights go to
the port through ``convert.bert_params_from_jax``; the same numpy batch
(8 x 64 ids, random token types, ``attention_mask`` zero on the last 14
columns of half the rows, MLM labels at 15% with -100 elsewhere, NSP
labels) goes through both, and the port (on the CPU: the kernels' plain
versions) is held to the JAX package with its dense paths and with its
Pallas kernels (interpret mode, ``pallas.set_enabled(True)``).

Tolerances (the JAX package's own two paths, on this batch: float32
logits and 8-step losses within 1e-5 of each other; in bfloat16 at lr
1e-4, losses up to 2.1e-3 apart; at lr 1e-3, 0.226 apart by step 3, so
a bfloat16 trajectory is compared at bench_bert's lr 1e-4):

- float32 logits, atol and rtol 1e-5 (|logit| < 2; summation order);
- bfloat16 logits, 2^-6 x the largest |logit|: two bfloat16 steps there
  (the frameworks round bfloat16 at different places; seen: 1.03e-2 at
  a largest |logit| of 1.16, 0.57 of the limit);
- every gradient after one backward, 1e-5 relative to each gradient's
  largest entry; but ``k_proj.bias``, whose gradient is 0 in exact
  arithmetic (a softmax row does not change when the same ``q . b_k``
  is added to each of its scores), is held to 0 on both sides, within
  1e-5 of its layer's largest ``k_proj.weight`` gradient entry (seen:
  rounding noise of 2e-9 to 5e-9 on both sides, against weight
  gradients of ~1e-2);
- the 8-step ``TrainStep`` losses (AdamW, global-norm clip 1.0): float32
  at lr 1e-3 within 5e-5 (seen: <= 5.7e-6); bfloat16 with
  ``multi_precision`` at lr 1e-4 within 1e-2 (seen: <= 3.8e-3).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optim as joptim
from paddle_tpu.models.nlp import bert as jbert
from paddle_tpu.ops import pallas as pk
from paddle_tpu_torch import convert, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.nlp import bert
from paddle_tpu_torch.nn.functional import loss as tloss
from paddle_tpu_torch.ops import kernels

from torch_test_threads import torch_threads  # noqa: F401,E402

B, L = 8, 64
LOGIT_TOL = 1e-5
BF16_LOGIT_STEPS = 2 ** -6
GRAD_TOL = 1e-5
LOSS_TOL = 5e-5
BF16_LOSS_TOL = 1e-2
VOCABS = pytest.mark.parametrize("vocab", [1024, 1000],
                                 ids=["fused-ce", "dense-ce"])


def _batch(vocab):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (B, L)).astype("int32")
    tt = rng.randint(0, 2, (B, L)).astype("int32")
    am = np.ones((B, L), "int32")
    am[::2, 50:] = 0
    mlm = np.where(rng.rand(B, L) < 0.15, ids, -100).astype("int32")
    nsp = rng.randint(0, 2, (B,)).astype("int32")
    return ids, tt, am, mlm, nsp


def _pair(vocab, dtype="float32"):
    """A JAX ``BertForPretraining`` from seed 0 and the port's (CPU) with
    its weights, both in ``dtype`` (cast with ``bfloat16()``, as
    ``bench.py:bench_bert`` does)."""
    pt.seed(0)
    jm = jbert.BertForPretraining(jbert.bert_tiny(vocab_size=vocab,
                                                  dropout=0.0))
    m = bert.BertForPretraining(bert.bert_tiny(vocab_size=vocab,
                                               dropout=0.0), device="cpu")
    if dtype == "bfloat16":
        jm.bfloat16()
        m.bfloat16()
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    m.load_state_dict(convert.bert_params_from_jax(sd))
    return jm, m


def _jax(batch):
    return [pt.to_tensor(a) for a in batch]


def _torch(batch):
    return [torch.from_numpy(a) for a in batch]


@pytest.fixture(scope="module")
def port_runs():
    """The port's side of each comparison, computed once a module: it does
    not depend on the path the JAX side takes (dense or Pallas), so a
    test's two ``pallas`` cases share it. Keyed by the test and its
    parameters."""
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


@VOCABS
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match(pallas, vocab, dtype, port_runs):
    jm, m = _pair(vocab, dtype)
    batch = _batch(vocab)
    want = [np.asarray(t._data).astype(np.float32)
            for t in jm(*_jax(batch[:3]))]

    def port():
        with torch.no_grad():
            return [t.float().numpy() for t in m(*_torch(batch[:3]))]

    got = _once(port_runs, ("logits", vocab, dtype), port)
    assert got[0].shape == (B, L, vocab) and got[1].shape == (B, 2)
    for g, w in zip(got, want):
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        else:
            np.testing.assert_allclose(
                g, w, atol=BF16_LOGIT_STEPS * np.abs(w).max(), rtol=0)


@VOCABS
def test_every_gradient_matches(pallas, vocab, port_runs):
    jm, m = _pair(vocab)
    batch = _batch(vocab)
    jl = jbert.bert_pretrain_loss(jm, *_jax(batch))
    jl.backward()
    want = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}

    def port():
        loss = bert.bert_pretrain_loss(m, *_torch(batch))
        loss.backward()
        return float(loss.detach()), {n: p.grad.numpy()
                                      for n, p in m.named_parameters()}

    loss, got = _once(port_runs, ("grads", vocab), port)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(loss, float(np.asarray(jl._data)),
                               rtol=LOGIT_TOL)
    for n in want:
        if n.endswith("k_proj.bias"):
            scale = np.abs(want[n.replace(".bias", ".weight")]).max()
            for side in (got[n], want[n]):
                np.testing.assert_allclose(side, 0, atol=GRAD_TOL * scale,
                                           err_msg=n)
            continue
        scale = np.abs(want[n]).max()
        np.testing.assert_allclose(got[n], want[n], rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, err_msg=n)


def _trajectories(vocab, dtype, lr, port_runs):
    """The JAX and the port's 8-step losses, and whether the port's
    parameters are all bfloat16 after them (the port's side once a
    module, ``port_runs``)."""
    jm, m = _pair(vocab, dtype)
    batch = _batch(vocab)
    mp = dtype == "bfloat16"
    jopt = joptim.AdamW(parameters=jm.parameters(), learning_rate=lr,
                        multi_precision=mp,
                        grad_clip=joptim.ClipGradByGlobalNorm(1.0))
    jstep = pt.TrainStep(jm, jopt, jbert.bert_pretrain_loss)
    want = [float(np.asarray(jstep(*batch)._data)) for _ in range(8)]

    def port():
        opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=lr,
                          multi_precision=mp,
                          grad_clip=optim.ClipGradByGlobalNorm(1.0))
        step = TrainStep(m, opt, bert.bert_pretrain_loss)
        got = [float(step(*batch)) for _ in range(8)]
        return got, all(p.dtype == torch.bfloat16 for p in m.parameters())

    got, bf16 = _once(port_runs, ("trajectory", vocab, dtype, lr), port)
    return got, want, bf16


@VOCABS
def test_train_step_trajectory_matches(pallas, vocab, port_runs):
    got, want, _ = _trajectories(vocab, "float32", 1e-3, port_runs)
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=LOSS_TOL)
    assert got[-1] < got[0] - 1.0          # it learns


@VOCABS
def test_bf16_multi_precision_trajectory_matches(pallas, vocab, port_runs):
    got, want, bf16 = _trajectories(vocab, "bfloat16", 1e-4, port_runs)
    np.testing.assert_allclose(got, want, atol=BF16_LOSS_TOL, rtol=0)
    assert got[-1] < got[0] - 0.5          # it learns
    assert bf16


@VOCABS
def test_mlm_loss_takes_the_fused_route_where_the_reference_does(
        vocab, monkeypatch):
    """At vocab 1024 the MLM loss goes to the fused cross-entropy op (its
    plain version on the CPU), at 1000 to the dense path; the NSP loss
    (2 classes) is always dense. No kernel launches on the CPU."""
    calls = []
    real = tloss.softmax_cross_entropy

    def counted(logits, *a):
        calls.append(tuple(logits.shape))
        return real(logits, *a)

    monkeypatch.setattr(tloss, "softmax_cross_entropy", counted)
    _, m = _pair(vocab)
    kernels.reset_launches()
    bert.bert_pretrain_loss(m, *_torch(_batch(vocab))).backward()
    assert calls == ([(B * L, vocab)] if vocab % 128 == 0 else [])
    assert set(kernels.launches().values()) == {0}


def test_encoder_layers_start_equal():
    """The reference's ``TransformerEncoder`` deep-copies its first layer
    (``transformer.py:228``): a fresh port model's layers hold equal
    weights, which are not shared, and the same parameter attributes."""
    m = bert.BertForPretraining(bert.bert_tiny(layers=3), device="cpu")
    layers = m.bert.encoder.layers
    first = layers[0].state_dict()
    for layer in layers[1:]:
        for (name, a), b in zip(first.items(), layer.state_dict().values()):
            assert torch.equal(a, b), name
            assert a.data_ptr() != b.data_ptr(), name
        for (name, p), q in zip(layers[0].named_parameters(),
                                layer.parameters()):
            assert (q.optimize_attr, q.regularizer, q.need_clip) == (
                p.optimize_attr, p.regularizer, p.need_clip), name
    # and the layers are Xavier-uniform, not one constant
    w = layers[0].linear1.weight
    limit = (6.0 / sum(w.shape)) ** 0.5
    assert w.abs().max() <= limit and w.std() > limit / 2


def test_bert_params_from_jax_rejects_what_does_not_fit():
    jm, _ = _pair(1024)
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    assert set(convert.bert_params_from_jax(sd)) == set(sd)
    missing = dict(sd)
    del missing["bert.encoder.layers.1.norm2.bias"]
    extra = dict(sd, **{"nsp.extra": np.zeros(3, np.float32)})
    bad = dict(sd, **{"bert.encoder.layers.0.linear1.weight":
                      np.zeros((128, 256), np.float32)})
    gap = {k.replace("layers.1.", "layers.2."): v for k, v in sd.items()}
    no_bias = {k: v for k, v in sd.items() if k != "mlm_bias"}
    for wrong in (missing, extra, bad, gap, no_bias):
        with pytest.raises(ValueError):
            convert.bert_params_from_jax(wrong)


def test_bert_params_from_jax_keeps_bfloat16():
    jm, m = _pair(1024, "bfloat16")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    assert {str(a.dtype) for a in sd.values()} == {"bfloat16"}
    got = convert.bert_params_from_jax(sd)
    assert {t.dtype for t in got.values()} == {torch.bfloat16}
    for k, t in got.items():
        np.testing.assert_array_equal(t.float().numpy(),
                                      sd[k].astype(np.float32), err_msg=k)
    # every floating parameter is bfloat16, LayerNorms and mlm_bias too
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())


def test_bert_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert.BertForPretraining(bert.bert_tiny())
