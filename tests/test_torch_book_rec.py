"""paddle_tpu_torch's word2vec and recommender nets (the book's chapters
4 and 5: ``models.nlp.NGramLM``/``SkipGram``, ``models.rec
.TwoTowerRecommender``/``DeepFM``) against the JAX package's, at the JAX
book tests' sizes and data (``tests/book/test_nlp_models.py``: vocabulary
120, ``NGramLM(120, 16, 64)``, ``SkipGram(120, 16)``,
``TwoTowerRecommender(40, 50)``, ``DeepFM([10, 20, 30], 8, (32, 32))``,
batch 64 from ``RandomState(0)``), weights carried from the JAX models
by ``convert.layer_params_from_jax``.

Each net takes 8 ``TrainStep`` steps under Adam (the book test's
``_fit``: 1e-2 for word2vec, 5e-3 for the recommenders) in both
packages: losses within rtol 1e-5, parameters within atol 1e-5 (float32,
sums in another order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn.functional as JF
from paddle_tpu import optim as joptim
from paddle_tpu.models.nlp import word2vec as jw2v
from paddle_tpu.models.rec import recommender as jrec
from paddle_tpu_torch import convert, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.nlp import NGramLM, SkipGram, skipgram_loss
from paddle_tpu_torch.models.rec import (DeepFM, TwoTowerRecommender,
                                         rating_loss)
from paddle_tpu_torch.nn import functional as F

from torch_test_threads import torch_threads  # noqa: F401,E402

VOCAB, N, STEPS = 120, 64, 8
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


def _ngram_data():
    rng = np.random.RandomState(0)
    ctx = rng.randint(0, VOCAB, (N, 4)).astype("int64")
    return ctx, ctx[:, 0].copy()


def _skipgram_data():
    rng = np.random.RandomState(0)
    center = rng.randint(0, VOCAB, (N,)).astype("int64")
    context = rng.randint(0, VOCAB, (N, 5)).astype("int64")
    label = np.zeros((N, 5), "float32")
    label[:, 0] = 1.0
    return center, context, label


def _two_tower_data():
    rng = np.random.RandomState(0)
    feats = [rng.randint(0, hi, (N,)).astype("int64")
             for hi in (40, 2, 7, 21, 50, 19)]
    return (*feats, (feats[0] % 5).astype("float32") + 0.5)


FIELDS = [10, 20, 30]


def _deepfm_data():
    rng = np.random.RandomState(0)
    ids = [rng.randint(0, v, (N,)).astype("int64") for v in FIELDS]
    return (*ids, ((ids[0] + ids[1]) % 2).astype("float32"))


def _deepfm_loss(Fm):
    return lambda m, a, b, c, t: Fm.binary_cross_entropy_with_logits(
        m(a, b, c), t)


NETS = {
    "ngram": (lambda: jw2v.NGramLM(VOCAB, 16, 64),
              lambda: NGramLM(VOCAB, 16, 64, device="cpu"),
              lambda m, c, t: JF.cross_entropy(m(c), t),
              lambda m, c, t: F.cross_entropy(m(c), t), _ngram_data, 1e-2),
    "skipgram": (lambda: jw2v.SkipGram(VOCAB, 16),
                 lambda: SkipGram(VOCAB, 16, device="cpu"),
                 jw2v.skipgram_loss, skipgram_loss, _skipgram_data, 1e-2),
    "two_tower": (lambda: jrec.TwoTowerRecommender(40, 50),
                  lambda: TwoTowerRecommender(40, 50, device="cpu"),
                  jrec.rating_loss, rating_loss, _two_tower_data, 5e-3),
    "deepfm": (lambda: jrec.DeepFM(FIELDS, embed_dim=8, hidden=(32, 32)),
               lambda: DeepFM(FIELDS, embed_dim=8, hidden=(32, 32),
                              device="cpu"),
               _deepfm_loss(JF), _deepfm_loss(F), _deepfm_data, 5e-3),
}


def _pair(kind):
    jmake, tmake = NETS[kind][:2]
    jpt.seed(0)
    jm, tm = jmake(), tmake()
    tm.load_state_dict(convert.layer_params_from_jax(
        {k: np.asarray(v._data) for k, v in jm.state_dict().items()}, tm))
    return jm, tm


@pytest.mark.parametrize("kind", sorted(NETS))
def test_eight_adam_steps_follow_the_jax_trainstep(kind):
    _, _, jloss, tloss, data, lr = NETS[kind]
    jm, tm = _pair(kind)
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    jstep = jpt.TrainStep(jm, joptim.Adam(lr, parameters=jm.parameters()),
                          jloss)
    step = TrainStep(tm, optim.Adam(lr, parameters=tm.named_parameters()),
                     tloss)
    batch = data()
    want = [float(np.asarray(jstep(*batch)._data)) for _ in range(STEPS)]
    got = [float(step(*batch)) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    jp = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jp[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_deepfm_state_dict_names_its_lists_as_the_jax_layerlist():
    _, tm = _pair("deepfm")
    names = list(tm.state_dict())
    assert names[:2] == ["embeds.0.weight", "embeds.1.weight"]
    assert "linears.2.weight" in names and "mlp.1.bias" in names
    assert tuple(tm.state_dict()["linears.0.weight"].shape) == (10, 1)


def test_layer_params_from_jax_rejects_another_width():
    jm, tm = _pair("two_tower")
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    state["u_fc.weight"] = np.zeros((81, 200), np.float32)
    with pytest.raises(ValueError, match="u_fc.weight"):
        convert.layer_params_from_jax(state, tm)


def test_first_logits_and_gradients_match():
    """One forward and backward of each net from the same weights:
    losses within rtol 1e-5 and every gradient within atol 1e-5 of the
    largest magnitude of the JAX one."""
    for kind in sorted(NETS):
        _, _, jloss, tloss, data, _ = NETS[kind]
        jm, tm = _pair(kind)
        batch = data()
        jl = jloss(jm, *[jpt.to_tensor(a) for a in batch])
        jl.backward()
        tl = tloss(tm, *[torch.from_numpy(a) for a in batch])
        tl.backward()
        np.testing.assert_allclose(float(tl), float(np.asarray(jl._data)),
                                   rtol=LOSS_RTOL, err_msg=kind)
        jp = dict(jm.named_parameters())
        for name, p in tm.named_parameters():
            w = np.asarray(jp[name].grad._data)
            scale = float(np.abs(w).max()) or 1.0
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * scale,
                                       err_msg=f"{kind} {name}")
