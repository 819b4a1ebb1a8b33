"""paddle_tpu_torch's BERT step against the JAX package's at ``bert_base``'s
widths: vocab 30522 (the dense cross-entropy path in both packages),
768 wide, 12 heads x 64, FFN 3072, max_position 512; depth cut to 2
layers and the batch to 8 x 128 (bench_bert's sequence length, its
token types 0, mask ones and MLM labels at 15%), float32, dropout 0,
AdamW(1e-4) with global-norm clip 1.0 — bench_bert's optimizer.

The 4-step losses agree within 5e-5 (seen: 7.6e-6). In both packages
the first AdamW step lifts the loss (here from 11.18 to 15.36): the
rise that ``chip_smoke.py``'s train-bert phase shows on the card at
full depth in bfloat16 (11.21 to 13.35) is the recipe's, not the
port's.
"""
import numpy as np

import paddle_tpu as pt
from paddle_tpu import optim as joptim
from paddle_tpu.models.nlp import bert as jbert
from paddle_tpu_torch import convert, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.nlp import bert

from torch_test_threads import torch_threads  # noqa: F401,E402

B, L, LAYERS = 8, 128, 2
LOSS_TOL = 5e-5


def test_bert_base_widths_follow_the_reference_trajectory():
    pt.seed(0)
    jm = jbert.BertForPretraining(jbert.bert_base(layers=LAYERS,
                                                  dropout=0.0))
    m = bert.BertForPretraining(bert.bert_base(layers=LAYERS, dropout=0.0),
                                device="cpu")
    m.load_state_dict(convert.bert_params_from_jax(
        {k: np.asarray(v._data) for k, v in jm.state_dict().items()}))
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 30522, (B, L)).astype("int32")
    tt = np.zeros((B, L), "int32")
    am = np.ones((B, L), "int32")
    mlm = np.where(rng.rand(B, L) < 0.15, ids, -100).astype("int32")
    nsp = rng.randint(0, 2, (B,)).astype("int32")
    batch = (ids, tt, am, mlm, nsp)
    jstep = pt.TrainStep(jm, joptim.AdamW(
        parameters=jm.parameters(), learning_rate=1e-4,
        grad_clip=joptim.ClipGradByGlobalNorm(1.0)), jbert.bert_pretrain_loss)
    step = TrainStep(m, optim.AdamW(
        parameters=m.named_parameters(), learning_rate=1e-4,
        grad_clip=optim.ClipGradByGlobalNorm(1.0)), bert.bert_pretrain_loss)
    want = [float(np.asarray(jstep(*batch)._data)) for _ in range(4)]
    got = [float(step(*batch)) for _ in range(4)]
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=LOSS_TOL)
    assert abs(want[0] - np.log(30522 * 2)) < 0.5
    assert want[1] > want[0] + 1 and got[1] > got[0] + 1
