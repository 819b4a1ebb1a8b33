"""BERT: the Transformer encoder with its masked-LM and next-sentence
pretraining heads.

The counterpart of ``paddle_tpu/models/nlp/bert.py``: ``BertConfig``,
``bert_base``, ``bert_tiny``, ``BertEmbeddings``, ``BertModel``,
``BertForPretraining`` and ``bert_pretrain_loss``, with the JAX model's
parameter names and layouts, so its state dict maps on name by name
(``convert.bert_params_from_jax``). The MLM decoder is tied to
``bert.embeddings.word.weight``; ``mlm_bias`` is a bias parameter
(zeros). Weights are drawn as the reference draws them: the embeddings
from N(0, ``initializer_range``**2), every ``Linear`` weight
Xavier-uniform, biases 0, LayerNorms 1 and 0; and, as there, the
encoder's layers are deep copies of its first, so they start equal.

``attention_mask`` (B, L) of 1/0 becomes the additive ``(1 - mask) *
-1e30`` in float32, shaped ``(B, 1, 1, L)``, which the dense attention
adds to its float32 scores: with a mask, attention is dense, as in the
reference. Every LayerNorm (26 a step in ``bert_base``) runs the
hand-written LayerNorm kernels on the card. The MLM loss takes the
fused cross-entropy kernel only where the JAX package does (vocab a
multiple of 128: ``bert_tiny``'s 1024, not ``bert_base``'s 30522).

``model.bfloat16()`` casts every floating parameter, the LayerNorms' and
``mlm_bias`` too, as the reference's ``Layer._to_dtype`` does
(``paddle_tpu/nn/layer.py:337-347``); logits come out in the
parameters' type.
"""
from __future__ import annotations

import torch

from ...nn.layer import Layer
from ..._device import resolve_device
from ...nn import functional as F
from ...nn.initializer import Normal
from ...ops.math import matmul
from ...nn.layers import (Dropout, Embedding, LayerNorm, Linear,
                          TransformerEncoder, TransformerEncoderLayer,
                          create_parameter)

__all__ = ["BertConfig", "BertEmbeddings", "BertModel", "BertForPretraining",
           "bert_base", "bert_tiny", "bert_pretrain_loss"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden=768, layers=12, heads=12,
                 intermediate=3072, max_position=512, type_vocab=2,
                 dropout=0.1, initializer_range=0.02):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.heads = heads
        self.intermediate = intermediate
        self.max_position = max_position
        self.type_vocab = type_vocab
        self.dropout = dropout
        self.initializer_range = initializer_range


def bert_base(**kw):
    return BertConfig(**kw)


def bert_tiny(**kw):
    kw.setdefault("vocab_size", 1024)
    kw.setdefault("hidden", 128)
    kw.setdefault("layers", 2)
    kw.setdefault("heads", 2)
    kw.setdefault("intermediate", 512)
    kw.setdefault("max_position", 128)
    return BertConfig(**kw)


class BertEmbeddings(Layer):
    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        std = cfg.initializer_range

        def table(n):
            return Embedding(n, cfg.hidden, weight_attr=Normal(0.0, std),
                             device=device, generator=generator)

        self.word = table(cfg.vocab_size)
        self.position = table(cfg.max_position)
        self.token_type = table(cfg.type_vocab)
        self.norm = LayerNorm(cfg.hidden, device=device)
        self.drop = Dropout(cfg.dropout)

    def forward(self, ids, token_type_ids=None):
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = self.word(ids) + self.position(pos)
        if token_type_ids is not None:
            x = x + self.token_type(token_type_ids)
        return self.drop(self.norm(x))


class BertModel(Layer):
    """Encoder trunk: embeddings -> N Transformer encoder layers (post-norm,
    GELU) -> the pooled first token."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        self.embeddings = BertEmbeddings(cfg, device, generator)
        layer = TransformerEncoderLayer(
            cfg.hidden, cfg.heads, cfg.intermediate, dropout=cfg.dropout,
            activation="gelu", device=device, generator=generator)
        self.encoder = TransformerEncoder(layer, cfg.layers)
        self.pooler = Linear(cfg.hidden, cfg.hidden, device=device,
                             generator=generator)

    @staticmethod
    def attn_mask(attention_mask):
        """``(B, L)`` 1/0 -> the additive ``(B, 1, 1, L)`` float32 mask."""
        if attention_mask is None:
            return None
        m = (1.0 - attention_mask.float()) * -1e30
        return m[:, None, None, :]

    def forward(self, ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(ids, token_type_ids)
        x = self.encoder(x, src_mask=self.attn_mask(attention_mask))
        return x, F.tanh(self.pooler(x[:, 0]))


class BertForPretraining(Layer):
    """``model(ids, token_type_ids, attention_mask) -> (mlm_logits (B, L,
    vocab), nsp_logits (B, 2))``: the MLM head (transform, GELU,
    LayerNorm, the tied decoder plus ``mlm_bias``) and the NSP head over
    the pooled token.

    Built on ``device`` (``cuda`` unless the caller passes ``"cpu"``);
    weights drawn from ``generator`` (default: the device's, seeded by
    ``core.random.seed``). Dropout draws from the device's generator."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        self.bert = BertModel(cfg, device, generator)
        self.transform = Linear(cfg.hidden, cfg.hidden, device=device,
                                generator=generator)
        self.transform_norm = LayerNorm(cfg.hidden, device=device)
        self.mlm_bias = create_parameter((cfg.vocab_size,), is_bias=True,
                                         device=device, owner=self)
        self.nsp = Linear(cfg.hidden, 2, device=device, generator=generator)

    def forward(self, ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(ids, token_type_ids, attention_mask)
        h = self.transform_norm(F.gelu(self.transform(seq)))
        mlm_logits = matmul(h, self.bert.embeddings.word.weight.t())
        return mlm_logits + self.mlm_bias, self.nsp(pooled)


def bert_pretrain_loss(model, ids, token_type_ids, attention_mask,
                       mlm_labels, nsp_labels, ignore_index=-100):
    """Masked-LM cross-entropy (the mean over the positions whose label
    is not ``ignore_index``) plus the NSP cross-entropy."""
    mlm_logits, nsp_logits = model(ids, token_type_ids, attention_mask)
    V = mlm_logits.shape[-1]
    mlm = F.cross_entropy(mlm_logits.reshape(-1, V), mlm_labels.reshape(-1),
                          ignore_index=ignore_index)
    return mlm + F.cross_entropy(nsp_logits, nsp_labels)
