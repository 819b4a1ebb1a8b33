"""GPT: the decoder-only language model, on its training path.

The counterpart of ``paddle_tpu/models/nlp/gpt.py`` for the forward of
training and evaluation without a KV cache (``GPTAttention.forward``
:97-130, ``GPTBlock.forward`` :166-172 and ``GPT.forward`` :198-231 with
``cache=None``), and ``gpt_loss``. Parameter names and layouts are the
JAX model's, so its state dict maps on name by name
(``convert.gpt_params_from_jax``). The LM head is tied to
``wte.weight``.

Through ``ops.norm_ops.layer_norm`` and ``nn.functional.cross_entropy``
every LayerNorm and the loss run the hand-written kernels on the card.
Attention is ``sdpa_bhld``: dense with dropout in training; with
dropout 0 (or in eval) at flash-friendly shapes, the flash kernels.

``GPTConfig(dtype="bfloat16")`` initialises in float32 and then casts
every floating parameter and buffer, as the JAX ``GPT`` does through
``Layer._to_dtype`` (``paddle_tpu/nn/layer.py:337-347``);
``model.bfloat16()`` does the same to a float32 model. Logits come out
in the parameters' type.

Not ported yet: the static and growing KV caches and ``generate*``,
ring attention, recompute and ``GPTPipeline``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..._device import resolve_device, resolve_dtype
from ...dist.tp_layers import (ColumnParallelLinear, RowParallelLinear,
                               VocabParallelEmbedding)
from ...nn import functional as F
from ...nn.initializer import Normal
from ...nn.layers import Dropout, Embedding, LayerNorm

__all__ = ["GPTConfig", "GPT", "GPTBlock", "GPTAttention", "gpt_loss",
           "gpt_tiny", "gpt_small"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden=768, layers=12, heads=12,
                 max_seq=1024, dropout=0.1, dtype="float32",
                 initializer_range=0.02):
        resolve_dtype(dtype)   # float32 or bfloat16, else ValueError
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.heads = heads
        self.max_seq = max_seq
        self.dropout = dropout
        self.dtype = dtype
        self.initializer_range = initializer_range


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=1024, hidden=128, layers=2, heads=4,
                     max_seq=128, **kw)


def gpt_small(**kw):
    return GPTConfig(vocab_size=50304, hidden=768, layers=12, heads=12, **kw)


class GPTAttention(nn.Module):
    def __init__(self, cfg, device, generator=None):
        super().__init__()
        self.cfg = cfg
        self.heads = cfg.heads
        self.head_dim = cfg.hidden // cfg.heads
        std = cfg.initializer_range
        self.qkv = ColumnParallelLinear(
            cfg.hidden, 3 * cfg.hidden, weight_attr=Normal(0.0, std),
            device=device, generator=generator)
        self.proj = RowParallelLinear(
            cfg.hidden, cfg.hidden,
            weight_attr=Normal(0.0, std / math.sqrt(2 * cfg.layers)),
            device=device, generator=generator)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x):
        B, L = x.shape[0], x.shape[1]
        q, k, v = self.qkv(x).split(self.cfg.hidden, dim=-1)

        def heads_of(t):
            return t.reshape(B, L, self.heads, self.head_dim).transpose(1, 2)

        att = F.sdpa_bhld(heads_of(q), heads_of(k), heads_of(v),
                          is_causal=True, dropout_p=self.cfg.dropout,
                          training=self.training)
        att = att.transpose(1, 2).reshape(B, L, self.cfg.hidden)
        return self.drop(self.proj(att))


class GPTBlock(nn.Module):
    def __init__(self, cfg, device, generator=None):
        super().__init__()
        self.cfg = cfg
        std = cfg.initializer_range
        self.ln1 = LayerNorm(cfg.hidden, device=device)
        self.attn = GPTAttention(cfg, device, generator)
        self.ln2 = LayerNorm(cfg.hidden, device=device)
        self.fc1 = ColumnParallelLinear(
            cfg.hidden, 4 * cfg.hidden, weight_attr=Normal(0.0, std),
            device=device, generator=generator)
        self.fc2 = RowParallelLinear(
            4 * cfg.hidden, cfg.hidden,
            weight_attr=Normal(0.0, std / math.sqrt(2 * cfg.layers)),
            device=device, generator=generator)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.drop(self.fc2(F.gelu(self.fc1(self.ln2(x)),
                                             approximate=True)))


class GPT(nn.Module):
    """``GPT(cfg)(ids (B, L)) -> logits (B, L, vocab)`` in ``cfg.dtype``.

    Built on ``device`` (``cuda`` unless the caller passes ``"cpu"``);
    weights drawn from ``generator`` (default: the device's, seeded by
    ``core.random.seed``). Dropout draws from the device's generator."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        std = cfg.initializer_range
        self.wte = VocabParallelEmbedding(cfg.vocab_size, cfg.hidden,
                                          weight_attr=Normal(0.0, std),
                                          device=device, generator=generator)
        self.wpe = Embedding(cfg.max_seq, cfg.hidden,
                             weight_attr=Normal(0.0, std), device=device,
                             generator=generator)
        self.drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList([GPTBlock(cfg, device, generator)
                                     for _ in range(cfg.layers)])
        self.ln_f = LayerNorm(cfg.hidden, device=device)
        if cfg.dtype != "float32":
            self.to(resolve_dtype(cfg.dtype))

    def forward(self, ids):
        L = ids.shape[1]
        if L > self.cfg.max_seq:
            raise ValueError(f"sequence of {L} tokens > max_seq "
                             f"{self.cfg.max_seq}")
        pos = torch.arange(L, device=ids.device)
        x = self.drop(self.wte(ids) + self.wpe(pos))
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_f(x)
        # LM head tied to the token embedding
        return torch.matmul(x, self.wte.weight.t())


def gpt_loss(model, ids, labels):
    """Next-token cross-entropy (labels already shifted), the mean over
    the rows whose label is not ``ignore_index``."""
    logits = model(ids)
    V = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))
