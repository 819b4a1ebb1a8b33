"""GPT: the decoder-only language model, for training and decoding.

The counterpart of ``paddle_tpu/models/nlp/gpt.py``: the forward of
training and evaluation (``GPTAttention.forward`` :97-130,
``GPTBlock.forward`` :166-178 and ``GPT.forward`` :198-231), with either
KV cache, ``init_cache``, ``init_static_cache``, ``generate``,
``generate_xla`` (:233-357) and ``gpt_loss``. Parameter names and
layouts are the JAX model's, so its state dict maps on name by name
(``convert.gpt_params_from_jax``). The LM head is tied to
``wte.weight``.

Through ``ops.norm_ops.layer_norm`` and ``nn.functional.cross_entropy``
every LayerNorm and the loss run the hand-written kernels on the card.
Attention is ``sdpa_bhld``: dense with dropout in training; with
dropout 0 (or in eval) at flash-friendly shapes, the flash kernels.

The two caches, as in the reference:

- the growing cache (``init_cache``: per layer a ``(k, v)`` pair of
  length 0 that each forward extends by concatenation). Its forward
  passes ``is_causal=False`` to attention (``is_causal=cache is None``,
  reference :124), so ``generate``'s prefill over a prompt attends in
  both directions; at a prompt of a multiple of 128 tokens it takes the
  flash forward with ``causal=False``. The port keeps this.
- the static cache (``init_static_cache``: per layer a fixed-size
  ``StaticKVCache`` and its write index on the device), whose forward is
  causal through ``static_kv_attention``'s validity mask; positions are
  the index plus ``arange(L)``, read on the device. ``generate_xla``
  runs on it, prefill and decode steps, as one CUDA graph per signature
  on the card (``framework.ProgramCache``), with no host sync between
  tokens.

Positions past ``max_seq`` are refused on the host (``ValueError``)
where the host knows them: a forward without a cache or with a growing
one, and ``generate``/``generate_xla`` before they start. The JAX
package reads them as NaN rows (``jnp.take``'s fill).

``GPTConfig(dtype="bfloat16")`` initialises in float32 and then casts
every floating parameter and buffer, as the JAX ``GPT`` does through
``Layer._to_dtype`` (``paddle_tpu/nn/layer.py:337-347``);
``model.bfloat16()`` does the same to a float32 model. Logits come out
in the parameters' type.

``GPTConfig(use_recompute=True)`` (or ``GPT.set_recompute``, which
fleet's ``DistributedStrategy.recompute`` calls in the reference) runs
each block under ``framework.recompute`` in training without a cache,
as the reference's ``jax.checkpoint`` per block (:218-221): the
backward runs each block's forward again.

``GPTConfig(dtype="float16")`` works as ``"bfloat16"`` does.

Not ported yet: ring attention and the tensor-parallel mesh (they wait
for ``dist/``) and ``GPTPipeline``.
"""
from __future__ import annotations

import functools
import math

import torch

from ...nn.layer import Layer, LayerList
from ..._device import as_ids, resolve_device, resolve_dtype
from ...core.random import default_generator
from ...dist.tp_layers import (ColumnParallelLinear, RowParallelLinear,
                               VocabParallelEmbedding)
from ...framework.jit import ProgramCache
from ...framework.recompute import recompute
from ...nn import functional as F
from ...nn.initializer import Normal
from ...nn.layers import Dropout, Embedding, LayerNorm
from ...nn.layers.transformer import MultiHeadAttention, static_kv_attention
from ...ops.math import matmul

StaticKVCache = MultiHeadAttention.StaticKVCache  # the shared cache record
NEG_INF = -1e30

__all__ = ["GPTConfig", "GPT", "GPTBlock", "GPTAttention", "gpt_loss",
           "gpt_tiny", "gpt_small", "StaticKVCache"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden=768, layers=12, heads=12,
                 max_seq=1024, dropout=0.1, dtype="float32",
                 initializer_range=0.02, use_recompute=False):
        resolve_dtype(dtype)   # float32, bfloat16 or float16, else ValueError
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.heads = heads
        self.max_seq = max_seq
        self.dropout = dropout
        self.dtype = dtype
        self.initializer_range = initializer_range
        self.use_recompute = use_recompute


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=1024, hidden=128, layers=2, heads=4,
                     max_seq=128, **kw)


def gpt_small(**kw):
    return GPTConfig(vocab_size=50304, hidden=768, layers=12, heads=12, **kw)


class GPTAttention(Layer):
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

    def forward(self, x, cache=None):
        """Without a cache: causal attention, the output. With a static
        cache: the output and the advanced cache. With a growing ``(k,
        v)`` cache: attention over it and the new rows, not causal (as in
        the reference), the output and the grown cache."""
        B, L = x.shape[0], x.shape[1]

        def heads_of(t):
            return t.reshape(B, L, self.heads, self.head_dim).transpose(1, 2)

        q, k, v = (heads_of(t) for t in
                   self.qkv(x).split(self.cfg.hidden, dim=-1))
        if isinstance(cache, StaticKVCache):
            att, new_cache = static_kv_attention(
                q, k, v, cache, dropout_p=self.cfg.dropout,
                training=self.training)
            return self._out(att, B, L), new_cache
        new_cache = None
        if cache is not None:
            pk, pv = cache
            k = torch.cat([pk, k], dim=2)
            v = torch.cat([pv, v], dim=2)
            new_cache = (k, v)
        att = F.sdpa_bhld(q, k, v, is_causal=cache is None,
                          dropout_p=self.cfg.dropout, training=self.training)
        out = self._out(att, B, L)
        return out if new_cache is None else (out, new_cache)

    def _out(self, att, B, L):
        att = att.transpose(1, 2).reshape(B, L, self.cfg.hidden)
        return self.drop(self.proj(att))


class GPTBlock(Layer):
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

    def forward(self, x, cache=None):
        if cache is None:
            x = x + self.attn(self.ln1(x))
        else:
            att, cache = self.attn(self.ln1(x), cache=cache)
            x = x + att
        x = x + self.drop(self.fc2(F.gelu(self.fc1(self.ln2(x)),
                                          approximate=True)))
        return x if cache is None else (x, cache)


class GPT(Layer):
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
        self.blocks = LayerList([GPTBlock(cfg, device, generator)
                                 for _ in range(cfg.layers)])
        self.ln_f = LayerNorm(cfg.hidden, device=device)
        if cfg.dtype != "float32":
            self.to(resolve_dtype(cfg.dtype))

    def forward(self, ids, cache=None):
        """``ids (B, L)`` -> logits ``(B, L, vocab)``; with ``cache`` (one
        per layer, growing or static) -> ``(logits, new caches)``."""
        L = ids.shape[1]
        if cache is not None and isinstance(cache[0], StaticKVCache):
            # the write index is the global position, read on the device
            pos = cache[0].idx + torch.arange(L, device=ids.device)
        else:
            n = 0 if cache is None else cache[0][0].shape[2]
            self._check_positions(n + L)
            pos = torch.arange(n, n + L, device=ids.device)
        x = self.drop(self.wte(ids) + self.wpe(pos))
        new_caches = None if cache is None else []
        for i, blk in enumerate(self.blocks):
            if cache is None:
                if self.cfg.use_recompute and self.training:
                    x = recompute(blk, x)
                else:
                    x = blk(x)
            else:
                x, c = blk(x, cache=cache[i])
                new_caches.append(c)
        x = self.ln_f(x)
        # LM head tied to the token embedding
        logits = matmul(x, self.wte.weight.t())
        return logits if cache is None else (logits, new_caches)

    def set_recompute(self, value=True):
        """Run the blocks under recompute in training (fleet's
        ``DistributedStrategy.recompute`` in the reference)."""
        self.cfg.use_recompute = bool(value)

    def _check_positions(self, n):
        """Raise ``ValueError`` unless positions ``0..n-1`` fit in
        ``max_seq``."""
        if n > self.cfg.max_seq:
            raise ValueError(f"a sequence of {n} positions is longer than "
                             f"max_seq {self.cfg.max_seq}")

    def init_cache(self, batch_size):
        """The growing cache: per layer ``(k, v)`` of length 0."""
        w = self.wte.weight
        z = w.new_zeros(batch_size, self.cfg.heads, 0,
                        self.cfg.hidden // self.cfg.heads)
        return [(z, z) for _ in range(self.cfg.layers)]

    def init_static_cache(self, batch_size, max_length):
        """Per layer fixed-size zeroed k and v buffers ``(batch_size,
        heads, max_length, head_dim)`` in the parameters' type, and a
        write index 0 on their device."""
        w = self.wte.weight
        shape = (batch_size, self.cfg.heads, max_length,
                 self.cfg.hidden // self.cfg.heads)
        return [StaticKVCache(w.new_zeros(shape), w.new_zeros(shape),
                              torch.zeros((), dtype=torch.int64,
                                          device=w.device))
                for _ in range(self.cfg.layers)]

    @torch.no_grad()
    def generate(self, ids, max_new_tokens=32, temperature=1.0, top_k=None,
                 generator=None):
        """Greedy (``temperature=0.0``) or sampled decode through the
        growing cache, op by op: ``(B, L + max_new_tokens)`` int64 ids.
        Sampling keeps the ``top_k`` largest logits (all when None) of
        ``logits / temperature`` and draws with ``torch.multinomial`` from
        ``generator`` (default: the device's)."""
        ids = as_ids(ids, self.wte.weight.device)
        if max_new_tokens > 0:
            self._check_positions(ids.shape[1] + max_new_tokens - 1)
        if temperature != 0.0 and generator is None:
            generator = default_generator(ids.device)
        cache = self.init_cache(ids.shape[0])
        out = cur = ids
        for _ in range(max_new_tokens):
            logits, cache = self.forward(cur, cache=cache)
            last = logits[:, -1]
            if temperature == 0.0:
                nxt = last.argmax(dim=-1, keepdim=True)
            else:
                last = _top_k_filter(last.float() / temperature, top_k)
                nxt = torch.multinomial(torch.softmax(last, dim=-1), 1,
                                        generator=generator)
            out = torch.cat([out, nxt], dim=1)
            cur = nxt
        return out

    def _traced_generate(self, ids, generator, *, max_new_tokens,
                         temperature, top_k):
        """The whole decode on the static cache with no host sync: the
        prefill, then ``max_new_tokens - 1`` one-token steps. Returns
        ``((B, L + max_new_tokens) int64 ids,)``."""
        B, Lp = ids.shape
        caches = self.init_static_cache(B, Lp + max_new_tokens)
        pick = functools.partial(_pick, temperature=temperature,
                                 top_k=top_k, generator=generator)
        logits, caches = self.forward(ids, cache=caches)   # prefill
        toks = [pick(logits[:, -1])]
        for _ in range(max_new_tokens - 1):
            logits, caches = self.forward(toks[-1][:, None], cache=caches)
            toks.append(pick(logits[:, -1]))
        return (torch.cat([ids, torch.stack(toks, dim=1)], dim=1),)

    def generate_xla(self, ids, max_new_tokens=32, temperature=0.0,
                     top_k=None, seed=0):
        """The whole decode as one program: prefill and token steps over
        the static cache, one CUDA graph per signature (shape,
        ``max_new_tokens``, temperature, ``top_k``; ``framework
        .ProgramCache`` adds ``training``, ``plain_versions()`` and the
        parameters' storage) on the card, op by op on the CPU. Greedy at
        ``temperature=0.0``; else the ``top_k`` largest of ``logits /
        temperature`` sampled by the Gumbel-max rule (``jax.random
        .categorical``'s) from a generator seeded with ``seed`` for each
        call. The graph reads the parameters in place, so weights updated
        between calls are honoured. Returns ``(B, L + max_new_tokens)``
        int64 ids."""
        ids = as_ids(ids, self.wte.weight.device)
        if max_new_tokens <= 0:   # as the eager decode: the prompt
            return ids.clone()
        self._check_positions(ids.shape[1] + max_new_tokens - 1)
        cache = getattr(self, "_xla_gen_cache", None)
        if cache is None:
            cache = self._xla_gen_cache = ProgramCache()
        sig = (tuple(ids.shape), int(max_new_tokens), float(temperature),
               top_k)
        fn = functools.partial(
            self._traced_generate, max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_k=top_k)
        return cache(self, sig, fn, (ids,),
                     seed=None if temperature == 0.0 else seed)[0]


def _top_k_filter(logits, top_k):
    """``logits`` with every entry below the ``top_k``-th largest of its
    row set to -1e30 (``logits`` itself when ``top_k`` is None)."""
    if top_k is None:
        return logits
    kth = torch.topk(logits, int(top_k), dim=-1).values[:, -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def _pick(last, *, temperature, top_k, generator):
    """The next token of each row of ``last (B, V)``: the argmax at
    temperature 0 (the first on ties), else a Gumbel-max draw over the
    float32 ``top_k``-filtered ``last / temperature`` (the rule of
    ``jax.random.categorical``: argmax of logits plus
    ``-log(-log(u))``, u uniform in [tiny, 1))."""
    if temperature == 0.0:
        return last.argmax(dim=-1)
    logits = _top_k_filter(last.float() / temperature, top_k)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


def gpt_loss(model, ids, labels):
    """Next-token cross-entropy (labels already shifted), the mean over
    the rows whose label is not ``ignore_index``."""
    logits = model(ids)
    V = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))
