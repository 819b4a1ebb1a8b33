"""Transformer for WMT en-de machine translation.

The counterpart of ``paddle_tpu/models/nlp/transformer.py`` (:27-257):
an encoder-decoder with a sinusoidal position table, the output
projection tied to the target embedding, the label-smoothed loss
``wmt_loss``, and decoding — ``greedy_decode``, ``beam_search_decode``
(the growing caches, op by op, a host sync a step) and
``beam_search_decode_xla`` (the static caches and
``inference.beam_search_xla``, the encode and the whole beam search as
one CUDA graph per signature on the card, through
``framework.ProgramCache``; op by op on the CPU). Parameter names and
layouts are the JAX model's (``convert.wmt_params_from_jax``).

On the card every LayerNorm runs the LayerNorm kernel: the encoder's
rows are ``B * L_src`` and a decode step's ``B * beam`` (or ``B``), each
a multiple of 8 at bench_wmt_beam's shapes, at ``d_model`` 512.
Attention is dense on this path (masks, or a query of one row), as in
the reference.

The position table is float32, kept beside the parameters on the
model's device (not a parameter or buffer, as the reference keeps a
numpy constant), and cast to the embedding's type before the add.
Positions past ``max_len`` are refused with ``ValueError`` (the
reference fails on the eager path and clamps in its jitted one).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...nn.layer import Layer
from ..._device import as_ids, resolve_device
from ...framework.jit import ProgramCache
from ...inference.decoder import beam_search, beam_search_xla, tile_beam
from ...nn import functional as F
from ...nn.layers import Dropout, Embedding
from ...nn.layers.transformer import Transformer

__all__ = ["WMTTransformer", "wmt_loss", "position_encoding"]


def position_encoding(max_len, d_model):
    """Sinusoidal table ``(max_len, d_model)``, float32 numpy."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    dim = np.arange(0, d_model, 2).astype(np.float64)
    inv = 1.0 / np.power(10000.0, dim / d_model)
    table = np.zeros((max_len, d_model), np.float32)
    table[:, 0::2] = np.sin(pos * inv)
    table[:, 1::2] = np.cos(pos * inv)
    return table


class WMTTransformer(Layer):
    """Encoder-decoder translation model with a tied target softmax,
    built on ``device`` (``cuda`` unless the caller passes ``"cpu"``),
    weights drawn from ``generator`` (default: the device's)."""

    def __init__(self, src_vocab, tgt_vocab, d_model=512, nhead=8,
                 num_layers=6, dim_feedforward=2048, dropout=0.1,
                 max_len=256, bos_id=0, eos_id=1, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.d_model = d_model
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.max_len = max_len
        self.src_embed = Embedding(src_vocab, d_model, device=device,
                                   generator=generator)
        self.tgt_embed = Embedding(tgt_vocab, d_model, device=device,
                                   generator=generator)
        self.pos_table = torch.from_numpy(
            position_encoding(max_len, d_model)).to(device)
        self.drop = Dropout(dropout)
        self.transformer = Transformer(
            d_model, nhead, num_layers, num_layers, dim_feedforward, dropout,
            device=device, generator=generator)
        self.tgt_vocab = tgt_vocab

    def _ids(self, ids):
        return as_ids(ids, self.src_embed.weight.device)

    def _positions(self, start, n):
        """Rows ``start .. start + n - 1`` of the position table."""
        if start < 0 or start + n > self.max_len:
            raise ValueError(f"positions {start}..{start + n - 1} are past "
                             f"max_len {self.max_len}")
        return self.pos_table[start:start + n]

    def _embed(self, table, ids):
        x = table(ids) * float(np.sqrt(self.d_model))
        # the float32 table in the embedding's type: a float32 add would
        # lift a bfloat16 model's activations to float32
        pos = self._positions(0, ids.shape[1]).to(x.dtype)
        return self.drop(x + pos)

    def _src_mask(self, src, pad_id=None):
        """``(B, 1, 1, L)`` additive float32 mask: -1e30 at ``pad_id``."""
        if pad_id is None:
            return None
        m = torch.where(src == pad_id, -1e30, 0.0).float()
        return m[:, None, None, :]

    def forward(self, src, tgt, src_pad_id=None):
        """Teacher-forced logits ``(B, Lt, tgt_vocab)``."""
        src, tgt = self._ids(src), self._ids(tgt)
        src_mask = self._src_mask(src, src_pad_id)
        tgt_mask = Transformer.generate_square_subsequent_mask(
            tgt.shape[1], device=tgt.device)
        memory = self.transformer.encoder(self._embed(self.src_embed, src),
                                          src_mask=src_mask)
        out = self.transformer.decoder(self._embed(self.tgt_embed, tgt),
                                       memory, tgt_mask=tgt_mask,
                                       memory_mask=src_mask)
        return torch.matmul(out, self.tgt_embed.weight.t())

    def encode(self, src, src_pad_id=None):
        """``(memory (B, L, d_model), src_mask or None)``."""
        src = self._ids(src)
        src_mask = self._src_mask(src, src_pad_id)
        memory = self.transformer.encoder(self._embed(self.src_embed, src),
                                          src_mask=src_mask)
        return memory, src_mask

    def decode_step(self, tgt_tok, memory, caches, pos, src_mask=None):
        """One incremental step: ``tgt_tok (B, 1)`` at position ``pos`` (a
        Python int) through the decoder's caches. Returns ``(logits (B,
        vocab), new caches)``."""
        x = self.tgt_embed(tgt_tok) * float(np.sqrt(self.d_model))
        x = x + self._positions(int(pos), 1).to(x.dtype)
        out, new_caches = self.transformer.decoder(
            x, memory, memory_mask=src_mask, cache=caches)
        logits = torch.matmul(out[:, -1], self.tgt_embed.weight.t())
        return logits, new_caches

    def _max_len(self, max_len):
        max_len = max_len or self.max_len
        if max_len - 1 > self.max_len:   # steps read positions 0..max_len-2
            raise ValueError(f"max_len {max_len} needs positions past the "
                             f"table's {self.max_len}")
        return max_len

    @torch.no_grad()
    def greedy_decode(self, src, max_len=None, src_pad_id=None):
        """Greedy decode through the growing caches, op by op: ``(B,
        max_len)`` int64, BOS first."""
        max_len = self._max_len(max_len)
        memory, src_mask = self.encode(src, src_pad_id)
        caches = self.transformer.decoder.gen_cache(memory)
        B = memory.shape[0]
        cur = torch.full((B, 1), self.bos_id, dtype=torch.int64,
                         device=memory.device)
        outs = [cur]
        for t in range(max_len - 1):
            logits, caches = self.decode_step(cur, memory, caches, t,
                                              src_mask)
            cur = logits.argmax(dim=-1, keepdim=True)
            outs.append(cur)
        return torch.cat(outs, dim=1)

    @torch.no_grad()
    def beam_search_decode(self, src, beam_size=4, max_len=None,
                           src_pad_id=None, length_penalty=0.6,
                           return_all=False):
        """Beam search through ``inference.beam_search`` on the growing
        caches, op by op with a host sync a step. Returns ``(tokens,
        scores)`` as ``beam_search`` does."""
        max_len = self._max_len(max_len)
        memory, src_mask = self.encode(src, src_pad_id)
        B = memory.shape[0]
        # memory and mask are the same for every beam of a batch item, so
        # they stay out of the reordered beam state
        mem_k = tile_beam(memory, beam_size)
        mask_k = tile_beam(src_mask, beam_size) if src_mask is not None \
            else None
        caches_k = self.transformer.decoder.gen_cache(mem_k)

        def step_fn(tok, caches, t):
            return self.decode_step(tok, mem_k, caches, t, mask_k)

        return beam_search(
            step_fn, caches_k, B, self.bos_id, self.eos_id, beam_size,
            max_len, length_penalty=length_penalty, return_all=return_all,
            state_is_tiled=True)

    def _traced_beam_decode(self, src, *, beam_size, max_len, src_pad_id,
                            length_penalty, return_all):
        """Encode and the static-cache beam search with no host sync.
        Returns ``(tokens, scores)``."""
        memory, src_mask = self.encode(src, src_pad_id)
        B = memory.shape[0]
        mem_k = tile_beam(memory, beam_size)
        mask_k = tile_beam(src_mask, beam_size) if src_mask is not None \
            else None
        pairs = self.transformer.decoder.gen_static_cache(mem_k, max_len)
        statics = [p[1] for p in pairs]

        def step_fn(tok, incs, t):
            # the cross-attention caches are the same for every beam:
            # only the self-attention buffers are reordered
            logits, new_caches = self.decode_step(
                tok, mem_k, list(zip(incs, statics)), t, mask_k)
            return logits, [c[0] for c in new_caches]

        return beam_search_xla(
            step_fn, [p[0] for p in pairs], B, self.bos_id, self.eos_id,
            beam_size, max_len, length_penalty=length_penalty,
            return_all=return_all)

    def beam_search_decode_xla(self, src, beam_size=4, max_len=None,
                               src_pad_id=None, length_penalty=0.6,
                               return_all=False):
        """The encode and the whole beam search as one program: one CUDA
        graph per signature (batch, source length, beam, ``max_len``,
        ``src_pad_id``, length penalty, ``return_all``; ``framework
        .ProgramCache`` adds ``training``, ``plain_versions()`` and the
        parameters' storage) on the card, op by op on the CPU. No host
        sync between steps; the graph reads the parameters in place, so
        weights updated between calls are honoured. Returns ``(tokens,
        scores)`` as ``beam_search`` does."""
        max_len = self._max_len(max_len)
        src = self._ids(src)
        cache = getattr(self, "_xla_decode_cache", None)
        if cache is None:
            cache = self._xla_decode_cache = ProgramCache()
        key = (tuple(src.shape), beam_size, max_len, src_pad_id,
               length_penalty, bool(return_all))
        fn = functools.partial(
            self._traced_beam_decode, beam_size=beam_size, max_len=max_len,
            src_pad_id=src_pad_id, length_penalty=length_penalty,
            return_all=return_all)
        return cache(self, key, lambda s, _gen: fn(s), (src,))


def wmt_loss(model, src, tgt_in, tgt_label, smooth_eps=0.1, pad_id=None):
    """Label-smoothed cross-entropy over the target positions that are
    not ``pad_id``: the mean over them (over all without ``pad_id``)."""
    logits = model(src, tgt_in, src_pad_id=pad_id)
    V = logits.shape[-1]
    flat = logits.reshape(-1, V)
    lab = model._ids(tgt_label).reshape(-1)
    if smooth_eps and smooth_eps > 0.0:
        soft = torch.nn.functional.one_hot(lab, V).float() * \
            (1.0 - smooth_eps) + smooth_eps / V
        per_tok = -(soft * torch.log_softmax(flat, dim=-1)).sum(dim=-1)
    else:
        per_tok = F.cross_entropy(flat, lab, reduction="none")
    if pad_id is not None:
        keep = (lab != pad_id).float()
        return (per_tok * keep).sum() / keep.sum().clamp_min(1.0)
    return per_tok.mean()
