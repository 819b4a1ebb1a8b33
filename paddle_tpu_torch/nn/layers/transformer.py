"""Transformer layers: ``MultiHeadAttention`` with its KV caches,
``static_kv_attention``, the encoder and decoder layers and stacks, and
``Transformer``.

The counterparts of ``paddle_tpu/nn/layers/transformer.py``'s
(:27-402). Projections keep the ``(in, out)`` weight layout; attention
runs through ``nn.functional.sdpa_bhld``, so the JAX package's flash
gate decides the path: no mask and no dropout at flash-friendly shapes
take the flash kernels, anything else the dense attention.

The caches are the reference's records:

- ``MultiHeadAttention.Cache(k, v)``: the incremental cache that grows
  by concatenation (``gen_cache(key)`` makes an empty one, of length 0);
- ``MultiHeadAttention.StaticCache(k, v)``: K/V computed once (the
  decoder's cross-attention over the encoder's memory);
- ``MultiHeadAttention.StaticKVCache(k, v, idx)``: fixed-size
  ``(B, H, max_len, D)`` buffers and a write index, a 0-d int64 tensor
  on the buffers' device. ``static_kv_attention`` writes the new rows at
  ``idx`` and attends under a validity mask, so every decode step keeps
  the same shapes and reads the index on the device: a step can be
  captured in a CUDA graph. It writes into new buffers, as the JAX
  package does (``gen_static_kv_cache`` hands the same zeroed buffer out
  as k and v).

As in the reference, ``TransformerEncoder`` and ``TransformerDecoder``
deep-copy the layer they are given for every layer after the first, so
all their layers start with the same weights.
"""
from __future__ import annotations

import collections
import copy

import torch

from ..layer import Layer, LayerList
from ..._device import resolve_device, resolve_dtype
from .. import functional as F
from .common import Dropout, Linear, copy_parameter_attrs
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "static_kv_attention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]

NEG_INF = -1e30


def _dtype(dtype):
    return dtype if isinstance(dtype, torch.dtype) else resolve_dtype(dtype)


class MultiHeadAttention(Layer):
    """``(B, L, E)`` in, ``(B, L, E)`` out: ``q/k/v_proj``, heads of
    ``E / num_heads``, ``sdpa_bhld`` with ``attn_mask`` (additive, or
    boolean keep) and attention dropout ``dropout`` in training, then
    ``out_proj``. With a ``Cache`` it also returns the grown cache, with
    a ``StaticKVCache`` the advanced one."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])
    StaticKVCache = collections.namedtuple("StaticKVCache",
                                           ["k", "v", "idx"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        device = resolve_device(device)

        def proj(n_in):
            return Linear(n_in, embed_dim, weight_attr, bias_attr,
                          device=device, generator=generator)

        self.q_proj = proj(embed_dim)
        self.k_proj = proj(kdim)
        self.v_proj = proj(vdim)
        self.out_proj = proj(embed_dim)

    def _split_heads(self, x):
        # (B, L, E) -> (B, H, L, D)
        b, l = x.shape[0], x.shape[1]
        return x.reshape(b, l, self.num_heads, self.head_dim).transpose(1, 2)

    def _merge_heads(self, out):
        # (B, H, L, D) -> (B, L, E), then the output projection
        b, l = out.shape[0], out.shape[2]
        return self.out_proj(out.transpose(1, 2).reshape(b, l,
                                                         self.embed_dim))

    def compute_kv(self, key, value):
        return (self._split_heads(self.k_proj(key)),
                self._split_heads(self.v_proj(value)))

    def gen_cache(self, key, value=None, type=None):
        """``StaticCache`` of K/V from ``key`` (and ``value``) when
        ``type`` is ``StaticCache``; a ``Cache`` of them when ``value`` is
        given; else an empty ``Cache`` (length 0, key's type)."""
        if type == MultiHeadAttention.StaticCache:
            return self.StaticCache(*self.compute_kv(
                key, key if value is None else value))
        if value is not None:
            return self.Cache(*self.compute_kv(key, value))
        empty = key.new_zeros(key.shape[0], self.num_heads, 0,
                              self.head_dim)
        return self.Cache(empty, empty)

    def gen_static_kv_cache(self, batch_size, max_length, dtype="float32"):
        """Zeroed fixed-size incremental cache on the module's device:
        one ``(batch_size, H, max_length, D)`` buffer as k and v, and the
        write index 0."""
        dev = self.q_proj.weight.device
        buf = torch.zeros(batch_size, self.num_heads, max_length,
                          self.head_dim, dtype=_dtype(dtype), device=dev)
        return self.StaticKVCache(
            buf, buf, torch.zeros((), dtype=torch.int64, device=dev))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticKVCache):
            k_new, v_new = self.compute_kv(key, value)
            out, new_cache = static_kv_attention(
                q, k_new, v_new, cache, attn_mask=attn_mask,
                dropout_p=self.dropout, training=self.training)
            return self._merge_heads(out), new_cache
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k, v = self.compute_kv(key, value)
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=2)
                v = torch.cat([cache.v, v], dim=2)
                cache = self.Cache(k, v)
        out = self._merge_heads(F.sdpa_bhld(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training))
        outs = [out]
        if self.need_weights:
            outs.append(None)  # the weights are not materialised
        if isinstance(cache, self.Cache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


def static_kv_attention(q, k_new, v_new, cache, attn_mask=None,
                        dropout_p=0.0, training=False):
    """Fixed-buffer incremental attention: write the L new K/V rows at
    ``cache.idx`` (clamped so that they fit, as ``dynamic_update_slice``
    clamps), then attend over the whole buffer with a causal and
    validity mask — query i at position idx + i sees keys j <= idx + i
    (a one-token decode step and a prompt's prefill are the same
    formula). ``attn_mask`` (boolean keep, or additive) is folded in.
    The index may be a Python int or a 0-d tensor; it is read on the
    device. Returns ``((B, H, L, D) output, advanced StaticKVCache)``."""
    kb, vb = cache.k, cache.v
    dev = kb.device
    idx = cache.idx
    if not isinstance(idx, torch.Tensor):
        idx = torch.full((), int(idx), dtype=torch.int64, device=dev)
    idx = idx.to(torch.int64)
    L, Lmax = q.shape[2], kb.shape[2]
    rows = torch.arange(L, device=dev)
    at = idx.clamp(0, Lmax - L) + rows
    k_upd = kb.index_copy(2, at, k_new.to(kb.dtype))
    v_upd = vb.index_copy(2, at, v_new.to(vb.dtype))
    valid = (torch.arange(Lmax, device=dev)[None, :]
             <= idx + rows[:, None]).reshape(1, 1, L, Lmax)
    mask = valid
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            mask = valid & attn_mask
        else:  # additive: fold the validity window into it
            mask = torch.where(valid, attn_mask.float(),
                               torch.full((), NEG_INF, device=dev))
    out = F.sdpa_bhld(q, k_upd, v_upd, attn_mask=mask, dropout_p=dropout_p,
                      training=training)
    return out, MultiHeadAttention.StaticKVCache(k_upd, v_upd, idx + L)


class TransformerEncoderLayer(Layer):
    """Self-attention and a feed-forward block, each with a residual and
    a LayerNorm: after the residual (post-norm, the default) or before
    the block (``normalize_before``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        device = resolve_device(device)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, device=device, generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, device=device, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, device=device, generator=generator)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        act = getattr(F, self.activation)
        src = self.linear2(self.act_dropout(act(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src, type=MultiHeadAttention.Cache)


def _copies(layer, num_layers):
    """``layer`` and ``num_layers - 1`` deep copies of it, with its
    parameters' attributes."""
    copies = [copy.deepcopy(layer) for _ in range(num_layers - 1)]
    for c in copies:
        copy_parameter_attrs(layer, c)
    return LayerList([layer] + copies)


class TransformerEncoder(Layer):
    """``num_layers`` layers: ``encoder_layer`` and deep copies of it
    (the same weights and parameter attributes), then ``norm`` if
    given. With ``cache`` (one per layer) it also returns the grown
    caches."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _copies(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask=src_mask)
            else:
                output, c = mod(output, src_mask=src_mask, cache=cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over ``memory`` and a feed-forward
    block, each with a residual and a LayerNorm (post-norm unless
    ``normalize_before``). ``cache`` is ``(self-attention cache,
    cross-attention StaticCache)``; with it the layer also returns
    ``(advanced self-attention cache, the StaticCache)``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        device = resolve_device(device)

        def attention():
            return MultiHeadAttention(
                d_model, nhead, attn_dropout, weight_attr=weight_attr,
                bias_attr=bias_attr, device=device, generator=generator)

        self.self_attn = attention()
        self.cross_attn = attention()
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, device=device, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, device=device, generator=generator)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incremental_cache = None
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        static_cache = None if cache is None else cache[1]
        tgt = self.cross_attn(tgt, memory, memory, memory_mask, static_cache)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        act = getattr(F, self.activation)
        tgt = self.linear2(self.act_dropout(act(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache,
                                                static_cache))

    def gen_cache(self, memory):
        """``(empty self-attention Cache, cross-attention StaticCache of
        memory)``."""
        incremental = self.self_attn.gen_cache(
            memory, type=MultiHeadAttention.Cache)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    """``num_layers`` decoder layers: ``decoder_layer`` and deep copies of
    it, then ``norm`` if given. With ``cache`` (one pair per layer) it
    also returns the advanced caches."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _copies(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask=tgt_mask,
                             memory_mask=memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask=tgt_mask,
                                memory_mask=memory_mask, cache=cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """Per-layer ``(Cache, StaticCache)`` pairs; ``do_zip``: the
        incremental caches and the static ones as two lists."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache

    def gen_static_cache(self, memory, max_length):
        """Per-layer ``(StaticKVCache, StaticCache)`` pairs for the
        fixed-shape decode: zeroed ``max_length`` buffers in memory's
        type, cross-attention K/V from ``memory``."""
        b = memory.shape[0]
        out = []
        for layer in self.layers:
            inc = layer.self_attn.gen_static_kv_cache(b, max_length,
                                                      memory.dtype)
            static = layer.cross_attn.gen_cache(
                memory, memory, type=MultiHeadAttention.StaticCache)
            out.append((inc, static))
        return out


class Transformer(Layer):
    """An encoder (``num_encoder_layers``) and a decoder
    (``num_decoder_layers``), or the ``custom_encoder`` /
    ``custom_decoder`` given; with ``normalize_before``, each stack ends
    in a LayerNorm."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        kw = dict(device=device, generator=generator)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            norm = LayerNorm(d_model, device=device) if normalize_before \
                else None
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            norm = LayerNorm(d_model, device=device) if normalize_before \
                else None
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """``(length, length)`` float32 additive causal mask: 0 on and
        below the diagonal, -1e30 above, on ``device`` (``cuda`` unless
        the caller asks for ``"cpu"``)."""
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=resolve_device(device)).tril()
        return torch.where(keep, 0.0, NEG_INF).float()
