"""Transformer encoder layers: ``MultiHeadAttention``,
``TransformerEncoderLayer`` and ``TransformerEncoder``.

The counterparts of ``paddle_tpu/nn/layers/transformer.py``'s
(:27-60, :89-114, :174-246) without a KV cache. Projections keep the
``(in, out)`` weight layout; attention runs through
``nn.functional.sdpa_bhld``, so the JAX package's flash gate decides
the path: no mask and no dropout at flash-friendly shapes take the
flash kernels, anything else the dense attention.

As in the reference, ``TransformerEncoder`` deep-copies the layer it is
given for every layer after the first, so all its layers start with the
same weights.

Not ported yet: the caches (``Cache``, ``StaticCache``,
``StaticKVCache``, ``static_kv_attention``) and the decoder; asking for
a cache raises ``NotImplementedError``.
"""
from __future__ import annotations

import copy

from torch import nn

from ..._device import resolve_device
from .. import functional as F
from .common import Dropout, Linear, copy_parameter_attrs
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


def _no_cache():
    raise NotImplementedError("the Transformer layers' KV caches are not "
                              "ported yet")


class MultiHeadAttention(nn.Module):
    """``(B, L, E)`` in, ``(B, L, E)`` out: ``q/k/v_proj``, heads of
    ``E / num_heads``, ``sdpa_bhld`` with ``attn_mask`` (additive, or
    boolean keep) and attention dropout ``dropout`` in training, then
    ``out_proj``."""

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

    def gen_cache(self, key, value=None, type=None):
        _no_cache()

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            _no_cache()
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        out = F.sdpa_bhld(q, k, v, attn_mask=attn_mask,
                          dropout_p=self.dropout, training=self.training)
        b, l = out.shape[0], out.shape[2]
        out = self.out_proj(out.transpose(1, 2).reshape(b, l,
                                                        self.embed_dim))
        # the weights are not materialised on the fused path
        return (out, None) if self.need_weights else out


class TransformerEncoderLayer(nn.Module):
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
        if cache is not None:
            _no_cache()
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src,
                                                      src_mask))
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
        return src

    def gen_cache(self, src):
        _no_cache()


class TransformerEncoder(nn.Module):
    """``num_layers`` layers: ``encoder_layer`` and deep copies of it
    (the same weights and parameter attributes), then ``norm`` if
    given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        copies = [copy.deepcopy(encoder_layer)
                  for _ in range(num_layers - 1)]
        for c in copies:
            copy_parameter_attrs(encoder_layer, c)
        self.layers = nn.ModuleList([encoder_layer] + copies)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            _no_cache()
        output = src
        for mod in self.layers:
            output = mod(output, src_mask=src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output

    def gen_cache(self, src):
        _no_cache()
