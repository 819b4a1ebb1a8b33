"""Attention: ``sdpa_bhld``, scaled-dot-product attention in the
``(B, H, L, D)`` layout, and ``scaled_dot_product_attention``, Paddle's
``(B, L, H, D)`` wrapper over it (``attention.py:75-86``), which keeps
its flash routing.

The counterpart of ``paddle_tpu/nn/functional/attention.py``. Its
``_flash_ok`` gate stays with the same conditions: no mask, no dropout,
``Lq % 128 == 0``, ``Lk % 128 == 0``, ``D % 64 == 0`` and ``D <= 256``.
Where the gate holds, attention is ``ops.kernels.flash_attention``'s
``autograd.Function``: on CUDA tensors it launches the flash kernels,
forward and backward; on the CPU, or inside ``plain_versions()``, it
runs their plain versions. Everywhere else — with a mask, or at dropout
> 0 in training, as ``gpt_small`` trains by default — attention is the
dense path below, the JAX package's own.

``sdpa_bhld`` is the registered op ``sdpa`` (the JAX package's dispatch
name), so ``amp.auto_cast`` casts q, k, v and the mask by its list entry
and a static Program records attention as one op.
"""
from __future__ import annotations

import torch

from ...ops._base import register
from ...ops.kernels.flash_attention import flash_attention
from ...ops.manipulation import transpose
from ...ops.random_ops import dropout

__all__ = ["sdpa_bhld", "scaled_dot_product_attention", "flash_ok"]

NEG_INF = -1e30


def flash_ok(q, k, dropout_p, mask):
    """True when the JAX package sends this attention to its flash kernel
    (``attention.py:21-30``, without the platform switch)."""
    if mask is not None or dropout_p > 0.0:
        return False
    Lq, D = q.shape[-2], q.shape[-1]
    Lk = k.shape[-2]
    return Lq % 128 == 0 and Lk % 128 == 0 and D % 64 == 0 and D <= 256


def _dense(q, k, v, mask, scale, is_causal, dropout_p, generator):
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if is_causal:
        Lq, Lk = scores.shape[-2], scores.shape[-1]
        causal = torch.ones(Lq, Lk, dtype=torch.bool,
                            device=q.device).tril(Lk - Lq)
        scores = scores.masked_fill(~causal, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, NEG_INF)
        else:
            scores = scores + mask.float()
    p = torch.softmax(scores, dim=-1)
    # dropout on the attention *weights*, before the V product, with
    # upscale-in-train normalisation (the reference's semantics)
    p = dropout(p, dropout_p, training=True, generator=generator)
    return torch.matmul(p.to(v.dtype), v)


@register("sdpa", inputs=("query", "key", "value", "attn_mask"))
def sdpa_bhld(query, key, value, attn_mask=None, scale=None,
              is_causal=False, dropout_p=0.0, training=True, generator=None):
    """Attention over ``(B, H, L, D)`` tensors; ``is_causal`` aligns the
    last query with the last key (offset ``Lk - Lq``). Dropout, in
    training only, draws from ``generator`` (default: the device's)."""
    if scale is None:
        scale = 1.0 / (query.shape[-1] ** 0.5)
    p = float(dropout_p) if dropout_p > 0.0 and training else 0.0
    if flash_ok(query, key, p, attn_mask):
        return flash_attention(query, key, value, bool(is_causal),
                               float(scale))
    return _dense(query, key, value, attn_mask, float(scale),
                  bool(is_causal), p, generator)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Attention over ``(B, L, H, D)`` tensors: ``sdpa_bhld`` of the
    ``(B, H, L, D)`` transposes, transposed back."""
    q, k, v = (transpose(t, [0, 2, 1, 3]) for t in (query, key, value))
    out = sdpa_bhld(q, k, v, attn_mask=attn_mask, is_causal=is_causal,
                    dropout_p=dropout_p, training=training,
                    generator=generator)
    return transpose(out, [0, 2, 1, 3])
