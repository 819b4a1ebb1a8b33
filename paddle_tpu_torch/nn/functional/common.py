"""Common functional ops: ``linear`` and ``embedding``.

The counterparts of ``paddle_tpu/nn/functional/common.py``'s. ``linear``
keeps Paddle's layout: the weight is ``(in_features, out_features)`` and
``y = x @ W + b``, so a JAX state dict maps on without a transpose.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["linear", "embedding"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with ``weight (in, out)``."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None):
    """Rows of ``weight (num_embeddings, dim)`` at the indices ``x``; 0
    wherever ``x == padding_idx`` (so that row gets no gradient), as the
    JAX package masks it (``functional/common.py:40-45``)."""
    out = F.embedding(x, weight)
    if padding_idx is None:
        return out
    return out * (x != padding_idx)[..., None].to(out.dtype)
