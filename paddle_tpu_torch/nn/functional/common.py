"""Common functional ops: ``linear`` and ``embedding``.

The counterparts of ``paddle_tpu/nn/functional/common.py``'s. ``linear``
keeps Paddle's layout: the weight is ``(in_features, out_features)`` and
``y = x @ W + b``, so a JAX state dict maps on without a transpose.
``embedding``'s weight gradient is repeatable from run to run (see
``_Embedding``), so a training run is repeatable from its seed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops._base import register

__all__ = ["linear", "embedding"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with ``weight (in, out)``."""
    return _linear_nobias(x, weight) if bias is None else \
        _linear(x, weight, bias)


@register("linear", inputs=("x", "weight", "bias"))
def _linear(x, weight, bias):
    return torch.matmul(x, weight) + bias


@register("linear_nobias", inputs=("x", "weight"))
def _linear_nobias(x, weight):
    return torch.matmul(x, weight)


class _Embedding(torch.autograd.Function):
    """``F.embedding`` with the weight gradient of PyTorch's deterministic
    embedding backward. On CUDA the default one sums a row's gradients in
    an order that changes from run to run when many lookups hit the row:
    BERT's token-type table, whose one row all 8192 tokens read, got
    other float32 bits within 300 runs, and in bfloat16 now and then
    another rounding, so two runs of one training step parted. The
    deterministic variant sums in a fixed order, for 0.03-0.10 ms more a
    table at bench_bert's and bench_gpt's shapes
    (``tools/torch_repeatability.py``, H100 80GB HBM3 at 700 W). The
    switch is the process-wide flag of
    ``torch.use_deterministic_algorithms``, turned on (warnings only)
    around the one call and back; it is set through ``torch._C`` because
    the public function also imports the inductor's config, 6.1 s of
    host time at its first call (same tool and card)."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x)
        ctx.num_weights = weight.shape[0]
        return F.embedding(x, weight)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        on = torch.are_deterministic_algorithms_enabled()
        warn = torch.is_deterministic_algorithms_warn_only_enabled()
        torch._C._set_deterministic_algorithms(True, warn_only=True)
        try:
            dw = torch.ops.aten.embedding_dense_backward(
                grad, x, ctx.num_weights, -1, False)
        finally:
            torch._C._set_deterministic_algorithms(on, warn_only=warn)
        return None, dw


@register("embedding", inputs=("x", "weight"))
def embedding(x, weight, padding_idx=None):
    """Rows of ``weight (num_embeddings, dim)`` at the indices ``x``; 0
    wherever ``x == padding_idx`` (so that row gets no gradient), as the
    JAX package masks it (``functional/common.py:40-45``)."""
    out = _Embedding.apply(x, weight)
    if padding_idx is None:
        return out
    return out * (x != padding_idx)[..., None].to(out.dtype)
