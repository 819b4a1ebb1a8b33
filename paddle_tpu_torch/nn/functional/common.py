"""Common functional ops: ``linear``, ``embedding``, ``one_hot``,
``cosine_similarity``, ``pairwise_distance``, ``label_smooth`` and
``bilinear``.

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

__all__ = ["linear", "embedding", "one_hot", "cosine_similarity",
           "pairwise_distance", "label_smooth", "bilinear"]


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


@register("one_hot", inputs=("x",))
def _one_hot(x, *, num_classes):
    return F.one_hot(x.long(), num_classes).to(torch.float32)


def one_hot(x, num_classes):
    """float32 one-hot rows of the integer ``x``: ``x.shape +
    (num_classes,)``."""
    return _one_hot(x, num_classes=int(num_classes))


@register("cosine_similarity", inputs=("x1", "x2"))
def _cosine_similarity(x1, x2, *, axis, eps):
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.sqrt((x1 * x1).sum(dim=axis))
    n2 = torch.sqrt((x2 * x2).sum(dim=axis))
    return dot / torch.clamp_min(n1 * n2, eps)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """``x1 . x2 / max(|x1| |x2|, eps)`` along ``axis``."""
    return _cosine_similarity(x1, x2, axis=int(axis), eps=float(eps))


@register("pairwise_distance", inputs=("x", "y"))
def _pairwise_distance(x, y, *, p, epsilon, keepdim):
    d = x - y + epsilon
    return (torch.abs(d) ** p).sum(dim=-1, keepdim=keepdim) ** (1.0 / p)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    """The ``p``-norm of ``x - y + epsilon`` along the last axis."""
    return _pairwise_distance(x, y, p=float(p), epsilon=float(epsilon),
                              keepdim=bool(keepdim))


@register("label_smooth", inputs=("label",))
def _label_smooth(label, *, epsilon):
    return label * (1.0 - epsilon) + epsilon / label.shape[-1]


@register("label_smooth_prior", inputs=("label", "prior"))
def _label_smooth_prior(label, prior, *, epsilon):
    return label * (1.0 - epsilon) + epsilon * prior


def label_smooth(label, prior_dist=None, epsilon=0.1):
    """``(1 - epsilon) label + epsilon / K`` (or ``+ epsilon *
    prior_dist``)."""
    if prior_dist is not None:
        return _label_smooth_prior(label, prior_dist, epsilon=float(epsilon))
    return _label_smooth(label, epsilon=float(epsilon))


@register("bilinear", inputs=("x1", "x2", "weight", "bias"))
def _bilinear(x1, x2, weight, bias):
    return torch.einsum("bi,oij,bj->bo", x1, weight, x2) + bias


@register("bilinear_nobias", inputs=("x1", "x2", "weight"))
def _bilinear_nobias(x1, x2, weight):
    return torch.einsum("bi,oij,bj->bo", x1, weight, x2)


def bilinear(x1, x2, weight, bias=None):
    """``y[b, o] = x1[b] @ weight[o] @ x2[b] + bias[o]``, ``weight (out,
    in1, in2)``."""
    if bias is None:
        return _bilinear_nobias(x1, x2, weight)
    return _bilinear(x1, x2, weight, bias)
