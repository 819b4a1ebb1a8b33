"""Loss functions: ``cross_entropy`` over hard or soft labels.

The counterpart of ``cross_entropy`` in
``paddle_tpu/nn/functional/loss.py``, with its routing: 2-D ``(N, V)``
logits, hard labels, no class weights, no label smoothing, ``N % 8 ==
0`` and ``V % 128 == 0`` go to the fused softmax-cross-entropy kernel
(``ops.kernels.softmax_ce``, whose wrapper picks the CUDA kernel or its
plain version by device); anything else takes the dense float32 path,
the JAX package's own. Soft labels (a distribution over the classes
for each row) take the JAX package's dense soft-label path
(``loss.py:92-101``): ``-sum(label * log_softmax(x))`` in float32.
"""
from __future__ import annotations

import torch

from ...ops._base import register
from ...ops.kernels.softmax_ce import softmax_cross_entropy

__all__ = ["cross_entropy", "fused_ce_ok"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def fused_ce_ok(logits, label, weight, axis, use_softmax, label_smoothing):
    """True when the JAX package routes this cross-entropy to its kernel
    (``loss.py:39-47``, without the platform switch)."""
    return (weight is None and use_softmax and label_smoothing == 0.0
            and axis in (-1, logits.dim() - 1) and logits.dim() == 2
            and label.dim() in (1, 2) and logits.shape[0] % 8 == 0
            and logits.shape[1] % 128 == 0)


def _dense(logits, label, weight, axis, ignore_index, reduction,
           use_softmax, label_smoothing):
    lf = logits.float()
    logp = torch.log_softmax(lf, dim=axis) if use_softmax else \
        torch.log(lf.clamp_min(1e-12))
    label = label.long()
    if label.dim() == logp.dim():  # (..., 1) trailing dim, fluid-style
        label = label.squeeze(axis)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    last = logp.movedim(axis, -1)
    picked = last.gather(-1, safe[..., None])[..., 0]
    if label_smoothing > 0.0:
        picked = (1.0 - label_smoothing) * picked + \
            label_smoothing * last.mean(dim=-1)
    loss = -picked
    w = weight.float()[safe] if weight is not None else \
        torch.ones_like(loss)
    w = torch.where(valid, w, torch.zeros_like(w))
    loss = loss * w
    if reduction == "mean":
        return loss.sum() / w.sum().clamp_min(1e-12)
    if reduction == "sum":
        return loss.sum()
    return loss


@register("cross_entropy_soft", inputs=("logits", "label"))
def _soft(logits, label, *, axis, reduction, use_softmax, label_smoothing):
    lf = logits.float()
    logp = torch.log_softmax(lf, dim=axis) if use_softmax else \
        torch.log(lf.clamp_min(1e-12))
    lab = label.float()
    if label_smoothing > 0.0:
        lab = lab * (1.0 - label_smoothing) + \
            label_smoothing / lab.shape[axis]
    return _reduce(-(lab * logp).sum(dim=axis), reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross-entropy of ``input`` against hard integer ``label``
    (rows whose label is ``ignore_index`` count neither in the loss nor
    in the mean's denominator) or, with ``soft_label``, against a
    ``label`` of ``input``'s shape holding each row's class
    probabilities (``weight`` and ``ignore_index`` are not read)."""
    if soft_label:
        return _soft(input, label, axis=axis, reduction=reduction,
                     use_softmax=bool(use_softmax),
                     label_smoothing=float(label_smoothing))
    return _hard(input, label, weight, axis=axis,
                 ignore_index=int(ignore_index), reduction=reduction,
                 use_softmax=bool(use_softmax),
                 label_smoothing=float(label_smoothing))


@register("cross_entropy_hard", inputs=("logits", "label", "weight"))
def _hard(logits, label, weight, *, axis, ignore_index, reduction,
          use_softmax, label_smoothing):
    """The JAX package's op ``cross_entropy_hard`` (``loss.py:50-89``):
    the fused kernel where ``fused_ce_ok``, else the dense path."""
    if fused_ce_ok(logits, label, weight, axis, use_softmax,
                   label_smoothing):
        lab = label if label.dim() == 1 else label.squeeze(-1)
        loss = softmax_cross_entropy(logits, lab, ignore_index)
        if reduction == "mean":
            valid = (lab != ignore_index).float()
            return loss.sum() / valid.sum().clamp_min(1e-12)
        return _reduce(loss, reduction)
    return _dense(logits, label, weight, axis, ignore_index, reduction,
                  use_softmax, label_smoothing)
