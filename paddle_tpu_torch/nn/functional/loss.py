"""Loss functions: ``cross_entropy`` over hard or soft labels, and the
JAX package's 17 others (``loss.py:117-433``).

The counterpart of ``cross_entropy`` in
``paddle_tpu/nn/functional/loss.py``, with its routing: 2-D ``(N, V)``
logits, hard labels, no class weights, no label smoothing, ``N % 8 ==
0`` and ``V % 128 == 0`` go to the fused softmax-cross-entropy kernel
(``ops.kernels.softmax_ce``, whose wrapper picks the CUDA kernel or its
plain version by device); anything else takes the dense float32 path,
the JAX package's own. Soft labels (a distribution over the classes
for each row) take the JAX package's dense soft-label path
(``loss.py:92-101``): ``-sum(label * log_softmax(x))`` in float32.

The others follow Paddle's semantics as the JAX package computes them,
in float32: ``smooth_l1_loss``'s ``delta`` is torch's ``beta``;
``binary_cross_entropy`` clips its input to ``[1e-12, 1 - 1e-7]``;
``log_loss`` adds ``epsilon`` inside both logs; ``kl_div`` takes
``log(max(label, 1e-12))``; ``ctc_loss`` takes ``(T, B, C)`` log
probabilities and runs the alpha recursion in log space over T
(``loss.py:360-433``), not ``F.ctc_loss``: its emissions are one batched
matmul by the one-hot of the blank-interleaved labels, and the last
step of each sequence is picked by a one-hot sum, so its backward sums
in a fixed order on the card (no gather's scatter-add); with
``norm_by_times`` each sequence's loss is divided by its length, and
``"mean"`` divides each by its label length before the mean.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops._base import register
from ...ops.activation import softmax
from ...ops.kernels.softmax_ce import softmax_cross_entropy
from ...ops.manipulation import unsqueeze

__all__ = [
    "cross_entropy", "fused_ce_ok", "softmax_with_cross_entropy",
    "nll_loss", "kl_div", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "mse_loss", "l1_loss",
    "smooth_l1_loss", "margin_ranking_loss", "cosine_embedding_loss",
    "ctc_loss", "square_error_cost", "log_loss", "sigmoid_focal_loss",
    "hinge_embedding_loss", "triplet_margin_loss", "npair_loss"]

NEG = -1e30     # the CTC recursion's log 0


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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Fluid's form: the per-example loss with a trailing axis of 1 kept
    (and the softmax with ``return_softmax``)."""
    loss = unsqueeze(cross_entropy(logits, label, soft_label=soft_label,
                                   ignore_index=ignore_index,
                                   reduction="none", axis=axis), axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def _weighted_mean(loss, w):
    return loss.sum() / w.sum().clamp_min(1e-12)


@register("nll_loss", inputs=("logp", "label", "weight"))
def _nll(logp, label, weight, *, ignore_index, reduction):
    label = label.long()
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    lp = logp.float().movedim(1, -1) if logp.dim() > 2 else logp.float()
    picked = lp.gather(-1, safe[..., None])[..., 0]
    w = weight.float()[safe] if weight is not None else \
        torch.ones_like(picked)
    w = torch.where(valid, w, torch.zeros_like(w))
    loss = -picked * w
    if reduction == "mean":
        return _weighted_mean(loss, w)
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean"):
    """Negative log-likelihood of log probabilities ``input`` (N, C, ...)
    at ``label``; ``mean`` divides by the labels' summed weights."""
    return _nll(input, label, weight, ignore_index=int(ignore_index),
                reduction=reduction)


@register("kl_div", inputs=("logp", "target"))
def _kl_div(logp, target, *, reduction):
    t = target.float()
    loss = t * (torch.log(t.clamp_min(1e-12)) - logp.float())
    if reduction == "batchmean":
        return loss.sum() / logp.shape[0]
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean"):
    """``label * (log label - input)`` with ``input`` log probabilities;
    ``reduction`` also ``batchmean``."""
    return _kl_div(input, label, reduction=reduction)


@register("mse_loss", inputs=("x", "y"))
def _mse(x, y, *, reduction):
    d = x.float() - y.float()
    return _reduce(d * d, reduction)


def mse_loss(input, label, reduction="mean"):
    return _mse(input, label, reduction=reduction)


@register("l1_loss", inputs=("x", "y"))
def _l1(x, y, *, reduction):
    return _reduce(torch.abs(x.float() - y.float()), reduction)


def l1_loss(input, label, reduction="mean"):
    return _l1(input, label, reduction=reduction)


@register("smooth_l1_loss", inputs=("x", "y"))
def _smooth_l1(x, y, *, reduction, delta):
    d = x.float() - y.float()
    ad = torch.abs(d)
    return _reduce(torch.where(ad < delta, 0.5 * d * d / delta,
                               ad - 0.5 * delta), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    """Huber loss: ``0.5 d^2 / delta`` below ``delta``, ``|d| - delta /
    2`` above (``delta`` is torch's ``beta``)."""
    return _smooth_l1(input, label, reduction=reduction, delta=float(delta))


@register("square_error_cost", inputs=("x", "y"))
def square_error_cost(input, label):
    """``(input - label) ** 2``, elementwise, in the inputs' type."""
    d = input - label
    return d * d


@register("log_loss", inputs=("x", "y"))
def _log_loss(x, y, *, epsilon):
    xf = x.float()
    return -y * torch.log(xf + epsilon) - (1.0 - y) * torch.log(
        1.0 - xf + epsilon)


def log_loss(input, label, epsilon=1e-4):
    """``-y log(x + eps) - (1 - y) log(1 - x + eps)``, elementwise."""
    return _log_loss(input, label, epsilon=float(epsilon))


@register("bce", inputs=("x", "y", "w"))
def _bce(x, y, w, *, reduction):
    xf = x.float().clamp(1e-12, 1.0 - 1e-7)
    loss = -(y * torch.log(xf) + (1.0 - y) * torch.log(1.0 - xf))
    if w is not None:
        loss = loss * w.float()
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    """BCE of probabilities ``input`` (clipped to ``[1e-12, 1 -
    1e-7]``)."""
    return _bce(input, label, weight, reduction=reduction)


@register("bce_logits", inputs=("x", "y", "w", "pos_w"))
def _bce_logits(x, y, w, pos_w, *, reduction):
    xf, yf = x.float(), y.float()
    pos = yf * F.logsigmoid(xf)
    if pos_w is not None:
        pos = pos_w * pos
    loss = -(pos + (1.0 - yf) * F.logsigmoid(-xf))
    if w is not None:
        loss = loss * w.float()
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """BCE of ``sigmoid(logit)`` through ``log_sigmoid``; ``pos_weight``
    scales the positive term."""
    return _bce_logits(logit, label, weight, pos_weight, reduction=reduction)


@register("sigmoid_focal_loss", inputs=("x", "y", "norm"))
def _focal(x, y, norm, *, alpha, gamma, reduction):
    xf, yf = x.float(), y.float()
    p = torch.sigmoid(xf)
    ce = -(yf * F.logsigmoid(xf) + (1.0 - yf) * F.logsigmoid(-xf))
    p_t = p * yf + (1.0 - p) * (1.0 - yf)
    a_t = alpha * yf + (1.0 - alpha) * (1.0 - yf)
    loss = a_t * ((1.0 - p_t) ** gamma) * ce
    if norm is not None:
        loss = loss / norm
    return _reduce(loss, reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum"):
    return _focal(logit, label, normalizer, alpha=float(alpha),
                  gamma=float(gamma), reduction=reduction)


@register("margin_ranking_loss", inputs=("x", "y", "label"))
def _margin_rank(x, y, label, *, margin, reduction):
    return _reduce(torch.clamp_min(-label * (x - y) + margin, 0.0),
                   reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    """``max(0, -label (input - other) + margin)``."""
    return _margin_rank(input, other, label, margin=float(margin),
                        reduction=reduction)


@register("cosine_embedding_loss", inputs=("x1", "x2", "label"))
def _cos_embed(x1, x2, label, *, margin, reduction):
    dot = (x1 * x2).sum(dim=-1)
    n1 = torch.sqrt((x1 * x1).sum(dim=-1).clamp_min(1e-12))
    n2 = torch.sqrt((x2 * x2).sum(dim=-1).clamp_min(1e-12))
    cos = dot / (n1 * n2)
    return _reduce(torch.where(label > 0, 1.0 - cos,
                               torch.clamp_min(cos - margin, 0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    """``1 - cos`` for a positive ``label``, else ``max(0, cos -
    margin)``."""
    return _cos_embed(input1, input2, label, margin=float(margin),
                      reduction=reduction)


@register("hinge_embedding_loss", inputs=("x", "label"))
def _hinge_embed(x, label, *, margin, reduction):
    return _reduce(torch.where(label > 0, x,
                               torch.clamp_min(margin - x, 0.0)), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    """``input`` for a positive ``label``, else ``max(0, margin -
    input)``."""
    return _hinge_embed(input, label, margin=float(margin),
                        reduction=reduction)


@register("triplet_margin_loss", inputs=("a", "p", "n"))
def _triplet(a, p, n, *, margin, p_norm, epsilon, swap, reduction):
    def dist(u, v):
        return (torch.abs(u - v + epsilon) ** p_norm).sum(dim=-1) ** (
            1.0 / p_norm)

    d_an = dist(a, n)
    if swap:
        d_an = torch.minimum(d_an, dist(p, n))
    return _reduce(torch.clamp_min(dist(a, p) - d_an + margin, 0.0),
                   reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    """``max(0, d(a, p) - d(a, n) + margin)``, ``d`` the ``p``-norm of
    ``u - v + epsilon``; ``swap`` takes the smaller of ``d(a, n)`` and
    ``d(p, n)``."""
    return _triplet(input, positive, negative, margin=float(margin),
                    p_norm=float(p), epsilon=float(epsilon),
                    swap=bool(swap), reduction=reduction)


@register("npair_loss", inputs=("anchor", "positive", "labels"))
def _npair(anchor, positive, labels, *, l2_reg):
    sim = anchor @ positive.t()
    lab = labels.reshape(-1)
    target = (lab[:, None] == lab[None, :]).float()
    target = target / target.sum(dim=1, keepdim=True)
    ce = -(target * torch.log_softmax(sim, 1)).sum(dim=1).mean()
    reg = l2_reg * ((anchor * anchor).sum(dim=1).mean()
                    + (positive * positive).sum(dim=1).mean()) * 0.25
    return ce + reg


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """N-pair loss: softmax cross-entropy of ``anchor @ positive.T``
    against the same-label rows, plus ``l2_reg / 4`` of the mean squared
    norms."""
    return _npair(anchor, positive, labels, l2_reg=float(l2_reg))


@register("ctc_loss", inputs=("log_probs", "labels", "input_lengths",
                              "label_lengths"))
def _ctc(log_probs, labels, input_lengths, label_lengths, *, blank,
         reduction, norm_by_times):
    T, B, C = log_probs.shape
    S = labels.shape[1]
    dev = log_probs.device
    lp = log_probs.float()
    # the labels with a blank before, between and after them: (B, 2S + 1)
    ext = torch.full((B, 2 * S + 1), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    ext_len = 2 * label_lengths.long() + 1
    same2 = torch.cat([torch.ones(B, 2, dtype=torch.bool, device=dev),
                       ext[:, 2:] == ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & ~same2
    # emit[b, t, s] = lp[t, b, ext[b, s]]: a product with one nonzero term
    onehot = F.one_hot(ext, C).to(lp.dtype)
    emit = torch.bmm(lp.transpose(0, 1), onehot.transpose(1, 2))
    pos = torch.arange(2 * S + 1, device=dev)
    alpha = torch.where((pos == 0) | ((pos == 1) & (ext_len > 1)[:, None]),
                        emit[:, 0], NEG)
    alphas = [alpha]
    neg = torch.full((B, 2), NEG, dtype=lp.dtype, device=dev)
    for t in range(1, T):
        shift1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        shift2 = torch.where(can_skip, torch.cat([neg, alpha[:, :-2]],
                                                 dim=1), NEG)
        alpha = torch.logaddexp(torch.logaddexp(alpha, shift1),
                                shift2) + emit[:, t]
        alphas.append(alpha)
    # each sequence's alphas at its last step, picked by a one-hot sum
    t_idx = (input_lengths.long() - 1).clamp(0, T - 1)
    at_end = (torch.arange(T, device=dev)[:, None] == t_idx[None]).to(
        lp.dtype)
    final = (torch.stack(alphas) * at_end[..., None]).sum(dim=0)
    last = final.gather(1, (ext_len - 1)[:, None])[:, 0]
    last2 = final.gather(1, (ext_len - 2).clamp_min(0)[:, None])[:, 0]
    loss = -torch.logaddexp(last, torch.where(ext_len > 1, last2, NEG))
    if norm_by_times:
        loss = loss / input_lengths.float().clamp_min(1.0)
    if reduction == "mean":
        return (loss / label_lengths.float().clamp_min(1.0)).mean()
    return _reduce(loss, reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC of ``log_probs`` (T, B, C; log-softmax scores) against
    ``labels`` (B, S), each sequence ``input_lengths[b]`` steps and
    ``label_lengths[b]`` labels long."""
    return _ctc(log_probs, labels, input_lengths, label_lengths,
                blank=int(blank), reduction=reduction,
                norm_by_times=bool(norm_by_times))
