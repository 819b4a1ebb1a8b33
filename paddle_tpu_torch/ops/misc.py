"""Fluid's long-tail ops, the counterparts of ``paddle_tpu/ops/misc.py``'s
(``:39-587``): the similarity, ranking and distillation losses
(``cos_sim``, ``dice_loss``, ``huber_loss``, ``rank_loss``,
``margin_rank_loss``, ``bpr_loss``, ``center_loss``,
``teacher_student_sigmoid_loss``, ``fsp_matrix``), ``mean_iou``, the
tensor utilities (``multiplex``, ``crop_tensor``, ``unstack``,
``bilinear_tensor_product``, ``add_position_encoding``,
``temporal_shift``, ``affine_channel``, ``clip_by_norm``, ``brelu``,
``soft_relu``, ``unique_with_counts``, ``hash``, ``similarity_focus``,
``polygon_box_transform``, ``tree_conv``), the decode helpers
(``gather_tree``, ``sampling_id``, ``ctc_greedy_decoder``), and
``dequantize_weight``, an int8 inference bundle's weight as its consumer
reads it (``framework.io.load_inference_model`` prepends one such op for
each int8 weight).

The JAX package computes each in jnp, outside any Pallas kernel; here
each is PyTorch's operators, with the JAX package's arithmetic in its
order. Where the JAX package's rules and torch's part, the JAX ones are
kept:

- a one-hot of a label outside ``[0, C)`` is all zeros (``jax.nn
  .one_hot``; ``F.one_hot`` raises);
- ``crop_tensor``'s offsets are clamped so that the crop lies inside
  ``x`` (``lax.dynamic_slice``);
- ``mean_iou``'s confusion counts drop a pair outside ``[0, C)`` after a
  negative id is counted from the end (``.at[].add(mode="drop")``);
- ``hash`` is the JAX package's multiplicative hash in uint32 arithmetic
  (wrapping), computed here in int64 with each product taken modulo
  2^32 in two 16-bit halves, so that it gives the reference's integers
  (it is not Paddle's xxhash).

The scatter-adds (``center_loss``'s centre update, ``tree_conv``'s
adjacency) add with ``index_put_`` in PyTorch's deterministic mode
(``_args.deterministic``), as the gathers' backwards do. Integer outputs
are int64 (Paddle's type; the JAX package's are int32). ``sampling_id``
draws from an explicit ``torch.Generator``: the device's
(``core.random.default_generator``) or, for ``seed`` not 0, one seeded
with it; it cannot match the JAX key stream bit for bit, only its
distribution. ``ctc_greedy_decoder`` decodes on the host, as the JAX
package does, and returns tensors on the input's device.

``dequantize_weight`` leaves no room for XLA's fusion of the multiply
into the consuming matmul or conv: PyTorch's cast and multiply write the
weight's float copy before the consumer reads it (PERF.md §7: the port's
int8 path moves no fewer weight bytes than the float32 one).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.random import default_generator
from ._args import deterministic, torch_dtype
from ._base import register

__all__ = [
    "cos_sim", "dice_loss", "huber_loss", "rank_loss",
    "margin_rank_loss", "bpr_loss", "center_loss",
    "teacher_student_sigmoid_loss", "mean_iou", "multiplex",
    "crop_tensor", "unstack", "bilinear_tensor_product",
    "add_position_encoding", "temporal_shift", "affine_channel",
    "gather_tree", "sampling_id", "ctc_greedy_decoder", "fsp_matrix",
    "clip_by_norm", "brelu", "soft_relu",
    "unique_with_counts", "hash", "similarity_focus",
    "polygon_box_transform", "tree_conv", "dequantize_weight",
]


def _one_hot(label, n, dtype):
    """``jax.nn.one_hot``: a label outside ``[0, n)`` gives zeros."""
    return (label[..., None] == torch.arange(n, device=label.device)).to(
        dtype)


def _bce_with_logits(z, target):
    """``paddle_tpu/ops/_base.py:34-40``'s stable sigmoid cross-entropy."""
    return (torch.clamp_min(z, 0) - z * target
            + torch.log1p(torch.exp(-torch.abs(z))))


def _act(out, act):
    if act is None:
        return out
    from ..nn import functional as NF

    return getattr(NF, act)(out)


# -- similarity / ranking / distillation losses -------------------------------


@register("cos_sim", inputs=("x", "y"))
def _cos_sim(x, y):
    xn = torch.sqrt((x * x).sum(-1, keepdim=True))
    yn = torch.sqrt((y * y).sum(-1, keepdim=True))
    dot = (x * y).sum(-1, keepdim=True)
    return dot / torch.clamp_min(xn * yn, 1e-12)


def cos_sim(X, Y):
    """Row-wise cosine similarity of ``X`` and ``Y`` (N, D): (N, 1)."""
    return _cos_sim(X, Y)


@register("dice_loss", inputs=("x", "label"))
def _dice_loss(x, label, *, epsilon):
    lab = _one_hot(label[..., 0], x.shape[-1], x.dtype)
    red = tuple(range(1, x.dim()))
    inter = (x * lab).sum(red)
    union = x.sum(red) + lab.sum(red)
    return 1.0 - (2.0 * inter + epsilon) / (union + epsilon)


def dice_loss(input, label, epsilon=1e-5):
    """Dice loss of probabilities ``input`` (N, ..., C) against integer
    ``label`` (N, ..., 1): (N,)."""
    return _dice_loss(input, label, epsilon=float(epsilon))


@register("huber_loss", inputs=("x", "y"))
def _huber_loss(x, y, *, delta):
    r = torch.abs(x - y)
    return torch.where(r <= delta, 0.5 * r * r, delta * (r - 0.5 * delta))


def huber_loss(input, label, delta=1.0):
    """Elementwise Huber loss: ``r² / 2`` for ``r = |x - y| <= delta``,
    else ``delta (r - delta / 2)``."""
    return _huber_loss(input, label, delta=float(delta))


@register("rank_loss", inputs=("label", "left", "right"))
def _rank_loss(label, left, right):
    return _bce_with_logits(left - right, label)


def rank_loss(label, left, right):
    """RankNet's pairwise loss: the sigmoid cross-entropy of ``left -
    right`` against ``label``, P(left > right)."""
    return _rank_loss(label, left, right)


@register("margin_rank_loss", inputs=("label", "left", "right"))
def _margin_rank_loss(label, left, right, *, margin):
    return torch.clamp_min(-label * (left - right) + margin, 0.0)


def margin_rank_loss(label, left, right, margin=0.1):
    """``max(0, -label (left - right) + margin)``, ``label`` in {1, -1}."""
    return _margin_rank_loss(label, left, right, margin=float(margin))


@register("bpr_loss", inputs=("x", "label"))
def _bpr_loss(x, label):
    C = x.shape[1]
    pos = torch.gather(x, 1, label.long())
    lsm = F.logsigmoid(pos - x)
    mask = _one_hot(label[:, 0], C, x.dtype)
    return -(lsm * (1 - mask)).sum(-1, keepdim=True) / (C - 1)


def bpr_loss(input, label):
    """Bayesian personalised ranking of logits ``input`` (N, C) with the
    positive class ``label`` (N, 1): ``-mean_j log sigmoid(x[label] -
    x[j])`` over the other classes, (N, 1)."""
    return _bpr_loss(input, label)


@register("center_loss", inputs=("x", "label", "centers"))
def _center_loss(x, label, centers, *, alpha, update_center):
    lab = label.reshape(-1).long()
    c = centers[lab]
    loss = 0.5 * ((x - c) ** 2).sum(-1, keepdim=True)
    if not update_center:
        return loss, centers
    counts = torch.zeros(centers.shape[0], dtype=x.dtype, device=x.device)
    with deterministic():
        counts = counts.index_put((lab,), torch.ones_like(lab, dtype=x.dtype),
                                  accumulate=True)
        delta = torch.zeros_like(centers).index_put((lab,), c - x,
                                                    accumulate=True)
    return loss, centers - alpha * delta / (counts[:, None] + 1.0)


def center_loss(input, label, num_classes=None, alpha=0.5, centers=None,
                update_center=True, param_attr=None):
    """Center loss of features ``input`` (N, D) against ``centers``
    (num_classes, D): ``(loss (N, 1), new centres)``. With
    ``update_center`` each class's centre moves toward its samples,
    ``c - alpha sum(c - x) / (count + 1)``, in a new tensor (the
    reference's functional form: the caller keeps the centres); without
    it ``centers`` come back as they are. Without ``centers`` it raises
    ``ValueError``."""
    if centers is None:
        raise ValueError("pass centers=(num_classes, D)")
    return _center_loss(input, label, centers, alpha=float(alpha),
                        update_center=bool(update_center))


@register("ts_sigmoid_loss", inputs=("x", "label"))
def _ts_sigmoid_loss(x, label, *, soft_max_up_bound, soft_max_lower_bound):
    z = torch.clamp(x, soft_max_lower_bound, soft_max_up_bound)
    hard = (label > 0.5).to(x.dtype)
    return _bce_with_logits(z, hard) + _bce_with_logits(z, label)


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """The sigmoid cross-entropy of the clipped logit against the hard
    label (``label > 0.5``) plus that against the soft one."""
    return _ts_sigmoid_loss(input, label,
                            soft_max_up_bound=float(soft_max_up_bound),
                            soft_max_lower_bound=float(soft_max_lower_bound))


@register("fsp_matrix", inputs=("x", "y"))
def _fsp_matrix(x, y):
    return torch.einsum("bchw,bdhw->bcd", x, y) / (x.shape[2] * x.shape[3])


def fsp_matrix(x, y):
    """The flow-of-solution-procedure matrix of ``x`` (B, Cx, H, W) and
    ``y`` (B, Cy, H, W): (B, Cx, Cy)."""
    return _fsp_matrix(x, y)


# -- metrics ------------------------------------------------------------------


@register("mean_iou", inputs=("pred", "label"))
def _mean_iou(pred, label, *, num_classes):
    K = num_classes
    p, lab = pred.reshape(-1).long(), label.reshape(-1).long()
    p, lab = torch.where(p < 0, p + K, p), torch.where(lab < 0, lab + K, lab)
    keep = (p >= 0) & (p < K) & (lab >= 0) & (lab < K)
    conf = torch.bincount((lab * K + p)[keep], minlength=K * K).reshape(
        K, K).float()
    inter = torch.diagonal(conf)
    union = conf.sum(0) + conf.sum(1) - inter
    present = union > 0
    iou = torch.where(present, inter / torch.clamp_min(union, 1.0), 0.0)
    miou = iou.sum() / torch.clamp_min(present.sum(), 1)
    return miou, (conf.sum(1) - inter).long(), inter.long()


def mean_iou(input, label, num_classes):
    """Mean IoU of predicted segment ids ``input`` against ``label``:
    ``(mean IoU, wrong (C,), correct (C,))``, the IoU averaged over the
    classes that occur in either."""
    return _mean_iou(input, label, num_classes=int(num_classes))


# -- tensor utilities ---------------------------------------------------------


@register("multiplex", inputs=("index", "xs"))
def _multiplex(index, *xs):
    stacked = torch.stack(xs, 0)
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


def multiplex(inputs, index):
    """Row ``i`` of ``inputs[index[i]]``: a row-wise choice among K inputs
    of one shape by ``index`` (N, 1)."""
    return _multiplex(index, *inputs)


@register("crop_tensor", inputs=("x",))
def _crop_tensor(x, *, offsets, shape):
    for axis, (o, n) in enumerate(zip(offsets, shape)):
        # lax.dynamic_slice clamps the start into [0, dim - n]
        x = x.narrow(axis, min(max(o, 0), x.shape[axis] - n), n)
    return x


def crop_tensor(x, shape=None, offsets=None):
    """The block of ``x`` of ``shape`` at ``offsets`` (0s by default); a
    -1 or ``None`` in ``shape`` runs to the axis's end."""
    if offsets is None:
        offsets = [0] * x.dim()
    shape = [x.shape[i] - int(offsets[i]) if s in (-1, None) else int(s)
             for i, s in enumerate(shape)]
    return _crop_tensor(x, offsets=tuple(int(o) for o in offsets),
                        shape=tuple(shape))


def unstack(x, axis=0, num=None):
    """``x``'s slices along ``axis``, that axis dropped; ``num`` must be
    its size when given."""
    from .manipulation import split, squeeze

    n = x.shape[axis]
    if num is not None and num != n:
        raise ValueError(f"num={num} != dim size {n}")
    return [squeeze(p, axis=axis) for p in split(x, n, axis=axis)]


@register("bilinear_tensor_product", inputs=("x", "y", "w", "b"))
def _bilinear_tensor_product(x, y, w, b):
    out = torch.einsum("nd,kde,ne->nk", x, w, y)
    return out if b is None else out + b


def bilinear_tensor_product(x, y, size=None, weight=None, bias=None,
                            act=None, param_attr=None, bias_attr=None):
    """``out[n, k] = x[n] W[k] y[n] (+ bias[k])`` for ``weight`` (size,
    Dx, Dy), then ``act`` (a ``nn.functional`` name); without ``weight``
    it raises ``ValueError``."""
    if weight is None:
        raise ValueError("pass weight=(size, x_dim, y_dim)")
    return _act(_bilinear_tensor_product(x, y, weight, bias), act)


@register("add_position_encoding", inputs=("x",))
def _add_position_encoding(x, *, alpha, beta):
    _, L, D = x.shape
    half = D // 2
    kw = dict(dtype=torch.float32, device=x.device)
    pos = torch.arange(L, **kw)[:, None]
    inv = torch.pow(10000.0, -torch.arange(half, **kw) / max(half, 1))
    angles = pos * inv[None, :]
    enc = torch.cat([torch.sin(angles), torch.cos(angles)], dim=1)
    if enc.shape[1] < D:
        enc = F.pad(enc, (0, D - enc.shape[1]))
    return alpha * x + beta * enc[None].to(x.dtype)


def add_position_encoding(input, alpha=1.0, beta=1.0):
    """``alpha x + beta PE`` for ``input`` (B, L, D), PE the sinusoid
    table (sines in the first half of D, cosines in the second)."""
    return _add_position_encoding(input, alpha=float(alpha),
                                  beta=float(beta))


@register("temporal_shift", inputs=("x",))
def _temporal_shift(x, *, seg_num, shift_ratio):
    NT, C, H, W = x.shape
    v = x.reshape(NT // seg_num, seg_num, C, H, W)
    fold = int(C * shift_ratio)
    back, fwd = v[:, :, :fold], v[:, :, fold:2 * fold]
    # a roll by one step with the step that wraps around set to 0
    back = torch.cat([torch.zeros_like(back[:, :1]), back[:, :-1]], dim=1)
    fwd = torch.cat([fwd[:, 1:], torch.zeros_like(fwd[:, :1])], dim=1)
    return torch.cat([back, fwd, v[:, :, 2 * fold:]], dim=2).reshape(
        NT, C, H, W)


def temporal_shift(x, seg_num, shift_ratio=0.25):
    """TSM's shift of ``x`` (N T, C, H, W): the first ``C shift_ratio``
    channels one step later in time, the next as many one step earlier,
    zeros where nothing shifts in."""
    return _temporal_shift(x, seg_num=int(seg_num),
                           shift_ratio=float(shift_ratio))


@register("affine_channel", inputs=("x", "scale", "bias"))
def _affine_channel(x, scale, bias):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.reshape(shape) + bias.reshape(shape)


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", act=None):
    """``x scale + bias`` per channel (axis 1; ``data_layout`` is taken and
    not read, as in the JAX package), then ``act``."""
    return _act(_affine_channel(x, scale, bias), act)


@register("clip_by_norm", inputs=("x",))
def _clip_by_norm(x, *, max_norm):
    norm = torch.sqrt((x * x).sum())
    return torch.where(norm > max_norm, x * (max_norm / norm), x)


def clip_by_norm(x, max_norm):
    """``x`` scaled down to an L2 norm of ``max_norm`` when larger."""
    return _clip_by_norm(x, max_norm=float(max_norm))


@register("brelu", inputs=("x",))
def _brelu(x, *, t_min, t_max):
    return torch.clamp(x, t_min, t_max)


def brelu(x, t_min=0.0, t_max=24.0):
    """``x`` clipped to ``[t_min, t_max]``."""
    return _brelu(x, t_min=float(t_min), t_max=float(t_max))


@register("soft_relu", inputs=("x",))
def _soft_relu(x, *, threshold):
    return torch.log1p(torch.exp(torch.clamp(x, -threshold, threshold)))


def soft_relu(x, threshold=40.0):
    """``log(1 + exp(clip(x, -threshold, threshold)))``."""
    return _soft_relu(x, threshold=float(threshold))


def unique_with_counts(x, dtype="int32"):
    """``x``'s distinct values in ascending order, each element's index
    among them and each value's count (the last two in ``dtype``)."""
    vals, inverse, counts = torch.unique(x.reshape(-1), sorted=True,
                                         return_inverse=True,
                                         return_counts=True)
    dt = torch_dtype(dtype)
    return vals, inverse.to(dt), counts.to(dt)


_U32 = 0xFFFFFFFF


def _mul_u32(a, m):
    """``(a * m) mod 2^32`` for int64 ``a`` and Python int ``m`` in [0,
    2^32): the product taken in two 16-bit halves of ``m``, so that no
    int64 product passes 2^49."""
    lo, hi = m & 0xFFFF, m >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32


@register("hash_op", inputs=("x",))
def _hash(x, *, num_hash, mod_by):
    flat = x.long().reshape(-1, x.shape[-1]) & _U32
    key = torch.zeros(flat.shape[0], dtype=torch.int64, device=x.device)
    for c in range(flat.shape[-1]):
        key = (_mul_u32(key, 1000003) + flat[:, c]) & _U32
    muls = [((i * 2654435761) & _U32) | 1 for i in range(num_hash)]
    acc = torch.stack([_mul_u32(key, m) for m in muls], dim=-1) % mod_by
    return acc.reshape(tuple(x.shape[:-1]) + (num_hash,))


def hash(input, hash_size, num_hash=1):  # noqa: A001 (fluid's name)
    """Each row of integer ids in ``input`` (..., D) to ``num_hash``
    bucket ids in ``[0, hash_size)``: the JAX package's multiplicative
    hash (``misc.py:430-443``)."""
    return _hash(input, num_hash=int(num_hash), mod_by=int(hash_size))


@register("similarity_focus_op", inputs=("x",))
def _similarity_focus(x, *, axis, indices):
    if axis != 1:
        raise NotImplementedError("similarity_focus: axis must be 1 (NCHW)")
    B, _, H, W = x.shape
    mask = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    rows = torch.arange(H, device=x.device)
    cols = torch.arange(W, device=x.device)
    for ind in indices:
        top = torch.argmax(x[:, ind].reshape(B, -1), dim=-1)
        hit = ((rows[None, :, None] == (top // W)[:, None, None])
               | (cols[None, None, :] == (top % W)[:, None, None]))
        mask = torch.maximum(mask, hit[:, None].float().expand_as(mask))
    return mask.to(x.dtype)


def similarity_focus(input, axis, indexes):
    """A {0, 1} mask of ``input``'s (B, C, H, W) shape: for each channel
    of ``indexes`` the row and the column of its largest element (the
    first in row-major order), marked in every channel. Only ``axis`` 1
    is taken, as in the JAX package."""
    return _similarity_focus(input, axis=int(axis),
                             indices=tuple(int(i) for i in indexes))


@register("polygon_box_transform_op", inputs=("x",))
def _polygon_box_transform(x):
    B, C, H, W = x.shape
    cols = torch.arange(W, dtype=x.dtype, device=x.device)[None, None, None]
    rows = torch.arange(H, dtype=x.dtype, device=x.device)[None, None, :,
                                                            None]
    is_x = (torch.arange(C, device=x.device) % 2 == 0)[None, :, None, None]
    base = torch.where(is_x, cols.expand(x.shape), rows.expand(x.shape))
    return 4.0 * base - x


def polygon_box_transform(input):
    """EAST's quad offsets (B, 2 k, H, W) as absolute coordinates: ``4
    col - x`` in the even channels, ``4 row - x`` in the odd ones."""
    return _polygon_box_transform(input)


@register("tree_conv_op", inputs=("nodes", "edges", "W"))
def _tree_conv(nodes, edges, W, *, max_depth):
    B, N, _ = nodes.shape
    dev = nodes.device
    x, Wf = nodes.float(), W.float()
    p, c = edges[..., 0].long(), edges[..., 1].long()
    real = (p != c).float()                  # pad rows repeat a node id
    flat = torch.arange(B, device=dev)[:, None] * N * N + p * N + c
    with deterministic():
        adj = torch.zeros(B * N * N, device=dev).index_put(
            (flat.reshape(-1),), real.reshape(-1), accumulate=True)
    adj = torch.clamp_max(adj.reshape(B, N, N), 1.0)
    parent_of = torch.argmax(adj, dim=1)                     # (B, N)
    sib_cnt = torch.gather(adj.sum(dim=2), 1, parent_of)
    par_rows = torch.gather(adj, 1, parent_of[:, :, None].expand(B, N, N))
    ids = torch.arange(N, device=dev)
    earlier = (ids[None, :] < ids[:, None]).float()
    rank = (par_rows * earlier).sum(dim=2)
    out = torch.zeros(B, N, Wf.shape[2], Wf.shape[3], device=dev)
    reach = torch.eye(N, device=dev).expand(B, N, N)
    ones, zeros = torch.ones(B, N, device=dev), torch.zeros(B, N, device=dev)
    for d in range(max_depth):
        eta_t = (max_depth - 1 - d) / max(max_depth - 1, 1)
        frac = torch.where(sib_cnt > 1,
                           rank / torch.clamp_min(sib_cnt - 1.0, 1.0), 0.5)
        if d == 0:                     # the window's root: all weight on t
            eta = torch.stack([ones, zeros, zeros], dim=2)
        else:
            eta = torch.stack([torch.full((B, N), eta_t, device=dev),
                               (1.0 - eta_t) * (1.0 - frac),
                               (1.0 - eta_t) * frac], dim=2)
        mixed = torch.einsum("bnf,fkom,bnk->bnom", x, Wf, eta)
        out = out + torch.einsum("brn,bnom->brom", reach, mixed)
        reach = reach @ adj
    return out


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              weight=None):
    """TBCNN's tree convolution (``misc.py:502-576``) of ``nodes_vector``
    (B, N, F) over the trees of ``edge_set`` (B, E, 2; (parent, child)
    rows, a pad row repeats one id) by ``weight`` (F, 3, output_size,
    num_filters): each node's window is its subtree to ``max_depth``,
    each member mixing the three filter banks by its depth and place
    among its siblings; (B, N, output_size, num_filters) in float32,
    then ``act``. Without ``weight`` it raises ``ValueError``."""
    if weight is None:
        raise ValueError(
            f"pass weight=({nodes_vector.shape[2]}, 3, {output_size}, "
            f"{num_filters}) — use fluid.dygraph.TreeConv for a "
            "parameter-owning layer")
    return _act(_tree_conv(nodes_vector, edge_set, weight,
                           max_depth=int(max_depth)), act)


# -- decode helpers -----------------------------------------------------------


@register("gather_tree", inputs=("ids", "parents"))
def _gather_tree(ids, parents):
    T, B, K = ids.shape
    beam = torch.arange(K, device=ids.device).expand(B, K)
    toks = []
    for t in range(T - 1, -1, -1):
        toks.append(torch.gather(ids[t], 1, beam))
        beam = torch.gather(parents[t], 1, beam).long()
    return torch.stack(toks[::-1], dim=0)


def gather_tree(ids, parents):
    """Beam search's backtrace of ``ids`` and ``parents`` (T, B, K): every
    (b, k) column followed from the last step through its parents, so
    that it holds one whole sequence."""
    return _gather_tree(ids, parents)


@register("sampling_id", inputs=("probs", "u"))
def _sampling_id(probs, u):
    """The id whose share of the row's cumulative sum first passes ``u``
    (N,) in [0, 1): inverse-CDF sampling."""
    cdf = torch.cumsum(torch.clamp_min(probs.float(), 1e-20), dim=-1)
    below = cdf < (u * cdf[:, -1])[:, None]
    return below.sum(-1).clamp_max(probs.shape[-1] - 1)


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64"):
    """One id a row of probabilities ``x`` (N, C), drawn with each id's
    probability (its entry, at least 1e-20, over the row's sum): int64
    (N,). The uniform draws take the device's generator, or for ``seed``
    not 0 one seeded with it (the same seed draws the same ids); the
    JAX package's ``categorical`` draws from its key stream instead.
    ``min``, ``max`` and ``dtype`` are taken and not read, as in the JAX
    package."""
    g = default_generator(x.device)
    if seed != 0:
        g = torch.Generator(device=x.device).manual_seed(int(seed))
    u = torch.rand(x.shape[0], generator=g, device=x.device)
    return _sampling_id(x, u)


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0):
    """Greedy CTC decoding of ``input`` (B, T, C): the argmax path of each
    sequence (its first ``input_length[b]`` steps), repeats merged and
    ``blank`` dropped, on the host. Returns ``(decoded (B, T) padded with
    padding_value, lengths (B,))``, int64 on ``input``'s device."""
    arr = input.detach().float().cpu().numpy()
    B, T = arr.shape[:2]
    lens = np.full((B,), T) if input_length is None else \
        np.asarray(input_length.detach().cpu() if isinstance(
            input_length, torch.Tensor) else input_length).reshape(-1)
    out = np.full((B, T), padding_value, np.int64)
    out_lens = np.zeros((B,), np.int64)
    for b in range(B):
        prev, k = -1, 0
        for t in arr[b, :lens[b]].argmax(-1):
            if t != prev and t != blank:
                out[b, k] = t
                k += 1
            prev = t
        out_lens[b] = k
    return (torch.from_numpy(out).to(input.device),
            torch.from_numpy(out_lens).to(input.device))


@register("dequantize_weight", inputs=("q", "s"))
def dequantize_weight(q, s, *, dtype="float32"):
    """``q`` (int8) times its scales ``s``, both in ``dtype``."""
    dt = torch_dtype(dtype)
    return q.to(dt) * s.to(dt)

