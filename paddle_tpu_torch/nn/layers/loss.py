"""Loss layers, the counterparts of ``paddle_tpu/nn/layers/loss.py``'s
13 classes: each holds its options (``weight`` a tensor, not a
parameter) and forwards through the ``functional`` loss of its name."""
from __future__ import annotations

from ..layer import Layer
from .. import functional as F

__all__ = [
    "CrossEntropyLoss", "NLLLoss", "KLDivLoss", "BCELoss", "BCEWithLogitsLoss",
    "MSELoss", "L1Loss", "SmoothL1Loss", "MarginRankingLoss",
    "CosineEmbeddingLoss", "HingeEmbeddingLoss", "TripletMarginLoss",
    "CTCLoss",
]


class _Loss(Layer):
    """Keeps its constructor's keyword options as ``self.opts``."""

    def __init__(self, **opts):
        super().__init__()
        self.opts = opts

    def extra_repr(self):
        return ", ".join(f"{k}={v!r}" for k, v in self.opts.items()
                         if k != "weight")


class CrossEntropyLoss(_Loss):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction, soft_label=soft_label,
                         axis=axis, use_softmax=use_softmax,
                         label_smoothing=label_smoothing)

    def forward(self, input, label):
        return F.cross_entropy(input, label, **self.opts)


class NLLLoss(_Loss):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean"):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction)

    def forward(self, input, label):
        return F.nll_loss(input, label, **self.opts)


class KLDivLoss(_Loss):
    def __init__(self, reduction="mean"):
        super().__init__(reduction=reduction)

    def forward(self, input, label):
        return F.kl_div(input, label, **self.opts)


class BCELoss(_Loss):
    def __init__(self, weight=None, reduction="mean"):
        super().__init__(weight=weight, reduction=reduction)

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, **self.opts)


class BCEWithLogitsLoss(_Loss):
    def __init__(self, weight=None, reduction="mean", pos_weight=None):
        super().__init__(weight=weight, reduction=reduction,
                         pos_weight=pos_weight)

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, **self.opts)


class MSELoss(_Loss):
    def __init__(self, reduction="mean"):
        super().__init__(reduction=reduction)

    def forward(self, input, label):
        return F.mse_loss(input, label, **self.opts)


class L1Loss(_Loss):
    def __init__(self, reduction="mean"):
        super().__init__(reduction=reduction)

    def forward(self, input, label):
        return F.l1_loss(input, label, **self.opts)


class SmoothL1Loss(_Loss):
    def __init__(self, reduction="mean", delta=1.0):
        super().__init__(reduction=reduction, delta=delta)

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, **self.opts)


class MarginRankingLoss(_Loss):
    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__(margin=margin, reduction=reduction)

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, **self.opts)


class CosineEmbeddingLoss(_Loss):
    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__(margin=margin, reduction=reduction)

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, **self.opts)


class HingeEmbeddingLoss(_Loss):
    def __init__(self, margin=1.0, reduction="mean"):
        super().__init__(margin=margin, reduction=reduction)

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, **self.opts)


class TripletMarginLoss(_Loss):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean"):
        super().__init__(margin=margin, p=p, epsilon=epsilon, swap=swap,
                         reduction=reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, **self.opts)


class CTCLoss(_Loss):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__(blank=blank, reduction=reduction)

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          norm_by_times=norm_by_times, **self.opts)
