"""AMP op lists: the counterpart of ``paddle_tpu/amp/lists.py`` (ref:
``python/paddle/fluid/contrib/mixed_precision/fp16_lists.py:20``
``AutoMixedPrecisionLists``), written out here: the port imports nothing
of the JAX package.

White: ops that are fast and safe in half precision (matrix products,
convolutions, attention). Black: numerically sensitive ops kept in
float32 (softmax, log, reductions, normalisation statistics). Every
other op runs in whatever type its inputs arrive in (the reference's
gray list: type promotion decides). The names are the registered op
names of ``ops._base.register``, the JAX package's dispatch names.
"""
from __future__ import annotations

__all__ = ["WHITE_LIST", "BLACK_LIST", "AutoMixedPrecisionLists"]

WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "dot", "linear",
    "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
    "sdpa",
}

BLACK_LIST = {
    "softmax", "log_softmax", "logsumexp",
    "cross_entropy_hard", "cross_entropy_soft", "nll_loss", "kl_div",
    "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "exp", "log", "log2", "log10", "log1p", "pow", "rsqrt",
    "mean", "sum", "prod", "std", "var",
    "layer_norm", "layer_norm_noaffine", "batch_norm", "group_norm",
    "instance_norm", "norm", "cosine_similarity", "erf", "softplus",
    "sigmoid_focal_loss", "ctc_loss",
}


class AutoMixedPrecisionLists:
    """The resolved white and black sets after the user's lists: an op in
    ``custom_white_list`` moves to the white set, one in
    ``custom_black_list`` to the black set; an op in both raises
    ``ValueError``."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(WHITE_LIST)
        self.black_list = set(BLACK_LIST)
        both = set(custom_white_list or ()) & set(custom_black_list or ())
        if both:
            raise ValueError(f"ops {sorted(both)} in both custom lists")
        for op in custom_white_list or ():
            self.black_list.discard(op)
            self.white_list.add(op)
        for op in custom_black_list or ():
            self.white_list.discard(op)
            self.black_list.add(op)
