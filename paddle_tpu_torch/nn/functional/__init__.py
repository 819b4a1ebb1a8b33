"""paddle_tpu_torch.nn.functional: the functional API under the JAX
package's names (``paddle_tpu/nn/functional/__init__.py``): every name
but ``sequence_mask``, which comes with ``ops/sequence.py``."""
from ...ops.activation import (celu, elu, gelu, glu, gumbel_softmax,
                               hardshrink, hardsigmoid, hardswish, hardtanh,
                               leaky_relu, log_sigmoid, log_softmax, maxout,
                               mish, prelu, relu, relu6, selu, sigmoid, silu,
                               softmax, softplus, softshrink, softsign,
                               swish, tanh, tanhshrink, thresholded_relu)
from ...ops.conv import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                         adaptive_max_pool1d, adaptive_max_pool2d,
                         affine_grid, avg_pool1d, avg_pool2d, avg_pool3d,
                         conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                         conv3d, conv3d_transpose, grid_sample, interpolate,
                         max_pool1d, max_pool2d, max_pool3d, pixel_shuffle,
                         unfold, upsample)
from ...ops.manipulation import pad
from ...ops.norm_ops import (batch_norm, group_norm, instance_norm,
                             layer_norm, local_response_norm, normalize)
from ...ops.random_ops import (alpha_dropout, channel_shuffle, dropout,
                               dropout2d, dropout3d)
from .attention import scaled_dot_product_attention, sdpa_bhld
from .common import (bilinear, cosine_similarity, embedding, label_smooth,
                     linear, one_hot, pairwise_distance)
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cosine_embedding_loss, cross_entropy, ctc_loss,
                   hinge_embedding_loss, kl_div, l1_loss, log_loss,
                   margin_ranking_loss, mse_loss, nll_loss, npair_loss,
                   sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost,
                   triplet_margin_loss)

__all__ = [n for n in dir() if not n.startswith("_")]


def _boundaries():
    """Every name here, and in ``attention``, ``common`` and ``loss``, as
    a ``core.tensor.boundary``: Paddle ``Tensor`` arguments reach it as
    plain tensors, and its result is one again."""
    from ...core.tensor import boundary
    from . import attention as _att, common as _com, loss as _loss

    for mod in (_att, _com, _loss):
        for n in mod.__all__:
            v = getattr(mod, n)
            if callable(v) and not isinstance(v, type):
                setattr(mod, n, boundary(v))
    g = globals()
    for n in __all__:
        v = g[n]
        if callable(v) and not isinstance(v, type) and \
                type(v).__name__ != "module":
            g[n] = boundary(v)


_boundaries()
