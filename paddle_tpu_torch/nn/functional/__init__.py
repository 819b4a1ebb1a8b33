"""paddle_tpu_torch.nn.functional: the functional ops of the ported
training paths, under the JAX package's names."""
from ...ops.activation import gelu, relu, tanh
from ...ops.conv import adaptive_avg_pool2d, conv2d, max_pool2d
from ...ops.norm_ops import batch_norm, layer_norm
from ...ops.random_ops import dropout
from .attention import sdpa_bhld
from .common import embedding, linear
from .loss import cross_entropy

__all__ = ["linear", "embedding", "gelu", "relu", "tanh", "dropout",
           "layer_norm", "batch_norm", "conv2d", "max_pool2d",
           "adaptive_avg_pool2d", "cross_entropy", "sdpa_bhld"]
