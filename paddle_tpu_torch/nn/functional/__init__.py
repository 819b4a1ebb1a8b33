"""paddle_tpu_torch.nn.functional: the functional ops of the ported
training paths, under the JAX package's names."""
from ...ops.activation import gelu, relu, tanh
from ...ops.norm_ops import layer_norm
from ...ops.random_ops import dropout
from .attention import sdpa_bhld
from .common import embedding, linear
from .loss import cross_entropy

__all__ = ["linear", "embedding", "gelu", "relu", "tanh", "dropout",
           "layer_norm", "cross_entropy", "sdpa_bhld"]
