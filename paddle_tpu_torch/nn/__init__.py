"""paddle_tpu_torch.nn: the layers (every class of the JAX package's
``nn/layers``), functional ops, initializers and ``ParamAttr``, under the
JAX package's names."""
from torch.nn import Sequential

from . import functional, initializer
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers
from .param_attr import ParamAttr, WeightNormParamAttr

__all__ = ["functional", "initializer", "ParamAttr", "WeightNormParamAttr",
           "Sequential", *_layers]
