"""paddle_tpu_torch.nn: ``Layer`` and its containers (``layer``), the
layers (every class of the JAX package's ``nn/layers``), functional ops,
initializers and ``ParamAttr``, under the JAX package's names; like the
JAX package's ``nn`` it also binds the gradient clips and the
functional convolutions."""
from . import functional, initializer
from .functional import conv2d, conv2d_transpose, conv3d, conv3d_transpose
from .layer import Layer, LayerDict, LayerList, ParameterList, Sequential
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers
from .param_attr import ParamAttr, WeightNormParamAttr
from ..optim.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                          ClipGradByValue)

functional_api = functional

__all__ = ["functional", "functional_api", "initializer", "ParamAttr",
           "WeightNormParamAttr", "Layer", "Sequential", "LayerList",
           "ParameterList", "LayerDict", "conv2d", "conv2d_transpose",
           "conv3d", "conv3d_transpose", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm", *_layers]
