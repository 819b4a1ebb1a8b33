"""paddle_tpu_torch.nn: the layers, functional ops, initializers and
``ParamAttr`` of the ported training and decoding paths, under the JAX
package's names."""
from . import functional, initializer
from torch.nn import Sequential

from .layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                     Embedding, LayerNorm, Linear, MaxPool2D,
                     MultiHeadAttention, ReLU, Transformer,
                     TransformerDecoder, TransformerDecoderLayer,
                     TransformerEncoder, TransformerEncoderLayer)
from .param_attr import ParamAttr, WeightNormParamAttr

__all__ = ["functional", "initializer", "ParamAttr", "WeightNormParamAttr",
           "Sequential", "ReLU",
           "Linear", "Dropout",
           "Embedding", "LayerNorm", "Conv2D", "BatchNorm2D", "MaxPool2D",
           "AdaptiveAvgPool2D", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]
