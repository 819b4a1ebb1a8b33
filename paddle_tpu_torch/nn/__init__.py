"""paddle_tpu_torch.nn: the layers, functional ops, initializers and
``ParamAttr`` of the ported training and decoding paths, under the JAX
package's names."""
from . import functional, initializer
from .layers import (Dropout, Embedding, LayerNorm, Linear,
                     MultiHeadAttention, Transformer, TransformerDecoder,
                     TransformerDecoderLayer, TransformerEncoder,
                     TransformerEncoderLayer)
from .param_attr import ParamAttr

__all__ = ["functional", "initializer", "ParamAttr", "Linear", "Dropout",
           "Embedding", "LayerNorm", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]
