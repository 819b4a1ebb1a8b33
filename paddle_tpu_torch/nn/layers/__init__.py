"""paddle_tpu_torch.nn.layers: the layers of the ported training and
decoding paths."""
from .activation import ReLU
from .common import Dropout, Embedding, Linear, create_parameter
from .conv import Conv2D
from .norm import BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer,
                          static_kv_attention)

__all__ = ["ReLU", "Linear", "Dropout", "Embedding", "LayerNorm", "Conv2D",
           "BatchNorm2D", "MaxPool2D", "AdaptiveAvgPool2D",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "static_kv_attention",
           "create_parameter"]
