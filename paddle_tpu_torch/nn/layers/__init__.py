"""paddle_tpu_torch.nn.layers: the layers of the ported training and
decoding paths."""
from .common import Dropout, Embedding, Linear, create_parameter
from .norm import LayerNorm
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer,
                          static_kv_attention)

__all__ = ["Linear", "Dropout", "Embedding", "LayerNorm",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "static_kv_attention",
           "create_parameter"]
