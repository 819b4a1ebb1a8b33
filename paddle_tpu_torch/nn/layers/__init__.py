"""paddle_tpu_torch.nn.layers: the layers of the ported training paths."""
from .common import Dropout, Embedding, Linear, create_parameter
from .norm import LayerNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Linear", "Dropout", "Embedding", "LayerNorm",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "create_parameter"]
