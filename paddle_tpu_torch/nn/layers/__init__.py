"""paddle_tpu_torch.nn.layers: the layers of the ported training path."""
from .common import Dropout, Embedding, Linear
from .norm import LayerNorm

__all__ = ["Linear", "Dropout", "Embedding", "LayerNorm"]
