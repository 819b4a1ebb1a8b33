"""paddle_tpu_torch.nn: the layers, functional ops and initializers of the
ported training path (the GPT train step), under the JAX package's
names."""
from . import functional, initializer
from .layers import Dropout, Embedding, LayerNorm, Linear

__all__ = ["functional", "initializer", "Linear", "Dropout", "Embedding",
           "LayerNorm"]
