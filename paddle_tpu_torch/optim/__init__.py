"""paddle_tpu_torch.optim: ``Adam``, ``AdamW`` and ``ClipGradByGlobalNorm``
with the JAX package's update rules."""
from .clip import ClipGradByGlobalNorm
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Optimizer", "Adam", "AdamW", "ClipGradByGlobalNorm"]
