"""paddle_tpu_torch.optim: ``Adam``, ``AdamW``, ``ClipGradByGlobalNorm``
and the ``L1Decay``/``L2Decay`` regularizers, with the JAX package's
update rules."""
from .clip import ClipGradByGlobalNorm
from .optimizer import Adam, AdamW, Optimizer
from .regularizer import L1Decay, L2Decay

__all__ = ["Optimizer", "Adam", "AdamW", "ClipGradByGlobalNorm", "L1Decay",
           "L2Decay"]
