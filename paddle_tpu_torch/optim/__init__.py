"""paddle_tpu_torch.optim: the optimizers, the gradient clips, the
``L1Decay``/``L2Decay`` regularizers and the learning-rate schedulers
(``optim.lr``), with the JAX package's update rules."""
from . import lr
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        Momentum, Optimizer, RMSProp)
from .regularizer import L1Decay, L2Decay

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta",
           "RMSProp", "Adam", "AdamW", "Adamax", "Lamb",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "L1Decay", "L2Decay", "lr"]
