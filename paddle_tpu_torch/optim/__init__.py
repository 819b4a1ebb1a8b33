"""paddle_tpu_torch.optim: the optimizers and their wrappers, the
gradient clips, the ``L1Decay``/``L2Decay`` regularizers and the
learning-rate schedulers (``optim.lr``), with the JAX package's update
rules, and the fluid-era ``*Optimizer`` names."""
from . import lr
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        DecayedAdagrad, DGCMomentum, Dpsgd,
                        ExponentialMovingAverage, Ftrl, Lamb, LarsMomentum,
                        LookAhead, ModelAverage, Momentum, Optimizer,
                        PipelineOptimizer, RecomputeOptimizer, RMSProp)
from .regularizer import L1Decay, L2Decay

# fluid-era *Optimizer names (paddle_tpu/optim/__init__.py:13-27)
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdagradOptimizer = Adagrad
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl
LambOptimizer = Lamb
DecayedAdagradOptimizer = DecayedAdagrad
DpsgdOptimizer = Dpsgd
LarsMomentumOptimizer = LarsMomentum
DGCMomentumOptimizer = DGCMomentum
LookaheadOptimizer = LookAhead

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta",
           "RMSProp", "Adam", "AdamW", "Adamax", "Lamb", "Ftrl",
           "ExponentialMovingAverage", "LookAhead", "DecayedAdagrad",
           "Dpsgd", "LarsMomentum", "DGCMomentum", "ModelAverage",
           "RecomputeOptimizer", "PipelineOptimizer",
           "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer",
           "AdamOptimizer", "AdamaxOptimizer", "AdadeltaOptimizer",
           "RMSPropOptimizer", "FtrlOptimizer", "LambOptimizer",
           "DecayedAdagradOptimizer", "DpsgdOptimizer",
           "LarsMomentumOptimizer", "DGCMomentumOptimizer",
           "LookaheadOptimizer",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "L1Decay", "L2Decay", "lr"]
