"""paddle_tpu_torch.framework: the eager ``TrainStep`` (``jit``)."""
from .jit import TrainStep

__all__ = ["TrainStep"]
