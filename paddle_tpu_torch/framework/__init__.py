"""paddle_tpu_torch.framework: ``TrainStep``, a training step as one CUDA
graph, and ``ProgramCache``, an inference program as one (``jit``)."""
from .jit import ProgramCache, TrainStep

__all__ = ["TrainStep", "ProgramCache"]
