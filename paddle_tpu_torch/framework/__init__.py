"""paddle_tpu_torch.framework: ``TrainStep``, a training step as one CUDA
graph, and ``ProgramCache``, an inference program as one (``jit``);
``save``/``load``, crash-safe training checkpoints, inference bundles
and the program-level variable I/O (``io``); ``recompute``, gradient
checkpointing."""
from . import io
from .io import (AsyncCheckpoint, CheckpointError, load, load_checkpoint,
                 save, save_checkpoint, set_state_dict, verify_checkpoint,
                 wait_checkpoints)
from .jit import ProgramCache, TrainStep
from .recompute import Recompute, recompute

__all__ = ["TrainStep", "ProgramCache", "io", "save", "load",
           "set_state_dict", "save_checkpoint", "load_checkpoint",
           "verify_checkpoint", "AsyncCheckpoint", "wait_checkpoints",
           "CheckpointError", "recompute", "Recompute"]
