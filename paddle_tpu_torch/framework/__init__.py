"""paddle_tpu_torch.framework: ``TrainStep``, a training step as one CUDA
graph, ``ProgramCache``, an inference program as one, and ``to_static``
(``jit``), a Layer's forward or a function as one a signature;
``save``/``load``, crash-safe training checkpoints, inference bundles
and the program-level variable I/O (``io``); ``recompute``, gradient
checkpointing."""
from . import io
from .io import (AsyncCheckpoint, CheckpointError, load, load_checkpoint,
                 load_inference_model, save, save_checkpoint,
                 save_inference_model, set_state_dict, verify_checkpoint,
                 wait_checkpoints)
from .jit import ProgramCache, StaticFunction, TrainStep, no_jit, to_static
from .recompute import Recompute, recompute

__all__ = ["TrainStep", "ProgramCache", "StaticFunction", "to_static",
           "no_jit", "io", "save", "load", "set_state_dict",
           "save_checkpoint", "load_checkpoint", "verify_checkpoint",
           "AsyncCheckpoint", "wait_checkpoints", "CheckpointError",
           "save_inference_model", "load_inference_model", "recompute",
           "Recompute"]
