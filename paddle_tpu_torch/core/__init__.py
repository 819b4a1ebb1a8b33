"""paddle_tpu_torch.core: the global random state (``core.random``)."""
from .random import default_generator, seed

__all__ = ["seed", "default_generator"]
