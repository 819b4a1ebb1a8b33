"""paddle_tpu_torch.dist: the tensor-parallel layers GPT builds, in their
single-device form (``tp_layers``)."""
from .tp_layers import (ColumnParallelLinear, RowParallelLinear,
                        VocabParallelEmbedding)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]
