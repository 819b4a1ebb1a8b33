"""paddle_tpu_torch.dist: the tensor-parallel layers GPT builds, in their
single-device form (``tp_layers``).

The module also calls as the tensor API's ``dist`` (``ops.linalg.dist``,
the p-norm of ``x - y``): Paddle scripts write ``paddle.dist(x, y)``,
and the JAX package binds that name to the op (``paddle_tpu/__init__.py``
rebinds it after importing its own ``dist`` package)."""
import sys
import types

from .tp_layers import (ColumnParallelLinear, RowParallelLinear,
                        VocabParallelEmbedding)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]


class _CallableModule(types.ModuleType):
    def __call__(self, x, y, p=2.0, name=None):
        from ..ops.linalg import dist

        return dist(x, y, p)


sys.modules[__name__].__class__ = _CallableModule
