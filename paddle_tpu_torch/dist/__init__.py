"""paddle_tpu_torch.dist (also ``paddle_tpu_torch.distributed``): data
parallelism over a ``torch.distributed`` process group, one process a
rank — the process environment and the mesh (``env``), the
collectives (``collective``), the launcher (``launch``,
``python -m paddle_tpu_torch.dist.launch``), the cluster model
(``utils``, ``cloud_utils``), ``DataParallel`` and
``DistributedTrainStep`` (``parallel``), the bucketed and int8 gradient
exchange (``gradcomm``), fleet's collective front end (``fleet``), and
the tensor-parallel layers GPT builds in their single-device form
(``tp_layers``).

Not ported (ROADMAP Queue 1, each raising ``NotImplementedError`` where
it is reached): tensor and sharded parallelism (item 6b), the static
program's data parallelism (6c), the gang supervisor (6d), sequence,
expert and pipeline parallelism (6e), the parameter server (6f). As in
the JAX package, ``spawn`` is None.

The module also calls as the tensor API's ``dist`` (``ops.linalg.dist``,
the p-norm of ``x - y``): Paddle scripts write ``paddle.dist(x, y)``,
and the JAX package binds that name to the op (``paddle_tpu/__init__.py``
rebinds it after importing its own ``dist`` package)."""
import sys
import types

from .env import (MeshGuard, ParallelEnv, get_mesh, get_rank,  # noqa: F401
                  get_world_size, init_mesh, init_parallel_env,
                  mesh_axis_size, set_mesh)
from .collective import (ReduceOp, all_gather, all_reduce,  # noqa: F401
                         all_to_all, barrier, broadcast, ppermute, reduce,
                         reduce_scatter, scatter)
from .parallel import (DataParallel, DistributedTrainStep,  # noqa: F401
                       param_spec, shard_tensor)
from .tp_layers import (ColumnParallelLinear, RowParallelLinear,
                        VocabParallelEmbedding)
from .gradcomm import CommOptions, plan_buckets  # noqa: F401
from . import fleet as _fleet_mod  # noqa: F401
from .fleet import DistributedStrategy, fleet  # noqa: F401

spawn = None  # as the JAX package: ranks start through dist.launch

__all__ = ["init_parallel_env", "get_world_size", "get_rank",
           "ParallelEnv", "init_mesh", "get_mesh", "set_mesh",
           "mesh_axis_size", "MeshGuard", "all_reduce", "all_gather",
           "reduce_scatter", "broadcast", "all_to_all", "ppermute",
           "reduce", "scatter", "barrier", "ReduceOp", "DataParallel",
           "DistributedTrainStep", "shard_tensor", "param_spec",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "CommOptions", "plan_buckets",
           "fleet", "DistributedStrategy", "spawn"]


class _CallableModule(types.ModuleType):
    def __call__(self, x, y, p=2.0, name=None):
        from ..ops.linalg import dist

        return dist(x, y, p)


sys.modules[__name__].__class__ = _CallableModule
