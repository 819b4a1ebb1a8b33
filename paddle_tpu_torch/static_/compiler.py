"""``CompiledProgram``, ``BuildStrategy``, ``ExecutionStrategy``.

The counterparts of ``paddle_tpu/static_/compiler.py``'s (ref:
``python/paddle/fluid/compiler.py``). A ``CompiledProgram`` runs as its
Program does, one CUDA graph per executor cache key; the strategies'
knobs are taken and inert, as in the JAX package, where XLA owns what
they tuned (here each replay is the recorded op list).
``with_data_parallel`` raises until the static program's data
parallelism is ported (ROADMAP Queue 1 item 6c).
"""
from __future__ import annotations

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]


class BuildStrategy:
    """Knob container for API parity; every flag is accepted and inert."""

    def __init__(self):
        self.reduce_strategy = "all_reduce"
        self.gradient_scale_strategy = "coeff_num_device"
        self.memory_optimize = None
        self.enable_inplace = None
        self.fuse_all_optimizer_ops = True
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0
        self.comm_options = None


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 100
        self.use_thread_pool = False
        self.allow_replicated_fallback = False


class CompiledProgram:
    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = ExecutionStrategy()
        self._data_parallel = False
        self._loss_name = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None, comm_options=None):
        raise NotImplementedError(
            "CompiledProgram.with_data_parallel (the static program's "
            "data parallelism) is not ported to paddle_tpu_torch yet "
            "(ROADMAP Queue 1 item 6c); eager data parallelism is "
            "dist.DistributedTrainStep")
