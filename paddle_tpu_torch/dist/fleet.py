"""Fleet's collective front end: the counterpart of
``paddle_tpu/dist/fleet.py`` (``fleet.py:22-181``; ref:
``python/paddle/fluid/incubate/fleet/`` in collective mode and
``DistributedStrategy``).

``fleet.init(is_collective=True, strategy)`` joins the process group
(``init_parallel_env``) and makes the mesh of the strategy's degrees;
``distributed_optimizer`` and ``distributed_model`` hand back what they
are given (the exchange is the train step's); ``build_train_step``
builds ``DistributedTrainStep`` with the strategy's features: AMP
(``amp.decorate`` at O2, ``auto_cast`` around the loss with the custom
lists, and the loss scaler ``amp_configs`` chooses: dynamic when
``use_dynamic_loss_scaling`` (default for float16), static at an
``init_loss_scaling``) and recompute (``set_recompute``). The worker
queries read the group.

A strategy with ``sharding``, or a degree other than data parallelism's
above 1, waits for ROADMAP Queue 1 items 6b and 6e (``init_mesh``
raises); the parameter server's ``init_worker``/``stop_worker`` are
no-ops, as in the JAX package.
"""
from __future__ import annotations

from .env import get_mesh, get_rank, get_world_size, init_mesh, \
    init_parallel_env
from .parallel import DistributedTrainStep

__all__ = ["DistributedStrategy", "init", "distributed_optimizer",
           "worker_num", "worker_index", "is_first_worker", "fleet"]


class DistributedStrategy:
    """ref: DistributedStrategy — degrees and feature switches."""

    def __init__(self):
        self.dp_degree = -1        # -1: whatever is left
        self.mp_degree = 1
        self.pp_degree = 1
        self.sp_degree = 1
        self.ep_degree = 1
        self.sharding = False      # shard optimizer state over dp axis
        self.sharding_degree = 1
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.lamb = False
        self.localsgd = False
        self.hybrid_configs = {}

    def mesh_axes(self):
        axes = {}
        if self.pp_degree > 1:
            axes["pipe"] = self.pp_degree
        axes["data"] = self.dp_degree
        if self.mp_degree > 1:
            axes["model"] = self.mp_degree
        if self.sp_degree > 1:
            axes["sp"] = self.sp_degree
        if self.ep_degree > 1:
            axes["expert"] = self.ep_degree
        return axes


class _Fleet:
    def __init__(self):
        self._strategy = None
        self._inited = False

    def init(self, role_maker=None, is_collective=True, strategy=None):
        """Join the group (``init_parallel_env``) and make the strategy's
        mesh."""
        init_parallel_env()
        self._strategy = strategy or DistributedStrategy()
        hybrid = self._strategy.hybrid_configs or {}
        for k in ("dp_degree", "mp_degree", "pp_degree", "sp_degree",
                  "ep_degree"):
            if k in hybrid:
                setattr(self._strategy, k, hybrid[k])
        if get_mesh() is None:
            init_mesh(self._strategy.mesh_axes())
        self._inited = True
        return self

    @property
    def strategy(self):
        return self._strategy

    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        optimizer._dist_strategy = self._strategy
        return optimizer

    def distributed_model(self, model):
        return model

    def build_train_step(self, model, optimizer, loss_fn, **kw):
        """``DistributedTrainStep`` with the strategy's AMP and recompute
        (``fleet.py:95-140``)."""
        st = self._strategy
        if st is not None and st.sharding:
            raise NotImplementedError(
                "strategy.sharding (the optimizer state sharded over the "
                "data axis) waits for ROADMAP Queue 1 item 6b")
        if st is not None and st.recompute and \
                hasattr(model, "set_recompute"):
            model.set_recompute(True)
        if st is not None and st.amp:
            from .. import amp as amp_mod

            cfgs = st.amp_configs or {}
            dtype = cfgs.get("dtype", "bfloat16")
            if cfgs.get("level", "O1") == "O2":
                amp_mod.decorate(model, optimizer, level="O2", dtype=dtype)
            white = cfgs.get("custom_white_list")
            black = cfgs.get("custom_black_list")
            inner_loss = loss_fn

            def loss_fn(m, *batch, _inner=inner_loss):  # noqa: F811
                with amp_mod.auto_cast(custom_white_list=white,
                                       custom_black_list=black,
                                       dtype=dtype):
                    return _inner(m, *batch)

            if "scaler" not in kw:
                if cfgs.get("use_dynamic_loss_scaling", dtype == "float16"):
                    kw["scaler"] = amp_mod.DynamicLossScaler(
                        init_loss_scaling=cfgs.get("init_loss_scaling",
                                                   2.0 ** 15),
                        incr_ratio=cfgs.get("incr_ratio", 2.0),
                        decr_ratio=cfgs.get("decr_ratio", 0.5),
                        incr_every_n_steps=cfgs.get("incr_every_n_steps",
                                                    1000),
                        decr_every_n_nan_or_inf=cfgs.get(
                            "decr_every_n_nan_or_inf", 1))
                elif cfgs.get("init_loss_scaling") is not None:
                    kw["scaler"] = amp_mod.StaticLossScaler(
                        cfgs["init_loss_scaling"])
        return DistributedTrainStep(model, optimizer, loss_fn,
                                    mesh=get_mesh(), **kw)

    # role queries (ref: fleet.worker_num()/worker_index())
    def worker_num(self):
        return get_world_size()

    def worker_index(self):
        return get_rank()

    def is_first_worker(self):
        return get_rank() == 0

    def barrier_worker(self):
        from .collective import barrier

        barrier()

    def init_worker(self):
        pass

    def stop_worker(self):
        pass


fleet = _Fleet()
init = fleet.init
distributed_optimizer = fleet.distributed_optimizer
worker_num = fleet.worker_num
worker_index = fleet.worker_index
is_first_worker = fleet.is_first_worker


def __getattr__(name):
    """The rest of the singleton's API at module level (``strategy``,
    ``build_train_step``, ...): an import of this module rebinds the
    package's ``fleet`` attribute to the module, which must then serve
    both spellings."""
    try:
        return getattr(fleet, name)
    except AttributeError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
