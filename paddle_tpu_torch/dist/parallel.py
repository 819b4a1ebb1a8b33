"""Data-parallel training: ``DataParallel``, ``DistributedTrainStep``,
``shard_tensor`` and ``param_spec``, the counterparts of
``paddle_tpu/dist/parallel.py``'s (``parallel.py:25-233``).

The JAX step takes the GLOBAL batch and shards it over the mesh's
``data`` axis (``parallel.py:167-182``). So does this one: each rank
takes its rows ``[r*k, (r+1)*k)`` of every batch item, so that one
script drives both packages on the same arrays. At setup rank 0's
parameters, buffers and optimizer state are broadcast, so the replicas
start the same; ranks after 0 reseed their device generator with the
global seed plus the rank, so that each draws its own dropout masks
(the JAX step splits its key a shard, ``jit.py:166-170``).

Each rank runs forward and backward on its rows, and the gradients are
exchanged through ``TrainStep``'s windows (``framework/jit.py``):

- without ``comm_options`` (the JAX implicit path, where GSPMD places
  one all-reduce a parameter gradient), one float32 ``all_reduce`` a
  parameter, in reverse parameter order, times ``1/n``; every
  BatchNorm in the loss normalises over the global batch
  (``ops.norm_ops.sync_stats``), as the JAX step's does when GSPMD
  shards its batch axis;
- with ``comm_options`` (or a ``DataParallel`` wrapper's
  ``comm_buffer_size``), the bucketed or int8 exchange of
  ``dist.gradcomm``, accumulation over ``accumulate_steps``
  microbatches of ``run_fused``, the error-feedback state in the
  optimizer's state; BatchNorm normalises each rank's rows and the
  floating buffers are averaged over the ranks after each microbatch,
  the integer ones taken from rank 0 (``jit.py:148-150, 191-197``).

The loss each rank returns is the global one: the ranks' losses summed
over n. A world of one trains as ``TrainStep`` does.

Not ported: tensor-parallel layouts (a mesh ``model`` axis,
``param_spec`` other than replicated) and ``shard_opt_state`` (ROADMAP
Queue 1 item 6b), and ``collective_profile`` (item 7).
"""
from __future__ import annotations

import warnings

import torch

from ..core.random import default_generator, global_seed
from ..framework.jit import TrainStep
from ..ops import norm_ops
from . import collective, gradcomm
from .env import get_group, get_mesh

__all__ = ["DataParallel", "DistributedTrainStep", "shard_tensor",
           "param_spec"]


def param_spec(p):
    """The layout of a parameter: replicated (None) here; tensor-parallel
    layouts wait for item 6b."""
    return getattr(p, "sharding_spec", None)


def shard_tensor(t, mesh=None, spec=None):
    """Place ``t`` replicated on the mesh (every rank keeps its copy);
    a split layout waits for item 6b."""
    if spec is not None and any(s is not None for s in spec):
        raise NotImplementedError(
            f"shard_tensor with spec {spec}: sharded layouts wait for "
            "ROADMAP Queue 1 item 6b")
    return t


class DistributedTrainStep(TrainStep):
    """``TrainStep`` over the mesh's ``data`` axis (see the module's
    doc). ``comm_options`` (a ``gradcomm.CommOptions``), or a
    ``DataParallel`` model's, selects the explicit exchange. ``donate``
    is accepted as the JAX step's: the state is updated in place here
    whatever it says."""

    def __init__(self, model, optimizer, loss_fn, mesh=None,
                 batch_axis="data", batch_specs=None, models=None,
                 donate=True, shard_opt_state=False, scaler=None,
                 check_nan=False, comm_options=None):
        super().__init__(model, optimizer, loss_fn, scaler=scaler,
                         check_nan=check_nan)
        self.mesh = mesh or get_mesh()
        if self.mesh is None:
            raise ValueError("no mesh: call dist.init_mesh(...) first")
        if models is not None:
            raise NotImplementedError(
                "models=: the port's TrainStep trains one model")
        if batch_specs is not None:
            raise NotImplementedError(
                "batch_specs (a layout a batch item): every item of one "
                "or more dimensions is split over the data axis here; "
                "other layouts wait for ROADMAP Queue 1 item 6b")
        if shard_opt_state:
            raise NotImplementedError(
                "shard_opt_state (ZeRO-style sharding of the optimizer "
                "state) waits for ROADMAP Queue 1 item 6b")
        self.batch_axis = batch_axis
        self.group = get_group()
        self._n = self.mesh.shape.get(batch_axis, 1)
        _, n, self.rank = collective._group(self.group)
        if self._n != n:
            raise ValueError(f"the mesh's {batch_axis!r} axis has "
                             f"{self._n} ranks, the group {n}")
        inherited = False
        if comm_options is None:
            # the DataParallel wrapper's knobs apply to the step that
            # owns the exchange
            comm_options = getattr(model, "comm_options", None)
            inherited = comm_options is not None
        self.comm_options = None
        if comm_options is not None:
            try:
                self._check_comm(comm_options)
                self.comm_options = comm_options
            except ValueError:
                if not inherited:
                    raise
                warnings.warn(
                    "DataParallel comm_buffer_size ignored: this layout "
                    "is not pure data parallelism (or composes with a "
                    "GradScaler); gradients take the implicit exchange. "
                    "Pass comm_options= to DistributedTrainStep "
                    "explicitly to make this an error", RuntimeWarning)
        self._replicate()

    def _check_comm(self, options):
        """``parallel.py:112-143``'s refusals."""
        if options.quantize and self.scaler is not None:
            raise ValueError(
                "quantize='int8' cannot compose with a GradScaler: the "
                "exchange runs on SCALED gradients, so error-feedback "
                "residuals would be stored in loss-scale units (stale "
                "after every scale change) and an overflow step would "
                "quantize inf into the persistent residual. Use int8 "
                "without dynamic loss scaling (or fp32 bucketing with "
                "it)")
        axes = dict(self.mesh.shape)
        if set(axes) != {self.batch_axis} or self._n < 2 or \
                self.batch_axis != "data":
            raise ValueError(
                "comm-efficient gradient exchange needs a pure data-"
                "parallel mesh over a single 'data' axis with >= 2 "
                f"devices, got mesh axes {axes} "
                f"(batch_axis={self.batch_axis!r})")
        for name, p in self.optimizer._named_params:
            if param_spec(p) is not None:
                raise ValueError(
                    f"comm-efficient exchange needs replicated params "
                    f"(pure DP); {name} is laid out {param_spec(p)}")

    @torch.no_grad()
    def _replicate(self):
        """Rank 0's parameters, buffers and optimizer state to every
        rank; ranks after 0 draw dropout from their own stream."""
        if self._n == 1:
            return
        for t in list(self.model.parameters()) + list(self.model.buffers()):
            collective.raw_broadcast(t.data, 0, self.group)
        for name, s in self.optimizer._accumulators.items():
            if not name.startswith("@comm@"):
                for v in s.values():
                    collective.raw_broadcast(v, 0, self.group)
        if self.rank > 0:
            default_generator(self._device()).manual_seed(
                global_seed() + self.rank)

    # -- the exchange hooks of TrainStep ------------------------------------

    def _ranks(self):
        return self._n

    def _window_size(self, accumulate_steps):
        own = 1 if self.comm_options is None \
            else self.comm_options.accumulate_steps
        if accumulate_steps is None:
            return own
        N = super()._window_size(accumulate_steps)
        if own > 1 and N != own:
            raise ValueError(f"accumulate_steps={N}, but the step's "
                             f"comm_options accumulate {own}")
        return N

    def _new_exchange(self, named, dev):
        entries = [(n, tuple(p.shape), p.dtype) for n, p in reversed(named)]
        if self.comm_options is None:
            plan = gradcomm.implicit_plan(entries, self._n)
        else:
            plan = gradcomm.plan_buckets(entries, self.comm_options,
                                         self._n)
        return gradcomm.Exchange(plan, named, self.optimizer, self.group,
                                 dev)

    def _forward_context(self):
        if self.comm_options is None and self._n > 1:
            return norm_ops.sync_stats(self.group)
        return super()._forward_context()

    @torch.no_grad()
    def _sync_buffers(self):
        """The explicit exchange's buffers: floating ones averaged over the
        ranks, integer ones rank 0's (``jit.py:191-197``)."""
        if self.comm_options is None or self._n == 1:
            return
        for b in self.model.buffers():
            if b.is_floating_point():
                total = collective.raw_all_reduce(b.float(),
                                                  group=self.group)
                b.copy_(total / self._n)
            else:
                collective.raw_broadcast(b, 0, self.group)

    def _local_batch(self, batch, K):
        """This rank's rows of each batch item (dim 0 of a step's items,
        dim 1 of a stacked window's)."""
        if self._n == 1:
            return batch
        d = 0 if K is None else 1
        out = []
        for a in batch:
            if a.dim() <= d:
                out.append(a)
                continue
            if a.shape[d] % self._n:
                shapes = [tuple(b.shape) for b in batch]
                raise ValueError(
                    f"a batch item's leading dim {a.shape[d]} does not "
                    f"divide the {self._n}-rank data mesh (batch shapes: "
                    f"{shapes}); each rank takes an equal share of the "
                    "rows")
            k = a.shape[d] // self._n
            out.append(a.narrow(d, self.rank * k, k))
        return out

    @property
    def last_exchange(self):
        """The last exchange across ranks: the calls of each kind, the
        bytes handed to them and its host wall (``ms``); None before."""
        return None if self._exchange is None else self._exchange.last


class DataParallel:
    """ref: ``paddle.DataParallel(layer)``: the forward is the layer's;
    ``comm_buffer_size`` (MB, as the reference) and
    ``last_comm_buffer_size`` become the ``gradcomm.CommOptions`` that
    ``DistributedTrainStep`` takes up (``parallel.py:196-233``)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=None,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 comm_options=None):
        self._layers = layers
        if comm_options is None and comm_buffer_size is not None:
            comm_options = gradcomm.CommOptions(
                bucket_bytes=int(comm_buffer_size * gradcomm.MB),
                last_bucket_bytes=int(last_comm_buffer_size * gradcomm.MB))
        self.comm_options = comm_options

    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)

    @property
    def scale_loss(self):
        return 1.0
