"""``TrainStep``: one training step — forward, backward, unscale and
finite check, clip, update, loss-scale advance — as one CUDA graph.

The counterpart of ``paddle_tpu/framework/jit.py``'s ``TrainStep``
(:67-457) and ``run_fused`` (:522-665). The JAX package traces the
whole step into one donated executable per batch signature; here the
step is captured into one ``torch.cuda.CUDAGraph`` per signature and
replayed. A graph replays exactly the kernels the step launches op by
op, so a replayed step gives the op-by-op step's bits; ``torch.compile``
could not trace the kernels' ``ctypes`` calls, and its fusions would
round the optimizer's arithmetic otherwise.

The step follows ``_make_apply`` (:258-331): with a loss scaler the loss
is scaled before ``backward()``, every gradient is unscaled in float32
with one finite check over all of them, then clipped and applied; an
overflowed step keeps parameters, masters, optimizer state and buffers
bitwise as they were, and the scaler's state advances on the device.
Without a scaler, ``check_nan`` flags a non-finite loss or gradient on
the device, still applies the update, and raises
``utils.nan_guard.NanInfError`` (a ``FloatingPointError``) on the host
after the step, with the loss's ``nonfinite_summary`` when the loss
itself is non-finite (``jit.py:445-456``). ``last_found_inf`` is the
raw device flag; ``captures`` counts the graphs captured.

On a CUDA model, calls go in this order for each key — the batch
signature, the storage of the parameters, of the model's buffers (a
BatchNorm's running statistics, which the step updates in place) and of
the optimizer state (``data_ptr``), ``model.training``, which
parameters train, and whether ``kernels.plain_versions()`` is active:

1. the first call runs the step op by op on a side stream: it counts as
   a training step, and it loads the kernel libraries, makes the
   optimizer state and warms cuBLAS;
2. the second captures the step on that stream (nothing runs) and
   replays it;
3. every later call copies the batch into the graph's input tensors,
   ``float32(optimizer.get_lr())`` into the optimizer's learning-rate
   tensor, and replays.

Storage that moves (``model.bfloat16()``, a new optimizer state) makes a
new key, so a new warm step and capture; graphs of storage that moved
are dropped. Each dropout draws from the device's generator
(``core.random``), registered with the graph so that every replay draws
new masks: the ones the op-by-op step would draw from the same state.
The kernel wrappers count launches in Python, so a capture's counts are
taken back and added once for each replay (``kernels.add_launches``).
A capture or replay that fails raises; nothing falls back to the op-by-op
step. On the CPU there is no graph: every call runs the step op by op,
which ``_eager_step`` also does on the card, for comparison.

``run_fused(batches, steps=K)`` runs K microbatches of one signature as
one graph of K steps, with the learning rate read once for the window.

``ProgramCache`` does the same for an inference program — a model's
whole decode (``GPT.generate_xla``, ``WMTTransformer
.beam_search_decode_xla``) — the counterpart of the JAX models' jit
caches (``_xla_gen_cache``, ``_xla_decode_cache``).

Not ported: the gradient-exchange paths (``accumulate_steps``) and the
AOT executable cache.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.random import default_generator
from ..ops import kernels
from ..ops.kernels import _route
from ..utils.nan_guard import NanInfError, nonfinite_summary

__all__ = ["TrainStep", "ProgramCache"]


def _signature(batch):
    return tuple((tuple(b.shape), b.dtype) for b in batch)


def _tensors(batch):
    """Batch items as tensors: numpy arrays and scalars through
    ``torch.from_numpy`` (no copy), tensors as they are."""
    return [b if isinstance(b, torch.Tensor)
            else torch.from_numpy(np.require(b, requirements="C"))
            for b in batch]


class _Graph:
    """A captured step: the graph, its input tensors (filled before each
    replay), its outputs, the gradients it writes and the kernel launches
    one replay makes."""

    __slots__ = ("graph", "inputs", "loss", "found", "grads", "launches")

    def __init__(self, graph, inputs, loss, found, grads, launches):
        self.graph, self.inputs, self.loss, self.found = (graph, inputs,
                                                          loss, found)
        self.grads, self.launches = grads, launches


class TrainStep:
    """``step = TrainStep(model, optimizer, loss_fn); loss = step(*batch)``.

    ``loss_fn(model, *batch)`` returns a scalar loss tensor. Batch items
    that are numpy arrays (or scalars) are moved to the model's device.
    Returns the loss of this step (computed before the update), detached.
    ``scaler`` is an ``amp`` loss scaler (``StaticLossScaler``,
    ``DynamicLossScaler``, ``GradScaler``)."""

    def __init__(self, model, optimizer, loss_fn, scaler=None,
                 check_nan=False):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.scaler = scaler
        self.check_nan = check_nan
        self.last_found_inf = None
        self.last_found_inf_per_step = None
        self._scaler_state = (scaler.state(self._device())
                              if scaler is not None else None)
        self._graphs = {}     # key -> _Graph, or None once warmed
        self._stream = None
        self.captures = 0

    def _device(self):
        return next(self.model.parameters()).device

    # -- the step on the device: run op by op, or captured ---------------

    def _step_body(self, batch):
        """One step on device tensors: ``(loss, found_inf)``, 0-d tensors on
        the device. Reads nothing back to the host."""
        opt, scaler = self.optimizer, self.scaler
        opt.clear_grad()
        buffers = list(self.model.buffers()) if scaler is not None else []
        old = [b.clone() for b in buffers]
        loss = self.loss_fn(self.model, *batch)
        scale = None if scaler is None else self._scaler_state["scale"]
        (loss if scale is None else loss * scale).backward()
        with torch.no_grad():
            named = [(name, p, p.grad) for name, p in opt._named_params
                     if p.requires_grad and p.grad is not None]
            flags = []
            if scale is not None:
                # unscale in float32, one finite check over every gradient
                inv = 1.0 / scale
                named = [(name, p, g.float() * inv) for name, p, g in named]
                flags = [~torch.isfinite(g).all() for _, _, g in named]
            elif self.check_nan:
                flags = [~torch.isfinite(loss).all()]
                flags += [~torch.isfinite(g).all() for _, _, g in named]
            found = (torch.stack(flags).any() if flags else
                     torch.zeros((), dtype=torch.bool, device=loss.device))
            opt._apply(named, found if scale is not None else None)
            if scale is not None:
                # an overflowed step commits no buffer update either
                for b, o in zip(buffers, old):
                    torch.where(found, o, b, out=b)
                for k, v in scaler.update_state(self._scaler_state,
                                                found).items():
                    self._scaler_state[k].copy_(v)
        return loss.detach(), found

    def _body(self, batch, K):
        """One step (``K`` None) or K steps over stacked microbatches:
        ``(loss, found_inf)``, each of shape ``()`` or ``(K,)``."""
        if K is None:
            return self._step_body(batch)
        outs = [self._step_body([b[k] for b in batch]) for k in range(K)]
        return (torch.stack([loss for loss, _ in outs]),
                torch.stack([found for _, found in outs]))

    def _run(self, batch, K):
        """The step(s) op by op on the current stream."""
        dev = self._device()
        batch = [b.to(dev) for b in batch]
        self.optimizer._load_lr(dev)
        return self._body(batch, K)

    # -- the graphs ---------------------------------------------------------

    def _key(self, batch, K):
        opt = self.optimizer
        storage = (tuple(p.data_ptr() for _, p in opt._named_params),
                   tuple(b.data_ptr() for b in self.model.buffers()),
                   tuple(t.data_ptr() for s in opt._accumulators.values()
                         for t in s.values()))
        return (K, _signature(batch), _route.forced(), self.model.training,
                tuple(p.requires_grad for _, p in opt._named_params),
                storage)

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self._device())
        return self._stream

    def _warm(self, batch, K):
        """The first call of a key: the step(s) op by op on the side
        stream that captures them next."""
        main, side = torch.cuda.current_stream(), self._side_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            loss, found = self._run(batch, K)
        main.wait_stream(side)
        for t in (loss, found):
            t.record_stream(main)
        return loss, found

    def _capture(self, batch, K):
        dev = self._device()
        opt = self.optimizer
        inputs = [torch.empty_like(b, device=dev) for b in batch]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(default_generator(dev))
        opt.clear_grad()
        before = kernels.launches()
        main, side = torch.cuda.current_stream(), self._side_stream()
        side.wait_stream(main)
        with torch.cuda.graph(graph, stream=side):
            loss, found = self._body(inputs, K)
        main.wait_stream(side)
        # the wrappers counted launches that a capture does not run
        launched = {k: n - before[k] for k, n in kernels.launches().items()}
        kernels.add_launches({k: -n for k, n in launched.items()})
        grads = [(p, p.grad) for _, p in opt._named_params]
        self.captures += 1
        return _Graph(graph, inputs, loss, found, grads, launched)

    def _replay(self, entry, batch):
        for dst, src in zip(entry.inputs, batch):
            dst.copy_(src)
        self.optimizer._load_lr(self._device())
        entry.graph.replay()
        kernels.add_launches(entry.launches)
        for p, g in entry.grads:
            p.grad = g
        return entry.loss.clone(), entry.found.clone()

    def _graphed(self, batch, K):
        key = self._key(batch, K)
        if key not in self._graphs:
            out = self._warm(batch, K)
            key = self._key(batch, K)     # the optimizer state exists now
            # graphs of storage that has moved can never replay again
            self._graphs = {k: g for k, g in self._graphs.items()
                            if k[-1] == key[-1]}
            self._graphs[key] = None
            return out
        entry = self._graphs[key]
        if entry is None:
            entry = self._graphs[key] = self._capture(batch, K)
        return self._replay(entry, batch)

    # -- the entry points ---------------------------------------------------

    def _finish(self, loss, found, K):
        opt = self.optimizer
        opt._global_step += 1 if K is None else K
        # the raw device flags, read without a host sync
        self.last_found_inf = found if K is None else found.any()
        if K is not None:
            self.last_found_inf_per_step = found
        if self.check_nan and self.scaler is None and \
                bool(self.last_found_inf):
            if K is None:
                # only the loss is still on hand: attach its summary when
                # IT is the nonfinite value, none when only the gradients
                # overflowed (a zero-count summary would mislead)
                s = nonfinite_summary(loss)
                raise NanInfError(
                    f"NaN/Inf in loss or gradients at step "
                    f"{opt._global_step} (loss={float(loss)})",
                    summary=s if s["num_nan"] or s["num_inf"] else None)
            bad = torch.nonzero(found.cpu()).flatten().tolist()
            raise NanInfError(
                f"NaN/Inf in loss or gradients in fused window ending at "
                f"step {opt._global_step} (microbatch index(es) {bad} of "
                f"{K})")
        return loss

    def _eager_step(self, *batch):
        """The step op by op on the current stream, with no graph."""
        return self._finish(*self._run(_tensors(batch), None), None)

    def __call__(self, *batch):
        if self._device().type != "cuda":
            return self._eager_step(*batch)
        return self._finish(*self._graphed(_tensors(batch), None), None)

    step = __call__

    def run_fused(self, batches, steps=None, accumulate_steps=1):
        """Run K microbatches as one graph of K steps; returns the (K,)
        losses.

        ``batches`` is a sequence of K per-step batch tuples of one
        signature (the tuples K calls would take), or one pre-stacked
        tuple of arrays with a leading axis of K (then ``steps=K`` is
        needed). The learning rate is read once for the window,
        ``optimizer._global_step`` advances by K, ``last_found_inf`` is
        the any-step flag and ``last_found_inf_per_step`` the (K,) flags;
        with ``check_nan`` a non-finite microbatch raises after the
        window. The first call of a window signature runs the K steps op
        by op, the second captures them. ``accumulate_steps`` other than
        1 needs the gradient exchange, which is not ported: it raises."""
        if accumulate_steps != 1:
            raise NotImplementedError(
                "accumulate_steps needs the gradient exchange "
                "(dist.gradcomm), which paddle_tpu_torch does not port")
        if steps is None:
            try:
                steps = len(batches)
            except TypeError:
                raise ValueError(
                    "run_fused needs steps=K when batches is not a sized "
                    "sequence of per-step batch tuples") from None
        K = int(steps)
        if K <= 0:
            raise ValueError(f"steps must be >= 1, got {K}")
        seq = list(batches)
        if seq and isinstance(seq[0], (list, tuple)):
            if len(seq) != K:
                raise ValueError(
                    f"steps={K} but {len(seq)} microbatches were given")
            rows = [_tensors(row) for row in seq]
            sig0 = _signature(rows[0])
            for i, row in enumerate(rows[1:], 1):
                if _signature(row) != sig0:
                    raise ValueError(
                        f"microbatch {i} signature {list(_signature(row))} "
                        f"!= microbatch 0 {list(sig0)}: fused steps need "
                        "uniform shapes")
            stacked = [torch.stack([row[i] for row in rows])
                       for i in range(len(rows[0]))]
        else:
            stacked = _tensors(seq)
            for a in stacked:
                if a.dim() < 1 or a.shape[0] != K:
                    raise ValueError(
                        f"pre-stacked batch array has shape "
                        f"{tuple(a.shape)}; expected a leading microbatch "
                        f"axis of {K}")
        if self._device().type != "cuda":
            return self._finish(*self._run(stacked, K), K)
        return self._finish(*self._graphed(stacked, K), K)


class _Program:
    """A captured inference program: the graph, its input tensors (filled
    before each replay), its outputs, its generator (or None) and the
    kernel launches one replay makes."""

    __slots__ = ("graph", "inputs", "outputs", "generator", "launches")

    def __init__(self, graph, inputs, outputs, generator, launches):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.generator, self.launches = generator, launches


class ProgramCache:
    """One CUDA graph per key for a module's inference program.

    ``cache(module, signature, fn, inputs, seed=None)`` returns
    ``fn(*inputs, generator)``, a tuple of tensors, computed under
    ``torch.no_grad()``. ``generator`` is None unless ``seed`` is given;
    then it is a generator on the inputs' device, seeded with ``seed``
    before every call, so that calls with one seed draw the same numbers
    (as the JAX package's ``PRNGKey(seed)`` does).

    On a CUDA device the key is ``signature``, whether
    ``kernels.plain_versions()`` is active, ``module.training`` and the
    storage of the module's parameters (``data_ptr``). The first call of
    a key runs ``fn`` op by op on a side stream (it loads the kernel
    libraries and warms cuBLAS), captures it on that stream, and replays
    the capture; every later call copies ``inputs`` into the graph's
    input tensors and replays. The graph reads the parameters in place,
    so weights written in place between calls are honoured; storage that
    moves (``module.bfloat16()``, ``load_state_dict`` into new tensors)
    makes a new key, and the graphs of the old storage are dropped. The
    generator, and the device's (dropout in training), are registered
    with the graph. Launches are counted as ``TrainStep`` counts them:
    the warm run's as they happen, a capture's taken back and added once
    for each replay. On the CPU every call runs ``fn`` op by op; the key
    is recorded all the same. ``len(cache)`` is the number of keys."""

    def __init__(self):
        self._programs = {}   # key -> _Program, None on the CPU
        self._stream = None

    def __len__(self):
        return len(self._programs)

    def __call__(self, module, signature, fn, inputs, seed=None):
        dev = inputs[0].device
        storage = tuple(p.data_ptr() for p in module.parameters())
        key = (signature, _route.forced(), module.training, storage)
        if key not in self._programs:
            # graphs of storage that has moved can never replay again
            self._programs = {k: g for k, g in self._programs.items()
                              if k[-1] == storage}
        with torch.no_grad():
            if dev.type != "cuda":
                self._programs[key] = None
                gen = None if seed is None else \
                    torch.Generator(device=dev).manual_seed(int(seed))
                return fn(*inputs, gen)
            if key not in self._programs:
                self._programs[key] = self._capture(fn, inputs, seed)
            return self._replay(self._programs[key], inputs, seed)

    def _capture(self, fn, inputs, seed):
        dev = inputs[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        main, side = torch.cuda.current_stream(), self._stream
        static = [x.clone() for x in inputs]
        gen = None if seed is None else torch.Generator(device=dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            if gen is not None:
                gen.manual_seed(int(seed))
            fn(*static, gen)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(default_generator(dev))
        if gen is not None:
            graph.register_generator_state(gen)
        before = kernels.launches()
        with torch.cuda.graph(graph, stream=side):
            outputs = fn(*static, gen)
        main.wait_stream(side)
        # the wrappers counted launches that a capture does not run
        launched = {k: n - before[k] for k, n in kernels.launches().items()}
        kernels.add_launches({k: -n for k, n in launched.items()})
        return _Program(graph, static, outputs, gen, launched)

    def _replay(self, program, inputs, seed):
        for dst, src in zip(program.inputs, inputs):
            dst.copy_(src)
        if program.generator is not None:
            program.generator.manual_seed(int(seed))
        program.graph.replay()
        kernels.add_launches(program.launches)
        return tuple(o.clone() for o in program.outputs)
