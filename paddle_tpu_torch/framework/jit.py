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
parameters train, whether ``kernels.plain_versions()`` is active, and
the calling thread's ``amp.auto_cast`` state (``amp_key``: a captured
step replays the casts it captured):

1. the first call runs the step op by op on a side stream: it counts as
   a training step, and it loads the kernel libraries, makes the
   optimizer state and warms cuBLAS;
2. the second captures the step on that stream (nothing runs) and
   replays it;
3. every later call copies the batch into the graph's input tensors,
   ``float32(optimizer.get_lr())`` into the optimizer's learning-rate
   tensor, and replays.

A step that reads a predicate on the card (``ops.control_flow``'s
``cond``, ``while_loop``, ``case``, ``switch_case`` with a CUDA tensor)
cannot be captured: a graph would replay the branch of its capture. Its
first call marks its key, ``uncaptured[key]`` names the ops that read
(the run journal records it once, an ``uncaptured`` event), and every
call of that key runs the step op by op on the card; the branch is
chosen on the host before anything could be captured. ``run_fused``
captures such a window all the same, and its capture raises
``RuntimeError`` at the read, as ``ProgramCache``'s and the static
``Executor``'s do.

Storage that moves (``model.bfloat16()``, a new optimizer state) makes a
new key, so a new warm step and capture; graphs of storage that moved
are dropped. Each dropout draws from the device's generator
(``core.random``), registered with the graph so that every replay draws
new masks: the ones the op-by-op step would draw from the same state.
The kernel wrappers count launches in Python, so a capture's counts are
taken back and added once for each replay (``kernels.add_launches``).
A capture or replay that fails raises; nothing falls back to the op-by-op
step. On the CPU there is no graph: every call runs the step op by op,
which ``_eager_step`` (and ``_eager_run_fused``) also does on the card,
for comparison.

``run_fused(batches, steps=K)`` runs K microbatches of one signature as
one graph of K steps, with the learning rate read once for the window.
``run_fused(..., accumulate_steps=N)`` updates once a window of N
microbatches: their gradients are added in float32 and the update takes
their sum over N (a ``dist.gradcomm.Exchange`` of this process alone,
one flat a parameter), as the JAX step's accumulation does
(``jit.py:459-520``) with one device.

The gradient exchange of data parallelism (``dist.DistributedTrainStep``)
runs through the same windows: forward and backward of each microbatch
write this rank's gradients into the exchange's float32 flats, the flats
are exchanged once a window, and the update reads them back. Across
ranks a collective cannot be captured (gloo's are host calls), so there
the step is two captured segments a window with the exchange between
them on the host: forward and backward (one graph for a window's first
microbatch, which copies its gradients into the flats, one for the
others, which add theirs; the graphs share one memory pool), then the
exchange op by op, then the update (unscale, finite check, clip,
update, scaler advance). In a process alone the exchange is device work
and the whole window stays one graph. A collective inside forward or
backward (a ``SyncBatchNorm`` across ranks, which records itself in
``control_flow.DEVICE_READS``) keeps the step's key uncaptured, a
``run_fused`` window's too: every call of that key runs op by op. The
exchange's own collectives, between the segments, are not recorded.
``exchanges`` counts the windows exchanged.

``ProgramCache`` does the same for an inference program — a model's
whole decode (``GPT.generate_xla``, ``WMTTransformer
.beam_search_decode_xla``) — the counterpart of the JAX models' jit
caches (``_xla_gen_cache``, ``_xla_decode_cache``).

``warm`` (a call op by op on the side stream that captures next) and
``capture`` (the capture on it, its launches taken back) are the first
two of the calls above; ``TrainStep``, ``ProgramCache`` and the static
``Executor`` (``static_/executor.py``) each run them.

``to_static(layer)`` (also ``jit``) is the reference's
``StaticFunction`` (``:693-759``) on ``ProgramCache``: a Layer's forward,
or a plain function, as one CUDA graph a signature of its inputs'
shapes and types, run under ``no_grad`` with the parameters read in
place; numpy arguments become tensors, and the outputs come back in the
pytree shape the function returned (tensors in tuples, lists and dicts).
In training mode dropout draws new numbers on each call, from the
device generator registered with the graph. On the CPU it runs op by
op. A plain function that closes over a parameter sees the parameter's
in-place updates here, where the JAX trace bakes its value in as a
constant (ROADMAP Queue 3, "not port faults").

Not ported: the AOT executable cache (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..amp.autocast import amp_key
from ..core.random import default_generator
from ..core.tensor import Tensor, plain, wrap
from ..ops import control_flow, kernels
from ..ops.kernels import _route
from ..utils.nan_guard import NanInfError, nonfinite_summary

__all__ = ["TrainStep", "ProgramCache", "warm", "capture",
           "StaticFunction", "to_static", "jit", "no_jit"]


def warm(stream, fn):
    """``fn()`` on the side ``stream``, after the current stream's work;
    the current stream then waits for it. Returns ``fn()``'s result."""
    main = torch.cuda.current_stream()
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        out = fn()
    main.wait_stream(stream)
    return out


def capture(stream, fn, generators, pool=None):
    """``fn()`` captured into a new ``torch.cuda.CUDAGraph`` on ``stream``
    (nothing runs), ``generators`` registered with it so that every
    replay draws on from their state; ``pool`` a memory pool it shares
    with graphs replayed in their capture order. Returns ``(graph,
    fn()'s result, {kernel: launches one replay makes})``: the wrappers
    counted the capture's launches, which did not run, so they are taken
    back here and added for each replay (``kernels.add_launches``)."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    before = kernels.launches()
    main = torch.cuda.current_stream()
    stream.wait_stream(main)
    with torch.cuda.graph(graph, stream=stream, pool=pool):
        out = fn()
    main.wait_stream(stream)
    launched = {k: n - before[k] for k, n in kernels.launches().items()}
    kernels.add_launches({k: -n for k, n in launched.items()})
    return graph, out, launched


def _signature(batch):
    return tuple((tuple(b.shape), b.dtype) for b in batch)


def _tensors(batch):
    """Batch items as plain tensors: numpy arrays and scalars through
    ``torch.from_numpy`` (no copy), Paddle ``Tensor``s as their plain
    aliases, other tensors as they are."""
    return [plain(b) if isinstance(b, torch.Tensor)
            else torch.from_numpy(np.require(b, requirements="C"))
            for b in batch]


def _any_paddle(items):
    return any(isinstance(b, Tensor) for b in items)


@contextlib.contextmanager
def _unrecorded():
    """The exchange between a window's segments: its collectives keep no
    key uncaptured (``control_flow.DEVICE_READS`` set aside)."""
    reads, control_flow.DEVICE_READS[0] = control_flow.DEVICE_READS[0], None
    try:
        yield
    finally:
        control_flow.DEVICE_READS[0] = reads


class _Graph:
    """A captured step: the graph, its input tensors (filled before each
    replay), its outputs, the gradients it writes and the kernel launches
    one replay makes."""

    __slots__ = ("graph", "inputs", "loss", "found", "grads", "launches")

    def __init__(self, graph, inputs, loss, found, grads, launches):
        self.graph, self.inputs, self.loss, self.found = (graph, inputs,
                                                          loss, found)
        self.grads, self.launches = grads, launches


class _Segments:
    """A window captured as segments around the exchange: one microbatch's
    input tensors, the forward-and-backward graphs (``fb[first]``: the
    graph, its loss, its launches, the gradients it writes) and the
    update's (the graph, its found-inf flag, its launches)."""

    __slots__ = ("inputs", "fb", "update")

    def __init__(self, inputs, fb, update):
        self.inputs, self.fb, self.update = inputs, fb, update

    def run_fb(self, mb, first):
        for dst, src in zip(self.inputs, mb):
            dst.copy_(src)
        graph, loss, launched, grads = self.fb[first]
        graph.replay()
        kernels.add_launches(launched)
        for p, g in grads:
            p.grad = g
        return loss.clone()

    def run_update(self):
        graph, found, launched = self.update
        graph.replay()
        kernels.add_launches(launched)
        return found.clone()


class TrainStep:
    """``step = TrainStep(model, optimizer, loss_fn); loss = step(*batch)``.

    ``loss_fn(model, *batch)`` returns a scalar loss tensor. Batch items
    that are numpy arrays (or scalars) are moved to the model's device.
    Returns the loss of this step (computed before the update), detached.
    A call with Paddle ``Tensor`` batch items hands ``loss_fn`` Paddle
    ``Tensor``s (aliases of the graph's plain input tensors) and returns
    the loss as one; the step itself, and its graph, are the same.
    ``scaler`` is an ``amp`` loss scaler (``StaticLossScaler``,
    ``DynamicLossScaler``, ``GradScaler``)."""

    def __init__(self, model, optimizer, loss_fn, scaler=None,
                 check_nan=False):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.scaler = scaler
        self.check_nan = check_nan
        self._paddle = False      # this call's batch held a Paddle Tensor
        self.last_found_inf = None
        self.last_found_inf_per_step = None
        self._scaler_state = (scaler.state(self._device())
                              if scaler is not None else None)
        self._graphs = {}     # key -> _Graph, or None once warmed
        self._stream = None
        self.captures = 0
        # key -> the ops whose predicate read on the card kept it uncaptured
        self.uncaptured = {}
        # the gradient exchange (dist.gradcomm.Exchange), made at first use
        self.exchanges = 0
        self._exchange = None
        self._exchange_for = None     # (serial, the names it plans)
        self._exchange_serial = 0
        self._win_loss = None         # the window's last global loss
        self._window_old = []         # buffers at the window's start

    def _device(self):
        return next(self.model.parameters()).device

    # -- the step on the device: run op by op, or captured ---------------

    def _step_body(self, batch):
        """One step on device tensors: ``(loss, found_inf)``, 0-d tensors on
        the device. Reads nothing back to the host."""
        opt, scaler = self.optimizer, self.scaler
        opt.clear_grad()
        old = [b.clone() for b in self.model.buffers()] \
            if scaler is not None else []
        if self._paddle:
            batch = [wrap(b) for b in batch]
        loss = plain(self.loss_fn(self.model, *batch))
        scale = None if scaler is None else self._scaler_state["scale"]
        (loss if scale is None else loss * scale).backward()
        named = [(name, p, p.grad) for name, p in opt._named_params
                 if p.requires_grad and p.grad is not None]
        return loss.detach(), self._apply_update(named, loss, old)

    @torch.no_grad()
    def _apply_update(self, named, loss, old):
        """Unscale (float32, one finite check over every gradient) or
        check, clip and update from ``[(name, parameter, gradient)]``;
        with a scaler an overflowed step keeps every value and puts the
        buffers back to ``old``, and the scale advances. Returns
        ``found_inf``. Device work only."""
        opt, scaler = self.optimizer, self.scaler
        scale = None if scaler is None else self._scaler_state["scale"]
        flags = []
        if scale is not None:
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
            for b, o in zip(self.model.buffers(), old):
                torch.where(found, o, b, out=b)
            for k, v in scaler.update_state(self._scaler_state,
                                            found).items():
                self._scaler_state[k].copy_(v)
        return found

    # -- the exchange path: accumulation windows, data parallelism -------

    def _ranks(self):
        """Ranks the gradients are exchanged over: this process alone."""
        return 1

    def _exchanging(self, N):
        """Whether a call of N-microbatch windows goes through the
        exchange: accumulation, or gradients exchanged across ranks."""
        return N > 1 or self._ranks() > 1

    def _segmented(self, N):
        """Whether the window is captured as segments around a host
        exchange: whenever the exchange crosses ranks."""
        return self._exchanging(N) and self._ranks() > 1

    def _new_exchange(self, named, dev):
        """The exchange of this process alone: one float32 flat a
        parameter, no collective."""
        from ..dist import gradcomm

        entries = [(n, tuple(p.shape), p.dtype) for n, p in reversed(named)]
        return gradcomm.Exchange(gradcomm.implicit_plan(entries, 1), named,
                                 self.optimizer, None, dev)

    def _exchange_ready(self, dev):
        """The exchange for the parameters that train now (a new one, and
        so new graphs, when that set changes)."""
        named = [(n, p) for n, p in self.optimizer._named_params
                 if p.requires_grad]
        names = tuple(n for n, _ in named)
        if self._exchange is None or self._exchange_for[1] != names:
            self._exchange = self._new_exchange(named, dev)
            self._exchange_serial += 1
            self._exchange_for = (self._exchange_serial, names)
            self._win_loss = None
        return self._exchange

    def _forward_context(self):
        """The context the loss runs in (data parallelism may sync
        BatchNorm's statistics in it)."""
        return contextlib.nullcontext()

    def _sync_buffers(self):
        """After each microbatch's forward: nothing in a process alone."""

    def _fb(self, batch, first):
        """Forward and backward of one microbatch, its gradients into the
        exchange's flats (copied on a window's first microbatch, added
        after); returns the local loss. Device work only."""
        opt, scaler = self.optimizer, self.scaler
        if first and scaler is not None:
            self._window_old = [b.clone() for b in self.model.buffers()]
        opt.clear_grad()
        if self._paddle:
            batch = [wrap(b) for b in batch]
        with self._forward_context():
            loss = plain(self.loss_fn(self.model, *batch))
        scale = None if scaler is None else self._scaler_state["scale"]
        (loss if scale is None else loss * scale).backward()
        self._exchange.gather(first)
        return loss.detach()

    def _update(self):
        """The update from the exchanged gradients (``_apply_update``),
        with the window's global loss (``_win_loss``) and its starting
        buffers (``_window_old``). Device work only."""
        return self._apply_update(self._exchange.grads(), self._win_loss,
                                  self._window_old)

    def _window(self, batch, K, N, segments=None):
        """One step (``K`` None) or K microbatches in windows of N through
        the exchange, each segment op by op or replayed from
        ``segments``: ``(loss, found_inf)`` of shape ``()`` or ``(K,)``,
        each loss the window's exchanged one."""
        ex = self._exchange
        denom = (ex.n if ex.plan.options.gradient_scale == "mean" else 1) * N
        losses, founds = [], []
        for w in range((1 if K is None else K) // N):
            local = []
            for k in range(N):
                mb = batch if K is None else [b[w * N + k] for b in batch]
                local.append(self._fb(mb, k == 0) if segments is None
                             else segments.run_fb(mb, k == 0))
                with _unrecorded():
                    self._sync_buffers()
            with _unrecorded():
                wl = ex.reduce(torch.stack(local), denom)
            if self._win_loss is None:
                self._win_loss = torch.empty((), dtype=wl.dtype,
                                             device=wl.device)
            self._win_loss.copy_(wl[-1])
            found = self._update() if segments is None \
                else segments.run_update()
            losses.append(wl)
            founds += [found] * N
        if K is None:
            return losses[0][0], founds[0]
        return torch.cat(losses), torch.stack(founds)

    def _body(self, batch, K, N=1):
        """One step (``K`` None) or K steps over stacked microbatches:
        ``(loss, found_inf)``, each of shape ``()`` or ``(K,)``."""
        if self._exchanging(N):
            return self._window(batch, K, N)
        if K is None:
            return self._step_body(batch)
        outs = [self._step_body([b[k] for b in batch]) for k in range(K)]
        return (torch.stack([loss for loss, _ in outs]),
                torch.stack([found for _, found in outs]))

    def _run(self, batch, K, N=1):
        """The step(s) op by op on the current stream."""
        dev = self._device()
        batch = [b.to(dev) for b in batch]
        self.optimizer._load_lr(dev)
        if self._exchanging(N):
            self._exchange_ready(dev)
        return self._body(batch, K, N)

    # -- the graphs ---------------------------------------------------------

    def _key(self, batch, K, N=1):
        opt = self.optimizer
        storage = (tuple(p.data_ptr() for _, p in opt._named_params),
                   tuple(b.data_ptr() for b in self.model.buffers()),
                   tuple(t.data_ptr() for s in opt._accumulators.values()
                         for t in s.values()))
        exchange = self._exchange_for[0] if self._exchanging(N) and \
            self._exchange_for is not None else None
        return (K, N, exchange, _signature(batch), _route.forced(),
                self.model.training,
                tuple(p.requires_grad for _, p in opt._named_params),
                amp_key(), storage)

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self._device())
        return self._stream

    def _warm(self, batch, K, N=1):
        """The first call of a key: the step(s) op by op on the side
        stream that captures them next."""
        loss, found = warm(self._side_stream(),
                           lambda: self._run(batch, K, N))
        for t in (loss, found):
            t.record_stream(torch.cuda.current_stream())
        return loss, found

    def _capture(self, batch, K, N=1):
        dev = self._device()
        opt = self.optimizer
        if self._segmented(N):
            return self._capture_segments(batch, K, N)
        inputs = [torch.empty_like(b, device=dev) for b in batch]
        opt.clear_grad()
        graph, (loss, found), launched = capture(
            self._side_stream(), lambda: self._body(inputs, K, N),
            [default_generator(dev)])
        grads = [(p, p.grad) for _, p in opt._named_params]
        self.captures += 1
        return _Graph(graph, inputs, loss, found, grads, launched)

    def _capture_segments(self, batch, K, N):
        """The window's forward-and-backward graphs (the first
        microbatch's and, with N > 1, the others') and its update graph,
        in one memory pool."""
        dev = self._device()
        opt = self.optimizer
        mb = batch if K is None else [b[0] for b in batch]
        inputs = [torch.empty_like(b, device=dev) for b in mb]
        gens = [default_generator(dev)]
        pool = torch.cuda.graph_pool_handle()
        stream = self._side_stream()
        fb = {}
        for first in ((True, False) if N > 1 else (True,)):
            opt.clear_grad()
            graph, loss, launched = capture(
                stream, lambda: self._fb(inputs, first), gens, pool)
            fb[first] = (graph, loss, launched,
                         [(p, p.grad) for _, p in opt._named_params])
        update = capture(stream, self._update, gens, pool)
        self.captures += 1
        return _Segments(inputs, fb, update)

    def _replay(self, entry, batch, K=None, N=1):
        self.optimizer._load_lr(self._device())
        if isinstance(entry, _Segments):
            return self._window(batch, K, N, entry)
        for dst, src in zip(entry.inputs, batch):
            dst.copy_(src)
        entry.graph.replay()
        kernels.add_launches(entry.launches)
        for p, g in entry.grads:
            p.grad = g
        return entry.loss.clone(), entry.found.clone()

    def _graphed(self, batch, K, N=1):
        key = self._key(batch, K, N)
        if key in self.uncaptured:
            return self._run(batch, K, N)
        if key not in self._graphs:
            control_flow.DEVICE_READS[0] = reads = []
            try:
                out = self._warm(batch, K, N)
            finally:
                control_flow.DEVICE_READS[0] = None
            key = self._key(batch, K, N)  # the optimizer state exists now
            # a window that reads a predicate is captured, and raises at
            # the read; one that runs a host collective runs op by op
            if reads and (K is None or "collective" in reads):
                self._mark_uncaptured(key, reads)
                return out
            # graphs of storage that has moved can never replay again
            self._graphs = {k: g for k, g in self._graphs.items()
                            if k[-1] == key[-1]}
            self._graphs[key] = None
            return out
        entry = self._graphs[key]
        if entry is None:
            entry = self._graphs[key] = self._capture(batch, K, N)
        return self._replay(entry, batch, K, N)

    def _mark_uncaptured(self, key, reads):
        from ..obs import journal

        ops = sorted(set(reads))
        self.uncaptured[key] = ops
        if journal.ACTIVE is not None:
            journal.ACTIVE.event("uncaptured", source="train_step", ops=ops,
                                 signature=[list(s) for s, _ in key[1]])

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

    def _local_batch(self, batch, K):
        """The rows of the batch this process trains on: all of them."""
        return batch

    def _window_size(self, accumulate_steps):
        """N, the microbatches a ``run_fused`` window exchanges once."""
        N = 1 if accumulate_steps is None else int(accumulate_steps)
        if N < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got {N}")
        return N

    def _count_exchanges(self, K, N):
        if self._exchanging(N):
            self.exchanges += 1 if K is None else K // N

    def _eager_step(self, *batch):
        """The step op by op on the current stream, with no graph."""
        self._check_call()
        self._paddle = _any_paddle(batch)
        batch = self._local_batch(_tensors(batch), None)
        loss = self._finish(*self._run(batch, None), None)
        self._count_exchanges(None, 1)
        return wrap(loss) if self._paddle else loss

    def _check_call(self):
        """A single step cannot accumulate (``jit.py:403-408``)."""
        if self._window_size(None) > 1:
            raise ValueError(
                "accumulate_steps > 1 exchanges gradients once per N "
                "microbatches and therefore needs the fused path: call "
                "run_fused(batches, steps=K) with K a multiple of N")

    def __call__(self, *batch):
        if self._device().type != "cuda":
            return self._eager_step(*batch)
        self._check_call()
        self._paddle = _any_paddle(batch)
        batch = self._local_batch(_tensors(batch), None)
        loss = self._finish(*self._graphed(batch, None), None)
        self._count_exchanges(None, 1)
        return wrap(loss) if self._paddle else loss

    step = __call__

    def run_fused(self, batches, steps=None, accumulate_steps=None):
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
        by op, the second captures them. ``accumulate_steps=N`` (which
        must divide K) updates once every N microbatches from their
        gradients' mean, with the scaler's skip decided on that mean;
        each microbatch's loss is its own (``jit.py:459-520``)."""
        return self._fused(batches, steps, accumulate_steps, True)

    def _eager_run_fused(self, batches, steps=None, accumulate_steps=None):
        """``run_fused`` op by op on the current stream, with no graph."""
        return self._fused(batches, steps, accumulate_steps, False)

    def _fused(self, batches, steps, accumulate_steps, graphed):
        N = self._window_size(accumulate_steps)
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
        self._paddle = any(_any_paddle(row) if isinstance(row, (list, tuple))
                           else isinstance(row, Tensor) for row in seq)
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
        if N > 1 and K % N:
            raise ValueError(
                f"accumulate_steps={N} must divide the fused window "
                f"(steps={K}): partial accumulation windows would "
                "silently change the effective batch")
        stacked = self._local_batch(stacked, K)
        if graphed and self._device().type == "cuda":
            losses = self._finish(*self._graphed(stacked, K, N), K)
        else:
            losses = self._finish(*self._run(stacked, K, N), K)
        self._count_exchanges(K, N)
        return wrap(losses) if self._paddle else losses


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
    ``kernels.plain_versions()`` is active, ``module.training``, the
    ``amp.auto_cast`` state (``amp_key``) and the storage of the module's
    parameters (``data_ptr``); ``module`` None (a function that holds no
    module) keys on the rest. The first call of
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
        inputs = [plain(x) for x in inputs]
        dev = inputs[0].device
        storage = () if module is None else \
            tuple(p.data_ptr() for p in module.parameters())
        training = None if module is None else module.training
        key = (signature, _route.forced(), training, amp_key(), storage)
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
        static = [x.clone() for x in inputs]
        gen = None if seed is None else torch.Generator(device=dev)

        def run():
            if gen is not None:
                gen.manual_seed(int(seed))
            fn(*static, gen)

        warm(self._stream, run)
        graph, outputs, launched = capture(
            self._stream, lambda: fn(*static, gen),
            [default_generator(dev)] + ([] if gen is None else [gen]))
        return _Program(graph, static, outputs, gen, launched)

    def _replay(self, program, inputs, seed):
        for dst, src in zip(program.inputs, inputs):
            dst.copy_(src)
        if program.generator is not None:
            program.generator.manual_seed(int(seed))
        program.graph.replay()
        kernels.add_launches(program.launches)
        return tuple(o.clone() for o in program.outputs)


# -- to_static ---------------------------------------------------------------


def _flatten(out, leaves):
    """``out``'s tensors appended to ``leaves``; its structure, with the
    tensors' places in ``leaves`` and anything else as it is."""
    if isinstance(out, torch.Tensor):
        leaves.append(out)
        return ("t", len(leaves) - 1)
    if isinstance(out, (tuple, list)):
        return (type(out), [_flatten(o, leaves) for o in out])
    if isinstance(out, dict):
        return (dict, [(k, _flatten(v, leaves)) for k, v in out.items()])
    return ("c", out)


def _unflatten(tree, leaves):
    kind, body = tree
    if kind == "t":
        return leaves[body]
    if kind == "c":
        return body
    if kind is dict:
        return {k: _unflatten(v, leaves) for k, v in body}
    items = [_unflatten(t, leaves) for t in body]
    return items if kind is list else kind(items)


class StaticFunction:
    """``fn`` (or ``fn(model, *inputs)`` with a ``model``) as one CUDA
    graph a signature (``ProgramCache``); see the module's doc."""

    def __init__(self, fn, model=None):
        self._fn = fn
        self.__wrapped__ = fn
        self._model = model
        self._cache = ProgramCache()
        self._trees = {}

    def _device(self):
        if self._model is not None:
            for p in self._model.parameters():
                return p.device
        from .._device import resolve_device

        return resolve_device(None)

    def __call__(self, *args):
        dev = self._device()
        paddle = _any_paddle(args)
        xs = []
        for a in args:
            if isinstance(a, torch.Tensor):
                a = plain(a)
            else:
                a = np.asarray(a)
                a = torch.from_numpy(np.require(
                    a.astype(np.float32) if a.dtype == np.float64 else a,
                    requirements="C"))
            xs.append(a.to(dev))
        sig = tuple((tuple(x.shape), x.dtype) for x in xs)
        tkey = (sig, None if self._model is None else self._model.training)

        def run(*inputs):
            inputs = inputs[:-1]      # ProgramCache passes its generator
            if paddle:
                inputs = [wrap(x) for x in inputs]
            out = self._fn(*inputs) if self._model is None \
                else self._fn(self._model, *inputs)
            leaves = []
            self._trees[tkey] = _flatten(out, leaves)
            return tuple(plain(x) for x in leaves)

        leaves = self._cache(self._model, sig, run, xs)
        out = _unflatten(self._trees[tkey], list(leaves))
        return wrap(out) if paddle else out


def to_static(layer_or_fn=None, input_spec=None, **kwargs):
    """``paddle.jit.to_static``: a Layer (its forward; the result is also
    ``layer._static_forward``) or a function as a ``StaticFunction``;
    with no argument, the decorator."""
    from ..nn.layer import Layer

    def make(obj):
        if isinstance(obj, Layer):
            sf = StaticFunction(lambda m, *xs: m(*xs), model=obj)
            obj._static_forward = sf
            return sf
        return StaticFunction(obj)

    if layer_or_fn is None:
        return make
    return make(layer_or_fn)


def jit(fn=None, **kwargs):
    """``@paddle_tpu_torch.jit``: ``to_static`` as a decorator."""
    return to_static(fn, **kwargs)


no_jit = contextlib.nullcontext
