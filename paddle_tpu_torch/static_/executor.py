"""Executor: verify, optimize and run a Program.

The counterpart of ``paddle_tpu/static_/executor.py`` (ref:
``python/paddle/fluid/executor.py``, ``framework/executor.cc``). The JAX
Executor replays a Program into one pure function and compiles it with
``jax.jit`` once per ``CacheKey``, donating the persistables. Here a
cache entry is the verified and optimized op list of its key
(``_compile``: the analysis passes run once a key, as the JAX package's
do), and its replay (``_step``) runs the ops in order on the device:

- each differentiated forward op runs once, on inputs detached from
  what came before, and its ``@grad`` op takes its saved autograd graph
  (``backward.GradFn``);
- the persistables the program writes (parameters, optimizer slots) go
  back into the Scope's tensors with ``copy_`` at the end of the step,
  so their storage never moves, as the JAX Executor's donated buffers
  stay in place.

On the card each key is one CUDA graph, with ``framework/jit.py``'s
``warm`` and ``capture``: the first call of a key (and of the storage of
its persistables, and of ``kernels.plain_versions()``) runs the step op
by op on a side stream (a real step: it loads the kernel libraries and
warms cuBLAS), the second captures it there and replays it, every later
call copies the feeds into the graph's input tensors and replays.
Dropout draws from the device's generator, registered with the graph.
``run_steps`` is K steps in one graph, with the fetches stacked on a
leading K axis and the learning rate read once for the window. On the
CPU, and with ``Executor(use_cuda_graph=False)``, every call runs op by
op. ``cache_stats()`` and ``dispatches`` count as the JAX Executor's do:
a miss is a new key (its passes), a dispatch a call of an entry.

With a run journal active (``obs.journal``), each new key journals a
``compile`` event, each ``run`` one step record
(``record_executor_run``) and each ``run_steps`` one record with
``steps_fused=K`` (``record_fused_run``), from the fetches already on
the host (with ``return_numpy=False`` or ``fetch_async=True`` from
their shapes alone, no device read); with none, one ``None`` check.

Static AMP (``amp.static_decorator``): a program with ``_amp_cfg`` has
each op's floating inputs cast by the white and black lists where the
replay calls the op (``_amp_cast_fn``; a ``@grad`` op follows its
forward op's entry), so on the card the casts are inside the graph; the
loss scaling, the finite check and unscale, the guarded updates and the
scale's update are program ops (``append_amp_backward``,
``append_update_ops``). An optimizer with ``multi_precision`` keeps a
float32 ``<param>@OPT@master`` beside each bfloat16 or float16
parameter, updated in its place.

Raise ``NotImplementedError``, naming their ROADMAP Queue 1 item: data
parallelism, the gradient exchange and sharding plans (item 6c), the
chaos points (item 7), the AOT executable cache (item 8) and the
dataset loops (item 10).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .._device import resolve_device
from ..core.random import default_generator
from ..core.tensor import plain
from ..framework.jit import capture, warm
from ..obs import journal as _journal
from ..obs import metrics as _metrics
from ..ops import kernels
from ..ops.kernels import _route
from ..resilience import inject as _chaos
from .backward import GradFn
from .program import Operator, default_main_program, global_scope

__all__ = ["Executor", "CacheKey", "append_update_ops",
           "build_optimize_ops", "append_amp_backward"]

_M_CACHE_HITS = _metrics.counter("executor.jit_cache.hits")
_M_CACHE_MISSES = _metrics.counter("executor.jit_cache.misses")
_M_DISPATCHES = _metrics.counter("executor.dispatches")
_M_COMPILE_MS = _metrics.histogram("executor.compile_ms")
_M_RUN_MS = _metrics.histogram("executor.run_ms")


# a context around each op of an op-by-op replay, named by the op's type
# (``tools/torch_train_profile.py --config lenet_exec`` sets a profiler
# range here); none by default
OP_RANGE = [None]


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP Queue 1 "
        f"item {item})")


@dataclasses.dataclass(frozen=True)
class CacheKey:
    """The executor cache's key, field for field the JAX package's:
    ``steps`` is None for ``run`` and K for ``run_steps``;
    ``data_parallel``, ``comm`` and ``plan`` stay False/None here (their
    paths are not ported)."""

    program_uid: int
    program_version: int
    feed_names: tuple
    feed_shapes: tuple
    fetch_names: tuple
    optimize_level: int
    steps: int | None
    data_parallel: bool
    allow_replicated_fallback: bool
    comm: tuple | None = None
    plan: tuple | None = None


class _Compiled:
    """A cache entry: the op list to replay, its names, the ``GradFn`` of
    each differentiated forward op (by uid), the program's constants on
    the device, and its CUDA graphs (by persistables' storage)."""

    def __init__(self, ops, feed_names, updated, frozen, fetch_names,
                 consts, amp_cast=None):
        self.ops = ops
        self.amp_cast = amp_cast
        self.feed_names = feed_names
        self.updated = updated
        self.frozen = frozen
        self.fetch_names = fetch_names
        self.consts = consts
        self.differentiated = {op.fn.fwd_uid: op.fn for op in ops
                               if isinstance(op.fn, GradFn)}
        self.graphs = {}


class _Graph:
    """A captured entry: the graph, its feed tensors, its fetches and the
    kernel launches one replay makes."""

    __slots__ = ("graph", "feeds", "fetches", "launches")

    def __init__(self, graph, feeds, fetches, launches):
        self.graph, self.feeds = graph, feeds
        self.fetches, self.launches = fetches, launches


class Executor:
    """``Executor(place=None)``: ``place`` is a device (``cuda`` unless the
    caller asks for ``"cpu"``; raises without a card). ``optimize_level``
    selects the pass pipeline (0 verify only, 1 identity forwarding +
    dead-op elimination, 2 + CSE; default 1). ``use_cuda_graph=False``
    runs every call op by op on the card too."""

    def __init__(self, place=None, optimize_level=None, use_cuda_graph=True):
        import os

        self.place = resolve_device(place)
        self._cache: dict = {}
        if optimize_level is None:
            optimize_level = int(os.environ.get("PADDLE_TPU_OPT_LEVEL", "1"))
        self.optimize_level = int(optimize_level)
        self.use_cuda_graph = bool(use_cuda_graph)
        self.last_diagnostics = None
        self._cache_hits = 0
        self._cache_misses = 0
        self._dispatches = 0
        self._stream = None
        self.captures = 0

    def close(self):
        self._cache.clear()

    @property
    def dispatches(self):
        """Calls of a cache entry so far (``run`` + ``run_steps``); pairs
        with ``cache_stats()['misses']`` (= compiles)."""
        return self._dispatches

    # -- program -> entry ---------------------------------------------------
    def _compile(self, program, feed_shapes, fetch_list, optimize_level,
                 steps, scope):
        from ..analysis import normalize_fetch

        if optimize_level is None:
            optimize_level = self.optimize_level
        feed_names = tuple(sorted(feed_shapes))
        fetch_names, _ = normalize_fetch(fetch_list)
        shapes = tuple(feed_shapes[n] for n in feed_names)
        key = CacheKey(
            program_uid=program._uid, program_version=program._version,
            feed_names=feed_names, feed_shapes=shapes,
            fetch_names=fetch_names, optimize_level=int(optimize_level),
            steps=None if steps is None else int(steps),
            data_parallel=False, allow_replicated_fallback=False)
        if key in self._cache:
            compiled = self._cache[key]
            # uid + version are in the key: a hit is the right program
            # unless Block.ops changed without Program.bump()
            assert compiled.op_count == len(program.global_block.ops), \
                "executor cache incoherent: Block.ops changed without " \
                "Program.bump()"
            self.last_diagnostics = compiled.diagnostics
            self._cache_hits += 1
            _M_CACHE_HITS.inc()
            return compiled
        self._cache_misses += 1
        _M_CACHE_MISSES.inc()
        t0 = time.perf_counter()
        compiled = self._build(program, feed_names, fetch_names, shapes,
                               fetch_list, optimize_level, steps, scope)
        compile_ms = (time.perf_counter() - t0) * 1e3
        _M_COMPILE_MS.observe(compile_ms)
        if _journal.ACTIVE is not None:
            extra = {"steps_fused": int(steps)} if steps else {}
            _journal.ACTIVE.event(
                "compile", uid=program._uid, version=program._version,
                optimize_level=int(optimize_level), ms=compile_ms,
                source="executor", **extra)
        self._cache[key] = compiled
        return compiled

    def _build(self, program, feed_names, fetch_names, shapes, fetch_list,
               optimize_level, steps, scope):
        from ..analysis import run_compile_passes

        blk = program.global_block
        persist_in = tuple(v.name for v in blk.vars.values()
                           if v.persistable
                           and scope.find_var(v.name) is not None)
        for n in persist_in:
            dev = scope.find_var(n).device
            if dev != self.place:
                raise ValueError(f"persistable '{n}' lies on {dev}, the "
                                 f"Executor runs on {self.place}")
        ops, report = run_compile_passes(
            program, fetch_list=fetch_list,
            feed_shapes=dict(zip(feed_names, shapes)),
            scope_names=set(persist_in), optimize_level=optimize_level)
        self.last_diagnostics = report
        written = set()
        for op in ops:
            written.update(op.output_names)
        updated = tuple(n for n in persist_in if n in written)
        frozen = tuple(n for n in persist_in if n not in written)
        consts = {n: c.to(self.place)
                  for n, c in program._constants.items()}
        amp_cast = _amp_cast_fn(getattr(program, "_amp_cfg", None))
        compiled = _Compiled(ops, feed_names, updated, frozen, fetch_names,
                             consts, amp_cast)
        compiled.program_uid = program._uid
        compiled.program_version = program._version
        compiled.op_count = len(blk.ops)  # pre-optimization: mirrors _version
        compiled.diagnostics = report
        compiled.optimize_level = int(optimize_level)
        compiled.steps = None if steps is None else int(steps)
        compiled.feed_dtypes = {n: blk.var(n).dtype for n in feed_names
                                if blk.has_var(n) and blk.var(n).is_data}
        # examples a step for the journal: the largest leading feed dim
        lead = [sh[0] for sh, _ in shapes if len(sh) >= 1 and sh[0] > 0]
        compiled.examples_hint = max(lead) if lead else None
        return compiled

    def cache_stats(self, per_entry=False):
        """Hit/miss/size of this executor's cache; ``per_entry=True`` adds
        ``dispatches`` and an ``entries`` list (program uid/version,
        optimize level, feeds, fused steps; the JAX Executor's memory and
        FLOP attribution from XLA is not measured here: None)."""
        out = {"hits": self._cache_hits, "misses": self._cache_misses,
               "size": len(self._cache)}
        if per_entry:
            out["dispatches"] = self._dispatches
            out["entries"] = [{
                "program_uid": c.program_uid,
                "program_version": c.program_version,
                "optimize_level": c.optimize_level,
                "feed_names": list(c.feed_names),
                "memory_bytes": None, "memory": None, "flops": None,
                "collectives": None, "mesh": None,
                "steps_fused": c.steps} for c in self._cache.values()]
        return out

    # -- the replay -----------------------------------------------------------
    @staticmethod
    def _run_ops(compiled, env):
        """Replay the entry's ops over a name -> tensor environment."""
        saved = {}
        for op in compiled.ops:
            if OP_RANGE[0] is None:
                Executor._run_op(op, env, saved, compiled)
            else:
                with OP_RANGE[0](op.type):
                    Executor._run_op(op, env, saved, compiled)
        return env

    @staticmethod
    def _run_op(op, env, saved, compiled):
        """One op: a ``@grad`` op from its forward's saved graph (``saved``:
        forward uid -> (inputs, outputs)), a differentiated forward op on
        detached inputs with its graph kept, any other op as it is."""
        args = [env[n] if n is not None else None for n in op.input_names]
        if compiled.amp_cast is not None:
            args = compiled.amp_cast(op.type, args)
        fn = op.fn
        if isinstance(fn, GradFn):
            got = saved.pop(fn.fwd_uid, None)
            # a forward op a pass removed: differentiate it afresh
            out = (fn.apply(*got, args[fn.n_inputs:]) if got is not None
                   else fn(*args))
        elif op.uid in compiled.differentiated:
            # the op's own function and attrs (a clone's may differ)
            leaves = compiled.differentiated[op.uid].leaves(args)
            with torch.enable_grad():
                out = fn(*leaves, **op.attrs)
            saved[op.uid] = (leaves, out)
        else:
            out = fn(*args, **op.attrs)
        if isinstance(out, (tuple, list)):
            env.update(zip(op.output_names, out))
        else:
            env[op.output_names[0]] = out

    def _step(self, compiled, feeds, scope):
        """One step on device tensors: runs the ops, writes the updated
        persistables into the Scope's storage, returns the fetches."""
        env = dict(compiled.consts)
        env.update(zip(compiled.feed_names, feeds))
        for n in compiled.updated + compiled.frozen:
            env[n] = scope.find_var(n)
        with torch.no_grad():
            self._run_ops(compiled, env)
            for n in compiled.updated:
                dst = scope.find_var(n)
                if env[n] is not dst:
                    dst.copy_(env[n])
            return [env[n].detach() for n in compiled.fetch_names]

    def _body(self, compiled, feeds, scope, K):
        """One step (``K`` None) or K steps over stacked feeds."""
        if K is None:
            return self._step(compiled, feeds, scope)
        outs = [self._step(compiled, [f[k] for f in feeds], scope)
                for k in range(K)]
        return [torch.stack(col) for col in zip(*outs)]

    def _dispatch(self, compiled, feeds, scope, K):
        """A call of ``compiled``: op by op, or through its CUDA graph."""
        self._dispatches += 1
        _M_DISPATCHES.inc()
        if self.place.type != "cuda" or not self.use_cuda_graph:
            return self._body(compiled, feeds, scope, K)
        storage = tuple(scope.find_var(n).data_ptr()
                        for n in compiled.updated + compiled.frozen)
        gkey = (storage, _route.forced())
        if gkey not in compiled.graphs:
            # graphs of storage that has moved can never replay again
            compiled.graphs = {k: g for k, g in compiled.graphs.items()
                               if k[0] == storage}
            compiled.graphs[gkey] = None
            out = warm(self._side_stream(),
                       lambda: self._body(compiled, feeds, scope, K))
            for t in out:
                t.record_stream(torch.cuda.current_stream())
            return out
        entry = compiled.graphs[gkey]
        if entry is None:
            static = [torch.empty_like(f) for f in feeds]
            graph, fetches, launched = capture(
                self._side_stream(),
                lambda: self._body(compiled, static, scope, K),
                [default_generator(self.place)])
            entry = compiled.graphs[gkey] = _Graph(graph, static, fetches,
                                                   launched)
            self.captures += 1
        for dst, src in zip(entry.feeds, feeds):
            dst.copy_(src)
        entry.graph.replay()
        kernels.add_launches(entry.launches)
        return [f.clone() for f in entry.fetches]

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.place)
        return self._stream

    # -- feeds and fetches ----------------------------------------------------
    @staticmethod
    def _shape_dtype(v):
        if isinstance(v, torch.Tensor):
            return tuple(v.shape), str(v.dtype).replace("torch.", "")
        a = np.asarray(v)
        return tuple(a.shape), str(a.dtype)

    def _as_device(self, v, dtype=None):
        t = plain(v) if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.require(np.asarray(v), requirements="C"))
        return t.to(device=self.place, dtype=dtype or t.dtype)

    @staticmethod
    def _unwrap_program(program):
        from .compiler import CompiledProgram

        if program is None:
            program = default_main_program()
        if isinstance(program, CompiledProgram):
            if program._data_parallel:
                raise _not_ported("data-parallel CompiledProgram", "6c")
            program = program._program
        if getattr(program, "_transpiled_dp", False):
            raise _not_ported("a transpiled data-parallel program", "6c")
        return program

    @staticmethod
    def _no_chaos():
        if _chaos.ACTIVE:
            raise _not_ported("the Executor's chaos points", 7)

    @staticmethod
    def _materialize(fetches, return_numpy, fetch_async):
        if fetch_async or not return_numpy:
            return list(fetches)
        return [f.cpu().numpy() for f in fetches]

    # -- public API -----------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name=None, fetch_var_name=None, scope=None,
            return_numpy=True, use_program_cache=True, optimize_level=None,
            fetch_async=False):
        """Run ``program`` once (ref: executor.py Executor.run): feeds in,
        the fetched values out (numpy by default; tensors on the device
        with ``return_numpy=False`` or ``fetch_async=True``). The verifier
        always runs at a key's first call; ``optimize_level`` (None: the
        Executor's) selects the passes. A program with no op (a startup
        program: parameters are made when the layers are built) returns
        ``[]``."""
        program = self._unwrap_program(program)
        self._no_chaos()
        feed = dict(feed or {})
        fetch_list = fetch_list or []
        scope = scope or global_scope()
        if not program.global_block.ops:
            return []
        if program._lr_getter is not None:
            feed["@lr"] = np.asarray(program._lr_getter(), np.float32)
        t0 = time.perf_counter()
        compiled = self._compile(
            program, {n: self._shape_dtype(v) for n, v in feed.items()},
            fetch_list, optimize_level, None, scope)
        feeds = [self._as_device(feed[n], compiled.feed_dtypes.get(n))
                 for n in compiled.feed_names]
        out = self._materialize(self._dispatch(compiled, feeds, scope, None),
                                return_numpy, fetch_async)
        run_ms = (time.perf_counter() - t0) * 1e3
        _M_RUN_MS.observe(run_ms)
        if _journal.ACTIVE is not None:
            _journal.ACTIVE.record_executor_run(
                compiled, out, run_ms,
                synced=bool(return_numpy) and not fetch_async)
        return out

    def run_steps(self, program=None, feeds=None, fetch_list=None,
                  steps=None, scope=None, return_numpy=True,
                  fetch_async=False, optimize_level=None):
        """Run K steps as one call (one CUDA graph on the card).

        ``feeds`` is a sequence of K per-step feed dicts of one signature,
        or one dict of arrays with a leading axis of K (then ``steps=K``
        is needed). Each fetch comes back stacked on a leading K axis:
        element ``[k]`` is what the k-th of K sequential ``run`` calls
        fetches. The learning rate is read once for the window."""
        program = self._unwrap_program(program)
        self._no_chaos()
        fetch_list = fetch_list or []
        scope = scope or global_scope()

        def host(v):
            return v if isinstance(v, torch.Tensor) else \
                torch.from_numpy(np.require(np.asarray(v),
                                            requirements="C"))

        if isinstance(feeds, dict):
            if not steps:
                raise ValueError(
                    "run_steps with a pre-stacked feed dict needs an "
                    "explicit steps=K (the leading axis length)")
            K = int(steps)
            stacked = {n: host(v) for n, v in feeds.items()}
            for n, v in stacked.items():
                if v.dim() < 1 or v.shape[0] != K:
                    raise ValueError(
                        f"pre-stacked feed {n!r} has shape "
                        f"{tuple(v.shape)}; expected a leading microbatch "
                        f"axis of {K}")
        else:
            feeds = list(feeds or ())
            if not feeds:
                raise ValueError("run_steps needs at least one feed dict")
            K = int(steps) if steps else len(feeds)
            if K != len(feeds):
                raise ValueError(
                    f"steps={K} but {len(feeds)} feed dicts were given")
            names = sorted(feeds[0])
            for f in feeds[1:]:
                if sorted(f) != names:
                    raise ValueError(
                        "every microbatch must feed the same variables; "
                        f"got {sorted(f)} vs {names}")
            stacked = {n: torch.stack([host(f[n]) for f in feeds])
                       for n in names}
        if K <= 0:
            raise ValueError(f"steps must be >= 1, got {K}")
        if not program.global_block.ops:
            return []
        if program._lr_getter is not None:
            lr = torch.tensor(np.float32(program._lr_getter()))
            stacked["@lr"] = lr.expand(K).clone()
        t0 = time.perf_counter()
        per_step = {n: (tuple(v.shape[1:]),
                        str(v.dtype).replace("torch.", ""))
                    for n, v in stacked.items()}
        compiled = self._compile(program, per_step, fetch_list,
                                 optimize_level, K, scope)
        feeds = [self._as_device(stacked[n], compiled.feed_dtypes.get(n))
                 for n in compiled.feed_names]
        out = self._materialize(self._dispatch(compiled, feeds, scope, K),
                                return_numpy, fetch_async)
        run_ms = (time.perf_counter() - t0) * 1e3
        _M_RUN_MS.observe(run_ms)
        if _journal.ACTIVE is not None:
            _journal.ACTIVE.record_fused_run(
                compiled, out, run_ms, steps=K,
                synced=bool(return_numpy) and not fetch_async)
        return out

    def train_from_dataset(self, *args, **kwargs):
        raise _not_ported("Executor.train_from_dataset", 10)

    def infer_from_dataset(self, *args, **kwargs):
        raise _not_ported("Executor.infer_from_dataset", 10)


def _amp_cast_fn(amp_cfg):
    """The list-driven cast of a static AMP program (the counterpart of
    the JAX Executor's ``_amp_cast_fn``, ``executor.py:1347-1375``, and
    of the reference's cast-op insertion, ``fp16_utils.py``
    ``rewrite_program``): a white-listed op's floating inputs go to the
    half type, a black-listed op's to float32; a ``<type>@grad`` op
    follows its forward op's entry, so its cotangents meet the forward
    in the same types. None for a program without AMP."""
    if not amp_cfg:
        return None
    wl = amp_cfg["lists"].white_list
    bl = amp_cfg["lists"].black_list
    half = torch.bfloat16 if amp_cfg["dtype"] == "bfloat16" \
        else torch.float16

    def amp_cast(op_type, args):
        base = op_type[:-5] if op_type.endswith("@grad") else op_type
        if base in wl:
            dt = half
        elif base in bl:
            dt = torch.float32
        else:
            return args
        return [a.to(dt) if isinstance(a, torch.Tensor)
                and a.is_floating_point() else a for a in args]

    return amp_cast


def _amp_scale_loss(loss, scale):
    return loss * scale.to(loss.dtype)


def append_amp_backward(amp_decorator, loss, parameter_list=None):
    """The AMP backward phase (ref: ``decorator.py`` backward and
    ``amp_nn.py`` ``check_finite_and_unscale``; JAX ``executor.py``
    :1377-1427): the persistable scale state, an op scaling the loss, the
    grad ops, then one op that checks every gradient for an inf or a NaN
    and unscales it to float32. Returns ``([(param, unscaled grad)],
    found-inf variable name)``."""
    from .backward import append_backward

    program = default_main_program()
    blk = program.global_block
    scope = global_scope()
    program._amp_cfg = {"dtype": amp_decorator._dtype,
                        "lists": amp_decorator._amp_lists}

    if not blk.has_var("@amp@scale"):
        device = next((scope.find_var(v.name).device
                       for v in blk.vars.values() if v.is_parameter
                       and scope.find_var(v.name) is not None), None)
        if device is None:
            raise ValueError("the program has no parameter in the global "
                             "scope to place the loss scale beside")
        init = {"@amp@scale": (amp_decorator._init_loss_scaling,
                               torch.float32),
                "@amp@good": (0, torch.int32), "@amp@bad": (0, torch.int32)}
        for name, (value, dtype) in init.items():
            blk.create_var(name=name, shape=(), dtype=dtype,
                           persistable=True)
            scope.set(name, torch.tensor(value, dtype=dtype, device=device))

    sname = loss.name + "@SCALED"
    with torch._C.DisableTorchFunction():
        shape, dtype = tuple(loss.shape), loss.dtype
    sv = blk.create_var(name=sname, shape=shape, dtype=dtype,
                        stop_gradient=False)
    blk.append_op(Operator("amp_scale_loss", _amp_scale_loss,
                           [loss.name, "@amp@scale"], [sname], {}))
    amp_decorator._scaled_loss = sv

    params_grads = append_backward(sv, parameter_list=parameter_list)

    gnames = [g.name for _, g in params_grads]
    fi = "@amp@found_inf"
    if not blk.has_var(fi):
        blk.create_var(name=fi, shape=(), dtype="bool")
    out_names = [n + "@UNSCALED" for n in gnames]
    for (_, g), on in zip(params_grads, out_names):
        with torch._C.DisableTorchFunction():
            shape = tuple(g.shape)
        blk.create_var(name=on, shape=shape, dtype="float32")
    blk.append_op(Operator(
        "amp_check_finite_and_unscale",
        amp_decorator.check_and_unscale_rule,
        ["@amp@scale"] + gnames, [fi] + out_names, {}))
    program.bump()
    return ([(p, blk.var(on)) for (p, _), on in
             zip(params_grads, out_names)], fi)


class _UpdateFn:
    """The function of an ``optimize_<opt>`` op: one parameter's update,
    as ``Optimizer._apply`` makes it (the gradient in the updated value's
    type, the regularizer, the parameter's learning-rate ratio), from
    ``(param, grad, lr[, found_inf], *slots)`` to ``(new param, *new
    slots)``. With a ``master`` slot the update runs on the float32
    master and the parameter is the new master rounded to its type;
    with ``found_inf`` (static AMP) a set flag leaves the parameter and
    every slot as they were (ref: ``update_loss_scaling``'s skip)."""

    __slots__ = ("opt", "name", "reg", "ratio", "skeys", "guarded")

    def __init__(self, opt, name, reg, ratio, skeys, guarded=False):
        self.opt, self.name, self.reg = opt, name, reg
        self.ratio, self.skeys = ratio, skeys
        self.guarded = guarded

    def __call__(self, p, g, lr, *rest):
        from ..optim.optimizer import AdamW

        found, slots = (rest[0], rest[1:]) if self.guarded else (None, rest)
        s = dict(zip(self.skeys, slots))
        master = s.get("master")
        pw = p if master is None else master
        g = g.to(pw.dtype)
        if self.reg is not None and not isinstance(self.opt, AdamW):
            g = self.reg(pw, g)
        if self.ratio != 1.0:
            lr = lr * self.ratio
        new_w, new_s = self.opt._update(self.name, pw, g, s, lr, {})
        new_s = {k: new_s.get(k, s[k]) for k in self.skeys}
        if master is not None:
            new_s["master"] = new_w
        new_p = new_w.to(p.dtype)
        if found is not None:
            new_p = torch.where(found, p, new_p)
            new_s = {k: torch.where(found, s[k], v)
                     for k, v in new_s.items()}
        return (new_p, *[new_s[k] for k in self.skeys])


class _ClipFn:
    """The function of the ``grad_clip`` op: the optimizer's clip over
    ``[(param Variable, grad)]`` (the Variable carries ``need_clip``)."""

    __slots__ = ("clip", "params")

    def __init__(self, clip, params):
        self.clip, self.params = clip, params

    def __call__(self, *grads):
        return tuple(g for _, g in self.clip(list(zip(self.params, grads))))


def append_update_ops(optimizer, params_grads, amp_decorator=None,
                      found_inf_name=None):
    """Append the clip op and one ``optimize_<opt>`` op a parameter (the
    update phase of the reference's ``Optimizer.minimize`` /
    ``apply_gradients``). Each parameter's state lives in persistables
    ``<param>@OPT@<slot>``, made in ``global_scope()`` beside the
    parameter (with ``multi_precision``, a float32 ``master`` slot for a
    bfloat16 or float16 parameter, and the other slots in float32, as
    ``Optimizer._state_for`` makes them); the learning rate is the fed
    scalar ``@lr``, read from ``optimizer.get_lr`` at each run. With an
    AMP decorator every update reads the found-inf flag, and with its
    dynamic loss scaling one more op advances the scale's state."""
    program = default_main_program()
    blk = program.global_block
    scope = global_scope()

    if optimizer._grad_clip is not None:
        gnames = [g.name for _, g in params_grads]
        out_names = [n + "@CLIPPED" for n in gnames]
        for (_, g), on in zip(params_grads, out_names):
            with torch._C.DisableTorchFunction():
                shape, dtype = tuple(g.shape), g.dtype
            blk.create_var(name=on, shape=shape, dtype=dtype)
        blk.append_op(Operator(
            "grad_clip",
            _ClipFn(optimizer._grad_clip, [p for p, _ in params_grads]),
            gnames, out_names, {}))
        params_grads = [(p, blk.var(on)) for (p, _), on in
                        zip(params_grads, out_names)]

    if not blk.has_var("@lr"):
        blk.create_var(name="@lr", shape=(), dtype="float32", is_data=True)
    program._lr_getter = optimizer.get_lr

    for p, g in params_grads:
        value = scope.find_var(p.name)
        if value is None:
            raise ValueError(f"parameter '{p.name}' has no value in the "
                             "global scope")
        state = optimizer._init_state(value)
        if optimizer._multi_precision and value.dtype in (torch.bfloat16,
                                                          torch.float16):
            state = {k: v.float() for k, v in state.items()}
            state["master"] = value.detach().float()
        skeys = sorted(state)
        sname = {k: f"{p.name}@OPT@{k}" for k in skeys}
        for k in skeys:
            blk.create_var(name=sname[k], shape=tuple(state[k].shape),
                           dtype=state[k].dtype, persistable=True)
            scope.set(sname[k], state[k])
        reg = getattr(p, "regularizer", None) or optimizer._regularization
        ratio = p.optimize_attr.get("learning_rate", 1.0)
        amp_in = [found_inf_name] if amp_decorator is not None else []
        blk.append_op(Operator(
            "optimize_" + type(optimizer).__name__.lower(),
            _UpdateFn(optimizer, p.name, reg, ratio, skeys,
                      guarded=amp_decorator is not None),
            [p.name, g.name, "@lr"] + amp_in + [sname[k] for k in skeys],
            [p.name] + [sname[k] for k in skeys], {}))
    if amp_decorator is not None and amp_decorator._use_dynamic:
        blk.append_op(Operator(
            "amp_update_loss_scaling", amp_decorator.update_scaling_rule,
            ["@amp@scale", "@amp@good", "@amp@bad", found_inf_name],
            ["@amp@scale", "@amp@good", "@amp@bad"], {}))
    program.bump()


def build_optimize_ops(optimizer, loss, parameter_list=None):
    """Append backward + optimizer-update ops to the current program (ref:
    ``Optimizer.minimize``'s static path in ``fluid/optimizer.py``)."""
    from .backward import append_backward

    params_grads = append_backward(loss, parameter_list=parameter_list)
    append_update_ops(optimizer, params_grads)
    return None, params_grads
