"""Predictor: a saved inference program, replayed as one CUDA graph per
feed signature.

The counterpart of ``paddle_tpu/inference/predictor.py`` (ref:
paddle/fluid/inference/api/analysis_predictor.h:82 AnalysisPredictor,
paddle_infer::Config/Predictor). The JAX Predictor replays the loaded
program into one function and compiles it with ``jax.jit`` once per
feed signature (shapes and dtypes), with the weights snapshotted at
construction and passed as arguments. Here:

- the weights are cloned onto the Predictor's device at construction,
  so a later load into the global scope cannot change them;
- a batch is padded up to its bucket (``Config.buckets``) and the
  padding sliced off every fetch that kept the batch axis, so ragged
  batch sizes share a few signatures;
- on the card each signature is one CUDA graph, kept by a
  ``framework.ProgramCache`` (the graphed decodes' cache): its first
  call runs the ops in order on a side stream (``framework.jit.warm``:
  it loads kernel libraries and warms cuBLAS and cuDNN), captures them
  there (``framework.jit.capture``) and replays; every later call copies
  the feeds into the graph's input tensors and replays. On the CPU, and
  with ``Config(use_cuda_graph=False)``, every call runs the ops in
  order.

``cache_stats()`` counts as the JAX Predictor's does: a miss is a new
signature, a hit a call of a known one; ``dispatches`` counts calls and
``captures`` the graphs captured. The ``predictor.*`` metrics and the
``predictor.compile``/``predictor.run`` spans are the JAX package's.
With a run journal active, a new signature journals a ``compile`` event
and each ``run`` one step record with ``source="predictor"`` and the
caller's batch as its examples (``RunJournal.record_executor_run``).

Not ported: the AOT executable cache (``Config.aot_cache_dir``, ROADMAP
Queue 1 item 8).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..framework.jit import ProgramCache
from ..obs import journal as _journal
from ..obs import metrics as _metrics
from ..obs import trace as _trace

__all__ = ["Config", "Predictor", "create_predictor"]

# process-wide mirrors of the per-instance cache stats, as the JAX
# package's
_M_HITS = _metrics.counter("predictor.jit_cache.hits")
_M_MISSES = _metrics.counter("predictor.jit_cache.misses")
_M_DISPATCHES = _metrics.counter("predictor.dispatches")
_M_RUN_MS = _metrics.histogram("predictor.run_ms")


class Config:
    """ref: paddle_infer.Config: the bundle's prefix and the knobs.
    ``device``: the card unless ``"cpu"`` is asked for (the Predictor
    raises without a card). ``use_cuda_graph=False`` runs every call op
    by op on the card too."""

    def __init__(self, model_prefix=None, device=None, use_cuda_graph=True):
        self.model_prefix = model_prefix
        self.device = device
        self.use_cuda_graph = bool(use_cuda_graph)
        self.batch_bucketing = True
        self.buckets = (1, 2, 4, 8, 16, 32, 64, 128, 256)

    @property
    def aot_cache_dir(self):
        """Always None: the AOT executable cache is not ported."""
        return None

    @aot_cache_dir.setter
    def aot_cache_dir(self, value):
        if value is not None:
            raise NotImplementedError(
                "Config.aot_cache_dir: the AOT executable cache is not "
                "ported to paddle_tpu_torch yet (ROADMAP Queue 1 item 8)")

    def disable_batch_bucketing(self):
        self.batch_bucketing = False

    def set_buckets(self, buckets):
        self.buckets = tuple(sorted(int(b) for b in buckets))


class Predictor:
    """Run a saved inference model (ref: AnalysisPredictor).

    >>> pred = Predictor("/tmp/model")            # prefix from
    ...                                           # save_inference_model
    >>> out, = pred.run({"x": np.zeros((4, 784), "float32")})
    """

    def __init__(self, config_or_prefix):
        from ..framework.io import load_inference_model
        from ..static_.program import global_scope

        cfg = config_or_prefix if isinstance(config_or_prefix, Config) \
            else Config(str(config_or_prefix))
        if cfg.model_prefix is None:
            raise ValueError("Config.model_prefix not set")
        self._config = cfg
        self.device = resolve_device(cfg.device)
        program, feed_names, fetch_names = load_inference_model(
            cfg.model_prefix, device=self.device)
        self._program = program
        self._feed_names = list(feed_names)
        self._fetch_names = list(fetch_names)
        blk = program.global_block
        self._feed_dtypes = [blk.var(n).dtype if blk.has_var(n) else None
                             for n in self._feed_names]
        # snapshot the weights now: later loads into the global scope must
        # not be able to change this predictor
        scope = global_scope()
        self._weight_names = tuple(
            v.name for v in blk.vars.values()
            if v.persistable and scope.find_var(v.name) is not None)
        self._weights = [scope.find_var(n).detach().to(self.device).clone()
                         for n in self._weight_names]
        # the snapshot as a module: ProgramCache keys its graphs on the
        # storage of a module's parameters
        self._params = torch.nn.ParameterList(
            torch.nn.Parameter(w, requires_grad=False)
            for w in self._weights)
        self._consts = {n: c.to(self.device)
                        for n, c in program._constants.items()}
        self._ops = list(blk.ops)
        self._compiled = set()      # feed signatures seen
        self._graphs = ProgramCache()
        self._cache_hits = 0
        self._cache_misses = 0
        self._dispatches = 0

    # -- introspection (ref: PaddlePredictor::GetInputNames) ----------------
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    # -- the replay -----------------------------------------------------------
    def _replay(self, feeds):
        """The program's ops in order over the feeds, the snapshot weights
        and the constants: the fetches."""
        env = dict(self._consts)
        env.update(zip(self._weight_names, self._weights))
        env.update(zip(self._feed_names, feeds))
        with torch.no_grad():
            for op in self._ops:
                args = [env[n] if n is not None else None
                        for n in op.input_names]
                out = op.fn(*args, **op.attrs)
                if isinstance(out, (tuple, list)):
                    env.update(zip(op.output_names, out))
                else:
                    env[op.output_names[0]] = out
        return [env[n] for n in self._fetch_names]

    def _dispatch(self, sig, feeds):
        """A call of signature ``sig``: through its CUDA graph, or op by
        op."""
        self._dispatches += 1
        _M_DISPATCHES.inc()
        if self.device.type != "cuda" or not self._config.use_cuda_graph:
            return self._replay(feeds)
        return list(self._graphs(self._params, sig,
                                 lambda *a: tuple(self._replay(a[:-1])),
                                 feeds))

    @property
    def captures(self):
        """CUDA graphs captured: one per signature (and per
        ``kernels.plain_versions()`` state) on the card, else none."""
        graphed = self.device.type == "cuda" and self._config.use_cuda_graph
        return len(self._graphs) if graphed else 0

    def _bucket(self, b):
        for cap in self._config.buckets:
            if b <= cap:
                return cap
        return b

    def run(self, feed, return_numpy=True):
        """``feed``: dict name -> array or tensor, or a list in
        ``get_input_names()`` order. Returns the fetches, numpy arrays
        (or tensors on the device with ``return_numpy=False``)."""
        if not isinstance(feed, dict):
            feed = dict(zip(self._feed_names, feed))
        missing = [n for n in self._feed_names if n not in feed]
        if missing:  # before indexing, or a bare KeyError beats us to it
            raise KeyError(f"missing feeds {missing}")
        arrays = [feed[n] if isinstance(feed[n], torch.Tensor)
                  else torch.from_numpy(np.require(np.asarray(feed[n]),
                                                   requirements="C"))
                  for n in self._feed_names]
        B = arrays[0].shape[0] if arrays and arrays[0].dim() else None
        pad_to = None
        if (self._config.batch_bucketing and B is not None
                and all(a.dim() and a.shape[0] == B for a in arrays)):
            cap = self._bucket(B)
            if cap != B:
                pad_to = cap
                arrays = [torch.cat([a, a.new_zeros((cap - B,)
                                                    + tuple(a.shape[1:]))])
                          for a in arrays]
        feeds = [a.to(device=self.device, dtype=dt or a.dtype)
                 for a, dt in zip(arrays, self._feed_dtypes)]
        sig = tuple((tuple(f.shape), str(f.dtype)) for f in feeds)
        if sig not in self._compiled:
            self._cache_misses += 1
            _M_MISSES.inc()
            with _trace.span("predictor.compile", uid=self._program._uid,
                             signature=len(self._compiled)):
                self._compiled.add(sig)
            if _journal.ACTIVE is not None:
                _journal.ACTIVE.event(
                    "compile", source="predictor", uid=self._program._uid,
                    version=self._program._version, ms=0.0)
        else:
            self._cache_hits += 1
            _M_HITS.inc()
        t0 = time.perf_counter()
        with _trace.span("predictor.run", uid=self._program._uid):
            outs = self._dispatch(sig, feeds)
        run_ms = (time.perf_counter() - t0) * 1e3
        _M_RUN_MS.observe(run_ms)
        if pad_to is not None:
            # slice padding back off any fetch that kept the batch dim
            outs = [o[:B] if o.dim() and o.shape[0] == pad_to else o
                    for o in outs]
        if return_numpy:
            outs = [o.cpu().numpy() for o in outs]
        if _journal.ACTIVE is not None:
            # from the fetches as the caller gets them (host arrays, or
            # device tensors summarized by shape alone); B is the batch
            # before bucket padding
            _journal.ACTIVE.record_executor_run(
                self, outs, run_ms, synced=return_numpy,
                source="predictor", examples=B)
        return outs

    __call__ = run

    @property
    def dispatches(self):
        """Calls of a signature's entry across ``run`` calls (the
        Executor's ``dispatches`` contract)."""
        return self._dispatches

    def cache_stats(self, per_entry=False):
        """Hit/miss/size of this predictor's signature cache, in the
        dict shape ``Executor.cache_stats`` has; ``per_entry=True`` adds
        ``dispatches``, ``captures`` and an ``entries`` list with the
        Executor's fields. The JAX package fills ``memory`` and ``flops``
        from XLA's cost analysis of the compiled executable; a CUDA graph
        has no such analysis, so they are None here."""
        out = {"hits": self._cache_hits, "misses": self._cache_misses,
               "size": len(self._compiled)}
        if per_entry:
            out["dispatches"] = self._dispatches
            out["captures"] = self.captures
            out["entries"] = [{
                "program_uid": self._program._uid,
                "program_version": self._program._version,
                "optimize_level": 0,
                "feed_names": list(self._feed_names),
                "memory_bytes": None, "memory": None, "flops": None,
                "collectives": None, "mesh": None, "steps_fused": None}
                for _ in self._compiled]
        return out


def create_predictor(config):
    """ref: paddle_infer.create_predictor."""
    return Predictor(config)
