"""paddle_tpu_torch.serving: paged KV cache, continuous batching,
per-request observability — the PyTorch/CUDA counterpart of
``paddle_tpu.serving``.

- ``kv_cache.PagedKVCache``: fixed-size pages from one preallocated
  device pool, written in place; host-side free list; per-sequence page
  tables; strict alloc==free accounting.
- ``ops/kernels/paged_attention.paged_decode_attention``: the ragged
  paged decode kernel, hand-written CUDA C++ for Hopper (one kernel for
  the whole mixed batch, K/V gathered through the page tables).
- ``scheduler.Scheduler``: continuous batching — token-budget
  admission, prefill/decode interleaving, preemption by page pressure
  with arrival-order requeue, deterministic under an injectable clock.
- ``engine.ServeEngine``: the serve loop tying them together, with
  ``serving.*`` metrics, lifecycle trace spans, and journal ``request``
  records.

The multi-replica layer lives in ``serving.fleet``: a load-aware
``Router`` over a ``ReplicaPool`` of engines (in-process or worker
processes), per-tenant fairness + rate limits, SLO-driven
``Autoscaler``, and elastic replica relaunch — see that package's
docstring.
"""
from .kv_cache import (CachePressureError, PageAllocationError,
                       PagedKVCache, write_tokens)
from .scheduler import (Batch, ManualClock, Request, Scheduler,
                        QUEUED, RUNNING, PREEMPTED, FINISHED, CANCELLED)
from .engine import (ServeEngine, TinyLM, live_engines, preempt_loss_ms,
                     request_phases)
from . import fleet  # noqa: F401  (serving.fleet.Router et al.)

__all__ = [
    "PagedKVCache", "PageAllocationError", "CachePressureError",
    "write_tokens",
    "Scheduler", "Request", "Batch", "ManualClock",
    "QUEUED", "RUNNING", "PREEMPTED", "FINISHED", "CANCELLED",
    "ServeEngine", "TinyLM", "live_engines", "preempt_loss_ms",
    "request_phases", "fleet",
]
