"""paddle_tpu_torch.serving.fleet: multi-replica serve router, SLO-aware
autoscaling, elastic replica supervision — the PyTorch/CUDA counterpart
of ``paddle_tpu.serving.fleet``.

N continuous-batching ``ServeEngine`` replicas, each on the CUDA card
(its decode through the paged decode kernel), behind a load-aware
:class:`~.router.Router` with per-tenant fairness + rate limits;
replica processes heartbeat-watched and relaunched under a
``resilience.ReplicaSupervisor`` budget, journaling per-rank and
exporting live SLO gauges; an :class:`~.autoscale.Autoscaler`
consuming that scrape to drive scale-up / drain-based scale-down.

- ``router.Router`` — least-outstanding-tokens dispatch, tenant
  fairness/rate limits, arrival-order requeue on replica death;
  deterministic under an injectable clock.
- ``pool.ReplicaPool`` / ``ReplicaSpec`` — in-process or worker-process
  replicas with heartbeats, per-rank journals, per-replica ``/metrics``.
- ``autoscale.Autoscaler`` — hysteresis + cooldown over queue-depth and
  TTFT/TPOT p99 signals in the Prometheus scrape format.
- ``worker`` — the replica process entry
  (``python -m paddle_tpu_torch.serving.fleet.worker``).
- ``drill`` — the kill-a-replica-mid-decode acceptance drill.

The trace bench over a fleet is ``tools/torch_serve_bench.py
--replicas N`` and the kill drill ``tools/torch_chaos_run.py
replica_kill``; its journals render through
``tools/torch_{fleet,request,slo,usage,run}_report.py``. Not here yet:
the JAX package's shared AOT executable cache
(``ReplicaSpec.aot_cache_dir`` raises).
"""
from .autoscale import Autoscaler
from .pool import LocalReplica, ProcessReplica, ReplicaPool, ReplicaSpec
from .router import FleetRequest, Router, TenantPolicy, TokenBucket

__all__ = [
    "Router", "FleetRequest", "TenantPolicy", "TokenBucket",
    "ReplicaPool", "ReplicaSpec", "LocalReplica", "ProcessReplica",
    "Autoscaler",
]
