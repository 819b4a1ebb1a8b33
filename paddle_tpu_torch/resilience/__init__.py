"""paddle_tpu_torch.resilience: bounded retry, chaos points, replica
supervision.

- ``policy``: ``TransientError``, ``RecoveryPolicy``, ``retry_call`` —
  the serve engine relieves KV-page pressure through ``retry_call``;
- ``inject``: the chaos registry and the ``replica_kill`` point the
  serve loop fires;
- ``elastic``: ``Heartbeat`` and ``ReplicaSupervisor``, the serve
  fleet's liveness beacon and relaunch budget.

The JAX package's training guards and elastic gang supervisor are not
ported yet.
"""
from . import elastic, inject, policy
from .elastic import ElasticBudgetError, Heartbeat, ReplicaSupervisor
from .policy import RecoveryPolicy, TransientError, retry_call

__all__ = ["elastic", "inject", "policy", "ElasticBudgetError",
           "Heartbeat", "ReplicaSupervisor", "RecoveryPolicy",
           "TransientError", "retry_call"]
