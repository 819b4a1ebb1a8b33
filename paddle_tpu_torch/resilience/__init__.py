"""paddle_tpu_torch.resilience: fault injection and recovery.

- ``policy``: ``TransientError``, ``RecoveryPolicy``, ``retry_call`` —
  the serve engine relieves KV-page pressure through ``retry_call``;
- ``inject``: the chaos registry — ``nan_feed``, ``transient_execute``,
  the ``ckpt_*`` checkpoint faults and ``replica_kill``;
- ``guard``: ``GuardedStep``, the nonfinite policies and transient
  retry around a ``TrainStep``, on device snapshots;
- ``elastic``: ``Heartbeat`` and ``ReplicaSupervisor`` (the serve
  fleet's liveness beacon and relaunch budget), ``GracefulShutdown``
  and ``newest_intact_step`` (a training worker's preemption exit and
  resume point).

The JAX package's ``GuardedExecutor`` and elastic gang supervisor are
not ported yet.
"""
from . import elastic, guard, inject, policy
from .elastic import (PREEMPTED_EXIT_CODE, ElasticBudgetError,
                      GracefulShutdown, Heartbeat, ReplicaSupervisor,
                      graceful_shutdown, newest_intact_step)
from .guard import GuardedStep, GuardStats
from .inject import (ACTIVE, INJECTORS, ChaosError, SimulatedCrashError,
                     TransientChaosError, chaos, install_from_env)
from .policy import (NONFINITE_ACTIONS, RecoveryPolicy, TransientError,
                     retry_call)

__all__ = ["elastic", "guard", "inject", "policy", "chaos",
           "install_from_env", "ACTIVE", "INJECTORS", "ChaosError",
           "TransientChaosError", "SimulatedCrashError", "TransientError",
           "RecoveryPolicy", "NONFINITE_ACTIONS", "retry_call",
           "GuardedStep", "GuardStats", "PREEMPTED_EXIT_CODE",
           "ElasticBudgetError", "GracefulShutdown", "Heartbeat",
           "ReplicaSupervisor", "graceful_shutdown", "newest_intact_step"]
