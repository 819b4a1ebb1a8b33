"""paddle_tpu_torch.resilience: bounded retry and chaos points.

- ``policy``: ``TransientError``, ``RecoveryPolicy``, ``retry_call`` —
  the serve engine relieves KV-page pressure through ``retry_call``;
- ``inject``: the chaos registry and the ``replica_kill`` point the
  serve loop fires.

The JAX package's training guards and elastic gang supervisor are not
ported yet.
"""
from . import inject, policy
from .policy import RecoveryPolicy, TransientError, retry_call

__all__ = ["inject", "policy", "RecoveryPolicy", "TransientError",
           "retry_call"]
