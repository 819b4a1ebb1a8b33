"""paddle_tpu_torch.utils: small stdlib-only helpers.

- ``envspec``: the ``"name:key=val;name2"`` grammar of the env knobs
  (``PADDLE_TPU_CHAOS``, ``PADDLE_TPU_ANOMALY``).
"""
from . import envspec  # noqa: F401

__all__ = ["envspec"]
