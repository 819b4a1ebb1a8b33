"""paddle_tpu_torch.utils: small helpers.

- ``envspec``: the ``"name:key=val;name2"`` grammar of the env knobs
  (``PADDLE_TPU_CHAOS``, ``PADDLE_TPU_ANOMALY``);
- ``nan_guard``: ``NanInfError`` and the bounded ``nonfinite_summary``
  that ``TrainStep(check_nan=True)`` attaches to it;
- ``unique_name``: the names a static Program gives its variables.
"""
from . import envspec, nan_guard, unique_name  # noqa: F401

__all__ = ["envspec", "nan_guard", "unique_name"]
