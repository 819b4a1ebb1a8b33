"""Shape ops: ``flatten``, the counterpart of
``paddle_tpu/ops/manipulation.py``'s (``:56-66``)."""
from __future__ import annotations

import torch

__all__ = ["flatten"]


def flatten(x, start_axis=0, stop_axis=-1):
    """``x`` with axes ``start_axis`` to ``stop_axis`` (both included)
    merged into one."""
    return torch.flatten(x, start_axis, stop_axis)
