"""Elementwise math: ``add``, the counterpart of
``paddle_tpu/ops/math.py``'s (``:22-24``)."""
from __future__ import annotations

import torch

from ._base import register

__all__ = ["add"]


@register("add", inputs=("x", "y"))
def add(x, y):
    """``x + y``, broadcast."""
    return torch.add(x, y)
