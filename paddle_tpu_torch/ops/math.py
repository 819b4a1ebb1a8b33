"""``add`` and ``matmul``, the counterparts of ``paddle_tpu/ops/math.py``'s
(``:22-24`` and ``:276-277``). ``matmul`` is a registered op of its own
so that ``amp.auto_cast`` casts the models' logits products by its list
entry, as the JAX package's dispatch does, and a static Program records
it as one op."""
from __future__ import annotations

import torch

from ._base import register

__all__ = ["add", "matmul"]


@register("add", inputs=("x", "y"))
def add(x, y):
    """``x + y``, broadcast."""
    return torch.add(x, y)


@register("matmul", inputs=("x", "y"))
def matmul(x, y, transpose_x=False, transpose_y=False):
    """``x @ y``, either operand's last two axes swapped first."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)
