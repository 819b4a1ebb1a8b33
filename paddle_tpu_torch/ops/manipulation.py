"""Shape ops: ``reshape`` and ``flatten``, the counterparts of
``paddle_tpu/ops/manipulation.py``'s (``:23-36``, ``:56-66``)."""
from __future__ import annotations

import torch

from ._base import register

__all__ = ["reshape", "flatten"]


@register("reshape", inputs=("x",))
def _reshape(x, *, shape):
    return torch.reshape(x, shape)


def reshape(x, shape):
    """``x`` in ``shape`` (one ``-1`` dim is inferred)."""
    return _reshape(x, shape=tuple(int(s) for s in shape))


@register("flatten", inputs=("x",))
def flatten(x, start_axis=0, stop_axis=-1):
    """``x`` with axes ``start_axis`` to ``stop_axis`` (both included)
    merged into one."""
    return torch.flatten(x, start_axis, stop_axis)
