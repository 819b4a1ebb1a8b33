"""``ReLU``, the counterpart of ``paddle_tpu/nn/layers/activation.py``'s:
forward through ``functional.relu``; no parameters."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["ReLU"]


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)
