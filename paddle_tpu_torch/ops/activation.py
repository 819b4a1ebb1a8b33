"""Activations: ``gelu``, the counterpart of ``paddle_tpu/ops/activation.py``'s
(``jax.nn.gelu``: the tanh form with ``approximate=True``, erf without)."""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["gelu"]


def gelu(x, approximate=False):
    return F.gelu(x, approximate="tanh" if approximate else "none")
