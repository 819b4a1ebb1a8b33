"""Activations: ``gelu``, ``relu`` and ``tanh``, the counterparts of
``paddle_tpu/ops/activation.py``'s (``jax.nn.gelu``: the tanh form with
``approximate=True``, erf without; ``jax.nn.relu``; ``jnp.tanh``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._base import register

__all__ = ["gelu", "relu", "tanh"]


def gelu(x, approximate=False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


@register("relu", inputs=("x",))
def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)
