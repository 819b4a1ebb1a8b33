"""Activations: ``gelu``, ``relu``, ``tanh`` and ``softmax``, the
counterparts of ``paddle_tpu/ops/activation.py``'s (``jax.nn.gelu``: the
tanh form with ``approximate=True``, erf without; ``jax.nn.relu``;
``jnp.tanh``; ``jax.nn.softmax``, ``:166-174``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._base import register
from .misc import torch_dtype

__all__ = ["gelu", "relu", "tanh", "softmax"]


def gelu(x, approximate=False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


@register("relu", inputs=("x",))
def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


@register("softmax", inputs=("x",))
def _softmax(x, *, axis=-1):
    return torch.softmax(x, axis)


def softmax(x, axis=-1, dtype=None):
    """Softmax of ``x`` along ``axis``, after a cast to ``dtype`` when one
    is given."""
    if dtype is not None:
        x = x.to(torch_dtype(dtype))
    return _softmax(x, axis=axis)
