"""Common layers: ``Linear``, ``Dropout`` and ``Embedding``.

The counterparts of ``paddle_tpu/nn/layers/common.py``'s, as
``torch.nn.Module``s with the same parameter names (``weight``,
``bias``) and Paddle's ``Linear`` layout: the weight is ``(in, out)``
and ``y = x @ W + b``. Each layer makes its parameters on ``device``
(``cuda`` unless the caller asks for ``"cpu"``), drawing random ones
from ``generator`` (default: the device's).

Only the ``Normal`` and ``Constant`` initializers are ported: a
``Linear`` needs its ``weight_attr`` (the JAX package's default there is
Xavier-uniform).
"""
from __future__ import annotations

import torch
from torch import nn

from ..._device import resolve_device
from .. import functional as F
from ..initializer import Constant, Normal

__all__ = ["Linear", "Dropout", "Embedding", "make_parameter"]


def make_parameter(init, shape, device, generator=None):
    """A float32 ``nn.Parameter`` of ``shape`` from initializer ``init``."""
    return nn.Parameter(init(shape, torch.float32, device, generator))


class Linear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, device=None, generator=None):
        super().__init__()
        if weight_attr is None:
            raise NotImplementedError(
                "Linear's default (Xavier-uniform) initializer is not "
                "ported yet: pass weight_attr=Normal(...) or Constant(...)")
        device = resolve_device(device)
        self.weight = make_parameter(weight_attr, (in_features,
                                                   out_features),
                                     device, generator)
        # bias_attr=False: no bias, as the reference's create_parameter
        # returns None for attr False (paddle_tpu/nn/layer.py:78-80)
        self.bias = None if bias_attr is False else make_parameter(
            bias_attr or Constant(0.0), (out_features,), device, generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.weight.shape[0]}, out={self.weight.shape[1]}"


class Dropout(nn.Module):
    """``upscale_in_train`` dropout; the identity in eval mode."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training)

    def extra_repr(self):
        return f"p={self.p}"


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = make_parameter(weight_attr or Normal(0.0, 1.0),
                                     (num_embeddings, embedding_dim),
                                     device, generator)

    def forward(self, x):
        return F.embedding(x, self.weight)
