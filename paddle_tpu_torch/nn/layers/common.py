"""Common layers: ``Linear``, ``Dropout`` and ``Embedding``, and
``create_parameter``.

The counterparts of ``paddle_tpu/nn/layers/common.py``'s, as
``torch.nn.Module``s with the same parameter names (``weight``,
``bias``) and Paddle's ``Linear`` layout: the weight is ``(in, out)``
and ``y = x @ W + b``. Each layer makes its parameters with
``create_parameter`` on ``device`` (``cuda`` unless the caller asks for
``"cpu"``), drawing random ones from ``generator`` (default: the
device's).
"""
from __future__ import annotations

import torch
from torch import nn

from ..._device import resolve_device
from .. import functional as F
from ..initializer import Constant, Normal, XavierUniform
from ..param_attr import ParamAttr

__all__ = ["Linear", "Dropout", "Embedding", "create_parameter",
           "copy_parameter_attrs"]

# what create_parameter sets on a parameter beside requires_grad
_ATTRS = ("optimize_attr", "regularizer", "need_clip")


def create_parameter(shape, attr=None, is_bias=False,
                     default_initializer=None, device=None, generator=None):
    """A float32 ``nn.Parameter`` of ``shape`` made as ``attr``
    (anything ``ParamAttr._to_attr`` takes) says, or ``None`` for
    ``attr=False``. The initializer is the attr's, else
    ``default_initializer``, else ``Constant(0)`` for a bias and
    ``XavierUniform`` otherwise (``paddle_tpu/nn/layer.py:75-88``). The
    parameter carries ``optimize_attr = {"learning_rate": ...}``,
    ``regularizer`` and ``need_clip``, and ``requires_grad`` is the
    attr's ``trainable``."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = attr.initializer or default_initializer or (
        Constant(0.0) if is_bias else XavierUniform())
    p = nn.Parameter(init(shape, torch.float32, resolve_device(device),
                          generator), requires_grad=bool(attr.trainable))
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p


def copy_parameter_attrs(src, dst):
    """Set the ``create_parameter`` attributes of ``src``'s parameters
    on ``dst``'s of the same names (``copy.deepcopy`` of a module copies
    a parameter's values but not the attributes set on it)."""
    theirs = dict(src.named_parameters())
    for name, p in dst.named_parameters():
        for a in _ATTRS:
            if hasattr(theirs[name], a):
                setattr(p, a, getattr(theirs[name], a))


class Linear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = create_parameter((in_features, out_features),
                                       weight_attr, device=device,
                                       generator=generator)
        # bias_attr=False: no bias (None)
        self.bias = create_parameter((out_features,), bias_attr,
                                     is_bias=True, device=device,
                                     generator=generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.weight.shape[0]}, out={self.weight.shape[1]}"


class Dropout(nn.Module):
    """Dropout with the reference's ``axis`` (a mask broadcast along the
    other axes) and ``mode`` (``upscale_in_train`` or
    ``downscale_in_infer``); see ``ops.random_ops.dropout``."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class Embedding(nn.Module):
    """Rows of ``weight (num_embeddings, embedding_dim)``, N(0, 1) unless
    ``weight_attr`` says otherwise. With ``padding_idx`` (negative counts
    from the end) that row starts at 0 and every lookup of it gives 0
    (``paddle_tpu/nn/layers/common.py:87-101``)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 weight_attr=None, device=None, generator=None):
        super().__init__()
        self._padding_idx = (padding_idx if padding_idx is None
                             or padding_idx >= 0
                             else num_embeddings + padding_idx)
        self.weight = create_parameter(
            (num_embeddings, embedding_dim), weight_attr,
            default_initializer=Normal(0.0, 1.0),
            device=resolve_device(device), generator=generator)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)
