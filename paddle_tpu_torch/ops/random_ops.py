"""Stochastic ops: ``dropout``, ``dropout2d``/``dropout3d``,
``alpha_dropout``, and ``channel_shuffle``, which sits beside them in
the JAX package.

The counterparts of ``paddle_tpu/ops/random_ops.py``'s (:28-96). In
training each element is kept with probability ``1 - p``:
``upscale_in_train`` scales what it keeps by ``1 / (1 - p)`` and is the
identity in eval; ``downscale_in_infer`` keeps it as it is and scales by
``1 - p`` in eval. With ``axis`` the mask has the size of ``x`` along
those axes and 1 along the others, and is broadcast (structured
dropout); a negative axis counts from the end (the JAX package's mask is
then of size 1 along it). The mask comes from an explicit
``torch.Generator`` on the tensor's device
(``core.random.default_generator`` unless the caller passes one), so a
run is reproducible from one seed. ``torch.nn.functional.dropout`` takes
no generator, hence this op.

Inside a recompute segment (``framework.recompute``) ``MASK_TAPE`` holds
the segment's tape: its forward appends each mask it draws, its
recomputed forward takes them back in order and draws nothing.
"""
from __future__ import annotations

import torch

from ..core.random import default_generator
from ._base import register

__all__ = ["dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "channel_shuffle", "MASK_TAPE"]

MODES = ("upscale_in_train", "downscale_in_infer")
# None, or the active recompute segment's (masks to append to, masks to
# replay): one of the two is None
MASK_TAPE = [None]


@register("dropout", inputs=("x",))
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """``where(keep, x / (1 - p), 0)`` (``upscale_in_train``) or
    ``where(keep, x, 0)`` (``downscale_in_infer``) with ``keep ~
    Bernoulli(1 - p)`` of shape ``x.shape`` (or broadcast along the axes
    not in ``axis``) drawn from ``generator`` (default: the device's).
    Not training: ``x`` itself, or ``x * (1 - p)`` for
    ``downscale_in_infer``; at ``p == 0`` in training, ``x``."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout probability {p} outside [0, 1]")
    if mode not in MODES:
        raise ValueError(f"dropout mode {mode!r} (one of {MODES})")
    if not training:
        return x if mode == "upscale_in_train" else x * (1.0 - p)
    if p == 0.0:
        return x
    if generator is None and x.device.type != "meta":
        # on meta (a static Program's shape inference) nothing is drawn
        generator = default_generator(x.device)
    shape = x.shape
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = [n if i in axes else 1 for i, n in enumerate(x.shape)]
    keep = 1.0 - p
    tape = MASK_TAPE[0]
    if tape is not None and tape[1] is not None:
        mask = next(tape[1])
    else:
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        if tape is not None:
            tape[0].append(mask)
    kept = x / keep if mode == "upscale_in_train" else x
    return torch.where(mask, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", generator=None):
    """Whole (N, C) feature maps of an NCHW (or NHWC) ``x`` dropped."""
    axis = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p=p, axis=list(axis), training=training,
                   generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", generator=None):
    """Whole (N, C) volumes of an NCDHW (or NDHWC) ``x`` dropped."""
    axis = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p=p, axis=list(axis), training=training,
                   generator=generator)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


@register("alpha_dropout", inputs=("x", "keep"))
def _alpha_dropout(x, keep, *, p):
    """``a * where(keep, x, -alpha * scale) + b`` with SELU's ``alpha``
    and ``scale``, ``a`` and ``b`` keeping the mean and variance
    (``random_ops.py:74-82``)."""
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    q = 1.0 - p
    a = (q + alpha_p ** 2 * q * (1 - q)) ** -0.5
    b = -a * alpha_p * (1 - q)
    return a * torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                               device=x.device)) + b


def alpha_dropout(x, p=0.5, training=True, generator=None):
    """Dropout for SELU nets: a dropped element becomes SELU's negative
    saturation, then an affine map keeps the mean and variance; ``x`` as
    it is in eval or at ``p == 0``. The mask draws from ``generator``
    (default: the device's)."""
    if not training or p == 0.0:
        return x
    if generator is None:
        generator = default_generator(x.device)
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p
    return _alpha_dropout(x, keep, p=float(p))


@register("shuffle_channel", inputs=("x",))
def _shuffle_channel(x, *, group):
    n, c, h, w = x.shape
    return x.reshape(n, group, c // group, h, w).transpose(1, 2).reshape(
        n, c, h, w)


def channel_shuffle(x, groups, data_format="NCHW"):
    """ShuffleNet's channel shuffle of an NCHW ``x``: channel ``g * (C /
    groups) + i`` moves to ``i * groups + g``."""
    return _shuffle_channel(x, group=int(groups))
