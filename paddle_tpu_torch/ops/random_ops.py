"""Stochastic ops: ``dropout``.

The counterpart of ``dropout`` in ``paddle_tpu/ops/random_ops.py``
(``upscale_in_train``): in training each element is kept with
probability ``1 - p`` and scaled by ``1 / (1 - p)``; in eval it is the
identity. The mask comes from an explicit ``torch.Generator`` on the
tensor's device (``core.random.default_generator`` unless the caller
passes one), so a run is reproducible from one seed.
``torch.nn.functional.dropout`` takes no generator, hence this op.
"""
from __future__ import annotations

import torch

from ..core.random import default_generator

__all__ = ["dropout"]


def dropout(x, p=0.5, training=True, generator=None):
    """``where(keep, x / (1 - p), 0)`` with ``keep ~ Bernoulli(1 - p)``
    drawn from ``generator`` (default: the device's); ``x`` itself when
    not training or ``p == 0``."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout probability {p} outside [0, 1]")
    if not training or p == 0.0:
        return x
    if generator is None:
        generator = default_generator(x.device)
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
