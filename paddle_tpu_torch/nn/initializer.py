"""Parameter initializers: ``Normal`` and ``Constant``, the two GPT uses.

The counterparts of ``paddle_tpu/nn/initializer.py``'s. An initializer
is called with a shape, a dtype and a device (``cuda`` unless the caller
asks for ``"cpu"``; raises without a card) and returns a new tensor; a
random one draws from the generator it is given, else from the device's
(``core.random.default_generator``).
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from ..core.random import default_generator

__all__ = ["Normal", "Constant"]


class Normal:
    """Samples of N(mean, std**2), drawn in float32 and cast."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        device = resolve_device(device)
        if generator is None:
            generator = default_generator(device)
        z = torch.randn(tuple(shape), generator=generator, device=device,
                        dtype=torch.float32)
        return (z * self.std + self.mean).to(dtype)


class Constant:
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=resolve_device(device))
