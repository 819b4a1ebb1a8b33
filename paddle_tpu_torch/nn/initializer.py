"""Parameter initializers: ``Constant``, ``Uniform``, ``Normal``,
``XavierUniform`` and ``XavierNormal``.

The counterparts of ``paddle_tpu/nn/initializer.py``'s. An initializer
is called with a shape, a dtype and a device (``cuda`` unless the caller
asks for ``"cpu"``; raises without a card) and returns a new tensor; a
random one draws from the generator it is given, else from the device's
(``core.random.default_generator``), in float32, and casts to the dtype.

Fans follow the reference's ``_fans`` (``initializer.py:41-52``): a
``Linear`` weight is ``(in, out)``, so ``fan_in = shape[0]``; a
convolution's ``(out, in, *kernel)`` multiplies both by the kernel size.
"""
from __future__ import annotations

import math

import torch

from .._device import resolve_device
from ..core.random import default_generator

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "XavierUniform",
           "XavierNormal"]


def _fans(shape):
    """``(fan_in, fan_out)`` of a weight of ``shape``."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:    # Linear stores (in, out)
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """``init(shape, dtype, device, generator)`` -> a new tensor."""

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        device = resolve_device(device)
        if generator is None:
            generator = default_generator(device)
        return self._generate(tuple(int(s) for s in shape), device,
                              generator).to(dtype)

    def _generate(self, shape, device, generator):
        """The float32 values (a constant may give them in any type)."""
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=resolve_device(device))


def _uniform(shape, low, high, device, generator):
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u * (high - low) + low


class Uniform(Initializer):
    """Samples of U(low, high)."""

    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _generate(self, shape, device, generator):
        return _uniform(shape, self.low, self.high, device, generator)


class Normal(Initializer):
    """Samples of N(mean, std**2)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape, device, generator):
        z = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return z * self.std + self.mean


class _Xavier(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fan_sum(self, shape):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return fi + fo


class XavierUniform(_Xavier):
    """Samples of U(-l, l) with ``l = gain * sqrt(6 / (fan_in +
    fan_out))``."""

    def _generate(self, shape, device, generator):
        limit = self.gain * math.sqrt(6.0 / self._fan_sum(shape))
        return _uniform(shape, -limit, limit, device, generator)


class XavierNormal(_Xavier):
    """Samples of N(0, s**2) with ``s = gain * sqrt(2 / (fan_in +
    fan_out))``."""

    def _generate(self, shape, device, generator):
        std = self.gain * math.sqrt(2.0 / self._fan_sum(shape))
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * std
