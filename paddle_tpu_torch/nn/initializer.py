"""Parameter initializers: ``Constant``, ``Uniform``, ``Normal``,
``TruncatedNormal``, ``XavierUniform``, ``XavierNormal``,
``KaimingUniform``, ``KaimingNormal``, ``Bilinear``, ``Assign``,
``Orthogonal`` and ``Dirac``, with ``calculate_gain`` and the global
initializer (``set_global_initializer``).

The counterparts of ``paddle_tpu/nn/initializer.py``'s. An initializer
is called with a shape, a dtype and a device (``cuda`` unless the caller
asks for ``"cpu"``; raises without a card) and returns a new tensor; a
random one draws from the generator it is given, else from the device's
(``core.random.default_generator``), in float32, and casts to the dtype.
The deterministic ones (``Constant``, ``Bilinear``, ``Assign``,
``Dirac``) give the reference's values exactly.

Fans follow the reference's ``_fans`` (``initializer.py:41-52``): a
``Linear`` weight is ``(in, out)``, so ``fan_in = shape[0]``; a
convolution's ``(out, in, *kernel)`` multiplies both by the kernel size.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from ..core.random import default_generator

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Bilinear", "Assign", "Orthogonal", "Dirac",
           "calculate_gain", "set_global_initializer",
           "global_initializer", "Xavier", "MSRA", "XavierInitializer",
           "MSRAInitializer"]


def calculate_gain(nonlinearity, param=None):
    """The recommended gain of ``nonlinearity`` (``initializer.py:28``;
    ``leaky_relu``'s slope ``param`` defaults to 0.01)."""
    recommended = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    if nonlinearity not in recommended:
        raise ValueError(f"unsupported nonlinearity: {nonlinearity}")
    return recommended[nonlinearity]


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


class TruncatedNormal(Initializer):
    """Samples of N(mean, std**2) truncated to two standard deviations
    (``initializer.py:92``), by the inverse CDF of a uniform draw
    between the normal CDF's values at -2 and 2."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape, device, generator):
        lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2.0))) for b in (-2, 2))
        u = _uniform(shape, 2 * lo - 1, 2 * hi - 1, device, generator)
        z = torch.clamp(torch.erfinv(u) * math.sqrt(2.0), -2.0, 2.0)
        return z * self.std + self.mean


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain_fan_in(self, shape):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        if self.nonlinearity == "leaky_relu":
            return calculate_gain("leaky_relu", self.negative_slope), fi
        return calculate_gain(self.nonlinearity), fi


class KaimingUniform(_Kaiming):
    """Samples of U(-l, l) with ``l = gain * sqrt(3 / fan_in)``
    (``initializer.py:128``)."""

    def _generate(self, shape, device, generator):
        gain, fi = self._gain_fan_in(shape)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, -limit, limit, device, generator)


class KaimingNormal(_Kaiming):
    """Samples of N(0, s**2) with ``s = gain / sqrt(fan_in)``
    (``initializer.py:144``)."""

    def _generate(self, shape, device, generator):
        gain, fi = self._gain_fan_in(shape)
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * (gain / math.sqrt(fi))


class _Exact(Initializer):
    """An initializer whose values are fixed: made in numpy (float32 for
    ``_values``), then cast once to the dtype on the device."""

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        values = self._values(tuple(int(s) for s in shape))
        return torch.as_tensor(values).to(device=resolve_device(device),
                                          dtype=dtype)

    def _values(self, shape):
        raise NotImplementedError


class Bilinear(_Exact):
    """The bilinear upsampling kernel of a transposed convolution's
    4-D weight (``initializer.py:159``)."""

    def _values(self, shape):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        h, w = shape[2], shape[3]
        f_h, f_w = math.ceil(h / 2.0), math.ceil(w / 2.0)
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        yy = 1 - np.abs(np.arange(h) / f_h - c_h)
        xx = 1 - np.abs(np.arange(w) / f_w - c_w)
        kernel = np.outer(yy, xx).astype(np.float32)
        weight = np.zeros(shape, dtype=np.float32)
        for i in range(shape[0]):
            weight[i, i % shape[1]] = kernel
        return weight


class Assign(_Exact):
    """The given values (a tensor, an array or nested lists), reshaped to
    the parameter's shape where they differ (``initializer.py:178``)."""

    def __init__(self, value):
        self.value = value

    def _values(self, shape):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        arr = np.asarray(v)
        return arr.reshape(shape) if tuple(arr.shape) != shape else arr


class Orthogonal(Initializer):
    """``gain`` times a matrix with orthonormal rows or columns, from the
    QR decomposition of a standard normal draw, signs fixed by R's
    diagonal, reshaped to the parameter (``initializer.py:192``)."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _generate(self, shape, device, generator):
        rows = shape[0]
        cols = math.prod(shape[1:]) if len(shape) > 1 else 1
        a = torch.randn((max(rows, cols), min(rows, cols)),
                        generator=generator, device=device,
                        dtype=torch.float32)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(shape)


class Dirac(_Exact):
    """The identity convolution's kernel: a 1 at the centre of input
    channel i for output channel i of each of ``groups`` groups
    (``initializer.py:208``)."""

    def __init__(self, groups=1):
        self.groups = groups

    def _values(self, shape):
        w = np.zeros(shape, dtype=np.float32)
        out_per_group = shape[0] // self.groups
        centre = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(out_per_group, shape[1])):
                w[(g * out_per_group + i, i) + centre] = 1.0
        return w


_GLOBAL = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    """The initializers ``create_parameter`` takes for a weight and a
    bias when neither the attr nor the layer gives one
    (``initializer.py:228-251``); ``None`` clears them."""
    _GLOBAL["weight"], _GLOBAL["bias"] = weight_init, bias_init


def global_initializer(is_bias):
    """The global bias initializer for ``is_bias``, else the weight one
    (``None`` when unset)."""
    return _GLOBAL["bias" if is_bias else "weight"]


# fluid-era names (paddle_tpu/nn/initializer.py:254-266)
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = XavierUniform
MSRAInitializer = KaimingNormal
BilinearInitializer = Bilinear
NumpyArrayInitializer = Assign
Xavier = XavierUniform
MSRA = KaimingNormal
