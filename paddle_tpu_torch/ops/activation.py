"""Activations, the counterparts of ``paddle_tpu/ops/activation.py``'s
(``:14-224``), with Paddle's parameters and defaults as the JAX package
takes them (not torch's): ``gelu`` (``jax.nn.gelu``: the tanh form with
``approximate=True``, erf without), ``relu``, ``tanh``, ``softmax`` and
``log_softmax``, and the rest written out as the JAX package writes them
(``jnp.where``/``jnp.clip`` forms, so that the gradient at a branch is
the same): ``leaky_relu`` keeps ``x`` at ``x >= 0``, ``hardsigmoid`` is
``clip(x / 6 + 0.5, 0, 1)``, ``softplus`` switches to ``x`` above
``threshold / beta``, ``maxout`` is a max over groups whose gradient
splits on ties. ``gumbel_softmax`` draws its noise from an explicit
``torch.Generator`` (default: the device's).

Each op the JAX registry names registers under that name (``ops._base``),
so a static Program records it as one op.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.random import default_generator
from ._base import register
from ._args import torch_dtype

__all__ = ["gelu", "relu", "relu6", "sigmoid", "tanh", "softmax",
           "log_softmax", "log_sigmoid", "logsigmoid", "softplus",
           "leaky_relu", "elu", "celu", "selu", "prelu", "hardtanh",
           "hardshrink", "softshrink", "thresholded_relu", "softsign",
           "silu", "swish", "mish", "hardswish", "hardsigmoid",
           "tanhshrink", "gumbel_softmax", "maxout", "glu"]


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


@register("log_softmax", inputs=("x",))
def _log_softmax(x, *, axis=-1):
    return torch.log_softmax(x, axis)


def log_softmax(x, axis=-1, dtype=None):
    """Log-softmax of ``x`` along ``axis`` (after a cast to ``dtype``)."""
    if dtype is not None:
        x = x.to(torch_dtype(dtype))
    return _log_softmax(x, axis=axis)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _hard_sigmoid(x):
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


@register("sigmoid", inputs=("x",))
def sigmoid(x):
    return torch.sigmoid(x)


@register("log_sigmoid", inputs=("x",))
def log_sigmoid(x):
    return F.logsigmoid(x)


logsigmoid = log_sigmoid


@register("softsign", inputs=("x",))
def softsign(x):
    return x / (1.0 + torch.abs(x))


@register("silu", inputs=("x",))
def silu(x):
    return x * torch.sigmoid(x)


swish = silu


@register("mish", inputs=("x",))
def mish(x):
    return x * torch.tanh(torch.logaddexp(x, _zero(x)))


@register("tanhshrink", inputs=("x",))
def tanhshrink(x):
    return x - torch.tanh(x)


@register("relu6", inputs=("x",))
def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@register("hardsigmoid", inputs=("x",))
def hardsigmoid(x):
    return _hard_sigmoid(x)


@register("hardswish", inputs=("x",))
def hardswish(x):
    return x * _hard_sigmoid(x)


@register("softplus", inputs=("x",))
def _softplus(x, *, beta=1.0, threshold=20.0):
    return torch.where(x * beta > threshold, x,
                       torch.logaddexp(x * beta, _zero(x)) / beta)


def softplus(x, beta=1.0, threshold=20.0):
    """``log(1 + exp(beta x)) / beta``, or ``x`` where ``beta x >
    threshold``."""
    return _softplus(x, beta=float(beta), threshold=float(threshold))


@register("leaky_relu", inputs=("x",))
def _leaky_relu(x, *, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def leaky_relu(x, negative_slope=0.01):
    return _leaky_relu(x, negative_slope=float(negative_slope))


@register("elu", inputs=("x",))
def _elu(x, *, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def elu(x, alpha=1.0):
    return _elu(x, alpha=float(alpha))


@register("celu", inputs=("x",))
def _celu(x, *, alpha=1.0):
    zero = _zero(x)
    return torch.maximum(x, zero) + torch.minimum(
        zero, alpha * torch.expm1(x / alpha))


def celu(x, alpha=1.0):
    return _celu(x, alpha=float(alpha))


@register("selu", inputs=("x",))
def _selu(x, *, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return _selu(x, scale=float(scale), alpha=float(alpha))


@register("prelu", inputs=("x", "weight"))
def _prelu(x, weight):
    return torch.where(x >= 0, x, weight * x)


def prelu(x, weight, data_format="NCHW"):
    """``x`` where ``x >= 0``, else ``weight * x``; a ``weight`` of more
    than one value holds one per channel (axis 1 for ``NC*``, the last
    for ``N*C``)."""
    if weight.dim() == 1 and weight.shape[0] > 1 and x.dim() > 1:
        axis = 1 if data_format == "NCHW" else x.dim() - 1
        shape = [1] * x.dim()
        shape[axis] = weight.shape[0]
        weight = weight.reshape(shape)
    return _prelu(x, weight)


@register("hardtanh", inputs=("x",))
def _hardtanh(x, *, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


def hardtanh(x, min=-1.0, max=1.0):
    return _hardtanh(x, min=float(min), max=float(max))


@register("hardshrink", inputs=("x",))
def _hardshrink(x, *, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


def hardshrink(x, threshold=0.5):
    return _hardshrink(x, threshold=float(threshold))


@register("softshrink", inputs=("x",))
def _softshrink(x, *, threshold=0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, _zero(x)))


def softshrink(x, threshold=0.5):
    return _softshrink(x, threshold=float(threshold))


@register("thresholded_relu", inputs=("x",))
def _thresholded_relu(x, *, threshold=1.0):
    return torch.where(x > threshold, x, _zero(x))


def thresholded_relu(x, threshold=1.0):
    return _thresholded_relu(x, threshold=float(threshold))


@register("gumbel_softmax_det", inputs=("x", "g"))
def _gumbel_softmax_det(x, g, *, temperature=1.0, hard=False, axis=-1):
    y = torch.softmax((x + g) / temperature, axis)
    if hard:  # straight-through estimator
        y_hard = (y == torch.amax(y, axis, keepdim=True)).to(y.dtype)
        y = y_hard - y.detach() + y
    return y


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1,
                   generator=None):
    """Softmax of ``(x + g) / temperature`` along ``axis`` with Gumbel
    noise ``g = -log(-log(u))``, ``u`` uniform from ``generator``
    (default: the device's); ``hard``: the one-hot of the largest, with
    the soft result's gradient."""
    if generator is None:
        generator = default_generator(x.device)
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=x.dtype)
    tiny = torch.finfo(x.dtype).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    return _gumbel_softmax_det(x, g, temperature=float(temperature),
                               hard=bool(hard), axis=int(axis))


@register("maxout", inputs=("x",))
def _maxout(x, *, groups, axis=1):
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // groups, groups]
    return torch.amax(x.reshape(shape), axis + 1)


def maxout(x, groups, axis=1):
    """The max over each run of ``groups`` channels along ``axis``."""
    return _maxout(x, groups=int(groups), axis=int(axis) % x.dim())


@register("glu", inputs=("x",))
def _glu(x, *, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def glu(x, axis=-1):
    """``a * sigmoid(b)`` for the halves ``a``, ``b`` of ``x`` along
    ``axis``."""
    return _glu(x, axis=int(axis))
