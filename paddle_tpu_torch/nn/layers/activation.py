"""Activation layers, the counterparts of
``paddle_tpu/nn/layers/activation.py``'s 27 classes: each forwards
through the ``functional`` op of its name with the parameters it was
made with (Paddle's defaults). Only ``PReLU`` holds a parameter:
``weight`` of ``num_parameters`` values, ``init`` (0.25) unless
``weight_attr`` says otherwise; like the JAX layer it takes
``data_format`` and applies a per-channel weight along axis 1."""
from __future__ import annotations

from ..layer import Layer
from ..._device import resolve_device
from .. import functional as F
from ..initializer import Constant
from .common import create_parameter

__all__ = [
    "ReLU", "ReLU6", "LeakyReLU", "PReLU", "ELU", "CELU", "SELU", "GELU",
    "Sigmoid", "LogSigmoid", "Tanh", "Tanhshrink", "Softmax", "LogSoftmax",
    "Softplus", "Softshrink", "Softsign", "Swish", "Silu", "Mish", "Hardtanh",
    "Hardshrink", "Hardsigmoid", "Hardswish", "ThresholdedReLU", "Maxout",
    "GLU",
]


def _layer(cls_name, fname, *params):
    """A layer class ``cls_name`` whose forward is ``F.<fname>(x,
    **its params)``; ``params`` are ``(name, default)`` pairs, taken by
    the constructor in this order."""

    def __init__(self, *args, **kwargs):
        # the JAX package names its parameterless activations after the
        # function (``activation.py:17-26``: ``relu_0``), the rest after
        # the class (``leaky_re_l_u_0``)
        Layer.__init__(self, name_scope=None if params else fname)
        kwargs.pop("name", None)
        values = dict(params)
        values.update(zip([n for n, _ in params], args))
        unknown = set(kwargs) - set(values)
        if unknown or len(args) > len(params):
            raise TypeError(f"{cls_name} takes {[n for n, _ in params]}, "
                            f"got {args} and {sorted(kwargs)}")
        values.update(kwargs)
        self._params = values

    def forward(self, x):
        return getattr(F, fname)(x, **self._params)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._params.items())

    return type(cls_name, (Layer,), {
        "__init__": __init__, "forward": forward, "extra_repr": extra_repr,
        "__doc__": f"``functional.{fname}`` as a layer.",
        "__module__": __name__})


ReLU = _layer("ReLU", "relu")
ReLU6 = _layer("ReLU6", "relu6")
Sigmoid = _layer("Sigmoid", "sigmoid")
LogSigmoid = _layer("LogSigmoid", "log_sigmoid")
Tanh = _layer("Tanh", "tanh")
Tanhshrink = _layer("Tanhshrink", "tanhshrink")
Softsign = _layer("Softsign", "softsign")
Silu = _layer("Silu", "silu")
Swish = _layer("Swish", "swish")
Mish = _layer("Mish", "mish")
Hardsigmoid = _layer("Hardsigmoid", "hardsigmoid")
Hardswish = _layer("Hardswish", "hardswish")
LeakyReLU = _layer("LeakyReLU", "leaky_relu", ("negative_slope", 0.01))
ELU = _layer("ELU", "elu", ("alpha", 1.0))
CELU = _layer("CELU", "celu", ("alpha", 1.0))
SELU = _layer("SELU", "selu", ("scale", 1.0507009873554805),
              ("alpha", 1.6732632423543772))
GELU = _layer("GELU", "gelu", ("approximate", False))
Softmax = _layer("Softmax", "softmax", ("axis", -1))
LogSoftmax = _layer("LogSoftmax", "log_softmax", ("axis", -1))
Softplus = _layer("Softplus", "softplus", ("beta", 1.0), ("threshold", 20.0))
Softshrink = _layer("Softshrink", "softshrink", ("threshold", 0.5))
Hardtanh = _layer("Hardtanh", "hardtanh", ("min", -1.0), ("max", 1.0))
Hardshrink = _layer("Hardshrink", "hardshrink", ("threshold", 0.5))
ThresholdedReLU = _layer("ThresholdedReLU", "thresholded_relu",
                         ("threshold", 1.0))
Maxout = _layer("Maxout", "maxout", ("groups", None), ("axis", 1))
GLU = _layer("GLU", "glu", ("axis", -1))


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", device=None, generator=None):
        super().__init__()
        self.weight = create_parameter(
            (num_parameters,), weight_attr,
            default_initializer=Constant(init),
            device=resolve_device(device), generator=generator, owner=self)

    def forward(self, x):
        return F.prelu(x, self.weight)
