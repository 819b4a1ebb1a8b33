"""``Tensor``, ``Parameter`` and ``to_tensor``: the counterparts of
``paddle_tpu/core/tensor.py``.

The eager value type is ``torch.Tensor`` itself (``Tensor``), with
torch's autograd: ``stop_gradient`` is ``not requires_grad``. No
Paddle-only method is added to torch's class (``astype``,
``stop_gradient``, ``clear_grad``): that would change it for every
other user in the process (ROADMAP Queue 1, "Paddle ``Tensor``
methods").

``Parameter`` is a ``torch.nn.Parameter`` with the reference's
attributes (``:222-257``): a ``name``, ``trainable`` (its
``requires_grad``), ``optimize_attr``, ``regularizer`` and
``need_clip``. Every parameter a layer of this package makes is one,
so torch's modules, optimizers and ``CUDAGraph`` captures take it as
they take any parameter. A deep copy gets a new unique name, as the
reference's does (``:243-257``): optimizer state is keyed by name.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _device
from . import dtype as _dtype

__all__ = ["Tensor", "Parameter", "to_tensor"]

Tensor = torch.Tensor


class Parameter(torch.nn.Parameter):
    """A trainable tensor (ref: ``framework::Parameter``)."""

    def __new__(cls, data=None, name=None, trainable=True):
        if data is None:
            data = torch.empty(0)
        elif not isinstance(data, torch.Tensor):
            data = to_tensor(data)
        p = torch.Tensor._make_subclass(cls, data.detach(), bool(trainable))
        p.name = name
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        p.need_clip = True
        return p

    def __init__(self, data=None, name=None, trainable=True):
        pass

    # ``TensorBase.name`` is read-only; a parameter's is its own
    @property
    def name(self):
        return self.__dict__.get("_pname")

    @name.setter
    def name(self, value):
        self.__dict__["_pname"] = value

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    def __repr__(self):   # torch's names the subclass twice
        return "Parameter containing:\n" + torch.Tensor.__repr__(
            self.detach())

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        from ..utils import unique_name

        p = Parameter(self.detach().clone(memory_format=torch.preserve_format),
                      name=None if self.name is None
                      else unique_name.generate(self.name),
                      trainable=self.requires_grad)
        p.optimize_attr = dict(self.optimize_attr)
        p.regularizer = self.regularizer
        p.need_clip = self.need_clip
        memo[id(self)] = p
        return p


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: ``data`` (a tensor, an array, a list or a
    number) as a new tensor on ``place`` (default: the current place),
    in ``dtype`` or its own type; float64 data (a Python float, a list
    of them, a float64 array) takes the default dtype, a Python int is
    int64.
    ``requires_grad`` is ``not stop_gradient``."""
    dev = _device.resolve_device(place)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(dev, copy=True)
    else:
        a = np.asarray(data)
        if a.dtype == object:
            raise TypeError(f"cannot make a tensor of {type(data)}")
        if a.dtype == np.float64 and dtype is None:
            dtype = _dtype.convert_dtype(None)
        t = torch.from_numpy(np.require(a, requirements="C").copy()).to(dev)
    if dtype is not None:
        t = t.to(_dtype.convert_dtype(dtype))
    if not stop_gradient:
        t.requires_grad_(True)
    return t
