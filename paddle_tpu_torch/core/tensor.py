"""``Tensor``, ``Parameter`` and ``to_tensor``: the counterparts of
``paddle_tpu/core/tensor.py``.

``Tensor`` is a ``torch.Tensor`` subclass with Paddle's class surface
(``:40-214``) and the reference's method table and operators
(``paddle_tpu/ops/__init__.py:31-71, 126-198``, bound by
``bind_methods`` from this package's copy in ``ops/__init__.py``).
Nothing is added to ``torch.Tensor`` itself: a plain tensor keeps
torch's meanings for every other user in the process.

126 of the reference's 139 method names are also ``torch.Tensor``
methods, many with another meaning (``transpose(perm)``, ``split``'s
section count, ``gather(index, axis)``, ``where`` with the condition as
``self``, ``max(axis)`` giving values only, ``equal`` giving a tensor,
``size`` an int). How each trap is met:

- **torch's own code never meets a Paddle override.** ``Tensor``'s
  ``__torch_function__`` runs a builtin (a C function, method or
  attribute) on the tensors as they are, with subclass dispatch off,
  and a torch function written in Python (``F.interpolate``,
  ``torch.split``, ``torch.nn.init.normal_``) on plain aliases
  (``unwrap``), so that its ``.size()``, ``.shape`` and ``.split`` are
  torch's. The results come back as Paddle ``Tensor``s (``wrap``); an
  input that is returned (an in-place op) comes back as itself. The
  autograd entry points (``torch.autograd.grad``/``backward``) take
  the tensors themselves: an alias is not the tensor the graph used.
- **the port's own code works on plain tensors.** The boundaries
  unwrap: ``boundary`` wraps every public op of ``ops`` and
  ``nn.functional`` (``unwrap`` turns each Paddle ``Tensor`` and
  ``Parameter`` argument into a plain alias; ``wrap`` makes the result a
  Paddle ``Tensor`` when an argument was a Paddle ``Tensor`` that is not
  a ``Parameter``, and always for the makers of ``ops.creation`` and
  for ``to_tensor``), ``nn.Layer.__call__`` of a layer whose
  ``forward`` is the port's, ``grad``, ``TrainStep``, ``ProgramCache``,
  ``to_static``, ``Executor.run``, ``save`` and the kernel wrappers.
  Inside them every tensor is plain, so a method keeps torch's meaning,
  and an op on parameters alone (a layer's own) gives a plain tensor. A
  method of the table runs the port's op on the plain alias of ``self``
  and always returns a Paddle ``Tensor``, as the reference's do.
- ``shape`` is a list (``Shape``) that also compares equal to a tuple
  or ``torch.Size``; ``size`` is the element count, an int (``Size``)
  that also answers torch's ``size()`` and ``size(dim)``. torch code
  that reads either on a Paddle tensor keeps working.
- ``x += y`` makes a new tensor, as the reference's ``x = x + y`` does
  (a Paddle ``Tensor`` has no in-place operators).

``Parameter`` is a ``torch.nn.Parameter`` and a ``Tensor``: torch's
modules, optimizers and ``CUDAGraph`` captures take it as before, since
``__torch_function__`` is off on it as on torch's (a torch op on
parameters alone gives a plain tensor, at no dispatch cost), and its
operators, indexing, ``detach``, ``clone``, ``copy_``, ``T`` and
``backward`` stay torch's, which the port's code and torch's call on
parameters. It answers the table's methods and the rest of the class
surface with Paddle's meanings (``transpose(perm)``, ``astype``,
``numpy()``, ``stop_gradient``, ``clear_grad``, ``set_value``,
``shape``, ``size``), each method giving a Paddle ``Tensor``. It has
the reference's attributes (``:222-257``): a ``name``, ``trainable``
(its ``requires_grad``), ``optimize_attr``, ``regularizer``,
``need_clip`` and ``persistable``. A deep copy gets a new unique name,
as the reference's does (``:243-257``): optimizer state is keyed by
name.

``numpy()`` of a bfloat16 tensor is float32 (the same values): this
package never imports ``ml_dtypes``, which the reference's array type
is.
"""
from __future__ import annotations

import functools
import itertools
import types

import numpy as np
import torch

from .. import _device
from . import dtype as _dtype

__all__ = ["Tensor", "Parameter", "to_tensor", "plain", "wrap", "unwrap",
           "boundary", "bind_methods", "Shape", "Size"]

_NO_SUBCLASS = torch._C.DisableTorchFunctionSubclass
_BUILTINS = (types.BuiltinFunctionType, types.MethodDescriptorType,
             types.WrapperDescriptorType, types.MethodWrapperType)
_names = itertools.count()


class Shape(list):
    """A tensor's ``shape`` as Paddle has it, a list, that also compares
    equal to the same dims as a tuple or ``torch.Size``."""

    __slots__ = ()

    def __eq__(self, other):
        if isinstance(other, tuple):
            return tuple(self) == other
        return list.__eq__(self, other)

    def __ne__(self, other):
        return not self == other

    __hash__ = None


class Size(int):
    """A tensor's ``size`` as Paddle has it, the element count, which
    also answers torch's ``size()`` and ``size(dim)``."""

    def __new__(cls, sizes):
        s = int.__new__(cls, int(np.prod(sizes, dtype=np.int64)))
        s._sizes = sizes
        return s

    def __call__(self, dim=None):
        return self._sizes if dim is None else self._sizes[dim]


def _sizes(t):
    with _NO_SUBCLASS():
        return torch._C.TensorBase.size(t)


def _is_value(a):
    """A Paddle ``Tensor`` that is not a ``Parameter``."""
    return isinstance(a, Tensor) and not isinstance(a, torch.nn.Parameter)


def plain(x):
    """A Paddle ``Tensor`` or ``Parameter`` as a plain ``torch.Tensor`` (an
    alias: the same storage, on the autograd graph, whose gradient
    reaches the parameter); anything else as it is."""
    if isinstance(x, Tensor):
        return torch.Tensor.as_subclass(x, torch.Tensor)
    return x


def _unwrap_seq(seq):
    """``seq``'s items unwrapped one level down (lists and tuples of
    tensors, as ``concat`` takes): ``(items or None when none was a
    Paddle tensor, seen)``."""
    seen = changed = False
    out = []
    for a in seq:
        if isinstance(a, Tensor):
            seen = seen or not isinstance(a, torch.nn.Parameter)
            changed = True
            a = torch.Tensor.as_subclass(a, torch.Tensor)
        elif type(a) in (list, tuple) and any(isinstance(b, Tensor)
                                              for b in a):
            seen = seen or any(_is_value(b) for b in a)
            changed = True
            a = type(a)(plain(b) for b in a)
        out.append(a)
    return (out if changed else None), seen


def unwrap(args, kwargs):
    """``(args, kwargs, seen)``: the arguments with every Paddle ``Tensor``
    and ``Parameter`` (also inside a list or tuple argument) as a plain
    alias, and whether there was a Paddle ``Tensor`` that is not a
    ``Parameter`` (ops on parameters alone give plain tensors, as the
    port's layers call them)."""
    new, seen = _unwrap_seq(args)
    if new is not None:
        args = new
    if kwargs:
        vals, seen_kw = _unwrap_seq(kwargs.values())
        if vals is not None:
            kwargs = dict(zip(kwargs, vals))
            seen = seen or seen_kw
    return args, kwargs, seen


def wrap(out, keep=()):
    """``out`` with every plain ``torch.Tensor`` in it (in tuples, lists
    and dicts) as a Paddle ``Tensor``; a tensor in ``keep`` (an alias this
    call made) as the Paddle tensor it aliases (``keep`` maps ``id``)."""
    t = type(out)
    if t is torch.Tensor:
        orig = keep.get(id(out)) if keep else None
        return orig if orig is not None else \
            torch.Tensor.as_subclass(out, Tensor)
    if t is list or t is tuple:
        return t(wrap(o, keep) for o in out)
    if isinstance(out, tuple) and hasattr(out, "n_fields"):   # structseq
        return t(wrap(o, keep) for o in out)
    if t is dict:
        return {k: wrap(v, keep) for k, v in out.items()}
    return out


_BOUNDARIES = {}


def boundary(fn, make=False):
    """``fn`` as a user-facing op: Paddle ``Tensor`` arguments reach it as
    plain tensors, and its result is a Paddle ``Tensor`` when one of them
    was one (always, with ``make``: a maker, as ``zeros``). One wrapper a
    function, so that an alias stays the function it names."""
    if getattr(fn, "_boundary", False):
        return fn
    if (fn, make) in _BOUNDARIES:
        return _BOUNDARIES[fn, make]

    @functools.wraps(fn)
    def op(*args, **kwargs):
        args, kwargs, seen = unwrap(args, kwargs)
        out = fn(*args, **kwargs)
        return wrap(out) if seen or make else out

    op._boundary = True
    _BOUNDARIES[fn, make] = op
    return op


def _paddle_method(fn, name):
    """``fn(self, ...)`` as the method ``name``: the port's op on the
    plain alias of ``self``, its result a Paddle ``Tensor``."""

    def method(self, *args, **kwargs):
        args, kwargs, _ = unwrap(args, kwargs)
        return wrap(fn(plain(self), *args, **kwargs))

    method.__name__ = method.__qualname__ = name
    method.__doc__ = fn.__doc__
    return method


def _swapped(fn, name):
    """The reflected operator ``name``: ``fn(other, self)``."""

    def method(self, other):
        return wrap(fn(plain(other), plain(self)))

    method.__name__ = method.__qualname__ = name
    return method


_IDENTITY = (torch.autograd.grad, torch.autograd.backward)


class Tensor(torch.Tensor):
    """``Tensor(data, dtype=None, stop_gradient=True, name=None)``: the
    eager value type (ref: ``VarBase``); see the module's doc."""

    def __new__(cls, data=None, dtype=None, stop_gradient=True, name=None):
        t = _make(torch.empty(0) if data is None else data, dtype, None)
        out = torch.Tensor._make_subclass(cls, t, not stop_gradient)
        if name is not None:
            out.__dict__["_pname"] = name
        return out

    def __init__(self, *args, **kwargs):
        pass

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, _BUILTINS) or func in _IDENTITY:
            with _NO_SUBCLASS():
                out = func(*args, **kwargs)
            if type(out) is torch.Tensor and (
                    any(out is a for a in args) or
                    any(out is v for v in kwargs.values())):
                return out      # written in place into a plain tensor
            return wrap(out)
        # torch code written in Python: plain aliases, so that it meets
        # torch's methods, not Paddle's
        keep = {}

        def alias(a):
            p = torch.Tensor.as_subclass(a, torch.Tensor)
            keep[id(p)] = a
            return p

        args = [alias(a) if isinstance(a, Tensor) else
                type(a)(alias(b) if isinstance(b, Tensor) else b for b in a)
                if type(a) in (list, tuple) else a for a in args]
        kwargs = {k: alias(v) if isinstance(v, Tensor) else v
                  for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        return wrap(out, keep)

    # -- the class surface (``core/tensor.py:40-214``) ---------------------

    @property
    def shape(self):
        return Shape(_sizes(self))

    @property
    def size(self):
        return Size(_sizes(self))

    @property
    def T(self):
        x = plain(self)
        return wrap(x.transpose(-2, -1) if x.dim() >= 2 else x.view_as(x))

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    @property
    def name(self):
        n = self.__dict__.get("_pname")
        if n is None:
            n = self.__dict__["_pname"] = f"generated_tensor_{next(_names)}"
        return n

    @name.setter
    def name(self, value):
        self.__dict__["_pname"] = value

    @property
    def persistable(self):
        return self.__dict__.get("_persistable", False)

    @persistable.setter
    def persistable(self, value):
        self.__dict__["_persistable"] = bool(value)

    def numpy(self):
        """The values on the host, also of a card tensor or one that
        requires a gradient; bfloat16 as float32."""
        x = torch.Tensor.detach(plain(self))
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()

    def astype(self, dtype):
        from ..ops.manipulation import cast

        return wrap(cast(plain(self), dtype))

    cast = astype

    def set_value(self, value):
        """Copy ``value`` (a tensor, array or number) into this tensor's
        storage, in its type and shape (ref: ``VarBase::SetValue``)."""
        x = plain(self)
        v = plain(value)
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(value))
        with torch.no_grad():
            torch.Tensor.copy_(x, v.to(x.device, x.dtype).reshape(
                _sizes(self)))

    def copy_(self, other, non_blocking=False):
        """Paddle's ``copy_(other)``: ``set_value``; returns ``self``."""
        self.set_value(other)
        return self

    def backward(self, grad_tensor=None, retain_graph=False, **kwargs):
        grad_tensor = kwargs.pop("gradient", grad_tensor)
        torch.autograd.backward(self, plain(grad_tensor),
                                retain_graph=retain_graph, **kwargs)

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """``hook(grad)`` on this tensor's gradient (a Paddle ``Tensor``);
        what it returns (unless None) replaces the gradient."""

        def call(g):
            return plain(hook(wrap(g)))

        with _NO_SUBCLASS():
            return torch.Tensor.register_hook(self, call)

    # -- conversion and indexing dunders ----------------------------------

    def __iter__(self):
        if self.dim() == 0:
            raise TypeError("iteration over a 0-d tensor")
        return iter(wrap(torch.Tensor.unbind(plain(self), 0)))

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self, *args, **kwargs):
        dt = str(self.dtype).replace("torch.", "")
        return (f"Tensor(shape={list(self.shape)}, dtype={dt}, "
                f"place={self.device}, stop_gradient={self.stop_gradient},"
                f"\n{self.numpy()})")

    __hash__ = torch.Tensor.__hash__


# in-place operators make new tensors, as the reference's ``x = x + y``
for _op in ("add", "sub", "mul", "truediv", "floordiv", "mod", "pow",
            "matmul", "and", "or", "xor"):
    setattr(Tensor, f"__i{_op}__",
            (lambda o: lambda self, other: getattr(self, f"__{o}__")(other))
            (_op))


def bind_methods(methods, dunders, swapped):
    """Bind the method table: ``methods`` and ``dunders`` map a name to
    the port's op ``fn(x, ...)``, ``swapped`` a reflected dunder to the op
    it calls as ``fn(other, x)``. A ``Parameter`` keeps torch's
    operators (see the module's doc)."""
    for name, fn in {**methods, **dunders}.items():
        setattr(Tensor, name, _paddle_method(fn, name))
    for name, fn in swapped.items():
        setattr(Tensor, name, _swapped(fn, name))
    for name in (*dunders, *swapped, *_TORCH_ON_PARAMETER):
        if hasattr(torch.Tensor, name):
            setattr(Parameter, name, getattr(torch.Tensor, name))


def _make(data, dtype, place, stop_gradient=True):
    """``data`` as a new plain tensor on ``place``, in ``dtype`` or its
    own type (float64 data takes the default dtype, a Python int is
    int64)."""
    dev = _device.resolve_device(place)
    if isinstance(data, torch.Tensor):
        t = torch.Tensor.detach(plain(data)).to(dev, copy=True)
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


_TORCH_ON_PARAMETER = (
    "__iadd__", "__isub__", "__imul__", "__itruediv__", "__ifloordiv__",
    "__imod__", "__ipow__", "__imatmul__", "__iand__", "__ior__",
    "__ixor__", "__iter__", "__array__", "T", "detach", "clone", "copy_",
    "backward", "register_hook")


class Parameter(Tensor, torch.nn.Parameter):
    """A trainable tensor (ref: ``framework::Parameter``)."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __new__(cls, data=None, name=None, trainable=True):
        if data is None:
            data = torch.empty(0)
        elif not isinstance(data, torch.Tensor):
            data = _make(data, None, None)
        p = torch.Tensor._make_subclass(cls, torch.Tensor.detach(plain(data)),
                                        bool(trainable))
        p.name = name
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        p.need_clip = True
        p.persistable = True
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
    def persistable(self):
        return self.__dict__.get("_persistable", True)

    @persistable.setter
    def persistable(self, value):
        self.__dict__["_persistable"] = bool(value)

    def __repr__(self):   # torch's names the subclass twice
        return "Parameter containing:\n" + torch.Tensor.__repr__(
            torch.Tensor.detach(self))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        from ..utils import unique_name

        p = Parameter(torch.Tensor.detach(self).clone(
                          memory_format=torch.preserve_format),
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
    number) as a new Paddle ``Tensor`` on ``place`` (default: the current
    place), in ``dtype`` or its own type; float64 data (a Python float, a
    list of them, a float64 array) takes the default dtype, a Python int
    is int64. ``requires_grad`` is ``not stop_gradient``."""
    return torch.Tensor._make_subclass(Tensor, _make(data, dtype, place),
                                       not stop_gradient)


def plain_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``to_tensor`` as a plain ``torch.Tensor``: what the port's own code
    makes (a buffer from an array)."""
    return _make(data, dtype, place, stop_gradient)
