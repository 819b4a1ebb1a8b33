"""``Layer``, the module base class, and its containers: the
counterparts of ``paddle_tpu/nn/layer.py``.

``Layer`` is a ``torch.nn.Module`` with the reference's API, so
everything that takes a torch module (``TrainStep``, ``ProgramCache``,
the static recorder, ``convert``, ``framework.io``) takes a Layer, and
torch's own methods keep working on it (``.to(device)``,
``.bfloat16()``, ``load_state_dict``). Where the two differ, a Layer
follows the JAX package:

- ``full_name()`` is the class in snake case, numbered by
  ``utils.unique_name`` when the layer is made (``layer.py:38-42``), and
  a parameter made by ``create_parameter`` is named
  ``<full_name>_w_<n>`` (``_b_<n>`` for a bias), in eager mode too
  (``:85``); ``optim`` keys a plain list of parameters by these names;
- parameters are made on the current place (``core.device``), in the
  layer's dtype (``Layer(dtype=...)``, float32 unless given);
- ``parameters()``, ``buffers()`` and ``sublayers()`` return lists
  (``parameters()`` and ``buffers()`` also answer ``next()``, as torch
  code takes the first with ``next(model.parameters())``); the
  traversals take ``include_sublayers`` (and torch's ``recurse`` and
  ``remove_duplicate``, which torch's own methods pass);
- ``state_dict()`` holds every parameter, then every persistable
  buffer (``:284-303``), where torch interleaves them module by module;
  the values share the parameters' storage. ``set_state_dict`` (also
  ``set_dict``, ``load_dict``) copies into that storage
  (``framework.io.set_state_dict``), so a captured graph replays on;
- assigning a tensor to a parameter's attribute copies it into the
  parameter (``:163-167``), where torch would raise;
- ``to`` takes Paddle's device strings and places as well as torch's,
  and ``to``/``astype``/``float``/``half``/``bfloat16`` set the dtype
  new parameters take;
- ``register_forward_post_hook`` is torch's forward hook; both hook
  kinds return a handle with ``remove()``;
- calling a layer whose ``forward`` is this package's (not a
  subclass's own, not ``Sequential``'s) is a boundary
  (``core.tensor``): Paddle ``Tensor`` inputs reach the forward as
  plain tensors, and the outputs are Paddle ``Tensor``s again when an
  input was one. A ``forward`` written outside the package, as a Paddle
  script's, takes its inputs as they are, methods and all.
"""
from __future__ import annotations

import collections

import torch

from .. import _device
from ..core import dtype as _dtype
from ..core.tensor import plain_tensor, unwrap, wrap
from ..utils import unique_name

__all__ = ["Layer", "Sequential", "LayerList", "ParameterList", "LayerDict"]


class _Items(list):
    """A list that also iterates itself under ``next()``, as the
    generators torch's ``parameters()`` and ``buffers()`` return do."""

    def __next__(self):
        if "_it" not in self.__dict__:
            self._it = iter(self)
        return next(self._it)


def _camel_to_snake(name):
    return "".join(("_" + c.lower()) if c.isupper() and i else c.lower()
                   for i, c in enumerate(name))


class Layer(torch.nn.Module):
    # whether ``forward`` is this package's: calls then unwrap (module doc)
    _port_forward = True

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fwd = cls.__dict__.get("forward")
        if fwd is not None and "_port_forward" not in cls.__dict__:
            cls._port_forward = getattr(fwd, "__module__", "").startswith(
                __name__.split(".")[0] + ".")

    def __call__(self, *args, **kwargs):
        if not self._port_forward:
            return super().__call__(*args, **kwargs)
        args, kwargs, seen = unwrap(args, kwargs)
        out = super().__call__(*args, **kwargs)
        return wrap(out) if seen else out

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        if name_scope is None:
            name_scope = _camel_to_snake(type(self).__name__)
        self._full_name = unique_name.generate(name_scope)
        self._dtype = None if dtype is None else _dtype.convert_dtype(dtype)

    def full_name(self):
        return self._full_name

    # -- making parameters and tensors ------------------------------------

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A parameter of ``shape`` made as ``attr`` says (see
        ``nn.layers.common.create_parameter``), in ``dtype`` or the
        layer's, on the current place; None for ``attr=False``."""
        from .layers.common import create_parameter

        return create_parameter(shape, attr, is_bias=is_bias,
                                default_initializer=default_initializer,
                                owner=self, dtype=dtype)

    def create_tensor(self, name=None, dtype=None, default_initializer=None):
        """A 0-d tensor in ``dtype`` (the layer's), from
        ``default_initializer`` (zeros)."""
        from .initializer import Constant

        dt = _dtype.convert_dtype(dtype if dtype is not None else
                                  self._dtype or "float32")
        init = default_initializer or Constant(0.0)
        return init([], dt, _device.resolve_device(None), None)

    # -- registration -------------------------------------------------------

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter,
                                                    torch.nn.Parameter):
            raise TypeError(f"{name} is not a Parameter")
        self.__dict__.pop(name, None)
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        if sublayer is not None and not isinstance(sublayer,
                                                   torch.nn.Module):
            raise TypeError(f"{name} is not a Layer")
        self.__dict__.pop(str(name), None)
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """``tensor`` (an array or number becomes a tensor on the current
        place) as the buffer ``name``; a buffer that is not
        ``persistable`` (torch's ``persistent``) stays out of
        ``state_dict``."""
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = plain_tensor(tensor)
        self.__dict__.pop(name, None)
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=bool(keep))
        return tensor

    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        if (params is not None and params.get(name) is not None
                and isinstance(value, torch.Tensor)
                and not isinstance(value, torch.nn.Parameter)):
            p = params[name]
            with torch.no_grad():
                p.copy_(value.reshape(p.shape))
            return
        super().__setattr__(name, value)

    # -- traversal ----------------------------------------------------------

    def parameters(self, include_sublayers=True, recurse=None):
        return _Items(p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse))

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        return super().named_parameters(
            prefix=prefix,
            recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        return _Items(b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse))

    def named_buffers(self, prefix="", include_sublayers=True, recurse=None,
                      remove_duplicate=True):
        return super().named_buffers(
            prefix=prefix,
            recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        if layers_set is None:
            layers_set = set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, l in self.named_children():
            if id(l) in layers_set:
                continue
            sub = prefix + ("." if prefix else "") + name
            if isinstance(l, Layer):
                yield from l.named_sublayers(prefix=sub, include_self=True,
                                             layers_set=layers_set)
            else:
                for n, m in l.named_modules(prefix=sub):
                    if id(m) not in layers_set:
                        layers_set.add(id(m))
                        yield n, m

    # -- hooks --------------------------------------------------------------

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after each forward; what it
        returns (unless None) replaces the outputs."""
        return self.register_forward_hook(hook)

    # -- state dicts --------------------------------------------------------

    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *,
                   prefix=None, keep_vars=None):
        if prefix is not None or keep_vars is not None:
            # torch's own recursion from a parent that is not a Layer
            return super().state_dict(destination=destination,
                                      prefix=prefix or "",
                                      keep_vars=bool(keep_vars))
        if destination is None:
            destination = collections.OrderedDict()
        pre = structured_name_prefix
        if pre and not pre.endswith("."):
            pre += "."
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            destination[pre + name] = p.detach()
        skip = set()
        for lp, layer in self.named_modules():
            for b in layer._non_persistent_buffers_set:
                skip.add(lp + ("." if lp else "") + b)
        for name, b in self.named_buffers(
                include_sublayers=include_sublayers):
            if name not in skip:
                destination[pre + name] = b.detach()
        return destination

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values into the parameters and
        persistable buffers of the same names; ``(missing,
        unexpected)`` names. A shape that differs raises ``ValueError``."""
        from ..framework.io import set_state_dict

        return set_state_dict(self, state_dict)

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- types, devices and gradients ---------------------------------------

    def to(self, *args, **kwargs):
        """``to(device=None, dtype=None, blocking=None)`` as Paddle has it
        (a device is a place, a Paddle or torch device string or a torch
        device; a dtype a name or a torch dtype), or any of torch's
        forms."""
        if (args and isinstance(args[0], torch.Tensor)) or \
                "memory_format" in kwargs or "tensor" in kwargs:
            return super().to(*args, **kwargs)
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        blocking = kwargs.pop("blocking", None)
        non_blocking = kwargs.pop("non_blocking", False)
        if kwargs:
            raise TypeError(f"to() got unexpected {sorted(kwargs)}")
        for a in args:
            if isinstance(a, bool):
                blocking = a
            elif isinstance(a, torch.dtype) or (
                    isinstance(a, str) and _is_dtype_name(a)):
                dtype = a
            else:
                device = a
        if blocking is not None:
            non_blocking = not blocking
        dt = None if dtype is None else _dtype.convert_dtype(dtype)
        dev = None if device is None else _device.torch_device(device)
        super().to(device=dev, dtype=dt, non_blocking=non_blocking)
        if dt is not None:
            self._set_dtype(dt)
        return self

    def _set_dtype(self, dt):
        for layer in self.modules():
            if isinstance(layer, Layer):
                layer._dtype = dt

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.astype("float32")

    def half(self):
        return self.astype("float16")

    def bfloat16(self):
        return self.astype("bfloat16")

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None


def _is_dtype_name(s):
    try:
        _dtype.convert_dtype(s)
    except ValueError:
        return False
    return True


class Sequential(Layer):
    """Layers called one after another (ref: ``dygraph/container.py``);
    ``Sequential(("a", layer), ...)`` or ``Sequential([("a", layer),
    ...])`` names them, ``Sequential(l0, l1, ...)`` numbers them. It
    passes its input on as it is: each layer is its own boundary."""

    _port_forward = False

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                len(layers[0]) and isinstance(layers[0][0], (list, tuple)):
            for name, layer in layers[0]:
                self.add_sublayer(name, layer)
        elif len(layers) and isinstance(layers[0], tuple) and \
                len(layers[0]) == 2 and isinstance(layers[0][0], str):
            for name, layer in layers:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        keys = list(self._modules)
        return self._modules[keys[idx]]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    """A list of layers, registered as ``"0"``, ``"1"``, ..."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, l in enumerate(sublayers):
                self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[str(self._abs_idx(idx))]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(self._abs_idx(idx)), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def _abs_idx(self, idx):
        idx = int(idx)
        if not -len(self) <= idx < len(self):
            raise IndexError(f"index {idx} is out of range")
        return idx + len(self) if idx < 0 else idx

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, l in enumerate(layers):
            self.add_sublayer(str(i), l)

    def extend(self, layers):
        for l in layers:
            self.append(l)
        return self


class ParameterList(Layer):
    """A list of parameters, registered as ``"0"``, ``"1"``, ..."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx + len(self) if idx < 0 else idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self


class LayerDict(Layer):
    """Layers by name, in the order they were added."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(
            sublayers, (dict, LayerDict)) else sublayers
        for key, layer in items:
            self.add_sublayer(key, layer)
        return self
