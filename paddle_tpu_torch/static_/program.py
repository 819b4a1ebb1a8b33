"""Static graph: Program / Block / Operator / Variable, and the recorder.

The counterpart of ``paddle_tpu/static_/program.py`` (ref:
``python/paddle/fluid/framework.py``). A Program is a list of Operators
over named Variables; the Executor replays it (``static_/executor.py``).

A ``Variable`` is a tensor on PyTorch's ``meta`` device: it has a shape
and a type and no values, so the port's layers and functional ops, which
read ``x.shape`` and call torch on their inputs, take it where they take
a tensor. It is an ``nn.Parameter`` (of ``requires_grad=False``) so that
a layer built in static mode registers its parameter Variables, and
``model.parameters()`` lists them, as the JAX package's Layer does.
Shapes are inferred on ``meta`` tensors: the port's counterpart of
``jax.eval_shape``.

Recording (``ProgramRecorder``, the counterpart of ``ProgramTracer``)
has two hooks, both active between ``static_.enable_static()`` and
``disable_static()``:

- an op of the registry (``ops/_base.py``: ``conv2d``, ``linear``,
  ``layer_norm``, ``cross_entropy_hard``, ...) called with a Variable
  records itself as one Operator under the JAX registry's name, holding
  the port's function; its outputs' shapes come from that function run
  on the meta inputs with the kernels' plain versions
  (``kernels.plain_versions()``: a kernel launched through ``ctypes``
  cannot run on ``meta``), and with the mode below switched off, so
  that the torch calls inside it record nothing;
- any other torch call on a Variable (a ``TorchFunctionMode``) records
  one Operator holding that call, such as ``x * 2.0``; such an op has
  no attributes a loader could read, so an inference bundle
  (``framework.io.save_inference_model``) refuses it. A call that
  returns no tensor (``x.shape``, ``x.dim()``) records nothing; an
  in-place call on a Variable raises.

Not ported: sub-blocks beyond the one global block (as in the JAX
package), and the ``fluid.layers`` builders.
"""
from __future__ import annotations

import contextlib
import itertools

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..ops import kernels
from ..utils import unique_name

__all__ = [
    "Variable", "Operator", "Block", "Program", "program_guard",
    "default_main_program", "default_startup_program", "data",
    "Scope", "global_scope", "scope_guard", "name_scope",
    "ProgramRecorder", "convert_dtype",
]

_DTYPES = {"float32": torch.float32, "float": torch.float32,
           "float64": torch.float64, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int64": torch.int64,
           "int32": torch.int32, "int16": torch.int16, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool}


def convert_dtype(d):
    """A dtype as a name (``"float32"``), a torch dtype or a numpy one ->
    the torch dtype."""
    if isinstance(d, torch.dtype):
        return d
    name = getattr(d, "name", None) or str(d)
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {d!r}") from None


class Variable(torch.nn.Parameter):
    """Symbolic tensor inside a Program (ref: framework.py Variable): a
    ``meta`` tensor of the variable's shape and type. ``-1``/``None``
    dims are dynamic: they record as the placeholder 1, and
    ``dynamic_dims`` keeps where they were (the verifier's PTA009 tells
    them from a feed that contradicts a static dim)."""

    def __new__(cls, block, name, shape, dtype, persistable=False,
                stop_gradient=True, is_data=False):
        shape = tuple(1 if s in (-1, None) else int(s) for s in shape)
        with torch._C.DisableTorchFunction():
            meta = torch.empty(shape, dtype=convert_dtype(dtype),
                               device="meta")
        return torch.Tensor._make_subclass(cls, meta, False)

    def __init__(self, block, name, shape, dtype, persistable=False,
                 stop_gradient=True, is_data=False):
        self.dynamic_dims = tuple(i for i, s in enumerate(shape)
                                  if s in (-1, None))
        self.name = name
        self.block = block
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_parameter = False
        self.initializer = None
        self.is_data = is_data
        self._stale = False
        self.trainable = True
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True

    # the variable's name (a tensor's own ``name`` is read-only)
    name = property(lambda self: self.__dict__["_name"],
                    lambda self, v: self.__dict__.__setitem__("_name", v))

    def numpy(self):
        raise RuntimeError(
            f"Variable '{self.name}' has no value outside Executor.run(); "
            "fetch it via fetch_list")

    def set_value(self, value):
        """In-graph assignment (ref: an assign op writing to an existing
        var): records ``assign_to``."""
        from ..ops._base import RECORDER

        if RECORDER[0] is None:
            raise RuntimeError(
                "set_value on a Variable outside program building")
        RECORDER[0].record_assign(self, value)

    def __repr__(self):
        with torch._C.DisableTorchFunction():
            shape, dtype = list(self.shape), self.dtype
        return (f"Variable(name={self.name}, shape={shape}, "
                f"dtype={dtype}, persistable={self.persistable})")


def _meta_of(v):
    """``(shape, dtype)`` of a Variable, read with torch functions off."""
    with torch._C.DisableTorchFunction():
        return tuple(v.shape), v.dtype


class Operator:
    """ref: framework.py Operator / OpDesc: the op's type, the function
    the replay calls as ``fn(*inputs, **attrs)``, its input and output
    variable names, and ``uid``, which a rewritten copy of the op keeps
    (a ``@grad`` op finds its forward op's saved state by it)."""

    __slots__ = ("type", "fn", "input_names", "output_names", "attrs",
                 "uid")
    _uids = itertools.count()

    def __init__(self, type, fn, input_names, output_names, attrs,
                 uid=None):
        self.type = type
        self.fn = fn
        self.input_names = input_names  # list[str|None]
        self.output_names = output_names  # list[str]
        self.attrs = attrs
        self.uid = next(Operator._uids) if uid is None else uid

    def __repr__(self):
        return (f"{{{', '.join(self.output_names)}}} = {self.type}"
                f"({', '.join(str(n) for n in self.input_names)})")


class Block:
    """ref: framework.py Block. One global block, as in the JAX package."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: dict[str, Variable] = {}
        self.ops: list[Operator] = []

    def var(self, name):
        if name not in self.vars:
            raise ValueError(f"variable {name} not in block {self.idx}")
        return self.vars[name]

    def has_var(self, name):
        return name in self.vars

    def create_var(self, name=None, shape=(), dtype="float32",
                   persistable=False, stop_gradient=True, is_data=False):
        name = name or unique_name.generate("tmp_var")
        v = Variable(self, name, shape, dtype, persistable, stop_gradient,
                     is_data)
        self.vars[name] = v
        return v

    def append_op(self, op):
        self.ops.append(op)

    def all_parameters(self):
        return [v for v in self.vars.values() if v.is_parameter]


class Program:
    """ref: framework.py Program. ``_uid`` is monotonic (the Executor's
    cache keys on it, never on ``id()``, which a new Program may reuse);
    ``_version`` moves with every op recorded (``bump``)."""

    _uid_counter = itertools.count()

    def __init__(self):
        self._uid = next(Program._uid_counter)
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._constants: dict[str, torch.Tensor] = {}
        self.random_seed = None
        self._version = 0
        self._lr_getter = None  # set by build_optimize_ops

    @property
    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def all_parameters(self):
        return self.global_block.all_parameters()

    def list_vars(self):
        return list(self.global_block.vars.values())

    def clone(self, for_test=False):
        """A copy of the program; ``for_test`` sets every dropout's ``p``
        to 0 (ref: ``Program.clone(for_test=True)``)."""
        p = Program()
        blk = p.global_block
        for name, v in self.global_block.vars.items():
            shape, dtype = _meta_of(v)
            shape = [-1 if i in v.dynamic_dims else s
                     for i, s in enumerate(shape)]
            nv = Variable(blk, name, shape, dtype, v.persistable,
                          v.stop_gradient, v.is_data)
            for a in ("is_parameter", "initializer", "trainable",
                      "optimize_attr", "regularizer", "need_clip"):
                setattr(nv, a, getattr(v, a))
            blk.vars[name] = nv
        for op in self.global_block.ops:
            attrs = dict(op.attrs)
            if for_test and op.type == "dropout":
                attrs["p"] = 0.0
            blk.append_op(Operator(op.type, op.fn, list(op.input_names),
                                   list(op.output_names), attrs, op.uid))
        p._constants = dict(self._constants)
        p._lr_getter = self._lr_getter
        p.random_seed = self.random_seed
        return p

    def __str__(self):
        lines = [f"Program(ops={len(self.global_block.ops)})"]
        for v in self.global_block.vars.values():
            tag = "param" if v.is_parameter else ("data" if v.is_data
                                                  else "tmp")
            shape, dtype = _meta_of(v)
            lines.append(f"  var {v.name}: {list(shape)} {dtype} [{tag}]")
        for op in self.global_block.ops:
            lines.append(f"  {op!r}")
        return "\n".join(lines)

    def to_string(self, throw_on_error=False, with_details=False):
        return str(self)

    def bump(self):
        self._version += 1


# -- defaults / guards ------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _main_program, _startup_program
    old_main, old_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = old_main, old_startup


@contextlib.contextmanager
def name_scope(prefix=None):
    with unique_name.guard(prefix + "/" if prefix else None):
        yield


# -- scope ------------------------------------------------------------------


class Scope:
    """ref: framework/scope.h — name -> tensor. The Executor updates the
    persistables in place, in these tensors' storage."""

    def __init__(self):
        self._vars: dict[str, torch.Tensor] = {}

    def var(self, name):
        return self._vars.get(name)

    def find_var(self, name):
        return self._vars.get(name)

    def set(self, name, value):
        self._vars[name] = value

    def drop_kids(self):
        self._vars.clear()


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = old


# -- data placeholder -------------------------------------------------------


def data(name, shape, dtype="float32", lod_level=0):
    """ref: fluid.data / static.data: a feed Variable of the current
    main program; ``-1``/``None`` dims are dynamic."""
    return default_main_program().global_block.create_var(
        name=name, shape=shape, dtype=dtype, is_data=True,
        stop_gradient=True)


# -- the recorder -----------------------------------------------------------

# op types of the torch calls the mode records, under the JAX registry's
# names where the JAX package has the op
_TORCH_OP_TYPES = {
    "add": "add", "__add__": "add", "__radd__": "add",
    "sub": "subtract", "__sub__": "subtract", "__rsub__": "subtract",
    "mul": "multiply", "__mul__": "multiply", "__rmul__": "multiply",
    "div": "divide", "__truediv__": "divide", "__rtruediv__": "divide",
    "matmul": "matmul", "__matmul__": "matmul", "neg": "neg",
    "__neg__": "neg", "reshape": "reshape", "view": "reshape",
    "__getitem__": "slice", "transpose": "transpose",
    "permute": "transpose", "to": "cast", "float": "cast",
    "sum": "reduce_sum", "mean": "reduce_mean",
}


def _torch_op_type(func):
    name = getattr(func, "__name__", None) or str(func)
    return _TORCH_OP_TYPES.get(name, name.strip("_"))


class _TorchCall:
    """A recorded torch call: ``func`` with its non-tensor arguments
    fixed and its tensor arguments taken positionally."""

    __slots__ = ("func", "leaves", "slots", "spec")

    def __init__(self, func, leaves, slots, spec):
        self.func, self.slots, self.spec = func, slots, spec
        self.leaves = [None if i in slots else leaf
                       for i, leaf in enumerate(leaves)]

    def __call__(self, *tensors):
        leaves = list(self.leaves)
        for i, t in zip(self.slots, tensors):
            leaves[i] = t
        args, kwargs = tree_unflatten(leaves, self.spec)
        return self.func(*args, **kwargs)

    def __repr__(self):
        return f"_TorchCall({getattr(self.func, '__name__', self.func)})"


class ProgramRecorder(TorchFunctionMode):
    """Records ops into the current default main program (ref: the
    imperative tracer flipped: recording at build time, execution at run
    time). See the module docstring for its two hooks."""

    @property
    def program(self):
        return default_main_program()

    # -- shared -------------------------------------------------------------
    @staticmethod
    def sees(args, kwargs):
        return any(isinstance(a, Variable) for a in args) or \
            any(isinstance(a, Variable) for a in kwargs.values())

    def _var_of(self, x):
        """The name of the variable ``x`` reads: a Variable's own; a
        concrete tensor becomes a captured constant."""
        if x is None:
            return None
        if isinstance(x, Variable):
            return x.name
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        name = unique_name.generate("const")
        self.program.global_block.create_var(name=name, shape=x.shape,
                                             dtype=x.dtype)
        self.program._constants[name] = x
        return name

    def _outputs(self, op_type, out, ins):
        """Variables for the meta result ``out`` (a tensor or a tuple of
        them) of an op of ``op_type`` reading ``ins``."""
        blk = self.program.global_block
        multi = isinstance(out, (tuple, list))
        outs = tuple(out) if multi else (out,)
        any_grad = any(isinstance(a, Variable) and not a.stop_gradient
                       for a in ins)
        vs = []
        for o in outs:
            if not isinstance(o, torch.Tensor):
                raise TypeError(f"op {op_type} returned "
                                f"{type(o).__name__}, not a tensor")
            with torch._C.DisableTorchFunction():
                shape, dtype = tuple(o.shape), o.dtype
            vs.append(blk.create_var(
                name=unique_name.generate(op_type + ".out"), shape=shape,
                dtype=dtype, stop_gradient=not any_grad))
        return vs, multi

    def _append(self, op, vs, multi):
        self.program.global_block.append_op(op)
        self.program.bump()
        return tuple(vs) if multi else vs[0]

    # -- registry ops ---------------------------------------------------------
    def record_op(self, op_type, fn, ins, attrs):
        """Record op ``op_type`` (``fn(*ins, **attrs)``) as one
        Operator."""
        names = [self._var_of(a) for a in ins]
        metas = [a if a is None or isinstance(a, Variable)
                 else self.program._constants[n].to("meta")
                 for a, n in zip(ins, names)]
        with torch._C.DisableTorchFunction(), kernels.plain_versions():
            out = fn(*metas, **attrs)
        vs, multi = self._outputs(op_type, out, ins)
        return self._append(Operator(op_type, fn, names,
                                     [v.name for v in vs], dict(attrs)),
                            vs, multi)

    # -- any other torch call on a Variable -----------------------------------
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves, spec = tree_flatten((args, kwargs))
        if not any(isinstance(x, Variable) for x in leaves):
            return func(*args, **kwargs)
        slots = [i for i, x in enumerate(leaves)
                 if isinstance(x, torch.Tensor)]
        metas = [x.to("meta") if i in slots and not isinstance(x, Variable)
                 else x for i, x in enumerate(leaves)]
        margs, mkwargs = tree_unflatten(metas, spec)
        with torch._C.DisableTorchFunction():
            out = func(*margs, **mkwargs)
        flat, _ = tree_flatten(out)
        if not any(isinstance(o, torch.Tensor) for o in flat):
            return out          # x.shape, x.dim(), x.dtype: no op
        if any(o is x for o in flat for x in leaves
               if isinstance(x, Variable)):
            raise NotImplementedError(
                f"in-place {getattr(func, '__name__', func)} on a static "
                "Variable is not recorded; use Variable.set_value")
        ins = [leaves[i] for i in slots]
        names = [self._var_of(x) for x in ins]
        op_type = _torch_op_type(func)
        vs, multi = self._outputs(op_type, out, ins)
        return self._append(Operator(op_type, _TorchCall(func, leaves, slots,
                                                      spec),
                                     names, [v.name for v in vs], {}),
                            vs, multi)

    def record_assign(self, target, value):
        from ..ops._base import OP_REGISTRY, register

        if "assign_to" not in OP_REGISTRY:
            register("assign_to", inputs=("x",))(lambda x: x)
        vname = self._var_of(value)
        self.program.global_block.append_op(Operator(
            "assign_to", OP_REGISTRY["assign_to"], [vname], [target.name],
            {}))
        self.program.bump()
