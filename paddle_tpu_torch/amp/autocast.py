"""``auto_cast``: per-op mixed precision (level O1).

The counterpart of ``paddle_tpu/amp/autocast.py`` (ref: ``paddle.amp
.auto_cast``, fluid's ``amp_guard``). The JAX package casts inside its
one dispatcher; the port's counterpart of that dispatcher is the
``register`` wrapper of ``ops/_base.py``, which every op the lists name
goes through. While an ``auto_cast`` is active in the calling thread,
the wrapper hands the op to ``amp_call``: the op's floating tensor
inputs go to the half type if its registered name is white-listed and
to float32 if it is black-listed (``cast_op_inputs``), then it runs.
The casts are ``.to(dtype)`` inside autograd, so gradients arrive in
the parameters' own type, as the reference's vjp gives them. Ops an op
calls inside itself are its own arithmetic and are not cast again.

O1: parameters stay float32, white-listed ops compute in the half type.
O2: ``amp.decorate`` casts the model to the half type with float32
masters in the optimizer; black-listed ops still run in float32.

A captured step replays the casts it captured, so ``framework``'s
graph caches key on ``amp_key()``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..ops import _base
from .lists import AutoMixedPrecisionLists

__all__ = ["auto_cast", "amp_guard", "amp_state", "amp_key",
           "cast_op_inputs", "amp_call"]

_tls = threading.local()
_HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _stack():
    if not hasattr(_tls, "amp_stack"):
        _tls.amp_stack = []
    return _tls.amp_stack


class _AmpState:
    __slots__ = ("dtype", "lists")

    def __init__(self, dtype, lists):
        self.dtype = dtype
        self.lists = lists


def amp_state():
    """The innermost active ``auto_cast`` state of this thread, or None
    (also inside a registered op, whose own ops are not cast again)."""
    st = _stack()
    return st[-1] if st else None


def amp_key():
    """What a captured program depends on of the active state: ``None``,
    or the half type and the resolved lists."""
    st = amp_state()
    if st is None:
        return None
    return (st.dtype, frozenset(st.lists.white_list),
            frozenset(st.lists.black_list))


def _cast(x, dtype):
    if isinstance(x, torch.Tensor) and x.is_floating_point() and \
            x.dtype != dtype:
        return x.to(dtype)
    return x


def cast_op_inputs(name, arrays):
    """The active policy applied to one op's inputs (``name`` its
    registered name): a list of the same length."""
    state = amp_state()
    if state is None:
        return arrays
    if name in state.lists.white_list:
        return [_cast(a, state.dtype) for a in arrays]
    if name in state.lists.black_list:
        return [_cast(a, torch.float32) for a in arrays]
    return arrays


def amp_call(name, fn, sig, inputs, args, kwargs):
    """Run the registered op ``name`` (plain function ``fn``, signature
    ``sig``, tensor arguments ``inputs``) under the active policy; ops
    ``fn`` calls run uncast."""
    if amp_state() is None:
        return fn(*args, **kwargs)
    bound = sig.bind(*args, **kwargs)
    present = [n for n in inputs if n in bound.arguments]
    cast = cast_op_inputs(name, [bound.arguments[n] for n in present])
    for n, v in zip(present, cast):
        bound.arguments[n] = v
    st = _stack()
    st.append(None)
    try:
        return fn(*bound.args, **bound.kwargs)
    finally:
        st.pop()


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """``paddle.amp.auto_cast`` / fluid ``amp_guard``: ``dtype`` is
    ``'bfloat16'`` or ``'float16'``."""
    if not enable:
        yield
        return
    if level not in ("O1", "O2"):
        raise ValueError(f"level must be O1 or O2, got {level}")
    if dtype not in _HALF:
        raise ValueError(f"dtype must be bfloat16 or float16, got {dtype!r}")
    lists = AutoMixedPrecisionLists(custom_white_list, custom_black_list)
    _stack().append(_AmpState(_HALF[dtype], lists))
    _base.AMP_ACTIVE[0] += 1
    try:
        yield
    finally:
        _base.AMP_ACTIVE[0] -= 1
        _stack().pop()


amp_guard = auto_cast  # the fluid-era name
