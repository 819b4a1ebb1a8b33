"""The op registry and the static-mode recording hook.

The counterpart of ``paddle_tpu/ops/_base.py``'s ``register`` and of the
dispatcher's tracer hook (``core/dispatch``). The JAX package sends
every op through one dispatcher, which a static Program's tracer
intercepts; the port has no dispatcher, so the ops a static Program
records as one ``Operator`` each carry this decorator instead:

    @register("conv2d", inputs=("x", "weight"))
    def _conv2d(x, weight, *, stride, padding, dilation, groups): ...

``inputs`` names the tensor arguments (a Program's input variables, in
this order; ``None`` for an absent optional one; a ``*xs`` argument
stands for its tensors, as ``concat``'s does); every other argument is
an attribute of the op. ``OP_REGISTRY[name]`` is the plain function,
which a Program's ``Operator`` holds and its replay calls as
``fn(*inputs, **attrs)``. The decorated function runs the plain one,
unless a static Program is being recorded (``static_.enable_static``)
and one of its arguments is a Program ``Variable``: then the recorder
(``RECORDER[0]``) appends one ``Operator`` and returns its output
Variables.

It is also where ``amp.auto_cast`` casts, as the JAX dispatcher does
(``core/dispatch.py:211-218``): while an ``auto_cast`` is active in any
thread (``AMP_ACTIVE[0]`` counts them), the op goes through
``amp.autocast.amp_call``, which casts its tensor inputs by the op's
``name`` and the calling thread's lists. Without one, the op costs one
more ``if``.
"""
from __future__ import annotations

import functools
import inspect

__all__ = ["OP_REGISTRY", "RECORDER", "AMP_ACTIVE", "register"]

OP_REGISTRY: dict = {}
# the active static-mode recorder, or None (static_.enable_static sets it)
RECORDER = [None]
# the auto_cast contexts active in the process (amp.autocast keeps it)
AMP_ACTIVE = [0]


def register(name, inputs):
    """Register ``fn`` as op ``name`` whose tensor arguments are
    ``inputs``; see the module docstring."""
    inputs = tuple(inputs)

    def deco(fn):
        OP_REGISTRY[name] = fn
        sig = inspect.signature(fn)
        star = {n for n, p in sig.parameters.items()
                if p.kind is p.VAR_POSITIONAL}

        @functools.wraps(fn)
        def op(*args, **kwargs):
            rec = RECORDER[0]
            if rec is not None and rec.sees(args, kwargs):
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                ins = []
                for n in inputs:
                    if n in star:
                        ins.extend(bound.arguments.get(n, ()))
                    else:
                        ins.append(bound.arguments[n])
                attrs = {k: v for k, v in bound.arguments.items()
                         if k not in inputs}
                return rec.record_op(name, fn, ins, attrs)
            if AMP_ACTIVE[0]:
                from ..amp.autocast import amp_call

                return amp_call(name, fn, sig, inputs, args, kwargs)
            return fn(*args, **kwargs)

        op.raw = fn
        return op

    return deco
