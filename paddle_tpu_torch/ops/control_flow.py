"""Control flow, the counterparts of ``paddle_tpu/ops/control_flow.py``'s
``cond``, ``while_loop``, ``case``, ``switch_case`` and ``scan``.

The JAX package runs a concrete predicate's branch in Python
(``control_flow.py:36-39, 52-57``) and hands a traced one to
``lax.cond``/``lax.while_loop``/``lax.switch``. Here every predicate is
read and one branch runs in Python:

- a Python value or a tensor on the host is read as it is;
- a tensor on the card is read back to the host (a sync), outside a
  CUDA graph capture. A capture cannot read a device value, so a
  capture that reaches such a read raises ``RuntimeError`` naming the
  op: no branch is ever picked silently. ``framework.TrainStep`` marks
  the step that made such a read (``DEVICE_READS``) and runs that
  batch signature op by op from then on, never captured
  (``TrainStep.uncaptured``).

Gradients flow through the branch that ran, by autograd. (The JAX
package's ``TrainStep`` traces the predicate, so ``lax.cond`` takes the
branch and its tape sees none of the branch's ops: a parameter trained
through ``cond`` or ``scan`` there gets no gradient. ROADMAP lists that
among the reference's behaviours that are not port faults.)

``scan(f, init, xs)`` is a Python loop over the leading axis of ``xs``
(a tensor, or a tuple, list or dict of them) that stacks the ``ys``
``f`` returns, with ``reverse`` and ``length`` as ``lax.scan`` takes
them (``unroll`` changes nothing here). It reads nothing back, so it
captures into a CUDA graph like the port's recurrent ``rnn``.

In a static Program (a ``Variable`` predicate), ``cond``, ``while_loop``,
``case`` and ``switch_case`` raise ``NotImplementedError``: the JAX
package's fail there too (``cond`` with a ``TypeError``, the
``ShapeDtypeStruct`` of a Variable not being a JAX type;
``while_loop`` with an ``AttributeError``).
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["cond", "while_loop", "case", "switch_case", "scan",
           "DEVICE_READS"]

# None, or the list of ops that read a predicate on the card during the
# step that ``framework.TrainStep`` is running (it sets the list and
# reads it after the step); a host collective across ranks
# (``dist.collective``) adds "collective"
DEVICE_READS = [None]


def _static(v):
    return isinstance(v, torch.Tensor) and v.device.type == "meta"


def _read(v, op):
    """A predicate or branch index as a Python value: read on the host,
    back from the card when it lies there (never inside a capture)."""
    if _static(v):
        raise NotImplementedError(
            f"{op} on a static Program Variable is not supported: the JAX "
            "package's static recorder fails there too (cond raises "
            "TypeError, a ShapeDtypeStruct not being a valid JAX type; "
            "while_loop raises AttributeError)")
    if not isinstance(v, torch.Tensor):
        return v
    if v.device.type == "cuda":
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{op} reads its predicate on the card, which a CUDA graph "
                "capture cannot do: run this step without a graph "
                "(TrainStep does so by itself for its batch signature)")
        if DEVICE_READS[0] is not None:
            DEVICE_READS[0].append(op)
    return v.item()


def cond(pred, true_fn=None, false_fn=None, name=None):
    """``true_fn()`` if ``pred`` holds, else ``false_fn()`` (None without
    one)."""
    if bool(_read(pred, "cond")):
        return true_fn() if true_fn is not None else None
    return false_fn() if false_fn is not None else None


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """``loop_vars = body_fn(*loop_vars)`` while ``cond_fn(*loop_vars)``
    holds; the final ``loop_vars`` as a list."""
    vars_ = list(loop_vars)
    while bool(_read(cond_fn(*vars_), "while_loop")):
        out = body_fn(*vars_)
        vars_ = list(out) if isinstance(out, (list, tuple)) else [out]
    return vars_


def case(pred_fn_pairs, default=None, name=None):
    """The function of the first ``(pred, fn)`` pair whose ``pred``
    holds, else ``default``; ``ValueError`` without either."""
    for pred, fn in pred_fn_pairs:
        if bool(_read(pred, "case")):
            return fn()
    if default is not None:
        return default()
    raise ValueError("no branch taken in case() and no default provided")


def switch_case(branch_index, branch_fns, default=None, name=None):
    """``branch_fns[branch_index]()`` (a dict by key, or a list by
    position); an index with no branch takes ``default``, or the last
    branch without one."""
    i = int(_read(branch_index, "switch_case"))
    if isinstance(branch_fns, dict):
        if i in branch_fns:
            return branch_fns[i]()
        fns = [branch_fns[k] for k in sorted(branch_fns)]
    else:
        fns = list(branch_fns)
        if 0 <= i < len(fns):
            return fns[i]()
    return default() if default is not None else fns[-1]()


def scan(f, init, xs, length=None, reverse=False, unroll=1):
    """``carry, y = f(carry, x)`` over the leading axis of ``xs`` (from
    the last step back with ``reverse``): ``(final carry, ys stacked in
    ``xs``' order)``. ``xs`` None runs ``length`` steps with ``x``
    None."""
    leaves, spec = tree_flatten(xs)
    n = int(length) if length is not None else leaves[0].shape[0]
    carry = init
    ys = [None] * n
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        x = None if xs is None else tree_unflatten([v[i] for v in leaves],
                                                   spec)
        carry, ys[i] = f(carry, x)
    if not n or ys[0] is None:
        return carry, None
    flat = [tree_flatten(y)[0] for y in ys]
    stacked = [torch.stack(col) for col in zip(*flat)]
    return carry, tree_unflatten(stacked, tree_flatten(ys[0])[1])
