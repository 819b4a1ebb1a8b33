"""Static-graph autodiff: ``append_backward`` / ``gradients``.

The counterpart of ``paddle_tpu/static_/backward.py`` (ref:
``python/paddle/fluid/backward.py``), with the same program structure: a
``fill_ones_like`` seed, one ``<type>@grad`` op for each differentiated
op in reverse order (inputs: the forward op's inputs, then the gradients
of its outputs; outputs: one gradient per input, a ``_gsink_<n>`` name
where the input takes none), ``fill_zeros_like`` for an output without a
gradient yet, and ``grad_accumulate`` where a variable feeds several ops.
Gradients are named ``<var>@GRAD``.

The JAX package's ``@grad`` op is ``jax.vjp`` of the forward function,
which recomputes the forward inside the grad op; XLA merges the two
within one executable. Replayed in PyTorch that would run every forward
op twice a step. So a ``@grad`` op's function (``GradFn``) has two ways
to run:

- the Executor's replay runs each differentiated forward op on inputs
  detached from what came before, those it differentiates needing
  gradients, keeps the op's inputs and outputs, and its ``@grad`` op
  calls ``torch.autograd.grad`` on that saved graph (``GradFn.apply``):
  each forward op runs once, and each backward is the one autograd
  would run for the op;
- called as a plain function of (inputs, output gradients), it runs the
  forward again and differentiates it (the verifier's shape inference
  on ``meta``, and a replay whose forward op a pass removed).
"""
from __future__ import annotations

import torch

from ..utils import unique_name
from .program import Operator, default_main_program

__all__ = ["append_backward", "gradients", "grad_name", "GradFn"]


def grad_name(name):
    return name + "@GRAD"


class GradFn:
    """The function of the ``@grad`` op of ``fwd_op``: gradients of the
    inputs at positions ``wrt`` (``None`` at the others)."""

    __slots__ = ("fwd_uid", "fn", "attrs", "n_inputs", "wrt")

    def __init__(self, fwd_op, wrt):
        self.fwd_uid = fwd_op.uid
        self.fn, self.attrs = fwd_op.fn, fwd_op.attrs
        self.n_inputs = len(fwd_op.input_names)
        self.wrt = tuple(wrt)

    def leaves(self, xs):
        """The forward op's inputs as the replay runs it: those at ``wrt``
        detached and needing gradients."""
        return [x.detach().requires_grad_() if i in self.wrt else x
                for i, x in enumerate(xs)]

    def apply(self, leaves, outs, gys):
        """The input gradients from the forward's saved graph."""
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, gys)
                 if isinstance(o, torch.Tensor) and o.requires_grad]
        wanted = [leaves[i] for i in self.wrt]
        got = torch.autograd.grad([o for o, _ in pairs], wanted,
                                  [g for _, g in pairs], allow_unused=True)
        grads = [None] * self.n_inputs
        for i, x, g in zip(self.wrt, wanted, got):
            grads[i] = torch.zeros_like(x) if g is None else g
        return tuple(grads)

    def __call__(self, *args):
        xs, gys = args[:self.n_inputs], args[self.n_inputs:]
        leaves = self.leaves(xs)
        with torch.enable_grad():
            outs = self.fn(*leaves, **self.attrs)
        return self.apply(leaves, outs, gys)


def _ensure_grad_var(block, src_var, gname):
    if block.has_var(gname):
        return block.var(gname)
    with torch._C.DisableTorchFunction():
        shape, dtype = tuple(src_var.shape), src_var.dtype
    return block.create_var(name=gname, shape=shape, dtype=dtype)


def _fill_ones_like(x):
    return torch.ones_like(x)


def _fill_zeros_like(x):
    return torch.zeros_like(x)


def _identity(g):
    return g


def _accumulate(a, b):
    return a + b


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, program=None):
    """Append grad ops computing d loss / d params (ref: backward.py).

    Returns a list of ``(param_var, grad_var)``."""
    from ..analysis import verify_program

    program = program or default_main_program()
    block = program.global_block
    no_grad_set = set(no_grad_set or ())

    # differentiating a malformed forward program would crash mid-surgery:
    # check structure up front, with coded diagnostics
    verify_program(program, infer_shapes=False)

    gname = grad_name(loss.name)
    _ensure_grad_var(block, loss, gname)
    block.append_op(Operator("fill_ones_like", _fill_ones_like,
                             [loss.name], [gname], {}))
    have_grad = {loss.name}

    fwd_ops = [op for op in block.ops if not op.type.endswith("@grad")
               and op.type != "fill_ones_like"]
    for op in reversed(fwd_ops):
        if not any(n in have_grad for n in op.output_names):
            continue
        if op.type == "assign_to":
            # pass-through: grad of target flows to source
            src, tgt = op.input_names[0], op.output_names[0]
            if src is not None:
                g_src = _ensure_grad_var(block, block.var(src),
                                         grad_name(src))
                block.append_op(Operator("assign_to@grad", _identity,
                                         [grad_name(tgt)], [g_src.name],
                                         {}))
                have_grad.add(src)
            continue
        g_out_names = []
        for oname in op.output_names:
            go = grad_name(oname)
            if oname not in have_grad:
                _ensure_grad_var(block, block.var(oname), go)
                block.append_op(Operator("fill_zeros_like",
                                         _fill_zeros_like, [oname], [go],
                                         {}))
            g_out_names.append(go)
        grad_outputs = []
        for iname in op.input_names:
            if iname is None or iname in no_grad_set:
                grad_outputs.append(None)
                continue
            iv = block.var(iname)
            if iv.is_data or (iv.stop_gradient and not iv.is_parameter):
                grad_outputs.append(None)
                continue
            grad_outputs.append(iname)
        if not any(g is not None for g in grad_outputs):
            continue

        # each grad op makes fresh partials; a variable that already has
        # a gradient (or appears twice in one op) gets a partial name and
        # an accumulate op (ref: sum_op insertion)
        partial_names = []
        seen_this_op: set[str] = set()
        for iname in grad_outputs:
            if iname is None:
                partial_names.append(unique_name.generate("_gsink"))
            elif iname in have_grad or iname in seen_this_op:
                partial_names.append(
                    unique_name.generate(grad_name(iname) + ".p"))
            else:
                partial_names.append(grad_name(iname))
                seen_this_op.add(iname)
        for iname, pname in zip(grad_outputs, partial_names):
            if iname is not None:
                _ensure_grad_var(block, block.var(iname), pname)
            else:
                block.create_var(name=pname, shape=(), dtype="float32")
        wrt = [i for i, n in enumerate(grad_outputs) if n is not None]
        block.append_op(Operator(
            op.type + "@grad", GradFn(op, wrt),
            list(op.input_names) + g_out_names, partial_names, {}))
        for iname, pname in zip(grad_outputs, partial_names):
            if iname is None:
                continue
            gn = grad_name(iname)
            if iname in have_grad and pname != gn:
                block.append_op(Operator("grad_accumulate", _accumulate,
                                         [gn, pname], [gn], {}))
            have_grad.add(iname)

    params = parameter_list if parameter_list is not None else [
        v for v in block.vars.values() if v.is_parameter]
    out = []
    for p in params:
        if isinstance(p, str):
            p = block.var(p)
        gn = grad_name(p.name)
        if block.has_var(gn) and p.name in have_grad:
            out.append((p, block.var(gn)))
    program.bump()
    # autodiff surgery is the classic source of malformed graphs: the
    # structural verifier again (the Executor runs the full one)
    verify_program(program, infer_shapes=False)
    return out


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """ref: fluid.gradients — grads of ``targets`` (their sum) with
    respect to ``inputs``."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    loss = targets[0]
    for t in targets[1:]:
        loss = loss + t
    pg = append_backward(loss, parameter_list=list(inputs),
                         no_grad_set=no_grad_set)
    got = {p.name: g for p, g in pg}
    block = default_main_program().global_block
    return [block.var(grad_name(i.name)) if block.has_var(grad_name(i.name))
            else got.get(i.name) for i in inputs]
