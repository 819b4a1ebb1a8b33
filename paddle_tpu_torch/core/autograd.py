"""``grad``, ``no_grad``, ``enable_grad`` and ``is_grad_enabled``: the
counterparts of ``paddle_tpu/core/autograd.py:112-143`` and
``core/dispatch.py``'s grad modes, on torch's autograd.

``grad`` follows the reference's signature: ``outputs`` and ``inputs``
may be single tensors or lists, ``grad_outputs`` defaults to ones,
``retain_graph`` to ``create_graph``, and an input the outputs do not
reach raises unless ``allow_unused`` (then its gradient is None). The
result is always a list, of Paddle ``Tensor``s when an output or input
was one (the tensors themselves go to torch's autograd: an alias is
not the tensor the graph used). With ``create_graph`` the gradients
stay on the tape, as torch keeps them; the reference returns them off
its tape (ROADMAP Queue 3, "not port faults").
"""
from __future__ import annotations

import torch

from .tensor import Tensor, plain, wrap

__all__ = ["grad", "no_grad", "enable_grad", "is_grad_enabled"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """The gradients of ``outputs`` with respect to ``inputs``, a list
    (ref: ``python/paddle/fluid/dygraph/base.py`` ``grad``)."""
    del only_inputs
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
        else [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    grad_outputs = [torch.ones_like(plain(o)) if g is None else plain(g)
                    for o, g in zip(outputs, grad_outputs)]
    keep = create_graph if retain_graph is None else retain_graph
    seen = any(isinstance(t, Tensor) for t in outputs + inputs)
    with torch._C.DisableTorchFunctionSubclass():
        out = list(torch.autograd.grad(outputs, inputs, grad_outputs,
                                       retain_graph=keep,
                                       create_graph=create_graph,
                                       allow_unused=allow_unused))
    return wrap(out) if seen else out
