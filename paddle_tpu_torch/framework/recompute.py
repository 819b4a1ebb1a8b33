"""Recompute (gradient checkpointing).

The counterpart of ``paddle_tpu/framework/recompute.py`` (ref: the
reference's forward recomputation, ``RecomputeOptimizer``'s segments).
The JAX package wraps the segment in ``jax.checkpoint``; here it is an
``autograd.Function`` of the port's own (``_Segment``): its forward runs
the segment without a graph, keeping only the segment's inputs; its
backward runs the segment's forward again with a graph and
differentiates it for the inputs and the parameters. It trades
operations for device memory, the usual lever for deep transformer
stacks; it works op by op and inside ``TrainStep``'s CUDA graph (the
recomputed forward is captured with the backward).
``torch.utils.checkpoint`` is not used: its first call imports
``torch._dynamo`` (13 s of host time on the machine with the H100).

Two things of the forward must come back as they were in the recomputed
one:

- the dropout masks. Dropout draws from the port's own generators
  (``core.random``), not from torch's default one, so the checkpoint's
  ``preserve_rng_state`` would not cover them. The segment's forward
  records each mask it draws (``ops.random_ops.MASK_TAPE``), and the
  recomputed forward takes them back in order instead of drawing: the
  same masks, and the generator advances as much as it does without
  recompute, so later draws do not move. Nothing is read from or
  written to a generator's state, so a captured step replays it as it
  is. The masks (one byte an element) are what a dropout segment keeps
  beside its inputs;
- the ``amp.auto_cast`` state, which is the calling thread's, while the
  backward (and with it the recompute) may run in autograd's own
  thread: the recomputed forward runs under the state the forward saw.

As in the reference, the segment must not mutate buffers: a BatchNorm's
running statistics updated inside it would be updated again by the
recompute.
"""
from __future__ import annotations

import contextlib

import torch

from ..amp import autocast
from ..ops import _base, random_ops

__all__ = ["recompute", "Recompute"]


class _Tape:
    """The masks one segment's forward drew, replayed in its recompute."""

    def __init__(self):
        self.masks = []
        self.amp = None

    @contextlib.contextmanager
    def recording(self):
        self.amp = autocast.amp_state()
        prev, random_ops.MASK_TAPE[0] = random_ops.MASK_TAPE[0], \
            (self.masks, None)
        try:
            yield
        finally:
            random_ops.MASK_TAPE[0] = prev

    @contextlib.contextmanager
    def replaying(self):
        prev, random_ops.MASK_TAPE[0] = random_ops.MASK_TAPE[0], \
            (None, iter(self.masks))
        stack = autocast._stack()
        stack.append(self.amp)
        _base.AMP_ACTIVE[0] += 1
        try:
            yield
        finally:
            _base.AMP_ACTIVE[0] -= 1
            stack.pop()
            random_ops.MASK_TAPE[0] = prev


class _Segment(torch.autograd.Function):
    """``function(*args, **kwargs)`` checkpointed; ``tensors`` are the
    args (tensors), then the parameters the backward differentiates."""

    @staticmethod
    def forward(ctx, function, kwargs, n_args, *tensors):
        tape = _Tape()
        ctx.function, ctx.kwargs, ctx.tape = function, kwargs, tape
        ctx.params = tensors[n_args:]
        ctx.save_for_backward(*tensors[:n_args])
        with tape.recording():
            out = function(*tensors[:n_args], **kwargs)
        ctx.multi = isinstance(out, tuple)
        return out

    @staticmethod
    def backward(ctx, *grads):
        args = [a.detach().requires_grad_(a.requires_grad)
                for a in ctx.saved_tensors]
        with torch.enable_grad(), ctx.tape.replaying():
            out = ctx.function(*args, **ctx.kwargs)
        outs = out if ctx.multi else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [t for t in (*args, *ctx.params) if t.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True) if pairs and wrt else ())
        return (None, None, None,
                *[next(got) if t.requires_grad else None
                  for t in (*args, *ctx.params)])


def _segment_params(function, models):
    """The parameters of ``function`` (a module) and of ``models``."""
    mods = ([function] if isinstance(function, torch.nn.Module) else []) + \
        list(models or ())
    seen, out = set(), []
    for m in mods:
        for p in m.parameters():
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
    return out


def recompute(function, *args, models=None, **kwargs):
    """``function(*args, **kwargs)`` under gradient checkpointing.

    ``function`` is a module (its parameters are found) or any callable
    of tensors (pass the modules it closes over as ``models``); ``args``
    are tensors. Without a gradient to take (no grad mode, or nothing
    that needs one) it is ``function(*args, **kwargs)``."""
    params = _segment_params(function, models)
    if not torch.is_grad_enabled() or not any(
            t.requires_grad for t in (*args, *params)):
        return function(*args, **kwargs)
    return _Segment.apply(function, kwargs, len(args), *args, *params)


class Recompute:
    """``Recompute(block)(x)`` is ``block(x)`` checkpointed (ref:
    ``RecomputeOptimizer``'s segment list)."""

    def __init__(self, layer):
        self._layer = layer

    def __call__(self, *args, **kwargs):
        return recompute(self._layer, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.__dict__["_layer"], name)
