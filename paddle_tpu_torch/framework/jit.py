"""``TrainStep``: one training step — forward, backward, clip, update.

The counterpart of ``paddle_tpu/framework/jit.py``'s ``TrainStep``
(:67-105, :402-457) in plain eager PyTorch: where the JAX package jits
the whole step into one donated executable, this runs the forward,
``loss.backward()``, the optimizer's clip and its in-place update, op by
op. ``last_found_inf`` and ``check_nan`` behave as in ``_make_apply``
(:268-331): with ``check_nan`` the step flags a non-finite loss or
gradient on the device, still applies the update (there is no scaler to
skip it), then raises ``FloatingPointError`` on the host.

Not ported yet: the loss scaler, ``run_fused`` (K steps in one
program), the gradient-exchange paths, the AOT executable cache, and
CUDA graphs or ``torch.compile`` of the step.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, optimizer, loss_fn); loss = step(*batch)``.

    ``loss_fn(model, *batch)`` returns a scalar loss tensor. Batch items
    that are numpy arrays are moved to the model's device. Returns the
    loss of this step (computed before the update), detached."""

    def __init__(self, model, optimizer, loss_fn, check_nan=False):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.check_nan = check_nan
        self.last_found_inf = None

    def _device(self):
        return next(self.model.parameters()).device

    def step(self, *batch):
        dev = self._device()
        batch = [torch.from_numpy(np.ascontiguousarray(b)).to(dev)
                 if isinstance(b, np.ndarray) else b for b in batch]
        opt = self.optimizer
        opt.clear_grad()
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        with torch.no_grad():
            if self.check_nan:
                flags = [~torch.isfinite(loss).all()]
                flags += [~torch.isfinite(p.grad).all()
                          for _, p in opt._named_params if p.grad is not None]
                found = torch.stack(flags).any()
            else:
                found = torch.zeros((), dtype=torch.bool, device=dev)
        opt.step()
        # the raw device flag, read without a host sync
        self.last_found_inf = found
        if self.check_nan and bool(found):
            raise FloatingPointError(
                f"NaN/Inf in loss or gradients at step {opt._global_step} "
                f"(loss={float(loss)})")
        return loss.detach()

    __call__ = step
