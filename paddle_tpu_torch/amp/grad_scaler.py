"""Loss scaling: ``StaticLossScaler``, ``DynamicLossScaler`` and
``GradScaler``.

The counterparts of ``paddle_tpu/amp/grad_scaler.py``'s (:22-176). A
scaler's state — ``scale`` (float32), ``good`` and ``bad`` (int32) — is
0-d tensors on the device, and ``update_state`` advances it from the
step's finite-check flag with ``torch.where`` as the reference does
(:56-72), reading nothing back to the host, so ``TrainStep(scaler=...)``
runs the whole scaled step — scale, unscale, finite check, the skipped or
applied update, the scale's advance — on the device, captured or not.

``GradScaler`` keeps the reference's explicit eager protocol::

    scaled = scaler.scale(loss); scaled.backward()
    scaler.step(opt); scaler.update()

with its state on the device as well: ``unscale_`` divides the
gradients by the scale in their type and sets the device flag,
``step`` runs the optimizer with that flag (an overflowed step leaves
every value as it was, on the device, where the reference skips the call
on the host; ``_global_step`` counts the call either way), ``update``
advances the state. ``state_dict`` reads the state to the host.
"""
from __future__ import annotations

import torch

from .._device import resolve_device

__all__ = ["StaticLossScaler", "DynamicLossScaler", "GradScaler"]


def _scalar(value, dtype, device):
    return torch.full((), value, dtype=dtype, device=device)


class StaticLossScaler:
    """A constant loss scale."""

    use_dynamic = False

    def __init__(self, init_loss_scaling=2.0 ** 15):
        self.loss_scaling = float(init_loss_scaling)

    def state(self, device=None):
        """The initial state on ``device`` (the card unless ``"cpu"``)."""
        dev = resolve_device(device)
        return {"scale": _scalar(self.loss_scaling, torch.float32, dev),
                "good": _scalar(0, torch.int32, dev)}

    def update_state(self, state, found_inf):
        return state


class DynamicLossScaler:
    """Grow the scale by ``incr_ratio`` after ``incr_every_n_steps`` clean
    steps; shrink it by ``decr_ratio`` (not below 1) after
    ``decr_every_n_nan_or_inf`` overflowed ones."""

    use_dynamic = True

    def __init__(self, init_loss_scaling=2.0 ** 15, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1):
        self.loss_scaling = float(init_loss_scaling)
        self.incr_ratio = float(incr_ratio)
        self.decr_ratio = float(decr_ratio)
        self.incr_every_n_steps = int(incr_every_n_steps)
        self.decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)

    def state(self, device=None):
        """The initial state on ``device`` (the card unless ``"cpu"``)."""
        dev = resolve_device(device)
        return {"scale": _scalar(self.loss_scaling, torch.float32, dev),
                "good": _scalar(0, torch.int32, dev),
                "bad": _scalar(0, torch.int32, dev)}

    def update_state(self, state, found_inf):
        """The next state from ``found_inf`` (a 0-d bool tensor), as new
        tensors."""
        scale, good = state["scale"], state["good"]
        bad = state.get("bad")
        if bad is None:
            bad = torch.zeros_like(good)
        good_new = torch.where(found_inf, 0, good + 1)
        bad_new = torch.where(found_inf, bad + 1, 0)
        grow = good_new >= self.incr_every_n_steps
        shrink = bad_new >= self.decr_every_n_nan_or_inf
        scale_new = torch.where(
            shrink, torch.clamp_min(scale * self.decr_ratio, 1.0),
            torch.where(grow, scale * self.incr_ratio, scale))
        good_new = torch.where(grow, 0, good_new)
        bad_new = torch.where(shrink, 0, bad_new)
        return {"scale": scale_new.to(torch.float32),
                "good": good_new.to(torch.int32),
                "bad": bad_new.to(torch.int32)}


class GradScaler(DynamicLossScaler):
    """``paddle.amp.GradScaler`` over the dynamic scaler. Pass it to
    ``TrainStep(scaler=...)``, or drive it eagerly (the module's
    docstring). Its state is made on the device of the first loss it
    scales (or of ``device`` in ``load_state_dict``)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        super().__init__(init_loss_scaling, incr_ratio, decr_ratio,
                         incr_every_n_steps, decr_every_n_nan_or_inf)
        self._enable = bool(enable)
        self.use_dynamic = bool(use_dynamic_loss_scaling)
        self._state = None
        self._found_inf = None
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self.use_dynamic

    def _state_on(self, device=None):
        if self._state is None:
            self._state = self.state(device)
        return self._state

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._state_on(loss.device)["scale"]

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient by the scale, in its own type, and set
        the device flag of a non-finite one."""
        if not self._enable or self._unscaled:
            return
        params = [p for _, p in optimizer._named_params if p.grad is not None]
        if params:
            inv = 1.0 / self._state_on(params[0].device)["scale"]
            flags = []
            for p in params:
                p.grad = p.grad * inv
                flags.append(~torch.isfinite(p.grad).all())
            self._found_inf = torch.stack(flags).any()
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        optimizer.step(found_inf=self._found_inf)

    def minimize(self, optimizer, scaled_loss):
        del scaled_loss  # backward already ran on it
        self.step(optimizer)
        self.update()

    def notify_skip(self, device=None):
        """Record an externally-discarded step (``resilience.GuardedStep``'s
        skip_step / rollback policies) as a found-inf event: the dynamic
        loss scale shrinks exactly as it would for an in-graph overflow
        (reference ``grad_scaler.py:130-138``). ``device`` is where the
        state is made if it does not exist yet."""
        if not self._enable:
            return
        state = self._state_on(device)
        self._found_inf = torch.ones((), dtype=torch.bool,
                                     device=state["scale"].device)
        self.update()

    @torch.no_grad()
    def update(self):
        if not self._enable:
            return
        if self.use_dynamic:
            state = self._state_on()
            found = self._found_inf
            if found is None:
                found = torch.zeros((), dtype=torch.bool,
                                    device=state["scale"].device)
            for k, v in self.update_state(state, found).items():
                state[k].copy_(v)
        self._found_inf = None
        self._unscaled = False

    def state_dict(self):
        """The state as host numbers (reads the device)."""
        state = self._state_on()
        return {"scale": float(state["scale"]),
                "incr_ratio": self.incr_ratio,
                "decr_ratio": self.decr_ratio,
                "incr_every_n_steps": self.incr_every_n_steps,
                "good_steps": int(state["good"]),
                "bad_steps": int(state["bad"])}

    def load_state_dict(self, state, device=None):
        s = self._state_on(device)
        s["scale"].fill_(float(state["scale"]))
        s["good"].fill_(int(state.get("good_steps", 0)))
        s["bad"].fill_(int(state.get("bad_steps", 0)))
