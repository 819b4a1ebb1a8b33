"""Static-graph mixed precision (fluid's ``contrib.mixed_precision``).

The counterpart of ``paddle_tpu/amp/static_decorator.py`` (ref:
``python/paddle/fluid/contrib/mixed_precision/decorator.py:218``
``decorate`` and ``OptimizerWithMixedPrecision``). The reference rewrites
the ProgramDesc with cast ops by the lists, scales the loss and guards
the update with ``check_finite_and_unscale`` and
``update_loss_scaling``. Here, as in the JAX package:

- the list-driven casts happen where the Executor's replay calls each
  op's function (``static_/executor.py``, ``program._amp_cfg``), so on
  the card they are inside the step's CUDA graph;
- the loss scaling, the finite check with the unscale, the update that
  an inf or NaN leaves undone, and the dynamic scale's update are
  ordinary program ops (``append_amp_backward`` and
  ``append_update_ops(amp_decorator=...)``), with the scale and its
  counters in the scope as ``@amp@scale``, ``@amp@good`` and
  ``@amp@bad``.
"""
from __future__ import annotations

import torch

from .grad_scaler import DynamicLossScaler
from .lists import AutoMixedPrecisionLists

__all__ = ["decorate", "OptimizerWithMixedPrecision"]


class OptimizerWithMixedPrecision:
    """An optimizer wrapped for static-mode AMP training (ref:
    ``decorator.py:40``); made by :func:`decorate`."""

    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
                 dtype="bfloat16"):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._scaler = DynamicLossScaler(
            init_loss_scaling=init_loss_scaling, incr_ratio=incr_ratio,
            decr_ratio=decr_ratio, incr_every_n_steps=incr_every_n_steps,
            decr_every_n_nan_or_inf=decr_every_n_nan_or_inf)
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic = bool(use_dynamic_loss_scaling)
        self._dtype = dtype
        self._scaled_loss = None
        self._params_grads = None
        self._found_inf_name = None

    # -- the reference's accessors -----------------------------------------
    def get_loss_scaling(self):
        """The current loss scale, read from the global scope."""
        from ..static_.program import global_scope

        v = global_scope().find_var("@amp@scale")
        return float(v) if v is not None else self._init_loss_scaling

    def get_scaled_loss(self):
        return self._scaled_loss

    def get_lr(self):  # the Executor feeds @lr through this
        return self._optimizer.get_lr()

    # -- backward / apply_gradients / minimize ------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        """Scale the loss, append the grad ops, then one op that checks
        every gradient and unscales it to float32."""
        from ..static_.executor import append_amp_backward

        self._params_grads, self._found_inf_name = append_amp_backward(
            self, loss, parameter_list)
        return self._params_grads

    def apply_gradients(self, params_grads):
        from ..static_.executor import append_update_ops

        append_update_ops(self._optimizer, params_grads, amp_decorator=self,
                          found_inf_name=self._found_inf_name)
        return []

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        self.apply_gradients(params_grads)
        return None, params_grads

    # -- the rules of the appended ops --------------------------------------
    def check_and_unscale_rule(self, scale, *grads):
        """``(found_inf, *grads / scale in float32)``: the flag is set if
        any gradient holds an inf or a NaN."""
        flags = [~torch.isfinite(g).all() for g in grads]
        found = torch.stack(flags).any()
        inv = 1.0 / scale.float()
        return (found,) + tuple(g.float() * inv for g in grads)

    def update_scaling_rule(self, scale, good, bad, found_inf):
        s = self._scaler.update_state(
            {"scale": scale, "good": good, "bad": bad}, found_inf)
        return s["scale"], s["good"], s["bad"]


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=True, dtype="bfloat16"):
    """fluid ``contrib.mixed_precision.decorate`` (``decorator.py:218``):
    an :class:`OptimizerWithMixedPrecision` whose ``minimize`` builds a
    loss-scaled, inf-guarded, list-cast train step. ``dtype`` is
    ``'bfloat16'`` (the JAX package's default) or ``'float16'`` (the
    reference's only type)."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        dtype=dtype)
