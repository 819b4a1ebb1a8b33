"""Optimizers: the ``Optimizer`` base, ``Adam`` and ``AdamW``.

The counterparts of ``paddle_tpu/optim/optimizer.py``'s (:36-131,
:280-336), with the reference's update order, computed in float32:

- Adam: ``m = b1*m + (1-b1)*g``, ``v = b2*v + (1-b2)*g*g``,
  ``p -= lr * (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)``;
- AdamW: the Adam step, then decoupled decay ``p -= lr*coeff*p_old``
  on every parameter that ``apply_decay_param_fun(name)`` does not
  exclude, with ``lr`` scaled by ``lr_ratio(param)`` when given, where
  ``param.name`` is the parameter's name.

``torch.optim.AdamW`` decays before the step and folds the bias
corrections differently, so it is not this update.

Rounding follows the reference. The Adam step is rounded to the
parameter's type, and AdamW's decay is applied to that rounded value and
rounded again: a bfloat16 parameter is rounded twice a step
(``optimizer.py:305``, ``:333-335``). With ``multi_precision=True`` each
bfloat16 or float16 parameter gets a float32 ``master`` copy at its
first update (``optimizer.py:84-91``); the update and the decay run on
the master with the gradient in float32, and the parameter is set to
the master rounded to its type (``:108-124``). The powers
``b1^t``/``b2^t`` are kept per parameter as float32 host scalars, as
the reference keeps them in float32. Parameters are updated in place.
The learning rate is a float: LR schedulers are not ported yet.

``parameters`` is an iterable of tensors or of ``(name, tensor)`` pairs
(``model.named_parameters()``); the names are what
``apply_decay_param_fun`` sees and ``lr_ratio`` reads as ``.name``
(``param_<i>`` when none are given).

Each step reads what ``nn.layers.common.create_parameter`` set on a
parameter, as the reference's ``Optimizer.step`` does (:100-125): only
parameters with ``requires_grad`` (the attr's ``trainable``) are
updated; the learning rate is ``lr * optimize_attr["learning_rate"]``;
the parameter's ``regularizer``, else the optimizer's ``weight_decay``
(a float is ``L2Decay``), transforms the gradient before the update,
except in ``AdamW``; the clip skips a gradient whose parameter has
``need_clip = False``.
"""
from __future__ import annotations

import numpy as np
import torch

from .regularizer import L2Decay

__all__ = ["Optimizer", "Adam", "AdamW"]


def _named(parameters):
    out = []
    for i, item in enumerate(parameters):
        if isinstance(item, tuple):
            out.append(item)
        else:
            out.append((f"param_{i}", item))
    return out


def _sqrt(v):
    """The float32 square root of ``v``, correctly rounded, as XLA's is.
    torch's float32 ``sqrt`` on the CPU is not on every host (its vector
    path differs from the correctly rounded root in about one value in
    six on an AVX-512 CPU); a float64 root rounded to float32 is, since
    53 >= 2 * 24 + 2. CUDA's float32 ``sqrt`` is correctly rounded
    (``tests/test_torch_cuda.py::test_cuda_sqrt_is_correctly_rounded``)."""
    if v.device.type == "cpu":
        return torch.sqrt(v.double()).float()
    return torch.sqrt(v)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if parameters is None:
            raise ValueError("optimizer constructed without parameters")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError("learning-rate schedulers are not "
                                      "ported yet: pass a float")
        self._named_params = _named(parameters)
        self._learning_rate = float(learning_rate)
        # a float weight_decay is L2 regularisation added to the gradient
        if isinstance(weight_decay, (int, float)):
            weight_decay = L2Decay(weight_decay)
        self._regularization = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._accumulators = {}
        self._global_step = 0

    def get_lr(self):
        return self._learning_rate

    def _state_for(self, name, p):
        if name not in self._accumulators:
            s = self._init_state(p)
            if self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16):
                s["master"] = p.detach().float()
            self._accumulators[name] = s
        return self._accumulators[name]

    def _init_state(self, p):
        return {}

    def _update(self, name, p, g, s, lr):
        """The new value of ``p``, in ``p``'s type, for gradient ``g`` (of
        ``p``'s type); updates the state ``s`` in place."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        """Clip the gradients, then update every trainable parameter that
        has one, in place."""
        named = [(name, p) for name, p in self._named_params
                 if p.requires_grad and p.grad is not None]
        pgs = [(p, p.grad) for _, p in named]
        if self._grad_clip is not None:
            pgs = self._grad_clip(pgs)
        base_lr = self.get_lr()
        for (name, _), (p, g) in zip(named, pgs):
            s = self._state_for(name, p)
            master = s.get("master")
            pw = p if master is None else master
            g = g.to(pw.dtype)
            reg = getattr(p, "regularizer", None) or self._regularization
            if reg is not None and not isinstance(self, AdamW):
                g = reg(pw, g)
            lr = base_lr * getattr(p, "optimize_attr", {}).get(
                "learning_rate", 1.0)
            new_p = self._update(name, pw, g, s, lr)
            if master is not None:
                s["master"] = new_p
            p.copy_(new_p)
        self._global_step += 1

    def clear_grad(self):
        for _, p in self._named_params:
            p.grad = None


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment1": torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device),
                "moment2": torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device),
                "beta1_pow": np.float32(1.0), "beta2_pow": np.float32(1.0)}

    def _update(self, name, p, g, s, lr):
        b1, b2 = self._beta1, self._beta2
        g = g.float()
        s["beta1_pow"] = b1p = s["beta1_pow"] * np.float32(b1)
        s["beta2_pow"] = b2p = s["beta2_pow"] * np.float32(b2)
        s["moment1"] = m = b1 * s["moment1"] + (1 - b1) * g
        s["moment2"] = v = b2 * s["moment2"] + (1 - b2) * g * g
        mhat = m / float(np.float32(1) - b1p)
        vhat = v / float(np.float32(1) - b2p)
        step = float(np.float32(lr)) * mhat / (_sqrt(vhat) + self._epsilon)
        return (p.float() - step).to(p.dtype)


class _ParamView:
    """The parameter as ``lr_ratio`` sees it: the reference calls it with
    its parameter (``optimizer.py:327-328``), whose ``.name`` is the
    parameter's name, so ``.name`` is the name the optimizer was given
    and every other attribute is the tensor's."""

    __slots__ = ("name", "_tensor")

    def __init__(self, name, tensor):
        self.name, self._tensor = name, tensor

    def __getattr__(self, attr):
        return getattr(self._tensor, attr)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision)
        # a float, or a regularizer whose coeff is the decay
        self._coeff = (float(weight_decay)
                       if isinstance(weight_decay, (int, float))
                       else weight_decay.coeff)
        self._apply_decay_fn = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _update(self, name, p, g, s, lr):
        if self._lr_ratio is not None:
            lr = lr * float(self._lr_ratio(_ParamView(name, p)))
        new_p = super()._update(name, p, g, s, lr)
        if self._apply_decay_fn is not None and \
                not self._apply_decay_fn(name):
            return new_p
        decay = float(np.float32(lr) * np.float32(self._coeff))
        return (new_p.float() - decay * p.float()).to(p.dtype)
