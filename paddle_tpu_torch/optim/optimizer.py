"""Optimizers: the ``Optimizer`` base, ``SGD``, ``Momentum``, ``Adagrad``,
``Adadelta``, ``RMSProp``, ``Adam``, ``AdamW``, ``Adamax``, ``Lamb``,
``Ftrl``, ``DecayedAdagrad``, ``Dpsgd``, ``LarsMomentum`` and
``DGCMomentum``, and the wrappers ``ExponentialMovingAverage``,
``LookAhead``, ``ModelAverage``, ``RecomputeOptimizer`` and
``PipelineOptimizer``.

The counterparts of ``paddle_tpu/optim/optimizer.py``'s (:36-131,
:190-699). Each rule is the reference's, operation for operation and in
its order, so that a float32 step gives the reference's bits wherever
its operations are elementwise and correctly rounded. The exceptions:
Lamb's and LarsMomentum's norms, and Dpsgd's clip norm, are sums taken
in another order; Ftrl's power ``n ** -lr_power`` is XLA's ``pow``
in the reference, which is not correctly rounded on the CPU, and
torch's here (a correctly rounded square root at the default
``lr_power = -0.5``; exact at ``-1``):

- SGD: ``p - lr*g``; Momentum: ``v = mu*v + g``, ``p - lr*v`` (Nesterov:
  ``p - lr*(g + mu*v)``); Adagrad: ``m += g*g``, ``p - lr*g/(sqrt(m) +
  eps)``; Adadelta and RMSProp (centered or not, with momentum) as
  ``:232-277``;
- Adam: ``m = b1*m + (1-b1)*g``, ``v = b2*v + (1-b2)*g*g``,
  ``p -= lr * (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)``; Adamax and
  Lamb (the trust ratio ``|p| / |r|``) as ``:339-392``;
- Ftrl: float32 ``squared``/``linear`` accumulators and the proximal
  step of ``:394-415``; DecayedAdagrad: ``m = decay*m + (1-decay)*g*g``,
  ``p - lr*g/(sqrt(m) + eps)``; Dpsgd: the gradient clipped to norm
  ``clip``, plus N(0, (sigma*clip)^2) noise over ``batch_size``, then
  SGD (``:524-554``); LarsMomentum: the local rate ``lr * coeff * |p| /
  (|g| + decay*|p|)`` in float32, ``v = mu*v + local*(g + decay*p)``
  in the parameter's type (``:557-581``); DGCMomentum is ``Momentum``
  (``:584-598``: the compression half is a transport optimization the
  reference does not keep either);
- AdamW: the Adam step, then decoupled decay ``p -= lr*coeff*p_old``
  on every parameter that ``apply_decay_param_fun(name)`` does not
  exclude, with ``lr`` scaled by ``lr_ratio(param)`` when given, where
  ``param.name`` is the parameter's name. ``torch.optim.AdamW`` decays
  before the step and folds the bias corrections differently, so it is
  not this update.

Rounding follows the reference. Adam, AdamW, Adamax and Lamb compute in
float32 and round the new value to the parameter's type; AdamW's decay
is applied to that rounded value and rounded again (``optimizer.py:305``,
``:333-335``). With ``multi_precision=True`` each bfloat16 or float16
parameter gets a float32 ``master`` copy at its first update
(``optimizer.py:84-91``); the update runs on the master with the
gradient in float32, and the parameter is set to the master rounded to
its type (``:108-124``). The state starts as the reference's
``_init_state`` makes it from the parameter (``zeros_like(p)``, an
Adagrad accumulator rounded to the parameter's type), in float32 beside
a master, as the reference's turns float32 at the first update. A
low-precision parameter without a master is updated in its own type.
The rules up to Lamb use torch's rules there, not bitwise the
reference's (torch keeps a Python scalar in float32 where JAX rounds it
to the parameter's type first); the later ones round each such scalar,
and the learning rate, to the parameter's type first (``_weak``), as
the reference's eager step does.

State lives on the parameter's device and is updated in place, as the
reference's step donates its buffers: the moments, the powers
``b1^t``/``b2^t`` (0-d float32 tensors, as the reference's ``jnp.ones((),
f32)``), the masters and the parameters keep their storage from step to
step, which a captured step (``framework.TrainStep``) needs. The
learning rate reaches each update as a 0-d float32 tensor on the device
(``_lr_tensor``), which ``step()`` and ``TrainStep`` fill with
``float32(get_lr())`` before the update runs. ``learning_rate`` is a
float or an ``optim.lr.LRScheduler``; ``get_lr`` and ``set_lr`` behave
as the reference's (``:67-76``).

Dpsgd draws its noise from the device's generator
(``core.random.default_generator``), which ``TrainStep`` registers with
its CUDA graph: every replay draws new noise, the noise the op-by-op
step would draw from the same generator state, never a constant of the
capture (the reference refuses a bare ``jax.jit`` for the same reason,
``:535-543``).

The wrappers act on the parameters' storage outside any graph, after a
``step()`` or a ``TrainStep`` call: ``ExponentialMovingAverage.update``
and ``ModelAverage.step`` accumulate, ``apply()`` copies the average
into each parameter after keeping a copy, ``restore()`` copies it back.
``LookAhead`` steps its inner optimizer, then every ``k`` steps pulls
each parameter toward its float32 slow weight (``:456-500``); like the
reference it writes the parameter, not an inner ``master``.

``state_dict``/``set_state_dict`` keep the reference's layout
(``optimizer.py:166-188``): ``<name>.<slot>`` per state value (a master
is the slot ``master``), ``@global_step`` and, with a scheduler,
``@lr``; a data-parallel step's exchange keeps its error-feedback state
under ``@comm@ef@<i>.residual`` and ``@comm@step.count``
(``dist.gradcomm``). ``set_state_dict`` copies into the state's storage and never
rebinds it, so a captured step goes on replaying after a load.

``minimize(loss)`` on a static Program's loss Variable appends the
backward and one ``optimize_<rule>`` op a parameter to the program
(``static_.executor.append_update_ops``), whose replay runs this
optimizer's ``_update``.

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

import torch

from ..core.random import default_generator
from .lr import LRScheduler
from .regularizer import L2Decay

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta",
           "RMSProp", "Adam", "AdamW", "Adamax", "Lamb", "Ftrl",
           "ExponentialMovingAverage", "LookAhead", "DecayedAdagrad",
           "Dpsgd", "LarsMomentum", "DGCMomentum", "ModelAverage",
           "RecomputeOptimizer", "PipelineOptimizer"]


def _named(parameters):
    """``[(name, parameter)]``: ``(name, parameter)`` pairs as they are;
    a parameter alone under its ``name`` (``core.Parameter``, as the JAX
    package keys its state, ``paddle_tpu/optim/optimizer.py:166-174``),
    else ``param_<i>``."""
    out = []
    for i, item in enumerate(parameters):
        if isinstance(item, tuple):
            out.append(item)
        else:
            out.append((getattr(item, "name", None) or f"param_{i}", item))
    return out


def _sqrt(v):
    """The square root of ``v`` in its type, correctly rounded, as XLA's
    is. torch's float32 ``sqrt`` on the CPU is not on every host (its
    vector path differs from the correctly rounded root in about one
    value in six on an AVX-512 CPU); a float64 root rounded to float32 is,
    since 53 >= 2 * 24 + 2. CUDA's float32 ``sqrt`` is correctly rounded
    (``tests/test_torch_cuda.py::test_cuda_sqrt_is_correctly_rounded``)."""
    if v.device.type == "cpu":
        return torch.sqrt(v.double()).to(v.dtype)
    return torch.sqrt(v)


def _weak(x, like):
    """A Python number (or the 0-d float32 learning rate) as the
    reference's weak-typed scalar meets a tensor of ``like``'s type: for
    a bfloat16 or float16 ``like`` rounded to that type first, as JAX
    rounds it; as it is otherwise. A device fill, so it can be
    captured."""
    if like.dtype not in (torch.bfloat16, torch.float16):
        return x
    if isinstance(x, torch.Tensor):
        return x.to(like.dtype)
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _pow(x, e):
    """``x ** e`` in ``x``'s type, a new tensor: the correctly rounded
    square root at 0.5, a copy of ``x`` at 1."""
    if e == 0.5:
        return _sqrt(x)
    if e == 1.0:
        return x.clone()
    return torch.pow(x, e)


def _commit(dst, new, found_inf):
    """Write ``new`` into ``dst``'s storage; where ``found_inf`` (a 0-d
    bool tensor) is set, keep ``dst`` as it was (``jit.py:311-318``)."""
    if found_inf is not None:
        torch.where(found_inf, dst, new.to(dst.dtype), out=dst)
    elif new is not dst:
        dst.copy_(new)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if parameters is None:
            raise ValueError("optimizer constructed without parameters")
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate)}")
        self._named_params = _named(parameters)
        self._learning_rate = (learning_rate
                               if isinstance(learning_rate, LRScheduler)
                               else float(learning_rate))
        # a float weight_decay is L2 regularisation added to the gradient
        if isinstance(weight_decay, (int, float)):
            weight_decay = L2Decay(weight_decay)
        self._regularization = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._accumulators = {}
        self._lr_tensors = {}
        self._global_step = 0

    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def _lr_tensor(self, device):
        """The 0-d float32 learning-rate tensor every update on ``device``
        reads; the same tensor from step to step."""
        lr = self._lr_tensors.get(device)
        if lr is None:
            lr = self._lr_tensors[device] = torch.zeros(
                (), dtype=torch.float32, device=device)
        return lr

    def _load_lr(self, device):
        """Write ``float32(get_lr())`` into ``device``'s learning-rate
        tensor."""
        self._lr_tensor(device).fill_(self.get_lr())

    def _state_for(self, name, p):
        if name not in self._accumulators:
            s = self._init_state(p)
            if self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16):
                s = {k: v.float() for k, v in s.items()}
                s["master"] = p.detach().float()
            self._accumulators[name] = s
        return self._accumulators[name]

    def _init_state(self, p):
        return {}

    def _update(self, name, p, g, s, lr, into):
        """The rule for parameter ``name``: ``p`` is the value updated (its
        float32 master, else the parameter), ``g`` the gradient in ``p``'s
        type, ``s`` its state, ``lr`` a 0-d float32 tensor. Returns ``(new
        p, {key: new state value})``. Each new state value is written into
        ``into.get(key)`` (``into`` is ``s`` for an update in place, or
        empty, when the step may be skipped, for new tensors); the new
        ``p`` is always a new tensor."""
        raise NotImplementedError

    @torch.no_grad()
    def _apply(self, named_grads, found_inf=None):
        """Clip the gradients of ``[(name, parameter, gradient)]``, then
        update each parameter, its master and its state in their storage,
        each reading its device's learning-rate tensor. Where
        ``found_inf`` (a 0-d bool tensor on the device) is set, every one
        keeps its bits (``jit.py:311-318``). Reads nothing back to the
        host, so it can be captured."""
        pgs = [(p, g) for _, p, g in named_grads]
        if self._grad_clip is not None:
            pgs = self._grad_clip(pgs)
        for (name, p, _), (_, g) in zip(named_grads, pgs):
            s = self._state_for(name, p)
            master = s.get("master")
            pw = p if master is None else master
            g = g.to(pw.dtype)
            reg = getattr(p, "regularizer", None) or self._regularization
            if reg is not None and not isinstance(self, AdamW):
                g = reg(pw, g)
            lr = self._lr_tensor(p.device)
            ratio = getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
            if ratio != 1.0:
                lr = lr * ratio
            new_p, new_s = self._update(
                name, pw, g, s, lr, s if found_inf is None else {})
            if master is not None:
                new_s["master"] = new_p
            for k, v in new_s.items():
                _commit(s[k], v, found_inf)
            _commit(p, new_p, found_inf)

    @torch.no_grad()
    def step(self, found_inf=None):
        """Clip the gradients, then update every trainable parameter that
        has one, in place, at ``get_lr()``. With ``found_inf`` (a 0-d bool
        tensor on the device) set, the update leaves every value as it
        was."""
        named = [(name, p, p.grad) for name, p in self._named_params
                 if p.requires_grad and p.grad is not None]
        for device in {p.device for _, p, _ in named}:
            self._load_lr(device)
        self._apply(named, found_inf)
        self._global_step += 1

    def clear_grad(self):
        for _, p in self._named_params:
            p.grad = None

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """A static Program's loss Variable: append its backward and this
        optimizer's update ops to the program (``static_.executor
        .build_optimize_ops``; ``parameters`` None: every parameter of
        the program), returning ``(None, [(param, grad)])``. An eager
        loss: ``backward()``, then ``step()`` (``optimizer.py:133-143``).
        """
        from ..static_.program import Variable

        if isinstance(loss, Variable):
            from ..static_.executor import build_optimize_ops

            return build_optimize_ops(self, loss, parameters)
        if not loss.requires_grad:
            raise ValueError("loss needs no gradient; nothing to minimize")
        loss.backward()
        self.step()
        return None, None

    # -- serialization (optimizer.py:166-188) -----------------------------

    def state_dict(self):
        """``{"<name>.<slot>": tensor, "@global_step": int}``, plus
        ``"@lr"`` (the scheduler's state dict) when the learning rate is
        an ``LRScheduler``. ``<name>`` is the name the optimizer was given
        for the parameter; the tensors are the state itself, not copies
        (``framework.io`` copies them to the host)."""
        out = {f"{name}.{k}": v for name, s in self._accumulators.items()
               for k, v in s.items()}
        out["@global_step"] = self._global_step
        if isinstance(self._learning_rate, LRScheduler):
            out["@lr"] = self._learning_rate.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        """Write ``state`` (``state_dict``'s layout; values are tensors,
        numpy arrays or numbers) into the optimizer. Each value is copied
        into the state tensor's storage, which a captured step reads; a
        parameter without state yet gets it first (``_state_for``: its
        master from the current parameter), then the copy. Raises
        ``ValueError`` on a parameter the optimizer does not have, a slot
        its rule does not keep or a shape that does not fit."""
        params = dict(self._named_params)
        for k, v in state.items():
            if k == "@global_step":
                self._global_step = int(v)
            elif k == "@lr":
                if isinstance(self._learning_rate, LRScheduler):
                    self._learning_rate.set_state_dict(v)
            elif k.startswith("@comm@"):
                self._set_comm_state(k, v)
            else:
                name, slot = k.rsplit(".", 1)
                if name not in params:
                    raise ValueError(f"{k}: the optimizer has no parameter "
                                     f"{name!r}")
                s = self._state_for(name, params[name])
                if slot not in s:
                    raise ValueError(f"{k}: {type(self).__name__} keeps "
                                     f"{sorted(s)} for {name!r}")
                src = torch.as_tensor(v)
                if tuple(src.shape) != tuple(s[slot].shape):
                    raise ValueError(f"{k} has shape {tuple(src.shape)}, "
                                     f"the state {tuple(s[slot].shape)}")
                s[slot].copy_(src)

    set_dict = set_state_dict

    def _set_comm_state(self, key, value):
        """The gradient exchange's state (``dist.gradcomm``'s
        ``@comm@ef@<i>.residual``, ``@comm@step.count``): copied into its
        storage when the exchange has made it, kept as it is until the
        exchange takes it up otherwise."""
        name, slot = key.rsplit(".", 1)
        s = self._accumulators.setdefault(name, {})
        src = torch.as_tensor(value)
        if slot in s:
            if tuple(src.shape) != tuple(s[slot].shape):
                raise ValueError(f"{key} has shape {tuple(src.shape)}, "
                                 f"the state {tuple(s[slot].shape)}")
            s[slot].copy_(src)
        else:
            s[slot] = src.clone()


class SGD(Optimizer):
    def _update(self, name, p, g, s, lr, into):
        return p - lr * g, {}


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, name, p, g, s, lr, into):
        v = torch.add(self._momentum * s["velocity"], g,
                      out=into.get("velocity"))
        if self._use_nesterov:
            new_p = p - lr * (g + self._momentum * v)
        else:
            new_p = p - lr * v
        return new_p, {"velocity": v}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p, self._init_acc)}

    def _update(self, name, p, g, s, lr, into):
        m = torch.add(s["moment"], g * g, out=into.get("moment"))
        return p - lr * g / (_sqrt(m) + self._epsilon), {"moment": m}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._epsilon = epsilon
        self._rho = rho

    def _init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def _update(self, name, p, g, s, lr, into):
        rho, eps = self._rho, self._epsilon
        asg = torch.add(rho * s["avg_squared_grad"], (1 - rho) * g * g,
                        out=into.get("avg_squared_grad"))
        # the update before its accumulator is overwritten
        delta = _sqrt((s["avg_squared_update"] + eps) / (asg + eps)) * g
        asu = torch.add(rho * s["avg_squared_update"],
                        (1 - rho) * delta * delta,
                        out=into.get("avg_squared_update"))
        return p - lr * delta, {"avg_squared_grad": asg,
                                "avg_squared_update": asu}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        s = {"mean_square": torch.zeros_like(p),
             "momentum": torch.zeros_like(p)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(p)
        return s

    def _update(self, name, p, g, s, lr, into):
        rho = self._rho
        ms = torch.add(rho * s["mean_square"], (1 - rho) * g * g,
                       out=into.get("mean_square"))
        new = {"mean_square": ms}
        if self._centered:
            mg = torch.add(rho * s["mean_grad"], (1 - rho) * g,
                           out=into.get("mean_grad"))
            new["mean_grad"] = mg
            denom = _sqrt(ms - mg * mg + self._epsilon)
        else:
            denom = _sqrt(ms + self._epsilon)
        mom = torch.add(self._momentum * s["momentum"], lr * g / denom,
                        out=into.get("momentum"))
        new["momentum"] = mom
        return p - mom, new


def _powers_and_moments(s, gf, b1, b2, into):
    """Adam's and Lamb's ``b1^t``, ``b2^t`` and moments, advanced."""
    b1p = torch.mul(s["beta1_pow"], b1, out=into.get("beta1_pow"))
    b2p = torch.mul(s["beta2_pow"], b2, out=into.get("beta2_pow"))
    m = torch.add(b1 * s["moment1"], (1 - b1) * gf, out=into.get("moment1"))
    v = torch.add(b2 * s["moment2"], (1 - b2) * gf * gf,
                  out=into.get("moment2"))
    return {"moment1": m, "moment2": v, "beta1_pow": b1p, "beta2_pow": b2p}


def _adam_state(p):
    def f32(fill):
        return torch.full((), fill, dtype=torch.float32, device=p.device)
    return {"moment1": torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device),
            "moment2": torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device),
            "beta1_pow": f32(1.0), "beta2_pow": f32(1.0)}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        return _adam_state(p)

    def _update(self, name, p, g, s, lr, into):
        new = _powers_and_moments(s, g.float(), self._beta1, self._beta2,
                                  into)
        mhat = new["moment1"] / (1 - new["beta1_pow"])
        vhat = new["moment2"] / (1 - new["beta2_pow"])
        step = lr * mhat / (_sqrt(vhat) + self._epsilon)
        return (p.float() - step).to(p.dtype), new


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

    def _update(self, name, p, g, s, lr, into):
        if self._lr_ratio is not None:
            lr = lr * float(self._lr_ratio(_ParamView(name, p)))
        new_p, new = super()._update(name, p, g, s, lr, into)
        if self._apply_decay_fn is not None and \
                not self._apply_decay_fn(name):
            return new_p, new
        # f32(lr) * f32(coeff), as the reference's step with a float32 lr
        decay = lr * self._coeff
        return (new_p.float() - decay * p.float()).to(p.dtype), new


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        s = _adam_state(p)
        return {"moment": s["moment1"], "inf_norm": s["moment2"],
                "beta1_pow": s["beta1_pow"]}

    def _update(self, name, p, g, s, lr, into):
        b1 = self._beta1
        gf = g.float()
        b1p = torch.mul(s["beta1_pow"], b1, out=into.get("beta1_pow"))
        m = torch.add(b1 * s["moment"], (1 - b1) * gf,
                      out=into.get("moment"))
        u = torch.maximum(self._beta2 * s["inf_norm"], torch.abs(gf),
                          out=into.get("inf_norm"))
        step = (lr / (1 - b1p)) * m / (u + self._epsilon)
        return (p.float() - step).to(p.dtype), \
            {"moment": m, "inf_norm": u, "beta1_pow": b1p}


class Lamb(Optimizer):
    """``exclude_from_weight_decay_fn`` is kept and not read, as in the
    reference (``optimizer.py:361-391``): every parameter decays."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        return _adam_state(p)

    def _update(self, name, p, g, s, lr, into):
        pf = p.float()
        new = _powers_and_moments(s, g.float(), self._beta1, self._beta2,
                                  into)
        mhat = new["moment1"] / (1 - new["beta1_pow"])
        vhat = new["moment2"] / (1 - new["beta2_pow"])
        r = mhat / (_sqrt(vhat) + self._epsilon) + self._lamb_wd * pf
        w_norm = _sqrt(torch.sum(pf * pf))
        r_norm = _sqrt(torch.sum(r * r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        return (pf - lr * trust * r).to(p.dtype), new


class Ftrl(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _init_state(self, p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"squared": z, "linear": z.clone()}

    def _update(self, name, p, g, s, lr, into):
        gf, pf = g.float(), p.float()
        e = -self._lr_power
        old_pow = _pow(s["squared"], e)    # before it is overwritten
        n = torch.add(s["squared"], gf * gf, out=into.get("squared"))
        new_pow = _pow(n, e)
        sigma = (new_pow - old_pow) / lr
        z = torch.sub(s["linear"] + gf, sigma * pf, out=into.get("linear"))
        denom = new_pow / lr + 2 * self._l2
        new_p = torch.where(torch.abs(z) > self._l1,
                            (torch.sign(z) * self._l1 - z) / denom, 0.0)
        return new_p.to(p.dtype), {"squared": n, "linear": z}


class DecayedAdagrad(Optimizer):
    """``moment = decay * moment + (1 - decay) * g^2`` in the parameter's
    type (``optimizer.py:503-521``)."""

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._decay = decay
        self._epsilon = epsilon

    def _init_state(self, p):
        return {"moment": torch.zeros_like(p)}

    def _update(self, name, p, g, s, lr, into):
        d = self._decay
        m = torch.add(_weak(d, p) * s["moment"], _weak(1 - d, p) * g * g,
                      out=into.get("moment"))
        step = _weak(lr, p) * g / (_sqrt(m) + _weak(self._epsilon, p))
        return p - step, {"moment": m}


class Dpsgd(Optimizer):
    """Differentially private SGD (``optimizer.py:524-554``): the
    gradient clipped to L2 norm ``clip``, plus Gaussian noise of standard
    deviation ``sigma * clip`` divided by ``batch_size``, then ``p -
    lr*g``. The noise comes from the device's generator, float32, so a
    captured step draws new noise at every replay. ``seed`` is kept and
    not read, as in the reference."""

    def __init__(self, learning_rate=0.001, clip=0.9, batch_size=0.999,
                 sigma=1.0, parameters=None, seed=0, multi_precision=False):
        super().__init__(learning_rate, parameters, None, None,
                         multi_precision)
        self._clip = clip
        self._batch = batch_size
        self._sigma = sigma

    def _update(self, name, p, g, s, lr, into):
        gf = g.float()
        norm = _sqrt(torch.sum(gf * gf))
        # a divided tensor: torch computes ``number / tensor`` as the
        # number times the tensor's reciprocal
        clip = torch.full((), self._clip, dtype=torch.float32,
                          device=g.device)
        scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
        g = g * scale.to(g.dtype)
        noise = torch.randn(g.shape, generator=default_generator(g.device),
                            device=g.device, dtype=torch.float32)
        noise = noise * (self._sigma * self._clip)
        g = g + (noise / self._batch).to(g.dtype)
        return p - _weak(lr, p) * g, {}


class LarsMomentum(Optimizer):
    """Layer-wise adaptive rate scaling (``optimizer.py:557-581``): the
    local rate ``lr * lars_coeff * |p| / max(|g| + lars_weight_decay *
    |p|, 1e-12)`` from float32 norms (each one ``torch.sum``: a fixed
    reduction tree, no atomics), and ``velocity`` in the parameter's
    type."""

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._coeff = lars_coeff
        self._decay = lars_weight_decay

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, name, p, g, s, lr, into):
        pf, gf = p.float(), g.float()
        wn = _sqrt(torch.sum(pf * pf))
        gn = _sqrt(torch.sum(gf * gf))
        local = lr * self._coeff * wn / torch.clamp(gn + self._decay * wn,
                                                    min=1e-12)
        v = torch.add(_weak(self._momentum, p) * s["velocity"],
                      (local * (gf + self._decay * pf)).to(p.dtype),
                      out=into.get("velocity"))
        return p - v, {"velocity": v}


class DGCMomentum(Momentum):
    """Deep gradient compression's optimizer as the reference keeps it
    (``optimizer.py:584-598``): plain ``Momentum``; the ramp-up and
    sparsity arguments are taken and not read."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, momentum, parameters=parameters,
                         use_nesterov=use_nesterov,
                         weight_decay=weight_decay, grad_clip=grad_clip,
                         multi_precision=multi_precision)


# -- the wrappers (optimizer.py:418-500, :601-699) ---------------------------


def _model_params(model_or_params):
    """``[(name, parameter)]`` of an ``nn.Module`` (its
    ``named_parameters()``) or of an iterable as ``Optimizer`` takes
    it."""
    if isinstance(model_or_params, torch.nn.Module):
        return list(model_or_params.named_parameters())
    return _named(model_or_params or [])


class _Swap:
    """``apply()``/``restore()`` of an averaging wrapper: ``apply`` keeps a
    copy of each parameter and writes the average into its storage,
    ``restore`` writes the copy back, bitwise."""

    def _average(self, name, p):
        raise NotImplementedError

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        self._backup = {n: p.detach().clone() for n, p in self._params}
        for n, p in self._params:
            p.copy_(self._average(n, p))

    @torch.no_grad()
    def restore(self, executor=None):
        for n, p in self._params:
            p.copy_(self._backup[n])
        self._backup = {}


class ExponentialMovingAverage(_Swap):
    """``shadow = d * shadow + (1 - d) * p`` at each ``update()``, in the
    parameter's type, with ``d = decay``, or with ``thres_steps`` given
    ``min(decay, (1 + t) / (10 + t))`` at the t-th update
    (``optimizer.py:418-453``). ``apply()`` writes the shadows into the
    parameters, ``restore()`` puts them back."""

    def __init__(self, model_or_params, decay=0.999, thres_steps=None):
        self._params = _model_params(model_or_params)
        self._decay = decay
        self._thres_steps = thres_steps
        self._shadow = {n: p.detach().clone() for n, p in self._params}
        self._backup = {}
        self._step = 0

    @torch.no_grad()
    def update(self):
        self._step += 1
        d = self._decay
        if self._thres_steps is not None:
            d = min(d, (1 + self._step) / (10 + self._step))
        for n, p in self._params:
            sh = self._shadow[n]
            torch.add(_weak(d, sh) * sh, _weak(1 - d, sh) * p.to(sh.dtype),
                      out=sh)

    def _average(self, name, p):
        return self._shadow[name]


class ModelAverage(_Swap):
    """Running float32 sums of the parameters, one ``step()`` after each
    update; ``apply()`` writes ``sum / count`` into the parameters. The
    window restarts (the sum becomes the current parameters, the count
    1) once the count passes both ``max_average_window`` and
    ``min_average_window`` (``optimizer.py:601-651``). ``apply()``
    before any ``step()`` raises ``RuntimeError``."""

    def __init__(self, average_window_rate, model_or_params=None,
                 min_average_window=10000, max_average_window=10000,
                 parameters=None):
        src = model_or_params if model_or_params is not None else parameters
        self._params = _model_params(src)
        self.rate = average_window_rate
        self.min_w = min_average_window
        self.max_w = max_average_window
        self._sum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in self._params}
        self._count = 0
        self._backup = {}

    @torch.no_grad()
    def step(self):
        self._count += 1
        restart = self._count > self.max_w and self._count > self.min_w
        for n, p in self._params:
            if restart:
                self._sum[n].copy_(p)
            else:
                torch.add(self._sum[n], p.float(), out=self._sum[n])
        if restart:
            self._count = 1

    def apply(self, executor=None, need_restore=True):
        if self._count == 0:
            raise RuntimeError(
                "ModelAverage.apply() before any step(): no accumulated "
                "window to average (parameters would be zeroed)")
        super().apply(executor, need_restore)

    def _average(self, name, p):
        return (self._sum[name] / self._count).to(p.dtype)


class LookAhead(Optimizer):
    """``k`` steps of ``inner_optimizer``, then each parameter pulled
    toward its float32 slow weight: ``slow += alpha * (p - slow)``, ``p =
    slow`` (``optimizer.py:456-500``). The slow weights start from the
    parameters at the first ``step()``. As in the reference, the pull
    writes the parameter only: an inner ``multi_precision`` master keeps
    the fast weights. Eager only; ``state_dict`` is the inner
    optimizer's."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._slow = None
        self._steps = 0

    @property
    def _named_params(self):
        return self.inner._named_params

    def get_lr(self):
        return self.inner.get_lr()

    @torch.no_grad()
    def step(self):
        if self._slow is None:
            self._slow = {n: p.detach().to(torch.float32, copy=True)
                          for n, p in self.inner._named_params}
        self.inner.step()
        self._steps += 1
        if self._steps % self.k == 0:
            for n, p in self.inner._named_params:
                slow = self._slow[n]
                torch.add(slow, self.alpha * (p.float() - slow), out=slow)
                p.copy_(slow)

    def clear_grad(self):
        self.inner.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        return None, None

    def state_dict(self):
        return self.inner.state_dict()

    def set_state_dict(self, state):
        self.inner.set_state_dict(state)


class _Delegating:
    """A recipe wrapper: ``minimize`` is ``backward()`` then the inner
    optimizer's ``step()``; every other attribute is the inner
    optimizer's."""

    def minimize(self, loss, **kw):
        loss.backward()
        self.inner.step()
        return None, None

    def __getattr__(self, item):
        if item == "inner":
            raise AttributeError(item)
        return getattr(self.inner, item)


class RecomputeOptimizer(_Delegating):
    """The reference's recompute recipe shape (``optimizer.py:654-681``):
    ``_set_checkpoints`` keeps the segment spec, everything else goes to
    the inner optimizer. Recompute itself is a property of the forward
    (``framework.recompute``)."""

    def __init__(self, optimizer):
        self.inner = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def backward(self, loss, **kw):
        loss.backward()
        return []

    def apply_gradients(self, params_grads=None):
        self.inner.step()


class PipelineOptimizer(_Delegating):
    """The reference's pipeline recipe shape (``optimizer.py:684-699``):
    keeps ``num_microbatches`` and delegates stepping to the inner
    optimizer. Stage-parallel training is ``dist`` (ROADMAP Queue 1 item
    6)."""

    def __init__(self, optimizer, num_microbatches=1, start_cpu_core_id=0):
        self.inner = optimizer
        self.num_microbatches = num_microbatches
