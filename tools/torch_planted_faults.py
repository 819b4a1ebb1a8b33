#!/usr/bin/env python3
"""Check that ``chip_smoke.py``'s train phases catch planted faults: a
backward kernel that drops one of its gradients, a graph that keeps its
first learning rate, ResNet-50's wrong convs and BatchNorm momentum,
checkpoints and guards that rebind storage or drop state, and a static
program that drops a gradient, a fused window or a velocity.

    python3 tools/torch_planted_faults.py [--resnet | --checkpoint |
                                           --static | --amp | --rare]

Builds the kernels, then runs the smoke's train phases with one fault
planted at a time:

- dgamma, then dbeta, of every ``layer_norm_bwd`` call zeroed, in the
  float32 train phase (``gpt_small``, dropout 0.1, batch 8 x 1024);
- dV of every ``flash_attention_bwd_dkv`` call zeroed, in the bf16
  train phase (bench_gpt's configuration, batch 16 x 1024);
- dx of every ``layer_norm_bwd`` call zeroed, in the train-bert phase
  (bench_bert's configuration, ``bert_base`` in bfloat16, batch 64 x
  128), whose kernels are the LayerNorm's alone;
- dgamma of every ``layer_norm_bwd`` call zeroed, in the train-bert
  phase. It moves the 4 bfloat16 steps' losses by at most 6.9e-3, as
  much as the bfloat16 roundings of an honest run move them (6.7e-3),
  under the loss limit of 1e-2: the phase's LayerNorm gradient check
  (``chip_smoke.ln_grad_check``, each backward launch of one step
  against its plain version) must catch it instead.
- a graph that keeps the learning rate of its first step: each replay
  of ``TrainStep`` skips writing ``get_lr()`` into the optimizer's
  learning-rate tensor, in the scheduler check of the train-graph phase
  (bench_gpt under LinearWarmup into CosineAnnealingDecay, 6 graphed
  steps against 6 eager ones), which must find the two runs' parameters
  differ.

- conv weights read transposed (kh and kw swapped, so the shapes still
  fit), then each conv of a window over 1 x 1 padded by 0 before and
  twice its padding after (the output's shape kept, the windows shifted
  by one), in every ``nn.functional.conv2d`` call of the train-resnet
  phase (bench_resnet50), which its per-conv float32 check must catch
  (``chip_smoke.resnet_value_check``);
- a BatchNorm momentum taken as 1 - m in every
  ``nn.functional.batch_norm`` call of the train-resnet phase, which
  leaves the training forward alone and must fail the stem BatchNorm's
  statistics check (``chip_smoke.stem_bn_check``).

``--resnet`` plants the three ResNet faults only.

Then three faults in the checkpoint phase (17), each patched into the
class it breaks (``--checkpoint`` plants these only):

- an ``Optimizer.set_state_dict`` that rebinds each state tensor to a
  new one instead of copying into it: the in-place load of the
  step-4 checkpoint must fail by capturing again
  (``chip_smoke.ckpt_reference``);
- an ``Optimizer.state_dict`` without the beta powers: steps 5-8 after
  that load must fail their losses (the powers stay at step 8's);
- a ``GuardedStep`` restore that leaves ``_global_step`` alone: the
  guarded run must fail its step count (``chip_smoke.ckpt_guard_check``;
  the weights alone cannot show it, AdamW reads the powers).

Then three faults in the static phase's bench_lenet_exec part (18(a),
``chip_smoke.lenet_exec_phase``), each patched into the port's
``static_`` (``--static`` plants these only):

- an ``append_backward`` that drops one parameter's ``@grad`` (the last
  pair it returns, so no update op is made for that parameter): the
  program's parameters must differ from the eager LeNet's;
- a ``run_steps`` that returns step 0's loss K times: the fused fetches
  must differ from 8 sequential ``run`` calls';
- an ``optimize_momentum`` op that does not write its velocity slot (it
  returns the slot it read): the program must part from the eager
  LeNet's losses and velocities.

Then four faults in the mixed-precision phase (21, ``--amp`` plants
these only):

- dV of every float16 ``flash_attention_bwd_dkv`` call zeroed, while
  21(a) runs bench_gpt under ``auto_cast(float16)``, and dx of every
  float16 ``layer_norm_bwd`` call zeroed while 21(b) runs it at O2: the
  kernel run's losses must part from the plain versions' by more than
  ``F16_TRAIN_LOSS_TOL`` (``chip_smoke.amp_compare``);
- a recompute segment that does not hand its parameters to autograd
  (``framework.recompute``'s ``_segment_params`` finding none), so they
  get no gradient: 21(d) must find the losses differ from the run
  without recompute (``chip_smoke.recompute_check``);
- a static AMP scale that doubles after every clean step: 21(e) must
  find ``@amp@scale`` off the reference's rule
  (``chip_smoke.static_amp_check``).

Then one fault in the optimizers of phase 22 (``--rare`` plants it
only): LarsMomentum's local learning rate without its weight-decay term
(``lr * coeff * |p| / |g|``), which ``chip_smoke.rule_value_check`` must
find off the plain formula (its case gives the decay term the weight of
the gradient's norm); graphed = op by op cannot see it, both run the
planted rule.

Each of the first phases runs 4 AdamW steps through the kernels and 4
through the plain versions and compares the losses. A fault is planted
by swapping the module's wrapper for one that calls the real kernel and
zeroes one output; the real wrapper counts its launch on the module's
name, the planted one, so the phase's launch check passes and its loss
check (the BERT dgamma fault: its gradient check) is what must catch the
fault. Nothing on disk changes. Each run prints its per-step loss
differences (the smoke's ``train:`` / ``train-bf16:`` / ``train-bert:``
lines) and must fail the named check (the learning-rate fault: its
bitwise check); the script exits non-zero if any fault passes or is
caught by another check. Needs one CUDA card.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu_torch.static_ import backward as static_backward  # noqa: E402
from paddle_tpu_torch.static_ import executor as static_executor  # noqa: E402
from paddle_tpu_torch.framework import TrainStep  # noqa: E402
from paddle_tpu_torch.optim import LarsMomentum, Optimizer  # noqa: E402
from paddle_tpu_torch.optim import optimizer as optim_rules  # noqa: E402
from paddle_tpu_torch.resilience import GuardedStep  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops.kernels import layernorm as ln  # noqa: E402
from paddle_tpu_torch.amp import static_decorator  # noqa: E402

LOSSES = "losses differ"
FAULTS = [
    # (label, module, wrapper name, output zeroed, phase, the failure
    # that must catch it)
    ("layer_norm_bwd dgamma = 0", ln, "layer_norm_bwd", 1,
     chip_smoke.train_phase, LOSSES),
    ("layer_norm_bwd dbeta = 0", ln, "layer_norm_bwd", 2,
     chip_smoke.train_phase, LOSSES),
    ("flash_attention_bwd_dkv dV = 0", fa, "flash_attention_bwd_dkv", 1,
     chip_smoke.train_bf16_phase, LOSSES),
    ("bert: layer_norm_bwd dx = 0", ln, "layer_norm_bwd", 0,
     chip_smoke.train_bert_phase, LOSSES),
    ("bert: layer_norm_bwd dgamma = 0", ln, "layer_norm_bwd", 1,
     chip_smoke.train_bert_phase, "dgamma differs"),
]


def _transposed(real):
    return lambda x, w, *a, **k: real(x, torch.transpose(w, 2, 3), *a, **k)


def _shifted(real):
    # the output's shape kept, each k > 1 conv's windows shifted by one
    def conv(x, w, *a, padding=0, **k):
        if w.shape[-1] > 1:
            padding = [0, 2 * padding, 0, 2 * padding]
        return real(x, w, *a, padding=padding, **k)
    return conv


def _momentum_flipped(real):
    return lambda *a, momentum=0.9, **k: real(*a, momentum=1 - momentum,
                                               **k)


OP_FAULTS = [
    # (label, nn.functional op, what wraps it, phase, the failure that
    # must catch it)
    ("resnet: conv weights read transposed", "conv2d", _transposed,
     chip_smoke.train_resnet_phase, "float32 conv"),
    ("resnet: conv padded unevenly", "conv2d", _shifted,
     chip_smoke.train_resnet_phase, "float32 conv"),
    ("resnet: BatchNorm momentum 1 - m", "batch_norm", _momentum_flipped,
     chip_smoke.train_resnet_phase, "stem BatchNorm"),
]


def op_faults(gpu):
    """The ResNet faults, each planted in ``nn.functional`` (the layers
    call the op through it) while the phase runs: the labels the phase
    passed or did not fail by the named check."""
    missed = []
    for label, name, wrap, phase, caught_by in OP_FAULTS:
        real = getattr(F, name)
        setattr(F, name, wrap(real))
        try:
            phase(gpu)
            missed.append(label)
            print(f"planted {label}: the phase PASSED it")
        except chip_smoke.CheckFailed as e:
            if caught_by not in str(e):
                missed.append(label)
            print(f"planted {label}: the phase failed: {e}")
        finally:
            setattr(F, name, real)
            torch.cuda.empty_cache()
    return missed


def kernel_faults(gpu):
    """The kernel faults and the learning-rate fault: the labels the
    phase passed or did not fail by the named check."""
    missed = []
    for label, module, name, index, phase, caught_by in FAULTS:
        real = getattr(module, name)

        def planted(*args, real=real, index=index):
            out = list(real(*args))
            out[index] = torch.zeros_like(out[index])
            return tuple(out)

        planted.launches = 0
        setattr(module, name, planted)
        try:
            phase(gpu)
            missed.append(label)
            print(f"planted {label}: the phase PASSED it")
        except chip_smoke.CheckFailed as e:
            if caught_by not in str(e):
                missed.append(label)
            print(f"planted {label}: the phase failed: {e}")
        finally:
            setattr(module, name, real)
            torch.cuda.empty_cache()
    # a graph that keeps its first learning rate: replays leave the
    # optimizer's learning-rate tensor as the first step wrote it
    real_replay = TrainStep._replay

    def replay_keeping_lr(self, entry, batch):
        self.optimizer._load_lr = lambda device: None
        try:
            return real_replay(self, entry, batch)
        finally:
            del self.optimizer._load_lr

    TrainStep._replay = replay_keeping_lr
    try:
        differ = chip_smoke.scheduler_check(gpu)
    finally:
        TrainStep._replay = real_replay
        torch.cuda.empty_cache()
    print(f"planted graph keeps its first lr: {differ} tensors differ "
          f"from the eager run")
    if not differ:
        missed.append("graph keeps its first lr")
    return missed


def _rebinding_set_state_dict(self, state):
    params = dict(self._named_params)
    for k, v in state.items():
        if k == "@global_step":
            self._global_step = int(v)
        elif not k.startswith("@"):
            name, slot = k.rsplit(".", 1)
            s = self._state_for(name, params[name])
            s[slot] = torch.as_tensor(v).to(s[slot].device, s[slot].dtype)


def _state_dict_without_powers(real):
    return lambda self: {k: v for k, v in real(self).items()
                         if not k.endswith(("beta1_pow", "beta2_pow"))}


def _restore_keeping_global_step(self, snap):
    snap.restore(self._state())


CKPT_FAULTS = [
    # (label, class, attribute, replacement from the real one, the part
    # of phase 17 that runs, the failure that must catch it)
    ("set_state_dict rebinds", Optimizer, "set_state_dict",
     lambda real: _rebinding_set_state_dict, "reference", "captured again"),
    ("state_dict without the beta powers", Optimizer, "state_dict",
     _state_dict_without_powers, "reference", "in-place load: losses"),
    ("restore leaves _global_step", GuardedStep, "_restore",
     lambda real: _restore_keeping_global_step, "guard", "step count"),
]


def checkpoint_faults(gpu):
    """The checkpoint faults, each planted while the part of phase 17
    that must catch it runs: the labels it passed or did not fail by the
    named check."""
    import shutil
    import tempfile

    missed = []
    for label, cls, attr, wrap, part, caught_by in CKPT_FAULTS:
        real = getattr(cls, attr)
        setattr(cls, attr, wrap(real))
        root = tempfile.mkdtemp(prefix="planted_ckpt_")
        try:
            if part == "reference":
                chip_smoke.ckpt_reference(gpu, root)
            else:
                chip_smoke.ckpt_guard_check(gpu)
            missed.append(label)
            print(f"planted {label}: the phase PASSED it")
        except chip_smoke.CheckFailed as e:
            if caught_by not in str(e):
                missed.append(label)
            print(f"planted {label}: the phase failed: {e}")
        finally:
            setattr(cls, attr, real)
            shutil.rmtree(root, ignore_errors=True)
            torch.cuda.empty_cache()
    return missed


def _dropping_one_grad(real):
    def append_backward(*a, **k):
        return real(*a, **k)[:-1]
    return append_backward


def _first_loss_k_times(real):
    def run_steps(self, *a, **k):
        out = real(self, *a, **k)
        return [np.repeat(out[0][:1], len(out[0]))] + out[1:]
    return run_steps


def _velocity_unwritten(real):
    def update(self, p, g, lr, *slots):
        return (real(self, p, g, lr, *slots)[0], *slots)
    return update


STATIC_FAULTS = [
    # (label, module or class, attribute, replacement from the real one,
    # the failure that must catch it)
    ("append_backward drops a parameter's @grad", static_backward,
     "append_backward", _dropping_one_grad, "eager LeNet"),
    ("run_steps returns step 0's loss K times", static_executor.Executor,
     "run_steps", _first_loss_k_times, "run_steps"),
    ("optimize_momentum leaves its velocity", static_executor._UpdateFn,
     "__call__", _velocity_unwritten, "eager LeNet"),
]


def static_faults(gpu):
    """The static faults, each planted while phase 18(a) runs: the
    labels it passed or did not fail by the named check."""
    missed = []
    for label, owner, attr, wrap, caught_by in STATIC_FAULTS:
        real = getattr(owner, attr)
        setattr(owner, attr, wrap(real))
        try:
            chip_smoke.lenet_exec_phase(gpu)
            missed.append(label)
            print(f"planted {label}: the phase PASSED it")
        except chip_smoke.CheckFailed as e:
            if caught_by not in str(e):
                missed.append(label)
            print(f"planted {label}: the phase failed: {e}")
        finally:
            setattr(owner, attr, real)
            torch.cuda.empty_cache()
    return missed


def _zeroing(real, index):
    def planted(*args):
        out = list(real(*args))
        if args[0].dtype == torch.float16:
            out[index] = torch.zeros_like(out[index])
        return tuple(out)
    planted.launches = 0
    return planted


def _no_segment_params(real):
    return lambda function, models: []


def _scale_grows_each_step(real):
    def rule(self, scale, good, bad, found_inf):
        return (torch.where(found_inf, scale, scale * 2), good * 0,
                bad * 0)
    return rule


def _amp_phase_part(part, gpu):
    f32, f16 = "torch.float32", "torch.float16"
    if part == "O1":
        chip_smoke.amp_compare("O1 gpt", "bench_gpt", "O1",
                               chip_smoke.o1_gpt_loss,
                               {"layer": f32, "softmax": f32, "flash": f16},
                               gpu)
    elif part == "O2":
        chip_smoke.amp_compare("O2 gpt", "bench_gpt", "O2", None,
                               {"layer": f16, "softmax": f16, "flash": f16},
                               gpu)
    elif part == "recompute":
        chip_smoke.recompute_check(gpu)
    else:
        chip_smoke.static_amp_check(gpu)


def amp_faults(gpu):
    """The mixed-precision faults, each planted while the part of phase
    21 that must catch it runs: the labels it passed or did not fail by
    the named check."""
    import importlib

    rc = importlib.import_module("paddle_tpu_torch.framework.recompute")
    faults = [
        # (label, owner, attribute, replacement from the real one, part
        # of phase 21, the failure that must catch it)
        ("float16 flash dV = 0 under O1", fa, "flash_attention_bwd_dkv",
         lambda real: _zeroing(real, 1), "O1", "plain versions'"),
        ("float16 layer_norm_bwd dx = 0 at O2", ln, "layer_norm_bwd",
         lambda real: _zeroing(real, 0), "O2", "plain versions'"),
        ("recompute leaves the parameters without gradients", rc,
         "_segment_params", _no_segment_params, "recompute",
         "recompute: losses"),
        ("static AMP scale doubles every clean step",
         static_decorator.OptimizerWithMixedPrecision,
         "update_scaling_rule", _scale_grows_each_step, "static",
         "@amp@scale"),
    ]
    missed = []
    for label, owner, attr, wrap, part, caught_by in faults:
        real = getattr(owner, attr)
        setattr(owner, attr, wrap(real))
        try:
            _amp_phase_part(part, gpu)
            missed.append(label)
            print(f"planted {label}: the phase PASSED it")
        except chip_smoke.CheckFailed as e:
            if caught_by not in str(e):
                missed.append(label)
            print(f"planted {label}: the phase failed: {e}")
        finally:
            setattr(owner, attr, real)
            torch.cuda.empty_cache()
    return missed


def _lars_without_decay(real):
    """``LarsMomentum._update`` with the local learning rate ``lr * coeff
    * |p| / |g|``: the weight-decay term dropped from the denominator."""
    def planted(self, name, p, g, s, lr, into):
        pf, gf = p.float(), g.float()
        wn = optim_rules._sqrt(torch.sum(pf * pf))
        gn = optim_rules._sqrt(torch.sum(gf * gf))
        local = lr * self._coeff * wn / torch.clamp(gn, min=1e-12)
        v = torch.add(self._momentum * s["velocity"],
                      (local * (gf + self._decay * pf)).to(p.dtype),
                      out=into.get("velocity"))
        return p - v, {"velocity": v}
    return planted


def rare_faults(gpu):
    """Phase 22's fault, planted while ``rule_value_check`` runs the
    Lars case: the labels it passed or did not fail by that check."""
    real = LarsMomentum._update
    LarsMomentum._update = _lars_without_decay(real)
    label = "LarsMomentum's local lr without its decay term"
    try:
        chip_smoke.rule_value_check("lars_momentum")
        print(f"planted {label}: the check PASSED it")
        return [label]
    except chip_smoke.CheckFailed as e:
        print(f"planted {label}: the check failed: {e}")
        return [] if "plain formula" in str(e) else [label]
    finally:
        LarsMomentum._update = real


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--resnet", action="store_true",
                    help="plant the three ResNet faults only")
    ap.add_argument("--checkpoint", action="store_true",
                    help="plant the three checkpoint faults only")
    ap.add_argument("--static", action="store_true",
                    help="plant the three static-graph faults only")
    ap.add_argument("--amp", action="store_true",
                    help="plant the four mixed-precision faults only")
    ap.add_argument("--rare", action="store_true",
                    help="plant the optimizer fault of phase 22 only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_planted_faults: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    gpu = chip_smoke.gpu_line()
    only = (args.resnet or args.checkpoint or args.static or args.amp
            or args.rare)
    missed = op_faults(gpu) if args.resnet or not only else []
    if not only:
        missed += kernel_faults(gpu)
    if args.checkpoint or not only:
        missed += checkpoint_faults(gpu)
    if args.static or not only:
        missed += static_faults(gpu)
    if args.amp or not only:
        missed += amp_faults(gpu)
    if args.rare or not only:
        missed += rare_faults(gpu)
    print(gpu)
    if missed:
        print(f"not caught by the check named for them: {missed}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
