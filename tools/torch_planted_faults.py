#!/usr/bin/env python3
"""Check that ``chip_smoke.py``'s train phases catch a backward kernel
that drops one of its gradients.

    python3 tools/torch_planted_faults.py

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

Each phase runs 4 AdamW steps through the kernels and 4 through the
plain versions and compares the losses. A fault is planted by swapping
the module's wrapper for one that calls the real kernel and zeroes one
output; the real wrapper counts its launch on the module's name, the
planted one, so the phase's launch check passes and its loss check (the
BERT dgamma fault: its gradient check) is what must catch the fault.
Nothing on disk changes. Each run prints its per-step loss differences
(the smoke's ``train:`` / ``train-bf16:`` / ``train-bert:`` lines) and
must fail the named check (the learning-rate fault: its bitwise check);
the script exits non-zero if any fault passes or is caught by another
check. Needs one CUDA card.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu_torch.framework import TrainStep  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops.kernels import layernorm as ln  # noqa: E402

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


def main():
    if not torch.cuda.is_available():
        print("torch_planted_faults: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    gpu = chip_smoke.gpu_line()
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
    print(gpu)
    if missed:
        print(f"not caught by the check named for them: {missed}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
