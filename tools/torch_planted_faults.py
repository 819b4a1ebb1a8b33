#!/usr/bin/env python3
"""Check that ``chip_smoke.py``'s train phase catches a LayerNorm backward
that drops its parameter gradients.

    python3 tools/torch_planted_faults.py

Builds the kernels, then runs the smoke's train phase (``gpt_small``,
dropout 0.1, batch 8 x 1024, 4 AdamW steps, kernel run against the
plain-version run) twice in this process: once with dgamma and once with
dbeta of every ``layer_norm_bwd`` call replaced by zeros. The fault is
planted by swapping the module's wrapper for one that calls the real
kernel and zeroes one output; nothing on disk changes. Each run prints
its per-step loss differences (the smoke's ``train:`` lines) and must
fail the smoke's check; the script exits non-zero if either passes.
Needs one CUDA card.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import layernorm as ln  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_planted_faults: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    gpu = chip_smoke.gpu_line()
    real = ln.layer_norm_bwd
    missed = []
    for index, name in ((1, "dgamma"), (2, "dbeta")):
        def planted(*args, index=index):
            out = list(real(*args))
            out[index] = torch.zeros_like(out[index])
            return tuple(out)

        ln.layer_norm_bwd = planted
        try:
            chip_smoke.train_phase(gpu)
            missed.append(name)
            print(f"planted zero {name}: the train phase PASSED it")
        except chip_smoke.CheckFailed as e:
            print(f"planted zero {name}: the train phase failed, as it "
                  f"must: {e}")
        finally:
            ln.layer_norm_bwd = real
    print(gpu)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
