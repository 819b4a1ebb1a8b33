#!/usr/bin/env python3
"""How often does torch.profiler lose kernels of a training step on the
card, with and without a pause between its start and the step?

    python3 tools/torch_profiler_misses.py [--calls N]

bench_gpt's step as ``chip_smoke.py`` builds it (gpt_small, bfloat16,
batch 16 x 1024, AdamW), eager and as one CUDA graph, profiled
``--calls`` times each through ``chip_smoke.profiled``, once with no
pause between the profiler's start and the step (and its end) and once
with its default pause. For each of the four, the calls in which
the profiler named fewer or more of the port's kernels than the wrappers
counted, and by how many each kernel was off. Needs one CUDA card.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=25,
                    help="profiled steps of each kind (default 25)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_profiler_misses: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch import core
    from paddle_tpu_torch.framework import TrainStep
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build

    _build.build()
    print(cs.gpu_line(), flush=True)
    config = "bench_gpt"
    model = cs.train_model(config)
    loss_fn, batch, _ = cs.train_batch(model, config)
    bad = 0
    for kind in ("eager", "graphed"):
        core.seed(1)
        step = TrainStep(model, cs.train_optimizer(model, config), loss_fn)
        fn = step._eager_step if kind == "eager" else step
        for _ in range(3):       # graphed: eager first call, capture, replay
            fn(*batch)
        for settle in (0.0, cs.profiled.__defaults__[0]):
            missed, off = 0, {}
            for _ in range(args.calls):
                _, _, seen = cs.profiled(lambda: fn(*batch), settle)
                counted = kernels.launches()
                diff = {k: seen[k] - counted[k] for k in seen
                        if seen[k] != counted[k]}
                missed += bool(diff)
                for k, d in diff.items():
                    off.setdefault(k, []).append(d)
            bad += missed if settle else 0
            print(f"{kind} step, pause {settle} s: "
                  f"{missed} of {args.calls} profiled steps named another "
                  f"number of kernels than the wrappers counted; off by "
                  f"{off or 'nothing'}", flush=True)
        del step, fn
        torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
