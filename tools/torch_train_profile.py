#!/usr/bin/env python3
"""Where the port's training step time goes on the card.

    python3 tools/torch_train_profile.py [--config NAME] [--json PATH]
                                         [--steps N]

Builds a model of ``paddle_tpu_torch`` on the card in one of the
training configurations of ``chip_smoke.py`` (``TRAIN_CONFIGS``; the
smoke's train phases drive the same three, with the same model,
optimizer and batch):

- ``dropout0.1-float32`` (the default): ``gpt_small`` (12 x 768, vocab
  50304) at its defaults, dropout 0.1, float32, batch 8 x 1024 — dense
  attention;
- ``bench_gpt``: ``bench.py:bench_gpt``'s recipe, ``gpt_small`` at
  dropout 0, ``model.bfloat16()``, batch 16 x 1024, multi_precision —
  the flash kernels;
- ``bench_bert``: ``bench.py:bench_bert``'s recipe, ``bert_base`` (12 x
  768, vocab 30522) at dropout 0.1, ``model.bfloat16()``, batch 64 x
  128 with an attention mask, multi_precision — dense attention, the
  LayerNorm kernels, the dense cross-entropy;

each with AdamW(1e-4, decay 0.01) and global-norm clip 1.0 on a batch
from RandomState(0). After two
warm steps it times ``--steps`` steps with CUDA events between the
forward, the backward and the optimizer (clip + AdamW), then profiles
one more step under ``torch.profiler`` and prints device time by kernel
group (the flash, LayerNorm and cross-entropy kernels, matrix products,
the attention softmax, dropout's random numbers, other elementwise and
reduction kernels, memory copies and sets), the repo's own kernels one
by one, and the device's busy share of that step's wall time, and the host's time to issue one LayerNorm
wrapper call and one ``F.layer_norm`` at the step's shape.
``--json`` also writes the numbers to a file.
Needs one CUDA card.
"""
import argparse
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

GROUPS = (("flash_attention", ("flash_fwd_", "flash_bwd_")),
          ("layer_norm", ("ln_fwd_", "ln_bwd_")),
          ("softmax_ce", ("ce_fwd_kernel", "ce_bwd_kernel")),
          ("matmul", ("gemm", "cutlass", "sm90_xmma", "cublas", "nvjet")),
          ("attention_softmax", ("softmax",)),
          ("dropout_random", ("philox", "distribution", "rand")),
          ("reduce", ("reduce_kernel",)),
          ("elementwise", ("elementwise", "vectorized", "unrolled")),
          ("copy", ("Memcpy", "memcpy", "Memset")))
OWN = ("flash_attention", "layer_norm", "softmax_ce")   # the repo's kernels


def host_us(fn, iters=50):
    """Microseconds the host takes to issue one call of ``fn``, with the
    card kept busy (``chip_smoke.QUEUE_CYCLES``) so that no call waits
    for it."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(chip_smoke.QUEUE_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def _group(name):
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=sorted(chip_smoke.TRAIN_CONFIGS),
                    default="dropout0.1-float32",
                    help="the training configuration (default: "
                    "dropout0.1-float32)")
    ap.add_argument("--json", help="also write the numbers here")
    ap.add_argument("--steps", type=int, default=3,
                    help="steps timed with CUDA events (default 3)")
    args = ap.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch import core
    from paddle_tpu_torch.ops import kernels

    core.seed(1)
    model = chip_smoke.train_model(args.config)
    cfg = model.cfg
    loss_fn, batch, _ = chip_smoke.train_batch(model, args.config)
    B, L = batch[0].shape
    batch = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in batch]
    opt = chip_smoke.train_optimizer(model, args.config)

    def step(events=None):
        # TrainStep.step's body, with an event between its phases
        opt.clear_grad()
        if events:
            events[0].record()
        loss = loss_fn(model, *batch)
        if events:
            events[1].record()
        loss.backward()
        if events:
            events[2].record()
        opt.step()
        if events:
            events[3].record()
        return loss

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    phases = {"forward": [], "backward": [], "optimizer": []}
    walls = []
    for _ in range(args.steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        step(ev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        for i, k in enumerate(phases):
            phases[k].append(ev[i].elapsed_time(ev[i + 1]))
    kernels.reset_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    launches = kernels.launches()
    # the host's cost of one LayerNorm launch at the step's shape, beside
    # the library call's: a step makes 50 of them
    from paddle_tpu_torch.ops.kernels import layernorm as ln

    dtype = next(model.parameters()).dtype
    x, dy = (torch.randn(B * L, cfg.hidden, device="cuda").to(dtype)
             for _ in range(2))
    gamma, beta = torch.ones_like(x[0]), torch.zeros_like(x[0])
    _, mean, rstd = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
    issue_us = {
        "layer_norm_fwd": host_us(
            lambda: ln.layer_norm_fwd(x, gamma, beta, 1e-5)),
        "layer_norm_bwd": host_us(
            lambda: ln.layer_norm_bwd(x, gamma, mean, rstd, dy)),
        "F.layer_norm": host_us(lambda: torch.nn.functional.layer_norm(
            x, (cfg.hidden,), gamma, beta, 1e-5)),
    }
    device, top, own = {}, [], {}
    for e in prof.key_averages():
        # device-side events only: a CPU op's self device time is its
        # kernels' time again
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us > 0:
            group = _group(e.key)
            device[group] = device.get(group, 0.0) + us
            top.append((us, e.count, e.key))
            if group in OWN:
                # the repo's own kernels one by one, template arguments
                # dropped: e.g. the LayerNorm backward apart from its reduce
                name = re.search(r"([A-Za-z_]\w*)[<(]", e.key + "(")[1]
                ms, n = own.get(name, (0.0, 0))
                own[name] = (ms + us / 1e3, n + e.count)
    busy_ms = sum(device.values()) / 1e3
    med = {k: sorted(v)[len(v) // 2] for k, v in phases.items()}
    wall = sorted(walls)[len(walls) // 2]
    out = {
        "device": torch.cuda.get_device_name(0),
        "config": args.config,
        "batch": [B, L],
        "step_wall_ms": walls,
        "phase_ms_median": med,
        "tokens_per_s": B * L / wall * 1e3,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "profiled_step_wall_ms": prof_wall,
        "launches": launches,
        "device_ms": {k: v / 1e3 for k, v in sorted(device.items())},
        "kernel_ms": {k: v[0] for k, v in sorted(own.items())},
        "kernel_launches": {k: v[1] for k, v in sorted(own.items())},
        "device_busy_ms": busy_ms if busy_ms else None,
        "device_busy_share": busy_ms / prof_wall if busy_ms else None,
        "host_issue_us": issue_us,
    }
    print(f"train step ({chip_smoke.TRAIN_CONFIGS[args.config]['model']}, "
          f"{args.config}, batch {B} x {L}): "
          f"wall ms " + " ".join(f"{w:.1f}" for w in walls)
          + f" = {out['tokens_per_s']:.0f} tokens/s at the median; phases "
          f"(CUDA events, median): " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in med.items())
          + f"; peak memory {out['peak_memory_gib']:.1f} GiB")
    print(f"profiled step: wall {prof_wall:.1f} ms; launches {launches}")
    print(f"host time to issue one call at ({B * L}, {cfg.hidden}): "
          + ", ".join(f"{k} {v:.1f} us" for k, v in issue_us.items()))
    if busy_ms:
        print(f"device busy {busy_ms:.1f} ms = "
              f"{out['device_busy_share'] * 100:.1f}% of wall; by group: "
              + ", ".join(f"{k} {v:.2f} ms"
                          for k, v in out["device_ms"].items()))
        print("the repo's kernels: " + ", ".join(
            f"{k} x{n} {ms:.3f} ms" for k, (ms, n) in sorted(own.items())))
        for us, count, key in sorted(top, reverse=True)[:15]:
            print(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    else:
        print("device time: not measured (the profiler saw no device "
              "activity)")
    if args.json:
        d = os.path.dirname(args.json)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
