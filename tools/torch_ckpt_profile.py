#!/usr/bin/env python3
"""Where a checkpoint's and a guarded step's time goes on the card.

    python3 tools/torch_ckpt_profile.py [--json PATH] [--repeat N]

Builds bench_gpt's configuration (``chip_smoke.TRAIN_CONFIGS``:
``gpt_small`` at dropout 0, ``model.bfloat16()``, multi_precision AdamW,
batch 16 x 1024), takes one step so that the optimizer state exists,
and times, through the public API, ``--repeat`` times each where it can
be repeated (the first and the median are printed):

- ``save_checkpoint(async_=True)`` until it returns (the state's copy to
  pinned host buffers: the first save of the process into fresh ones,
  the second into the buffers the caching host allocator kept), and
  ``wait_checkpoints()`` after it (the writer: pickling, the file and
  per-array crc32s, the write);
- a sync ``save_checkpoint``;
- ``framework.io.save`` of the model's and the optimizer's state dicts
  (the host copy, pickling and the write, with no crc32) and
  ``framework.io.load`` of the two files (reading and unpickling);
- ``load_checkpoint`` into the live model and optimizer (reading, the
  file crc32s, unpickling, host-to-device copies) and
  ``verify_checkpoint`` (the same reads with the per-array crc32 pass);
- ``GuardedStep._take``, the guard's snapshot of the step's state into
  its device buffers: host time to issue, device time between CUDA
  events from an idle card, and queued behind a spin
  (``chip_smoke.cuda_ms``), beside the bound of its bytes read and
  written at the card's memory rate.

Each line carries the card's name and power limit. Needs one CUDA card.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu_torch.framework import (TrainStep, load, load_checkpoint,  # noqa: E402
                                        save, save_checkpoint,
                                        verify_checkpoint, wait_checkpoints)
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.resilience import GuardedStep, RecoveryPolicy  # noqa: E402

CONFIG = chip_smoke.CKPT_CONFIG


def timed(fn, repeat):
    """``fn()`` ``repeat`` times from an idle card: (first ms, median ms,
    last result)."""
    out, res = [], None
    for _ in range(repeat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out[0], sorted(out)[len(out) // 2], res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ckpt_profile: no CUDA device", file=sys.stderr)
        return 2
    _build.build()
    gpu = chip_smoke.gpu_line()
    r = args.repeat
    model = chip_smoke.train_model(CONFIG)
    opt = chip_smoke.train_optimizer(model, CONFIG)
    step = TrainStep(model, opt, chip_smoke.ckpt_loss, check_nan=True)
    batch = chip_smoke.ckpt_batches(model, 1)[0]
    step(*batch)
    torch.cuda.synchronize()
    state = {**dict(model.state_dict()), **opt.state_dict()}
    nbytes = sum(v.numel() * v.element_size() for v in state.values()
                 if isinstance(v, torch.Tensor))
    res = {"gpu": gpu, "state_bytes": nbytes,
           "tensors": sum(isinstance(v, torch.Tensor)
                          for v in state.values())}

    def line(name, first, med):
        res[name] = {"first_ms": first, "median_ms": med}
        print(f"{name}: first {first:.1f} ms, median {med:.1f} ms = "
              f"{nbytes / med / 1e6:.2f} GB/s [{gpu}]", flush=True)

    print(f"ckpt-profile: {CONFIG}, {res['tensors']} tensors, {nbytes} "
          f"bytes of state [{gpu}]", flush=True)
    with tempfile.TemporaryDirectory() as d:
        for name in ("async_snapshot_fresh", "async_snapshot_reused"):
            t0 = time.perf_counter()
            save_checkpoint(d, 1, model, opt, keep_last=2, async_=True)
            snap_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            wait_checkpoints()
            wait_ms = (time.perf_counter() - t0) * 1e3
            line(name, snap_ms, snap_ms)
            line(name.replace("snapshot", "writer"), wait_ms, wait_ms)
        f, m, path = timed(lambda: save_checkpoint(d, 1, model, opt), r)
        line("save_checkpoint_sync", f, m)
        with open(os.path.join(path, "manifest.json")) as fh:
            res["file_bytes"] = sum(
                e["size"] for e in json.load(fh)["files"].values())
        files = [os.path.join(d, "model.pd"), os.path.join(d, "opt.pd")]
        f, m, _ = timed(lambda: (save(model.state_dict(), files[0]),
                                 save(opt.state_dict(), files[1])), r)
        line("save_no_crc", f, m)
        f, m, _ = timed(lambda: [load(p) for p in files], r)
        line("load_no_crc", f, m)
        f, m, _ = timed(lambda: load_checkpoint(d, model, opt), r)
        line("load_checkpoint", f, m)
        f, m, _ = timed(lambda: verify_checkpoint(path), r)
        line("verify_checkpoint", f, m)
    print(f"checkpoint: {res['file_bytes']} bytes on disk [{gpu}]",
          flush=True)
    # the guard's snapshot of the live state into its device buffers
    guard = GuardedStep(step, RecoveryPolicy(on_nonfinite="skip_step"))
    guard(*batch)
    tensors = guard._state()
    gbytes = sum(t.numel() * t.element_size() for t in tensors)
    bound = 2 * gbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    host, dev = [], []
    for _ in range(r):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        t0 = time.perf_counter()
        guard._take(guard._pre)
        host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        torch.cuda.synchronize()
        dev.append(a.elapsed_time(b))
    queued = chip_smoke.cuda_ms(lambda: guard._take(guard._pre), 3,
                                warmup=1)
    host_ms, dev_ms = sorted(host)[r // 2], sorted(dev)[r // 2]
    res["guard_take"] = {"tensors": len(tensors), "bytes": gbytes,
                         "host_ms": host_ms, "device_ms": dev_ms,
                         "queued_device_ms": queued, "bound_ms": bound}
    print(f"guard_take (GuardedStep._take): {len(tensors)} tensors, "
          f"{gbytes} bytes: host {host_ms:.2f} ms to issue, device "
          f"{dev_ms:.2f} ms issued from idle, {queued:.2f} ms queued "
          f"behind a spin (bound {bound:.2f} ms, bytes read and written "
          f"at the card's memory rate) [{gpu}]", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
