#!/usr/bin/env python3
"""Where the port's serving time goes on the card.

    python3 tools/torch_serve_profile.py [--json PATH]

Runs the main-path workload of ``chip_smoke.py`` (full gpt_small width:
16 requests of 128-2048 prompt tokens from RandomState(0), 32 new tokens
each, a 4096-page float32 pool) through ``paddle_tpu_torch``'s
``ServeEngine`` twice — once to warm the step shapes, once under
``torch.profiler`` — and prints, for the profiled run: host wall time of
the prefill and decode spans, device time by kernel group (the paged
decode kernel, matrix products, gathers and scatters, copies to and
from the host, the rest) and the device's busy share of the run's wall
time. ``--json`` also writes those numbers to a file. Needs one CUDA
card.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

GROUPS = (("paged_decode", ("paged_decode_",)),
          ("matmul", ("gemm", "cutlass", "sm90_xmma", "cublas")),
          ("gather_scatter", ("index", "gather", "scatter")),
          ("host_copy", ("Memcpy DtoH", "Memcpy HtoD", "memcpy")))


def _group(name):
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def _workload():
    rng = np.random.RandomState(0)
    lens = [int(n) for n in rng.randint(128, 2049, 16)]
    return [[int(t) for t in rng.randint(0, 50304, n)] for n in lens]


def _serve(model, prompts, trace):
    import torch

    from paddle_tpu_torch.serving import (PagedKVCache, Scheduler,
                                          ServeEngine)

    cache = PagedKVCache(4096, 16, 12, 64)
    eng = ServeEngine(model, cache,
                      scheduler=Scheduler(cache, token_budget=8192))
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    trace.clear_trace()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the numbers here")
    args = ap.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from paddle_tpu_torch.obs import trace
    from paddle_tpu_torch.serving import TinyLM

    model = TinyLM(vocab_size=50304, num_heads=12, head_dim=64, seed=0)
    prompts = _workload()
    trace.enable_tracing()
    _serve(model, prompts, trace)                    # warm the shapes
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng, wall = _serve(model, prompts, trace)
    spans = {}
    for ev in trace.trace_events():
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    device = {}
    top = []
    for e in prof.key_averages():
        # device-side events only: a CPU op's self device time is its
        # kernels' time again
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us > 0:
            device[_group(e.key)] = device.get(_group(e.key), 0.0) + us
            top.append((us, e.count, e.key))
    busy_ms = sum(device.values()) / 1e3
    out = {
        "device": torch.cuda.get_device_name(0),
        "wall_ms": wall * 1e3,
        "steps": eng.stats()["steps"],
        "decode_steps": eng.usage.decode_steps,
        "prefills": eng.usage.prefills,
        "host_span_ms": {k: spans.get(k, 0.0) for k in
                         ("serving.prefill", "serving.decode")},
        "device_ms": {k: v / 1e3 for k, v in sorted(device.items())},
        "device_busy_ms": busy_ms if busy_ms else None,
        "device_busy_share": busy_ms / (wall * 1e3) if busy_ms else None,
    }
    print(f"profiled run: {out['steps']} steps ({out['prefills']} prefills,"
          f" {out['decode_steps']} decode steps), wall {out['wall_ms']:.1f}"
          f" ms; host spans: prefill "
          f"{out['host_span_ms']['serving.prefill']:.1f} ms, decode "
          f"{out['host_span_ms']['serving.decode']:.1f} ms")
    if busy_ms:
        print(f"device busy {busy_ms:.1f} ms = "
              f"{out['device_busy_share'] * 100:.1f}% of wall; by group: "
              + ", ".join(f"{k} {v:.2f} ms"
                          for k, v in out["device_ms"].items()))
        for us, count, key in sorted(top, reverse=True)[:12]:
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
