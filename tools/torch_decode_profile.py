#!/usr/bin/env python3
"""Where the port's decode time goes on the card.

    python3 tools/torch_decode_profile.py [--json PATH]

Builds the two decode configurations of ``chip_smoke.py``'s decode
phase (``chip_smoke.wmt_setup`` and ``gpt_decode_setup``):

- bench_wmt_beam: ``WMTTransformer`` at Transformer-base width (6 + 6
  layers x 512, vocab 32000), bfloat16, 16 x 32 source ids, beam 4,
  max_len 32, through ``beam_search_decode_xla``;
- ``gpt_small`` (bfloat16, batch 8, prompt 128, 32 new greedy tokens)
  through ``generate_xla`` and through ``generate``;

and profiles one call of each under ``torch.profiler`` — the graphed
decodes as a replay of their CUDA graph (after the call that captures
it), then the same decode op by op — printing the call's wall time,
the device's busy time and share, and device time by kernel group
(matrix products, the LayerNorm and flash kernels, sorting, softmax,
gathers and index copies, other elementwise and reduction kernels,
copies). ``--json`` also writes the numbers to a file. Needs one CUDA
card.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

GROUPS = (("flash_attention", ("flash_fwd_",)),
          ("layer_norm", ("ln_fwd_",)),
          ("matmul", ("gemm", "cutlass", "sm90_xmma", "cublas", "nvjet")),
          ("sort", ("sort", "radix", "Sort")),
          ("softmax", ("softmax",)),
          ("gather_index", ("index", "gather", "scatter")),
          ("reduce", ("reduce_kernel",)),
          ("elementwise", ("elementwise", "vectorized", "unrolled")),
          ("copy", ("Memcpy", "memcpy", "Memset")))


def _group(name):
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def profile_call(fn):
    """One call of ``fn`` under ``torch.profiler`` (with
    ``chip_smoke.profiled``'s pause on each side): ``(wall ms, device
    busy ms, {group: ms}, kernels launched)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(0.2)
    groups, count = {}, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
        count += e.count
    return wall, sum(groups.values()), groups, count


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the numbers here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.kernels import _build

    _build.build()
    gpu = chip_smoke.gpu_line()
    wmt, src = chip_smoke.wmt_setup()
    kw = dict(chip_smoke.WMT_DECODE)
    gpt, ids = chip_smoke.gpt_decode_setup()
    n = chip_smoke.GPT_DECODE["new"]
    full = dict(kw, src_pad_id=None, return_all=False)

    def wmt_op_by_op():
        with torch.no_grad():
            wmt._traced_beam_decode(src, **full)

    def gpt_op_by_op():
        with torch.no_grad():
            gpt._traced_generate(ids, None, max_new_tokens=n,
                                 temperature=0.0, top_k=None)

    calls = {
        "wmt beam_search_decode_xla graphed":
            lambda: wmt.beam_search_decode_xla(src, **kw),
        "wmt beam_search_decode_xla op by op": wmt_op_by_op,
        "gpt generate_xla graphed": lambda: gpt.generate_xla(ids, n),
        "gpt generate_xla op by op": gpt_op_by_op,
        "gpt generate (growing cache)":
            lambda: gpt.generate(ids, n, temperature=0.0),
    }
    out = {"device": gpu}
    for label, fn in calls.items():
        fn()                         # warm (and capture, when graphed)
        fn()
        wall, busy, groups, count = profile_call(fn)
        out[label] = dict(wall_ms=wall, device_busy_ms=busy,
                          device_busy_share=busy / wall, kernels=count,
                          device_ms=groups)
        print(f"{label}: wall {wall:.2f} ms, device busy {busy:.2f} ms = "
              f"{busy / wall * 100:.1f}%, {count} kernels; by group: "
              + ", ".join(f"{k} {v:.2f}" for k, v in
                          sorted(groups.items(), key=lambda kv: -kv[1]))
              + f" [{gpu}]")
    if args.json:
        d = os.path.dirname(args.json)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
