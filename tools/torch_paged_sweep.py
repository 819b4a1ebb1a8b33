#!/usr/bin/env python3
"""Time the paged decode kernel over its two layout choices.

    python3 tools/torch_paged_sweep.py [--json PATH]

At ``chip_smoke.py``'s decode shape (16 lanes of RandomState(0) prompt
lengths + 1, H = 12, D = 64, page 16, a 4096-page pool), in float32 and
bfloat16 pools, for each chunk size (``CHUNK_TOKENS``: 64 to 1024
tokens) and CTA layout (``HEADS_PER_CTA``: the warps of 1, 4 or all 12
heads of one chunk in a CTA), the kernel is held to its plain version
(2e-5 float32, 2e-2 bfloat16) and two calls to the same bits, then
timed on the card (``chip_smoke.cuda_ms``) beside the bound from the
bytes it must move. Needs one CUDA card.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import paged_attention as pa  # noqa: E402

CHUNKS = (64, 128, 256, 512, 1024)
LAYOUTS = (1, 2, 4)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="write the rows here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_paged_sweep: no CUDA device", file=sys.stderr)
        return 2
    _build.build(["paged_attention"])
    gpu = chip_smoke.gpu_line()
    rng = np.random.RandomState(0)
    lengths = [int(n) + 1 for n in rng.randint(128, 2049, 16)]
    H, D, page, P = 12, 64, 16, 4096
    rows = []
    default = (pa.CHUNK_TOKENS, pa.HEADS_PER_CTA)
    try:
        for dtype, tol in ((torch.float32, chip_smoke.F32_TOL),
                           (torch.bfloat16, chip_smoke.BF16_TOL)):
            a = chip_smoke.paged_inputs(lengths, H, D, page, P, dtype,
                                        seed=99)
            ref = pa.paged_decode_attention_reference(*a)
            bound, _, nbytes = chip_smoke.paged_bound_ms(
                lengths, page, H, D, a[1].element_size(), a[3].shape[1])
            for chunk in CHUNKS:
                for hpc in LAYOUTS:
                    pa.CHUNK_TOKENS, pa.HEADS_PER_CTA = chunk, hpc
                    out = pa.paged_decode_attention(*a)
                    again = pa.paged_decode_attention(*a)
                    torch.cuda.synchronize()
                    err = (out - ref).abs().max().item()
                    ok = bool(((out - ref).abs()
                               <= tol * (1 + ref.abs())).all())
                    same = torch.equal(out, again)
                    ms = min(chip_smoke.cuda_ms(
                        lambda: pa.paged_decode_attention(*a), 50)
                        for _ in range(2))
                    name = str(dtype).split(".")[-1]
                    print(f"paged sweep {name} chunk {chunk} tokens, "
                          f"{hpc} head(s) a CTA: {ms:.4f} ms = "
                          f"{bound / ms * 100:.1f}% of the {bound:.4f} ms "
                          f"bound ({nbytes / 1e6:.1f} MB); max abs err "
                          f"{err:.2e} ({'ok' if ok else 'FAIL'}), two "
                          f"calls {'equal' if same else 'DIFFER'} [{gpu}]",
                          flush=True)
                    rows.append(dict(pool=name, chunk_tokens=chunk,
                                     heads_per_cta=hpc, ms=ms,
                                     bound_ms=bound, max_abs_err=err,
                                     ok=ok and same))
            del a
    finally:
        pa.CHUNK_TOKENS, pa.HEADS_PER_CTA = default
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"gpu": gpu, "rows": rows}, f, indent=1)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
