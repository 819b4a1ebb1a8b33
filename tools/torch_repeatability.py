#!/usr/bin/env python3
"""Is the embedding's weight gradient repeatable on the card, and what
does the repeatable one cost?

    python3 tools/torch_repeatability.py [--runs N]

For the lookups of bench_bert and bench_gpt (8192 or 16384 ids: BERT's
token types, all 0 of 2; its positions, 0-127 repeated; its words and
GPT's, random ids; GPT's positions, 0-1023 repeated), float32 and
bfloat16 gradients of width 768 from one seed: whether ``--runs``
backward passes give the same bits, and the time of one, for
PyTorch's default CUDA embedding backward, for its deterministic
variant (``torch.use_deterministic_algorithms``), and for the port's
``nn.functional.embedding``, which takes the deterministic one. Also
the host time of the first and second call of
``torch.use_deterministic_algorithms``, which the port does not call
(it sets the flag through ``torch._C``). Needs one CUDA card.
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

E = 768
CASES = [
    # label, ids, table rows, how the ids are made
    ("bert token types", 8192, 2, "zeros"),
    ("bert positions", 8192, 512, "arange128"),
    ("bert words", 8192, 30522, "random"),
    ("gpt positions", 16384, 1024, "arange1024"),
    ("gpt words", 16384, 50304, "random"),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=300,
                    help="backward passes compared per case (default 300)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_repeatability: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.nn import functional as PF

    # the public switch first: its first call imports the inductor's config
    for label in ("first", "second"):
        t0 = time.perf_counter()
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.use_deterministic_algorithms(False)
        print(f"torch.use_deterministic_algorithms, {label} call: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms host", flush=True)

    def ms(fn, iters=50):
        for _ in range(3):
            fn()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    g = torch.Generator(device="cuda").manual_seed(0)
    for label, N, V, kind in CASES:
        if kind == "zeros":
            ids = torch.zeros(N, dtype=torch.long, device="cuda")
        elif kind.startswith("arange"):
            L = int(kind[len("arange"):])
            ids = torch.arange(L, device="cuda").repeat(N // L)
        else:
            ids = torch.randint(0, V, (N,), device="cuda", generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            dy = torch.randn(N, E, device="cuda", generator=g).to(dtype)

            def default():
                return torch.ops.aten.embedding_dense_backward(
                    dy, ids, V, -1, False)

            def deterministic():
                torch._C._set_deterministic_algorithms(True, warn_only=True)
                try:
                    return default()
                finally:
                    torch._C._set_deterministic_algorithms(False)

            w = torch.zeros(V, E, device="cuda", dtype=dtype,
                            requires_grad=True)

            def port():
                w.grad = None
                PF.embedding(ids, w).backward(dy)
                return w.grad

            out = []
            for name, fn in (("default", default),
                             ("deterministic", deterministic),
                             ("port forward+backward", port)):
                first = fn().clone()
                same = all(torch.equal(first, fn())
                           for _ in range(args.runs - 1))
                out.append(f"{name} {'repeatable' if same else 'NOT'} "
                           f"{ms(fn):.4f} ms")
            print(f"{label} ({N} ids, {V} rows) "
                  f"{str(dtype).split('.')[-1]}, {args.runs} runs: "
                  + "; ".join(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
