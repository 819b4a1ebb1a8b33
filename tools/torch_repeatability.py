#!/usr/bin/env python3
"""Are the embedding's weight gradient, ResNet-50's conv, pooling and
BatchNorm backwards and the static LeNet step repeatable on the card,
and what do the repeatable ones cost?

    python3 tools/torch_repeatability.py [--runs N]
                                         [--cases all|embedding|resnet|static]

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
(it sets the flag through ``torch._C``).

The ResNet cases, bfloat16 at bench_resnet50's batch of 128: the conv's
data gradient (dgrad) and weight gradient (wgrad) at four of ResNet-50's
shapes (the 7 x 7 / 2 stem, a 1 x 1, a 3 x 3 / 2 and a 1 x 1 / 2
downsample), each under cuDNN's default flags (no benchmarking,
non-deterministic algorithms allowed) and under the port's
(``ops.conv._cudnn``: deterministic algorithms only, no TF32); then the
port's ``max_pool2d`` backward on the stem's ReLU output (windows of
tied zeros), its global ``adaptive_avg_pool2d`` backward and its
BatchNorm backward, through autograd. Each: whether ``--runs``
backwards give the same bits, and the time of one.

The static case: bench_lenet_exec's program (``chip_smoke.lenet_program``,
B = 256, Momentum) run op by op (``Executor(use_cuda_graph=False)``, as
before it joins a CUDA graph) ``--runs`` times from one state: whether
every run gives the same loss and the same bits in every parameter and
velocity, and the time of one step. Needs one CUDA card.
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


# ResNet-50's convs in bench_resnet50: label, x (N, C, H, W), weight
# (O, C, k, k), stride, padding
CONVS = [("stem 7x7/2", (128, 3, 224, 224), (64, 3, 7, 7), 2, 3),
         ("1x1", (128, 256, 56, 56), (64, 256, 1, 1), 1, 0),
         ("3x3/2", (128, 128, 56, 56), (128, 128, 3, 3), 2, 1),
         ("1x1/2 downsample", (128, 256, 56, 56), (512, 256, 1, 1), 2, 0)]


def _ms(fn, iters=20):
    import torch

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


def _repeatable(fn, runs):
    """Whether ``runs`` calls of ``fn`` give the same bits in every tensor
    it returns."""
    import torch

    first = [t.clone() for t in fn()]
    return all(all(torch.equal(a, b) for a, b in zip(first, fn()))
               for _ in range(runs - 1))


def resnet_cases(runs):
    import torch

    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops.conv import _cudnn

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=g).to(
            torch.bfloat16)

    for label, xs, ws, stride, pad in CONVS:
        x, w = randn(*xs), randn(*ws) * (2.0 / (ws[1] * ws[2] ** 2)) ** 0.5
        out = torch.ops.aten.convolution(x, w, None, (stride,) * 2,
                                         (pad,) * 2, (1, 1), False, (0, 0), 1)
        dy = randn(*out.shape)
        row = []
        for setting, flags in (
                ("cuDNN default", lambda: torch.backends.cudnn.flags(
                    enabled=True, benchmark=False, deterministic=False)),
                ("port (deterministic)", _cudnn)):
            for part, mask in (("dgrad", [True, False, False]),
                               ("wgrad", [False, True, False])):
                def bwd(mask=mask, flags=flags):
                    with flags():
                        dx, dw, _ = torch.ops.aten.convolution_backward(
                            dy, x, w, None, (stride,) * 2, (pad,) * 2,
                            (1, 1), False, (0, 0), 1, mask)
                    return [dx if mask[0] else dw]

                same = _repeatable(bwd, runs)
                row.append(f"{setting} {part} "
                           f"{'repeatable' if same else 'NOT'} "
                           f"{_ms(bwd):.4f} ms")
        print(f"conv {label} x {xs} w {ws} bf16, {runs} runs: "
              + "; ".join(row), flush=True)

    def autograd(fn, *inputs):
        inputs = [t.requires_grad_() for t in inputs]
        out = fn(*inputs)
        dy = randn(*out.shape)
        return lambda: torch.autograd.grad(out, inputs, dy,
                                           retain_graph=True)

    stem = torch.relu(randn(128, 64, 112, 112))
    ones = torch.ones(64, device="cuda", dtype=torch.bfloat16)
    for label, bwd in (
            ("max_pool2d 3/2/1 on the stem's ReLU output (128, 64, 112, "
             "112), tied zeros",
             autograd(lambda t: PF.max_pool2d(t, 3, 2, 1), stem.clone())),
            ("adaptive_avg_pool2d (128, 2048, 7, 7) -> 1",
             autograd(lambda t: PF.adaptive_avg_pool2d(t, 1),
                      randn(128, 2048, 7, 7))),
            ("batch_norm training (128, 64, 112, 112), dx dweight dbias",
             autograd(lambda t, w, b: PF.batch_norm(
                 t, torch.zeros(64, device="cuda", dtype=torch.bfloat16),
                 ones.clone(), w, b, training=True),
                 randn(128, 64, 112, 112), ones.clone(),
                 torch.zeros_like(ones)))):
        same = _repeatable(bwd, runs)
        print(f"{label} bf16 backward, {runs} runs: "
              f"{'repeatable' if same else 'NOT'} {_ms(bwd):.4f} ms",
              flush=True)


def static_cases(runs):
    import torch

    import chip_smoke
    import paddle_tpu_torch as pt

    main, startup, loss, _, scope = chip_smoke.lenet_program()
    x, y = chip_smoke.lenet_batch()
    exe = pt.static.Executor(use_cuda_graph=False)
    exe.run(startup, scope=scope)
    init = chip_smoke.scope_state(main, scope)

    def step():
        chip_smoke.restore_scope(scope, init)
        out = exe.run(main, feed={"x": x, "y": y}, fetch_list=[loss],
                      scope=scope, return_numpy=False)
        return out + list(chip_smoke.scope_state(main, scope).values())

    same = _repeatable(step, runs)
    print(f"static LeNet step op by op (B = {chip_smoke.LENET_BATCH}, "
          f"Momentum; loss, {len(init)} parameters and velocities), "
          f"{runs} runs: {'repeatable' if same else 'NOT'} "
          f"{_ms(step):.4f} ms", flush=True)
    del exe
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=None,
                    help="backward passes compared per case (default 300 "
                    "for the embedding cases, 20 for the ResNet ones)")
    ap.add_argument("--cases", choices=("all", "embedding", "resnet",
                                        "static"),
                    default="all", help="which cases (default all)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_repeatability: no CUDA device", file=sys.stderr)
        return 2
    if args.cases in ("all", "resnet"):
        resnet_cases(args.runs or 20)
    if args.cases in ("all", "embedding"):
        embedding_cases(args.runs or 300)
    if args.cases in ("all", "static"):
        static_cases(args.runs or 20)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


def embedding_cases(runs):
    import torch

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
                           for _ in range(runs - 1))
                out.append(f"{name} {'repeatable' if same else 'NOT'} "
                           f"{ms(fn):.4f} ms")
            print(f"{label} ({N} ids, {V} rows) "
                  f"{str(dtype).split('.')[-1]}, {runs} runs: "
                  + "; ".join(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
