#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving path and its two training steps once
on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no final ``ok`` line) on
any failed check:

1. build   — every CUDA kernel library (paged attention, LayerNorm,
             softmax-cross-entropy, flash attention), from the sources in
             this checkout, with nvcc for sm_90a (all builds started
             together);
2. kernels — each kernel against its plain PyTorch version on the card:
             ragged lengths (0, 1, page edges, ~2000), shuffled pages,
             float32 (tolerance 2e-5) and bfloat16 pools (2e-2), at the
             serving width (H=12, D=64, page 16) and a narrow one (H=2,
             D=8); zero-length lanes exactly 0;
3. engine  — the main path at the full width of gpt_small (vocab 50304,
             12 heads x 64): 16 requests, prompts of 128-2048 tokens from
             RandomState(0), 32 new tokens each, through ``submit`` and
             ``run`` over a 4096-page float32 pool; tokens must equal the
             dense oracle on the card, every decode step must launch the
             paged kernel once, the pool must balance and usage telescope;
4. preempt — the same model over a 64-page pool that forces preemption,
             with the same checks;
5. timing  — the paged kernel, its plain version and gather + SDPA at
             the engine's decode shape, beside the bandwidth bound, plus
             the per-step host sync (logits to the host for the argmax).
6. train-kernels — the LayerNorm and softmax-cross-entropy kernels,
             forward and backward, against their plain versions on the
             card: LN at (8192, 768), (8, 128), N = 8191 (not a
             multiple of a CTA's rows) and bench_gpt's (16384, 768); CE
             at (8192, 50304), bench_gpt's (16384, 50304), (8, 128),
             V = 1000 (a ragged tail), all rows ignore_index, logits of
             magnitude ~1e3; float32 (tolerance 1e-5) and bfloat16
             (2e-2; bench_gpt's shapes in bfloat16 only), dgamma/dbeta
             and dlogits relative to the magnitudes of each entry's
             terms; dgamma/dbeta bitwise equal across two runs;
7. train   — the training main path: ``gpt_small`` at full width and
             depth (12 x 768, vocab 50304), dropout 0.1, float32, batch
             8 x 1024 from RandomState(0), AdamW(1e-4, decay 0.01) with
             global-norm clip 1.0 through ``TrainStep``, 4 steps; every
             loss finite, the first near ln(50304), launches exactly
             25/25/1/1 a step (LN fwd/bwd, CE fwd/bwd); then the same 4
             steps from the same weights and dropout seed through the
             plain versions (``plain_versions()``, zero launches) must
             give the same losses within TRAIN_LOSS_TOL;
8. train-timing — each training kernel at the float32 path's shape
             (8192 rows, float32) and at bench_gpt's (16384 rows,
             bfloat16): kernel, plain version and library call
             (``F.layer_norm`` and ``F.cross_entropy(reduction="none")``,
             forward and autograd backward) beside the bound from the
             bytes moved; LayerNorm warm (one input) and cold (inputs
             rotated over four times the L2), and the forward's scalar
             kernel, which the vector kernel took over at D = 768;
9. flash-kernels — the flash-attention forward, dQ and dK/dV kernels
             against their plain versions on the card: the bench_gpt
             shape (B*H = 192, L = 1024, D = 64, bfloat16, causal),
             float32 and bfloat16, causal and not, Lq = Lk and Lq < Lk,
             D = 64, 128, 192 and 256, and L = 200 and 100/300 (not
             multiples of the kernels' 64-row tile), each within
             FLASH tolerances (``flash_close``); dQ, dK and dV bitwise
             equal across two runs;
10. train-bf16 — bench_gpt's configuration (``bench.py:bench_gpt``):
             ``gpt_small`` at full width and depth, dropout 0,
             ``model.bfloat16()``, batch 16 x 1024 from RandomState(0),
             AdamW(1e-4, multi_precision) with global-norm clip 1.0,
             through ``TrainStep`` for 4 steps; every loss finite, the
             first near ln(50304), launches exactly 25/25/1/1/12/12/12 a
             step (LN fwd/bwd, CE fwd/bwd, flash fwd/dQ/dKV); then the
             same steps through the plain versions (zero launches) must
             give the same losses within BF16_TRAIN_LOSS_TOL;
11. flash-timing — each flash kernel at the path's shape: kernel, plain
             version and ``F.scaled_dot_product_attention(is_causal=True)``
             (forward; its autograd backward for both backward kernels,
             and beside the two backward kernels launched back to back),
             beside the bound at the bfloat16 tensor-core rate.

It prints the card's name and power limit, a ``{"kernels": [...]}``
line, and as its last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or away from the repo, it exits non-zero and prints no
result.
"""
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

FULL = dict(vocab_size=50304, num_heads=12, head_dim=64)  # gpt_small
POOL = dict(num_pages=4096, page_size=16)                  # README's pool
F32_TOL = 2e-5
BF16_TOL = 2e-2
LOGIT_TOL = 1e-5   # float32 logits (magnitude ~0.02), engine vs oracle
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # bfloat16 tensor cores, dense
TRAIN_F32_TOL = 1e-5
# losses of the kernel run vs the plain-version run on the card, absolute
# on each of the 4 steps: two float32 spacings at ~10.9. Seen on an H100
# 80GB HBM3 (700 W): 0 on every step. tools/torch_planted_faults.py plants
# dgamma = 0 (diffs 0, 5.7e-6, 9.5e-6, 6.3e-5) and dbeta = 0 (0, 6.4e-5,
# 2.0e-4, 2.4e-4) in the LayerNorm backward: both fail
TRAIN_LOSS_TOL = 2e-6
LOSS_NEAR_LN_V = 0.5   # logits of std ~0.55 at init: loss ~ ln V + 0.15
# flash kernels against their plain versions (flash_close): float32 sums
# in another order; in bfloat16 also one rounding step of the output
FLASH_F32_TOL = 1e-5
FLASH_BF16_STEP = 2 ** -7      # a bfloat16 keeps 8 significant bits
# losses of the bf16 kernel run vs its plain-version run, absolute on each
# of the 4 steps. Seen on an H100 80GB HBM3 (700 W): 6.1e-5, 4.0e-5,
# 7.9e-4, 2.8e-4 (bfloat16 roundings that flip between the two runs).
# tools/torch_planted_faults.py plants dV = 0 in the flash dK/dV kernel:
# its losses leave the honest run's by 0, 7.2e-2, 3.6e-1, 5.3e-1 and fail
BF16_TRAIN_LOSS_TOL = 1e-2
# a timed run's launches are queued while the card spins this many cycles
# (~20 ms at the H100's 1.98 GHz), longer than the host takes to issue them
QUEUE_CYCLES = 40_000_000
# LayerNorm's cold timing rotates over at least this many bytes of inputs
# and outputs: four times the H100's 50 MB L2
COLD_BYTES = 200 * 10 ** 6
# the training configurations of the main path, driven by phases 7 and 10
# and profiled by tools/torch_train_profile.py: gpt_small at full width and
# depth, batch x 1024 ids from RandomState(0), AdamW(1e-4, decay 0.01) with
# global-norm clip 1.0 (train_model, train_optimizer)
TRAIN_CONFIGS = {
    # name: dropout, model.bfloat16(), batch, AdamW's multi_precision
    "dropout0.1-float32": dict(dropout=0.1, bfloat16=False, batch=8,
                               multi_precision=False),
    "bench_gpt": dict(dropout=0.0, bfloat16=True, batch=16,
                      multi_precision=True),
}


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def log(*a):
    print(*a, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rotating(fns):
    """One callable that calls ``fns`` in turn, one a call."""
    turn = itertools.cycle(fns)
    return lambda: next(turn)()


def cuda_ms(fn, iters, warmup=3):
    """Milliseconds of the card's time a call of ``fn`` takes: ``iters``
    calls between two CUDA events, queued while the card spins
    ``QUEUE_CYCLES``, so that the events time the launches on the card
    and not how fast the host issues them (a wrapper can take longer to
    issue a launch than a small kernel takes to run)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2: kernels against their plain versions ---------------------------


def paged_inputs(lengths, H, D, page, P, pool_dtype, seed, pools=None):
    """Random q and pools (unless given), distinct shuffled pages per
    lane, table width the engine's bucket of the longest lane."""
    import torch

    from paddle_tpu_torch.serving.engine import _len_bucket

    g = torch.Generator().manual_seed(seed)
    B = len(lengths)
    need = [-(-n // page) for n in lengths]
    W = _len_bucket(max(max(need), 1), 1)
    check(sum(need) < P, "kernel case needs more pages than the pool")
    q = torch.randn(B, H, D, generator=g).cuda()
    if pools is None:
        pools = tuple(torch.randn(P, page, H, D, generator=g).to(
            "cuda", pool_dtype) for _ in range(2))
    perm = torch.randperm(P - 1, generator=g) + 1
    table = torch.zeros(B, W, dtype=torch.int32)
    used = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[used:used + n].int()
        used += n
    lengths = torch.tensor(lengths, dtype=torch.int32)
    return (q, pools[0], pools[1], table.cuda(), lengths.cuda())


def kernel_phase():
    import torch

    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    ragged = [0, 1, 15, 16, 17, 31, 32, 33, 2000, 1999, 2048, 0, 777, 64,
              5, 1024]
    cases = [("full", ragged, 12, 64, 16, 4096),
             ("narrow", ragged, 2, 8, 16, 4096),
             ("narrow-page4", [0, 1, 3, 4, 5, 9, 23, 0], 2, 8, 4, 64)]
    errs = {}
    for name, lengths, H, D, page, P in cases:
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            args = paged_inputs(lengths, H, D, page, P, dtype, seed=len(errs))
            out = pa.paged_decode_attention(*args)
            torch.cuda.synchronize()
            ref = pa.paged_decode_attention_reference(*args)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            bound = (tol + tol * ref.abs()).sub((out - ref).abs()).min()
            zero = args[4] == 0
            log(f"kernel paged_decode_attention {name} H={H} D={D} "
                f"page={page} pool={str(dtype).split('.')[-1]} "
                f"max_abs_err={err:.3e} (tol {tol})")
            check(bool(torch.isfinite(out).all()), f"{name}: non-finite")
            check(bound.item() >= 0, f"{name} {dtype}: kernel disagrees "
                  f"with its plain version (max abs err {err})")
            check(bool((out[zero] == 0).all()),
                  f"{name}: zero-length lane is not exactly 0")
            errs[(name, dtype)] = err
    return errs


# -- phases 3 and 4: the serving main path -----------------------------------


class LogitRows:
    """The engine's ``sample_fn`` for this run: picks the argmax as the
    engine's default does, and keeps the logits it was given at 512
    fixed probe positions (a copy of 2 KB, so the step's timing stays
    the engine's own) under the request they went to — the request
    whose ``generated`` grew right after the call. In this model the
    tied embedding's residual dominates the argmax, so tokens alone say
    little about attention; the logits do."""

    def __init__(self, vocab):
        self.vocab = vocab
        self.probe = np.sort(np.random.RandomState(7).choice(
            vocab, min(512, vocab), replace=False))
        self.rows, self._reqs, self._lens, self._pending = {}, [], [], None

    def track(self, reqs):
        self._reqs, self._lens = list(reqs), [0] * len(reqs)

    def settle(self):
        if self._pending is None:
            return
        for j, r in enumerate(self._reqs):
            if len(r.generated) > self._lens[j]:
                self._lens[j] = len(r.generated)
                self.rows.setdefault(r.rid, []).append(self._pending)
                self._pending = None
                return
        raise CheckFailed("a logits row went to no request")

    def __call__(self, row):
        self.settle()
        check(row.shape == (self.vocab,), f"logits row of shape {row.shape}")
        self._pending = row[self.probe].copy()
        return int(np.argmax(row))


def oracle_logits(model, ctx):
    """Dense (unpaged) logits for the next token after ``ctx``."""
    import torch

    from paddle_tpu_torch.ops.kernels import dense_decode_reference

    with torch.inference_mode():
        ids = torch.tensor(ctx, device=model.device)
        emb, q, k, v = model.qkv(ids)
        attn = dense_decode_reference(q[-1:], k[None], v[None])[0]
        return model.head(attn[None], emb[-1:])[0].cpu().numpy()


def oracle_check(model, req, prompt, max_new, rows, probe):
    """Tokens must equal the dense oracle's greedy decode, and the
    logits the engine chose each token from must equal the oracle's for
    the same context, at the probe positions. Returns the largest
    logits error."""
    ref = model.reference_generate(prompt, max_new)
    if req.generated != ref:
        i = next(j for j, (a, b) in enumerate(zip(req.generated, ref))
                 if a != b)
        top = np.sort(oracle_logits(model, prompt + ref[:i]))[-2:]
        raise CheckFailed(
            f"{req.rid}: token {i} is {req.generated[i]}, oracle "
            f"{ref[i]}; oracle top-2 logit gap {top[1] - top[0]:.3e}")
    check(len(rows) == len(ref), f"{req.rid}: {len(rows)} logits rows "
          f"for {len(ref)} tokens")
    worst = 0.0
    for i, row in enumerate(rows):
        want = oracle_logits(model, prompt + ref[:i])[probe]
        err = float(np.abs(row - want).max())
        check(bool(np.isfinite(row).all()) and row.shape == want.shape
              and np.allclose(row, want, atol=LOGIT_TOL, rtol=LOGIT_TOL),
              f"{req.rid}: logits of token {i} differ from the oracle's "
              f"by {err:.3e}")
        worst = max(worst, err)
    return worst


def serve(model, cache, budget, prompts, max_new, label):
    """One run of the main path with the launch counts zeroed just
    before and read just after. Returns the engine, its requests and the
    counts."""
    import torch

    from paddle_tpu_torch.obs import trace
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import Scheduler, ServeEngine

    rows = LogitRows(model.vocab_size)
    eng = ServeEngine(model, cache, sample_fn=rows,
                      scheduler=Scheduler(cache, token_budget=budget))
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    rows.track(reqs)
    trace.clear_trace()
    trace.enable_tracing()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    trace.disable_tracing()
    rows.settle()
    spans = {}
    for ev in trace.trace_events():
        spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    st = eng.stats()
    dec = sorted(spans.get("serving.decode", []))
    log(f"{label}: {len(prompts)} requests, {st['steps']} steps "
        f"({eng.usage.prefills} prefills, {eng.usage.decode_steps} decode "
        f"steps), {st['preemptions']} preemptions, wall {wall * 1e3:.1f} ms;"
        f" prefill total {sum(spans.get('serving.prefill', [])):.1f} ms, "
        f"decode total {sum(dec):.1f} ms, decode step p50 "
        f"{dec[len(dec) // 2] if dec else float('nan'):.3f} ms")
    log(f"{label}: launches {launches}")
    check(all(r.state == "FINISHED" for r in reqs),
          f"{label}: not every request finished")
    check(launches["paged_decode_attention"] == eng.usage.decode_steps > 0,
          f"{label}: {launches} kernel launches for "
          f"{eng.usage.decode_steps} decode steps")
    logit_err = max(oracle_check(model, r, p, max_new, rows.rows[r.rid],
                                 rows.probe)
                    for r, p in zip(reqs, prompts))
    check(cache.verify() and cache.stats()["used_pages"] == 0,
          f"{label}: pool does not balance: {cache.stats()}")
    u = eng.usage
    check(u.verify() and u.busy_ns == sum(u.device_ns.values()) > 0,
          f"{label}: usage does not telescope")
    log(f"{label}: tokens equal the dense oracle for all {len(reqs)} "
        f"requests, logits within {logit_err:.3e} of it (tol "
        f"{LOGIT_TOL}); pool balanced; usage telescopes")
    return eng, reqs, launches


# -- phase 5: timing ---------------------------------------------------------


def paged_bound_ms(lengths, page, H, D, itemsize, W):
    """Least time for one decode attention call: each live K/V row read
    once, q/table/lengths read and the output written once, against the
    float32 operations it needs."""
    B = len(lengths)
    live_rows = sum(-(-n // page) * page for n in lengths)
    nbytes = (2 * live_rows * H * D * itemsize + 2 * B * H * D * 4
              + B * W * 4 + B * 4)
    flops = 4 * sum(lengths) * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def gather_sdpa(q, k_pages, v_pages, table, lengths):
    """The library yardstick: gather the pages, then one SDPA call."""
    import torch
    import torch.nn.functional as F

    B, H, D = q.shape
    page = k_pages.shape[1]
    L = table.shape[1] * page
    k = k_pages[table.long()].reshape(B, L, H, D).transpose(1, 2)
    v = v_pages[table.long()].reshape(B, L, H, D).transpose(1, 2)
    mask = torch.arange(L, device=q.device)[None, :] < lengths[:, None]
    return F.scaled_dot_product_attention(
        q[:, :, None, :], k, v, attn_mask=mask[:, None, None, :])[:, :, 0]


def timing_phase(cache, prompt_lens, vocab, gpu):
    import torch

    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    # the engine's first full decode step: 16 lanes, each prompt + 1
    lengths = [n + 1 for n in prompt_lens]
    H, D, page = cache.num_heads, cache.head_dim, cache.page_size
    args = paged_inputs(lengths, H, D, page, cache.num_pages,
                        torch.float32, seed=99,
                        pools=(cache.k_pages[0], cache.v_pages[0]))
    out = pa.paged_decode_attention(*args)
    ref = pa.paged_decode_attention_reference(*args)
    lib = gather_sdpa(*args)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    check(err <= F32_TOL * (1 + ref.abs().max().item()),
          f"engine-shape kernel disagrees with plain version: {err}")
    lib_err = (lib - ref).abs().max().item()
    ms = cuda_ms(lambda: pa.paged_decode_attention(*args), 50)
    plain_ms = cuda_ms(lambda: pa.paged_decode_attention_reference(*args),
                       10)
    lib_ms = cuda_ms(lambda: gather_sdpa(*args), 10)
    ms2 = cuda_ms(lambda: pa.paged_decode_attention(*args), 50)
    bound, bound_by, nbytes = paged_bound_ms(
        lengths, page, H, D, 4, args[3].shape[1])
    # the per-step host sync: (16, V) float32 logits to the host and the
    # numpy argmax the engine runs there
    logits = torch.randn(len(lengths), vocab, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        host = logits.cpu().numpy()
        np.argmax(host, axis=-1)
    sync_ms = (time.perf_counter() - t0) / 20 * 1e3
    log(f"timing paged_decode_attention B={len(lengths)} H={H} D={D} "
        f"page={page} W={args[3].shape[1]} context={sum(lengths)} tokens: "
        f"kernel {ms:.4f} ms (again {ms2:.4f}), plain {plain_ms:.4f} ms, "
        f"gather+SDPA {lib_ms:.4f} ms (max abs err vs plain {lib_err:.2e}),"
        f" bound {bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB at 3.35 "
        f"TB/s) = {bound / ms * 100:.1f}% of roofline; host sync "
        f"{sync_ms:.3f} ms per step ({len(lengths)} x {vocab} float32 "
        f"logits + numpy argmax) [{gpu}]")
    return dict(max_abs_err=err, ms=min(ms, ms2), plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, library_ms=lib_ms)


# -- phase 6: training kernels against their plain versions ------------------


def within(out, ref, tol, scale=None):
    """``|out - ref| <= tol * (1 + |ref|)`` elementwise, or ``tol *
    scale`` (plus the least normal float32, below which a float has no
    relative precision) for a value whose terms have magnitudes summing
    to ``scale``. Returns ``(ok, max abs err)``."""
    import torch

    err = (out.float() - ref.float()).abs()
    bound = (tol * (1 + ref.float().abs()) if scale is None else
             tol * scale + torch.finfo(torch.float32).tiny)
    return bool((err <= bound).all()), err.max().item()


def ce_bwd_scale(x, lab, lse, g):
    """The magnitudes of each dlogits entry's two terms, ``p * g +
    onehot * g`` with ``p = exp(x - lse)``, 0 on ignore_index rows. Most
    entries are ~g/V, far below 1, so the bound must scale with each
    entry: a bound of ``tol * (1 + |ref|)`` would pass a kernel that
    wrote 0 everywhere off the label column."""
    import torch

    valid = lab != -100
    gv = g.float() * valid
    scale = torch.exp(x.float() - lse[:, None]) * gv[:, None]
    rows = valid.nonzero()[:, 0]
    scale[rows, lab[rows].long()] += gv[rows]
    return scale


def train_kernel_phase():
    """Each LN and CE kernel against its plain version; returns the
    largest abs error of each kernel over every case."""
    import torch

    from paddle_tpu_torch.ops.kernels import layernorm as ln
    from paddle_tpu_torch.ops.kernels import softmax_ce as ce

    errs = dict.fromkeys(("layer_norm_fwd", "layer_norm_bwd",
                          "softmax_ce_fwd", "softmax_ce_bwd"), 0.0)

    def note(kernel, label, what, res):
        ok, err = res
        errs[kernel] = max(errs[kernel], err)
        check(ok, f"{kernel} {label}: {what} disagrees with the plain "
              f"version (max abs err {err:.3e})")
        return err

    both = ((torch.float32, TRAIN_F32_TOL), (torch.bfloat16, BF16_TOL))
    bf16 = both[1:]
    g = torch.Generator(device="cuda").manual_seed(11)
    # (16384, 768) bfloat16 is bench_gpt's shape: its own CTA partition of
    # the dgamma/dbeta partials and their reduce
    for N, D, dtypes in ((8192, 768, both), (8, 128, both),
                         (8191, 768, both), (16384, 768, bf16)):
        for dtype, tol in dtypes:
            label = f"({N}, {D}) {str(dtype).split('.')[-1]}"
            x = (torch.randn(N, D, generator=g, device="cuda") * 2
                 + 0.5).to(dtype)
            dy = torch.randn(N, D, generator=g, device="cuda").to(dtype)
            gamma, beta = (torch.randn(D, generator=g, device="cuda")
                           .to(dtype) for _ in range(2))
            y, mean, rstd = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
            dx, dg, db = ln.layer_norm_bwd(x, gamma, mean, rstd, dy)
            dx2, dg2, db2 = ln.layer_norm_bwd(x, gamma, mean, rstd, dy)
            torch.cuda.synchronize()
            yr, mr, rr = ln.layer_norm_fwd_reference(x, gamma, beta, 1e-5)
            dxr, dgr, dbr = ln.layer_norm_bwd_reference(x, gamma, mean,
                                                        rstd, dy)
            e = [note("layer_norm_fwd", label, "y", within(y, yr, tol)),
                 note("layer_norm_fwd", label, "mean",
                      within(mean, mr, TRAIN_F32_TOL)),
                 note("layer_norm_fwd", label, "rstd",
                      within(rstd, rr, TRAIN_F32_TOL)),
                 note("layer_norm_bwd", label, "dx", within(dx, dxr, tol))]
            xhat = (x.float() - mean) * rstd
            e.append(note("layer_norm_bwd", label, "dgamma", within(
                dg, dgr, tol, (dy.float() * xhat).abs().sum(0))))
            e.append(note("layer_norm_bwd", label, "dbeta", within(
                db, dbr, tol, dy.float().abs().sum(0))))
            check(torch.equal(dg, dg2) and torch.equal(db, db2)
                  and torch.equal(dx, dx2),
                  f"layer_norm_bwd {label}: two runs differ")
            log(f"train-kernel layer_norm {label}: max abs err y/mean/rstd/"
                f"dx/dgamma/dbeta " + " ".join(f"{v:.2e}" for v in e)
                + f" (tol {tol}); dgamma/dbeta bitwise equal across runs")
    cases = [("full", 8192, 50304, 1.0, False, both),
             ("path-bf16", 16384, 50304, 1.0, False, bf16),   # bench_gpt's
             ("narrow", 8, 128, 3.0, False, both),
             ("tail", 16, 1000, 3.0, False, both),
             ("ignored", 8, 128, 3.0, True, both),
             ("large", 64, 4096, 1e3, False, both)]
    for name, N, V, scale, all_ignored, dtypes in cases:
        for dtype, tol in dtypes:
            label = f"{name} ({N}, {V}) {str(dtype).split('.')[-1]}"
            x = (torch.randn(N, V, generator=g, device="cuda")
                 * scale).to(dtype)
            lab = torch.randint(0, V, (N,), generator=g, device="cuda")
            lab[::5] = -100
            if all_ignored:
                lab[:] = -100
            gl = torch.rand(N, generator=g, device="cuda")
            loss, lse = ce.softmax_ce_fwd(x, lab)
            dx = ce.softmax_ce_bwd(x, lab, lse, gl)
            torch.cuda.synchronize()
            lr, lser = ce.softmax_ce_fwd_reference(x, lab)
            # the backward's inputs are the forward kernel's lse, held to
            # the plain lse above
            dxr = ce.softmax_ce_bwd_reference(x, lab, lse, gl)
            e = [note("softmax_ce_fwd", label, "loss",
                      within(loss, lr, TRAIN_F32_TOL)),
                 note("softmax_ce_fwd", label, "lse",
                      within(lse, lser, TRAIN_F32_TOL)),
                 note("softmax_ce_bwd", label, "dlogits",
                      within(dx, dxr, tol, ce_bwd_scale(x, lab, lse, gl)))]
            ign = lab == -100
            check(bool((loss[ign] == 0).all() and (dx[ign] == 0).all()),
                  f"softmax_ce {label}: ignore_index rows are not 0")
            check(bool(torch.isfinite(loss).all()
                       and torch.isfinite(dx.float()).all()),
                  f"softmax_ce {label}: non-finite output")
            log(f"train-kernel softmax_ce {label}: max abs err loss/lse/"
                f"dlogits " + " ".join(f"{v:.2e}" for v in e)
                + f" (tol {tol}); {int(ign.sum())} ignore_index rows 0")
            del x, dx, dxr
    return errs


# -- phase 7: the training main path -----------------------------------------


def train_launches(cfg, steps, flash):
    """The launches ``steps`` training steps of ``cfg`` must make: two
    LayerNorms a block and ln_f, forward and backward; one cross-entropy
    forward and backward; with ``flash``, each flash kernel once a
    block."""
    ln = (2 * cfg.layers + 1) * steps
    fl = cfg.layers * steps if flash else 0
    return {"paged_decode_attention": 0, "layer_norm_fwd": ln,
            "layer_norm_bwd": ln, "softmax_ce_fwd": steps,
            "softmax_ce_bwd": steps, "flash_attention_fwd": fl,
            "flash_attention_bwd_dq": fl, "flash_attention_bwd_dkv": fl}


def train_model(config):
    """``gpt_small`` in ``TRAIN_CONFIGS[config]`` on the card, weights
    from seed 0."""
    import torch

    from paddle_tpu_torch.models.nlp import gpt

    c = TRAIN_CONFIGS[config]
    model = gpt.GPT(gpt.gpt_small(dropout=c["dropout"]),
                    generator=torch.Generator(device="cuda").manual_seed(0))
    return model.bfloat16() if c["bfloat16"] else model


def train_optimizer(model, config):
    """AdamW(1e-4, decay 0.01, global-norm clip 1.0) over ``model``, with
    ``TRAIN_CONFIGS[config]``'s multi_precision."""
    from paddle_tpu_torch import optim

    return optim.AdamW(
        parameters=model.named_parameters(), learning_rate=1e-4,
        weight_decay=0.01, grad_clip=optim.ClipGradByGlobalNorm(1.0),
        multi_precision=TRAIN_CONFIGS[config]["multi_precision"])


def train_run(model, config, init, ids, labels, steps, plain):
    """``steps`` TrainStep calls from the weights ``init`` with the
    dropout generator reseeded and ``config``'s optimizer, launch counts
    zeroed just before and read just after. Returns (losses, launches,
    step walls in ms)."""
    import contextlib

    import torch

    from paddle_tpu_torch import core
    from paddle_tpu_torch.framework import TrainStep
    from paddle_tpu_torch.models.nlp.gpt import gpt_loss
    from paddle_tpu_torch.ops import kernels

    model.load_state_dict(init)
    core.seed(1)
    step = TrainStep(model, train_optimizer(model, config), gpt_loss)
    losses, walls = [], []
    with kernels.plain_versions() if plain else contextlib.nullcontext():
        torch.cuda.synchronize()
        kernels.reset_launches()
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step(ids, labels)))   # syncs on the loss
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = kernels.launches()
    return losses, launches, walls


def train_compare(label, config, steps, flash, loss_tol, gpu):
    """The training main path: ``steps`` steps of ``TRAIN_CONFIGS[config]``
    on its batch x max_seq from RandomState(0) through the kernels, then
    the same steps from the same weights through the plain versions. Checks
    finite losses, the first near ln V, the launch counts (exactly
    ``train_launches``; none in the plain run) and the per-step loss
    differences against ``loss_tol``. Returns the kernel run's
    launches."""
    import math

    import torch

    model = train_model(config)
    c, cfg = TRAIN_CONFIGS[config], model.cfg
    B, L = c["batch"], cfg.max_seq
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (B, L))
    labels = np.roll(ids, -1, axis=1)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{label}: gpt_small {n_params / 1e6:.1f}M parameters (12 x 768, "
        f"vocab {cfg.vocab_size}), {config}: dropout {c['dropout']}, "
        f"{'bfloat16' if c['bfloat16'] else 'float32'}, multi_precision "
        f"{c['multi_precision']}, batch {B} x {L}")
    torch.cuda.reset_peak_memory_stats()
    losses, launches, walls = train_run(model, config, init, ids, labels,
                                        steps, False)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = train_launches(cfg, steps, flash)
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    log(f"{label}: kernel run losses {losses}; step wall ms "
        + " ".join(f"{w:.1f}" for w in walls)
        + f" (median of steps 2-{steps}: {steady:.1f} ms = "
        f"{B * L / steady * 1e3:.0f} tokens/s); peak memory {peak:.1f} GiB;"
        f" launches {launches} [{gpu}]")
    check(all(math.isfinite(x) for x in losses),
          f"{label}: non-finite loss")
    ln_v = math.log(cfg.vocab_size)
    check(abs(losses[0] - ln_v) < LOSS_NEAR_LN_V,
          f"{label}: first loss {losses[0]} is not within {LOSS_NEAR_LN_V} "
          f"of ln {cfg.vocab_size} = {ln_v:.4f}")
    check(launches == want, f"{label}: launches {launches}, want {want}")
    plain, plain_launches, plain_walls = train_run(
        model, config, init, ids, labels, steps, True)
    diffs = [abs(a - b) for a, b in zip(losses, plain)]
    log(f"{label}: plain-version run losses {plain}; |diff| "
        + " ".join(f"{d:.2e}" for d in diffs) + f" (tol {loss_tol}); "
        f"step wall ms " + " ".join(f"{w:.1f}" for w in plain_walls)
        + f"; launches {plain_launches}")
    check(set(plain_launches.values()) == {0},
          f"{label}: the plain-version run launched {plain_launches}")
    check(all(d <= loss_tol for d in diffs),
          f"{label}: the kernel run's losses differ from the plain "
          f"versions'")
    del model, init
    torch.cuda.empty_cache()
    return launches


def train_phase(gpu):
    """Phase 7: gpt_small at its defaults (dropout 0.1, float32), batch
    8: dense attention, the LayerNorm and cross-entropy kernels."""
    return train_compare("train", "dropout0.1-float32", 4, False,
                         TRAIN_LOSS_TOL, gpu)


def train_bf16_phase(gpu):
    """Phase 10: bench_gpt's configuration (``bench.py:187-210``):
    dropout 0, ``model.bfloat16()``, batch 16, multi_precision AdamW —
    flash attention in every block."""
    return train_compare("train-bf16", "bench_gpt", 4, True,
                         BF16_TRAIN_LOSS_TOL, gpu)


# -- phase 8: training kernels timed at the path's shape ---------------------


def train_timing_phase(gpu, N, dtype):
    """Kernel, plain version and library call for each training kernel at
    a train path's shape (N rows, D = 768, V = 50304, in ``dtype``: 8 x
    1024 float32 rows for the float32 step, 16 x 1024 bfloat16 ones for
    bench_gpt), beside the least time the card could take: the bytes
    each must move (every input read once, every output written once)
    over 3.35 TB/s against its float32 operations (the kernels compute
    in float32 whatever the type) over 67 TFLOP/s.

    The LayerNorm kernels and their library calls are timed twice: warm,
    every launch on the same input (which, at 25 MB, may still sit in the
    50 MB L2 from the launch before), and cold, launches rotating over
    ``COLD_BYTES`` of distinct inputs and outputs, so that no launch
    finds its input in L2, as a training step's LayerNorm does not. The
    row keeps the cold times as ``ms`` and ``library_ms``. Beside the
    LayerNorm forward, its scalar kernel at the same shape, checked
    against the plain version and timed warm and cold (logged only)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import layernorm as ln
    from paddle_tpu_torch.ops.kernels import softmax_ce as ce

    D, V = 768, 50304
    g = torch.Generator(device="cuda").manual_seed(13)
    x, dy = (torch.randn(N, D, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    gamma, beta = (torch.randn(D, generator=g, device="cuda").to(dtype)
                   for _ in range(2))
    logits = torch.randn(N, V, generator=g, device="cuda").to(dtype)
    lab = torch.randint(0, V, (N,), generator=g, device="cuda")
    gl = torch.full((N,), 1.0 / N, device="cuda")
    _, mean, rstd = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
    _, lse = ce.softmax_ce_fwd(logits, lab)

    xl = x.clone().requires_grad_()
    wl, bl = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
    yl = F.layer_norm(xl, (D,), wl, bl, 1e-5)
    cl = logits.clone().requires_grad_()
    lossl = F.cross_entropy(cl, lab, reduction="none")

    # copies for the cold timing: their inputs and outputs come to
    # COLD_BYTES, so a copy's lines have left L2 before its next turn
    reps = -(-COLD_BYTES // (2 * N * D * x.element_size()))
    xs = [torch.randn(N, D, generator=g, device="cuda").to(dtype)
          for _ in range(reps)]
    dys = [torch.randn(N, D, generator=g, device="cuda").to(dtype)
           for _ in range(reps)]
    stats = [ln.layer_norm_fwd(xi, gamma, beta, 1e-5)[1:] for xi in xs]
    xls = [xi.clone().requires_grad_() for xi in xs]
    yls = [F.layer_norm(xi, (D,), wl, bl, 1e-5) for xi in xls]
    cold = {
        # name: (kernel, library), each rotating over the copies
        "layer_norm_fwd": (
            rotating([lambda xi=xi: ln.layer_norm_fwd(xi, gamma, beta, 1e-5)
                      for xi in xs]),
            rotating([lambda xi=xi: F.layer_norm(xi, (D,), gamma, beta,
                                                 1e-5) for xi in xs])),
        "layer_norm_bwd": (
            rotating([lambda i=i: ln.layer_norm_bwd(xs[i], gamma, *stats[i],
                                                    dys[i])
                      for i in range(reps)]),
            rotating([lambda i=i: torch.autograd.grad(
                yls[i], (xls[i], wl, bl), dys[i], retain_graph=True)
                for i in range(reps)])),
    }
    # PR 2-4's forward, the scalar ln_fwd_kernel, which the vector kernel
    # took over at this width: an x one element past a 16-byte boundary
    # sends the forward there (the dispatch in csrc/layernorm.cu)
    def off16(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view_as(t)

    xos = [off16(xi) for xi in xs]
    scalar = (lambda: ln.layer_norm_fwd(xos[0], gamma, beta, 1e-5),
              rotating([lambda xi=xi: ln.layer_norm_fwd(xi, gamma, beta,
                                                        1e-5)
                        for xi in xos]))

    s, f4, il = x.element_size(), 4, lab.element_size()
    rows = {
        # name: (kernel, plain, library, bytes, float32 operations)
        "layer_norm_fwd": (
            lambda: ln.layer_norm_fwd(x, gamma, beta, 1e-5),
            lambda: ln.layer_norm_fwd_reference(x, gamma, beta, 1e-5),
            lambda: F.layer_norm(x, (D,), gamma, beta, 1e-5),
            s * (2 * N * D + 2 * D) + f4 * 2 * N, 8 * N * D),
        "layer_norm_bwd": (
            lambda: ln.layer_norm_bwd(x, gamma, mean, rstd, dy),
            lambda: ln.layer_norm_bwd_reference(x, gamma, mean, rstd, dy),
            lambda: torch.autograd.grad(yl, (xl, wl, bl), dy,
                                        retain_graph=True),
            s * (3 * N * D + 3 * D) + f4 * 2 * N, 12 * N * D),
        "softmax_ce_fwd": (
            lambda: ce.softmax_ce_fwd(logits, lab),
            lambda: ce.softmax_ce_fwd_reference(logits, lab),
            lambda: F.cross_entropy(logits, lab, reduction="none"),
            s * N * V + (il + 2 * f4) * N, 4 * N * V),
        "softmax_ce_bwd": (
            lambda: ce.softmax_ce_bwd(logits, lab, lse, gl),
            lambda: ce.softmax_ce_bwd_reference(logits, lab, lse, gl),
            lambda: torch.autograd.grad(lossl, cl, gl, retain_graph=True),
            s * 2 * N * V + (il + 2 * f4) * N, 4 * N * V),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, flops) in rows.items():
        iters = 50 if name.startswith("layer") else 10
        ms = cuda_ms(kern, iters)
        plain_ms = cuda_ms(plain, max(iters // 5, 2))
        lib_ms = cuda_ms(lib, iters)
        ms2 = cuda_ms(kern, iters)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        tag = (f"timing {name} N={N} D={D if 'layer' in name else V} "
               f"{str(dtype).split('.')[-1]}")
        log(f"{tag}{' warm' if name in cold else ''}:"
            f" kernel {ms:.4f} ms (again {ms2:.4f}), plain {plain_ms:.4f} "
            f"ms, library {lib_ms:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by}: {nbytes / 1e6:.1f} MB at 3.35 TB/s) = "
            f"{bound / min(ms, ms2) * 100:.1f}% of roofline [{gpu}]")
        if name in cold:
            kern_c, lib_c = cold[name]
            ms = cuda_ms(kern_c, iters)
            lib_ms = cuda_ms(lib_c, iters)
            ms2 = cuda_ms(kern_c, iters)
            log(f"{tag} cold ({reps} copies of its inputs in turn): "
                f"kernel {ms:.4f} ms (again {ms2:.4f}), library "
                f"{lib_ms:.4f} ms, bound {bound:.4f} ms = "
                f"{bound / min(ms, ms2) * 100:.1f}% of roofline [{gpu}]")
        if name == "layer_norm_fwd":
            tol = TRAIN_F32_TOL if dtype == torch.float32 else BF16_TOL
            ok, err = within(scalar[0]()[0], ln.layer_norm_fwd_reference(
                xos[0], gamma, beta, 1e-5)[0], tol)
            check(ok, f"{tag} scalar kernel: y disagrees with the plain "
                  f"version (max abs err {err:.3e})")
            warm_s, cold_s = cuda_ms(scalar[0], iters), cuda_ms(scalar[1],
                                                                 iters)
            log(f"{tag} scalar ln_fwd_kernel (PR 2-4's forward; x off "
                f"16-byte alignment): warm {warm_s:.4f} ms, cold "
                f"{cold_s:.4f} ms = {bound / cold_s * 100:.1f}% of roofline"
                f" (max abs err vs plain {err:.2e}) [{gpu}]")
        # LayerNorm: the cold times (a training step's inputs are not in L2)
        out[name] = dict(ms=min(ms, ms2), plain_ms=plain_ms,
                         bound_ms=bound, bound_by=bound_by,
                         library_ms=lib_ms)
    return out


# -- phase 9: flash-attention kernels against their plain versions -----------


def flash_close(out, ref, grad):
    """Flash tolerance: ``|out - ref| <= rtol * |ref| + atol * m``, with
    ``m`` 1 for O and lse and the largest ``|ref|`` for a gradient (its
    entries are sums of terms of that order, which cancel). float32:
    rtol = atol = FLASH_F32_TOL. bfloat16: rtol one bfloat16 step
    (FLASH_BF16_STEP), since both sides round a float32 result that
    differs in its last bits; atol FLASH_F32_TOL. lse is float32 in
    both. Returns ``(ok, max abs err)``."""
    import torch

    err = (out.float() - ref.float()).abs()
    a = ref.float().abs()
    m = a.max() if grad else 1.0
    rtol = FLASH_BF16_STEP if out.dtype == torch.bfloat16 else FLASH_F32_TOL
    return (bool((err <= rtol * a + FLASH_F32_TOL * m).all()),
            err.max().item())


FLASH_CASES = [
    # label, B, H, Lq, Lk, D, causal; each in float32 and bfloat16
    ("path", 16, 12, 1024, 1024, 64, True),
    ("dense", 2, 4, 512, 512, 64, False),
    ("offset", 2, 4, 256, 640, 64, True),
    ("offset-dense", 2, 4, 256, 640, 64, False),
    ("d128", 2, 4, 512, 512, 128, True),
    ("d192", 1, 2, 256, 384, 192, True),
    ("d256", 1, 2, 256, 384, 256, True),
    ("ragged", 1, 2, 200, 200, 64, True),
    ("ragged-offset", 1, 2, 100, 300, 64, True),
]


def flash_kernel_phase():
    """Each flash kernel against its plain version on the card; the
    backward's inputs are the forward kernel's O and lse (held to the
    plain ones on their own). Returns the largest abs error of each
    kernel over every case."""
    import torch

    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    errs = dict.fromkeys(names, 0.0)
    g = torch.Generator(device="cuda").manual_seed(17)
    for label, B, H, Lq, Lk, D, causal in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            if label == "path" and dtype == torch.float32:
                continue   # the path is bfloat16; the others take both
            tag = (f"{label} B*H={B * H} Lq={Lq} Lk={Lk} D={D} "
                   f"{'causal' if causal else 'full'} "
                   f"{str(dtype).split('.')[-1]}")
            q, k, v, do = (torch.randn(B, H, L, D, generator=g,
                                       device="cuda").to(dtype)
                           for L in (Lq, Lk, Lk, Lq))
            scale = 1.0 / D ** 0.5
            o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
            delta = fa.flash_delta(o, do)
            args = (q, k, v, do, lse, delta, causal, scale)
            dq = fa.flash_attention_bwd_dq(*args)
            dk, dv = fa.flash_attention_bwd_dkv(*args)
            dq2 = fa.flash_attention_bwd_dq(*args)
            dk2, dv2 = fa.flash_attention_bwd_dkv(*args)
            torch.cuda.synchronize()
            ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                        scale)
            rdq = fa.flash_attention_bwd_dq_reference(*args)
            rdk, rdv = fa.flash_attention_bwd_dkv_reference(*args)
            e = []
            for kernel, what, out, ref, grad in (
                    (names[0], "O", o, ro, False),
                    (names[0], "lse", lse, rlse, False),
                    (names[1], "dQ", dq, rdq, True),
                    (names[2], "dK", dk, rdk, True),
                    (names[2], "dV", dv, rdv, True)):
                ok, err = flash_close(out, ref, grad)
                errs[kernel] = max(errs[kernel], err)
                e.append(err)
                check(bool(torch.isfinite(out.float()).all()),
                      f"{kernel} {tag}: non-finite {what}")
                check(ok, f"{kernel} {tag}: {what} disagrees with the "
                      f"plain version (max abs err {err:.3e})")
            check(torch.equal(dk, dk2) and torch.equal(dv, dv2)
                  and torch.equal(dq, dq2),
                  f"flash backward {tag}: two runs differ")
            log(f"flash-kernel {tag}: max abs err O/lse/dQ/dK/dV "
                + " ".join(f"{x:.2e}" for x in e)
                + "; dQ/dK/dV bitwise equal across runs")
            del q, k, v, do, o, lse, dq, dk, dv, ro, rdq, rdk, rdv
    torch.cuda.empty_cache()
    return errs


# -- phase 11: flash kernels timed at the path's shape -----------------------


def flash_timing_phase(gpu):
    """Kernel, plain version and library call for each flash kernel at
    the bench_gpt shape (B = 16, H = 12, L = 1024, D = 64, bfloat16,
    causal), beside the least time the card could take: the bytes each
    must move (every input read once, every output written once) over
    3.35 TB/s against the operations the causal half needs over the
    bfloat16 tensor-core rate (989 TFLOP/s)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    B, H, L, D = 16, 12, 1024, 64
    BH, scale = B * H, 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, do = (torch.randn(B, H, L, D, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    delta = fa.flash_delta(o, do)
    args = (q, k, v, do, lse, delta, True, scale)
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    pairs = BH * L * (L + 1) // 2        # (query, key) pairs under the mask
    t = BH * L * D * 2                   # one bfloat16 (BH, L, D) tensor
    row = BH * L * 4                     # one float32 (BH, L) row vector
    rows = {
        # name: (kernel, plain, library, bytes, operations)
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, True, scale),
            lambda: fa.flash_attention_fwd_reference(q, k, v, True, scale),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            4 * t + row, 4 * D * pairs),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(*args),
            lambda: fa.flash_attention_bwd_dq_reference(*args),
            lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                        retain_graph=True),
            5 * t + 2 * row, 6 * D * pairs),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(*args),
            lambda: fa.flash_attention_bwd_dkv_reference(*args),
            lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                        retain_graph=True),
            6 * t + 2 * row, 8 * D * pairs),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, flops) in rows.items():
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 3)
        lib_ms = cuda_ms(lib, 10)
        ms2 = cuda_ms(kern, 10)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"timing {name} B*H={BH} L={L} D={D} bfloat16 causal: kernel "
            f"{ms:.4f} ms (again {ms2:.4f}), plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB at 3.35 TB/s, {flops / 1e9:.1f} GFLOP "
            f"at 989 TFLOP/s) = {bound / min(ms, ms2) * 100:.2f}% of "
            f"roofline; {flops / min(ms, ms2) / 1e9:.1f} TFLOP/s [{gpu}]")
        out[name] = dict(ms=min(ms, ms2), plain_ms=plain_ms, bound_ms=bound,
                         bound_by=bound_by, library_ms=lib_ms)
    # the port's whole backward, dQ then dK/dV, beside the library's (the
    # rows above set one gradient beside a call that computes three); its
    # bound: read q, k, v, dO, lse, delta, write dQ, dK, dV; S, dP, dQ, dK
    # and dV, two operations a multiply-add each
    bwd_lib = rows["flash_attention_bwd_dq"][2]

    def bwd():
        fa.flash_attention_bwd_dq(*args)
        fa.flash_attention_bwd_dkv(*args)
    ms, lib_ms, ms2 = cuda_ms(bwd, 10), cuda_ms(bwd_lib, 10), cuda_ms(bwd, 10)
    bound = max((7 * t + 2 * row) / HBM_BYTES_PER_S,
                10 * D * pairs / BF16_FLOP_PER_S) * 1e3
    log(f"timing flash backward (dQ + dK/dV) B*H={BH} L={L} D={D} bfloat16 "
        f"causal: kernels {ms:.4f} ms (again {ms2:.4f}), library backward "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms = "
        f"{bound / min(ms, ms2) * 100:.2f}% of roofline [{gpu}]")
    return out



def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from paddle_tpu_torch.ops import kernels
        from paddle_tpu_torch.ops.kernels import _build
        from paddle_tpu_torch.serving import PagedKVCache, TinyLM
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    check(not any(m.split(".")[0] in ("jax", "paddle_tpu")
                  for m in sys.modules), "the JAX side was imported")
    # float32 products in full float32: no TF32 anywhere on this path
    torch.backends.cudnn.allow_tf32 = False
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    gpu = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'}"
        f" in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in libs))

    errs = kernel_phase()

    rng = np.random.RandomState(0)
    prompt_lens = [int(n) for n in rng.randint(128, 2049, 16)]
    prompts = [[int(t) for t in rng.randint(0, FULL["vocab_size"], n)]
               for n in prompt_lens]
    t0 = time.perf_counter()
    model = TinyLM(**FULL, seed=0)
    cache = PagedKVCache(**POOL, num_heads=FULL["num_heads"],
                         head_dim=FULL["head_dim"])
    log(f"engine: TinyLM {FULL} + pool {POOL} float32 ready in "
        f"{time.perf_counter() - t0:.1f} s; prompt lengths {prompt_lens}")
    _, _, launches = serve(model, cache, 8192, prompts, 32, "engine")

    # 63 usable pages of 16: three 320-token prompts (20 pages each, 21
    # with the admission headroom) fill the pool to 3 free pages, and
    # their growth past 336 tokens must preempt
    small = PagedKVCache(64, 16, FULL["num_heads"], FULL["head_dim"])
    prng = np.random.RandomState(1)
    pprompts = [[int(t) for t in prng.randint(0, FULL["vocab_size"], 320)]
                for _ in range(4)]
    eng, _, _ = serve(model, small, 2048, pprompts, 48, "preempt")
    check(eng.scheduler.preemptions > 0, "preempt: no preemption happened")

    t = timing_phase(cache, prompt_lens, FULL["vocab_size"], gpu)
    # the worst disagreement of any comparison this run made
    t["max_abs_err"] = max([t["max_abs_err"], *errs.values()])
    del eng, model, cache, small
    torch.cuda.empty_cache()

    train_errs = train_kernel_phase()
    launches_f32 = train_phase(gpu)
    train_t = train_timing_phase(gpu, 8192, torch.float32)
    # the same kernels at bench_gpt's shape, logged for PERF.md; the JSON
    # line keeps the float32 step's
    train_timing_phase(gpu, 16384, torch.bfloat16)
    train_errs.update(flash_kernel_phase())
    launches_bf16 = train_bf16_phase(gpu)
    train_t.update(flash_timing_phase(gpu))

    pa = kernels.KERNELS["paged_decode_attention"]
    rows = [{"name": "paged_decode_attention", "route": "cuda",
             "source": pa.SOURCE,
             "replaces": pa.paged_decode_attention.replaces,
             "launches": launches["paged_decode_attention"], **t}]
    for name, tt in train_t.items():
        # the run that took this kernel: bf16 for flash, float32 for the
        # others (the bf16 run takes them too, for the same counts a step)
        ran = launches_bf16 if name.startswith("flash") else launches_f32
        rows.append({"name": name, "route": "cuda",
                     "source": kernels.KERNELS[name].SOURCE,
                     "replaces": getattr(kernels.KERNELS[name],
                                         name).replaces,
                     "launches": ran[name],
                     "max_abs_err": train_errs[name], **tt})
    log(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
