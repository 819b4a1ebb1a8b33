#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving path, its training steps (GPT, BERT,
ResNet-50), its serving fleet, the step as one CUDA graph, its decoding
and its checkpointed and guarded training once on one NVIDIA H100.

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
             D=8); zero-length lanes exactly 0; two calls the same bits;
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
             global-norm clip 1.0 through ``TrainStep``, 4 steps (the
             first op by op, the second captured as one CUDA graph and
             replayed, then replays; launches counted over them); every
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
             rotated over four times the L2), and the scalar kernels,
             which the vector kernels took over at D = 768 (reached with
             an x off 16-byte alignment, held to the plain versions);
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
             beside the bound at the bfloat16 tensor-core rate; and the
             forward at bench_bert's eval shape (B*H = 768, L = 128, not
             causal) against its plain version and SDPA;
12. train-bert — bench_bert's configuration (``bench.py:bench_bert``):
             ``bert_base`` at full width and depth (12 x 768, 12 heads,
             FFN 3072, vocab 30522), dropout 0.1, ``model.bfloat16()``,
             batch 64 x 128 from RandomState(0) (token types 0, mask
             ones, MLM labels at 15%, NSP labels), AdamW(1e-4,
             multi_precision) with global-norm clip 1.0, through
             ``TrainStep`` for 4 steps; every loss finite, the first near
             ln(30522) + ln(2), launches exactly 26/26/0/0/0/0/0 a step;
             the same steps through the plain versions within
             BF16_TRAIN_LOSS_TOL; then one backward whose every
             LayerNorm backward launch is held to its plain version on
             the same inputs (dgamma/dbeta within TRAIN_F32_TOL of
             their terms' magnitudes); then one eval forward without a
             mask (12 non-causal flash forwards, 26 LayerNorm forwards), its
             MLM logits within BERT_LOGIT_STEPS of the largest |logit|
             of the plain versions'; and the LayerNorm kernels timed at
             its (8192, 768) bfloat16 as in phase 8.

13. fleet  — the serving fleet (``paddle_tpu_torch.serving.fleet``) at
             gpt_small's serving width (``FLEET_LOCAL``/``FLEET_DRILL``):
             the engine phase's 16 requests through a ``Router`` over two
             local replicas (tenants of weight 1 and 2), tokens equal to
             the dense oracle, one paged launch for every decode step of
             every replica, each pool balanced, the scraped tenant gauges
             bitwise equal to the router's rollup; then the kill drill
             (``serving.fleet.drill``) with two worker processes on the
             card, replica 1 killed mid-decode and relaunched: every drill
             check, every incarnation's journal naming this card, and the
             survivor's decode steps each one paged launch. It prints the
             router step p50, the scraped TTFT/TPOT p50/p99 and the time
             from the kill's detection to the relaunched replica's ready.

14. train-graph — the step as one CUDA graph (``TrainStep``), against
             its op-by-op ``_eager_step``: bench_gpt and bench_bert, 4
             graphed steps and 4 eager ones from the same weights and
             dropout seed, the same bits in losses, parameters, masters
             and moments, then 5 more steps of each timed and one
             profiled (``torch.profiler`` must name each kernel in a
             replay as often as the wrappers count for a step; the
             device-busy share); bench_gpt under LinearWarmup into
             CosineAnnealingDecay for 6 steps, graphed = eager bitwise;
             bench_bert with a dynamic loss scaler and its third step
             poisoned (that step keeps every value's bits and halves the
             scale, two clean steps double it, the eager run agrees);
             ``run_fused`` with K = 4 against 8 graphed calls; one graphed
             step of bench_gpt's model under Momentum with
             multi_precision against the eager step, bitwise.

15. decode — bench_wmt_beam (``bench.py:213-243``): ``WMTTransformer``
             at Transformer-base width (6 + 6 layers x 512, vocab 32000),
             bfloat16, eval, 16 x 32 source ids from RandomState(0), beam
             4, max_len 32: ``beam_search_decode_xla`` as one CUDA graph
             equal bitwise to the same decode op by op; the plain
             versions' decode and the growing-cache
             ``beam_search_decode``, each made to take its decisions,
             give the same tokens, their values and scores within
             WMT_VALUE_TOL, and would take the same decisions wherever
             their margins exceed WMT_MARGIN (``Decisions``);
             ``greedy_decode``;
             exactly 12 + 18 a step LayerNorm launches; then
             ``gpt_small`` (bfloat16, eval, 8 prompts of 128, 32 greedy
             tokens): ``generate`` with exactly 12 non-causal flash
             forwards (its prefill) and 32 x 25 LayerNorm forwards,
             held to a teacher-forced plain-version run of the same
             path; ``generate_xla`` graphed = op by op bitwise, held to
             a causal forward's argmax (``greedy_agree``); latency,
             sentences/s and tokens/s of each, graphed and op by op;
             and the flash and LayerNorm forwards timed at the decode
             shapes.

16. train-resnet — bench_resnet50 (``bench.py:158-185``): ``resnet50()``
             cast with ``bfloat16()``, batch 128 x 3 x 224 x 224 from
             RandomState(0), Momentum(0.1, 0.9, multi_precision), nothing
             cut. The first forward against a float32 forward of the
             same weights written with ``torch.nn.functional``
             (``resnet_reference_forward``; logits, loss, and each conv
             against a float32 conv of its own input:
             ``resnet_value_check``); two op-by-op steps from one state
             the same bits (loss, gradients, buffers, velocities,
             masters); the stem BatchNorm's running statistics after
             step 1 against Paddle's update of a separate float32
             ``var_mean`` (``stem_bn_check``); 4 graphed steps = 4
             op-by-op steps bitwise, buffers included; no launch of the
             port's kernels (counts and profiler); the first loss near
             ln 1000; the replay's wall and imgs/s, the op-by-op step,
             peak memory and a profiled replay's busy share.

17. checkpoint — bench_gpt's graphed step (as phase 14, each batch
             times a float32 1.0, batches from RandomState(0)) saved,
             killed and resumed (``framework.io``): 8 steps from seed 0
             with a sync ``save_checkpoint`` after step 4, verified; that
             checkpoint loaded back into the same model and optimizer,
             steps 5-8 replayed with no new capture, the same losses and
             state bitwise; the run again with ``async_=True`` after step
             4 (steps 5-6 while the writer writes) and again after
             step 6, bitwise; both
             checkpoints resumed in a fresh Python process from a model
             of another seed, steps 5-8 and the final state bitwise;
             ``GuardedStep(TrainStep(check_nan=True))`` under
             ``skip_step`` and under ``rollback`` (``snapshot_every=1``)
             with ``nan_feed`` at call 3 bitwise 7 steps that never saw
             batch 3 (losses, state, step count), one graph captured;
             the truncate, bit-flip, crash and per-array drills at 2
             layers of gpt_small's width. It logs the bytes on disk,
             the sync save, the async snapshot, the loads, the verify,
             the replays with and without the writer, and the guarded
             replays against plain ones.

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
# logits of std ~0.55 at init: loss ~ ln V + 0.15 (BERT: ln V + ln 2)
LOSS_NEAR_LN_V = 0.5
# flash kernels against their plain versions (flash_close): float32 sums
# in another order; in bfloat16 also one rounding step of the output
FLASH_F32_TOL = 1e-5
FLASH_BF16_STEP = 2 ** -7      # a bfloat16 keeps 8 significant bits
# losses of the bf16 kernel run vs its plain-version run, absolute on each
# of the 4 steps. Seen on an H100 80GB HBM3 (700 W): bench_gpt 6.1e-5,
# 4.0e-5, 7.9e-4, 2.8e-4 (bfloat16 roundings that flip between the two
# runs); bench_bert 2.6e-4, 6.7e-3, 2.7e-4, 2.3e-3 (its first AdamW step
# lifts the loss from 11.2 to 13.4, in the JAX package too, and the
# roundings' effect with it). tools/torch_planted_faults.py plants dV = 0
# in the flash dK/dV kernel (bench_gpt: 0, 7.2e-2, 3.6e-1, 5.3e-1) and
# dx = 0 in the LayerNorm backward (bench_bert: 2.6e-4, 2.2, 2.5, 0.29):
# both fail
BF16_TRAIN_LOSS_TOL = 1e-2
# a timed run's launches are queued while the card spins this many cycles
# (~20 ms at the H100's 1.98 GHz), longer than the host takes to issue them
QUEUE_CYCLES = 40_000_000
# LayerNorm's cold timing rotates over at least this many bytes of inputs
# and outputs: four times the H100's 50 MB L2
COLD_BYTES = 200 * 10 ** 6
# the training configurations of the main paths, driven by phases 7, 10,
# 12 and 16 and profiled by tools/torch_train_profile.py: gpt_small,
# bert_base or resnet50 at full width and depth, a batch from
# RandomState(0) (gpt_small: batch x 1024 ids; bert_base: batch x BERT_SEQ
# as bench.py:143-148 builds it; resnet50: batch x 3 x 224 x 224 images
# and labels of 1000 classes as bench.py:172-174 builds them), AdamW(1e-4,
# decay 0.01) with global-norm clip 1.0 (resnet50: Momentum(0.1, 0.9))
# (train_model, train_optimizer, train_batch)
TRAIN_CONFIGS = {
    # name: model, dropout, model.bfloat16(), batch, AdamW's multi_precision
    "dropout0.1-float32": dict(model="gpt_small", dropout=0.1,
                               bfloat16=False, batch=8,
                               multi_precision=False),
    "bench_gpt": dict(model="gpt_small", dropout=0.0, bfloat16=True,
                      batch=16, multi_precision=True),
    "bench_bert": dict(model="bert_base", dropout=0.1, bfloat16=True,
                       batch=64, multi_precision=True),
    # bench.py:158-185: Momentum(0.1, 0.9) instead of AdamW, no clip
    "bench_resnet50": dict(model="resnet50", dropout=0.0, bfloat16=True,
                           batch=128, multi_precision=True),
}
BERT_SEQ = 128          # bench.py:bench_bert's L
# bfloat16 MLM logits of the kernels against the plain versions (12 layers
# of bfloat16 activations), as a share of the largest |logit|: two
# bfloat16 steps there. Seen on an H100 80GB HBM3 (700 W): 2.3e-2 at a
# largest |logit| of 2.48, 0.6 of the limit
BERT_LOGIT_STEPS = 2 ** -6
RESNET_IMAGE = 224       # bench.py:bench_resnet50's size
RESNET_CLASSES = 1000
# phase 16's limits, from readings on an H100 80GB HBM3 (700 W): the first
# step's bfloat16 logits against a float32 forward of the same weights
# (resnet_reference_forward), as a share of its largest |logit| (seen
# 0.129: 53 convs and BatchNorms of bfloat16 activations), and the losses'
# difference (seen 0.0129); the first loss's distance from ln 1000 (seen
# 0.86: loss 7.770 at this init)
RESNET_LOGIT_TOL = 2 ** -2
RESNET_LOSS_TOL = 5e-2
RESNET_LOSS_NEAR = 1.5
# each conv's bfloat16 output against a float32 conv of the same bfloat16
# input and weight, as a share of its largest |value|: one bfloat16
# rounding is at most 2^-8 of it
RESNET_CONV_TOL = 2 ** -6


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
    ``QUEUE_CYCLES`` or more, so that the events time the launches on
    the card and not how fast the host issues them (a wrapper can take
    longer to issue a launch than a small kernel takes to run). The spin
    grows until it outlasts the host's issuing of the calls."""
    import torch

    for _ in range(warmup):
        fn()
    cycles = QUEUE_CYCLES
    while True:
        spin, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        torch.cuda.synchronize()
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        end.record()
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        # the card still spun when the host had issued every launch, so
        # the events timed the card; else spin longer (a slow host)
        if (spin.elapsed_time(start) > issue_ms
                or cycles >= 64 * QUEUE_CYCLES):
            return start.elapsed_time(end) / iters
        cycles *= 4


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
            again = pa.paged_decode_attention(*args)
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
            check(torch.equal(out, again), f"{name} {dtype}: two calls "
                  f"give different bits")
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


# -- phase 13: the serving fleet ----------------------------------------------

# the fleet's replicas: gpt_small's serving width, one layer, float32
# pools of 16-token pages. Local mode: the engine phase's 16 requests over
# two replicas, 1600 pages each (~8 prompts of <= 2080 tokens a replica);
# the drill: six prompts of 128-512 tokens, 32 new tokens each, 400 pages
FLEET_LOCAL = dict(FULL, seed=0, pages=1600, page_size=16, max_seq_len=4096,
                   token_budget=8192, warm=False)
FLEET_DRILL = dict(FULL, seed=0, pages=400, page_size=16, max_seq_len=1024,
                   token_budget=4096, max_batch=4)


def fleet_local(prompts, max_new, gpu):
    """Two local replicas behind one Router, tenants t1 (weight 1) and t2
    (weight 2), the launch counts zeroed just before the router drives
    the requests and read just after. Every request must finish with the
    dense oracle's tokens, each decode step of each replica must launch
    the paged kernel once, each pool must balance and the scraped tenant
    gauges must equal the router's rollup bitwise. Returns the launch
    counts."""
    import torch

    from paddle_tpu_torch.obs import export, usage
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import fleet

    t0 = time.perf_counter()
    pool = fleet.ReplicaPool(fleet.ReplicaSpec(**FLEET_LOCAL), replicas=2,
                             mode="local")
    router = fleet.Router(pool, tenants={
        "t1": fleet.TenantPolicy(weight=1.0),
        "t2": fleet.TenantPolicy(weight=2.0)})
    engines = pool.local_engines()
    log(f"fleet local: 2 replicas of {FLEET_LOCAL} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = [router.submit(p, max_new_tokens=max_new, rid=f"f{i:02d}",
                          tenant=("t1", "t2")[i % 2])
            for i, p in enumerate(prompts)]
    step_ms = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    while router.inflight or router.queue_depth:
        s0 = time.perf_counter()
        router.step()
        step_ms.append((time.perf_counter() - s0) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    decode_steps = [e.usage.decode_steps for e in engines]
    log(f"fleet local: {len(reqs)} requests in {wall * 1e3:.1f} ms, "
        f"{len(step_ms)} router steps, decode steps {decode_steps}, "
        f"launches {launches}")
    check(all(r.state == "FINISHED" for r in reqs),
          "fleet local: not every request finished")
    check(launches["paged_decode_attention"] == sum(decode_steps) > 0
          and all(decode_steps),
          f"fleet local: {launches['paged_decode_attention']} paged "
          f"launches for decode steps {decode_steps}")
    oracle = engines[0].model
    for r, p in zip(reqs, prompts):
        ref = oracle.reference_generate(p, max_new)
        check(r.tokens == ref, f"fleet local: {r.rid} on replica "
              f"{r.replica_id}: tokens differ from the dense oracle's")
    for e in engines:
        check(e.cache.verify() and e.cache.stats()["used_pages"] == 0,
              f"fleet local: replica {e.replica_id}'s pool does not "
              f"balance: {e.cache.stats()}")
        check(e.usage.verify(), f"fleet local: replica {e.replica_id}'s "
              "usage does not telescope")
    # the chargeback gauges, scraped from a live exporter over HTTP, equal
    # the router's rollup bitwise
    exporter = export.MetricsExporter(engines=engines, router=router,
                                      port=0)
    port = exporter.start()
    try:
        scraped = export.parse_prometheus_text(
            export.scrape(f"http://127.0.0.1:{port}/metrics"))
    finally:
        exporter.stop()
    truth = usage.router_tenant_usage(router)
    check(set(truth["tenants"]) == {"t1", "t2"} and truth["served_total"],
          f"fleet local: tenant rollup {truth['tenants']}")
    for tenant, d in truth["tenants"].items():
        for key in ("weight_share", "served_tokens", "share", "requests",
                    "completed", "requeued", "preemptions",
                    "prompt_tokens", "decode_tokens"):
            skey = f'paddle_tpu_tenant_{key}{{tenant="{tenant}"}}'
            check(scraped.get(skey) == float(d.get(key, 0)),
                  f"fleet local: {skey} scraped {scraped.get(skey)} != "
                  f"router truth {d.get(key, 0)}")

    def q(name, p):
        return scraped[f'paddle_tpu_fleet_router_{name}{{q="{p}"}}']
    srt = sorted(step_ms)
    log(f"fleet local: router step p50 {srt[len(srt) // 2]:.3f} ms; TTFT "
        f"p50 {q('ttft_ms', 'p50'):.3f} ms p99 {q('ttft_ms', 'p99'):.3f} "
        f"ms; TPOT p50 {q('tpot_ms', 'p50'):.3f} ms p99 "
        f"{q('tpot_ms', 'p99'):.3f} ms (exporter scrape); tokens equal the "
        f"dense oracle, pools balanced, chargeback gauges bitwise [{gpu}]")
    router.close()
    return launches


def fleet_drill(gpu):
    """The kill drill on the card: two worker processes at FLEET_DRILL,
    replica 1 killed by ``replica_kill`` mid-decode and relaunched. Every
    drill assertion must hold, every incarnation's journal must name this
    card, and the survivor's decode steps after its ready line must each
    have launched the paged kernel once."""
    import torch

    from paddle_tpu_torch.serving.fleet import drill

    rng = np.random.RandomState(1)
    trace = [([int(t) for t in rng.randint(0, FULL["vocab_size"], n)], 32)
             for n in rng.randint(128, 513, drill.N_REQUESTS)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = drill.run_drill(geometry=FLEET_DRILL, trace=trace)
    wall = time.perf_counter() - t0
    check(res["failures"] == [], f"fleet drill: {res['failures']}")
    name = torch.cuda.get_device_name(0)
    for rank in (0, drill.VICTIM):
        evs = res["backends"].get(rank) or []
        check(evs and all(e.get("platform") == "gpu"
                          and e.get("device_kind") == name for e in evs),
              f"fleet drill: rank {rank}'s backend events {evs}")
    check(len(res["backends"][drill.VICTIM]) == 2,
          "fleet drill: the victim's two incarnations did not both "
          "journal the card")
    (survivor,) = res["kernel_launches"][0]
    served = (survivor["stop"]["paged_decode_attention"]
              - survivor["ready"]["paged_decode_attention"])
    check(served == survivor["decode_steps"] > 0,
          f"fleet drill: survivor launched the paged kernel {served} "
          f"times for {survivor['decode_steps']} decode steps")
    for ev in res["kernel_launches"].get(drill.VICTIM) or []:
        check(ev["stop"]["paged_decode_attention"]
              - ev["ready"]["paged_decode_attention"]
              == ev["decode_steps"],
              f"fleet drill: relaunched replica's launches {ev}")
    log(f"fleet drill: {len(trace)} requests, requeued "
        f"{res['requeued_rids']}, {res['incarnations']} incarnations of "
        f"replica {drill.VICTIM}; survivor {survivor['decode_steps']} "
        f"decode steps, {served} paged launches after ready; kill "
        f"detected to relaunched replica ready "
        f"{res['relaunch_ready_s']:.3f} s; drill wall {wall:.1f} s; "
        f"every drill check holds and every incarnation journaled "
        f"{name} [{gpu}]")
    return res


def fleet_phase(prompts, gpu):
    launches = fleet_local(prompts, 32, gpu)
    fleet_drill(gpu)
    return launches


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


# -- phases 7, 10 and 12: the training main paths ---------------------------


def train_launches(config, cfg, steps):
    """The launches ``steps`` training steps of ``config`` must make. GPT:
    two LayerNorms a block and ln_f, one cross-entropy; BERT: the
    embeddings' LayerNorm, two a layer and the MLM head's, and no
    cross-entropy kernel (vocab 30522 is not a multiple of 128, and the
    NSP loss has 2 classes); each forward and backward. Flash attention
    once a layer where it fires: in bench_gpt (dropout 0, no mask), not
    at dropout 0.1 nor with BERT's mask."""
    if TRAIN_CONFIGS[config]["model"] == "bert_base":
        ln, ce = (2 * cfg.layers + 2) * steps, 0
    else:
        ln, ce = (2 * cfg.layers + 1) * steps, steps
    fl = cfg.layers * steps if config == "bench_gpt" else 0
    return {"paged_decode_attention": 0, "layer_norm_fwd": ln,
            "layer_norm_bwd": ln, "softmax_ce_fwd": ce,
            "softmax_ce_bwd": ce, "flash_attention_fwd": fl,
            "flash_attention_bwd_dq": fl, "flash_attention_bwd_dkv": fl}


def train_model(config, seed=0):
    """``TRAIN_CONFIGS[config]``'s model on the card, weights from
    ``seed``: ``gpt_small``, ``BertForPretraining(bert_base())`` or
    ``resnet50()``."""
    import torch

    from paddle_tpu_torch.models.nlp import bert, gpt

    c = TRAIN_CONFIGS[config]
    g = torch.Generator(device="cuda").manual_seed(seed)
    if c["model"] == "resnet50":
        from paddle_tpu_torch.models.vision import resnet50

        model = resnet50(generator=g)
    elif c["model"] == "bert_base":
        model = bert.BertForPretraining(bert.bert_base(dropout=c["dropout"]),
                                        generator=g)
    else:
        model = gpt.GPT(gpt.gpt_small(dropout=c["dropout"]), generator=g)
    return model.bfloat16() if c["bfloat16"] else model


def train_optimizer(model, config):
    """AdamW(1e-4, decay 0.01, global-norm clip 1.0) over ``model``, with
    ``TRAIN_CONFIGS[config]``'s multi_precision; for resnet50
    bench_resnet50's ``Momentum(0.1, 0.9, multi_precision=True)``."""
    from paddle_tpu_torch import optim

    if TRAIN_CONFIGS[config]["model"] == "resnet50":
        return optim.Momentum(0.1, 0.9, parameters=model.named_parameters(),
                              multi_precision=True)
    return optim.AdamW(
        parameters=model.named_parameters(), learning_rate=1e-4,
        weight_decay=0.01, grad_clip=optim.ClipGradByGlobalNorm(1.0),
        multi_precision=TRAIN_CONFIGS[config]["multi_precision"])


def train_batch(model, config):
    """``(loss_fn, batch, first loss expected)`` for ``config``, the batch
    numpy arrays from RandomState(0). GPT: batch x 1024 ids and the ids
    shifted; its first loss near ln V. BERT as ``bench.py:143-148``
    builds it: batch x 128 ids, token types 0, ``attention_mask`` ones,
    MLM labels at 15% (-100 elsewhere), NSP labels; its first loss near
    ln V + ln 2 (MLM plus NSP). ResNet-50 as ``bench.py:172-174`` builds
    it: batch x 3 x 224 x 224 float32 images, then int32 labels of 1000
    classes; its first loss near ln 1000."""
    import math

    from paddle_tpu_torch.models.nlp import bert, gpt

    c = TRAIN_CONFIGS[config]
    rng = np.random.RandomState(0)
    if c["model"] == "resnet50":
        x = rng.randn(c["batch"], 3, RESNET_IMAGE, RESNET_IMAGE).astype(
            np.float32)
        y = rng.randint(0, RESNET_CLASSES, (c["batch"],)).astype("int32")
        return resnet_loss, (x, y), math.log(RESNET_CLASSES)
    cfg = model.cfg
    if c["model"] == "bert_base":
        B, L = c["batch"], BERT_SEQ
        ids = rng.randint(0, cfg.vocab_size, (B, L)).astype("int32")
        tt = np.zeros((B, L), "int32")
        am = np.ones((B, L), "int32")
        mlm = np.where(rng.rand(B, L) < 0.15, ids, -100).astype("int32")
        nsp = rng.randint(0, 2, (B,)).astype("int32")
        return (bert.bert_pretrain_loss, (ids, tt, am, mlm, nsp),
                math.log(cfg.vocab_size) + math.log(2))
    ids = rng.randint(0, cfg.vocab_size, (c["batch"], cfg.max_seq))
    return (gpt.gpt_loss, (ids, np.roll(ids, -1, axis=1)),
            math.log(cfg.vocab_size))


def train_run(model, config, init, loss_fn, batch, steps, plain):
    """``steps`` TrainStep calls from the weights ``init`` with the
    dropout generator reseeded and ``config``'s optimizer, launch counts
    zeroed just before and read just after. Returns (losses, launches,
    step walls in ms)."""
    import contextlib

    import torch

    from paddle_tpu_torch import core
    from paddle_tpu_torch.framework import TrainStep
    from paddle_tpu_torch.ops import kernels

    model.load_state_dict(init)
    core.seed(1)
    step = TrainStep(model, train_optimizer(model, config), loss_fn)
    losses, walls = [], []
    with kernels.plain_versions() if plain else contextlib.nullcontext():
        torch.cuda.synchronize()
        kernels.reset_launches()
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step(*batch)))   # syncs on the loss
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = kernels.launches()
    return losses, launches, walls


def train_compare(label, config, steps, loss_tol, gpu, after=None):
    """The training main path: ``steps`` steps of ``TRAIN_CONFIGS[config]``
    on its batch from RandomState(0) through the kernels, then the same
    steps from the same weights through the plain versions. Checks
    finite losses, the first near its expected value, the launch counts
    (exactly ``train_launches``; none in the plain run) and the per-step
    loss differences against ``loss_tol``. ``after(model, init, batch)``,
    if given, runs before the model is freed. Returns the kernel run's
    launches."""
    import math

    import torch

    model = train_model(config)
    c, cfg = TRAIN_CONFIGS[config], model.cfg
    init = {k: v.clone() for k, v in model.state_dict().items()}
    loss_fn, batch, first = train_batch(model, config)
    B, L = batch[0].shape
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{label}: {c['model']} {n_params / 1e6:.1f}M parameters "
        f"({cfg.layers} x {cfg.hidden}, vocab {cfg.vocab_size}), {config}: "
        f"dropout {c['dropout']}, "
        f"{'bfloat16' if c['bfloat16'] else 'float32'}, multi_precision "
        f"{c['multi_precision']}, batch {B} x {L}")
    torch.cuda.reset_peak_memory_stats()
    losses, launches, walls = train_run(model, config, init, loss_fn, batch,
                                        steps, False)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = train_launches(config, cfg, steps)
    # step 1 runs op by op, step 2 is captured and replayed, then replays
    steady = sorted(walls[2:])[len(walls[2:]) // 2]
    log(f"{label}: kernel run losses {losses}; step wall ms "
        + " ".join(f"{w:.1f}" for w in walls)
        + f" (median of the replays, steps 3-{steps}: {steady:.1f} ms = "
        f"{B * L / steady * 1e3:.0f} tokens/s); peak memory {peak:.2f} GiB;"
        f" launches {launches} [{gpu}]")
    check(all(math.isfinite(x) for x in losses),
          f"{label}: non-finite loss")
    check(abs(losses[0] - first) < LOSS_NEAR_LN_V,
          f"{label}: first loss {losses[0]} is not within {LOSS_NEAR_LN_V} "
          f"of {first:.4f}")
    check(launches == want, f"{label}: launches {launches}, want {want}")
    plain, plain_launches, plain_walls = train_run(
        model, config, init, loss_fn, batch, steps, True)
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
    if after is not None:
        after(model, init, batch)
    del model, init
    torch.cuda.empty_cache()
    return launches


def train_phase(gpu):
    """Phase 7: gpt_small at its defaults (dropout 0.1, float32), batch
    8: dense attention, the LayerNorm and cross-entropy kernels."""
    return train_compare("train", "dropout0.1-float32", 4, TRAIN_LOSS_TOL,
                         gpu)


def train_bf16_phase(gpu):
    """Phase 10: bench_gpt's configuration (``bench.py:187-210``):
    dropout 0, ``model.bfloat16()``, batch 16, multi_precision AdamW —
    flash attention in every block."""
    return train_compare("train-bf16", "bench_gpt", 4, BF16_TRAIN_LOSS_TOL,
                         gpu)


def bert_eval_forward(model, init, batch):
    """One ``model.eval()`` forward of ``init`` at dropout 0 without an
    attention mask (BERT inference): every attention takes the
    non-causal flash forward. Launches exactly 12 flash forwards and 26
    LayerNorm forwards; its MLM logits must be within
    ``BERT_LOGIT_STEPS`` of the largest |logit| of the plain versions'
    (zero launches). Returns the largest difference."""
    import torch

    from paddle_tpu_torch.ops import kernels

    cfg = model.cfg
    model.load_state_dict(init)
    model.eval()
    ids, tt = (torch.from_numpy(a).cuda() for a in batch[:2])
    with torch.no_grad():
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = model(ids, tt)[0].float()
        torch.cuda.synchronize()
        launches = kernels.launches()
        kernels.reset_launches()
        with kernels.plain_versions():
            want = model(ids, tt)[0].float()
            plain_launches = kernels.launches()
    model.train()
    err = (got - want).abs().max().item()
    tol = BERT_LOGIT_STEPS * want.abs().max().item()
    log(f"train-bert eval: forward without a mask at dropout 0, MLM logits "
        f"{tuple(got.shape)}: max abs diff from the plain versions {err:.3e}"
        f" (tol {tol:.3e}); launches {launches}")
    want_launches = dict.fromkeys(launches, 0)
    want_launches.update(layer_norm_fwd=2 * cfg.layers + 2,
                         flash_attention_fwd=cfg.layers)
    check(launches == want_launches,
          f"train-bert eval: launches {launches}, want {want_launches}")
    check(plain_launches == dict.fromkeys(launches, 0),
          f"train-bert eval: the plain versions launched {plain_launches}")
    check(bool(torch.isfinite(got).all()), "train-bert eval: non-finite")
    check(err <= tol, "train-bert eval: the kernels' logits differ from "
          "the plain versions'")
    return err


def ln_grad_check(model, init, batch):
    """One forward and backward of bench_bert's loss from the weights
    ``init``, every LayerNorm backward launch held to its plain version
    on the same inputs: dx within BF16_TOL, dgamma and dbeta within
    TRAIN_F32_TOL of the sum of their terms' magnitudes (both versions
    sum the same float32 products in another order; a dgamma dropped to
    0 is off by about 1/sqrt(rows) of that sum, 1.1e-2 at 8192 rows,
    where 4 bfloat16 steps' losses cannot show it). Returns the largest
    error of each."""
    import torch

    from paddle_tpu_torch import core
    from paddle_tpu_torch.models.nlp import bert
    from paddle_tpu_torch.ops.kernels import layernorm as ln

    model.load_state_dict(init)
    core.seed(1)
    launched = ln.layer_norm_bwd
    errs = dict.fromkeys(("dx", "dgamma", "dbeta"), 0.0)
    calls = []

    def checked(x, gamma, mean, rstd, dy):
        dx, dg, db = launched(x, gamma, mean, rstd, dy)
        want = ln.layer_norm_bwd_reference(x, gamma, mean, rstd, dy)
        xhat = (x.float() - mean) * rstd
        for name, got, ref, res in (
                ("dx", dx, want[0], within(dx, want[0], BF16_TOL)),
                ("dgamma", dg, want[1], within(
                    dg, want[1], TRAIN_F32_TOL,
                    (dy.float() * xhat).abs().sum(0))),
                ("dbeta", db, want[2], within(
                    db, want[2], TRAIN_F32_TOL, dy.float().abs().sum(0)))):
            ok, err = res
            check(ok, f"train-bert: layer_norm_bwd call {len(calls)}: "
                  f"{name} differs from the plain version's by {err:.3e}")
            errs[name] = max(errs[name], err)
        calls.append(tuple(x.shape))
        return dx, dg, db

    # the kernel wrapper counts its launch on the module's name
    checked.launches = 0
    ln.layer_norm_bwd = checked
    try:
        loss = bert.bert_pretrain_loss(model, *(
            torch.from_numpy(np.require(a, requirements="C")).cuda()
            for a in batch))
        loss.backward()
        torch.cuda.synchronize()
    finally:
        ln.layer_norm_bwd = launched
    model.zero_grad(set_to_none=True)
    want = 2 * model.cfg.layers + 2
    check(len(calls) == want, f"train-bert: {len(calls)} LayerNorm "
          f"backward launches in one step, want {want}")
    log(f"train-bert: one backward's {len(calls)} LayerNorm backward "
        f"launches each held to the plain version on its inputs {calls[0]}:"
        f" max abs err dx {errs['dx']:.3e} (tol {BF16_TOL}), dgamma "
        f"{errs['dgamma']:.3e}, dbeta {errs['dbeta']:.3e} (tol "
        f"{TRAIN_F32_TOL} of their terms' magnitudes)")
    return errs


def bert_checks(model, init, batch):
    """After bench_bert's runs: ``ln_grad_check``, then
    ``bert_eval_forward``."""
    ln_grad_check(model, init, batch)
    return bert_eval_forward(model, init, batch)


def train_bert_phase(gpu):
    """Phase 12: bench_bert's configuration (``bench.py:129-155``):
    ``bert_base`` at full width and depth, dropout 0.1,
    ``model.bfloat16()``, batch 64 x 128, multi_precision AdamW, 4 steps
    through the kernels and 4 through the plain versions; then one
    backward with every LayerNorm backward held to its plain version
    (``ln_grad_check``) and the mask-free eval forward
    (``bert_eval_forward``)."""
    return train_compare("train-bert", "bench_bert", 4, BF16_TRAIN_LOSS_TOL,
                         gpu, after=bert_checks)


# -- phase 14: the step as one CUDA graph ------------------------------------

# the kernels' names as torch.profiler reports them, one kernel a launch
# of each wrapper (the LayerNorm backward's reduce apart): a replay must
# name each as many times as the wrapper counts
PROFILED = {"paged_decode_attention": r"\bpaged_decode_chunk_kernel\b",
            "layer_norm_fwd": r"\bln_fwd_(vec_)?kernel\b",
            "layer_norm_bwd": r"\bln_bwd_(vec_)?kernel\b",
            "softmax_ce_fwd": r"\bce_fwd_kernel\b",
            "softmax_ce_bwd": r"\bce_bwd_kernel\b",
            "flash_attention_fwd": r"\bflash_fwd_(tc_)?kernel\b",
            "flash_attention_bwd_dq": r"\bflash_bwd_dq_(tc_)?kernel\b",
            "flash_attention_bwd_dkv": r"\bflash_bwd_dkv_(tc_)?kernel\b"}


def profiled(fn, settle=0.2):
    """One call of ``fn`` under ``torch.profiler``: ``(host wall ms,
    device busy ms, {wrapper name: kernels of it the profiler saw})``,
    the port's launch counts set to 0 just before that call. The call
    starts ``settle`` seconds after the profiler does, and the profiler
    stops ``settle`` seconds after the call: with no pause, the profiler
    now and then missed the first kernels of a step (1 to 5 of bench_gpt's
    first LayerNorm and flash forwards), as if it placed them before its
    window's start (``tools/torch_profiler_misses.py`` counts both)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(settle)
        kernels.reset_launches()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(settle)
    busy, seen = 0.0, dict.fromkeys(PROFILED, 0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        busy += e.self_device_time_total / 1e3
        for name, pattern in PROFILED.items():
            if re.search(pattern, e.key):
                seen[name] += e.count
    return wall, busy, seen


def snapshot(model, opt):
    """Copies of every parameter and buffer (a BatchNorm's running
    statistics) and of every optimizer state value."""
    return ({n: t.detach().clone() for n, t in itertools.chain(
                model.named_parameters(), model.named_buffers())},
            {n: {k: v.clone() for k, v in s.items()}
             for n, s in opt._accumulators.items()})


def same_bits(a, b):
    """The names in snapshot ``a`` whose tensor differs from ``b``'s."""
    (pa, sa), (pb, sb) = a, b
    bad = [n for n in pa if not torch_equal(pa[n], pb[n])]
    bad += [f"{n}.{k}" for n in sa for k in sa[n]
            if not torch_equal(sa[n][k], sb[n][k])]
    return bad


def torch_equal(a, b):
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def graph_run(model, config, init, loss_fn, batches, eager, make_opt=None,
              scaler=None, each=None):
    """``len(batches)`` steps of ``config`` from the weights ``init``, the
    dropout generator reseeded, through the graphed ``TrainStep`` or its
    ``_eager_step``; ``each(i, step)`` after each. Returns ``(step,
    losses, walls ms, launches)``."""
    import torch

    from paddle_tpu_torch import core
    from paddle_tpu_torch.framework import TrainStep
    from paddle_tpu_torch.ops import kernels

    model.load_state_dict(init)
    core.seed(1)
    opt = (make_opt or (lambda m: train_optimizer(m, config)))(model)
    step = TrainStep(model, opt, loss_fn, scaler=scaler)
    fn = step._eager_step if eager else step
    losses, walls = [], []
    torch.cuda.synchronize()
    kernels.reset_launches()
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        losses.append(float(fn(*b)))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if each is not None:
            each(i, step)
    return step, losses, walls, kernels.launches()


def graph_compare(label, config, gpu, steps=4, timed=5):
    """``steps`` graphed steps of ``config`` against ``steps`` eager ones
    from the same weights and dropout seed: losses, parameters, masters
    and moments must be the same bits, and the graphed run's launches
    ``train_launches``. Then each is timed (``timed`` more steps) and one
    step of each profiled: a replay must run each kernel as often as the
    wrappers count for a step. Returns the median step walls and busy
    shares."""
    import torch

    from paddle_tpu_torch.ops import kernels

    model = train_model(config)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    loss_fn, batch, _ = train_batch(model, config)
    B, L = batch[0].shape
    out = {}
    for eager in (False, True):
        kind = "eager" if eager else "graphed"
        step, losses, walls, launches = graph_run(
            model, config, init, loss_fn, [batch] * steps, eager)
        state = snapshot(model, step.optimizer)
        fn = step._eager_step if eager else step
        more = []
        for _ in range(timed):
            t0 = time.perf_counter()
            fn(*batch)
            torch.cuda.synchronize()
            more.append((time.perf_counter() - t0) * 1e3)
        wall, busy, seen = profiled(lambda: fn(*batch))
        counted = kernels.launches()
        med = sorted(more)[len(more) // 2]
        out[kind] = dict(losses=losses, state=state, wall=med, busy=busy,
                         prof_wall=wall)
        log(f"train-graph {label} {kind}: losses {losses}; step wall ms "
            + " ".join(f"{w:.1f}" for w in walls) + "; then "
            + " ".join(f"{w:.1f}" for w in more) + f" (median {med:.2f} ms "
            f"= {B * L / med * 1e3:.0f} tokens/s); one profiled step: wall "
            f"{wall:.2f} ms, device busy {busy:.2f} ms = "
            f"{busy / wall * 100:.1f}% [{gpu}]")
        want = train_launches(config, model.cfg, steps)
        check(launches == want,
              f"train-graph {label} {kind}: launches {launches}, want {want}")
        one = train_launches(config, model.cfg, 1)
        check(counted == one, f"train-graph {label} {kind}: the profiled "
              f"step counted {counted}, want {one}")
        check(seen == one, f"train-graph {label} {kind}: the profiler saw "
              f"kernels {seen} in one step, want {one}")
        del step
    g, e = out["graphed"], out["eager"]
    check(g["losses"] == e["losses"], f"train-graph {label}: graphed "
          f"losses {g['losses']} != eager {e['losses']}")
    bad = same_bits(g["state"], e["state"])
    check(not bad, f"train-graph {label}: graphed and eager differ in "
          f"{len(bad)} tensors, e.g. {bad[:4]}")
    log(f"train-graph {label}: graphed = eager bitwise over {steps} steps "
        f"(losses, {len(g['state'][0])} parameters and every optimizer "
        f"state value); the profiler named every kernel in a replay as "
        f"often as the wrappers count; step wall graphed {g['wall']:.2f} "
        f"ms vs eager {e['wall']:.2f} ms; device busy "
        f"{g['busy'] / g['prof_wall'] * 100:.1f}% vs "
        f"{e['busy'] / e['prof_wall'] * 100:.1f}% of a profiled step [{gpu}]")
    del model, init
    torch.cuda.empty_cache()
    return {k: (v["wall"], v["busy"], v["prof_wall"]) for k, v in out.items()}


def scheduler_check(gpu, steps=6):
    """bench_gpt under ``LinearWarmup`` (3 steps from 1e-5) into
    ``CosineAnnealingDecay(1e-4, T_max=steps)``, stepped after every
    call: ``steps`` graphed steps must end at the eager run's parameters
    and state, bitwise. Returns the number of tensors that differ (a
    graph that kept its first learning rate differs in every one)."""
    import torch

    from paddle_tpu_torch import optim

    config = "bench_gpt"
    model = train_model(config)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    loss_fn, batch, _ = train_batch(model, config)

    def make_opt(m):
        return optim.AdamW(
            parameters=m.named_parameters(), weight_decay=0.01,
            learning_rate=optim.lr.LinearWarmup(
                optim.lr.CosineAnnealingDecay(1e-4, T_max=steps),
                warmup_steps=3, start_lr=1e-5, end_lr=1e-4),
            grad_clip=optim.ClipGradByGlobalNorm(1.0), multi_precision=True)

    runs = {}
    for eager in (False, True):
        lrs = []

        def each(i, step):
            lrs.append(step.optimizer.get_lr())
            step.optimizer._learning_rate.step()

        step, losses, _, _ = graph_run(model, config, init, loss_fn,
                                       [batch] * steps, eager, make_opt,
                                       each=each)
        runs[eager] = (losses, lrs, snapshot(model, step.optimizer))
        del step
    bad = same_bits(runs[False][2], runs[True][2])
    log(f"train-graph scheduler (bench_gpt, LinearWarmup into "
        f"CosineAnnealingDecay): learning rates {runs[False][1]}; graphed "
        f"losses {runs[False][0]}, eager {runs[True][0]}; "
        f"{len(bad)} tensors differ [{gpu}]")
    del model, init, runs
    torch.cuda.empty_cache()
    return len(bad)


def scaler_check(gpu, steps=5, poisoned=2):
    """bench_bert with ``DynamicLossScaler(2**15, incr_every_n_steps=2)``
    and a ``poison`` batch item multiplying the loss, the third step's
    inf: that step must leave parameters, masters and moments bitwise,
    halve the scale and set ``last_found_inf`` (no other step may); two
    clean steps must double the scale; the eager run must give the same
    scales, flags and final bits."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.nlp import bert

    config = "bench_bert"
    model = train_model(config)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    _, batch, _ = train_batch(model, config)

    def loss_fn(m, *b):
        return bert.bert_pretrain_loss(m, *b[:-1]) * b[-1]

    batches = [batch + (np.array(np.inf if i == poisoned else 1.0,
                                 np.float32),) for i in range(steps)]
    runs = {}
    for eager in (False, True):
        trace, before = [], {}

        def each(i, step):
            trace.append((bool(step.last_found_inf),
                          float(step._scaler_state["scale"])))
            if i == poisoned - 1:
                before["state"] = snapshot(model, step.optimizer)
            if i == poisoned:
                bad = same_bits(before.pop("state"),
                                snapshot(model, step.optimizer))
                check(not bad, f"train-graph scaler: the poisoned step "
                      f"changed {len(bad)} tensors, e.g. {bad[:4]}")

        step, losses, _, _ = graph_run(
            model, config, init, loss_fn, batches, eager,
            scaler=amp.DynamicLossScaler(2.0 ** 15, incr_every_n_steps=2),
            each=each)
        runs[eager] = (losses, trace, snapshot(model, step.optimizer))
        del step
    (gl, gt, gs), (el, et, es) = runs[False], runs[True]
    log(f"train-graph scaler (bench_bert, step {poisoned + 1} poisoned): "
        f"(found_inf, scale) a step {gt}; losses {gl}; eager {et} [{gpu}]")
    check([f for f, _ in gt] == [i == poisoned for i in range(steps)],
          f"train-graph scaler: found_inf {gt}")
    s0 = 2.0 ** 15
    check([s for _, s in gt] == [s0, 2 * s0, s0, s0, 2 * s0],
          f"train-graph scaler: scales {gt}")
    check(gt == et, f"train-graph scaler: eager {et} != graphed {gt}")
    bad = same_bits(gs, es)
    check(not bad, f"train-graph scaler: graphed and eager differ in "
          f"{len(bad)} tensors")
    del model, init, runs
    torch.cuda.empty_cache()


def run_fused_check(gpu, K=4):
    """bench_gpt: two windows of ``run_fused`` (the first op by op, the
    second one graph of K steps) against 2K graphed calls: the same
    losses and final bits; then a third window, a replay, timed."""
    import torch

    config = "bench_gpt"
    model = train_model(config)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    loss_fn, batch, _ = train_batch(model, config)
    step, calls, _, _ = graph_run(model, config, init, loss_fn,
                                  [batch] * (2 * K), False)
    by_calls = snapshot(model, step.optimizer)
    del step
    step, _, _, _ = graph_run(model, config, init, loss_fn, [], False)
    fused = []
    walls = []
    # the first window runs op by op, the second is captured and replayed,
    # the third (timed only) is a replay
    for _ in range(3):
        t0 = time.perf_counter()
        losses = step.run_fused([batch] * K).tolist()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if len(walls) == 2:
            bad = same_bits(by_calls, snapshot(model, step.optimizer))
        fused += losses
    log(f"train-graph run_fused (bench_gpt, K = {K}): window losses "
        f"{fused[:2 * K]}; {2 * K} calls {calls}; window walls ms "
        + " ".join(f"{w:.1f}" for w in walls)
        + f" (a replayed window: {walls[2] / K:.2f} ms a step) [{gpu}]")
    check(fused[:2 * K] == calls, "train-graph run_fused: the windows' "
          "losses differ from the calls'")
    check(not bad, f"train-graph run_fused: {len(bad)} tensors differ")
    check(step.optimizer._global_step == 3 * K
          and step.last_found_inf_per_step.shape == (K,),
          "train-graph run_fused: step count or flags")
    del model, init, step
    torch.cuda.empty_cache()


def momentum_check(gpu):
    """bench_gpt's model under ``Momentum(1e-3, 0.9, multi_precision)``
    with global-norm clip 1.0, as ResNet-50 will train: the graphed second
    step must end at the eager run's bits."""
    import torch

    from paddle_tpu_torch import optim

    config = "bench_gpt"
    model = train_model(config)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    loss_fn, batch, _ = train_batch(model, config)

    def make_opt(m):
        return optim.Momentum(1e-3, 0.9, parameters=m.named_parameters(),
                              grad_clip=optim.ClipGradByGlobalNorm(1.0),
                              multi_precision=True)

    runs = {}
    for eager in (False, True):
        step, losses, _, _ = graph_run(model, config, init, loss_fn,
                                       [batch] * 2, eager, make_opt)
        runs[eager] = (losses, snapshot(model, step.optimizer))
        del step
    bad = same_bits(runs[False][1], runs[True][1])
    log(f"train-graph momentum (bench_gpt, multi_precision): graphed "
        f"losses {runs[False][0]}, eager {runs[True][0]}; {len(bad)} "
        f"tensors differ [{gpu}]")
    check(runs[False][0] == runs[True][0] and not bad,
          "train-graph momentum: the graphed step differs from the eager")
    del model, init, runs
    torch.cuda.empty_cache()


def train_graph_phase(gpu):
    """Phase 14: the step as one CUDA graph."""
    walls = {c: graph_compare(c, c, gpu) for c in ("bench_gpt",
                                                   "bench_bert")}
    check(scheduler_check(gpu) == 0, "train-graph scheduler: the graphed "
          "run differs from the eager run under the same scheduler")
    scaler_check(gpu)
    run_fused_check(gpu)
    momentum_check(gpu)
    return walls


# -- phase 8: training kernels timed at the path's shape ---------------------


def train_timing_phase(gpu, N, dtype, V=50304):
    """Kernel, plain version and library call for each training kernel at
    a train path's shape (N rows, D = 768, V = 50304, in ``dtype``: 8 x
    1024 float32 rows for the float32 step, 16 x 1024 bfloat16 ones for
    bench_gpt; with ``V=None`` the LayerNorm kernels alone, as for
    bench_bert's 64 x 128 bfloat16 rows, whose vocab takes no
    cross-entropy kernel), beside the least time the card could take: the bytes
    each must move (every input read once, every output written once)
    over 3.35 TB/s against its float32 operations (the kernels compute
    in float32 whatever the type) over 67 TFLOP/s.

    The LayerNorm kernels and their library calls are timed twice: warm,
    every launch on the same input (which, at 25 MB, may still sit in the
    50 MB L2 from the launch before), and cold, launches rotating over
    ``COLD_BYTES`` of distinct inputs and outputs, so that no launch
    finds its input in L2, as a training step's LayerNorm does not. The
    row keeps the cold times as ``ms`` and ``library_ms``. Beside each
    LayerNorm kernel, its scalar kernel at the same shape, checked
    against the plain version and timed warm and cold (logged only)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import layernorm as ln
    from paddle_tpu_torch.ops.kernels import softmax_ce as ce

    D = 768
    g = torch.Generator(device="cuda").manual_seed(13)
    x, dy = (torch.randn(N, D, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    gamma, beta = (torch.randn(D, generator=g, device="cuda").to(dtype)
                   for _ in range(2))
    if V is not None:
        logits = torch.randn(N, V, generator=g, device="cuda").to(dtype)
        lab = torch.randint(0, V, (N,), generator=g, device="cuda")
        gl = torch.full((N,), 1.0 / N, device="cuda")
        _, lse = ce.softmax_ce_fwd(logits, lab)
        cl = logits.clone().requires_grad_()
        lossl = F.cross_entropy(cl, lab, reduction="none")
    _, mean, rstd = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
    xl = x.clone().requires_grad_()
    wl, bl = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
    yl = F.layer_norm(xl, (D,), wl, bl, 1e-5)

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
    # the scalar kernels, ln_fwd_kernel and ln_bwd_kernel, which the
    # vector kernels took over at this width: an x one element past a
    # 16-byte boundary sends both there (the dispatch in csrc/layernorm.cu)
    def off16(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view_as(t)

    xos = [off16(xi) for xi in xs]
    scalar = {
        # name: (warm, cold, the plain version's output, the kernel's)
        "layer_norm_fwd": (
            lambda: ln.layer_norm_fwd(xos[0], gamma, beta, 1e-5),
            rotating([lambda xi=xi: ln.layer_norm_fwd(xi, gamma, beta,
                                                      1e-5)
                      for xi in xos]),
            lambda: ln.layer_norm_fwd_reference(xos[0], gamma, beta, 1e-5)),
        "layer_norm_bwd": (
            lambda: ln.layer_norm_bwd(xos[0], gamma, *stats[0], dys[0]),
            rotating([lambda i=i: ln.layer_norm_bwd(xos[i], gamma,
                                                    *stats[i], dys[i])
                      for i in range(reps)]),
            lambda: ln.layer_norm_bwd_reference(xos[0], gamma, *stats[0],
                                                dys[0])),
    }

    s, f4 = x.element_size(), 4
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
    }
    if V is not None:
        il = lab.element_size()
        rows.update({
            "softmax_ce_fwd": (
                lambda: ce.softmax_ce_fwd(logits, lab),
                lambda: ce.softmax_ce_fwd_reference(logits, lab),
                lambda: F.cross_entropy(logits, lab, reduction="none"),
                s * N * V + (il + 2 * f4) * N, 4 * N * V),
            "softmax_ce_bwd": (
                lambda: ce.softmax_ce_bwd(logits, lab, lse, gl),
                lambda: ce.softmax_ce_bwd_reference(logits, lab, lse, gl),
                lambda: torch.autograd.grad(lossl, cl, gl,
                                            retain_graph=True),
                s * 2 * N * V + (il + 2 * f4) * N, 4 * N * V)})
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
        if name in scalar:
            warm_k, cold_k, plain_k = scalar[name]
            tol = TRAIN_F32_TOL if dtype == torch.float32 else BF16_TOL
            got, want = warm_k(), plain_k()
            scales = [None]
            if name == "layer_norm_bwd":   # dgamma, dbeta: sums over N rows
                g0 = dys[0].float()
                xhat = (xos[0].float() - stats[0][0]) * stats[0][1]
                scales += [(g0 * xhat).abs().sum(0), g0.abs().sum(0)]
            err = 0.0
            for o, r, sc in zip(got, want, scales):
                ok, e = within(o, r, tol, sc)
                check(ok, f"{tag} scalar kernel disagrees with the plain "
                      f"version (max abs err {e:.3e})")
                err = max(err, e)
            warm_s, cold_s = cuda_ms(warm_k, iters), cuda_ms(cold_k, iters)
            kern = ("ln_fwd_kernel" if name == "layer_norm_fwd" else
                    "ln_bwd_kernel + ln_bwd_reduce_kernel")
            log(f"{tag} scalar {kern} (x off 16-byte alignment): warm "
                f"{warm_s:.4f} ms, cold {cold_s:.4f} ms = "
                f"{bound / cold_s * 100:.1f}% of roofline (max abs err vs "
                f"plain {err:.2e}) [{gpu}]")
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
    # the forward at bench_bert's eval shape (no mask, not causal): the
    # 12 launches of the train-bert phase's eval forward, B*H = 64 * 12,
    # L = BERT_SEQ; every (query, key) pair counts
    qe, ke, ve = (torch.randn(64, 12, BERT_SEQ, D, generator=g,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(3))
    oe, lse_e = fa.flash_attention_fwd(qe, ke, ve, False, scale)
    oe_ref, lse_ref = fa.flash_attention_fwd_reference(qe, ke, ve, False,
                                                       scale)
    ok_o, err_o = flash_close(oe, oe_ref, False)
    ok_l, err_l = flash_close(lse_e, lse_ref, False)
    check(ok_o and ok_l, f"flash forward at bench_bert's eval shape "
          f"disagrees with its plain version: O {err_o:.3e}, lse "
          f"{err_l:.3e}")
    BHe = 64 * 12
    te, rowe = BHe * BERT_SEQ * D * 2, BHe * BERT_SEQ * 4
    flops = 4 * D * BHe * BERT_SEQ * BERT_SEQ
    ms = cuda_ms(lambda: fa.flash_attention_fwd(qe, ke, ve, False, scale),
                 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_fwd_reference(
        qe, ke, ve, False, scale), 5)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qe, ke, ve),
                     20)
    ms2 = cuda_ms(lambda: fa.flash_attention_fwd(qe, ke, ve, False, scale),
                  20)
    t_bytes = (4 * te + rowe) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    log(f"timing flash_attention_fwd (bench_bert eval) B*H={BHe} "
        f"L={BERT_SEQ} D={D} bfloat16 not causal: kernel {ms:.4f} ms "
        f"(again {ms2:.4f}), plain {plain_ms:.4f} ms, library (SDPA) "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
        f"{(4 * te + rowe) / 1e6:.1f} MB at 3.35 TB/s, {flops / 1e9:.1f} "
        f"GFLOP at 989 TFLOP/s) = {bound / min(ms, ms2) * 100:.2f}% of "
        f"roofline; max abs err vs plain O {err_o:.3e} lse {err_l:.3e} "
        f"[{gpu}]")
    return out


# -- phase 15: decoding -------------------------------------------------------

# bench.py:bench_wmt_beam (:213-243): WMTTransformer at Transformer-base
# width, bfloat16, eval; 16 x 32 source ids from RandomState(0) in
# [2, 32000), beam 4, max_len 32, length penalty 0.6. Nothing cut.
WMT_MODEL = dict(src_vocab=32000, tgt_vocab=32000, d_model=512, nhead=8,
                 num_layers=6, dim_feedforward=2048, dropout=0.0,
                 max_len=32)
WMT_BATCH, WMT_SRC_LEN = 16, 32
WMT_DECODE = dict(beam_size=4, max_len=32, length_penalty=0.6)
# gpt_small at dropout 0, bfloat16, eval: 8 prompts of 128 tokens from
# RandomState(0), 32 new greedy tokens
GPT_DECODE = dict(batch=8, prompt=128, new=32)
# a decode against another run of it (the plain versions', the growing
# cache's) made to take the first run's decisions. Along them, every
# candidate value taken — a beam's accumulated float32 log-probability —
# must be within WMT_VALUE_TOL of the first run's, and so the best-beam
# score (that value over a length penalty >= 1). Seen on an H100 80GB
# HBM3 (700 W): 1.37 apart (plain versions), one step's increments up to
# 1.0: at this width and init the logits reach ~100 in bfloat16, whose
# steps there are 0.5, and a decode sums 31 steps. The other run's own
# decisions must be the same wherever its margin exceeds WMT_MARGIN, the
# most two values held to WMT_VALUE_TOL can move a decision (for a beam
# step the gap between the K-th and the (K+1)-th largest totals, which
# beams go on; at the end the gap between the best and second score). A
# greedy step's token is held to the other run's argmax where its top-2
# logits are more than GPT_MARGIN apart (gpt_small's logits, |logit| <
# 2, carry bfloat16 steps of 2^-9 to 2^-8).
WMT_VALUE_TOL = 2.0
WMT_MARGIN = 2 * WMT_VALUE_TOL
GPT_MARGIN = 2 ** -4


class Decisions:
    """Records, while active, the decisions of the decode library's beam
    search: the candidates ``_top_k`` keeps at each step and the final
    order ``_order`` gives. Given ``forced``, another run's record, the
    search takes that run's decisions instead (its values read at those
    candidates), and this record keeps its own beside them with their
    margins: the gap between the K-th and (K+1)-th largest candidate of
    each batch item, and between the best and second score."""

    def __init__(self, forced=None):
        self.forced = forced
        self.chosen, self.own, self.gaps, self.values = [], [], [], []
        self.order = None

    def __enter__(self):
        from paddle_tpu_torch.inference import decoder

        self._real = decoder._top_k, decoder._order

        def top_k(x, k):
            self.vocab = x.shape[-1] // k
            v, i = self._real[0](x, k)
            top = x.topk(k + 1, dim=-1).values
            self.gaps.append((top[:, k - 1] - top[:, k]).float())
            self.own.append(i.sort(dim=-1).values)
            if self.forced is not None:
                i = self.forced.chosen[len(self.chosen)]
                v = x.gather(-1, i)
            self.chosen.append(i)
            self.values.append(v.float())
            return v, i

        def order(scores):
            o = self._real[1](scores)
            top = scores.topk(2, dim=-1).values
            self.order_gap = (top[:, 0] - top[:, 1]).float()
            self.own_best = o[:, 0]
            if self.forced is not None:
                o = self.forced.order
            self.order = o
            return o

        decoder._top_k, decoder._order = top_k, order
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.inference import decoder

        decoder._top_k, decoder._order = self._real

    def step_drift(self):
        """The largest difference between this run's and the forced
        run's log-probability increments along the same decisions (a
        candidate's value less its parent beam's value before the step),
        over candidates above -1e8 (a finished beam's non-EOS tokens and
        the dead beams of the first step sit at -1e9)."""
        worst, prev, prev_f = 0.0, None, None
        for i, v, vf in zip(self.chosen, self.values, self.forced.values):
            if prev is None:      # the first step's parent, beam 0, is 0
                inc, inc_f = v, vf
            else:
                parent = i // self.vocab
                inc = v - prev.gather(1, parent)
                inc_f = vf - prev_f.gather(1, parent)
            live = (v > -1e8) & (vf > -1e8)
            if bool(live.any()):
                worst = max(worst, (inc - inc_f)[live].abs().max().item())
            prev, prev_f = v, vf
        return worst

    def agree(self, label):
        """This run against the forced one: every candidate value taken
        within WMT_VALUE_TOL, and each of this run's own decisions the
        same wherever its margin exceeds WMT_MARGIN. Returns ``(decisions
        held, decisions equal, all decisions, the largest difference of
        the values taken, of one step's increments)``."""
        import torch

        drift = max((a - b).abs().max().item() for a, b in
                    zip(self.values, self.forced.values))
        check(drift <= WMT_VALUE_TOL, f"{label}: candidate values taken "
              f"differ by {drift:.3e} (tol {WMT_VALUE_TOL})")
        gaps = torch.stack(self.gaps + [self.order_gap])
        sure = gaps > WMT_MARGIN
        same = [(own == forced.sort(dim=-1).values).all(dim=-1)
                for own, forced in zip(self.own, self.forced.chosen)]
        same = torch.stack(same + [self.own_best == self.forced.order[:, 0]])
        bad = (sure & ~same).nonzero().tolist()
        check(not bad, f"{label}: decisions (step, item) {bad[:8]} differ "
              f"though their margins exceed {WMT_MARGIN}")
        q = torch.quantile(gaps.flatten(), torch.tensor(
            [0.25, 0.5, 0.75], device=gaps.device)).tolist()
        log(f"{label}: margins' quartiles "
            + " ".join(f"{x:.3f}" for x in q))
        return (int(sure.sum()), int(same.sum()), sure.numel(), drift,
                self.step_drift())


def wmt_setup():
    """bench_wmt_beam's model on the card from seed 0 (bfloat16, eval)
    and its source ids; also read by ``tools/torch_decode_profile.py``."""
    import torch

    from paddle_tpu_torch.models.nlp.transformer import WMTTransformer

    g = torch.Generator(device="cuda").manual_seed(0)
    model = WMTTransformer(**WMT_MODEL, generator=g).bfloat16().eval()
    src = torch.from_numpy(np.random.RandomState(0).randint(
        2, WMT_MODEL["src_vocab"], (WMT_BATCH, WMT_SRC_LEN))).cuda()
    return model, src


def gpt_decode_setup():
    """``gpt_small`` on the card from seed 0 (dropout 0, bfloat16, eval)
    and the decode's prompts; also read by
    ``tools/torch_decode_profile.py``."""
    import torch

    from paddle_tpu_torch.models.nlp import gpt

    g = torch.Generator(device="cuda").manual_seed(0)
    model = gpt.GPT(gpt.gpt_small(dropout=0.0), generator=g).bfloat16()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, model.cfg.vocab_size,
        (GPT_DECODE["batch"], GPT_DECODE["prompt"]))).cuda()
    return model.eval(), ids


def decode_launches(launches, **counts):
    """``launches`` must be exactly ``counts`` (every other kernel 0)."""
    want = dict.fromkeys(launches, 0)
    want.update(counts)
    return launches == want, want


def timed(fn, calls):
    """Median host wall ms of ``calls`` calls of ``fn``, each ending in a
    synchronize."""
    import torch

    walls = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[len(walls) // 2], walls


def wmt_decode(gpu):
    """bench_wmt_beam's decode: ``beam_search_decode_xla`` graphed, then
    op by op (the same bits and launches), then under the plain versions
    and through the growing caches, each made to take the kernel run's
    decisions (``Decisions``), ``greedy_decode``;
    exactly 12 LayerNorm launches in the encoder and 18 a decode step,
    nothing else; latency, sentences/s and tokens/s as bench_wmt_beam
    reckons them, graphed and op by op."""
    import torch

    from paddle_tpu_torch.ops import kernels

    model, src = wmt_setup()
    B, T = WMT_BATCH, WMT_DECODE["max_len"]
    kw = dict(WMT_DECODE, src_pad_id=None, return_all=False)
    layers = WMT_MODEL["num_layers"]

    def ln_launches(steps):
        return 2 * layers + 3 * layers * steps

    def run(fn, label, steps=T - 1):
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = kernels.launches()
        ok, want = decode_launches(launches,
                                   layer_norm_fwd=ln_launches(steps))
        check(ok, f"decode wmt {label}: launches {launches}, want {want}")
        return out

    t0 = time.perf_counter()
    model.beam_search_decode_xla(src, **WMT_DECODE)   # warm, capture, replay
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    toks_g, sc_g = run(lambda: model.beam_search_decode_xla(
        src, **WMT_DECODE), "graphed")
    with torch.no_grad(), Decisions() as made:
        toks_o, sc_o = run(lambda: model._traced_beam_decode(src, **kw),
                           "op by op")
    check(torch.equal(toks_g, toks_o) and torch.equal(sc_g, sc_o),
          "decode wmt: the graphed beam search differs from op by op")
    check(toks_g.shape == (B, T) and sc_g.shape == (B,)
          and bool(torch.isfinite(sc_g).all())
          and bool((toks_g[:, 0] == model.bos_id).all())
          and bool(((toks_g >= 0) & (toks_g < WMT_MODEL["tgt_vocab"])).all()),
          "decode wmt: tokens or scores out of shape or range")

    def along(label, fn):
        """``fn`` made to take the kernel run's decisions: its own ones
        agree where their margins allow, its tokens are the kernel run's
        and its values and scores within WMT_VALUE_TOL."""
        with Decisions(forced=made) as other:
            toks, sc = fn()
        held = other.agree(f"decode wmt {label}")
        check(torch.equal(toks, toks_g), f"decode wmt {label}: tokens "
              f"differ along the same decisions")
        err = (sc.float() - sc_g.float()).abs().max().item()
        check(err <= WMT_VALUE_TOL, f"decode wmt {label}: scores differ "
              f"by {err:.3e} along the same decisions (tol "
              f"{WMT_VALUE_TOL})")
        return held, err, len(other.chosen)

    with torch.no_grad(), kernels.plain_versions():
        kernels.reset_launches()
        plain = along("plain", lambda: model._traced_beam_decode(src, **kw))
        check(set(kernels.launches().values()) == {0},
              "decode wmt: the plain versions launched a kernel")
    grow = along("growing cache", lambda: model.beam_search_decode(
        src, **WMT_DECODE))
    # the eager search stops once every beam has finished
    run(lambda: model.beam_search_decode(src, **WMT_DECODE), "eager",
        steps=grow[2])
    greedy = run(lambda: model.greedy_decode(src, max_len=T), "greedy")
    check(greedy.shape == (B, T) and bool((greedy[:, 0] == model.bos_id)
                                          .all()),
          "decode wmt: greedy tokens out of shape")
    ms_g, walls_g = timed(lambda: model.beam_search_decode_xla(
        src, **WMT_DECODE), 5)

    def op_by_op():
        with torch.no_grad():
            model._traced_beam_decode(src, **kw)
    ms_o, walls_o = timed(op_by_op, 3)
    ms_e, _ = timed(lambda: model.beam_search_decode(src, **WMT_DECODE), 3)
    log(f"decode wmt: bench_wmt_beam ({WMT_MODEL['num_layers']} + "
        f"{layers} layers x {WMT_MODEL['d_model']}, vocab "
        f"{WMT_MODEL['tgt_vocab']}, bfloat16, "
        f"batch {B} x {WMT_SRC_LEN}, beam {WMT_DECODE['beam_size']}, "
        f"max_len {T}): graphed = op by op bitwise, {ln_launches(T - 1)} "
        f"LayerNorm launches a decode (12 + 18 x {T - 1}); along its "
        f"decisions the plain versions' values taken differ by up to "
        f"{plain[0][3]:.3e} (one step's by {plain[0][4]:.3e}; tol "
        f"{WMT_VALUE_TOL}), best-beam scores by {plain[1]:.3e}, and they "
        f"would take the same {plain[0][1]} of {plain[0][2]} decisions "
        f"({plain[0][0]} with margins > {WMT_MARGIN}, each the same); the "
        f"growing cache's values by {grow[0][3]:.3e} (a step's "
        f"{grow[0][4]:.3e}), scores by {grow[1]:.3e}, the same "
        f"{grow[0][1]} decisions ({grow[0][0]} held)")
    for label, ms, walls in (("graphed", ms_g, walls_g),
                             ("op by op", ms_o, walls_o),
                             ("eager growing cache", ms_e, None)):
        log(f"decode wmt {label}: {ms:.2f} ms a batch = {B / ms * 1e3:.1f} "
            f"sentences/s, {B * T / ms * 1e3:.0f} tokens/s"
            + (f" (calls " + " ".join(f"{w:.2f}" for w in walls) + ")"
               if walls else "") + f" [{gpu}]")
    log(f"decode wmt: first graphed call (op by op, capture, replay) "
        f"{first:.1f} ms")
    del model
    torch.cuda.empty_cache()
    return dict(graphed_ms=ms_g, op_by_op_ms=ms_o, eager_ms=ms_e)


def greedy_agree(label, toks, logits):
    """Greedy tokens ``toks (B, n)`` against the argmax of ``logits (B, n,
    V)`` wherever its top-2 margin exceeds GPT_MARGIN. Returns ``(tokens
    held, tokens equal)``."""
    top = logits.float().topk(2, dim=-1).values
    sure = (top[..., 0] - top[..., 1]) > GPT_MARGIN
    same = logits.argmax(dim=-1) == toks
    check(bool((same | ~sure).all()), f"{label}: "
          f"{int((~same & sure).sum())} tokens are not the argmax though "
          f"its margin exceeds {GPT_MARGIN}")
    check(2 * int(sure.sum()) >= sure.numel(), f"{label}: only "
          f"{int(sure.sum())} of {sure.numel()} tokens had margins above "
          f"{GPT_MARGIN}")
    return int(sure.sum()), int(same.sum())


def gpt_decode(gpu):
    """gpt_small's decode: ``generate`` (growing cache, its prefill the
    non-causal flash forward) with exactly 12 flash forwards and 32 x 25
    LayerNorm launches, its tokens held to a teacher-forced run of the
    same path under the plain versions; ``generate_xla`` graphed = op by
    op bitwise, its tokens held to the argmax of a full causal forward
    over the context; tokens/s of both."""
    import torch

    from paddle_tpu_torch.ops import kernels

    model, ids = gpt_decode_setup()
    cfg = model.cfg
    B, Lp, n = GPT_DECODE["batch"], GPT_DECODE["prompt"], GPT_DECODE["new"]
    ln = (2 * cfg.layers + 1) * n

    def run(fn, label, **counts):
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = kernels.launches()
        ok, want = decode_launches(launches, **counts)
        check(ok, f"decode gpt {label}: launches {launches}, want {want}")
        return out

    out_e = run(lambda: model.generate(ids, n, temperature=0.0), "generate",
                layer_norm_fwd=ln, flash_attention_fwd=cfg.layers)
    check(out_e.shape == (B, Lp + n) and torch.equal(out_e[:, :Lp], ids),
          "decode gpt: generate's output is not the prompt and 32 tokens")
    # the same growing-cache path teacher-forced on generate's tokens,
    # through the plain versions
    with torch.no_grad(), kernels.plain_versions():
        cache = model.init_cache(B)
        rows = []
        for i in range(n):
            x = ids if i == 0 else out_e[:, Lp + i - 1:Lp + i]
            logits, cache = model(x, cache=cache)
            rows.append(logits[:, -1])
    plain_logits = torch.stack(rows, dim=1)
    held_e = greedy_agree("decode gpt generate vs plain", out_e[:, Lp:],
                          plain_logits)
    # the kernels' logits on the same teacher-forced inputs, for the log
    with torch.no_grad():
        cache = model.init_cache(B)
        rows = []
        for i in range(n):
            x = ids if i == 0 else out_e[:, Lp + i - 1:Lp + i]
            logits, cache = model(x, cache=cache)
            rows.append(logits[:, -1])
    logit_diff = (torch.stack(rows, dim=1).float()
                  - plain_logits.float()).abs().max().item()
    model.generate_xla(ids, n)                   # warm, capture, replay
    out_x = run(lambda: model.generate_xla(ids, n), "generate_xla graphed",
                layer_norm_fwd=ln)
    with torch.no_grad():
        out_o = run(lambda: model._traced_generate(
            ids, None, max_new_tokens=n, temperature=0.0, top_k=None)[0],
            "generate_xla op by op", layer_norm_fwd=ln)
    check(torch.equal(out_x, out_o), "decode gpt: the graphed generate_xla "
          "differs from op by op")
    with torch.no_grad():
        full = model(out_x[:, :-1])[:, Lp - 1:]
    held_x = greedy_agree("decode gpt generate_xla vs causal forward",
                          out_x[:, Lp:], full)

    ms_e, _ = timed(lambda: model.generate(ids, n, temperature=0.0), 3)
    ms_x, walls_x = timed(lambda: model.generate_xla(ids, n), 5)

    def op_by_op():
        with torch.no_grad():
            model._traced_generate(ids, None, max_new_tokens=n,
                                   temperature=0.0, top_k=None)
    ms_o, _ = timed(op_by_op, 3)
    same = int((out_e[:, Lp:] == out_x[:, Lp:]).sum())
    log(f"decode gpt: gpt_small bfloat16, batch {B}, prompt {Lp}, {n} new "
        f"tokens: generate launched {cfg.layers} non-causal flash forwards "
        f"and {ln} LayerNorm forwards, its tokens held to the plain "
        f"versions' argmax on {held_e[0]} of {B * n} (equal {held_e[1]}; "
        f"their logits on the same inputs differ by at most "
        f"{logit_diff:.3e}, largest |logit| "
        f"{plain_logits.float().abs().max().item():.3e}); "
        f"generate_xla graphed = op by op bitwise, held to the causal "
        f"forward's argmax on {held_x[0]} (equal {held_x[1]}); generate and "
        f"generate_xla agree on {same} of {B * n} tokens (generate's "
        f"prefill is not causal)")
    for label, ms in (("generate (growing cache, op by op)", ms_e),
                      ("generate_xla graphed", ms_x),
                      ("generate_xla op by op", ms_o)):
        log(f"decode gpt {label}: {ms:.2f} ms a call = "
            f"{B * n / ms * 1e3:.0f} tokens/s [{gpu}]")
    del model
    torch.cuda.empty_cache()
    return dict(generate_ms=ms_e, xla_ms=ms_x, xla_op_by_op_ms=ms_o)


def decode_timing(gpu):
    """The two kernels of the decode paths at their shapes there, beside
    their plain versions, library calls and bounds: the flash forward at
    the GPT prefill's (B*H = 8 * 12, L = 128, D = 64, bfloat16, not
    causal) and the LayerNorm forward at WMT's encoder (512, 512) and
    beam-step (64, 512) rows, GPT's prefill (1024, 768) and token-step
    (8, 768) rows, bfloat16, warm (a decode's LayerNorm reads what the
    kernel before it just wrote)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layernorm as ln

    g = torch.Generator(device="cuda").manual_seed(23)
    B, H, L, D = GPT_DECODE["batch"], 12, GPT_DECODE["prompt"], 64
    BH, scale = B * H, 1.0 / D ** 0.5
    q, k, v = (torch.randn(B, H, L, D, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, False, scale)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, False, scale)
    ok_o, err_o = flash_close(o, o_ref, False)
    ok_l, err_l = flash_close(lse, lse_ref, False)
    check(ok_o and ok_l, f"flash forward at the GPT prefill's shape "
          f"disagrees with its plain version: O {err_o:.3e}, lse "
          f"{err_l:.3e}")
    t, row = BH * L * D * 2, BH * L * 4
    rows = [("flash_attention_fwd", f"B*H={BH} L={L} D={D} not causal",
             lambda: fa.flash_attention_fwd(q, k, v, False, scale),
             lambda: fa.flash_attention_fwd_reference(q, k, v, False, scale),
             lambda: F.scaled_dot_product_attention(q, k, v),
             4 * t + row, 4 * D * BH * L * L, BF16_FLOP_PER_S,
             max(err_o, err_l))]
    for N, Dn in ((512, 512), (64, 512), (1024, 768), (8, 768)):
        x = torch.randn(N, Dn, generator=g, device="cuda").to(torch.bfloat16)
        gamma, beta = (torch.randn(Dn, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(2))
        y, mean, rstd = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
        yr, mr, rr = ln.layer_norm_fwd_reference(x, gamma, beta, 1e-5)
        oks = [within(y, yr, BF16_TOL), within(mean, mr, TRAIN_F32_TOL),
               within(rstd, rr, TRAIN_F32_TOL)]
        check(all(ok for ok, _ in oks), f"layer_norm_fwd ({N}, {Dn}) "
              f"bfloat16 disagrees with its plain version")
        rows.append((
            "layer_norm_fwd", f"({N}, {Dn})",
            lambda x=x, gm=gamma, bt=beta: ln.layer_norm_fwd(x, gm, bt,
                                                              1e-5),
            lambda x=x, gm=gamma, bt=beta: ln.layer_norm_fwd_reference(
                x, gm, bt, 1e-5),
            lambda x=x, gm=gamma, bt=beta, Dn=Dn: F.layer_norm(
                x, (Dn,), gm, bt, 1e-5),
            2 * (2 * N * Dn + 2 * Dn) + 4 * 2 * N, 8 * N * Dn,
            F32_FLOP_PER_S, max(e for _, e in oks)))
    out = {}
    for name, shape, kern, plain, lib, nbytes, flops, peak, err in rows:
        ms, plain_ms = cuda_ms(kern, 50), cuda_ms(plain, 20)
        lib_ms, ms2 = cuda_ms(lib, 50), cuda_ms(kern, 50)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        bound = max(t_bytes, t_ops)
        log(f"timing decode {name} {shape} bfloat16: kernel {ms:.4f} ms "
            f"(again {ms2:.4f}), plain {plain_ms:.4f} ms, library "
            f"{lib_ms:.4f} ms, bound {bound:.4f} ms "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}) = "
            f"{bound / min(ms, ms2) * 100:.2f}% of roofline; max abs err vs "
            f"plain {err:.3e} [{gpu}]")
        out[f"{name} {shape}"] = min(ms, ms2)
    return out


def decode_phase(gpu):
    """Phase 15: bench_wmt_beam's decode and gpt_small's, then the
    decode shapes' kernel timings."""
    return wmt_decode(gpu), gpt_decode(gpu), decode_timing(gpu)



# -- phase 16: ResNet-50 training as bench.py:bench_resnet50 runs it ----------


def resnet_loss(m, x, y):
    """bench_resnet50's loss: ``cross_entropy(m(x.astype(bf16))
    .astype(f32), y)`` over 1000 classes (the dense path in both packages:
    1000 is not a multiple of 128)."""
    import torch

    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(m(x.to(torch.bfloat16)).float(), y)


def resnet_reference_forward(state, x):
    """ResNet-50's training forward (BatchNorm on the batch's statistics)
    in float32 over the float32 ``state``, written with
    ``torch.nn.functional`` and none of the port's ops, cuDNN without
    TF32: the plain reference a fault in the port's conv, pooling or
    BatchNorm cannot reach."""
    import torch
    import torch.nn.functional as TF

    def conv_bn(h, prefix, stride, act=True):
        w = state[f"{prefix}.conv.weight"]
        h = TF.conv2d(h, w, stride=stride, padding=(w.shape[-1] - 1) // 2)
        h = TF.batch_norm(h, None, None, state[f"{prefix}.bn.weight"],
                          state[f"{prefix}.bn.bias"], training=True,
                          eps=1e-5)
        return TF.relu(h) if act else h

    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        h = TF.max_pool2d(conv_bn(x, "stem", 2), 3, 2, 1)
        stages = sorted({int(k.split(".")[1]) for k in state
                         if k.startswith("layers.")})
        for i in stages:
            blocks = sorted({int(k.split(".")[2]) for k in state
                             if k.startswith(f"layers.{i}.")})
            for j in blocks:
                p = f"layers.{i}.{j}"
                stride = 2 if i > 0 and j == 0 else 1
                out = conv_bn(h, f"{p}.conv1", 1)
                out = conv_bn(out, f"{p}.conv2", stride)
                out = conv_bn(out, f"{p}.conv3", 1, act=False)
                if f"{p}.downsample.conv.weight" in state:
                    h = conv_bn(h, f"{p}.downsample", stride, act=False)
                h = TF.relu(out + h)
        return h.mean(dim=(2, 3)) @ state["fc.weight"] + state["fc.bias"]


def resnet_value_check(model, init, batch):
    """The first step's forward, in bfloat16 through the port, against
    ``resnet_reference_forward`` of the same weights in float32: logits
    within RESNET_LOGIT_TOL of the reference's largest |logit|, losses
    within RESNET_LOSS_TOL. At random weights BatchNorm and the global
    pool leave the logits little sensitive to what a conv does (weights
    read transposed moved them by 0.27 of the largest |logit|, against
    0.13 for bfloat16's roundings), so each of the 53 convs' outputs is
    also held, during that forward, to ``torch.nn.functional.conv2d`` in
    float32 of its own bfloat16 input and weight, with the stride and
    padding its module declares: within RESNET_CONV_TOL of the largest
    |value| (one bfloat16 rounding of each output). A conv that pads or
    reads its weight wrongly fails that. Returns (logit error share,
    loss difference, the worst conv's error share)."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.layers import Conv2D

    dev = next(model.parameters()).device
    x, y = (torch.from_numpy(a).to(dev) for a in batch)
    convs = []

    def held(module, inputs, out):
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            ref = TF.conv2d(inputs[0].float(), module.weight.float(),
                            stride=module._stride, padding=module._padding)
        convs.append(((out.float() - ref).abs().max()
                      / ref.abs().max()).item())

    model.load_state_dict(init)
    hooks = [m.register_forward_hook(held) for m in model.modules()
             if isinstance(m, Conv2D)]
    try:
        with torch.no_grad():
            got = model(x.to(torch.bfloat16)).float()
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        loss = F.cross_entropy(got, y).item()
        ref = resnet_reference_forward(
            {k: v.float() for k, v in init.items()}, x)
        ref_loss = torch.nn.functional.cross_entropy(ref, y.long()).item()
    model.load_state_dict(init)     # the forward moved the statistics
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    log(f"train-resnet: first forward, bf16 logits vs a float32 forward of "
        f"the same weights: max |diff| {err:.3e} of the largest |logit| "
        f"{ref.abs().max().item():.3f} (tol {RESNET_LOGIT_TOL}); loss "
        f"{loss:.5f} vs {ref_loss:.5f} (tol {RESNET_LOSS_TOL}); each of "
        f"{len(convs)} convs vs a float32 conv of its input: worst "
        f"{max(convs):.3e} of its largest |value| (tol {RESNET_CONV_TOL})")
    check(bool(torch.isfinite(got).all()), "train-resnet: non-finite logits")
    check(max(convs) <= RESNET_CONV_TOL, f"train-resnet: conv "
          f"{convs.index(max(convs))} differs from a float32 conv of its "
          f"input by {max(convs):.3e} of its largest |value|")
    check(err <= RESNET_LOGIT_TOL, "train-resnet: the bf16 logits differ "
          "from the float32 reference's")
    check(abs(loss - ref_loss) <= RESNET_LOSS_TOL, "train-resnet: the loss "
          "differs from the float32 reference's")
    return err, abs(loss - ref_loss), max(convs)


def stem_bn_check(model, init, x):
    """After one step from ``init``: the stem BatchNorm's running mean and
    variance against Paddle's update (momentum 0.9 kept, the variance
    unbiased by n / (n - 1), the update in bfloat16) applied to a separate
    float32 ``var_mean`` of the stem conv's output (``F.conv2d`` of the
    bfloat16 images and weight). Within one bfloat16 step (2^-7 of the
    value); a momentum taken as 1 - m fails it."""
    import torch
    import torch.nn.functional as TF

    w = init["stem.conv.weight"]
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=False):
        out = TF.conv2d(torch.from_numpy(x).to(w.device, w.dtype), w,
                        stride=2, padding=3)
        var, mean = torch.var_mean(out.float(), dim=(0, 2, 3), correction=0)
    n = out.numel() // out.shape[1]
    keep, take = (torch.tensor(v, dtype=w.dtype).item() for v in (0.9, 0.1))
    bn = model.stem.bn
    worst = 0.0
    for name, got, start, stat in (
            ("mean", bn._mean, init["stem.bn._mean"], mean),
            ("variance", bn._variance, init["stem.bn._variance"],
             var * (n / (n - 1)))):
        want = (start * keep + stat.to(w.dtype) * take).float()
        err = ((got.float() - want).abs() / want.abs().clamp_min(1e-30))
        worst = max(worst, err.max().item())
        check(got.dtype == w.dtype and err.max().item() <= 2 ** -7,
              f"train-resnet: the stem BatchNorm's running {name} after "
              f"step 1 is off Paddle's update by {err.max().item():.3e} "
              f"(tol one bfloat16 step, 2^-7)")
    log(f"train-resnet: stem BatchNorm's running mean and variance after "
        f"step 1 within {worst:.3e} of Paddle's update of a separate "
        f"float32 var_mean (tol 2^-7)")
    return worst


def resnet_eager_once(model, init, loss_fn, batch):
    """One op-by-op step from ``init`` with a new optimizer: (loss, the
    gradients, snapshot, wall ms)."""
    import torch

    from paddle_tpu_torch.framework import TrainStep

    model.load_state_dict(init)
    opt = train_optimizer(model, "bench_resnet50")
    step = TrainStep(model, opt, loss_fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(step._eager_step(*batch))
    wall = (time.perf_counter() - t0) * 1e3
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss, grads, snapshot(model, opt), wall


def train_resnet_phase(gpu, steps=4, timed=5):
    """Phase 16: bench_resnet50 (``bench.py:158-185``): ``resnet50()``
    cast with ``bfloat16()``, batch 128 x 3 x 224 x 224 from
    RandomState(0), Momentum(0.1, 0.9, multi_precision), nothing cut.
    The first forward against a float32 reference; two op-by-op steps
    from one state the same bits (loss, every gradient, every BatchNorm
    buffer, velocities and masters), the stem BatchNorm's statistics
    after step 1 against Paddle's update; ``steps`` graphed steps against
    ``steps`` op-by-op ones bitwise, buffers included; no launch of the
    port's kernels (their counts and the profiler); the first loss finite
    and near ln 1000. Logs the replay's wall and imgs/s (median of
    ``timed`` after the capture), the op-by-op step, peak memory and the
    device-busy share of a profiled replay."""
    import math

    import torch

    from paddle_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    config = "bench_resnet50"
    model = train_model(config)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    loss_fn, batch, first = train_batch(model, config)
    B = batch[0].shape[0]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"train-resnet: resnet50 {n_params / 1e6:.2f}M parameters, "
        f"{len(list(model.buffers()))} BatchNorm buffers, bfloat16, batch "
        f"{tuple(batch[0].shape)}, Momentum(0.1, 0.9, multi_precision)")
    resnet_value_check(model, init, batch)
    kernels.reset_launches()
    runs = [resnet_eager_once(model, init, loss_fn, batch)]
    stem_bn_check(model, init, batch[0])
    runs.append(resnet_eager_once(model, init, loss_fn, batch))
    (l1, g1, s1, w1), (l2, g2, s2, w2) = runs
    bad = [n for n in g1 if not torch_equal(g1[n], g2[n])]
    bad += same_bits(s1, s2)
    log(f"train-resnet: two op-by-op steps from one state: losses {l1} and "
        f"{l2}; {len(bad)} of {len(g1)} gradients, {len(s1[0])} parameters "
        f"and buffers and {sum(len(v) for v in s1[1].values())} optimizer "
        f"values differ; walls {w1:.1f} and {w2:.1f} ms [{gpu}]")
    check(l1 == l2 and not bad, f"train-resnet: two op-by-op steps from one "
          f"state differ in the loss or {bad[:4]}")
    check(math.isfinite(l1) and abs(l1 - first) < RESNET_LOSS_NEAR,
          f"train-resnet: first loss {l1} is not within {RESNET_LOSS_NEAR} "
          f"of ln 1000 = {first:.4f}")
    del runs, g1, g2, s1, s2
    out = {}
    for eager in (False, True):
        kind = "op by op" if eager else "graphed"
        torch.cuda.reset_peak_memory_stats()
        step, losses, walls, launches = graph_run(
            model, config, init, loss_fn, [batch] * steps, eager)
        state = snapshot(model, step.optimizer)
        fn = step._eager_step if eager else step
        more = []
        for _ in range(timed):
            t0 = time.perf_counter()
            fn(*batch)
            torch.cuda.synchronize()
            more.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        wall, busy, seen = profiled(lambda: fn(*batch))
        counted = kernels.launches()
        med = sorted(more)[len(more) // 2]
        out[kind] = dict(losses=losses, state=state)
        log(f"train-resnet {kind}: losses {losses}; step wall ms "
            + " ".join(f"{w:.1f}" for w in walls) + "; then "
            + " ".join(f"{w:.1f}" for w in more) + f" (median {med:.2f} ms "
            f"= {B / med * 1e3:.0f} imgs/s); peak memory {peak:.2f} GiB; "
            f"one profiled step: wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms = {busy / wall * 100:.1f}% [{gpu}]")
        zero = dict.fromkeys(kernels.KERNELS, 0)
        check(launches == zero and counted == zero and seen == zero,
              f"train-resnet {kind}: the port's kernels launched "
              f"{launches}, {counted} (profiled step; the profiler saw "
              f"{seen}); ResNet-50 runs none")
        del step
    g, e = out["graphed"], out["op by op"]
    bad = same_bits(g["state"], e["state"])
    check(g["losses"] == e["losses"] and not bad, f"train-resnet: "
          f"graphed losses {g['losses']} vs op by op {e['losses']}; "
          f"{len(bad)} tensors differ, e.g. {bad[:4]}")
    log(f"train-resnet: {steps} graphed steps = {steps} op-by-op steps "
        f"bitwise (losses, {len(g['state'][0])} parameters and buffers, "
        f"every velocity and master); no launch of the port's kernels; "
        f"phase took {time.perf_counter() - t_phase:.1f} s")
    del model, init, out, g, e
    torch.cuda.empty_cache()


# -- phase 17: checkpoints and guarded training (bench_gpt) ------------------

CKPT_CONFIG = "bench_gpt"
CKPT_STEPS = 8          # the reference run's steps
CKPT_AT = 4             # the step saved, killed and resumed from
CKPT_POISONED = 3       # the guarded run's nan_feed hit (1-based)
CKPT_DRILL_LAYERS = 2   # the drills' depth, at gpt_small's width
# the phase writes ~4 bench_gpt checkpoints of ~1.7 GB and the drills'
CKPT_MIN_FREE = 16 * 10 ** 9


def ckpt_loss(model, ids, labels, scale):
    """bench_gpt's loss times a float32 batch item (1 in every batch), the
    item ``nan_feed`` poisons in the guarded runs."""
    from paddle_tpu_torch.models.nlp import gpt

    return gpt.gpt_loss(model, ids, labels) * scale


def ckpt_batches(model, n):
    """``n`` bench_gpt batches from RandomState(0) (the first is
    ``train_batch``'s), each ``(ids, labels, 1.0)``."""
    c, cfg = TRAIN_CONFIGS[CKPT_CONFIG], model.cfg
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        ids = rng.randint(0, cfg.vocab_size, (c["batch"], cfg.max_seq))
        out.append((ids, np.roll(ids, -1, axis=1), np.ones((), np.float32)))
    return out


def timed_calls(fn, batches, each=None):
    """``fn(*b)`` for each batch: ``(losses, host walls ms)``, each call
    ended by a synchronize; ``each(i)`` after call ``i``."""
    import torch

    losses, walls = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        loss = fn(*b)
        losses.append(None if loss is None else float(loss))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if each is not None:
            each(i)
    return losses, walls


def ms_list(walls):
    return " ".join(f"{w:.1f}" for w in walls)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def ckpt_state_diff(path, state):
    """The names whose saved value in checkpoint ``path`` differs from
    snapshot ``state`` (parameters, then ``<name>.<slot>`` of the
    optimizer), and a missing or extra name."""
    import torch

    from paddle_tpu_torch.framework import load

    params, slots = state
    model = load(os.path.join(path, "model.pdparams"))
    opt = load(os.path.join(path, "opt.pdopt"))
    want = dict(params)
    want.update({f"{n}.{k}": v for n, s in slots.items()
                 for k, v in s.items()})
    got = dict(model)
    got.update({k: v for k, v in opt.items() if not k.startswith("@")})
    bad = sorted(set(want) ^ set(got))
    for k, v in want.items():
        if k in got and not torch_equal(
                torch.as_tensor(got[k]).to(v.device), v):
            bad.append(k)
    return bad


def ckpt_reference(gpu, root):
    """Steps 1-8 of bench_gpt from seed 0, a sync checkpoint after step 4;
    then the step-4 checkpoint loaded back into the same model and
    optimizer, and steps 5-8 replayed from it: the same losses and state
    bitwise, and no new capture. Returns the losses, the final state
    (device copies) and the timings."""
    import torch

    from paddle_tpu_torch import core
    from paddle_tpu_torch.framework import (TrainStep, load_checkpoint,
                                            save_checkpoint,
                                            verify_checkpoint)

    sync_dir = os.path.join(root, "sync")
    model = train_model(CKPT_CONFIG)
    opt = train_optimizer(model, CKPT_CONFIG)
    core.seed(1)
    step = TrainStep(model, opt, ckpt_loss)
    batches = ckpt_batches(model, CKPT_STEPS)
    t = {}

    def save_at(i):
        if i + 1 == CKPT_AT:
            t0 = time.perf_counter()
            save_checkpoint(sync_dir, CKPT_AT, model, opt, keep_last=2)
            t["save_ms"] = (time.perf_counter() - t0) * 1e3

    losses, walls = timed_calls(step, batches, save_at)
    final = snapshot(model, opt)
    path = os.path.join(sync_dir, f"ckpt_{CKPT_AT}")
    t["bytes"] = dir_bytes(path)
    t0 = time.perf_counter()
    ok, problems = verify_checkpoint(path)
    t["verify_ms"] = (time.perf_counter() - t0) * 1e3
    check(ok, f"checkpoint: the sync checkpoint fails verification: "
          f"{problems}")
    t["replay_ms"] = walls[2:]
    log(f"checkpoint reference: {CKPT_CONFIG} from seed 0, {CKPT_STEPS} "
        f"graphed steps, losses {losses}; step wall ms {ms_list(walls)}; "
        f"sync save of step {CKPT_AT}: {t['bytes']} bytes on disk in "
        f"{t['save_ms']:.1f} ms ({t['bytes'] / t['save_ms'] / 1e6:.2f} "
        f"GB/s); deep verify {t['verify_ms']:.1f} ms [{gpu}]")
    # the step-4 checkpoint loaded back into this model and optimizer
    graphs, captures = list(step._graphs.values()), step.captures
    t0 = time.perf_counter()
    at = load_checkpoint(sync_dir, model, opt)
    torch.cuda.synchronize()
    t["load_ms"] = (time.perf_counter() - t0) * 1e3
    check(at == CKPT_AT and opt._global_step == CKPT_AT,
          f"checkpoint in-place load: resumed at {at}, global step "
          f"{opt._global_step}, want {CKPT_AT}")
    again, rwalls = timed_calls(step, batches[CKPT_AT:])
    log(f"checkpoint in-place load: step {at} loaded into the live model "
        f"and optimizer in {t['load_ms']:.1f} ms; steps {CKPT_AT + 1}-"
        f"{CKPT_STEPS} replayed: losses {again}, step wall ms "
        f"{ms_list(rwalls)}; graphs captured {step.captures} [{gpu}]")
    check(step.captures == captures and
          list(step._graphs.values()) == graphs and
          all(g is not None for g in graphs),
          f"checkpoint in-place load: it captured again ({step.captures} "
          f"graphs, {captures} before): the load rebound storage")
    check(again == losses[CKPT_AT:], f"checkpoint in-place load: losses "
          f"{again} != the reference's {losses[CKPT_AT:]}")
    bad = same_bits(snapshot(model, opt), final)
    check(not bad, f"checkpoint in-place load: {len(bad)} tensors differ "
          f"from the reference run's, e.g. {bad[:4]}")
    t["replay_ms"] += rwalls[1:]
    del step, model, opt
    torch.cuda.empty_cache()
    return losses, final, t


def ckpt_async(gpu, root, losses, final):
    """The reference run again with an async save after step 4: steps 5-6
    run while the writer writes, ``wait_checkpoints()``; then a second
    async save after step 6 (its snapshot reuses the first one's pinned
    host buffers), steps 7-8, ``wait_checkpoints()``; the same losses and
    final state bitwise. Returns the timings."""
    import torch

    from paddle_tpu_torch import core
    from paddle_tpu_torch.framework import (TrainStep, save_checkpoint,
                                            wait_checkpoints)

    model = train_model(CKPT_CONFIG)
    opt = train_optimizer(model, CKPT_CONFIG)
    core.seed(1)
    step = TrainStep(model, opt, ckpt_loss)
    batches = ckpt_batches(model, CKPT_STEPS)
    t, handle, writing = {}, [], []

    def save_at(i):
        if i + 1 == CKPT_AT:
            t0 = time.perf_counter()
            handle.append(save_checkpoint(os.path.join(root, "async"),
                                          CKPT_AT, model, opt, keep_last=2,
                                          async_=True))
            t["snapshot_ms"] = (time.perf_counter() - t0) * 1e3
        elif i + 1 == CKPT_AT + 2:
            writing.append(not handle[0].done())
            t0 = time.perf_counter()
            wait_checkpoints()
            t["wait_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            save_checkpoint(os.path.join(root, "async_again"), i + 1,
                            model, opt, async_=True)
            t["snapshot_again_ms"] = (time.perf_counter() - t0) * 1e3
        elif i + 1 == CKPT_AT + 1:
            writing.append(not handle[0].done())

    got, walls = timed_calls(step, batches, save_at)
    wait_checkpoints()
    log(f"checkpoint async: step {CKPT_AT} snapshot (device-to-host copies, "
        f"the step path's cost) {t['snapshot_ms']:.1f} ms; steps "
        f"{CKPT_AT + 1}-{CKPT_AT + 2} while the writer wrote "
        f"{ms_list(walls[CKPT_AT:CKPT_AT + 2])} ms (writer still running "
        f"after each: {writing}); then waited {t['wait_ms']:.1f} ms for "
        f"it; a second async snapshot after step {CKPT_AT + 2} (pinned "
        f"buffers reused) {t['snapshot_again_ms']:.1f} ms; losses {got}; "
        f"step wall ms {ms_list(walls)} [{gpu}]")
    check(all(writing), f"checkpoint async: the writer was done before "
          f"steps {CKPT_AT + 1}-{CKPT_AT + 2} ended (running after each: "
          f"{writing}), so they did not overlap it")
    check(got == losses, f"checkpoint async: losses {got} != the "
          f"reference's {losses}")
    bad = same_bits(snapshot(model, opt), final)
    check(not bad, f"checkpoint async: {len(bad)} tensors differ from the "
          f"reference run's, e.g. {bad[:4]}")
    t["writer_ms"] = walls[CKPT_AT:CKPT_AT + 2]
    del step, model, opt
    torch.cuda.empty_cache()
    return t


def ckpt_resume_child(args):
    """In a fresh process: for each ``(source dir, output dir)`` a model,
    optimizer and ``TrainStep`` from seed 1, ``load_checkpoint`` of the
    source, steps 5-8 and a checkpoint of the result at step 8. Prints
    one JSON line of the losses and load times; returns 0."""
    import torch

    from paddle_tpu_torch.framework import (TrainStep, load_checkpoint,
                                            save_checkpoint)
    from paddle_tpu_torch.ops.kernels import _build

    _build.build()
    out = []
    for src, dst in json.loads(args[0]):
        model = train_model(CKPT_CONFIG, seed=1)
        opt = train_optimizer(model, CKPT_CONFIG)
        step = TrainStep(model, opt, ckpt_loss)
        t0 = time.perf_counter()
        at = load_checkpoint(src, model, opt)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        losses, walls = timed_calls(step, ckpt_batches(
            model, CKPT_STEPS)[CKPT_AT:])
        save_checkpoint(dst, CKPT_STEPS, model, opt)
        out.append(dict(at=at, losses=losses, load_ms=load_ms, walls=walls,
                        global_step=opt._global_step))
        del step, model, opt
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def ckpt_resume(gpu, root, losses, final):
    """A fresh Python process resumes from the sync and the async
    checkpoint: each resumed run's steps 5-8 and final state must be the
    reference run's, bitwise. Returns the child's load times."""
    pairs = [(os.path.join(root, kind), os.path.join(root, f"{kind}_out"))
             for kind in ("sync", "async")]
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke;"
            " sys.exit(chip_smoke.ckpt_resume_child(sys.argv[2:]))")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code, here,
                          json.dumps(pairs)], capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"checkpoint resume: the fresh process "
          f"failed ({out.returncode}): {out.stderr[-3000:]}")
    runs = json.loads(out.stdout.strip().splitlines()[-1])
    for (src, dst), r in zip(pairs, runs):
        kind = os.path.basename(src)
        bad = ckpt_state_diff(os.path.join(dst, f"ckpt_{CKPT_STEPS}"),
                              final)
        log(f"checkpoint resume ({kind}, fresh process, model from seed 1):"
            f" loaded step {r['at']} in {r['load_ms']:.1f} ms; steps "
            f"{CKPT_AT + 1}-{CKPT_STEPS} losses {r['losses']}, step wall ms "
            f"{ms_list(r['walls'])}; {len(bad)} saved tensors differ from "
            f"the reference run's [{gpu}]")
        check(r["at"] == CKPT_AT and r["global_step"] == CKPT_STEPS,
              f"checkpoint resume ({kind}): resumed at {r['at']}, ended at "
              f"global step {r['global_step']}")
        check(r["losses"] == losses[CKPT_AT:], f"checkpoint resume "
              f"({kind}): losses {r['losses']} != the reference's "
              f"{losses[CKPT_AT:]}")
        check(not bad, f"checkpoint resume ({kind}): {len(bad)} tensors "
              f"differ from the reference run's, e.g. {bad[:4]}")
    log(f"checkpoint resume: the fresh process took {wall:.1f} s")
    return [r["load_ms"] for r in runs]


def ckpt_guard_check(gpu):
    """``GuardedStep(TrainStep(check_nan=True))`` with ``nan_feed`` at call
    3, under ``skip_step`` and under ``rollback`` with
    ``snapshot_every=1``: 8 calls equal, bitwise, 7 graphed steps that
    never saw batch 3 (losses, parameters, masters, moments and the step
    count), one graph captured. Returns the walls of the guarded and the
    plain replays."""
    import torch

    from paddle_tpu_torch import core
    from paddle_tpu_torch.framework import TrainStep
    from paddle_tpu_torch.resilience import (GuardedStep, RecoveryPolicy,
                                             inject)

    model = train_model(CKPT_CONFIG)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batches = ckpt_batches(model, CKPT_STEPS)

    def fresh():
        model.load_state_dict(init)
        core.seed(1)
        return TrainStep(model, train_optimizer(model, CKPT_CONFIG),
                         ckpt_loss, check_nan=True)

    step = fresh()
    kept = [b for i, b in enumerate(batches) if i + 1 != CKPT_POISONED]
    want, pwalls = timed_calls(step, kept)
    want_state = snapshot(model, step.optimizer)
    want_gstep = step.optimizer._global_step
    out = {"plain": pwalls[2:]}
    del step
    for policy, kw in (("skip_step", {}), ("rollback",
                                           {"snapshot_every": 1})):
        step = fresh()
        guard = GuardedStep(step, RecoveryPolicy(on_nonfinite=policy, **kw))
        with inject.chaos("nan_feed", at=CKPT_POISONED, var=2) as inj:
            got, walls = timed_calls(guard, batches)
        gstep = step.optimizer._global_step
        log(f"checkpoint guard ({policy}{', snapshot_every=1' if kw else ''}"
            f"): nan_feed fired {inj.fired} time(s) at call "
            f"{CKPT_POISONED}; losses {got}; {guard.stats}; call wall ms "
            f"{ms_list(walls)}; graphs captured {step.captures}; the run "
            f"that never saw batch {CKPT_POISONED}: losses {want}, wall ms "
            f"{ms_list(pwalls)} [{gpu}]")
        check(inj.fired == 1 and got[CKPT_POISONED - 1] is None,
              f"checkpoint guard ({policy}): call {CKPT_POISONED} was not "
              f"discarded ({got})")
        check([x for x in got if x is not None] == want,
              f"checkpoint guard ({policy}): losses {got} != the omitted-"
              f"batch run's {want}")
        bad = same_bits(snapshot(model, step.optimizer), want_state)
        check(not bad, f"checkpoint guard ({policy}): {len(bad)} tensors "
              f"differ from the omitted-batch run's, e.g. {bad[:4]}")
        check(gstep == want_gstep, f"checkpoint guard ({policy}): step "
              f"count {gstep} != the omitted-batch run's {want_gstep}")
        check(step.captures == 1 and len(step._graphs) == 1,
              f"checkpoint guard ({policy}): {step.captures} graphs "
              f"captured, {len(step._graphs)} keys: a restore rebound "
              f"storage")
        # the replays: calls after the capture, the poisoned one excepted
        out[policy] = [w for i, w in enumerate(walls)
                       if i >= 2 and i + 1 != CKPT_POISONED]
        del guard, step
    del model, init, want_state
    torch.cuda.empty_cache()
    return out


def ckpt_drills(gpu, root):
    """The reference's checkpoint drills at gpt_small's width and
    ``CKPT_DRILL_LAYERS`` layers (bf16, multi_precision AdamW, one step
    before each save): a truncated, then a bit-flipped, newest checkpoint
    makes ``load_checkpoint`` fall back to the one before (the loaded
    state that one's, bitwise); ``ckpt_crash`` leaves only a
    ``.tmp_ckpt_*`` orphan; an array edited with its file's crc
    regenerated fails ``verify_checkpoint``, which names the array."""
    import binascii
    import shutil
    import warnings

    import torch

    from paddle_tpu_torch.framework import (TrainStep, load,
                                            load_checkpoint, save,
                                            save_checkpoint,
                                            verify_checkpoint)
    from paddle_tpu_torch.models.nlp import gpt
    from paddle_tpu_torch.resilience import SimulatedCrashError, inject

    d = os.path.join(root, "drills")

    def parts(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        cfg = gpt.gpt_small(dropout=0.0)
        cfg.layers = CKPT_DRILL_LAYERS
        m = gpt.GPT(cfg, generator=g).bfloat16()
        return m, train_optimizer(m, CKPT_CONFIG)

    model, opt = parts(0)
    step = TrainStep(model, opt, ckpt_loss)
    batches = ckpt_batches(model, 2)
    step(*batches[0])
    save_checkpoint(d, 1, model, opt)
    one = snapshot(model, opt)
    step(*batches[1])
    for point, cfg in (("ckpt_truncate", {}), ("ckpt_bitflip", {"seed": 5})):
        with inject.chaos(point, **cfg) as inj:
            save_checkpoint(d, 2, model, opt)
        ok, problems = verify_checkpoint(os.path.join(d, "ckpt_2"))
        m2, o2 = parts(1)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            at = load_checkpoint(d, m2, o2)
        fell = any("falling back" in str(x.message) for x in w)
        bad = same_bits(snapshot(m2, o2), one)
        log(f"checkpoint drill {point} ({CKPT_DRILL_LAYERS} layers of "
            f"gpt_small's width): fired {inj.fired}; verify of the newest: "
            f"{problems}; load_checkpoint resumed at step {at} (fell back: "
            f"{fell}); {len(bad)} tensors differ from step 1's [{gpu}]")
        check(inj.fired == 1 and not ok and at == 1 and fell and not bad,
              f"checkpoint drill {point}: no fallback to the intact "
              f"checkpoint")
        shutil.rmtree(os.path.join(d, "ckpt_2"))
        del m2, o2
    with inject.chaos("ckpt_crash"):
        try:
            save_checkpoint(d, 2, model, opt)
            crashed = False
        except SimulatedCrashError:
            crashed = True
    names = sorted(os.listdir(d))
    log(f"checkpoint drill ckpt_crash ({CKPT_DRILL_LAYERS} layers): the "
        f"save raised SimulatedCrashError: {crashed}; the directory holds "
        f"{names}")
    check(crashed and names == [".tmp_ckpt_2", "ckpt_1"],
          f"checkpoint drill ckpt_crash: {names}")
    # one array edited, the file's crc regenerated around it
    path = os.path.join(d, "ckpt_1")
    fpath = os.path.join(path, "model.pdparams")
    state = load(fpath)
    key = sorted(state)[0]
    state[key] = state[key] + 1
    save(state, fpath)
    with open(fpath, "rb") as f:
        blob = f.read()
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["files"]["model.pdparams"] = {
        "size": len(blob), "crc32": binascii.crc32(blob) & 0xFFFFFFFF}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    ok, problems = verify_checkpoint(path)
    log(f"checkpoint drill per-array edit of {key!r} ({CKPT_DRILL_LAYERS} "
        f"layers): verify_checkpoint says {problems}")
    check(not ok and "per-array checksum mismatch" in problems[0]
          and repr(key) in problems[0], f"checkpoint drill per-array edit: "
          f"{problems}")
    del step, model, opt, one
    torch.cuda.empty_cache()


def checkpoint_phase(gpu):
    """Phase 17: bench_gpt's graphed step saved, killed and resumed, and
    guarded; the checkpoint drills."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        log(f"checkpoint: writing under {root} ({free / 1e9:.1f} GB free)")
        check(free >= CKPT_MIN_FREE, f"checkpoint: {free} bytes free under "
              f"{root}, the phase needs {CKPT_MIN_FREE}")
        losses, final, t = ckpt_reference(gpu, root)
        t.update(ckpt_async(gpu, root, losses, final))
        t["child_load_ms"] = ckpt_resume(gpu, root, losses, final)
        del final
        g = ckpt_guard_check(gpu)
        ckpt_drills(gpu, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    log(f"checkpoint: {t['bytes']} bytes on disk; sync save "
        f"{t['save_ms']:.1f} ms; async snapshot {t['snapshot_ms']:.1f} ms "
        f"(again, pinned buffers reused: {t['snapshot_again_ms']:.1f} ms); "
        f"in-place load {t['load_ms']:.1f} ms, fresh-process loads "
        + " ".join(f"{x:.1f}" for x in t["child_load_ms"])
        + f" ms; deep verify {t['verify_ms']:.1f} ms; replay median "
        f"{med(t['replay_ms']):.2f} ms, with the async writer running "
        + (" ".join(f"{x:.1f}" for x in t["writer_ms"]) or "none") + " ms; "
        f"guarded replay median {med(g['skip_step']):.2f} ms (skip_step), "
        f"{med(g['rollback']):.2f} ms (rollback, snapshot_every=1) vs plain "
        f"{med(g['plain']):.2f} ms; phase took "
        f"{time.perf_counter() - t_phase:.1f} s [{gpu}]")


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
        # every module of the fleet and training paths, imported before
        # the check below
        import paddle_tpu_torch.amp  # noqa: F401
        import paddle_tpu_torch.framework  # noqa: F401
        import paddle_tpu_torch.inference  # noqa: F401
        import paddle_tpu_torch.models.nlp.transformer  # noqa: F401
        import paddle_tpu_torch.models.vision  # noqa: F401
        import paddle_tpu_torch.optim.lr  # noqa: F401
        import paddle_tpu_torch.obs  # noqa: F401
        import paddle_tpu_torch.resilience.elastic  # noqa: F401
        import paddle_tpu_torch.resilience.guard  # noqa: F401
        import paddle_tpu_torch.serving.fleet.drill  # noqa: F401
        import paddle_tpu_torch.serving.fleet.worker  # noqa: F401
        import paddle_tpu_torch.utils.envspec  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    check(not any(m.split(".")[0] in ("jax", "paddle_tpu", "ml_dtypes")
                  for m in sys.modules), "the JAX side was imported")
    check({"paddle_tpu_torch.serving.fleet.router",
           "paddle_tpu_torch.serving.fleet.pool",
           "paddle_tpu_torch.serving.fleet.autoscale",
           "paddle_tpu_torch.obs.export", "paddle_tpu_torch.obs.slo",
           "paddle_tpu_torch.obs.timeseries", "paddle_tpu_torch.obs.anomaly",
           "paddle_tpu_torch.obs.reqtrace", "paddle_tpu_torch.obs.fleet"}
          <= set(sys.modules), "a module of the fleet path was not imported")
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

    t0 = t_start = time.perf_counter()
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
    # line keeps the float32 step's cross-entropy rows
    train_timing_phase(gpu, 16384, torch.bfloat16)
    train_errs.update(flash_kernel_phase())
    launches_bf16 = train_bf16_phase(gpu)
    train_t.update(flash_timing_phase(gpu))
    launches_bert = train_bert_phase(gpu)
    # the LayerNorm kernels at bench_bert's shape (64 x 128 rows, bf16):
    # the JSON line's LayerNorm rows, beside the BERT run's launches
    train_t.update(train_timing_phase(gpu, 64 * BERT_SEQ, torch.bfloat16,
                                      V=None))
    torch.cuda.empty_cache()
    fleet_phase(prompts, gpu)
    train_graph_phase(gpu)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    decode_phase(gpu)
    log(f"decode: phase took {time.perf_counter() - t0:.1f} s")
    train_resnet_phase(gpu)
    checkpoint_phase(gpu)

    pa = kernels.KERNELS["paged_decode_attention"]
    rows = [{"name": "paged_decode_attention", "route": "cuda",
             "source": pa.SOURCE,
             "replaces": pa.paged_decode_attention.replaces,
             "launches": launches["paged_decode_attention"], **t}]
    for name, tt in train_t.items():
        # the run whose shape the row was timed at: bench_gpt for flash,
        # bench_bert for LayerNorm, the float32 step for cross-entropy
        ran = {"flash": launches_bf16, "layer": launches_bert}.get(
            name.split("_")[0], launches_f32)
        rows.append({"name": name, "route": "cuda",
                     "source": kernels.KERNELS[name].SOURCE,
                     "replaces": getattr(kernels.KERNELS[name],
                                         name).replaces,
                     "launches": ran[name],
                     "max_abs_err": train_errs[name], **tt})
    log(f"smoke: every phase passed in {time.perf_counter() - t_start:.1f} "
        f"s")
    log(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
