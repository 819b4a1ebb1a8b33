#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving path, its training steps (GPT, BERT,
ResNet-50, VGG-16, MobileNet V1/V2), its serving fleet, the step as one
CUDA graph, its decoding, its checkpointed and guarded training, its
static graph, the serve bench, the int8 Predictor, float16 mixed
precision with recompute, the rest of Paddle's optimizers, initializers
and run reports, its layer library with the book's sentiment nets, the
tensor API with the book's word2vec and recommender nets, the Paddle
user surface and the rest of the op library once on one NVIDIA H100.

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

18. static — the static graph (``static_``): (a) bench_lenet_exec
             (``bench.py:468-529``): LeNet's program recorded in static
             mode at B = 256 (seed 0, a ``RandomState(0)`` batch,
             ``Momentum(0.01, 0.9).minimize``), the startup run, 4
             ``Executor.run`` calls as CUDA graphs (op by op, capture,
             replays) = the program op by op = the eager ``LeNet`` with
             Momentum from the same weights, bitwise in losses,
             parameters and velocities; losses finite, the 4th below
             the 1st; no launch of the port's kernels (10 classes fail
             ``fused_ce_ok``); bench's timing (3 warm and 20 timed
             ``run`` calls, ``run_steps`` with K = 8); ``run_steps``'s
             fetches (op by op, captured, replayed) = 8 sequential
             ``run`` calls' bitwise; one compile and one capture each
             for ``run`` and ``run_steps``. (b) In a fresh Python
             process (its profiler keeps what a late one in this process
             loses): a static ``Linear(768 -> 768)`` -> ``LayerNorm(768)``
             -> ``Linear(768 -> 50304)`` -> ``cross_entropy`` program
             over 8192 float32 rows with its ``append_backward``: ``layer_norm`` and the fused
             ``cross_entropy_hard`` one op each; every call (op by op,
             the capture's replay, a profiled replay) launches the LN
             and CE kernels once each way, by the wrappers' counts and
             the profiler; loss and gradients = the eager modules'
             bitwise. It logs ``step_ms``, imgs/s, ``fused_step_ms``,
             the op-by-op step and ``compiled_calls``.

19. serve-bench — bench_serve (``bench.py:304-465``) through
             ``tools/torch_serve_bench.py``'s ``bench_serve_leg``: 48
             requests of an open-loop Poisson trace at 100 req/s, tenants
             ``a:rate=75,weight=3;b:rate=25,weight=1``, 256 pages of 16,
             journaled and evaluated against ``SERVE_SLO_SPEC``, the
             live ``/metrics`` scrape over localhost, and 24 requests
             through a two-replica Router; (a) at bench's TinyLM (vocab
             32, 2 x 8), (b) the same trace at the engine phase's full
             width. Each: every request finished (none rejected or
             stuck) with the dense oracle's tokens, no SLO violated, the
             scraped gauge right, one paged launch for each decode step
             of each engine; then the trace replayed on a ``ManualClock``
             through one full-width engine, with the same checks. It
             prints each run's dict on a line.

20. int8   — bench_int8_predictor (``bench.py:246-293``): LeNet +
             ``F.softmax`` at B = 256, seed 0, ``save_inference_model``,
             ``quantize_inference_model`` (its int8 arrays and scales =
             ``quantize_abs_max`` of the saved weights), an fp32 and an
             int8 ``Predictor`` (one CUDA graph a feed signature), 3
             warm-up and 20 timed calls each: bench's imgs/s, their
             ratio and ``max_prob_diff`` (< ``INT8_PROB_TOL``); each
             Predictor's replay = its op-by-op run bitwise, the fp32 one
             = ``Executor.run`` bitwise; one capture each; none of the
             port's kernels launched; the busy share of a profiled
             window of calls.

21. amp    — float16 mixed precision and recompute (``amp_phase``):
             every kernel's float16 variant against its plain version
             (flash's backward also with dO at 2^13 x unit scale, where
             the plain float32 dS passes float16's range: dQ/dK/dV
             finite wherever the plain ones are), and a routed float16
             LayerNorm launching its kernel; (a) bench_gpt (float32
             parameters) under ``auto_cast(dtype="float16")`` with
             ``DynamicLossScaler()`` in ``TrainStep``, 4 graphed steps =
             4 op-by-op steps bitwise (and the scaler's state), launches
             12/12/12 float16 flash, 25/25 float32 LayerNorm and 1/1
             float32 cross-entropy a step, the plain versions' losses
             within ``F16_TRAIN_LOSS_TOL``; (b) the same at O2 float16
             (``amp.decorate``, multi_precision AdamW), every kernel in
             float16; (c) bench_bert under O1 float16, LayerNorm
             26/26 a step in float32; (d) bench_gpt with
             ``use_recompute=True``: bitwise the run without, the
             blocks' forward launched twice, peak memory of both; (e)
             static AMP (``static_decorator.decorate(dtype="float16")``)
             on phase 18's LeNet and LN/CE programs, graphed = op by op
             bitwise, ``@amp@scale`` by the reference's rule; then the
             float16 kernels timed at bench_gpt's shapes (the JSON
             line's ``[float16]`` rows).

22. rare   — the rest of Paddle's optimizers, initializers and reports
             (``rare_phase``): Ftrl, DecayedAdagrad, LarsMomentum,
             DGCMomentum and Dpsgd each against its plain float64
             formula on a (768, 3072) weight (``rule_value_check``,
             within ``RULE_TOL``); then bench_gpt's step (phase 10's
             configuration) under each of them in AdamW's place: 4
             graphed steps = 4 op-by-op steps bitwise from one generator
             seed (Dpsgd's noise included), launches 25/25/1/1/12/12/12
             a step, finite losses, 5 replays timed beside AdamW's, every
             step journaled; Dpsgd's noise new at each replay
             (``dpsgd_noise_check``); ``ExponentialMovingAverage`` and
             ``ModelAverage`` after each replay of AdamW's step, their
             ``apply()`` = their plain arithmetic and ``restore()`` the
             trained parameters bitwise; ``LookAhead(AdamW, k=2)`` over 4
             eager steps, its pulls = the plain formula; each random
             initializer filling a (768, 3072) weight on the card, held
             to its law (``init_check``); a static LeNet ``Executor.run``,
             ``run_steps`` and a ``Predictor.run`` under a journal; then
             the five report tools over the journals of phases 13, 19
             and 22 (``report_check``).
23. layers — Paddle's layer library (``layers_phase``): (a) the book's
             stacked LSTM (``StackedLSTMSentiment``: embed 128, hidden
             128, 3 layers, dropout 0.2) and (b) its text-CNN
             (``ConvSentiment``: 128 filters of widths 3 and 4) at
             vocabulary 5148, batch 128 x 63 ids from RandomState(0)
             (lengths 16-63, padded with 0; the LSTM reads them as
             ``seq_len`` on the card), each 4 steps of Adam(1e-2)
             through ``TrainStep`` graphed = op by op bitwise (losses,
             parameters, Adam's moments), losses finite, the first
             within ``SENT_REF_TOL`` of a float64 CPU forward of the same
             weights and dropout mask (the LSTM's also near ln 2), no
             launch of the port's kernels, then 5 calls of each
             timed and a replay profiled; (c) every layer class at a
             small size on the card against the CPU (``LAYER_F32_TOL``),
             forward and backward, run twice: the classes whose bits
             move are printed, and none of (a)'s or (b)'s may be among
             them.
24. tensor — the Paddle tensor API (``tensor_phase``): first the JAX
             package's rules torch's ops do not keep (``scatter``'s
             repeated index, descending ``argsort``, ``topk``, ``median``,
             ``mode`` and ``kthvalue`` under ties, ``svd``'s V, a
             rank-deficient ``lstsq``, ``empty``); (a) the book's
             ``NGramLM(2074)`` (embed 32, hidden 256, 4 context words),
             ``SkipGram(2074)`` (embed 64, 1 true + 4 negatives),
             ``TwoTowerRecommender(944, 1683)`` (embed 32, hidden 200)
             and ``DeepFM`` over the six MovieLens fields (embed 16,
             hidden 400 x 3) at batch 256 from RandomState(0), each 4
             Adam steps through ``TrainStep`` graphed = op by op bitwise,
             the first loss within ``REC_REF_TOL`` of a float64 CPU
             forward, no launch of the port's kernels, 5 calls timed and
             a replay profiled; (b) DeepFM and the 3-layer stacked LSTM
             (phase 23's widths and batch, no ``sequence_length``: one
             ``rnn_scan`` op a layer) as static Programs through the
             ``Executor``, graphed = op by op bitwise, the DeepFM program
             within ``STATIC_REC_TOL`` of (a)'s run from the same
             weights, the LSTM's replay beside phase 23's; (c) every
             exported tensor-API name at a small size on the card
             against the CPU (``LAYER_F32_TOL``), forward and backward,
             run twice (repeated indices for the scatters and the
             gathers' backwards): the names whose bits move and the
             names that read back to the host are printed, and none of
             (a)'s or (b)'s may move; (d) ``cond`` on a value on the card
             inside ``TrainStep``: never captured (``uncaptured`` names
             it), each loss the branch its flag picks, a captured
             ``run_fused`` over it raising ``RuntimeError``; ``scan``
             captured and replayed = op by op bitwise.
25. surface — ``tools/paddle_gpt_script.py`` at bench_gpt's widths
             through the Paddle user surface (``surface_phase``).
26. vision — (a) ``vgg16()``, ``MobileNetV1()`` and ``MobileNetV2()``
             at full width as bench_resnet50 trains ResNet-50 (224 x 224,
             1000 classes, their default dropout, batch 128 from
             RandomState(0), ``bfloat16()``, Momentum(0.1, 0.9) with
             masters; ``vision_phase``): the first forward against a
             float32 ``torch.nn.functional`` reference (logits, loss near
             ln 1000 with dropout off, each conv against a float32 conv
             of its input), two op-by-op steps the same bits, 4 graphed
             steps = 4 op-by-op steps bitwise (buffers, velocities,
             masters), no launch of the port's kernels, replay and
             op-by-op walls, imgs/s, peak memory, a profiled step's busy
             share and device time by group; (b) channels-last
             ``conv2d`` at ResNet-50's and MobileNetV2's shapes against
             the NCHW call, ``deformable_conv`` at a 64-channel 56 x 56
             map against the CPU, and every name of the op library's rest on
             the card against the CPU, each run twice (bits that move
             printed).

It prints the card's name and power limit, a ``{"kernels": [...]}``
line, and as its last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or away from the repo, it exits non-zero and prints no
result.
"""
import contextlib
import itertools
import json
import os
import subprocess
import sys
import time
import warnings

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
FLASH_F16_STEP = 2 ** -10      # a float16 keeps 11 significant bits
# float16 kernels against their plain versions (LayerNorm's y and dx, the
# cross-entropy's dlogits, the paged decode): two float16 steps
FP16_TOL = 2 ** -9
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
    # phase 26: bench_resnet50's recipe for the other ImageNet models, each
    # at its default dropout (VGG 0.5, MobileNetV2 0.2, MobileNetV1 none)
    "bench_vgg16": dict(model="vgg16", dropout=0.5, bfloat16=True,
                        batch=128, multi_precision=True),
    "bench_mobilenet_v1": dict(model="mobilenet_v1", dropout=0.0,
                               bfloat16=True, batch=128,
                               multi_precision=True),
    "bench_mobilenet_v2": dict(model="mobilenet_v2", dropout=0.2,
                               bfloat16=True, batch=128,
                               multi_precision=True),
}
# the image classifiers: bench_resnet50's optimizer, batch and loss
IMAGE_MODELS = ("resnet50", "vgg16", "mobilenet_v1", "mobilenet_v2")
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


def fleet_drill(gpu, root=None):
    """The kill drill on the card: two worker processes at FLEET_DRILL,
    replica 1 killed by ``replica_kill`` mid-decode and relaunched. Every
    drill assertion must hold, every incarnation's journal must name this
    card, and the survivor's decode steps after its ready line must each
    have launched the paged kernel once. With ``root`` the drill's
    journals stay under ``root/run`` for phase 22."""
    import torch

    from paddle_tpu_torch.serving.fleet import drill

    rng = np.random.RandomState(1)
    trace = [([int(t) for t in rng.randint(0, FULL["vocab_size"], n)], 32)
             for n in rng.randint(128, 513, drill.N_REQUESTS)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = drill.run_drill(geometry=FLEET_DRILL, trace=trace, root=root)
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


def fleet_phase(prompts, gpu, journals=None):
    launches = fleet_local(prompts, 32, gpu)
    fleet_drill(gpu, journals and os.path.join(journals, "fleet_drill"))
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


def image_model(name, device="cuda", generator=None, **kw):
    """The image classifier ``name`` of ``IMAGE_MODELS`` at its defaults
    (``kw`` overrides them: ``scale``, ``num_classes``, ``dropout``)."""
    from paddle_tpu_torch.models import vision

    make = {"resnet50": vision.resnet50, "vgg16": vision.vgg16,
            "mobilenet_v1": vision.MobileNetV1,
            "mobilenet_v2": vision.MobileNetV2}[name]
    return make(device=device, generator=generator, **kw)


def train_model(config, seed=0):
    """``TRAIN_CONFIGS[config]``'s model on the card, weights from
    ``seed``: ``gpt_small``, ``BertForPretraining(bert_base())`` or an
    image model (``image_model``)."""
    import torch

    from paddle_tpu_torch.models.nlp import bert, gpt

    c = TRAIN_CONFIGS[config]
    g = torch.Generator(device="cuda").manual_seed(seed)
    if c["model"] in IMAGE_MODELS:
        model = image_model(c["model"], generator=g)
    elif c["model"] == "bert_base":
        model = bert.BertForPretraining(bert.bert_base(dropout=c["dropout"]),
                                        generator=g)
    else:
        model = gpt.GPT(gpt.gpt_small(dropout=c["dropout"]), generator=g)
    return model.bfloat16() if c["bfloat16"] else model


def train_optimizer(model, config):
    """AdamW(1e-4, decay 0.01, global-norm clip 1.0) over ``model``, with
    ``TRAIN_CONFIGS[config]``'s multi_precision; for the image models
    bench_resnet50's ``Momentum(0.1, 0.9, multi_precision=True)``."""
    from paddle_tpu_torch import optim

    if TRAIN_CONFIGS[config]["model"] in IMAGE_MODELS:
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
    ln V + ln 2 (MLM plus NSP). The image models as ``bench.py:172-174``
    builds ResNet-50's: batch x 3 x 224 x 224 float32 images, then int32
    labels of 1000 classes; the first loss near ln 1000."""
    import math

    from paddle_tpu_torch.models.nlp import bert, gpt

    c = TRAIN_CONFIGS[config]
    rng = np.random.RandomState(0)
    if c["model"] in IMAGE_MODELS:
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
    from paddle_tpu_torch import core
    from paddle_tpu_torch.framework import TrainStep
    from paddle_tpu_torch.ops import kernels

    model.load_state_dict(init)
    core.seed(1)
    opt = (make_opt or (lambda m: train_optimizer(m, config)))(model)
    step = TrainStep(model, opt, loss_fn, scaler=scaler)
    fn = step._eager_step if eager else step
    losses, walls = [], []
    sync()
    kernels.reset_launches()
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        losses.append(float(fn(*b)))
        sync()
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


def flash_timing_phase(gpu, dtype=None):
    """Kernel, plain version and library call for each flash kernel at
    the bench_gpt shape (B = 16, H = 12, L = 1024, D = 64, causal, in
    ``dtype``: bfloat16 unless given), beside the least time the card
    could take: the bytes each must move (every input read once, every
    output written once) over 3.35 TB/s against the operations the
    causal half needs over the tensor-core rate (989 TFLOP/s in bfloat16
    and in float16). In bfloat16 also the forward at bench_bert's eval
    shape."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    dtype = dtype or torch.bfloat16
    dname = str(dtype).split(".")[-1]
    B, H, L, D = 16, 12, 1024, 64
    BH, scale = B * H, 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, do = (torch.randn(B, H, L, D, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    delta = fa.flash_delta(o, do)
    args = (q, k, v, do, lse, delta, True, scale)
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    pairs = BH * L * (L + 1) // 2        # (query, key) pairs under the mask
    t = BH * L * D * 2                   # one 16-bit (BH, L, D) tensor
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
        log(f"timing {name} B*H={BH} L={L} D={D} {dname} causal: kernel "
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
    log(f"timing flash backward (dQ + dK/dV) B*H={BH} L={L} D={D} {dname} "
        f"causal: kernels {ms:.4f} ms (again {ms2:.4f}), library backward "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms = "
        f"{bound / min(ms, ms2) * 100:.2f}% of roofline [{gpu}]")
    if dtype != torch.bfloat16:
        return out
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
    """``image_value_check`` of ResNet-50 against
    ``resnet_reference_forward``."""
    return image_value_check("train-resnet", model, init, batch,
                             resnet_reference_forward)


def image_value_check(label, model, init, batch, reference, first=None):
    """The first step's forward, in bfloat16 through the port, against
    ``reference`` (the float32 forward of the same weights, written with
    ``torch.nn.functional``): logits within RESNET_LOGIT_TOL of the
    reference's largest |logit|, losses within RESNET_LOSS_TOL, and the
    loss within RESNET_LOSS_NEAR of ``first`` when given (ln 1000: logits
    near uniform at init); dropout off for both (the reference draws no
    masks; VGG's two dropouts at 0.5 lift its first training loss to
    9.04 from 7.41 without them, on the card). At random weights
    BatchNorm and the global pool leave the logits little sensitive to
    what a conv does (ResNet-50's weights read transposed moved them by
    0.27 of the largest |logit|, against 0.13 for bfloat16's roundings),
    so each conv's output is also held, during that forward, to
    ``torch.nn.functional.conv2d`` in float32 of its own bfloat16 input,
    weight and bias, with the stride, padding, dilation and groups its
    module declares: within RESNET_CONV_TOL of the largest |value| (one
    bfloat16 rounding of each output). A conv that pads or reads its
    weight wrongly fails that. Returns (logit error share, loss
    difference, the worst conv's error share)."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.layers import Conv2D, Dropout

    dev = next(model.parameters()).device
    x, y = (torch.from_numpy(a).to(dev) for a in batch)
    convs = []

    def held(module, inputs, out):
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            ref = TF.conv2d(inputs[0].float(), module.weight.float(),
                            None if module.bias is None else
                            module.bias.float(), stride=module._stride,
                            padding=module._padding,
                            dilation=module._dilation,
                            groups=module._groups)
        convs.append(((out.float() - ref).abs().max()
                      / ref.abs().max()).item())

    model.load_state_dict(init)
    hooks = [m.register_forward_hook(held) for m in model.modules()
             if isinstance(m, Conv2D)]
    drops = [(m, m.p) for m in model.modules() if isinstance(m, Dropout)]
    for m, _ in drops:
        m.p = 0.0
    try:
        with torch.no_grad():
            got = model(x.to(torch.bfloat16)).float()
    finally:
        for h in hooks:
            h.remove()
        for m, p in drops:
            m.p = p
    with torch.no_grad():
        loss = F.cross_entropy(got, y).item()
        ref = reference({k: v.float() for k, v in init.items()}, x)
        ref_loss = torch.nn.functional.cross_entropy(ref, y.long()).item()
    model.load_state_dict(init)     # the forward moved the statistics
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    log(f"{label}: first forward, bf16 logits vs a float32 forward of "
        f"the same weights: max |diff| {err:.3e} of the largest |logit| "
        f"{ref.abs().max().item():.3f} (tol {RESNET_LOGIT_TOL}); loss "
        f"{loss:.5f} vs {ref_loss:.5f} (tol {RESNET_LOSS_TOL}); each of "
        f"{len(convs)} convs vs a float32 conv of its input: worst "
        f"{max(convs):.3e} of its largest |value| (tol {RESNET_CONV_TOL})")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits")
    check(max(convs) <= RESNET_CONV_TOL, f"{label}: conv "
          f"{convs.index(max(convs))} differs from a float32 conv of its "
          f"input by {max(convs):.3e} of its largest |value|")
    check(err <= RESNET_LOGIT_TOL, f"{label}: the bf16 logits differ "
          "from the float32 reference's")
    check(abs(loss - ref_loss) <= RESNET_LOSS_TOL, f"{label}: the loss "
          "differs from the float32 reference's")
    check(first is None or abs(loss - first) < RESNET_LOSS_NEAR,
          f"{label}: the first loss {loss} (dropout off) is not within "
          f"{RESNET_LOSS_NEAR} of {first}")
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


def image_eager_once(model, init, loss_fn, batch, config):
    """One op-by-op step of ``config`` from ``init`` with a new optimizer
    and the dropout generator reseeded: (loss, the gradients, snapshot,
    wall ms)."""
    from paddle_tpu_torch import core
    from paddle_tpu_torch.framework import TrainStep

    model.load_state_dict(init)
    core.seed(1)
    opt = train_optimizer(model, config)
    step = TrainStep(model, opt, loss_fn)
    sync()
    t0 = time.perf_counter()
    loss = float(step._eager_step(*batch))
    wall = (time.perf_counter() - t0) * 1e3
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss, grads, snapshot(model, opt), wall


# an op-by-op step's device time by group (device_ms_by_op): the first
# group whose names appear on the stack of the op that launched a kernel
# (the profiler ranges port::<op> that step_ranges puts around
# nn.functional's ops, the optimizer's update, autograd's nodes) takes it
STEP_GROUPS = (("optimizer", ("optimizer.step",)),
               ("loss", ("port::cross_entropy", "LogSoftmax", "NllLoss")),
               ("batch_norm", ("port::batch_norm", "_BatchNormTrain")),
               ("depthwise_conv", ("port::depthwise_conv2d",)),
               ("conv", ("port::conv2d", "_Conv")),
               ("linear", ("port::linear", "MmBackward", "AddmmBackward")),
               ("pooling", ("port::max_pool2d", "port::adaptive_avg_pool2d",
                            "MaxPool2D", "MeanBackward")),
               ("activation", ("port::relu", "port::relu6", "ReluBackward",
                               "Hardtanh", "ClampBackward")),
               ("dropout", ("port::dropout",)))
STEP_RANGES = ("cross_entropy", "batch_norm", "conv2d", "linear",
               "max_pool2d", "adaptive_avg_pool2d", "relu", "relu6",
               "dropout")


def is_step_range(name):
    """Whether ``name`` is a profiler range of ``step_ranges`` (it shows
    on the device's timeline too, and its time is its kernels')."""
    return name == "optimizer.step" or name.startswith("port::")


@contextlib.contextmanager
def step_ranges(optimizer):
    """While the block runs, each call of ``nn.functional``'s
    ``STEP_RANGES`` (a conv of more than one group as
    ``depthwise_conv2d``) runs inside a profiler range ``port::<op>``,
    and ``optimizer``'s update inside ``optimizer.step``."""
    from torch.profiler import record_function

    from paddle_tpu_torch.nn import functional as PF

    real = {n: getattr(PF, n) for n in STEP_RANGES}

    def ranged(n, fn):
        def wrapped(*a, **k):
            name = n
            if n == "conv2d" and int(k.get("groups", 1)) > 1:
                name = "depthwise_conv2d"
            with record_function(f"port::{name}"):
                return fn(*a, **k)
        return wrapped

    apply = optimizer._apply

    def ranged_apply(*a, **k):
        with record_function("optimizer.step"):
            return apply(*a, **k)

    for n, fn in real.items():
        setattr(PF, n, ranged(n, fn))
    optimizer._apply = ranged_apply
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(PF, n, fn)
        del optimizer._apply


def _step_group(event, kernel):
    """The group of one kernel of CPU op ``event`` (``STEP_GROUPS``): a
    conv's kernels split into forward, dgrad and wgrad, and PyTorch's own
    depthwise kernels (named so) into the depthwise group; BatchNorm's
    into its reductions and its elementwise passes."""
    names, e = [], event
    while e is not None:
        names.append(e.name)
        e = e.cpu_parent
    names = " ".join(names)
    if any(k in kernel for k in ("Memcpy", "memcpy", "Memset")):
        return "copy"
    group = next((g for g, keys in STEP_GROUPS
                  if any(k in names for k in keys)), "other")
    if group in ("conv", "depthwise_conv"):
        if "depthwise" in kernel:
            group = "depthwise_conv"
        part = ("dgrad" if "dgrad" in kernel or "backward" in kernel.lower()
                else "wgrad" if "wgrad" in kernel or "grad_weight" in kernel
                else "backward" if "Backward" in names else "forward")
        return f"{group}_{part}"
    if group == "batch_norm":
        low = kernel.lower()
        return ("batch_norm_reductions" if "reduce" in low or "welford" in low
                else "batch_norm_elementwise")
    return group


def device_ms_by_op(prof):
    """Of a profile taken under ``step_ranges``: device ms by group
    (``STEP_GROUPS``), each kernel put with the op that launched it, or
    ``None`` when the profiler linked no kernel to an op; and device ms
    by (group, kernel name)."""
    out, names = {}, {}
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            g = _step_group(e, k.name)
            out[g] = out.get(g, 0.0) + k.duration / 1e3
            key = (g, k.name[:60])
            names[key] = names.get(key, 0.0) + k.duration / 1e3
    return out or None, names


def step_breakdown(step, batch):
    """``device_ms_by_op`` of one op-by-op step of the ``TrainStep``
    ``step`` (its groups), with the three longest kernels of each of the
    three longest groups logged."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with step_ranges(step.optimizer), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)     # see profiled
        step._eager_step(*batch)
        sync()
        time.sleep(0.2)
    out, names = device_ms_by_op(prof)
    for g in sorted(out or {}, key=lambda g: -out[g])[:3]:
        top = sorted(((ms, n) for (gg, n), ms in names.items() if gg == g),
                     reverse=True)[:3]
        log(f"  {g}: " + "; ".join(f"{n} {ms:.2f} ms" for ms, n in top))
    return out


def sync():
    """Wait for the card, where there is one (a phase's checks also run
    on the CPU, in the tests)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def image_train_check(label, config, model, init, loss_fn, batch, first,
                      gpu, reference, steps=4, timed=5, after_first=None):
    """The checks phases 16 and 26 make of an image model's training
    step, ``config``'s optimizer from the weights ``init``: the first
    forward against ``reference`` and its loss near ``first``
    (``image_value_check``), two op-by-op
    steps from one state (``eager_repeat_check``), graphed against op by
    op (``graph_compare_check``). Returns the latter's numbers."""
    image_value_check(label, model, init, batch, reference, first)
    eager_repeat_check(label, config, model, init, loss_fn, batch, gpu,
                       after_first)
    return graph_compare_check(label, config, model, init, loss_fn, batch,
                               gpu, steps, timed)


def eager_repeat_check(label, config, model, init, loss_fn, batch, gpu,
                       after_first=None):
    """Two op-by-op steps of ``config`` from ``init`` give the same bits
    (loss, every gradient, every BatchNorm buffer, velocities and
    masters; ``after_first(model, init, images)`` runs after the first),
    and the first loss is finite."""
    import math

    from paddle_tpu_torch.ops import kernels

    kernels.reset_launches()
    runs = [image_eager_once(model, init, loss_fn, batch, config)]
    if after_first is not None:
        after_first(model, init, batch[0])
    runs.append(image_eager_once(model, init, loss_fn, batch, config))
    (l1, g1, s1, w1), (l2, g2, s2, w2) = runs
    bad = [n for n in g1 if not torch_equal(g1[n], g2[n])]
    bad += same_bits(s1, s2)
    log(f"{label}: two op-by-op steps from one state: losses {l1} and "
        f"{l2}; {len(bad)} of {len(g1)} gradients, {len(s1[0])} parameters "
        f"and buffers and {sum(len(v) for v in s1[1].values())} optimizer "
        f"values differ; walls {w1:.1f} and {w2:.1f} ms [{gpu}]")
    check(l1 == l2 and not bad, f"{label}: two op-by-op steps from one "
          f"state differ in the loss or {bad[:4]}")
    check(math.isfinite(l1), f"{label}: first loss {l1}")


def graph_compare_check(label, config, model, init, loss_fn, batch, gpu,
                        steps=4, timed=5):
    """``steps`` graphed steps of ``config`` from ``init`` against
    ``steps`` op-by-op ones (``graph_run``, the dropout generator
    reseeded for each): the same losses and bits in every parameter,
    BatchNorm buffer, velocity and master; no launch of the port's
    kernels (their counts, and on the card the profiler). On the card it
    also logs each run's step walls, ``timed`` more steps (median,
    imgs/s), peak memory, a profiled step's device-busy share and, for
    the op-by-op run, the device time by group (``step_breakdown``).
    Returns the numbers it logged by run. (On the CPU, as in the tests,
    ``TrainStep`` has no graph: both runs go op by op.)"""
    import torch

    from paddle_tpu_torch.ops import kernels

    card = next(model.parameters()).device.type == "cuda"
    B = batch[0].shape[0]
    out, zero = {}, dict.fromkeys(kernels.KERNELS, 0)
    for eager in (False, True):
        kind = "op by op" if eager else "graphed"
        if card:
            torch.cuda.reset_peak_memory_stats()
        step, losses, walls, launches = graph_run(
            model, config, init, loss_fn, [batch] * steps, eager)
        out[kind] = dict(losses=losses, state=snapshot(model,
                                                       step.optimizer))
        check(launches == zero, f"{label} {kind}: the port's kernels "
              f"launched {launches}; an image model runs none")
        if card:
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
            out[kind].update(walls=walls, more=more, median=med,
                             imgs_per_s=B / med * 1e3, peak_gib=peak,
                             prof_wall=wall, busy=busy)
            log(f"{label} {kind}: losses {losses}; step wall ms "
                + " ".join(f"{w:.1f}" for w in walls) + "; then "
                + " ".join(f"{w:.1f}" for w in more) + f" (median "
                f"{med:.2f} ms = {B / med * 1e3:.0f} imgs/s); peak memory "
                f"{peak:.2f} GiB; one profiled step: wall {wall:.2f} ms, "
                f"device busy {busy:.2f} ms = {busy / wall * 100:.1f}% "
                f"[{gpu}]")
            check(counted == zero and seen == zero, f"{label} {kind}: the "
                  f"port's kernels launched {counted} in the profiled "
                  f"step (the profiler saw {seen}); an image model runs "
                  f"none")
            if eager:
                groups = step_breakdown(step, batch)
                out[kind]["groups"] = groups
                log(f"{label} op by op, device ms by group: " + (
                    "the profiler linked no kernel to an op" if not groups
                    else ", ".join(f"{g} {ms:.2f}" for g, ms in sorted(
                        groups.items(), key=lambda kv: -kv[1])))
                    + f" [{gpu}]")
        del step
    g, e = out["graphed"], out["op by op"]
    bad = same_bits(g["state"], e["state"])
    check(g["losses"] == e["losses"] and not bad, f"{label}: "
          f"graphed losses {g['losses']} vs op by op {e['losses']}; "
          f"{len(bad)} tensors differ, e.g. {bad[:4]}")
    log(f"{label}: {steps} graphed steps = {steps} op-by-op steps "
        f"bitwise (losses, {len(g['state'][0])} parameters and buffers, "
        f"every velocity and master); no launch of the port's kernels")
    for v in out.values():
        del v["state"]
    return out


def image_phase(label, config, gpu, reference, after_first=None):
    """``image_train_check`` of ``TRAIN_CONFIGS[config]`` (an image model
    from seed 0, ``bfloat16()``, its batch from RandomState(0)) on the
    card; logs the model's size and the phase's time."""
    import torch

    t_phase = time.perf_counter()
    model = train_model(config)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    loss_fn, batch, first = train_batch(model, config)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{label}: {TRAIN_CONFIGS[config]['model']} {n_params / 1e6:.2f}M "
        f"parameters, {len(list(model.buffers()))} BatchNorm buffers, "
        f"bfloat16, batch {tuple(batch[0].shape)}, dropout "
        f"{TRAIN_CONFIGS[config]['dropout']}, Momentum(0.1, 0.9, "
        f"multi_precision)")
    out = image_train_check(label, config, model, init, loss_fn, batch,
                            first, gpu, reference, after_first=after_first)
    log(f"{label}: phase took {time.perf_counter() - t_phase:.1f} s")
    del model, init
    torch.cuda.empty_cache()
    return out


def train_resnet_phase(gpu):
    """Phase 16: bench_resnet50 (``bench.py:158-185``): ``resnet50()``
    cast with ``bfloat16()``, batch 128 x 3 x 224 x 224 from
    RandomState(0), Momentum(0.1, 0.9, multi_precision), nothing cut,
    through ``image_train_check`` against ``resnet_reference_forward``,
    the stem BatchNorm's statistics after step 1 against Paddle's update
    (``stem_bn_check``)."""
    return image_phase("train-resnet", "bench_resnet50", gpu,
                       resnet_reference_forward, after_first=stem_bn_check)


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


# -- phase 18: the static graph (bench_lenet_exec; LN/CE through it) ---------

LENET_BATCH = 256         # bench.py:bench_lenet_exec's B
LENET_STEPS = 4           # graphed = op by op = eager over these
LENET_WARM, LENET_ITERS = 3, 20    # bench.py:499 (not SMOKE)
LENET_K = 8               # bench_lenet_exec's K
STATIC_LN_CE = dict(rows=8192, hidden=768, vocab=50304)
STATIC_LN_CE_CALLS = 3    # warm, capture + replay, a profiled replay
# one replay of phase 18(b)'s program: LN and CE, forward and backward
STATIC_LN_CE_LAUNCHES = {"layer_norm_fwd": 1, "layer_norm_bwd": 1,
                         "softmax_ce_fwd": 1, "softmax_ce_bwd": 1}


def lenet_program(B=LENET_BATCH):
    """bench_lenet_exec's program (``bench.py:474-496``) in a Scope and a
    name generator of its own: ``(main, startup, loss, model, scope)``,
    the model's parameter Variables in the Scope on the card."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import optim
    from paddle_tpu_torch.models.vision import LeNet
    from paddle_tpu_torch.utils import unique_name

    scope = pt.static.Scope()
    pt.seed(0)
    with unique_name.guard(), pt.static.scope_guard(scope):
        pt.enable_static()
        try:
            main, startup = pt.static.Program(), pt.static.Program()
            with pt.program_guard(main, startup):
                xv = pt.static.data("x", [B, 1, 28, 28], "float32")
                yv = pt.static.data("y", [B], "int64")
                model = LeNet()
                loss = F.cross_entropy(model(xv), yv)
                optim.Momentum(0.01, 0.9,
                               parameters=model.parameters()).minimize(loss)
        finally:
            pt.disable_static()
    return main, startup, loss, model, scope


def lenet_batch(B=LENET_BATCH):
    rng = np.random.RandomState(0)
    return (rng.randn(B, 1, 28, 28).astype("float32"),
            rng.randint(0, 10, (B,)).astype("int64"))


def scope_state(main, scope):
    """Copies of the program's persistables in ``scope``."""
    return {n: scope.find_var(n).clone()
            for n, v in main.global_block.vars.items() if v.persistable}


def restore_scope(scope, state):
    for n, t in state.items():
        scope.find_var(n).copy_(t)


def lenet_eager(model_vars, init, x, y, steps):
    """``steps`` eager steps of the port's ``LeNet`` under
    ``Momentum(0.01, 0.9)`` from the static model's weights ``init``:
    ``(losses, {static name: parameter}, {static name: velocity})``."""
    import torch

    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import optim
    from paddle_tpu_torch.models.vision import LeNet

    model = LeNet()
    names = [v.name for v in model_vars]
    with torch.no_grad():
        for n, p in zip(names, model.parameters()):
            p.copy_(init[n])
    opt = optim.Momentum(0.01, 0.9, parameters=model.parameters())
    xt, yt = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    losses = []
    for _ in range(steps):
        loss = F.cross_entropy(model(xt), yt)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    params = dict(zip(names, model.parameters()))
    vel = {n: opt._accumulators[key]["velocity"]
           for n, (key, _) in zip(names, opt._named_params)}
    return losses, params, vel


def timed_runs(fn, warm, iters):
    """``fn()`` ``warm`` times, then ``iters`` times timed on the host's
    clock (each returns numpy: a host sync): ms a call."""
    for _ in range(warm):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def lenet_exec_phase(gpu):
    """Phase 18(a): bench_lenet_exec (``bench.py:468-529``) on the card:
    B = 256, seed 0, ``RandomState(0)``'s batch, ``Momentum(0.01, 0.9)``,
    the startup run. ``LENET_STEPS`` graphed ``Executor.run`` calls (the
    first op by op, the second the capture) against the same program run
    op by op (``use_cuda_graph=False``) and against the eager ``LeNet``
    from the same weights, bitwise in the losses, every parameter and
    velocity; the losses finite, the 4th below the 1st; no launch of the
    port's kernels (10 classes fail ``fused_ce_ok``). Then bench's timing
    (3 warm and 20 timed ``run``, then ``run_steps`` with K = 8), each
    ``run_steps`` call's k-th fetch against the k-th of 8 sequential
    ``run`` calls bitwise, from one state, and one compile each for
    ``run`` and ``run_steps``. Returns the printed numbers."""
    import math

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    B, K = LENET_BATCH, LENET_K
    main, startup, loss, model, scope = lenet_program(B)
    x, y = lenet_batch(B)
    feed = {"x": x, "y": y}
    exe = pt.static.Executor()
    exe.run(startup, scope=scope)
    init = scope_state(main, scope)

    def run(e):
        return float(e.run(main, feed=feed, fetch_list=[loss],
                           scope=scope)[0])

    out = {}
    for kind, e in (("graphed", exe),
                    ("op by op", pt.static.Executor(use_cuda_graph=False))):
        restore_scope(scope, init)
        kernels.reset_launches()
        losses = [run(e) for _ in range(LENET_STEPS)]
        launches = kernels.launches()
        out[kind] = (losses, scope_state(main, scope))
        log(f"static lenet {kind}: losses {losses}")
        check(launches == dict.fromkeys(kernels.KERNELS, 0),
              f"static lenet {kind}: the port's kernels launched "
              f"{launches}; LeNet runs none")
    check(exe.captures == 1, f"static lenet: {exe.captures} captures for "
          f"one cache key")
    (gl, gs), (ol, os_) = out["graphed"], out["op by op"]
    check(all(math.isfinite(v) for v in gl) and gl[3] < gl[0],
          f"static lenet: losses {gl} not finite or not falling")
    bad = [n for n in gs if not torch_equal(gs[n], os_[n])]
    check(gl == ol and not bad, f"static lenet: graphed {gl} != op by op "
          f"{ol}, or {len(bad)} persistables differ, e.g. {bad[:4]}")
    el, ep, ev = lenet_eager(list(model.parameters()), init, x, y,
                             LENET_STEPS)
    bad = [n for n in ep if not torch_equal(ep[n], gs[n])]
    # a parameter without an update op has no velocity in the program
    bad += [n for n in ev if f"{n}@OPT@velocity" not in gs
            or not torch_equal(ev[n], gs[f"{n}@OPT@velocity"])]
    check(el == gl and not bad, f"static lenet: the eager LeNet's losses "
          f"{el} != the program's {gl}, or {len(bad)} parameters and "
          f"velocities differ, e.g. {bad[:4]}")
    log(f"static lenet: {LENET_STEPS} graphed steps = the program op by op "
        f"= the eager LeNet with Momentum, bitwise (losses, {len(ep)} "
        f"parameters, {len(ev)} velocities); one capture")

    # bench_lenet_exec's timing
    restore_scope(scope, init)
    step_ms = timed_runs(lambda: run(exe), LENET_WARM, LENET_ITERS)
    eager_exe = pt.static.Executor(use_cuda_graph=False)
    restore_scope(scope, init)
    op_ms = timed_runs(lambda: run(eager_exe), LENET_WARM, LENET_ITERS)
    # run_steps against 8 sequential run calls, from one state
    restore_scope(scope, init)
    seq = [run(exe) for _ in range(K)]
    seq_state = scope_state(main, scope)
    feeds = [feed] * K
    fused = []
    for call in ("op by op", "capture", "replay"):
        restore_scope(scope, init)
        got = exe.run_steps(main, feeds=feeds, fetch_list=[loss],
                            scope=scope)[0].tolist()
        state = scope_state(main, scope)
        bad = [n for n in state if not torch_equal(state[n], seq_state[n])]
        check(got == seq and not bad, f"static lenet: run_steps ({call}) "
              f"fetched {got}, 8 sequential runs {seq}; {len(bad)} "
              f"persistables differ, e.g. {bad[:4]}")
        fused.append(got)
    iters = max(1, LENET_ITERS // K)
    fused_ms = timed_runs(lambda: exe.run_steps(
        main, feeds=feeds, fetch_list=[loss], scope=scope), 0, iters) / K
    cs = exe.cache_stats()
    calls = {"compiles": cs["misses"], "dispatches": exe.dispatches,
             "entries": cs["size"]}
    check(cs["misses"] == 2 and cs["size"] == 2, f"static lenet: "
          f"{cs['misses']} compiles, {cs['size']} entries; one for run and "
          f"one for run_steps")
    check(exe.captures == 2, f"static lenet: {exe.captures} captures, one "
          f"for run and one for run_steps")
    res = {"step_ms": step_ms, "imgs_per_sec": B / step_ms * 1e3,
           "op_by_op_step_ms": op_ms, "fused_step_ms": fused_ms,
           "fused_imgs_per_sec": B / fused_ms * 1e3,
           "fused_vs_loop": step_ms / fused_ms, "compiled_calls": calls}
    log(f"static lenet: run_steps (K = {K}) fetches = 8 sequential runs "
        f"bitwise, op by op, captured and replayed: {fused[-1]}")
    log(f"static lenet: step_ms {step_ms:.4f} ({B / step_ms * 1e3:.0f} "
        f"imgs/s) graphed, {op_ms:.4f} op by op; fused_step_ms "
        f"{fused_ms:.4f} ({B / fused_ms * 1e3:.0f} imgs/s, "
        f"{step_ms / fused_ms:.2f}x the loop); compiled_calls {calls}; "
        f"phase took {time.perf_counter() - t_phase:.1f} s [{gpu}]")
    return res


def static_ln_ce_program(rows, hidden, vocab):
    """A static ``Linear(hidden -> hidden)`` -> ``LayerNorm(hidden)`` ->
    ``Linear(hidden -> vocab)`` -> ``cross_entropy`` over ``rows`` rows,
    float32, and its ``append_backward``: ``(main, loss, [(param,
    grad)], layers, scope)``."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.utils import unique_name

    scope = pt.static.Scope()
    pt.seed(0)
    with unique_name.guard(), pt.static.scope_guard(scope):
        pt.enable_static()
        try:
            main = pt.static.Program()
            with pt.program_guard(main, pt.static.Program()):
                x = pt.static.data("x", [rows, hidden], "float32")
                lab = pt.static.data("label", [rows], "int64")
                layers = (nn.Linear(hidden, hidden), nn.LayerNorm(hidden),
                          nn.Linear(hidden, vocab))
                h = x
                for m in layers:
                    h = m(h)
                loss = F.cross_entropy(h, lab)
                pg = pt.static.append_backward(loss)
        finally:
            pt.disable_static()
    return main, loss, pg, layers, scope


def static_ln_ce_phase(gpu):
    """Phase 18(b): the LayerNorm and softmax-CE kernels through the
    static graph: ``STATIC_LN_CE``'s program records ``layer_norm`` and
    the fused ``cross_entropy_hard`` as one op each; every call (op by
    op, the capture's replay, a profiled replay) launches the LN forward
    and backward and the CE forward and backward kernels once each, by
    the wrappers' counts and (the profiled replay) by ``torch.profiler``;
    its loss and gradients equal the eager modules' (the same weights)
    bitwise. Returns the replay's wall ms."""
    import torch

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.ops import kernels

    cfg = STATIC_LN_CE
    main, loss, pg, layers, scope = static_ln_ce_program(**cfg)
    fwd = [op.type for op in main.global_block.ops
           if not op.type.endswith("@grad") and op.type != "fill_ones_like"]
    check(fwd == ["linear", "layer_norm", "linear", "cross_entropy_hard"],
          f"static ln-ce: recorded forward ops {fwd}")
    rng = np.random.RandomState(0)
    x = rng.randn(cfg["rows"], cfg["hidden"]).astype("float32")
    lab = rng.randint(0, cfg["vocab"], cfg["rows"]).astype("int64")
    feed = {"x": x, "label": lab}
    fetch = [loss] + [g for _, g in pg]
    exe = pt.static.Executor()
    want = dict.fromkeys(kernels.KERNELS, 0) | STATIC_LN_CE_LAUNCHES
    walls, out = [], []

    def one():
        out[:] = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                         return_numpy=False)

    for call in range(STATIC_LN_CE_CALLS):
        if call == STATIC_LN_CE_CALLS - 1:
            wall, busy, seen = profiled(one)
            counted = kernels.launches()
            check(seen == want, f"static ln-ce: the profiler saw {seen} in "
                  f"a replay, want {want}")
        else:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            counted = kernels.launches()
        check(counted == want, f"static ln-ce: call {call + 1} launched "
              f"{counted}, want {want}")
    check(exe.captures == 1, f"static ln-ce: {exe.captures} captures")
    eager = (nn.Linear(cfg["hidden"], cfg["hidden"]),
             nn.LayerNorm(cfg["hidden"]),
             nn.Linear(cfg["hidden"], cfg["vocab"]))
    pairs = [(p, q) for m, e in zip(layers, eager)
             for p, q in ((m.weight, e.weight), (m.bias, e.bias))]
    with torch.no_grad():
        for p, q in pairs:
            q.copy_(scope.find_var(p.name))
    h = torch.from_numpy(x).cuda()
    for m in eager:
        h = m(h)
    el = F.cross_entropy(h, torch.from_numpy(lab).cuda())
    el.backward()
    grads = {p.name: g for (p, _), g in zip(pg, out[1:])}
    bad = [p.name for p, q in pairs if not torch_equal(grads[p.name],
                                                       q.grad)]
    check(torch_equal(out[0], el.detach()) and not bad,
          f"static ln-ce: loss {float(out[0])} vs eager "
          f"{float(el.detach())}; gradients differ: {bad}")
    log(f"static ln-ce: {cfg} float32: layer_norm and cross_entropy_hard "
        f"one op each; LN fwd/bwd and CE fwd/bwd launched once each a "
        f"call (op by op, replay, profiled replay: the profiler agrees); "
        f"loss {float(out[0]):.6f} and {len(pairs)} gradients = the eager "
        f"modules' bitwise; walls ms (op by op, capture + replay) " + " ".join(
            f"{w:.2f}" for w in walls) + f", profiled replay {wall:.2f} ms, "
        f"device busy {busy:.2f} ms [{gpu}]")
    del exe, out, eager, h, el
    torch.cuda.empty_cache()
    return wall


def static_ln_ce_child():
    """``static_ln_ce_phase`` in a fresh process: builds (the libraries
    the parent built are reused), runs the phase, returns 0, or 1 after
    logging the failed check."""
    import torch

    from paddle_tpu_torch.ops.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    try:
        static_ln_ce_phase(gpu_line())
    except CheckFailed as e:
        log(f"static ln-ce: check failed: {e}")
        return 1
    return 0


def static_phase(gpu):
    """Phase 18: ``lenet_exec_phase``, then ``static_ln_ce_phase`` in a
    fresh Python process. Late in this long process ``torch.profiler``
    loses the first milliseconds of GPU activity of most of its
    sessions, whatever the pause before the call (there, the replay's
    forward kernels, LN's and CE's among them); a fresh process's
    profiler keeps them, so the profiled check of 18(b) is made in one."""
    t0 = time.perf_counter()
    res = lenet_exec_phase(gpu)
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke;"
            " sys.exit(chip_smoke.static_ln_ce_child())")
    out = subprocess.run([sys.executable, "-c", code, here],
                         capture_output=True, text=True, timeout=600)
    for line in out.stdout.splitlines():
        log(line)
    check(out.returncode == 0, f"static ln-ce: the fresh process failed "
          f"({out.returncode}): {(out.stdout + out.stderr)[-3000:]}")
    log(f"static: phase took {time.perf_counter() - t0:.1f} s")
    return res


# -- phase 19: the serve bench (bench.py:bench_serve) ---------------------------

# bench_serve's arguments (bench.py:304) and its tenants (:334-335)
SERVE_BENCH = dict(requests=48, rate=100.0, pages=256, page_size=16)
SERVE_TENANTS = "a:rate=75,weight=3;b:rate=25,weight=1"
# run (a): bench's TinyLM; run (b): the engine phase's full width, the
# same trace (token ids below 32); 256 pages of 16 hold every request of
# the trace at once (644 prompt and 667 new tokens), so none is rejected
SERVE_WIDTHS = {"bench": dict(vocab=32, heads=2, head_dim=8),
                "full": dict(vocab=FULL["vocab_size"],
                             heads=FULL["num_heads"],
                             head_dim=FULL["head_dim"])}


def serve_bench_tool():
    """``tools/torch_serve_bench.py`` of this checkout, as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", "torch_serve_bench.py")
    spec = importlib.util.spec_from_file_location("torch_serve_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Oracle:
    """The dense oracle's tokens (``TinyLM.reference_generate``) of one
    model on the card, each (prompt, new tokens) computed once."""

    def __init__(self, width):
        from paddle_tpu_torch.serving import TinyLM

        self.model = TinyLM(vocab_size=width["vocab"],
                            num_heads=width["heads"],
                            head_dim=width["head_dim"], seed=0)
        self.tokens = {}

    def __call__(self, prompt, new):
        key = (tuple(prompt), new)
        if key not in self.tokens:
            self.tokens[key] = self.model.reference_generate(prompt, new)
        return self.tokens[key]


def serve_bench_run(sb, label, gpu, journal_dir=None):
    """``bench_serve_leg`` at one of ``SERVE_WIDTHS``, the launch counts
    zeroed just before and read just after: every request of the engine
    and fleet legs finishes (none rejected or stuck) with the dense
    oracle's tokens, no SLO of ``SERVE_SLO_SPEC`` is violated, the scraped
    running gauge equals the engine's, and the paged kernel launches once
    for each decode step of each engine the leg ran (the engine, the
    export leg's and the two replicas). ``journal_dir`` keeps the engine
    leg's journal. Returns the leg's dict and the oracle."""
    import torch

    from paddle_tpu_torch.ops import kernels

    width = SERVE_WIDTHS[label]
    detail = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = sb.bench_serve_leg(**SERVE_BENCH, **width, detail=detail,
                             journal_dir=journal_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    log(f"serve bench ({label}) " + json.dumps(out, sort_keys=True))
    eng, fleet, steps = detail["engine"], detail["fleet"], \
        detail["decode_steps"]
    check(out["finished"] == out["requests"] == SERVE_BENCH["requests"]
          and eng["rejected"] == 0 and eng["stuck"] == 0,
          f"serve bench ({label}): {out['finished']} of {out['requests']} "
          f"finished, {eng['rejected']} rejected, {eng['stuck']} stuck")
    check(out["slo_violations"] == [] and out["export_gauge_ok"] is True,
          f"serve bench ({label}): SLO violations {out['slo_violations']}, "
          f"export gauge ok {out['export_gauge_ok']}")
    check(fleet["finished"] == 24 and fleet["rejected"] == 0
          and fleet["stuck"] == 0 and out["replicas"] == 2,
          f"serve bench ({label}): the fleet leg finished "
          f"{fleet['finished']} of 24 ({fleet['rejected']} rejected, "
          f"{fleet['stuck']} stuck) on {out['replicas']} replicas")
    total = steps["engine"] + steps["export"] + sum(steps["fleet"])
    want = dict.fromkeys(kernels.KERNELS, 0) | {
        "paged_decode_attention": total}
    check(launches == want and steps["engine"] and all(steps["fleet"]),
          f"serve bench ({label}): launches {launches} for decode steps "
          f"{steps}")
    oracle = Oracle(width)
    runs = detail["requests"] + detail["tokens"]
    bad = [i for i, (p, n, toks) in enumerate(runs) if toks != oracle(p, n)]
    check(len(runs) == 72 and not bad, f"serve bench ({label}): {len(bad)} "
          f"of {len(runs)} requests' tokens differ from the dense oracle's")
    log(f"serve bench ({label}): {width}; 48 + 24 requests finished with "
        f"the dense oracle's tokens, no SLO violated, the scraped gauge "
        f"right; paged launches {total} = decode steps {steps}; leg wall "
        f"{wall:.2f} s [{gpu}]")
    return out, oracle


def serve_bench_replay(sb, oracle, gpu):
    """The leg's trace on a ``ManualClock`` through one engine at full
    width (``replay_manual``), the launch counts zeroed just before and
    read just after: every request finishes with the dense oracle's
    tokens and each decode step launches the paged kernel once."""
    import torch

    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import (ManualClock, PagedKVCache,
                                          Scheduler, ServeEngine)

    width = SERVE_WIDTHS["full"]
    trace = sb.make_trace(SERVE_BENCH["requests"], SERVE_BENCH["rate"],
                          tenants=sb.parse_tenants(SERVE_TENANTS))
    clock = ManualClock()
    cache = PagedKVCache(SERVE_BENCH["pages"], SERVE_BENCH["page_size"],
                         width["heads"], width["head_dim"])
    eng = ServeEngine(oracle.model, cache, scheduler=Scheduler(
        cache, token_budget=512, clock=clock))
    torch.cuda.synchronize()
    kernels.reset_launches()
    reqs = sb.replay_manual(eng, clock, trace)
    torch.cuda.synchronize()
    launches = kernels.launches()
    check(all(r.state == "FINISHED" for r in reqs) and len(reqs) == 48,
          "serve bench replay: not every request finished")
    bad = [r.rid for r, t in zip(reqs, trace)
           if r.generated != oracle(t["prompt"], t["max_new_tokens"])]
    check(not bad, f"serve bench replay: {bad} differ from the dense oracle")
    want = dict.fromkeys(kernels.KERNELS, 0) | {
        "paged_decode_attention": eng.usage.decode_steps}
    check(launches == want and eng.usage.decode_steps > 0,
          f"serve bench replay: launches {launches} for "
          f"{eng.usage.decode_steps} decode steps")
    check(cache.verify() and cache.stats()["used_pages"] == 0,
          f"serve bench replay: pool does not balance: {cache.stats()}")
    log(f"serve bench replay: the trace on a ManualClock at full width: "
        f"{eng.stats()['steps']} steps, {eng.usage.decode_steps} decode "
        f"steps = paged launches, {eng.scheduler.preemptions} preemptions, "
        f"tokens = the dense oracle's [{gpu}]")


def serve_bench_phase(gpu, journals=None):
    """Phase 19: ``serve_bench_run`` at bench's width and at full width,
    then ``serve_bench_replay``. Returns the two legs' dicts. With
    ``journals`` each leg's engine journal stays under
    ``journals/serve_bench/<label>`` for phase 22."""
    import torch

    t0 = time.perf_counter()
    sb = serve_bench_tool()
    out = {}
    for label in SERVE_WIDTHS:
        out[label], oracle = serve_bench_run(
            sb, label, gpu, journals and os.path.join(
                journals, "serve_bench", label))
    serve_bench_replay(sb, oracle, gpu)
    del oracle
    torch.cuda.empty_cache()
    log(f"serve bench: phase took {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 20: the int8 Predictor (bench.py:bench_int8_predictor) -------------

INT8_BATCH = 256                  # bench_int8_predictor's B
INT8_WARM, INT8_ITERS = 3, 20     # bench.py:281 (not SMOKE)
# max |fp32 - int8| of the two Predictors' probabilities. Seen on the CPU
# (tests/test_torch_smoke_checks.py): 0.0116 from this sequence's weights,
# 0.0115 from the JAX package's; one weight's scales doubled, the planted
# fault of that test, gives 0.33
INT8_PROB_TOL = 5e-2


def int8_bundles(root, device=None, B=INT8_BATCH):
    """bench_int8_predictor's sequence (``bench.py:257-277``) up to its
    bundles: seed 0, LeNet + ``F.softmax`` recorded at B in a Scope and a
    name generator of their own, ``save_inference_model`` and
    ``quantize_inference_model``. Returns ``(prefix, main, prob, scope,
    quantized names)``; ``prefix + "_int8"`` is the int8 bundle."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.framework import io
    from paddle_tpu_torch.models.vision import LeNet
    from paddle_tpu_torch.quant import quantize_inference_model
    from paddle_tpu_torch.utils import unique_name

    scope = pt.static.Scope()
    pt.seed(0)
    with unique_name.guard(), pt.static.scope_guard(scope):
        pt.enable_static()
        try:
            main, startup = pt.static.Program(), pt.static.Program()
            with pt.program_guard(main, startup):
                xv = pt.static.data("x", [B, 1, 28, 28], "float32")
                prob = F.softmax(LeNet(device=device)(xv), axis=-1)
        finally:
            pt.disable_static()
        pt.static.Executor(device).run(startup)
        prefix = os.path.join(root, "lenet")
        io.save_inference_model(prefix, ["x"], [prob], program=main)
    return prefix, main, prob, scope, quantize_inference_model(prefix)


def int8_bundle_check(prefix, quantized):
    """The int8 bundle holds, for each quantized weight, exactly
    ``quantize_abs_max`` of the fp32 bundle's weight (per output channel:
    axis 0 of a conv weight, axis 1 of a linear one), and the fp32
    weights of the rest."""
    from paddle_tpu_torch.quant import quantize_abs_max

    fp = np.load(prefix + ".pdiparams.npz")
    q8 = np.load(prefix + "_int8.pdiparams.npz")
    for k in fp.files:
        name = k[2:]
        if name in quantized:
            q, s = quantize_abs_max(fp[k], channel_axis=0 if name.startswith(
                "conv") else 1)
            check(q8["q!" + name].tobytes() == q.tobytes()
                  and q8["s!" + name].tobytes() == s.tobytes(),
                  f"int8: {name}'s int8 values or scales differ from "
                  "quantize_abs_max of the saved weight")
        elif k.startswith("w!"):
            check(q8[k].tobytes() == fp[k].tobytes(),
                  f"int8: {name} should stay float32")


def max_prob_diff(a, b):
    return float(np.abs(a - b).max())


def int8_predict(prefix, x, device=None, use_cuda_graph=True):
    """A Predictor of ``prefix`` (loaded in a Scope of its own) and its
    output on ``x``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.inference import Config, Predictor

    with pt.static.scope_guard(pt.static.Scope()):
        pred = Predictor(Config(prefix, device=device,
                                use_cuda_graph=use_cuda_graph))
    return pred, pred.run({"x": x})[0]


def int8_phase(gpu):
    """Phase 20: bench_int8_predictor (``bench.py:246-293``) on the card:
    B = 256, seed 0, the fp32 and int8 bundles (``int8_bundles``,
    ``int8_bundle_check``), an fp32 and an int8 ``Predictor``, 3 warm-up
    and 20 timed ``run`` calls each, the launch counts zeroed just before
    and read just after (LeNet runs none of the port's kernels). Each
    Predictor's output (after its capture, replayed) equals the same
    Predictor's op by op (``use_cuda_graph=False``) bitwise; the fp32 one
    equals ``Executor.run`` of the recorded program; ``max_prob_diff``
    stays under ``INT8_PROB_TOL``; one signature and one capture each.
    Logs bench's four numbers, the op-by-op time a call and the device's
    busy share over a profiled window of calls. Returns bench's dict."""
    import tempfile

    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    B = INT8_BATCH
    x = np.random.RandomState(0).randn(B, 1, 28, 28).astype("float32")
    with tempfile.TemporaryDirectory() as root:
        prefix, main, prob, scope, quantized = int8_bundles(root)
        int8_bundle_check(prefix, quantized)
        with pt.static.scope_guard(scope):
            ref, = pt.static.Executor().run(main, feed={"x": x},
                                            fetch_list=[prob])
        preds, outs, rates, plain = {}, {}, {}, {}
        for kind, p in (("fp32", prefix), ("int8", prefix + "_int8")):
            pred, _ = int8_predict(p, x)
            torch.cuda.synchronize()
            kernels.reset_launches()
            for _ in range(INT8_WARM):
                pred.run({"x": x})
            t1 = time.perf_counter()
            for _ in range(INT8_ITERS):
                out, = pred.run({"x": x})
            ms = (time.perf_counter() - t1) / INT8_ITERS * 1e3
            launches = kernels.launches()
            check(launches == dict.fromkeys(kernels.KERNELS, 0),
                  f"int8: the {kind} Predictor launched {launches}; LeNet "
                  f"runs none of the port's kernels")
            eager, eager_out = int8_predict(p, x, use_cuda_graph=False)
            plain[kind] = timed_runs(lambda: eager.run({"x": x}), INT8_WARM,
                                     INT8_ITERS)
            cs = pred.cache_stats()
            check(np.array_equal(out, eager_out),
                  f"int8: the {kind} Predictor's replay differs from its op "
                  f"by op run (max {max_prob_diff(out, eager_out)})")
            check(cs["size"] == cs["misses"] == 1 and pred.captures == 1,
                  f"int8: the {kind} Predictor has {cs} and "
                  f"{pred.captures} captures; one signature, one capture")
            preds[kind], outs[kind], rates[kind] = pred, out, B / ms * 1e3
            log(f"int8 {kind}: {ms:.4f} ms a call ({rates[kind]:.0f} "
                f"imgs/s) graphed, {plain[kind]:.4f} ms op by op; replay = "
                f"op by op bitwise; {cs}")
        check(np.array_equal(outs["fp32"], ref),
              "int8: the fp32 Predictor differs from Executor.run of the "
              f"program (max {max_prob_diff(outs['fp32'], ref)})")
        diff = max_prob_diff(outs["fp32"], outs["int8"])
        check(diff < INT8_PROB_TOL, f"int8: max_prob_diff {diff} >= "
              f"{INT8_PROB_TOL}")
        window = 20
        wall, busy, _ = profiled(lambda: [preds["int8"].run({"x": x})
                                          for _ in range(window)])
    res = {"imgs_per_sec_int8": rates["int8"],
           "imgs_per_sec_fp32": rates["fp32"],
           "int8_vs_fp32": rates["int8"] / rates["fp32"],
           "max_prob_diff": diff}
    log("int8 predictor " + json.dumps(res, sort_keys=True))
    log(f"int8: quantized {sorted(quantized)}; the fp32 Predictor = "
        f"Executor.run bitwise; max_prob_diff {diff:.6f} < {INT8_PROB_TOL}; "
        f"a profiled window of {window} int8 calls: wall {wall:.3f} ms, "
        f"device busy {busy:.3f} ms ({busy / wall:.1%}); phase took "
        f"{time.perf_counter() - t0:.1f} s [{gpu}]")
    return res


# -- phase 21: mixed precision (float16 O1/O2, static AMP) and recompute ----


def fp16_close(out, ref, grad):
    """``flash_close`` in float16: rtol one float16 step
    (``FLASH_F16_STEP``), atol ``FLASH_F32_TOL`` times 1 (O, lse) or the
    largest ``|ref|`` (a gradient); compared only where ``ref`` is
    finite, and there ``out`` must be finite too. Returns ``(ok, max abs
    err)``."""
    import torch

    fin = torch.isfinite(ref.float())
    o, r = out.float()[fin], ref.float()[fin]
    if o.numel() == 0:
        return True, 0.0
    err = (o - r).abs()
    m = r.abs().max() if grad else 1.0
    ok = bool(torch.isfinite(o).all()
              and (err <= FLASH_F16_STEP * r.abs() + FLASH_F32_TOL * m).all())
    return ok, err.max().item()


def fp16_kernel_phase():
    """Each kernel's float16 variant against its plain version on the
    card: LayerNorm forward and backward at bench_gpt's (16384, 768) and
    (8, 128); cross-entropy at (16384, 50304) and a ragged V = 1000; the
    flash kernels at bench_gpt's shape (B*H 192, L 1024, D 64, causal),
    D = 128 and 256, a ragged L, and the backward again with dO at 2^13
    times unit scale, where the plain version's float32 dS passes
    float16's 65504 (checked): dQ, dK and dV must be finite wherever the
    plain version's are; the paged decode over float16 pools; and a
    float16 LayerNorm of a routed shape through ``ops.norm_ops``, which
    must launch the kernel once. Returns the largest abs error of each
    kernel."""
    import torch

    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops import norm_ops
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layernorm as ln
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import softmax_ce as ce

    errs = dict.fromkeys(kernels.KERNELS, 0.0)
    h = torch.float16

    def note(kernel, label, what, res):
        ok, err = res
        errs[kernel] = max(errs[kernel], err)
        check(ok, f"fp16 {kernel} {label}: {what} disagrees with the plain "
              f"version (max abs err {err:.3e})")
        return err

    g = torch.Generator(device="cuda").manual_seed(21)
    for N, D in ((16384, 768), (8, 128), (8191, 768)):
        label = f"({N}, {D}) float16"
        x = (torch.randn(N, D, generator=g, device="cuda") * 2 + 0.5).to(h)
        dy = torch.randn(N, D, generator=g, device="cuda").to(h)
        gamma, beta = (torch.randn(D, generator=g, device="cuda").to(h)
                       for _ in range(2))
        y, mean, rstd = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
        dx, dg, db = ln.layer_norm_bwd(x, gamma, mean, rstd, dy)
        torch.cuda.synchronize()
        yr, mr, rr = ln.layer_norm_fwd_reference(x, gamma, beta, 1e-5)
        dxr, dgr, dbr = ln.layer_norm_bwd_reference(x, gamma, mean, rstd, dy)
        xhat = (x.float() - mean) * rstd
        e = [note("layer_norm_fwd", label, "y", within(y, yr, FP16_TOL)),
             note("layer_norm_fwd", label, "mean",
                  within(mean, mr, TRAIN_F32_TOL)),
             note("layer_norm_fwd", label, "rstd",
                  within(rstd, rr, TRAIN_F32_TOL)),
             note("layer_norm_bwd", label, "dx", within(dx, dxr, FP16_TOL)),
             note("layer_norm_bwd", label, "dgamma", within(
                 dg, dgr, TRAIN_F32_TOL, (dy.float() * xhat).abs().sum(0))),
             note("layer_norm_bwd", label, "dbeta", within(
                 db, dbr, TRAIN_F32_TOL, dy.float().abs().sum(0)))]
        log(f"fp16-kernel layer_norm {label}: max abs err y/mean/rstd/dx/"
            f"dgamma/dbeta " + " ".join(f"{v:.2e}" for v in e)
            + f" (tol {FP16_TOL})")
    for name, N, V in (("path", 16384, 50304), ("tail", 16, 1000)):
        label = f"{name} ({N}, {V}) float16"
        x = (torch.randn(N, V, generator=g, device="cuda") * 3).to(h)
        lab = torch.randint(0, V, (N,), generator=g, device="cuda")
        lab[::5] = -100
        gl = torch.rand(N, generator=g, device="cuda")
        loss, lse = ce.softmax_ce_fwd(x, lab)
        dx = ce.softmax_ce_bwd(x, lab, lse, gl)
        torch.cuda.synchronize()
        lr, lser = ce.softmax_ce_fwd_reference(x, lab)
        dxr = ce.softmax_ce_bwd_reference(x, lab, lse, gl)
        e = [note("softmax_ce_fwd", label, "loss",
                  within(loss, lr, TRAIN_F32_TOL)),
             note("softmax_ce_fwd", label, "lse",
                  within(lse, lser, TRAIN_F32_TOL)),
             note("softmax_ce_bwd", label, "dlogits",
                  within(dx, dxr, FP16_TOL, ce_bwd_scale(x, lab, lse, gl)))]
        log(f"fp16-kernel softmax_ce {label}: max abs err loss/lse/dlogits "
            + " ".join(f"{v:.2e}" for v in e) + f" (tol {FP16_TOL})")
        del x, dx, dxr
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    for label, B, H, Lq, Lk, D, causal, do_mul in (
            ("path", 16, 12, 1024, 1024, 64, True, 1.0),
            ("path-dO*2^13", 16, 12, 1024, 1024, 64, True, 2.0 ** 13),
            ("d128", 2, 4, 512, 512, 128, True, 1.0),
            ("d128-dO*2^13", 2, 4, 512, 512, 128, True, 2.0 ** 13),
            ("d256", 1, 2, 256, 384, 256, True, 1.0),
            ("ragged", 1, 2, 200, 200, 64, True, 1.0)):
        tag = (f"{label} B*H={B * H} Lq={Lq} Lk={Lk} D={D} "
               f"{'causal' if causal else 'full'} float16")
        q, k, v, do = (torch.randn(B, H, L, D, generator=g, device="cuda")
                       for L in (Lq, Lk, Lk, Lq))
        q, k, v = q.to(h), k.to(h), v.to(h)
        # |dO| <= 7 * 2^13 = 57344 < 65504
        do = (do.clamp(-7, 7) * do_mul).to(h)
        scale = 1.0 / D ** 0.5
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        delta = fa.flash_delta(o, do)
        args = (q, k, v, do, lse, delta, causal, scale)
        dq = fa.flash_attention_bwd_dq(*args)
        dk, dv = fa.flash_attention_bwd_dkv(*args)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
        rdq = fa.flash_attention_bwd_dq_reference(*args)
        rdk, rdv = fa.flash_attention_bwd_dkv_reference(*args)
        if do_mul > 1:
            _, ds = fa._p_ds(*args)
            big = ds.abs().max().item()
            check(big > 65504, f"fp16 flash {tag}: the plain dS peaks at "
                  f"{big:.0f}, inside float16's range: the case tests "
                  f"nothing")
            del ds
        e = []
        for kernel, what, out, ref, grad in (
                (names[0], "O", o, ro, False),
                (names[0], "lse", lse, rlse, False),
                (names[1], "dQ", dq, rdq, True),
                (names[2], "dK", dk, rdk, True),
                (names[2], "dV", dv, rdv, True)):
            e.append(note(kernel, tag, what, fp16_close(out, ref, grad)))
        fin = [bool(torch.isfinite(t.float()).all()) for t in (rdq, rdk, rdv)]
        log(f"fp16-kernel flash {tag}: max abs err O/lse/dQ/dK/dV "
            + " ".join(f"{x:.2e}" for x in e)
            + f"; plain dQ/dK/dV all finite {fin}"
            + (f"; plain |dS| peaks at {big:.0f}" if do_mul > 1 else ""))
        del q, k, v, do, o, lse, dq, dk, dv, ro, rdq, rdk, rdv
    lengths = [0, 1, 16, 17, 700, 2048]
    q, kp, vp, table, ln_t = paged_inputs(lengths, 12, 64, 16, 1024, h, 5)
    out = pa.paged_decode_attention(q, kp, vp, table, ln_t)
    torch.cuda.synchronize()
    ref = pa.paged_decode_attention_reference(q, kp, vp, table, ln_t)
    # float32 q and output, float32 arithmetic over the same float16 pool
    e = note("paged_decode_attention", "float16 pools", "out",
             within(out, ref, F32_TOL))
    log(f"fp16-kernel paged_decode_attention lengths {lengths} float16 "
        f"pools: max abs err {e:.2e} (tol {F32_TOL})")
    # timed at the engine's first decode step (phase 5's shape) over
    # float16 pools: no main path runs them, so the row is logged only
    rng = np.random.RandomState(0)
    lengths = [int(n) + 1 for n in rng.randint(128, 2049, 16)]
    args = paged_inputs(lengths, 12, 64, 16, POOL["num_pages"], h, 99)
    ms = cuda_ms(lambda: pa.paged_decode_attention(*args), 50)
    plain_ms = cuda_ms(lambda: pa.paged_decode_attention_reference(*args),
                       10)
    # SDPA takes one type: q in the pools' float16
    lib_ms = cuda_ms(lambda: gather_sdpa(args[0].half(), *args[1:]), 10)
    bound, bound_by, nbytes = paged_bound_ms(lengths, 16, 12, 64, 2,
                                             args[3].shape[1])
    log(f"timing paged_decode_attention B=16 H=12 D=64 float16 pools: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (gather + "
        f"SDPA) {lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB at 3.35 TB/s) = {bound / ms * 100:.1f}% "
        f"of roofline")
    x = torch.randn(16, 1024, 768, generator=g, device="cuda").to(h)
    w = torch.ones(768, device="cuda", dtype=h)
    b = torch.zeros(768, device="cuda", dtype=h)
    kernels.reset_launches()
    y = norm_ops.layer_norm(x, None, w, b)
    n = kernels.launches()["layer_norm_fwd"]
    check(n == 1 and y.dtype == h, f"fp16: a routed float16 LayerNorm made "
          f"{n} kernel launches (want 1) and gave {y.dtype}")
    log("fp16-kernel: a float16 LayerNorm of (16, 1024, 768) through "
        "ops.norm_ops launched layer_norm_fwd once")
    torch.cuda.empty_cache()
    return errs



# phase 21's runs: ``AMP_STEPS`` steps each; the loss scaler is
# ``DynamicLossScaler()`` at its defaults (2^15, x2 after 1000 clean
# steps, x0.5 after each overflow), as ``paddle.amp.GradScaler``'s
AMP_STEPS = 4
# losses of a float16 kernel run vs its plain-version run, absolute on
# each step. Seen on an H100 80GB HBM3 (700 W): O1 bench_gpt <= 4.1e-5,
# O2 <= 2.0e-4, O1 bench_bert <= 2.1e-3. tools/torch_planted_faults.py
# --amp plants float16 flash dV = 0 under O1 (0, 7.2e-2, 0.35, 0.53)
# and float16 LayerNorm dx = 0 at O2 (5.7e-6, 0.12, 0.33, 0.26): both
# fail
F16_TRAIN_LOSS_TOL = 1e-2
# the C++ type in a kernel's name for each tensor type
CTYPES = {"torch.float32": "float", "torch.bfloat16": "__nv_bfloat16",
          "torch.float16": "__half"}


class Tally:
    """Stands in for a kernel wrapper in its module and counts its calls
    on CUDA tensors (a static program's shape inference calls some on
    ``meta`` tensors) by the type of their first tensor, the type of the
    kernel that launches; ``launches`` and every other attribute are the
    wrapper's. Python runs only op by op (a captured step replays without
    it), so the tally is taken over op-by-op steps."""

    def __init__(self, fn, name, counts):
        self.__dict__.update(fn=fn, name=name, counts=counts)

    def __call__(self, *args, **kwargs):
        if args[0].is_cuda:
            self.counts[(self.name, str(args[0].dtype))] += 1
        return self.fn(*args, **kwargs)

    def __getattr__(self, attr):
        return getattr(self.fn, attr)

    def __setattr__(self, attr, value):
        setattr(self.fn, attr, value)


@contextlib.contextmanager
def dtype_tally():
    """The kernel wrappers' calls by ``(wrapper, dtype)`` while inside."""
    import collections

    from paddle_tpu_torch.ops import kernels

    counts = collections.Counter()
    saved = {name: getattr(mod, name)
             for name, mod in kernels.KERNELS.items()}
    try:
        for name, mod in kernels.KERNELS.items():
            setattr(mod, name, Tally(saved[name], name, counts))
        yield counts
    finally:
        for name, mod in kernels.KERNELS.items():
            setattr(mod, name, saved[name])


def o1_gpt_loss(model, ids, labels):
    """bench_gpt's loss under ``auto_cast(dtype="float16")`` (O1)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.nlp import gpt

    with amp.auto_cast(dtype="float16"):
        return gpt.gpt_loss(model, ids, labels)


def o1_bert_loss(model, *batch):
    """bench_bert's loss under ``auto_cast(dtype="float16")`` (O1)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.nlp import bert

    with amp.auto_cast(dtype="float16"):
        return bert.bert_pretrain_loss(model, *batch)


def amp_model(config, level):
    """``TRAIN_CONFIGS[config]``'s model from seed 0, in float32 (O1) or
    through ``amp.decorate(level="O2", dtype="float16")`` (O2), and its
    AdamW (multi_precision, as ``train_optimizer``)."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.nlp import bert, gpt

    c = TRAIN_CONFIGS[config]
    g = torch.Generator(device="cuda").manual_seed(0)
    if c["model"] == "bert_base":
        model = bert.BertForPretraining(bert.bert_base(dropout=c["dropout"]),
                                        generator=g)
    else:
        model = gpt.GPT(gpt.gpt_small(dropout=c["dropout"]), generator=g)
    opt = train_optimizer(model, config)
    if level == "O2":
        model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    return model, opt


def amp_run(config, level, loss_fn, batch, mode, steps=AMP_STEPS):
    """``steps`` steps of ``config`` at ``level`` under a
    ``DynamicLossScaler()`` from seed 0's weights, the dropout generator
    reseeded: ``mode`` "graphed" (``TrainStep``), "eager" (its
    ``_eager_step``, with the kernels' calls tallied by type) or "plain"
    (op by op through the plain versions). Returns ``(losses, launches,
    tally, snapshot, scaler state, found flags, step walls ms)``."""
    import collections

    import torch

    from paddle_tpu_torch import amp, core
    from paddle_tpu_torch.framework import TrainStep
    from paddle_tpu_torch.ops import kernels

    model, opt = amp_model(config, level)
    core.seed(1)
    step = TrainStep(model, opt, loss_fn, scaler=amp.DynamicLossScaler())
    fn = step if mode == "graphed" else step._eager_step
    ctx = (dtype_tally() if mode == "eager" else contextlib.nullcontext(
        collections.Counter()))
    losses, found, walls = [], [], []
    with ctx as tally, (kernels.plain_versions() if mode == "plain"
                        else contextlib.nullcontext()):
        torch.cuda.synchronize()
        kernels.reset_launches()
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(fn(*batch)))
            found.append(bool(step.last_found_inf))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = kernels.launches()
    state = snapshot(model, opt)
    scaler = {k: v.item() for k, v in step._scaler_state.items()}
    del step, model, opt
    torch.cuda.empty_cache()
    return losses, launches, tally, state, scaler, found, walls


def scaler_rule(found, init=2.0 ** 15, decr_ratio=0.5, decr_every=1):
    """A dynamic loss scaler's state after the flags ``found``, on the
    host: the reference's rule (``paddle_tpu/amp/grad_scaler.py``), x2
    after 1000 clean steps; by default ``DynamicLossScaler()``'s, and
    with ``decr_ratio=0.8, decr_every=2`` static AMP's defaults. The
    scale is a float32 product, as on the device."""
    scale, good, bad = np.float32(init), 0, 0
    for f in found:
        good, bad = (0, bad + 1) if f else (good + 1, 0)
        if bad >= decr_every:
            scale, bad = max(scale * np.float32(decr_ratio),
                             np.float32(1.0)), 0
        elif good >= 1000:
            scale, good = scale * np.float32(2.0), 0
    return {"scale": float(scale), "good": good, "bad": bad}


def amp_compare(label, config, level, loss_fn, want_types, gpu):
    """Phase 21(a)-(c): ``config`` at ``level`` in float16 under the
    dynamic loss scaler, ``AMP_STEPS`` graphed steps, the same steps op by
    op, then through the plain versions. Gates: finite losses on the
    steps (a step the scaler skips still computed its loss; not every
    step may be skipped), graphed = op by op bitwise (losses,
    parameters, masters, moments, the scaler's state and its flags), the
    scaler's state equal to the reference's rule over the flags, the
    launch counts ``train_launches`` a step, every kernel call of the op
    by op run in the type ``want_types`` names for it, and the plain run's
    losses within ``F16_TRAIN_LOSS_TOL`` with the same steps skipped.
    ``loss_fn`` None: the config's own loss (O2 runs without
    ``auto_cast``). Returns the graphed run's launches and median replay
    ms."""
    import math

    from paddle_tpu_torch.ops import kernels

    model, _ = amp_model(config, level)
    plain_loss, batch, first = train_batch(model, config)
    loss_fn = loss_fn or plain_loss
    cfg = model.cfg
    B, L = batch[0].shape
    del model
    runs = {m: amp_run(config, level, loss_fn, batch, m)
            for m in ("graphed", "eager", "plain")}
    (g_loss, g_launch, _, g_state, g_scaler, g_found, g_walls) = \
        runs["graphed"]
    (e_loss, _, tally, e_state, e_scaler, e_found, e_walls) = runs["eager"]
    p_loss, p_launch, _, _, p_scaler, p_found, _ = runs["plain"]
    steady = sorted(g_walls[2:])[len(g_walls[2:]) // 2]
    log(f"amp {label}: {config} {level} float16 under DynamicLossScaler(), "
        f"batch {B} x {L}: graphed losses {g_loss}, flags {g_found}, "
        f"scaler {g_scaler}; step wall ms "
        + " ".join(f"{w:.1f}" for w in g_walls)
        + f" (median of the replays {steady:.2f} ms = "
        f"{B * L / steady * 1e3:.0f} tokens/s); op by op ms "
        + " ".join(f"{w:.1f}" for w in e_walls)
        + f"; launches {g_launch}; kernel calls by type op by op "
        f"{dict(tally)} [{gpu}]")
    check(all(math.isfinite(x) for x in g_loss) and not all(g_found),
          f"amp {label}: non-finite losses {g_loss} or every step skipped "
          f"({g_found})")
    check(abs(g_loss[0] - first) < LOSS_NEAR_LN_V,
          f"amp {label}: first loss {g_loss[0]} not within "
          f"{LOSS_NEAR_LN_V} of {first:.4f}")
    check(g_loss == e_loss,
          f"amp {label}: graphed losses {g_loss} != op by op {e_loss}")
    bad = same_bits(g_state, e_state)
    check(not bad and g_scaler == e_scaler and g_found == e_found,
          f"amp {label}: graphed and op by op differ in {bad[:4]} or the "
          f"scaler ({g_scaler} vs {e_scaler}, flags {g_found} vs "
          f"{e_found})")
    check(g_scaler == scaler_rule(g_found), f"amp {label}: scaler state "
          f"{g_scaler}, the rule gives {scaler_rule(g_found)}")
    want = train_launches(config, cfg, AMP_STEPS)
    check(g_launch == want, f"amp {label}: launches {g_launch}, want {want}")
    typed = {}
    for (name, dtype), n in tally.items():
        typed.setdefault(name, set()).add(dtype)
    for name, n in want.items():
        if n:
            check(typed.get(name) == {want_types[name.split("_")[0]]},
                  f"amp {label}: {name} ran in {typed.get(name)}, want "
                  f"{want_types[name.split('_')[0]]}")
    check(set(p_launch.values()) == {0},
          f"amp {label}: the plain run launched {p_launch}")
    diffs = [abs(a - b) for a, b in zip(g_loss, p_loss)]
    log(f"amp {label}: plain-version losses {p_loss}, flags {p_found}; "
        f"|diff| " + " ".join(f"{d:.2e}" for d in diffs)
        + f" (tol {F16_TRAIN_LOSS_TOL}); graphed = op by op bitwise "
        f"({len(g_state[0])} parameters, every optimizer state value, the "
        f"scaler); scaler = the reference's rule; kernel types "
        f"{ {k: sorted(v) for k, v in typed.items()} }")
    check(g_found == p_found and all(
        d <= F16_TRAIN_LOSS_TOL for d, f in zip(diffs, g_found) if not f),
          f"amp {label}: the kernel run's losses differ from the plain "
          f"versions' (or other steps were skipped)")
    del runs
    return g_launch, steady


def recompute_check(gpu):
    """Phase 21(d): bench_gpt's recipe (bfloat16 O2, dropout 0) with
    ``use_recompute=True``, ``AMP_STEPS`` graphed steps, against the same
    steps without recompute: losses, parameters and optimizer state
    bitwise equal; launches: the blocks' forward twice (LayerNorm
    forward 2 x 12 + 1 + 2 x 12 a step, flash forward 2 x 12), the rest
    as without; the peak device memory of each run logged."""
    import torch

    from paddle_tpu_torch import core
    from paddle_tpu_torch.framework import TrainStep
    from paddle_tpu_torch.ops import kernels

    config = "bench_gpt"
    out = {}
    for rc in (False, True):
        model = train_model(config)
        if rc:
            model.set_recompute(True)
        loss_fn, batch, _ = train_batch(model, config)
        core.seed(1)
        step = TrainStep(model, train_optimizer(model, config), loss_fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        losses, walls = [], []
        for _ in range(AMP_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(*batch)))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = kernels.launches()
        peak = torch.cuda.max_memory_allocated()
        steady = sorted(walls[2:])[len(walls[2:]) // 2]
        out[rc] = (losses, snapshot(model, step.optimizer), launches, peak,
                   steady)
        log(f"recompute {rc}: bench_gpt losses {losses}; step wall ms "
            + " ".join(f"{w:.1f}" for w in walls) + f" (median of the "
            f"replays {steady:.2f} ms); peak memory {peak / 2 ** 30:.2f} "
            f"GiB; launches {launches} [{gpu}]")
        cfg = model.cfg
        del step, model
        torch.cuda.empty_cache()
    base = train_launches(config, cfg, AMP_STEPS)
    want = dict(base)
    want["layer_norm_fwd"] += 2 * cfg.layers * AMP_STEPS
    want["flash_attention_fwd"] += cfg.layers * AMP_STEPS
    check(out[False][2] == base, f"recompute: without, launches "
          f"{out[False][2]}, want {base}")
    check(out[True][2] == want, f"recompute: launches {out[True][2]}, "
          f"want {want}")
    check(out[True][0] == out[False][0], f"recompute: losses "
          f"{out[True][0]} != {out[False][0]} without")
    bad = same_bits(out[True][1], out[False][1])
    check(not bad, f"recompute: parameters or state differ in {bad[:4]}")
    log(f"recompute: {AMP_STEPS} graphed steps = the same steps without "
        f"recompute bitwise; peak memory {out[True][3] / 2 ** 30:.2f} GiB "
        f"vs {out[False][3] / 2 ** 30:.2f} GiB without; replay "
        f"{out[True][4]:.2f} ms vs {out[False][4]:.2f} ms [{gpu}]")
    return out[True][2], {rc: (v[3], v[4]) for rc, v in out.items()}


def static_amp_program(kind):
    """A static program under ``static_decorator.decorate(dtype=
    "float16")`` in its own Scope and name generator: ``"lenet"``, phase
    18(a)'s bench_lenet_exec program (Momentum(0.01, 0.9)), or
    ``"ln_ce"``, phase 18(b)'s ``STATIC_LN_CE`` program trained by SGD
    (0.01). Returns ``(main, loss, decorated optimizer, scope, feeds)``."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import nn, optim
    from paddle_tpu_torch.amp import static_decorator
    from paddle_tpu_torch.models.vision import LeNet
    from paddle_tpu_torch.utils import unique_name

    scope = pt.static.Scope()
    pt.seed(0)
    with unique_name.guard(), pt.static.scope_guard(scope):
        pt.enable_static()
        try:
            main = pt.static.Program()
            with pt.program_guard(main, pt.static.Program()):
                if kind == "lenet":
                    xv = pt.static.data("x", [LENET_BATCH, 1, 28, 28],
                                        "float32")
                    yv = pt.static.data("y", [LENET_BATCH], "int64")
                    model = LeNet()
                    loss = F.cross_entropy(model(xv), yv)
                    opt = optim.Momentum(0.01, 0.9,
                                         parameters=model.parameters())
                    x, y = lenet_batch()
                    feeds = {"x": x, "y": y}
                else:
                    c = STATIC_LN_CE
                    xv = pt.static.data("x", [c["rows"], c["hidden"]],
                                        "float32")
                    lab = pt.static.data("label", [c["rows"]], "int64")
                    layers = (nn.Linear(c["hidden"], c["hidden"]),
                              nn.LayerNorm(c["hidden"]),
                              nn.Linear(c["hidden"], c["vocab"]))
                    h = xv
                    for m in layers:
                        h = m(h)
                    loss = F.cross_entropy(h, lab)
                    opt = optim.SGD(0.01, parameters=[
                        p for m in layers for p in m.parameters()])
                    rng = np.random.RandomState(0)
                    feeds = {"x": rng.randn(c["rows"], c["hidden"]).astype(
                                 "float32"),
                             "label": rng.randint(0, c["vocab"], c["rows"])
                             .astype("int64")}
                dec = static_decorator.decorate(opt, dtype="float16")
                dec.minimize(loss)
        finally:
            pt.disable_static()
    return main, loss, dec, scope, feeds


def static_amp_check(gpu):
    """Phase 21(e): each ``static_amp_program`` for ``AMP_STEPS`` steps
    through the Executor's CUDA graph and the same steps op by op
    (``use_cuda_graph=False``) from the same Scope state, LeNet's third
    batch with an inf in one pixel: losses, found-inf flags and every
    persistable (parameters, optimizer slots, ``@amp@scale`` and its
    counters) bitwise equal; the inf step leaves the parameters as they
    were; ``@amp@scale`` as the reference's rule gives it (2^15, x0.8
    after every 2 overflows in a row). LN/CE's program launches the
    LayerNorm and cross-entropy kernels once each a step, in float32
    (black-listed), by counts and by type."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernels

    for kind in ("lenet", "ln_ce"):
        main, loss, dec, scope, feeds = static_amp_program(kind)
        init = scope_state(main, scope)
        runs = {}
        for graphed in (True, False):
            restore_scope(scope, init)
            exe = pt.static.Executor(use_cuda_graph=graphed)
            losses, flags, walls = [], [], []
            ctx = (contextlib.nullcontext() if graphed else dtype_tally())
            with pt.static.scope_guard(scope), ctx as tally:
                torch.cuda.synchronize()
                kernels.reset_launches()
                for i in range(AMP_STEPS):
                    f = dict(feeds)
                    if kind == "lenet" and i == 2:
                        f["x"] = f["x"].copy()
                        f["x"][0, 0, 0, 0] = np.inf
                    before = scope_state(main, scope)
                    t0 = time.perf_counter()
                    lv, fi = exe.run(main, feed=f,
                                     fetch_list=[loss, "@amp@found_inf"])
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                    losses.append(float(lv))
                    flags.append(bool(fi))
                    if fi:
                        after = scope_state(main, scope)
                        moved = [n for n in before if not n.startswith(
                            "@amp@") and not torch.equal(before[n],
                                                         after[n])]
                        check(not moved, f"static-amp {kind}: the inf "
                              f"step moved {moved[:4]}")
                launches = kernels.launches()
            runs[graphed] = (losses, flags, scope_state(main, scope),
                             launches, tally, walls, exe.captures)
        (gl, gf, gs, glaunch, _, gw, caps), (el, ef, es, _, tally, ew, _) = \
            runs[True], runs[False]
        scale = float(gs["@amp@scale"])
        rule = scaler_rule(gf, decr_ratio=0.8, decr_every=2)["scale"]
        log(f"static-amp {kind}: float16 losses {gl}, found-inf {gf}, "
            f"@amp@scale {scale} (rule {rule}); step wall ms graphed "
            + " ".join(f"{w:.1f}" for w in gw) + ", op by op "
            + " ".join(f"{w:.1f}" for w in ew) + f"; {caps} capture(s); "
            f"launches {glaunch}; kernel calls by type op by op "
            f"{dict(tally)} [{gpu}]")
        # the inf step's loss is NaN in both
        check(np.array_equal(gl, el, equal_nan=True) and gf == ef,
              f"static-amp {kind}: graphed {gl} {gf} != op by op {el} {ef}")
        diff = [n for n in gs if not torch.equal(gs[n], es[n])]
        check(not diff, f"static-amp {kind}: graphed and op by op differ "
              f"in {diff[:4]}")
        check(scale == rule, f"static-amp {kind}: @amp@scale {scale}, the "
              f"rule gives {rule}")
        check((kind == "lenet") == any(gf), f"static-amp {kind}: found-inf "
              f"flags {gf}")
        if kind == "ln_ce":
            one = {"layer_norm_fwd": AMP_STEPS, "layer_norm_bwd": AMP_STEPS,
                   "softmax_ce_fwd": AMP_STEPS, "softmax_ce_bwd": AMP_STEPS}
            check({k: v for k, v in glaunch.items() if v} == one,
                  f"static-amp ln_ce: launches {glaunch}, want {one}")
            check(set(tally) == {(k, "torch.float32") for k in one},
                  f"static-amp ln_ce: kernel calls by type {dict(tally)}")
        else:
            check(set(glaunch.values()) == {0}, f"static-amp lenet: "
                  f"launches {glaunch}")
        del main, scope
        torch.cuda.empty_cache()


def amp_phase(gpu):
    """Phase 21: float16 mixed precision and recompute on the card:
    ``fp16_kernel_phase``; (a) bench_gpt under ``auto_cast(float16)``
    (O1: float32 parameters, float16 flash, float32 LayerNorm and
    cross-entropy); (b) bench_gpt at O2 float16 (``amp.decorate``,
    multi_precision AdamW: every kernel in float16); (c) bench_bert under
    O1 float16 (BASELINE config 3's fp16 AMP on one chip: LayerNorm in
    float32, attention and cross-entropy dense); (d) recompute; (e)
    static AMP; then the float16 kernels timed at bench_gpt's shapes.
    Returns ``(errs, timings, launches)``: the float16 kernels' largest
    errors, their timing rows and the launches of the run each row
    belongs to (flash: O1; LayerNorm and cross-entropy: O2)."""
    import torch

    t0 = time.perf_counter()
    errs = fp16_kernel_phase()
    f32, f16 = "torch.float32", "torch.float16"
    launch_o1, _ = amp_compare(
        "O1 gpt", "bench_gpt", "O1", o1_gpt_loss,
        {"layer": f32, "softmax": f32, "flash": f16}, gpu)
    launch_o2, _ = amp_compare(
        "O2 gpt", "bench_gpt", "O2", None,
        {"layer": f16, "softmax": f16, "flash": f16}, gpu)
    amp_compare("O1 bert", "bench_bert", "O1", o1_bert_loss,
                {"layer": f32}, gpu)
    recompute_check(gpu)
    static_amp_check(gpu)
    t = train_timing_phase(gpu, 16384, torch.float16)
    t.update(flash_timing_phase(gpu, torch.float16))
    launches = {name: (launch_o1 if name.startswith("flash") else
                       launch_o2)[name] for name in t}
    log(f"amp: phase took {time.perf_counter() - t0:.1f} s")
    return errs, t, launches

# -- phase 22: the rest of Paddle's optimizers, initializers and reports ------

RARE_RULES = ("ftrl", "decayed_adagrad", "lars_momentum", "dgc_momentum",
              "dpsgd")
# a rule's float32 update against its plain float64 formula, relative to
# the formula's largest |update| (each case's update is >= 1e4 float32
# steps of the weight)
RULE_TOL = 1e-4
INIT_SHAPE = (768, 3072)      # gpt_small's fc1 weight: fan_in 768, out 3072
INIT_STD_RTOL = 0.01          # 2.36M draws: the std within 1%
ORTHO_TOL = 1e-4              # |QᵀQ - I| of a float32 QR, 3072 x 768
TRUNC_STD = 0.8796256610342398   # std of N(0, 1) truncated to [-2, 2]
RARE_TIMED = 5


def rare_optimizer(kind, params):
    """bench_gpt's optimizer with the rule ``kind`` in AdamW's place:
    ``multi_precision``, global-norm clip 1.0 (Dpsgd clips by its own
    norm), learning rates at which the 4 steps stay finite."""
    from paddle_tpu_torch import optim

    kw = dict(parameters=params, multi_precision=True)
    clip = optim.ClipGradByGlobalNorm(1.0)
    if kind == "adamw":
        return optim.AdamW(parameters=params, learning_rate=1e-4,
                           weight_decay=0.01, grad_clip=clip,
                           multi_precision=True)
    if kind == "ftrl":
        return optim.Ftrl(1e-4, l1=1e-6, l2=1e-6, grad_clip=clip, **kw)
    if kind == "decayed_adagrad":
        return optim.DecayedAdagrad(1e-4, decay=0.95, grad_clip=clip, **kw)
    if kind == "lars_momentum":
        return optim.LarsMomentum(0.1, momentum=0.9, lars_coeff=0.001,
                                  lars_weight_decay=0.0005, grad_clip=clip,
                                  **kw)
    if kind == "dgc_momentum":
        return optim.DGCMomentum(1e-3, 0.9, rampup_begin_step=1,
                                 sparsity=(0.999,), grad_clip=clip, **kw)
    return optim.Dpsgd(1e-3, clip=1.0, batch_size=16.0, sigma=1.0, **kw)


# each rule's case in ``rule_value_check``: learning rate, gradient
# scale; Lars's gradient norm is of the size of ``lars_weight_decay *
# |p|``, so its decay term weighs as much as the gradient's
RULE_CASES = {"ftrl": (0.01, 1e-2), "decayed_adagrad": (0.01, 1e-2),
              "lars_momentum": (10.0, 1e-5), "dgc_momentum": (0.01, 1e-2),
              "dpsgd": (10.0, 1e-2)}


def plain_rule(kind, p, g, steps):
    """``steps`` updates of ``p`` by ``g`` (float64 copies) written out
    from the reference's formulas (``paddle_tpu/optim/optimizer.py``), at
    ``rule_value_check``'s hyperparameters."""
    import torch

    lr = RULE_CASES[kind][0]
    p, g = p.double(), g.double()
    s = torch.zeros_like(p)           # squared / moment / velocity
    z = torch.zeros_like(p)           # Ftrl's linear
    for _ in range(steps):
        if kind == "ftrl":           # l1 1e-6, l2 1e-2, lr_power -0.5
            n = s + g * g
            z = z + g - (n.sqrt() - s.sqrt()) / lr * p
            s = n
            p = torch.where(z.abs() > 1e-6,
                            (z.sign() * 1e-6 - z) / (n.sqrt() / lr + 2e-2),
                            torch.zeros_like(p))
        elif kind == "decayed_adagrad":          # decay 0.9, eps 1e-6
            s = 0.9 * s + 0.1 * g * g
            p = p - lr * g / (s.sqrt() + 1e-6)
        elif kind == "lars_momentum":   # mu 0.9, coeff 1e-3, decay 5e-4
            wn, gn = p.norm(), g.norm()
            local = lr * 1e-3 * wn / (gn + 5e-4 * wn).clamp(min=1e-12)
            s = 0.9 * s + local * (g + 5e-4 * p)
            p = p - s
        elif kind == "dgc_momentum":     # mu 0.9
            s = 0.9 * s + g
            p = p - lr * s
        else:                            # sigma 0, clip 0.5, batch 4
            p = p - lr * g * min(1.0, 0.5 / max(float(g.norm()), 1e-12))
    return p


def rule_value_check(kind, device="cuda", steps=3):
    """``steps`` updates of ``kind`` (``RULE_CASES``) on a (768, 3072)
    float32 weight against ``plain_rule``: the update within
    ``RULE_TOL`` of the plain one's largest magnitude. Returns the worst
    relative difference."""
    import torch

    from paddle_tpu_torch import optim

    lr, scale = RULE_CASES[kind]
    gen = torch.Generator(device=device).manual_seed(22)
    p0 = torch.randn(INIT_SHAPE, generator=gen, device=device) * 0.02
    g = torch.randn(INIT_SHAPE, generator=gen, device=device) * scale
    p = torch.nn.Parameter(p0.clone())
    opt = {"ftrl": lambda ps: optim.Ftrl(lr, l1=1e-6, l2=1e-2,
                                         parameters=ps),
           "decayed_adagrad": lambda ps: optim.DecayedAdagrad(
               lr, decay=0.9, parameters=ps),
           "lars_momentum": lambda ps: optim.LarsMomentum(
               lr, momentum=0.9, parameters=ps),
           "dgc_momentum": lambda ps: optim.DGCMomentum(lr, 0.9,
                                                        parameters=ps),
           "dpsgd": lambda ps: optim.Dpsgd(lr, clip=0.5, batch_size=4.0,
                                           sigma=0.0, parameters=ps),
           }[kind]([("w", p)])
    for _ in range(steps):
        p.grad = g.clone()
        opt.step()
    want = plain_rule(kind, p0, g, steps) - p0.double()
    got = p.detach().double() - p0.double()
    err = float((got - want).abs().max() / want.abs().max())
    check(err <= RULE_TOL, f"rare {kind}: the update differs from the "
          f"plain formula's by {err:.3g} of its largest magnitude "
          f"(limit {RULE_TOL})")
    return err


def rule_run(model, init, loss_fn, batches, eager, make_opt, run_dir,
             timed=0, each=None):
    """``len(batches)`` steps of bench_gpt from ``init`` under
    ``make_opt(model)``, the device's generator reseeded, through the
    graphed ``TrainStep`` or its ``_eager_step``, every step journaled
    under ``run_dir`` (loss, wall, tokens) as a training loop journals
    it and followed by ``each()``; launches counted over those steps and
    the state ``snapshot`` after them; then ``timed`` more steps,
    journaled too. Returns ``(step, losses, walls, launches, timed
    walls, state)``."""
    import torch

    from paddle_tpu_torch import core
    from paddle_tpu_torch.framework import TrainStep
    from paddle_tpu_torch.obs import journal
    from paddle_tpu_torch.ops import kernels

    model.load_state_dict(init)
    core.seed(1)
    step = TrainStep(model, make_opt(model), loss_fn)
    fn = step._eager_step if eager else step
    B, L = batches[0][0].shape
    walls, losses, more = [], [], []
    with journal.RunJournal(run_dir, flush_every=64) as j:
        def one(b, into):
            t0 = time.perf_counter()
            loss = float(fn(*b))   # syncs on the loss
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            into.append(ms)
            j.record_step(loss=loss, step_ms=ms, examples=B * L,
                          source="train_step")
            if each is not None:
                each()
            return loss

        torch.cuda.synchronize()
        kernels.reset_launches()
        losses = [one(b, walls) for b in batches]
        launches = kernels.launches()
        state = snapshot(model, step.optimizer)
        for _ in range(timed):
            one(batches[0], more)
    return step, losses, walls, launches, more, state


def rule_compare(kind, model, init, loss_fn, batch, gpu, journals,
                 steps=4):
    """bench_gpt's step under ``kind`` (``rare_optimizer``): ``steps``
    graphed steps against ``steps`` op-by-op ones from the same weights
    and generator seed, the same bits in losses, parameters, masters and
    state; launches ``train_launches``; finite losses; then
    ``RARE_TIMED`` replays timed. AdamW is timed alone, beside them
    (phase 14 compares it). Returns the median replay's ms."""
    import math

    import torch

    B, L = batch[0].shape
    runs = {}
    for eager in ((False, True) if kind != "adamw" else (False,)):
        tag = "eager" if eager else "graphed"
        step, losses, walls, launches, more, state = rule_run(
            model, init, loss_fn, [batch] * steps, eager,
            lambda m: rare_optimizer(kind, m.named_parameters()),
            os.path.join(journals, "rules", f"{kind}_{tag}"),
            0 if eager else RARE_TIMED)
        runs[tag] = (losses, state, more)
        want = train_launches("bench_gpt", model.cfg, steps)
        check(launches == want, f"rare {kind} {tag}: launches {launches}, "
              f"want {want}")
        check(all(math.isfinite(x) for x in losses),
              f"rare {kind} {tag}: losses {losses}")
        del step
    losses, state, more = runs["graphed"]
    med = sorted(more)[len(more) // 2]
    if kind != "adamw":
        bad = same_bits(state, runs["eager"][1])
        check(losses == runs["eager"][0] and not bad,
              f"rare {kind}: graphed and op by op differ (losses "
              f"{losses} vs {runs['eager'][0]}; {len(bad)} tensors, e.g. "
              f"{bad[:4]})")
    log(f"rare {kind} (bench_gpt, 16 x 1024 bf16, multi_precision): "
        f"losses {losses}; graphed = op by op bitwise; launches "
        f"25/25/1/1/12/12/12 a step; replay ms "
        + " ".join(f"{w:.2f}" for w in more) + f" (median {med:.2f} ms "
        f"= {B * L / med * 1e3:.0f} tokens/s) [{gpu}]")
    del runs
    torch.cuda.empty_cache()
    return med


def dpsgd_noise_check(model, init, batch, gpu):
    """Dpsgd's noise in the graphed step: with the loss times 0 (zero
    gradients), lr 1, clip 1, batch_size 1, sigma 1, each replay moves
    every float32 master by minus its noise: the two replays' moves of
    the largest master differ and each has mean 0 and std 1 (within 1%)."""
    import torch

    from paddle_tpu_torch import core, optim
    from paddle_tpu_torch.framework import TrainStep
    from paddle_tpu_torch.models.nlp import gpt

    model.load_state_dict(init)
    core.seed(1)
    opt = optim.Dpsgd(1.0, clip=1.0, batch_size=1.0, sigma=1.0,
                      parameters=model.named_parameters(),
                      multi_precision=True)
    step = TrainStep(model, opt,
                     lambda m, *b: gpt.gpt_loss(m, *b) * 0.0)
    name = max(opt._named_params, key=lambda np_: np_[1].numel())[0]
    masters = []
    for _ in range(4):
        step(*batch)
        masters.append(opt._accumulators[name]["master"].clone())
    d3, d4 = masters[2] - masters[1], masters[3] - masters[2]
    stats = [(float(d.mean()), float(d.std())) for d in (d3, d4)]
    check(not torch.equal(d3, d4), "rare dpsgd: two replays drew the same "
          "noise")
    check(all(abs(m) < 0.01 and abs(s - 1) < 0.01 for m, s in stats),
          f"rare dpsgd: replay noise (mean, std) {stats}, want (0, 1)")
    log(f"rare dpsgd noise: replays 3 and 4 of {name} ({d3.numel()} "
        f"values) moved by fresh noise, (mean, std) {stats} [{gpu}]")
    del step, opt, masters
    torch.cuda.empty_cache()


def wrapper_check(model, init, loss_fn, batch, gpu, journals, steps=4):
    """bench_gpt's graphed AdamW step with ``ExponentialMovingAverage``
    (decay 0.999, ``thres_steps``) updated and ``ModelAverage`` stepped
    after each replay: the EMA shadows equal their arithmetic written
    out (bfloat16 scalars, as the reference's weak types), the average
    the float32 sum over the steps divided by their count; ``apply()``
    sets them and ``restore()`` gives every parameter back bitwise."""
    import torch

    from paddle_tpu_torch import optim

    snaps = []

    def each():
        ema.update()
        ma.step()
        snaps.append({n: p.detach().clone()
                      for n, p in model.named_parameters()})

    model.load_state_dict(init)
    ema = optim.ExponentialMovingAverage(model, decay=0.999, thres_steps=1)
    ma = optim.ModelAverage(0.15, model, min_average_window=2,
                            max_average_window=10)
    step, _, _, _, _, _ = rule_run(
        model, init, loss_fn, [batch] * steps, False,
        lambda m: rare_optimizer("adamw", m.named_parameters()),
        os.path.join(journals, "wrappers"), each=each)
    params = dict(model.named_parameters())
    shadow = {n: init[n].clone() for n in params}
    total = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    for t, snap in enumerate(snaps, 1):
        d = min(0.999, (1 + t) / (10 + t))
        for n, s in shadow.items():
            full = torch.full((), d, dtype=s.dtype, device=s.device)
            rest = torch.full((), 1 - d, dtype=s.dtype, device=s.device)
            shadow[n] = full * s + rest * snap[n]
            total[n] += snap[n].float()
    last = snaps[-1]
    for label, wrapper, want in (
            ("EMA", ema, shadow),
            ("ModelAverage", ma, {n: (v / steps).to(params[n].dtype)
                                  for n, v in total.items()})):
        wrapper.apply()
        bad = [n for n, p in params.items() if not torch.equal(p, want[n])]
        check(not bad, f"rare {label}: apply() differs from the plain "
              f"arithmetic in {len(bad)} parameters, e.g. {bad[:3]}")
        wrapper.restore()
        bad = [n for n, p in params.items() if not torch.equal(p, last[n])]
        check(not bad, f"rare {label}: restore() did not give back "
              f"{len(bad)} parameters, e.g. {bad[:3]}")
    log(f"rare wrappers: EMA (thres_steps) and ModelAverage after each of "
        f"{steps} replays: apply() = their plain arithmetic and restore() "
        f"= the trained parameters bitwise, {len(params)} parameters "
        f"[{gpu}]")
    del step, ema, ma, snaps, shadow, total
    torch.cuda.empty_cache()


def lookahead_check(model, init, batch, gpu, journals, steps=4):
    """``LookAhead(AdamW, alpha 0.5, k 2)`` over bench_gpt's model, 4 eager
    steps (``backward``, ``step``, ``clear_grad``), journaled: at steps 2
    and 4 every parameter is its slow weight pulled halfway to the fast
    weights the inner step left, ``slow + 0.5 * (fast - slow)`` in
    float32 rounded to bfloat16, and the slow weights are that sum."""
    import torch

    from paddle_tpu_torch import optim
    from paddle_tpu_torch.models.nlp import gpt
    from paddle_tpu_torch.obs import journal

    model.load_state_dict(init)
    la = optim.LookAhead(rare_optimizer("adamw", model.named_parameters()),
                         alpha=0.5, k=2)
    inner_step, fast = la.inner.step, {}

    def spy():
        inner_step()
        fast.update({n: p.detach().float()
                     for n, p in la.inner._named_params})

    la.inner.step = spy
    ids, labels = (torch.from_numpy(b).cuda() for b in batch)
    slow = {n: p.detach().float() for n, p in la.inner._named_params}
    losses = []
    with journal.RunJournal(os.path.join(journals, "lookahead")) as j:
        for k in range(1, steps + 1):
            t0 = time.perf_counter()
            loss = gpt.gpt_loss(model, ids, labels)
            loss.backward()
            la.step()
            la.clear_grad()
            losses.append(float(loss.detach()))
            j.record_step(loss=losses[-1],
                          step_ms=(time.perf_counter() - t0) * 1e3,
                          examples=ids.numel(), source="lookahead")
            if k % 2:
                continue
            bad = []
            for n, p in la.inner._named_params:
                want = slow[n] + 0.5 * (fast[n] - slow[n])
                if not (torch.equal(la._slow[n], want)
                        and torch.equal(p, want.to(p.dtype))):
                    bad.append(n)
                slow[n] = want
            check(not bad, f"rare lookahead: the pull at step {k} differs "
                  f"from slow + 0.5 * (fast - slow) in {len(bad)} "
                  f"parameters, e.g. {bad[:3]}")
    log(f"rare lookahead (AdamW, k 2): losses {losses}; the pulls at steps "
        f"2 and 4 = slow + 0.5 * (fast - slow) bitwise [{gpu}]")
    del la, fast, slow
    torch.cuda.empty_cache()


def init_check(gpu):
    """Each random initializer fills a (768, 3072) weight on the card: a
    uniform's bounds, every mean within 5 standard errors, every std
    within ``INIT_STD_RTOL`` of the one its law and the fans give,
    TruncatedNormal inside mean +- 2 std, Orthogonal's QQᵀ = I within
    ``ORTHO_TOL``; the same generator seed the same bits."""
    import math

    import torch

    from paddle_tpu_torch.nn import initializer as I

    fi, fo = INIT_SHAPE
    laws = {
        "Uniform(-0.3, 0.5)": (I.Uniform(-0.3, 0.5), "u", -0.3, 0.5),
        "Normal(0.1, 0.2)": (I.Normal(0.1, 0.2), "n", 0.1, 0.2),
        "TruncatedNormal(0.05, 0.02)": (I.TruncatedNormal(0.05, 0.02), "t",
                                        0.05, 0.02),
        "XavierUniform": (I.XavierUniform(), "u",
                          *(s * math.sqrt(6 / (fi + fo)) for s in (-1, 1))),
        "XavierNormal": (I.XavierNormal(), "n", 0.0,
                         math.sqrt(2 / (fi + fo))),
        "KaimingUniform": (I.KaimingUniform(), "u",
                           *(s * math.sqrt(2) * math.sqrt(3 / fi)
                             for s in (-1, 1))),
        "KaimingNormal": (I.KaimingNormal(), "n", 0.0,
                          math.sqrt(2) / math.sqrt(fi)),
    }
    out = []
    for label, (init, law, a, b) in laws.items():
        x = init(INIT_SHAPE, generator=torch.Generator(
            device="cuda").manual_seed(0))
        again = init(INIT_SHAPE, generator=torch.Generator(
            device="cuda").manual_seed(0))
        check(x.is_cuda and torch.equal(x, again),
              f"rare init {label}: the same seed gave other bits")
        xd = x.double()
        if law == "u":
            mean, std = (a + b) / 2, (b - a) / math.sqrt(12)
            check(float(xd.min()) >= a and float(xd.max()) < b,
                  f"rare init {label}: values outside [{a}, {b})")
        elif law == "n":
            mean, std = a, b
        else:
            mean, std = a, b * TRUNC_STD
            check(float(xd.min()) >= a - 2 * b and
                  float(xd.max()) <= a + 2 * b,
                  f"rare init {label}: values outside mean +- 2 std")
        m, s = float(xd.mean()), float(xd.std())
        check(abs(m - mean) < 5 * std / math.sqrt(x.numel())
              and abs(s / std - 1) < INIT_STD_RTOL,
              f"rare init {label}: mean {m}, std {s}, want {mean}, {std}")
        out.append(f"{label} mean {m:.3g} std {s:.4g} (want {std:.4g})")
    q = I.Orthogonal()(INIT_SHAPE, generator=torch.Generator(
        device="cuda").manual_seed(0)).double()
    err = float((q @ q.T - torch.eye(fi, dtype=torch.float64,
                                     device="cuda")).abs().max())
    check(err <= ORTHO_TOL, f"rare init Orthogonal: |QQᵀ - I| {err}")
    log(f"rare init {INIT_SHAPE} on the card: " + "; ".join(out)
        + f"; Orthogonal |QQᵀ - I| {err:.3g}; same seed, same bits [{gpu}]")


def static_journal_check(gpu, journals):
    """A static LeNet ``Executor.run`` (4 calls), a ``run_steps`` window
    (K 2) and a ``Predictor.run`` (3 calls, B 100, bucketed) under an
    active journal: one ``executor`` step record a call (``steps_fused``
    2 on the window), ``predictor`` records with the caller's batch as
    their examples, the losses the ones ``run`` returned."""
    import json as _json

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.obs import journal

    run_dir = os.path.join(journals, "static")
    main, startup, loss, _, scope = lenet_program()
    x, y = lenet_batch()
    exe = pt.static.Executor()
    with pt.static.scope_guard(scope):
        exe.run(startup)
        journal.start_run(run_dir)
        try:
            losses = [float(exe.run(main, feed={"x": x, "y": y},
                                    fetch_list=[loss])[0])
                      for _ in range(4)]
            exe.run_steps(main, feeds=[{"x": x, "y": y}] * 2,
                          fetch_list=[loss])
            prefix, _, _, _, _ = int8_bundles(run_dir)
            pred, _ = int8_predict(prefix, x)
            for _ in range(3):
                pred.run({"x": x[:100]})
        finally:
            journal.end_run()
    with open(os.path.join(run_dir, "journal.jsonl")) as f:
        steps = [r for r in map(_json.loads, f) if r["t"] == "step"]
    srcs = [s["source"] for s in steps]
    check(srcs == ["executor"] * 5 + ["predictor"] * 4
          and [s["loss"] for s in steps[:4]] == losses
          and steps[4].get("steps_fused") == 2
          and [s["examples"] for s in steps[5:]] == [256, 100, 100, 100],
          f"rare static journal: step records {srcs}, "
          f"{[s.get('examples') for s in steps]}")
    log(f"rare static journal: {len(steps)} step records (4 run, 1 "
        f"run_steps K 2, 4 Predictor.run), losses = run's [{gpu}]")
    return run_dir


def report_tool(name):
    """``tools/torch_<name>_report.py`` of this checkout, as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", f"torch_{name}_report.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}_report",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def report(name, *argv):
    """``(exit code, stdout)`` of ``torch_<name>_report`` on ``argv``."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = report_tool(name).main(list(argv))
    return rc, buf.getvalue()


def report_check(gpu, journals):
    """The five report tools over this run's journals: ``torch_run_report``
    renders each rule's run and the static one and ``--diff``s Lars
    against DGC; ``torch_fleet_report`` and ``torch_request_report``
    render the kill drill's run (phase 13), ``torch_slo_report`` (with
    ``SERVE_SLO_SPEC``), ``torch_usage_report`` and
    ``torch_request_report`` the serve bench's journal (phase 19,
    against the leg's ``SERVE_SLO_SPEC``)."""
    rules = os.path.join(journals, "rules")
    seen = []
    for kind in RARE_RULES:
        rc, out = report("run", os.path.join(rules, f"{kind}_graphed"),
                         "--json")
        rep = json.loads(out)
        check(rc == 0 and len(rep["steps"]) == 4 + RARE_TIMED,
              f"rare run_report {kind}: rc {rc}, {len(rep['steps'])} steps")
    rc, text = report("run", os.path.join(rules, "lars_momentum_graphed"))
    check(rc == 0 and "step" in text, "rare run_report: no table")
    rc, out = report("run", "--diff",
                     os.path.join(rules, "lars_momentum_graphed"),
                     os.path.join(rules, "dgc_momentum_graphed"), "--json")
    diff = json.loads(out)
    check(rc in (0, 1) and "regression" in diff,
          f"rare run_report --diff: rc {rc}")
    seen.append(f"run_report: 5 rules rendered, lars vs dgc mean step "
                f"{diff.get('base_mean_step_ms')} -> "
                f"{diff.get('new_mean_step_ms')} ms (regression "
                f"{diff['regression']})")
    rc, out = report("run", os.path.join(journals, "static"), "--json")
    check(rc == 0 and len(json.loads(out)["steps"]) == 9,
          "rare run_report: the static journal")
    drill = os.path.join(journals, "fleet_drill", "run")
    rc, out = report("fleet", drill, "--json")
    agg = json.loads(out)
    check(rc == 0 and agg.get("nranks", 0) >= 2,
          f"rare fleet_report: rc {rc}, nranks {agg.get('nranks')}")
    rc, out = report("request", drill, "--json")
    check(rc == 0 and json.loads(out)["requests"] > 0,
          "rare request_report: the drill")
    seen.append(f"fleet_report: {agg['nranks']} ranks; request_report: "
                f"the drill's requests")
    serve = os.path.join(journals, "serve_bench", "full")
    rc, out = report("slo", serve, "--json", "--spec",
                     json.dumps(serve_bench_tool().SERVE_SLO_SPEC))
    slo = json.loads(out)
    check(rc == 0 and slo["evaluation"]["violations"] == [],
          f"rare slo_report: rc {rc}, {slo.get('evaluation')}")
    rc, out = report("usage", serve, "--json")
    usage = json.loads(out)
    check(rc == 0 and set(usage["tenants"]) == {"a", "b"},
          f"rare usage_report: rc {rc}, tenants {usage.get('tenants')}")
    rc, out = report("request", serve, "--json")
    check(rc == 0 and json.loads(out)["requests"] == SERVE_BENCH["requests"],
          f"rare request_report: the serve bench: {out[:200]}")
    seen.append("slo_report: no violation; usage_report: tenants "
                + ", ".join(f"{t} {r['device_ns']} device-ns"
                            for t, r in sorted(usage["tenants"].items())))
    log("rare reports: " + "; ".join(seen) + f" [{gpu}]")


def rare_phase(gpu, journals):
    """Phase 22: the rest of Paddle's optimizers, the wrappers, the
    initializers and the report tools. Returns each rule's median replay
    ms."""
    import torch

    t0 = time.perf_counter()
    errs = {kind: rule_value_check(kind) for kind in RARE_RULES}
    log("rare rules against their plain formulas (relative): "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    model = train_model("bench_gpt")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    loss_fn, batch, _ = train_batch(model, "bench_gpt")
    ms = {kind: rule_compare(kind, model, init, loss_fn, batch, gpu,
                             journals)
          for kind in ("adamw",) + RARE_RULES}
    dpsgd_noise_check(model, init, batch, gpu)
    wrapper_check(model, init, loss_fn, batch, gpu, journals)
    lookahead_check(model, init, batch, gpu, journals)
    del model, init
    torch.cuda.empty_cache()
    init_check(gpu)
    static_journal_check(gpu, journals)
    report_check(gpu, journals)
    log(f"rare: phase took {time.perf_counter() - t0:.1f} s")
    return ms


# -- phase 23: the layer library (the book's sentiment nets) ------------------

SENT_VOCAB = 5148        # paddle_tpu/dataset/imdb.py:9, the synthetic dict
SENT_BATCH = 128
SENT_LEN = 63            # ids padded to the reader's longest sentence
SENT_MIN_LEN = 16        # the synthetic reader's shortest (imdb.py:18-22)
SENT_LR = 1e-2           # tests/book/test_nlp_models.py:20-23's Adam
SENT_STEPS = 4
SENT_TIMED = 5
# the stacked LSTM's first loss at init: within this of ln 2 (its pooled
# outputs are small). The text-CNN's is not near ln 2: each filter's
# tanh, max-pooled over 63+ steps, sits near 1 for every row, so its
# logits are two sums of ~256 Xavier weights (std ~1.4), about the same
# for every row; its first loss (2.44 on an H100 80GB HBM3 at 700 W, PR
# 19) is held to the float64 reference below instead, as the LSTM's is
SENT_LOSS_NEAR = 0.5
# the first step's loss against a float64 CPU forward of the same weights,
# batch and dropout mask (sentiment_reference_loss): float32 sums over at
# most 63 LSTM steps or 512-term conv windows, absolute
SENT_REF_TOL = 1e-4
# the nets at the JAX package's default widths (sentiment.py:25-26, 50-51)
SENT_NETS = {
    "lstm": dict(embed_dim=128, hidden=128, num_layers=3, num_classes=2,
                 dropout=0.2),
    "conv": dict(embed_dim=128, num_filters=128, widths=(3, 4),
                 num_classes=2, dropout=0.2),
}
# the layers (a) and (b) run: none of them may change its bits between
# two runs on the card
SENT_PATH_LAYERS = {"Embedding", "LSTM", "Conv1D", "Linear", "Dropout"}
# phase 23(c): a layer on the card against the same layer on the CPU, both
# float32 (TF32 off): sums in other orders and CUDA's own exp/log/tanh,
# a few ulps each, as a share of the largest |value| of each array
LAYER_F32_TOL = 1e-4


def sentiment_batch(device):
    """RandomState(0): ``SENT_BATCH`` rows of ids in [2, vocab) padded
    with 0 past each row's length (drawn in [16, 63]), labels in {0, 1},
    and the lengths; int64 tensors on ``device``."""
    import torch

    rng = np.random.RandomState(0)
    n = rng.randint(SENT_MIN_LEN, SENT_LEN + 1, SENT_BATCH)
    ids = rng.randint(2, SENT_VOCAB, (SENT_BATCH, SENT_LEN))
    ids[np.arange(SENT_LEN)[None] >= n[:, None]] = 0
    y = rng.randint(0, 2, SENT_BATCH)
    return [torch.from_numpy(a.astype(np.int64)).to(device)
            for a in (ids, y, n)]


def sentiment_loss(kind):
    """``loss_fn(model, ids, y, lengths)``: the LSTM reads the lengths as
    its ``seq_len``, the text-CNN does not."""
    from paddle_tpu_torch.nn import functional as F

    if kind == "lstm":
        return lambda m, ids, y, n: F.cross_entropy(m(ids, n), y)
    return lambda m, ids, y, n: F.cross_entropy(m(ids), y)


def sentiment_net(kind, device="cuda"):
    """The phase's ``kind`` net on ``device``, weights from seed 0."""
    import torch

    from paddle_tpu_torch.models.nlp import (ConvSentiment,
                                             StackedLSTMSentiment)

    cls = StackedLSTMSentiment if kind == "lstm" else ConvSentiment
    return cls(SENT_VOCAB, **SENT_NETS[kind], device=device,
               generator=torch.Generator(device).manual_seed(0))


def sentiment_reference_loss(kind, state, batch, device="cuda", p=None):
    """The first step's loss, recomputed in float64 on the CPU with plain
    torch ops from the net's weights ``state``: the embedding rows, the
    convs (or the LSTM's cells, masked at each row's padded steps), tanh
    and the max over time, the dropout (rate ``p``, default the phase's)
    with the mask the first step draws (``device``'s generator from seed
    1: the path's first draw), the FC and the cross-entropy."""
    import torch
    import torch.nn.functional as F

    sd = {k: v.detach().double().cpu() for k, v in state.items()}
    ids, y, n = [b.cpu() for b in batch]
    x = sd["embed.weight"][ids]                       # (B, L, E)
    if kind == "conv":
        feats, i = [], 0
        while f"convs.{i}.weight" in sd:
            w = sd[f"convs.{i}.weight"]
            h = F.conv1d(x.transpose(1, 2), w, sd[f"convs.{i}.bias"],
                         padding=w.shape[-1] // 2)
            feats.append(torch.tanh(h).amax(-1))
            i += 1
        h = torch.cat(feats, -1)
    else:
        i = 0
        while f"lstm.{i}.weight_ih" in sd:
            w_ih, w_hh = sd[f"lstm.{i}.weight_ih"], sd[f"lstm.{i}.weight_hh"]
            b = sd[f"lstm.{i}.bias_ih"] + sd[f"lstm.{i}.bias_hh"]
            H = w_hh.shape[1]
            hs = cs = torch.zeros(x.shape[0], H, dtype=torch.float64)
            outs = []
            for t in range(x.shape[1]):
                gi, gf, gg, go = (x[:, t] @ w_ih.t() + hs @ w_hh.t()
                                  + b).split(H, -1)
                c2 = torch.sigmoid(gf) * cs + torch.sigmoid(gi) * \
                    torch.tanh(gg)
                h2 = torch.sigmoid(go) * torch.tanh(c2)
                keep = (t < n)[:, None]
                hs, cs = torch.where(keep, h2, hs), torch.where(keep, c2, cs)
                outs.append(torch.where(keep, h2, torch.zeros(())))
            x = torch.stack(outs, 1)
            i += 1
        h = x.amax(1)
    p = SENT_NETS[kind]["dropout"] if p is None else p
    gen = torch.Generator(device).manual_seed(1)
    keep = torch.rand(h.shape, generator=gen, device=device) < 1.0 - p
    h = torch.where(keep.cpu(), h / (1.0 - p), torch.zeros(()))
    return float(F.cross_entropy(h @ sd["fc.weight"] + sd["fc.bias"], y))


def sentiment_compare(kind, gpu):
    """Phase 23(a)/(b): ``SENT_STEPS`` steps through ``TrainStep`` with
    Adam(1e-2) — the first op by op, the second captured, then replays —
    against as many op-by-op steps from the same weights and dropout
    seed: losses, parameters and Adam's state the same bits; losses
    finite, the first within ``SENT_LOSS_NEAR`` of ln 2; no launch of
    the port's kernels; the first loss within ``SENT_REF_TOL`` of
    ``sentiment_reference_loss`` (the LSTM's also near ln 2). Then
    ``SENT_TIMED`` more calls of each, timed, and one profiled replay.
    Returns the median ms of each."""
    import math

    import torch

    from paddle_tpu_torch import optim
    from paddle_tpu_torch.ops import kernels

    model = sentiment_net(kind)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = sentiment_batch("cuda")
    loss_fn = sentiment_loss(kind)

    def adam(m):
        return optim.Adam(SENT_LR, parameters=m.named_parameters())

    n_params = sum(p.numel() for p in model.parameters())
    log(f"layers {kind}: {type(model).__name__} {SENT_NETS[kind]}, vocab "
        f"{SENT_VOCAB}, {n_params / 1e6:.3f}M parameters; batch "
        f"{SENT_BATCH} x {SENT_LEN}, lengths {int(batch[2].min())}-"
        f"{int(batch[2].max())}; Adam({SENT_LR})")
    out, zero = {}, dict.fromkeys(kernels.KERNELS, 0)
    for eager in (False, True):
        what = "op by op" if eager else "graphed"
        step, losses, walls, launches = graph_run(
            model, None, init, loss_fn, [batch] * SENT_STEPS, eager,
            make_opt=adam)
        state = snapshot(model, step.optimizer)
        fn = step._eager_step if eager else step
        more = []
        for _ in range(SENT_TIMED):
            t0 = time.perf_counter()
            fn(*batch)
            torch.cuda.synchronize()
            more.append((time.perf_counter() - t0) * 1e3)
        wall, busy, seen = profiled(lambda: fn(*batch))
        med = sorted(more)[len(more) // 2]
        out[what] = dict(losses=losses, state=state, ms=med)
        log(f"layers {kind} {what}: losses {losses}; step wall ms "
            + " ".join(f"{w:.2f}" for w in walls) + "; then "
            + " ".join(f"{w:.2f}" for w in more) + f" (median {med:.2f} ms "
            f"= {SENT_BATCH / med * 1e3:.0f} samples/s); one profiled step: "
            f"wall {wall:.2f} ms, device busy {busy:.2f} ms = "
            f"{busy / wall * 100:.1f}% of it, {busy / med * 100:.1f}% of the "
            f"median step [{gpu}]")
        check(launches == zero and seen == zero and
              kernels.launches() == zero,
              f"layers {kind} {what}: the port's kernels launched "
              f"{launches} (the profiler saw {seen}); this path runs none")
        del step
    g, e = out["graphed"], out["op by op"]
    bad = same_bits(g["state"], e["state"])
    check(g["losses"] == e["losses"] and not bad,
          f"layers {kind}: graphed losses {g['losses']} vs op by op "
          f"{e['losses']}; {len(bad)} tensors differ, e.g. {bad[:4]}")
    first = g["losses"][0]
    ref = sentiment_reference_loss(kind, init, batch)
    check(all(math.isfinite(v) for v in g["losses"]) and
          abs(first - ref) < SENT_REF_TOL,
          f"layers {kind}: losses {g['losses']}: not finite, or the first "
          f"not within {SENT_REF_TOL} of the float64 reference {ref}")
    check(kind != "lstm" or abs(first - math.log(2)) < SENT_LOSS_NEAR,
          f"layers {kind}: first loss {first} not within {SENT_LOSS_NEAR} "
          f"of ln 2")
    log(f"layers {kind}: {SENT_STEPS} graphed steps = {SENT_STEPS} op-by-op "
        f"steps bitwise (losses, {len(g['state'][0])} parameters, Adam's "
        f"moments); first loss {first} vs float64 reference {ref} "
        f"({abs(first - ref):.3g}; ln 2 = {math.log(2):.4f}); replay "
        f"{g['ms']:.2f} ms vs op by op {e['ms']:.2f} ms a step [{gpu}]")
    del model, init
    torch.cuda.empty_cache()
    return g["ms"], e["ms"]


def _fl(*shape, scale=1.0):
    return lambda r: (r.randn(*shape) * scale).astype(np.float32)


def _ints(high, *shape):
    return lambda r: r.randint(0, high, shape).astype(np.int64)


def _const(a):
    return lambda r: np.asarray(a)


_X = (2, 6, 5, 4)
_PROB = lambda r: (1 / (1 + np.exp(-r.randn(4, 5)))).astype(np.float32)
_Y01 = lambda r: (r.rand(4, 5) > 0.5).astype(np.float32)
_PM1 = lambda r: np.where(r.rand(4) > 0.5, 1.0, -1.0).astype(np.float32)
_LOGP = lambda r: np.log(np.full((6, 2, 4), 0.25) + r.rand(6, 2, 4) *
                         0.1).astype(np.float32)
_LENS = _const(np.array([6, 3, 5]))


def _flatten(v):
    """Nested tuples and lists of tensors as one list."""
    if isinstance(v, (tuple, list)):
        return [t for x in v for t in _flatten(x)]
    return [v]


def _rnn_call(m, x, n):
    return _flatten(m(x, sequence_length=n))


# phase 23(c): (class, kwargs, inputs, call); the port's layers with
# parameters or buffers take device= and generator=, ``call(layer,
# *inputs)`` is the forward (default: the layer)
LAYER_CASES = [
    *[(n, {}, [_fl(3, 8, scale=4.0)], None) for n in (
        "ReLU", "ReLU6", "Sigmoid", "LogSigmoid", "Tanh", "Tanhshrink",
        "Softsign", "Silu", "Swish", "Mish", "Hardsigmoid", "Hardswish",
        "SELU", "GELU", "LogSoftmax", "Softmax")],
    ("LeakyReLU", dict(negative_slope=0.2), [_fl(3, 8, scale=4.0)], None),
    ("ELU", dict(alpha=0.7), [_fl(3, 8, scale=4.0)], None),
    ("CELU", dict(alpha=1.5), [_fl(3, 8, scale=4.0)], None),
    ("Softplus", dict(beta=2.0, threshold=6.0), [_fl(3, 8, scale=4.0)],
     None),
    ("Softshrink", dict(threshold=1.0), [_fl(3, 8, scale=4.0)], None),
    ("Hardtanh", dict(min=-2.0, max=3.0), [_fl(3, 8, scale=4.0)], None),
    ("Hardshrink", dict(threshold=1.0), [_fl(3, 8, scale=4.0)], None),
    ("ThresholdedReLU", dict(threshold=1.5), [_fl(3, 8, scale=4.0)], None),
    ("Maxout", dict(groups=3), [_fl(*_X)], None),
    ("GLU", dict(axis=1), [_fl(*_X)], None),
    ("PReLU", dict(num_parameters=6), [_fl(*_X)], None),
    ("Identity", {}, [_fl(*_X)], None),
    ("Linear", dict(in_features=4, out_features=3), [_fl(2, 5, 4)], None),
    ("Dropout", dict(p=0.3), [_fl(*_X)], None),
    ("Dropout2D", dict(p=0.3), [_fl(*_X)], None),
    ("Dropout3D", dict(p=0.3), [_fl(2, 3, 2, 2, 2)], None),
    ("AlphaDropout", dict(p=0.3), [_fl(*_X)], None),
    ("Embedding", dict(num_embeddings=9, embedding_dim=4, padding_idx=0),
     [_ints(9, 64, 16)], None),
    ("Flatten", dict(start_axis=1, stop_axis=2), [_fl(*_X)], None),
    ("Pad1D", dict(padding=[1, 2], mode="reflect"), [_fl(2, 3, 5)], None),
    ("Pad2D", dict(padding=[1, 0, 2, 1], value=1.5), [_fl(*_X)], None),
    ("Pad3D", dict(padding=[1, 1, 0, 1, 1, 0], mode="replicate"),
     [_fl(1, 2, 3, 3, 4)], None),
    ("ZeroPad2D", dict(padding=[2, 1, 0, 1]), [_fl(*_X)], None),
    ("Upsample", dict(scale_factor=1.5, mode="bicubic"), [_fl(*_X)], None),
    ("UpsamplingNearest2D", dict(scale_factor=2), [_fl(*_X)], None),
    ("UpsamplingBilinear2D", dict(scale_factor=2), [_fl(*_X)], None),
    ("CosineSimilarity", dict(axis=2), [_fl(*_X), _fl(*_X)], None),
    ("PairwiseDistance", dict(p=1.0), [_fl(4, 6), _fl(4, 6)], None),
    ("Bilinear", dict(in1_features=3, in2_features=4, out_features=5),
     [_fl(6, 3), _fl(6, 4)], None),
    ("Unfold", dict(kernel_sizes=3, strides=2, paddings=1), [_fl(*_X)],
     None),
    ("PixelShuffle", dict(upscale_factor=2), [_fl(2, 8, 3, 3)], None),
    ("ChannelShuffle", dict(groups=2), [_fl(*_X)], None),
    ("Conv1D", dict(in_channels=4, out_channels=6, kernel_size=3,
                    padding=1), [_fl(2, 4, 7)], None),
    ("Conv2D", dict(in_channels=6, out_channels=4, kernel_size=3, stride=2,
                    groups=2), [_fl(*_X)], None),
    ("Conv3D", dict(in_channels=3, out_channels=2, kernel_size=2,
                    dilation=(1, 2, 1)), [_fl(2, 3, 3, 5, 4)], None),
    ("Conv1DTranspose", dict(in_channels=4, out_channels=6, kernel_size=3,
                             stride=2, output_padding=1), [_fl(2, 4, 5)],
     None),
    ("Conv2DTranspose", dict(in_channels=6, out_channels=4, kernel_size=3,
                             stride=2, padding=1, groups=2), [_fl(*_X)],
     None),
    ("Conv3DTranspose", dict(in_channels=3, out_channels=2, kernel_size=2,
                             stride=2), [_fl(1, 3, 2, 3, 2)], None),
    ("MaxPool1D", dict(kernel_size=2), [_fl(2, 3, 7)], None),
    ("MaxPool2D", dict(kernel_size=3, stride=2, padding=1), [_fl(*_X)],
     None),
    ("MaxPool3D", dict(kernel_size=2, stride=1), [_fl(1, 2, 3, 4, 3)], None),
    ("AvgPool1D", dict(kernel_size=3, stride=2, padding=1), [_fl(2, 3, 7)],
     None),
    ("AvgPool2D", dict(kernel_size=3, stride=2, padding=1), [_fl(*_X)],
     None),
    ("AvgPool3D", dict(kernel_size=2, stride=2, padding=1),
     [_fl(1, 2, 3, 4, 3)], None),
    ("AdaptiveAvgPool1D", dict(output_size=3), [_fl(2, 3, 7)], None),
    ("AdaptiveAvgPool2D", dict(output_size=3), [_fl(*_X)], None),
    ("AdaptiveMaxPool1D", dict(output_size=3), [_fl(2, 3, 7)], None),
    ("AdaptiveMaxPool2D", dict(output_size=(3, 2)), [_fl(*_X)], None),
    ("LayerNorm", dict(normalized_shape=4), [_fl(*_X)], None),
    ("BatchNorm", dict(num_channels=6, act="relu"), [_fl(*_X)], None),
    ("BatchNorm1D", dict(num_features=6), [_fl(5, 6)], None),
    ("BatchNorm2D", dict(num_features=6, momentum=0.8), [_fl(*_X)], None),
    ("BatchNorm3D", dict(num_features=3), [_fl(2, 3, 2, 3, 2)], None),
    ("SyncBatchNorm", dict(num_features=6), [_fl(*_X)], None),
    ("GroupNorm", dict(num_groups=2, num_channels=6), [_fl(*_X)], None),
    ("InstanceNorm1D", dict(num_features=3), [_fl(2, 3, 7)], None),
    ("InstanceNorm2D", dict(num_features=6), [_fl(*_X)], None),
    ("InstanceNorm3D", dict(num_features=3), [_fl(2, 3, 2, 3, 2)], None),
    ("LocalResponseNorm", dict(size=5, alpha=0.01), [_fl(*_X)], None),
    ("SpectralNorm", dict(weight_shape=(6, 5, 4), dim=1, power_iters=3),
     [_fl(6, 5, 4)], None),
    ("CrossEntropyLoss", dict(ignore_index=2), [_fl(4, 5), _ints(5, 4)],
     None),
    ("NLLLoss", dict(reduction="none"), [_fl(4, 5), _ints(5, 4)], None),
    ("KLDivLoss", dict(reduction="sum"), [_fl(4, 5), _PROB], None),
    ("BCELoss", {}, [_PROB, _Y01], None),
    ("BCEWithLogitsLoss", {}, [_fl(4, 5), _Y01], None),
    ("MSELoss", dict(reduction="none"), [_fl(4, 5), _PROB], None),
    ("L1Loss", {}, [_fl(4, 5), _PROB], None),
    ("SmoothL1Loss", dict(delta=2.0), [_fl(4, 5, scale=3.0), _PROB], None),
    ("MarginRankingLoss", dict(margin=0.5), [_fl(4), _fl(4), _PM1], None),
    ("CosineEmbeddingLoss", dict(margin=0.1), [_fl(4, 3), _fl(4, 3), _PM1],
     None),
    ("HingeEmbeddingLoss", dict(margin=0.5), [_fl(4, 5), _Y01], None),
    ("TripletMarginLoss", dict(p=1.0), [_fl(4, 6), _fl(4, 6), _fl(4, 6)],
     None),
    ("CTCLoss", {}, [_LOGP, _const(np.array([[1, 2], [3, 0]])),
                     _const(np.array([6, 5])), _const(np.array([2, 1]))],
     lambda m, x, lab, n, k: m(x, lab, n, k, norm_by_times=True)),
    ("SimpleRNNCell", dict(input_size=5, hidden_size=4),
     [_fl(3, 5), _fl(3, 4)], lambda m, x, h: _flatten(m(x, h))),
    ("LSTMCell", dict(input_size=5, hidden_size=4),
     [_fl(3, 5), _fl(3, 4), _fl(3, 4)],
     lambda m, x, h, c: _flatten(m(x, (h, c)))),
    ("GRUCell", dict(input_size=5, hidden_size=4), [_fl(3, 5), _fl(3, 4)],
     lambda m, x, h: _flatten(m(x, h))),
    ("SimpleRNN", dict(input_size=5, hidden_size=4, num_layers=2,
                       direction="bidirect"), [_fl(3, 6, 5), _LENS],
     _rnn_call),
    ("LSTM", dict(input_size=5, hidden_size=4, num_layers=2,
                  direction="bidirect"), [_fl(3, 6, 5), _LENS], _rnn_call),
    ("GRU", dict(input_size=5, hidden_size=4, num_layers=2),
     [_fl(3, 6, 5), _LENS], _rnn_call),
]
# classes made of cells: built from two ``LSTMCell(5, 4)``s
CELL_RUNNERS = ("RNN", "BiRNN")


def _layer(name, kw, device):
    """``nn.<name>(**kw)`` on ``device`` (parameters drawn from a fixed
    seed on the CPU; the card's copy loads them)."""
    import inspect

    import torch

    from paddle_tpu_torch import nn

    if name in CELL_RUNNERS:
        cells = [nn.LSTMCell(5, 4, device=device) for _ in range(2)]
        return nn.RNN(cells[0], is_reverse=True) if name == "RNN" else \
            nn.BiRNN(*cells)
    cls = getattr(nn, name)
    params = inspect.signature(cls.__init__).parameters
    if "device" in params:
        kw = dict(kw, device=device)
    if "generator" in params:
        kw = dict(kw, generator=torch.Generator(device).manual_seed(0))
    return cls(**kw)


def _layer_run(layer, call, arrays, device, grads_g):
    """Forward and backward of ``layer`` on ``device``: (outputs, input
    gradients, parameter gradients), as CPU float32 tensors."""
    import torch

    ins = [torch.from_numpy(a).to(device).requires_grad_(
        a.dtype == np.float32) for a in arrays]
    out = call(layer, *ins) if call else layer(*ins)
    outs = _flatten(out)
    layer.zero_grad(set_to_none=True)
    floats = [o for o in outs if o.is_floating_point()]
    if grads_g is None:
        rng = np.random.RandomState(1)
        grads_g = [np.asarray(rng.randn(*o.shape), np.float32)
                   for o in floats]
    total = sum((o * torch.from_numpy(g).to(device)).sum()
                for o, g in zip(floats, grads_g))
    if total.requires_grad:
        total.backward()
    cpu = lambda t: None if t is None else t.detach().float().cpu()
    return ([cpu(o) for o in outs], [cpu(t.grad) for t in ins],
            {n: cpu(p.grad) for n, p in layer.named_parameters()}, grads_g)


def layer_card_check(gpu, device="cuda"):
    """Phase 23(c): every layer class at a small size, forward and
    backward, on the card against the same layer (same weights and
    buffers) on the CPU, float32, within ``LAYER_F32_TOL``; each run
    twice on the card, and the layers whose outputs or gradients change
    bits from the first run to the second are listed. None of them may
    be on (a)'s or (b)'s path. Returns that list. (``device="cpu"``
    runs the checks with the CPU in the card's place.)"""
    import torch

    from paddle_tpu_torch import nn

    t0 = time.perf_counter()
    cases = LAYER_CASES + [(n, {}, [_fl(3, 6, 5), _LENS], _rnn_call)
                           for n in CELL_RUNNERS]
    worst, moving = 0.0, []
    for name, kw, inputs, call in cases:
        rng = np.random.RandomState(0)
        arrays = [make(rng) for make in inputs]
        cpu_layer = _layer(name, kw, "cpu")
        card = _layer(name, kw, device)
        card.load_state_dict(cpu_layer.state_dict())
        if name.startswith(("Dropout", "AlphaDropout")):
            cpu_layer.eval()
            card.eval()
        want = _layer_run(cpu_layer, call, arrays, "cpu", None)
        runs = [_layer_run(card, call, arrays, device, want[3])
                for _ in range(2)]
        got = runs[0]
        pairs = list(zip(got[0], want[0])) + list(zip(got[1], want[1]))
        pairs += [(got[2][n], want[2][n]) for n in want[2]]
        for g, w in pairs:
            check((g is None) == (w is None), f"layers (c) {name}: a "
                  "gradient on one device only")
            if w is None:
                continue
            scale = float(w.abs().max()) or 1.0
            err = float((g - w).abs().max()) / scale
            worst = max(worst, err)
            check(err <= LAYER_F32_TOL, f"layers (c) {name}: card vs CPU "
                  f"{err:.3g} of the largest |value|, limit {LAYER_F32_TOL}")
        flat = lambda r: [t for t in r[0] + r[1] + list(r[2].values())
                          if t is not None]
        if not all(torch.equal(a, b) for a, b in zip(flat(runs[0]),
                                                        flat(runs[1]))):
            moving.append(name)
    names = {c[0] for c in cases}
    classes = {n for n in nn.layers.__all__ if n[0].isupper() and n not in (
        "MultiHeadAttention", "Transformer", "TransformerDecoder",
        "TransformerDecoderLayer", "TransformerEncoder",
        "TransformerEncoderLayer", "RNNCellBase")}
    check(classes <= names, f"layers (c): no case for "
          f"{sorted(classes - names)}")
    log(f"layers (c): {len(cases)} layer classes on the card = on the CPU "
        f"within {worst:.3g} of the largest |value| (limit {LAYER_F32_TOL}),"
        f" forward and backward, float32; bits that changed between two "
        f"runs on the card: {moving or 'none'}; took "
        f"{time.perf_counter() - t0:.1f} s [{gpu}]")
    check(not set(moving) & SENT_PATH_LAYERS, f"layers (c): layers of the "
          f"sentiment path are not repeatable: "
          f"{sorted(set(moving) & SENT_PATH_LAYERS)}")
    return moving


def layers_phase(gpu):
    """Phase 23: (a) the stacked LSTM and (b) the text-CNN train at the
    JAX package's default widths, graphed = op by op bitwise; (c) every
    layer class on the card against the CPU, and run twice."""
    t0 = time.perf_counter()
    times = {kind: sentiment_compare(kind, gpu) for kind in ("lstm", "conv")}
    moving = layer_card_check(gpu)
    log(f"layers: phase took {time.perf_counter() - t0:.1f} s [{gpu}]")
    return times, moving


# -- phase 24: the tensor API, the book's word2vec and recommender nets -------

REC_BATCH = 256          # the smoke's batch for the four nets
W2V_VOCAB = 2074         # paddle_tpu/dataset/imikolov.py:7, the synthetic dict
# user ids, genders, ages, jobs, movie ids, categories: the synthetic
# MovieLens (paddle_tpu/dataset/movielens.py:10-11) and the recommenders'
# defaults
ML_FIELDS = (944, 2, 7, 21, 1683, 19)
# Adam's rates of tests/book/test_nlp_models.py's _fit
REC_LR = {"ngram": 1e-2, "skipgram": 1e-2, "two_tower": 5e-3,
          "deepfm": 5e-3}
REC_STEPS = 4
REC_TIMED = 5
# the first step's loss against a float64 CPU forward of the same weights
# and batch (rec_reference_loss), relative: float32 sums of at most 2074
# terms (the N-gram model's log-softmax)
REC_REF_TOL = 1e-5
# the static DeepFM against (a)'s TrainStep run from the same weights and
# batch, relative: one program of the same ops, its Adam update written
# as the static optimizer writes it
STATIC_REC_TOL = 1e-6
# PERF.md §5: the TrainStep LSTM replay at phase 23's shapes (PR 19; NVIDIA
# H100 80GB HBM3, 700 W), printed beside the static program's
PR19_LSTM_MS = 25.78
# the tensor-API names (a) and (b) run: none may change its bits between
# two runs on the card
REC_PATH_NAMES = {"sum", "reshape", "squeeze", "unsqueeze", "matmul",
                  "concat", "stack", "max", "multiply", "subtract", "add",
                  "pow", "tanh", "mean"}


def rec_net(kind, device="cuda"):
    """Phase 24's ``kind`` net at the JAX package's default widths on
    ``device``, weights from seed 0."""
    import torch

    from paddle_tpu_torch.models.nlp import NGramLM, SkipGram
    from paddle_tpu_torch.models.rec import DeepFM, TwoTowerRecommender

    kw = dict(device=device,
              generator=torch.Generator(device).manual_seed(0))
    if kind == "ngram":
        return NGramLM(W2V_VOCAB, embed_dim=32, hidden=256, context_size=4,
                       **kw)
    if kind == "skipgram":
        return SkipGram(W2V_VOCAB, embed_dim=64, **kw)
    if kind == "two_tower":
        return TwoTowerRecommender(ML_FIELDS[0], ML_FIELDS[4], *ML_FIELDS[1:4],
                                   ML_FIELDS[5], embed_dim=32, hidden=200,
                                   **kw)
    return DeepFM(list(ML_FIELDS), embed_dim=16, hidden=(400, 400, 400), **kw)


def rec_batch(kind, device):
    """``RandomState(0)``'s batch of ``REC_BATCH`` for ``kind``: 4 context
    words and the next (N-gram); a center and 1 true + 4 negative
    candidates with their 0/1 labels (skip-gram); the six MovieLens fields
    and a rating in 1-5 (two-tower) or its ``>= 4`` as a 0/1 label
    (DeepFM). Tensors on ``device``."""
    import torch

    rng = np.random.RandomState(0)
    B = REC_BATCH
    if kind == "ngram":
        ids = rng.randint(0, W2V_VOCAB, (B, 5))
        arrays = [ids[:, :4], ids[:, 4]]
    elif kind == "skipgram":
        label = np.zeros((B, 5), np.float32)
        label[:, 0] = 1.0
        arrays = [rng.randint(0, W2V_VOCAB, B),
                  rng.randint(0, W2V_VOCAB, (B, 5)), label]
    else:
        fields = [rng.randint(0, v, B) for v in ML_FIELDS]
        rating = rng.randint(1, 6, B).astype(np.float32)
        arrays = fields + [rating if kind == "two_tower" else
                           (rating >= 4).astype(np.float32)]
    return [torch.from_numpy(np.ascontiguousarray(
        a if a.dtype == np.float32 else a.astype(np.int64))).to(device)
        for a in arrays]


def rec_loss(kind):
    """``loss_fn(model, *batch)`` of ``kind``: cross-entropy over the
    vocabulary, negative-sampling BCE, the rating's squared error, BCE
    on the label."""
    from paddle_tpu_torch.models.nlp import skipgram_loss
    from paddle_tpu_torch.models.rec import rating_loss
    from paddle_tpu_torch.nn import functional as F

    if kind == "ngram":
        return lambda m, ctx, nxt: F.cross_entropy(m(ctx), nxt)
    if kind == "skipgram":
        return skipgram_loss
    if kind == "two_tower":
        return rating_loss
    return lambda m, *b: F.binary_cross_entropy_with_logits(m(*b[:-1]),
                                                            b[-1])


def rec_reference_loss(kind, state, batch):
    """The first step's loss, recomputed in float64 on the CPU with plain
    torch ops from the net's weights ``state`` and the batch."""
    import torch
    import torch.nn.functional as F

    sd = {k: v.detach().double().cpu() for k, v in state.items()}
    b = [t.cpu() for t in batch]

    def fc(h, name):
        return h @ sd[f"{name}.weight"] + sd[f"{name}.bias"]

    if kind == "ngram":
        e = sd["embed.weight"][b[0]].reshape(len(b[0]), -1)
        return float(F.cross_entropy(fc(torch.relu(fc(e, "fc1")), "fc2"),
                                     b[1]))
    if kind == "skipgram":
        c = sd["center.weight"][b[0]]
        t = sd["context.weight"][b[1]]
        return float(F.binary_cross_entropy_with_logits(
            (t @ c[..., None]).squeeze(-1), b[2].double()))
    if kind == "two_tower":
        uid, g, a, j, iid, cat, r = b
        u = torch.tanh(fc(torch.cat([
            sd["u_id.weight"][uid], sd["u_gender.weight"][g],
            sd["u_age.weight"][a], sd["u_job.weight"][j]], -1), "u_fc"))
        i = torch.tanh(fc(torch.cat([sd["i_id.weight"][iid],
                                     sd["i_cat.weight"][cat]], -1), "i_fc"))
        sim = (u * i).sum(-1) / torch.clamp_min(
            (u * u).sum(-1).sqrt() * (i * i).sum(-1).sqrt(), 1e-8)
        return float(F.mse_loss(5.0 * sim, r.double()))
    *ids, y = b
    V = torch.stack([sd[f"embeds.{k}.weight"][x] for k, x in enumerate(ids)],
                    1)
    first = torch.cat([sd[f"linears.{k}.weight"][x]
                       for k, x in enumerate(ids)], -1).sum(-1)
    fm = 0.5 * (V.sum(1) ** 2 - (V * V).sum(1)).sum(-1)
    h, k = V.reshape(len(y), -1), 0
    while f"mlp.{k}.weight" in sd:
        h, k = torch.relu(fc(h, f"mlp.{k}")), k + 1
    deep = fc(h, "out").squeeze(-1)
    return float(F.binary_cross_entropy_with_logits(first + fm + deep,
                                                     y.double()))


def rec_compare(kind, gpu):
    """Phase 24(a): ``REC_STEPS`` steps of ``kind`` through ``TrainStep``
    under Adam — the first op by op, the second captured, then replays —
    against as many op-by-op steps from the same weights: losses,
    parameters and Adam's moments the same bits; losses finite, the first
    within ``REC_REF_TOL`` of ``rec_reference_loss``; no launch of the
    port's kernels. Then ``REC_TIMED`` more calls of each, timed, and one
    profiled replay. Returns ``(median replay ms, median op-by-op ms,
    graphed losses, initial state, final snapshot)``."""
    import math

    import torch

    from paddle_tpu_torch import optim
    from paddle_tpu_torch.ops import kernels

    model = rec_net(kind)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = rec_batch(kind, "cuda")
    loss_fn = rec_loss(kind)

    def adam(m):
        return optim.Adam(REC_LR[kind], parameters=m.named_parameters())

    n_params = sum(p.numel() for p in model.parameters())
    log(f"rec {kind}: {type(model).__name__}, {n_params / 1e6:.3f}M "
        f"parameters; batch {REC_BATCH}; Adam({REC_LR[kind]})")
    out, zero = {}, dict.fromkeys(kernels.KERNELS, 0)
    for eager in (False, True):
        what = "op by op" if eager else "graphed"
        step, losses, walls, launches = graph_run(
            model, None, init, loss_fn, [batch] * REC_STEPS, eager,
            make_opt=adam)
        state = snapshot(model, step.optimizer)
        fn = step._eager_step if eager else step
        more = []
        for _ in range(REC_TIMED):
            t0 = time.perf_counter()
            fn(*batch)
            torch.cuda.synchronize()
            more.append((time.perf_counter() - t0) * 1e3)
        wall, busy, seen = profiled(lambda: fn(*batch))
        med = sorted(more)[len(more) // 2]
        out[what] = dict(losses=losses, state=state, ms=med)
        log(f"rec {kind} {what}: losses {losses}; step wall ms "
            + " ".join(f"{w:.3f}" for w in walls) + "; then "
            + " ".join(f"{w:.3f}" for w in more) + f" (median {med:.4f} ms "
            f"= {REC_BATCH / med * 1e3:.0f} samples/s); one profiled step: "
            f"wall {wall:.3f} ms, device busy {busy:.4f} ms = "
            f"{busy / wall * 100:.1f}% of it, {busy / med * 100:.1f}% of "
            f"the median step [{gpu}]")
        check(launches == zero and seen == zero and
              kernels.launches() == zero,
              f"rec {kind} {what}: the port's kernels launched {launches} "
              f"(the profiler saw {seen}); this path runs none")
        check(eager or step.captures == 1,
              f"rec {kind}: {step.captures} captures, want 1")
        del step
    g, e = out["graphed"], out["op by op"]
    bad = same_bits(g["state"], e["state"])
    check(g["losses"] == e["losses"] and not bad,
          f"rec {kind}: graphed losses {g['losses']} vs op by op "
          f"{e['losses']}; {len(bad)} tensors differ, e.g. {bad[:4]}")
    first = g["losses"][0]
    ref = rec_reference_loss(kind, init, batch)
    check(all(math.isfinite(v) for v in g["losses"]) and
          abs(first - ref) <= REC_REF_TOL * max(1.0, abs(ref)),
          f"rec {kind}: losses {g['losses']}: not finite, or the first not "
          f"within {REC_REF_TOL} of the float64 reference {ref}")
    log(f"rec {kind}: {REC_STEPS} graphed steps = {REC_STEPS} op-by-op "
        f"steps bitwise (losses, {len(g['state'][0])} parameters, Adam's "
        f"moments); first loss {first} vs float64 reference {ref} "
        f"({abs(first - ref):.3g}); replay {g['ms']:.4f} ms vs op by op "
        f"{e['ms']:.4f} ms a step [{gpu}]")
    return g["ms"], e["ms"], g["losses"], init, g["state"]


def static_net_program(kind):
    """Phase 24(b)'s program on the card, in a Scope and a name generator
    of its own: ``DeepFM`` (batch and Adam as (a)'s) or
    ``StackedLSTMSentiment`` (phase 23's widths and batch, no
    ``sequence_length``, Adam(1e-2)). Returns ``(main, startup, loss,
    model, scope)``."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import optim
    from paddle_tpu_torch.models.nlp import StackedLSTMSentiment
    from paddle_tpu_torch.models.rec import DeepFM
    from paddle_tpu_torch.utils import unique_name

    scope = pt.static.Scope()
    pt.seed(0)
    with unique_name.guard(), pt.static.scope_guard(scope):
        pt.enable_static()
        try:
            main, startup = pt.static.Program(), pt.static.Program()
            with pt.program_guard(main, startup):
                if kind == "deepfm":
                    ids = [pt.static.data(f"f{k}", [REC_BATCH], "int64")
                           for k in range(len(ML_FIELDS))]
                    y = pt.static.data("y", [REC_BATCH], "float32")
                    model = DeepFM(list(ML_FIELDS), embed_dim=16,
                                   hidden=(400, 400, 400))
                    loss = F.binary_cross_entropy_with_logits(model(*ids), y)
                    lr = REC_LR["deepfm"]
                else:
                    ids = pt.static.data("ids", [SENT_BATCH, SENT_LEN],
                                         "int64")
                    y = pt.static.data("y", [SENT_BATCH], "int64")
                    model = StackedLSTMSentiment(SENT_VOCAB,
                                                 **SENT_NETS["lstm"])
                    loss = F.cross_entropy(model(ids), y)
                    lr = SENT_LR
                optim.Adam(lr, parameters=model.parameters()).minimize(loss)
        finally:
            pt.disable_static()
    return main, startup, loss, model, scope


def static_net_compare(kind, gpu, step_run=None):
    """Phase 24(b): ``REC_STEPS`` graphed ``Executor.run`` calls of
    ``kind``'s program (the first op by op, the second the capture)
    against the program op by op (``use_cuda_graph=False``) from the same
    state and dropout seed, bitwise in the losses and every persistable;
    one capture; no launch of the port's kernels. The DeepFM program
    starts from (a)'s weights (``step_run``: its losses, initial state
    and final snapshot) and is held to that run within
    ``STATIC_REC_TOL``. Then ``REC_TIMED`` timed runs of each and one
    profiled replay. Returns ``(replay ms, op-by-op ms)``."""
    import math

    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import core
    from paddle_tpu_torch.ops import kernels

    main, startup, loss, model, scope = static_net_program(kind)
    exe = pt.static.Executor()
    exe.run(startup, scope=scope)
    names = {n: v.name for n, v in model.named_parameters()}
    if kind == "deepfm":
        batch = rec_batch("deepfm", "cuda")
        feed = {f"f{k}": t for k, t in enumerate(batch[:-1])}
        feed["y"] = batch[-1]
        with torch.no_grad():
            for n, var in names.items():
                scope.find_var(var).copy_(step_run[1][n])
    else:
        ids, y, _ = sentiment_batch("cuda")
        feed = {"ids": ids, "y": y}
    state0 = scope_state(main, scope)
    types = [op.type for op in main.global_block.ops]

    def run(e):
        return float(e.run(main, feed=feed, fetch_list=[loss],
                           scope=scope)[0])

    out, zero = {}, dict.fromkeys(kernels.KERNELS, 0)
    for what, e in (("graphed", exe),
                    ("op by op", pt.static.Executor(use_cuda_graph=False))):
        restore_scope(scope, state0)
        core.seed(1)
        kernels.reset_launches()
        losses = [run(e) for _ in range(REC_STEPS)]
        state = scope_state(main, scope)
        more = []
        for _ in range(REC_TIMED):
            t0 = time.perf_counter()
            run(e)
            more.append((time.perf_counter() - t0) * 1e3)
        wall, busy, seen = profiled(lambda: run(e))
        med = sorted(more)[len(more) // 2]
        out[what] = (losses, state, med)
        log(f"static {kind} {what}: losses {losses}; run ms "
            + " ".join(f"{w:.3f}" for w in more) + f" (median {med:.4f}); "
            f"one profiled run: wall {wall:.3f} ms, device busy "
            f"{busy:.4f} ms = {busy / med * 100:.1f}% of the median [{gpu}]")
        check(kernels.launches() == zero and seen == zero,
              f"static {kind} {what}: the port's kernels launched "
              f"{kernels.launches()}; this program runs none")
    check(exe.captures == 1, f"static {kind}: {exe.captures} captures for "
          f"one cache key")
    (gl, gs, gms), (ol, os_, oms) = out["graphed"], out["op by op"]
    bad = [n for n in gs if not torch_equal(gs[n], os_[n])]
    check(all(math.isfinite(v) for v in gl) and gl == ol and not bad,
          f"static {kind}: graphed {gl} != op by op {ol} (or not finite), "
          f"or {len(bad)} persistables differ, e.g. {bad[:4]}")
    if kind == "deepfm":
        losses, _, final = step_run
        worst = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(gl, losses))
        params = final[0]
        worst_p = max(float((gs[var] - params[n]).abs().max())
                      / max(1.0, float(params[n].abs().max()))
                      for n, var in names.items())
        check(worst <= STATIC_REC_TOL and worst_p <= STATIC_REC_TOL,
              f"static deepfm: losses {gl} vs the TrainStep run's {losses} "
              f"({worst:.3g}), parameters {worst_p:.3g} apart, limit "
              f"{STATIC_REC_TOL}")
        for op in ("reduce_sum", "pow", "stack", "subtract", "multiply",
                   "reshape", "squeeze"):
            check(op in types and op + "@grad" in types,
                  f"static deepfm: no {op} (or its @grad) in the program")
        log(f"static deepfm: the program's {REC_STEPS} steps = (a)'s "
            f"TrainStep steps within {worst:.3g} (losses) and {worst_p:.3g} "
            f"(parameters), limit {STATIC_REC_TOL} [{gpu}]")
    else:
        check(types.count("rnn_scan") == SENT_NETS["lstm"]["num_layers"],
              f"static lstm: {types.count('rnn_scan')} rnn_scan ops")
        log(f"static lstm: {types.count('rnn_scan')} rnn_scan ops; replay "
            f"{gms:.4f} ms vs phase 23's TrainStep LSTM {PR19_LSTM_MS} ms "
            f"(PR 19) [{gpu}]")
    log(f"static {kind}: {REC_STEPS} graphed runs = op by op bitwise "
        f"({len(gs)} persistables); one capture; replay {gms:.4f} ms vs op "
        f"by op {oms:.4f} ms [{gpu}]")
    return gms, oms


# phase 24(c): (name, call(pt, kw, *xs), inputs, flags); kw holds the
# makers' device; flags: "grad" (differentiate the float inputs), "random"
# (held to itself under one seed, not to the CPU)
def _pos(*shape):
    return lambda r: r.uniform(0.5, 2.0, shape).astype(np.float32)


def _unit(*shape):
    return lambda r: r.uniform(-0.9, 0.9, shape).astype(np.float32)


def _spd(n):
    def make(r):
        a = r.randn(n, n)
        return (a @ a.T + n * np.eye(n)).astype(np.float32)
    return make


def _bools(*shape):
    return lambda r: r.rand(*shape) > 0.5


def _svd_inv(t):
    u, s, v = t
    return u @ (s[:, None] * v.transpose(0, 1)), s


def _eig_inv(m, a, w, v):
    # whether A v = v diag(w) (each side's rounding is noise of its own),
    # and the sum and product of the eigenvalues
    return ((a.to(v.dtype) @ v - v * w).abs().max() < 1e-4, w.sum(),
            w.prod())


TENSOR_X = _fl(3, 4)
TENSOR_CASES = [
    *[(n, (lambda n: lambda m, d: getattr(m, n)([2, 3], **d))(n), [], "")
      for n in ("zeros", "ones", "empty")],
    ("full", lambda m, d: m.full([2, 3], 1.5, **d), [], ""),
    ("fill_constant", lambda m, d: m.fill_constant([2], "int64", 3, **d), [],
     ""),
    *[(n, (lambda n: lambda m, d, x: getattr(m, n)(x))(n), [TENSOR_X], "")
      for n in ("zeros_like", "ones_like", "empty_like")],
    ("full_like", lambda m, d, x: m.full_like(x, 2.5), [TENSOR_X], ""),
    ("arange", lambda m, d: m.arange(0.5, 3.0, 0.5, **d), [], ""),
    ("linspace", lambda m, d: m.linspace(-1.0, 2.0, 7, **d), [], ""),
    ("logspace", lambda m, d: m.logspace(0.0, 2.0, 5, **d), [], ""),
    ("eye", lambda m, d: m.eye(3, 4, **d), [], ""),
    ("tril", lambda m, d, x: m.tril(x, 1), [TENSOR_X], "grad"),
    ("triu", lambda m, d, x: m.triu(x, -1), [TENSOR_X], "grad"),
    ("meshgrid", lambda m, d, x, y: m.meshgrid(x, y), [_fl(3), _fl(4)],
     "grad"),
    ("diagflat", lambda m, d, x: m.diagflat(x, 1), [_fl(3)], "grad"),
    ("assign", lambda m, d, x: m.assign(x), [TENSOR_X], "grad"),
    ("clone", lambda m, d, x: m.clone(x), [TENSOR_X], "grad"),
    ("rand", lambda m, d: m.rand([64], **d), [], "random"),
    ("randn", lambda m, d: m.randn([64], **d), [], "random"),
    ("standard_normal", lambda m, d: m.standard_normal([64], **d), [],
     "random"),
    ("uniform", lambda m, d: m.uniform([64], min=-2.0, max=4.0, **d), [],
     "random"),
    ("normal", lambda m, d: m.normal(1.0, 2.0, [64], **d), [], "random"),
    ("randint", lambda m, d: m.randint(3, 9, [64], **d), [], "random"),
    ("randperm", lambda m, d: m.randperm(64, **d), [], "random"),
    ("bernoulli", lambda m, d, p: m.bernoulli(p.abs()), [_unit(64)],
     "random"),
    ("multinomial", lambda m, d, p: m.multinomial(p.abs() + 0.1, 2),
     [_fl(8, 5)], "random"),
    *[(n, (lambda n: lambda m, d, x, y: getattr(m, n)(x, y))(n),
       [TENSOR_X, _pos(3, 4)], "grad") for n in (
        "add", "subtract", "multiply", "divide", "remainder", "mod",
        "maximum", "minimum", "atan2", "logaddexp")],
    ("floor_divide", lambda m, d, x, y: m.floor_divide(x, y),
     [_ints(9, 4), _const(np.array([2, -2, 3, -3]))], ""),
    ("pow", lambda m, d, x, y: m.pow(x, y), [_pos(3, 4), _fl(3, 4)], "grad"),
    ("matmul", lambda m, d, x, y: m.matmul(x, y), [TENSOR_X, _fl(4, 2)],
     "grad"),
    ("mm", lambda m, d, x, y: m.mm(x, y), [TENSOR_X, _fl(4, 2)], "grad"),
    ("bmm", lambda m, d, x, y: m.bmm(x, y), [_fl(2, 3, 4), _fl(2, 4, 2)],
     "grad"),
    ("dot", lambda m, d, x, y: m.dot(x, y), [TENSOR_X, TENSOR_X], "grad"),
    ("outer", lambda m, d, x, y: m.outer(x, y), [_fl(3), _fl(4)], "grad"),
    ("inner", lambda m, d, x, y: m.inner(x, y), [TENSOR_X, _fl(2, 4)],
     "grad"),
    ("mul", lambda m, d, x, y: m.mul(x, y), [_fl(2, 3, 4), _fl(12, 5)],
     "grad"),
    ("scale", lambda m, d, x: m.scale(x, 2.0, 1.0), [TENSOR_X], "grad"),
    ("clip", lambda m, d, x: m.clip(x, -0.5, 0.5), [TENSOR_X], "grad"),
    ("add_n", lambda m, d, x, y: m.add_n([x, y, x]), [TENSOR_X, TENSOR_X],
     "grad"),
    ("cumsum", lambda m, d, x: m.cumsum(x, axis=1), [TENSOR_X], "grad"),
    ("cumprod", lambda m, d, x: m.cumprod(x, dim=1), [TENSOR_X], "grad"),
    ("lerp", lambda m, d, x, y: m.lerp(x, y, 0.3), [TENSOR_X, TENSOR_X],
     "grad"),
    ("einsum", lambda m, d, x, y: m.einsum("ij,kj->ik", x, y),
     [TENSOR_X, _fl(2, 4)], "grad"),
    ("kron", lambda m, d, x, y: m.kron(x, y), [_fl(2, 2), _fl(2, 3)],
     "grad"),
    ("trace", lambda m, d, x: m.trace(x, 1), [TENSOR_X], "grad"),
    ("diag", lambda m, d, x: m.diag(x), [TENSOR_X], "grad"),
    ("diagonal", lambda m, d, x: m.diagonal(x, 1), [TENSOR_X], "grad"),
    ("nan_to_num", lambda m, d, x: m.nan_to_num(x / (x > 0.5), 0.5, 9.0,
                                                -9.0), [TENSOR_X], ""),
    ("stanh", lambda m, d, x: m.stanh(x), [TENSOR_X], "grad"),
    ("increment", lambda m, d, x: m.increment(x, 2.0), [TENSOR_X], "grad"),
    *[(n, (lambda n: lambda m, d, x: getattr(m, n)(x))(n), [TENSOR_X],
       "grad") for n in (
        "exp", "expm1", "sin", "cos", "tan", "atan", "sinh", "cosh", "asinh",
        "erf", "tanh", "abs", "neg", "floor", "ceil", "round", "trunc",
        "sign", "square")],
    *[(n, (lambda n: lambda m, d, x: getattr(m, n)(x))(n), [_pos(3, 4)],
       "grad") for n in (
        "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "digamma", "lgamma",
        "reciprocal")],
    *[(n, (lambda n: lambda m, d, x: getattr(m, n)(x))(n), [_unit(3, 4)],
       "grad") for n in ("asin", "acos", "atanh", "erfinv")],
    ("acosh", lambda m, d, x: m.acosh(x + 2.0), [_pos(3, 4)], "grad"),
    *[(n, (lambda n: lambda m, d, x: getattr(m, n)(x / (x > 0.3)))(n),
       [TENSOR_X], "") for n in ("isnan", "isinf", "isfinite")],
    *[(n, (lambda n: lambda m, d, x: getattr(m, n)(x, axis=1))(n),
       [TENSOR_X], "grad") for n in (
        "sum", "mean", "max", "min", "amax", "amin", "prod", "logsumexp",
        "std", "var", "median", "nansum", "nanmean")],
    ("quantile", lambda m, d, x: m.quantile(x, [0.25, 0.9], axis=0),
     [TENSOR_X], "grad"),
    *[(n, (lambda n: lambda m, d, x: getattr(m, n)(x > 0, axis=1))(n),
       [TENSOR_X], "") for n in ("all", "any", "count_nonzero")],
    *[(n, (lambda n: lambda m, d, x: getattr(m, n)(x, axis=1))(n),
       [TENSOR_X], "") for n in ("argmax", "argmin")],
    ("kthvalue", lambda m, d, x: m.kthvalue(x, 2, axis=1), [TENSOR_X],
     "grad"),
    ("mode_op", lambda m, d, x: m.mode_op(x.round(), axis=1), [_fl(3, 9)],
     "grad"),
    ("reshape", lambda m, d, x: m.reshape(x, [2, -1]), [TENSOR_X], "grad"),
    ("transpose", lambda m, d, x: m.transpose(x, [1, 0]), [TENSOR_X],
     "grad"),
    ("t", lambda m, d, x: m.t(x), [TENSOR_X], "grad"),
    ("flatten", lambda m, d, x: m.flatten(x), [_fl(2, 3, 4)], "grad"),
    ("squeeze", lambda m, d, x: m.squeeze(x, 1), [_fl(3, 1, 4)], "grad"),
    ("unsqueeze", lambda m, d, x: m.unsqueeze(x, [0, 2]), [TENSOR_X],
     "grad"),
    ("concat", lambda m, d, x, y: m.concat([x, y], 1), [TENSOR_X, TENSOR_X],
     "grad"),
    ("stack", lambda m, d, x, y: m.stack([x, y], 1), [TENSOR_X, TENSOR_X],
     "grad"),
    ("split", lambda m, d, x: m.split(x, [1, -1], 1), [TENSOR_X], "grad"),
    ("chunk", lambda m, d, x: m.chunk(x, 2, 1), [TENSOR_X], "grad"),
    ("unbind", lambda m, d, x: m.unbind(x, 1), [TENSOR_X], "grad"),
    ("slice", lambda m, d, x: m.slice(x, [1], [1], [3]), [TENSOR_X], "grad"),
    ("strided_slice", lambda m, d, x: m.strided_slice(x, [1], [3], [0],
                                                      [-2]),
     [TENSOR_X], "grad"),
    # repeated indices: the gathers' backwards add them up
    ("gather", lambda m, d, x, k: m.gather(x, k, axis=1),
     [_fl(3, 5), _const(np.array([2, 0, 2, 2, 1]))], "grad"),
    ("gather_nd", lambda m, d, x, k: m.gather_nd(x, k),
     [_fl(3, 5), _const(np.array([[1, 2], [0, 0], [1, 2]]))], "grad"),
    ("take_along_axis", lambda m, d, x, k: m.take_along_axis(x, k, 1),
     [_fl(3, 5), _const(np.array([[0, 0, 0], [4, 4, 1], [2, 3, 2]]))],
     "grad"),
    ("index_select", lambda m, d, x, k: m.index_select(x, k, axis=0),
     [_fl(3, 5), _const(np.array([2, 2, 0, 2]))], "grad"),
    ("index_sample", lambda m, d, x, k: m.index_sample(x, k),
     [_fl(3, 5), _const(np.array([[3, 3], [0, 0], [2, 2]]))], "grad"),
    # repeated indices: the last write wins, or the updates add up
    ("scatter", lambda m, d, x, k, u: m.scatter(x, k, u),
     [TENSOR_X, _const(np.array([2, 0, 2, 2])), _fl(4, 4)], "grad"),
    ("scatter_nd", lambda m, d, k, u: m.scatter_nd(k, u, [3, 4]),
     [_const(np.array([[1], [2], [1]])), _fl(3, 4)], "grad"),
    ("scatter_nd_add", lambda m, d, x, k, u: m.scatter_nd_add(x, k, u),
     [TENSOR_X, _const(np.array([[1, 2], [0, 0], [1, 2], [1, 2]])),
      _fl(4)], "grad"),
    ("put_along_axis", lambda m, d, x, k, v: (
        m.put_along_axis(x, k, v, 1), m.put_along_axis(x, k, v, 1, "add"),
        m.put_along_axis(x, k, v, 1, "multiply")),
     [TENSOR_X, _const(np.array([[0, 0], [3, 3], [2, 2]])), _fl(3, 2)],
     "grad"),
    ("tile", lambda m, d, x: m.tile(x, [2, 3]), [TENSOR_X], "grad"),
    ("expand", lambda m, d, x: m.expand(x, [2, -1, 4]), [_fl(3, 1)], "grad"),
    ("broadcast_to", lambda m, d, x: m.broadcast_to(x, [3, 4]), [_fl(1, 4)],
     "grad"),
    ("expand_as", lambda m, d, x, y: m.expand_as(x, y), [_fl(3, 1), TENSOR_X],
     "grad"),
    ("repeat_interleave", lambda m, d, x: m.repeat_interleave(x, 2, 1),
     [TENSOR_X], "grad"),
    ("flip", lambda m, d, x: m.flip(x, [0, 1]), [TENSOR_X], "grad"),
    ("roll", lambda m, d, x: m.roll(x, 5), [TENSOR_X], "grad"),
    ("pad", lambda m, d, x: m.pad(x, [1, 2, 0, 1], mode="replicate"),
     [_fl(2, 3, 4)], "grad"),
    ("where", lambda m, d, x, y: m.where(x > 0, x, y), [TENSOR_X, TENSOR_X],
     "grad"),
    ("topk", lambda m, d, x: m.topk(x.round(), 2, axis=1), [_fl(3, 9)],
     "grad"),
    ("sort", lambda m, d, x: m.sort(x, 1, descending=True), [TENSOR_X],
     "grad"),
    ("argsort", lambda m, d, x: m.argsort(x.round(), 1, descending=True),
     [_fl(3, 9)], ""),
    ("one_hot", lambda m, d, k: m.one_hot(k, 5), [_ints(5, 2, 3)], ""),
    ("cast", lambda m, d, x: m.cast(x * 4.0, "int32"), [TENSOR_X], ""),
    ("nonzero", lambda m, d, x: m.nonzero(x > 0), [TENSOR_X], ""),
    ("masked_select", lambda m, d, x: m.masked_select(x, x > 0),
     [TENSOR_X], "grad"),
    ("unique", lambda m, d, k: m.unique(k, True, True, True),
     [_ints(5, 3, 4)], ""),
    ("masked_fill", lambda m, d, x: m.masked_fill(x, x > 0, -1.5),
     [TENSOR_X], "grad"),
    ("bincount", lambda m, d, k, w: (m.bincount(k), m.bincount(k, w)),
     [_const(np.array([0, 3, 3, 1, 3, 3])), _fl(6)], ""),
    ("moveaxis", lambda m, d, x: m.moveaxis(x, 0, -1), [_fl(2, 3, 4)],
     "grad"),
    ("swapaxes", lambda m, d, x: m.swapaxes(x, 0, 2), [_fl(2, 3, 4)],
     "grad"),
    ("rot90", lambda m, d, x: m.rot90(x, 1, [0, 1]), [TENSOR_X], "grad"),
    ("shard_index", lambda m, d, k: m.shard_index(k, 20, 4, 1),
     [_ints(20, 3, 4)], ""),
    ("as_real", lambda m, d, x: m.as_real(m.as_complex(x)), [_fl(3, 2)],
     "grad"),
    ("as_complex", lambda m, d, x: m.as_real(m.as_complex(x) * 2.0),
     [_fl(3, 2)], "grad"),
    *[(n, (lambda n: lambda m, d, x, y: getattr(m, n)(x, y))(n),
       [TENSOR_X, TENSOR_X], "") for n in (
        "equal", "not_equal", "less_than", "less_equal", "greater_than",
        "greater_equal", "isclose", "allclose", "equal_all")],
    *[(n, (lambda n: lambda m, d, x, y: getattr(m, n)(x > 0, y > 0))(n),
       [TENSOR_X, TENSOR_X], "") for n in (
        "logical_and", "logical_or", "logical_xor")],
    ("logical_not", lambda m, d, x: m.logical_not(x > 0), [TENSOR_X], ""),
    *[(n, (lambda n: lambda m, d, x, y: getattr(m, n)(x, y))(n),
       [_ints(8, 3, 4), _ints(8, 3, 4)], "") for n in (
        "bitwise_and", "bitwise_or", "bitwise_xor")],
    ("bitwise_not", lambda m, d, k: m.bitwise_not(k), [_ints(8, 3, 4)], ""),
    ("is_empty", lambda m, d, x: m.is_empty(x), [TENSOR_X], ""),
    ("is_tensor", lambda m, d, x: m.full([], float(m.is_tensor(x)), **d),
     [TENSOR_X], ""),
    ("norm", lambda m, d, x: (m.norm(x), m.norm(x, p=1, axis=1),
                              m.norm(x, p=3, axis=[0, 1])), [TENSOR_X],
     "grad"),
    ("dist", lambda m, d, x, y: m.dist(x, y, 2.0), [TENSOR_X, TENSOR_X],
     "grad"),
    ("cholesky", lambda m, d, x: m.cholesky(x), [_spd(4)], "grad"),
    ("inverse", lambda m, d, x: m.inverse(x), [_spd(4)], "grad"),
    ("matrix_power", lambda m, d, x: m.matrix_power(x, 3), [_fl(4, 4)],
     "grad"),
    ("pinv", lambda m, d, x: m.pinv(x), [TENSOR_X], "grad"),
    ("svd", lambda m, d, x: _svd_inv(m.svd(x)), [TENSOR_X], "grad"),
    ("qr", lambda m, d, x: (lambda q, r: (q @ r, r.abs()))(*m.qr(x)),
     [_fl(4, 3)], "grad"),
    ("eig", lambda m, d, x: _eig_inv(m, x, *m.eig(x)), [_fl(4, 4)], ""),
    ("eigvals", lambda m, d, x: (m.eigvals(x).sum(), m.eigvals(x).prod()),
     [_fl(4, 4)], ""),
    ("eigh", lambda m, d, x: (lambda w, v: (
        w, v @ (w[:, None] * v.transpose(0, 1))))(*m.eigh(x)), [_spd(4)],
     "grad"),
    ("eigvalsh", lambda m, d, x: m.eigvalsh(x), [_spd(4)], "grad"),
    ("matrix_rank", lambda m, d, x: m.matrix_rank(x), [TENSOR_X], ""),
    ("det", lambda m, d, x: m.det(x), [_fl(4, 4)], "grad"),
    ("slogdet", lambda m, d, x: m.slogdet(x), [_fl(4, 4)], "grad"),
    ("cross", lambda m, d, x, y: m.cross(x, y), [_fl(2, 3), _fl(2, 3)],
     "grad"),
    ("triangular_solve", lambda m, d, x, y: m.triangular_solve(
        m.triu(x) + 4.0 * m.eye(4, **d), y), [_fl(4, 4), _fl(4, 2)], "grad"),
    ("cholesky_solve", lambda m, d, b, a: m.cholesky_solve(b, m.cholesky(a)),
     [_fl(4, 2), _spd(4)], "grad"),
    ("solve", lambda m, d, x, y: m.solve(x, y), [_spd(4), _fl(4, 2)],
     "grad"),
    ("lstsq", lambda m, d, x, y: m.lstsq(x, y), [_fl(5, 3), _fl(5, 2)], ""),
    ("histogram", lambda m, d, x: m.histogram(x, bins=5), [_fl(40)], ""),
    ("mv", lambda m, d, x, v: m.mv(x, v), [TENSOR_X, _fl(4)], "grad"),
    ("multi_dot", lambda m, d, x, y, z: m.multi_dot([x, y, z]),
     [_fl(2, 3), TENSOR_X, _fl(4, 2)], "grad"),
    ("cov", lambda m, d, x: m.cov(x), [TENSOR_X], "grad"),
    ("corrcoef", lambda m, d, x: m.corrcoef(x), [TENSOR_X], "grad"),
    ("cond", lambda m, d, x: m.cond(x.sum() < 0, lambda: x * 2.0,
                                    lambda: x.exp()), [TENSOR_X], "grad"),
    ("while_loop", lambda m, d, x: m.while_loop(
        lambda n, s: n < 3, lambda n, s: [n + 1, s * 2.0 + 1.0],
        [m.zeros([], "int64", **d), x]), [TENSOR_X], "grad"),
    ("case", lambda m, d, x: m.case([(x.sum() > 100.0, lambda: x * 0.0),
                                     (x.max() < 100.0, lambda: x * 3.0)],
                                    default=lambda: x), [TENSOR_X], "grad"),
    ("switch_case", lambda m, d, k, x: m.switch_case(
        k, [lambda: x + 1.0, lambda: x * x]), [_const(np.array(1)),
                                                 TENSOR_X], "grad"),
    ("scan", lambda m, d, x: m.scan(lambda c, r: (c * 0.5 + r, c * r), x[0],
                                    x), [TENSOR_X], "grad"),
]


def _tensor_run(call, arrays, flags, device, grads_g, seed=None,
                watch=None):
    """A case's outputs and input gradients on ``device``, as CPU tensors;
    ``watch()`` is a context around the call and its backward only (the
    copies of the inputs and results stay out of it). The output
    cotangents ``grads_g`` are drawn from ``RandomState(1)`` when None."""
    import contextlib

    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import random as trandom

    if seed is not None:
        trandom.seed(seed)
    ins = [torch.from_numpy(np.array(a)).to(device).requires_grad_(
        "grad" in flags and a.dtype == np.float32) for a in arrays]
    gs = None if grads_g is None else [torch.from_numpy(g).to(device)
                                       for g in grads_g]
    with (watch or contextlib.nullcontext)():
        outs = _flatten(call(pt, {"device": device}, *ins))
        floats = [o for o in outs if o.is_floating_point() and
                  o.requires_grad]
        if gs is None:
            rng = np.random.RandomState(1)
            grads_g = [np.asarray(rng.randn(*o.shape), np.float32)
                       for o in floats]
            gs = [torch.from_numpy(g) for g in grads_g]
        if floats:
            sum((o * g).sum() for o, g in zip(floats, gs)).backward()
    cpu = lambda t: None if t is None else t.detach().cpu()
    return ([cpu(o) for o in outs],
            [cpu(t.grad) for t in ins if t.requires_grad], grads_g)


@contextlib.contextmanager
def sync_watch(device):
    """Warnings of every read back to the host inside (the card's sync
    debug mode); yields the list they go to."""
    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        if device == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield seen
        finally:
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("default")


def tensor_card_check(gpu, device="cuda"):
    """Phase 24(c): every exported tensor-API name at a small size,
    forward and (where differentiable) backward, on the card against the
    port on the CPU: floats within ``LAYER_F32_TOL`` of the largest
    |value|, integers, booleans and indices exactly; a random maker is
    held to itself under one seed (its shape and type to the CPU's).
    Each case runs twice on the card; the names whose bits move between
    the runs are listed, and none may be among the names phase 24(a)
    and (b) run (``REC_PATH_NAMES``). The names that read back to the
    host (a sync, seen by ``torch.cuda.set_sync_debug_mode``) are
    named. Returns ``(names that moved, names that synced)``.
    (``device="cpu"`` runs the checks with the CPU in the card's
    place.)"""
    import torch

    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    with sync_watch(device):     # the debug mode's own first-use warnings
        torch.zeros(1, device=device).add_(1)
    worst, moving, syncing = 0.0, [], []
    for name, call, inputs, flags in TENSOR_CASES:
        rng = np.random.RandomState(0)
        arrays = [make(rng) for make in inputs]
        seed = 5 if "random" in flags else None
        want = _tensor_run(call, arrays, flags, "cpu", None, seed)
        runs, seen = [], []

        @contextlib.contextmanager
        def watch():
            with sync_watch(device) as got:
                yield
            seen.extend(got)

        for _ in range(2):
            runs.append(_tensor_run(call, arrays, flags, device, want[2],
                                    seed, watch))
        if any("synchroniz" in str(w.message) for w in seen):
            syncing.append(name)
        got = runs[0]
        pairs = list(zip(got[0], want[0])) + list(zip(got[1], want[1]))
        check(len(got[0]) == len(want[0]) and len(got[1]) == len(want[1]),
              f"tensor (c) {name}: another count of outputs or gradients")
        for g, w in pairs:
            check((g is None) == (w is None) and (
                w is None or (g.shape == w.shape and g.dtype == w.dtype)),
                f"tensor (c) {name}: {None if g is None else tuple(g.shape)}"
                f" vs the CPU's {None if w is None else tuple(w.shape)}")
            if w is None or "random" in flags:
                continue
            if w.is_complex():
                g, w = torch.view_as_real(g), torch.view_as_real(w)
            if not w.is_floating_point():
                check(torch.equal(g, w), f"tensor (c) {name}: card "
                      f"{g.tolist()} != CPU {w.tolist()}")
                continue
            scale = float(w.abs().max()) if w.numel() else 1.0
            err = float((g - w).abs().max()) / (scale or 1.0) \
                if w.numel() else 0.0
            worst = max(worst, err)
            check(err <= LAYER_F32_TOL, f"tensor (c) {name}: card vs CPU "
                  f"{err:.3g} of the largest |value|, limit {LAYER_F32_TOL}")
        flat = lambda r: [t for t in r[0] + r[1] if t is not None]
        if not all(torch.equal(a, b) for a, b in zip(flat(runs[0]),
                                                        flat(runs[1]))):
            moving.append(name)
    names = {c[0] for c in TENSOR_CASES}
    check(set(pt.ops.__all__) <= names,
          f"tensor (c): no case for {sorted(set(pt.ops.__all__) - names)}")
    log(f"tensor (c): {len(TENSOR_CASES)} tensor-API names on the card = on "
        f"the CPU within {worst:.3g} of the largest |value| (limit "
        f"{LAYER_F32_TOL}), forward and backward; bits that changed between "
        f"two runs on the card: {moving or 'none'}; names that read back to "
        f"the host: {syncing or 'none'}; took {time.perf_counter() - t0:.1f}"
        f" s [{gpu}]")
    check(not set(moving) & REC_PATH_NAMES, f"tensor (c): names of phase "
          f"24's nets are not repeatable: {sorted(set(moving) & REC_PATH_NAMES)}")
    return moving, syncing


def tensor_trap_check(device="cuda"):
    """The JAX package's rules the port keeps where torch's differ, on
    ``device``, with the inputs they were checked on in the JAX package:
    ``scatter`` with a repeated index (the last write wins, and only it
    takes a gradient), descending ``argsort`` (the ascending stable sort
    reversed), ``topk`` under ties (the lower index first), ``median`` of
    an even count, ``mode`` and ``kthvalue`` under ties, ``svd``'s ``V``
    and a rank-deficient ``lstsq``."""
    import torch

    import paddle_tpu_torch as pt

    def t(a, **kw):
        return torch.tensor(a, device=device, **kw)

    u = t([5.0, 7.0, 9.0], requires_grad=True)
    out = pt.scatter(t([0.0] * 4), t([1, 1, 2]), u)
    (out * t([1.0, 2.0, 3.0, 4.0])).sum().backward()
    check(out.tolist() == [0.0, 7.0, 9.0, 0.0] and
          u.grad.tolist() == [0.0, 2.0, 3.0],
          f"tensor traps: scatter gave {out.tolist()}, its updates' "
          f"gradient {u.grad.tolist()}; want [0, 7, 9, 0] and [0, 2, 3]")
    x = t([3.0, 1.0, 3.0, 2.0, 3.0])
    got = pt.argsort(x, descending=True).tolist()
    check(got == [4, 2, 0, 3, 1], f"tensor traps: descending argsort {got},"
          " want [4, 2, 0, 3, 1]")
    got = pt.sort(x, descending=True).tolist()
    check(got == [3.0, 3.0, 3.0, 2.0, 1.0], f"tensor traps: sort {got}")
    got = (pt.topk(x, 2)[1].tolist(),
           pt.topk(t([1.0, 0.0, 1.0, 0.0]), 2, largest=False)[1].tolist())
    check(got == ([0, 2], [1, 3]), f"tensor traps: topk indices {got}, "
          f"want [0, 2] and [1, 3]")
    got = float(pt.median(t([4.0, 1.0, 3.0, 2.0])))
    check(got == 2.5, f"tensor traps: median {got}, want 2.5")
    v, k = pt.mode_op(t([2.0, 1.0, 1.0, 2.0, 3.0]))
    check((float(v), int(k)) == (2.0, 0), f"tensor traps: mode "
          f"({float(v)}, {int(k)}), want (2.0, 0)")
    v, k = pt.kthvalue(t([1.0, 0.0, 1.0, 0.0]), 3)
    check((float(v), int(k)) == (1.0, 0), f"tensor traps: kthvalue "
          f"({float(v)}, {int(k)}), want (1.0, 0)")
    a = torch.from_numpy(np.random.RandomState(0).randn(2, 3).astype(
        np.float32)).to(device)
    _, _, vv = pt.svd(a)
    check(tuple(vv.shape) == (3, 2), f"tensor traps: svd's v {vv.shape}")
    rng = np.random.RandomState(0)
    a = torch.from_numpy((rng.randn(5, 2) @ rng.randn(2, 3)).astype(
        np.float32)).to(device)
    y = torch.from_numpy(rng.randn(5, 2).astype(np.float32)).to(device)
    sol, _, rank, s = pt.lstsq(a, y)
    check(int(rank) == 2 and s.numel() == 3 and
          float((a @ sol - y).abs().max()) < 3.0,
          f"tensor traps: lstsq of a rank-2 system: rank {int(rank)}")
    empty = pt.empty([3], device=device)
    check(not empty.any(), f"tensor traps: empty {empty.tolist()}")


def _cond_loss(m, x, y, s):
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import control_flow

    out = m(x)
    return control_flow.cond(s.sum() > 0, lambda: F.mse_loss(out, y),
                             lambda: F.mse_loss(out * 2.0, y))


def _scan_loss(m, x, y):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import functional as F

    _, hs = pt.scan(lambda h, r: (F.tanh(m(h) + r), h), x[0] * 0.0, x)
    return F.mse_loss(hs, y)


def control_flow_check(gpu, device="cuda", steps=4):
    """Phase 24(d): a ``Linear`` whose loss branches with ``cond`` on a
    value on the card (the flag of each batch, alternating in sign) and
    one run through ``scan``, each ``steps`` SGD steps through
    ``TrainStep`` against as many op-by-op steps, bitwise. The ``cond``
    key is never captured (``uncaptured`` names ``cond``), each step's
    loss is the branch its flag picks (recomputed from the weights before
    the step), and ``run_fused`` over it, whose capture reaches the read,
    raises ``RuntimeError``; the ``scan`` key is captured once and
    replays. (``device="cpu"`` runs the checks without graphs.)"""
    import torch

    from paddle_tpu_torch import nn, optim
    from paddle_tpu_torch.framework import TrainStep
    from paddle_tpu_torch.nn import functional as F

    rng = np.random.RandomState(3)
    cond_batches = [[torch.from_numpy(a).to(device) for a in (
        rng.randn(16, 8).astype(np.float32),
        rng.randn(16, 4).astype(np.float32),
        np.array([1.0 if k % 2 == 0 else -1.0], np.float32))]
        for k in range(steps)]
    scan_batches = [[torch.from_numpy(a).to(device) for a in (
        rng.randn(6, 16, 8).astype(np.float32),
        rng.randn(6, 16, 8).astype(np.float32))]] * steps
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out = {}
    for kind, loss_fn, width, batches in (
            ("cond", _cond_loss, 4, cond_batches),
            ("scan", _scan_loss, 8, scan_batches)):
        model = nn.Linear(8, width, device=device,
                          generator=torch.Generator(device).manual_seed(0))
        init = {k: v.clone() for k, v in model.state_dict().items()}
        for eager in (False, True):
            model.load_state_dict(init)
            step = TrainStep(model, optim.SGD(
                0.1, parameters=model.named_parameters()), loss_fn)
            fn = step._eager_step if eager else step
            losses, before = [], []
            for b in batches:
                before.append({k: v.clone() for k, v in
                               model.state_dict().items()})
                losses.append(float(fn(*b)))
                sync()
            out[kind, eager] = (losses, before, {
                k: v.clone() for k, v in model.state_dict().items()}, step)
        (gl, gb, gs, gstep), (el, _, es, _) = out[kind, False], \
            out[kind, True]
        bad = [n for n in gs if not torch_equal(gs[n], es[n])]
        check(gl == el and not bad, f"control flow {kind}: TrainStep losses "
              f"{gl} vs op by op {el}; {len(bad)} tensors differ")
        uncaptured = list(gstep.uncaptured.values())
        if kind == "cond":
            for k, ((x, y, s), w) in enumerate(zip(cond_batches, gb)):
                model.load_state_dict(w)
                with torch.no_grad():
                    o = model(x)
                    want = float(F.mse_loss(o if float(s) > 0 else o * 2.0,
                                            y))
                check(gl[k] == want, f"control flow cond: step {k}'s loss "
                      f"{gl[k]}, the branch its flag ({float(s)}) picks "
                      f"gives {want}")
            if device == "cuda":
                check(uncaptured == [["cond"]] and gstep.captures == 0,
                      f"control flow cond: uncaptured {uncaptured}, "
                      f"{gstep.captures} captures; want [['cond']] and 0")
                try:
                    for _ in range(2):
                        gstep.run_fused(cond_batches[:2])
                    raised = None
                except RuntimeError as e:
                    raised = str(e)
                check(raised is not None and "cond" in raised,
                      f"control flow cond: a captured run_fused over the "
                      f"read raised {raised!r}")
        elif device == "cuda":
            check(uncaptured == [] and gstep.captures == 1,
                  f"control flow scan: uncaptured {uncaptured}, "
                  f"{gstep.captures} captures; want none and 1")
        log(f"control flow {kind}: {steps} TrainStep steps = op by op "
            f"bitwise, losses {gl}; uncaptured {uncaptured}, "
            f"{gstep.captures} captures [{gpu}]")
    return out


def tensor_phase(gpu):
    """Phase 24: (a) the book's N-gram, skip-gram, two-tower and DeepFM
    nets train at the JAX package's widths through ``TrainStep``, graphed
    = op by op bitwise; (b) the static DeepFM and stacked-LSTM programs,
    graphed = op by op; (c) every tensor-API name on the card against the
    CPU, run twice; (d) ``cond`` and ``scan`` in a training step."""
    t0 = time.perf_counter()
    tensor_trap_check()
    times = {kind: rec_compare(kind, gpu) for kind in REC_LR}
    static = {"deepfm": static_net_compare("deepfm", gpu, times["deepfm"][2:]),
              "lstm": static_net_compare("lstm", gpu)}
    moving, syncing = tensor_card_check(gpu)
    control_flow_check(gpu)
    log(f"tensor: phase took {time.perf_counter() - t0:.1f} s [{gpu}]")
    return times, static, moving, syncing


# -- phase 25: the Paddle user surface ----------------------------------------

SURFACE_CONFIG = "bench_gpt"     # tools/paddle_gpt_script.py's CONFIGS
SURFACE_STEPS = 4
SURFACE_TIMED = 5
SURFACE_SMALL_BATCH = 4          # to_static's second signature


def surface_script():
    """``tools/paddle_gpt_script.py`` of this checkout, as a module: the
    Paddle script written once for both packages."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", "paddle_gpt_script.py")
    spec = importlib.util.spec_from_file_location("paddle_gpt_script", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def surface_launches(cfg, steps=1, forward_only=False):
    """The script's launches: two LayerNorms a block and ``ln_f``, flash
    attention once a block, one cross-entropy; each forward and backward
    (``forward_only``: the forwards, no loss)."""
    ln, fl = (2 * cfg["layers"] + 1) * steps, cfg["layers"] * steps
    ce = 0 if forward_only else steps
    bwd = 0 if forward_only else 1
    return {"paged_decode_attention": 0, "layer_norm_fwd": ln,
            "layer_norm_bwd": ln * bwd, "softmax_ce_fwd": ce,
            "softmax_ce_bwd": ce, "flash_attention_fwd": fl,
            "flash_attention_bwd_dq": fl * bwd,
            "flash_attention_bwd_dkv": fl * bwd}


def surface_train(S, pt, model, init, cfg, data, gpu):
    """(a): ``S.train`` (``pt.TrainStep`` through its graph) against
    ``_eager_step`` from the same weights, bitwise; the launches of the
    graphed steps; the first loss against the plain versions'."""
    import math

    import torch

    from paddle_tpu_torch.ops import kernels

    runs = {}
    for eager in (False, True):
        model.set_state_dict(init)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        if eager:
            opt = pt.optim.AdamW(learning_rate=cfg["lr"],
                                 parameters=model.parameters(),
                                 multi_precision=True)
            step = pt.TrainStep(model, opt,
                                lambda m, x, y: S.loss_fn(pt, m, x, y))
            losses = [float(step._eager_step(pt.to_tensor(x),
                                             pt.to_tensor(y)))
                      for x, y in data]
        else:
            losses, step = S.train(pt, model, data, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = kernels.launches()
        x, y = (pt.to_tensor(a) for a in data[0])
        fn = step._eager_step if eager else step
        walls = []
        for _ in range(SURFACE_TIMED):
            t0 = time.perf_counter()
            fn(x, y)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        # the state after the timed steps too: both runs take the same
        runs[eager] = dict(losses=losses, launches=launches,
                           state=snapshot(model, step.optimizer),
                           wall=sorted(walls)[len(walls) // 2],
                           captures=step.captures)
        log(f"surface train {'eager' if eager else 'graphed'}: losses "
            f"{losses} ({wall:.0f} ms for {len(data)} steps); then "
            + " ".join(f"{w:.2f}" for w in walls) + f" ms a step "
            f"(median {runs[eager]['wall']:.2f}); launches {launches} "
            f"[{gpu}]")
        del step
    g, e = runs[False], runs[True]
    want = surface_launches(cfg, len(data))
    check(g["launches"] == want,
          f"surface train: graphed launches {g['launches']}, want {want}")
    check(e["launches"] == want,
          f"surface train: op-by-op launches {e['launches']}, want {want}")
    check(g["captures"] == 1, f"surface train: {g['captures']} captures")
    check(all(math.isfinite(v) for v in g["losses"]),
          "surface train: non-finite loss")
    check(g["losses"] == e["losses"], f"surface train: graphed losses "
          f"{g['losses']} != op by op {e['losses']}")
    bad = same_bits(g["state"], e["state"])
    check(not bad, f"surface train: graphed and op by op differ in "
          f"{len(bad)} tensors, e.g. {bad[:4]}")
    model.set_state_dict(init)
    with torch.no_grad():
        x, y = (pt.to_tensor(a) for a in data[0])
        first = float(S.loss_fn(pt, model, x, y))
        with kernels.plain_versions():
            plain = float(S.loss_fn(pt, model, x, y))
    check(abs(first - math.log(cfg["vocab"])) < LOSS_NEAR_LN_V,
          f"surface train: first loss {first} is not near ln V")
    check(abs(g["losses"][0] - plain) <= BF16_TRAIN_LOSS_TOL,
          f"surface train: first loss {g['losses'][0]} vs the plain "
          f"versions' {plain}")
    log(f"surface train: graphed = op by op bitwise over {len(data)} steps "
        f"and {SURFACE_TIMED} timed ones (losses, parameters, masters, "
        f"moments; a first step of {first} recomputed, {plain} through the "
        f"plain versions, |diff| {abs(g['losses'][0] - plain):.2e} of "
        f"{BF16_TRAIN_LOSS_TOL}); {len(want)} kernel counts each "
        f"{surface_launches(cfg)} a step; step wall graphed "
        f"{g['wall']:.2f} ms vs op by op {e['wall']:.2f} ms [{gpu}]")
    return g["wall"], e["wall"]


def surface_save_load(S, pt, model, cfg, root, gpu):
    """(b): ``pt.save(model.state_dict())``, ``pt.load`` into a fresh
    model by ``set_state_dict``: equal bits, its storage unmoved."""
    import torch

    fresh = S.make_model(pt, cfg)
    ptrs = [p.data_ptr() for p in fresh.parameters()]
    path = os.path.join(root, "surface.pdparams")
    t0 = time.perf_counter()
    res = S.save_and_load(pt, model, path, fresh)
    wall = time.perf_counter() - t0
    check(res == ([], []), f"surface save/load: missing, unexpected {res}")
    check([p.data_ptr() for p in fresh.parameters()] == ptrs,
          "surface save/load: the parameters' storage moved")
    theirs = fresh.state_dict()
    bad = [n for n, t in model.state_dict().items()
           if not torch_equal(t, theirs[n]) or t.dtype != theirs[n].dtype]
    check(not bad, f"surface save/load: {len(bad)} tensors differ: "
          f"{bad[:4]}")
    log(f"surface save/load: {len(theirs)} tensors, "
        f"{os.path.getsize(path) / 2 ** 20:.1f} MiB, saved and loaded in "
        f"{wall:.2f} s; equal bits, storage unmoved [{gpu}]")
    del fresh
    torch.cuda.empty_cache()


def surface_static(S, pt, model, cfg, data, gpu):
    """(c): ``pt.to_static(model)`` in eval mode at two batch sizes: one
    capture a signature, the replay's logits the eager forward's bits,
    25 LayerNorm and 12 flash forwards a call. Returns the replay and
    eager walls (ms) at the full batch."""
    import torch

    from paddle_tpu_torch.ops import kernels

    out = {}
    for B in (cfg["batch"], SURFACE_SMALL_BATCH):
        ids = data[0][0][:B]
        t = pt.to_tensor(ids)
        with torch.no_grad():
            model.eval()
            eager = model(t)
        if B == cfg["batch"]:
            fn, first = S.static_forward(pt, model, ids)
        else:
            first = fn(ids)
        torch.cuda.synchronize()
        kernels.reset_launches()
        again = fn(t)
        torch.cuda.synchronize()
        launches = kernels.launches()
        want = surface_launches(cfg, forward_only=True)
        check(launches == want, f"surface to_static B={B}: launches "
              f"{launches}, want {want}")
        check(torch_equal(first, eager) and torch_equal(again, eager),
              f"surface to_static B={B}: the replay differs from the "
              f"eager forward")
        walls = {}
        for kind, call in (("replay", lambda: fn(t)),
                           ("eager", lambda: model(t))):
            ms = []
            with torch.no_grad():
                for _ in range(SURFACE_TIMED):
                    t0 = time.perf_counter()
                    call()
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
            walls[kind] = sorted(ms)[len(ms) // 2]
        out[B] = walls
        log(f"surface to_static B={B}: {len(fn._cache)} signature(s) "
            f"captured; replay = eager bitwise ({tuple(eager.shape)} "
            f"{eager.dtype}); launches a call {launches}; wall replay "
            f"{walls['replay']:.2f} ms vs eager {walls['eager']:.2f} ms "
            f"[{gpu}]")
    check(len(fn._cache) == 2, f"surface to_static: {len(fn._cache)} "
          "captures for 2 signatures")
    check(model._static_forward is fn, "surface to_static: the layer's "
          "_static_forward is not the static function")
    model.train()
    return out


def surface_places(pt):
    """(d): a Layer made with no device lands on the current place."""
    try:
        pt.set_device("cpu")
        host = pt.nn.Linear(4, 4)
        check(pt.get_device() == "cpu:0" and
              host.weight.device.type == "cpu" and
              pt.zeros([2]).device.type == "cpu",
              "surface places: set_device('cpu') did not put a Layer on "
              "the host")
    finally:
        pt.set_device("gpu")
    card = pt.nn.Linear(4, 4)
    check(pt.get_device() == "gpu:0" and card.weight.device.type == "cuda",
          "surface places: set_device('gpu') did not bring a Layer back "
          "to the card")
    log("surface places: set_device('cpu') made a Layer on the host, "
        "set_device('gpu') the next on the card")


def surface_phase(gpu):
    """Phase 25: the Paddle script of ``tools/paddle_gpt_script.py`` at
    bench_gpt's widths, through the user surface only: (a) 4 AdamW steps
    through ``pt.TrainStep``, graphed = op by op bitwise, 25/25/1/1/12/12/
    12 launches a step; (b) ``pt.save``/``pt.load``/``set_state_dict``;
    (c) ``pt.to_static`` at two batch sizes; (d) ``set_device``."""
    import shutil
    import tempfile

    import torch

    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    S = surface_script()
    cfg = S.CONFIGS[SURFACE_CONFIG]
    pt.set_device("gpu")
    with pt.utils.unique_name.guard():
        model = S.make_model(pt, cfg)
    check(all(isinstance(p, pt.Parameter) and p.device.type == "cuda"
              and p.dtype == torch.bfloat16 for p in model.parameters()),
          "surface: the script's parameters are not bfloat16 on the card")
    n = sum(p.numel() for p in model.parameters())
    init = {k: v.clone() for k, v in model.state_dict().items()}
    data = S.batches(cfg, SURFACE_STEPS)
    log(f"surface: the Paddle script at {SURFACE_CONFIG}'s widths, "
        f"{n / 1e6:.1f}M parameters ({cfg['layers']} x {cfg['hidden']}, "
        f"{cfg['heads']} heads, vocab {cfg['vocab']}), bfloat16, batch "
        f"{cfg['batch']} x {cfg['seq']}")
    walls = surface_train(S, pt, model, init, cfg, data, gpu)
    root = tempfile.mkdtemp(prefix="chip_smoke_surface_")
    try:
        surface_save_load(S, pt, model, cfg, root, gpu)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    static = surface_static(S, pt, model, cfg, data, gpu)
    surface_places(pt)
    del model, init
    torch.cuda.empty_cache()
    log(f"surface: phase took {time.perf_counter() - t0:.1f} s [{gpu}]")
    return walls, static


# -- phase 26: VGG-16 and MobileNet V1/V2 as bench_resnet50 trains them ------

VISION_CONFIGS = ("bench_vgg16", "bench_mobilenet_v1", "bench_mobilenet_v2")
# MobileNetV1's depthwise strides, block by block, and MobileNetV2's
# (expansion, width, blocks, first stride) stages
# (paddle_tpu/models/vision/mobilenet.py:60-64, 87-89)
V1_STRIDES = (1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 2, 1)
V2_STAGES = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
# phase 26(b): channels-last conv2d at ResNet-50's and MobileNetV2's
# shapes (batch 128, bfloat16): label, x (N, C, H, W), weight (O, C /
# groups, k, k), stride, padding, groups. Held to the NCHW call on the
# same data within RESNET_CONV_TOL of the largest |value| (output, dx,
# dw): each side rounds its float32 sums to bfloat16 once
CHANNELS_LAST_SHAPES = (
    ("resnet50 stem 7x7/2", (128, 3, 224, 224), (64, 3, 7, 7), 2, 3, 1),
    ("resnet50 3x3", (128, 64, 56, 56), (64, 64, 3, 3), 1, 1, 1),
    ("resnet50 1x1/2 downsample", (128, 256, 56, 56), (512, 256, 1, 1), 2,
     0, 1),
    ("mobilenet_v2 stem 3x3/2", (128, 3, 224, 224), (32, 3, 3, 3), 2, 1, 1),
    ("mobilenet_v2 depthwise 3x3/2", (128, 96, 112, 112), (96, 1, 3, 3), 2,
     1, 96),
    ("mobilenet_v2 1x1", (128, 32, 112, 112), (16, 32, 1, 1), 1, 0, 1))
# deformable_conv (v1 and v2) on the card against the CPU, float32, at a
# 64-channel 56 x 56 map (batch 4, 64 filters of 3 x 3, padding 1),
# within LAYER_F32_TOL of the largest |value|
DEFORM_SHAPE = dict(B=4, C=64, H=56, W=56, O=64)


def vgg_reference_forward(state, x, depth=16):
    """VGG's training forward (BatchNorm on the batch's statistics,
    dropout off) in float32 over the float32 ``state``, written with
    ``torch.nn.functional`` and none of the port's ops, cuDNN without
    TF32."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.models.vision.vgg import _CFGS

    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        h, i = x, 0
        for v in _CFGS[depth]:
            if v == "M":
                h, i = TF.max_pool2d(h, 2, 2), i + 1
                continue
            h = TF.conv2d(h, state[f"features.{i}.weight"],
                          state[f"features.{i}.bias"], padding=1)
            bn = f"features.{i + 1}"
            h = TF.batch_norm(h, None, None, state[f"{bn}.weight"],
                              state[f"{bn}.bias"], training=True, eps=1e-5)
            h, i = TF.relu(h), i + 3
        h = TF.adaptive_avg_pool2d(h, 7).flatten(1)
        for j in (0, 3):
            h = TF.relu(h @ state[f"classifier.{j}.weight"]
                        + state[f"classifier.{j}.bias"])
        return h @ state["classifier.6.weight"] + state["classifier.6.bias"]


def mobilenet_reference_forward(state, x):
    """MobileNet V1's or V2's (``head`` present) training forward in
    float32 over the float32 ``state``, dropout off, written with
    ``torch.nn.functional``, cuDNN without TF32: each conv with the
    stride and groups of the reference's layout (``V1_STRIDES``,
    ``V2_STAGES``)."""
    import torch
    import torch.nn.functional as TF

    acts = {"relu": TF.relu, "relu6": TF.relu6, None: lambda t: t}

    def cba(h, p, stride=1, depthwise=False, act="relu6"):
        w = state[f"{p}.conv.weight"]
        h = TF.conv2d(h, w, stride=stride, padding=(w.shape[-1] - 1) // 2,
                      groups=h.shape[1] if depthwise else 1)
        h = TF.batch_norm(h, None, None, state[f"{p}.bn.weight"],
                          state[f"{p}.bn.bias"], training=True, eps=1e-5)
        return acts[act](h)

    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        if "head.conv.weight" not in state:
            h = cba(x, "stem", 2, act="relu")
            for j, st in enumerate(V1_STRIDES):
                h = cba(h, f"blocks.{j}.dw", st, True, "relu")
                h = cba(h, f"blocks.{j}.pw", act="relu")
        else:
            h, j = cba(x, "stem", 2), 0
            for t, _, n, st in V2_STAGES:
                for i in range(n):
                    p, inp, k = f"blocks.{j}.block", h, 0
                    if t != 1:
                        h, k = cba(h, f"{p}.0"), 1
                    stride = st if i == 0 else 1
                    h = cba(h, f"{p}.{k}", stride, True)
                    h = cba(h, f"{p}.{k + 1}", act=None)
                    if stride == 1 and inp.shape[1] == h.shape[1]:
                        h = inp + h
                    j += 1
            h = cba(h, "head")
        return h.mean(dim=(2, 3)) @ state["fc.weight"] + state["fc.bias"]


def _share(got, want):
    """|got - want|'s largest entry over want's largest |value|."""
    scale = float(want.abs().max()) or 1.0
    return float((got.float() - want.float()).abs().max()) / scale


def channels_last_check(gpu, device="cuda", shapes=CHANNELS_LAST_SHAPES):
    """Phase 26(b): ``ops.conv2d`` on NHWC data with an HWIO weight
    (``data_format="NHWC"``) against the NCHW call on the same bfloat16
    data, forward and backward (dx, dw, for one cotangent), each within
    RESNET_CONV_TOL of the largest |value|; the channels-last call run
    twice, and the shapes whose bits move between the two are listed.
    Returns ``(worst share, shapes whose bits moved, shapes whose
    channels-last bits equal the NCHW call's)``."""
    import torch

    from paddle_tpu_torch import ops

    g = torch.Generator(device=device).manual_seed(26)
    worst, moving, equal = 0.0, [], []
    for label, xs, ws, stride, pad, groups in shapes:
        x = torch.randn(xs, generator=g, device=device).to(torch.bfloat16)
        w = (torch.randn(ws, generator=g, device=device) * (2.0 / (
            ws[1] * ws[2] * ws[3])) ** 0.5).to(torch.bfloat16)
        dy = []

        def run(last):
            xi = (x.permute(0, 2, 3, 1).contiguous() if last else
                  x.clone()).requires_grad_()
            wi = (w.permute(2, 3, 1, 0).contiguous() if last else
                  w.clone()).requires_grad_()
            out = ops.conv2d(xi, wi, stride=stride, padding=pad,
                             groups=groups,
                             data_format="NHWC" if last else "NCHW")
            if not dy:
                dy.append(torch.randn(out.shape, generator=g,
                                      device=device).to(out.dtype))
            cot = dy[0].permute(0, 2, 3, 1) if last else dy[0]
            dx, dw = torch.autograd.grad(out, (xi, wi), cot)
            if last:
                out, dx = out.permute(0, 3, 1, 2), dx.permute(0, 3, 1, 2)
                dw = dw.permute(3, 2, 0, 1)
            return [out.detach(), dx, dw]

        want = run(False)
        got, again = run(True), run(True)
        errs = [_share(a, b) for a, b in zip(got, want)]
        worst = max(worst, *errs)
        check(all(torch.equal(a, b) for a, b in zip(got, want))
              or max(errs) <= RESNET_CONV_TOL,
              f"vision (b) channels-last conv2d {label}: out/dx/dw differ "
              f"from the NCHW call by {[f'{e:.3e}' for e in errs]} of the "
              f"largest |value| (tol {RESNET_CONV_TOL})")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            moving.append(label)
        if all(torch.equal(a, b) for a, b in zip(got, want)):
            equal.append(label)
        del x, w, dy, want, got, again
    log(f"vision (b): channels-last conv2d (NHWC x, HWIO weight) = the NCHW "
        f"call within {worst:.3e} of the largest |value| (tol "
        f"{RESNET_CONV_TOL}), output, dx and dw, at {len(shapes)} shapes "
        f"of ResNet-50 and MobileNetV2, bfloat16; the same bits as NCHW: "
        f"{equal or 'none'}; bits that moved between two runs: "
        f"{moving or 'none'} [{gpu}]")
    return worst, moving, equal


def deformable_check(gpu, device="cuda", shape=None):
    """Phase 26(b): ``deformable_conv`` v1 and v2 at ``DEFORM_SHAPE``
    (offsets of a few pixels, some taps off the map), float32, on the
    card against the CPU: the output and the gradients of x, offset,
    mask, weight and bias within LAYER_F32_TOL of the largest |value|;
    run twice on the card, the versions whose bits move listed (the
    backward's scatter into x adds with ``index_put_`` in deterministic
    mode). Returns ``(worst share, versions whose bits moved)``."""
    import torch

    from paddle_tpu_torch import ops

    sh = dict(DEFORM_SHAPE, **(shape or {}))
    B, C, H, W, O = (sh[k] for k in "BCHWO")
    rng = np.random.RandomState(26)
    arrays = [rng.randn(B, C, H, W), rng.randn(B, 18, H, W) * 2.0,
              1.0 / (1.0 + np.exp(-rng.randn(B, 9, H, W))),
              rng.randn(O, C, 3, 3) * (2.0 / (C * 9)) ** 0.5,
              rng.randn(O) * 0.1, rng.randn(B, O, H, W)]
    arrays = [a.astype(np.float32) for a in arrays]
    worst, moving = 0.0, []
    for v2 in (False, True):
        def run(dev):
            x, off, mask, w, b, dy = (torch.from_numpy(a).to(dev)
                                      for a in arrays)
            ins = [t.requires_grad_() for t in (x, off, mask, w, b)]
            out = ops.deformable_conv(x, off, mask if v2 else None, O, 3,
                                      padding=1, weight=w, bias=b)
            used = ins if v2 else [x, off, w, b]
            return [t.detach().cpu() for t in
                    [out, *torch.autograd.grad(out, used, dy)]]

        want = run("cpu")
        got, again = run(device), run(device)
        errs = [_share(a, b) for a, b in zip(got, want)]
        worst = max(worst, *errs)
        label = "v2" if v2 else "v1"
        check(max(errs) <= LAYER_F32_TOL, f"vision (b) deformable_conv "
              f"{label}: the card's output and gradients differ from the "
              f"CPU's by {[f'{e:.3e}' for e in errs]} (tol {LAYER_F32_TOL})")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            moving.append(label)
    log(f"vision (b): deformable_conv v1 and v2 at ({B}, {C}, {H}, {W}) -> "
        f"{O} float32 on the card = on the CPU within {worst:.3e} of the "
        f"largest |value| (tol {LAYER_F32_TOL}), output and every "
        f"gradient; bits that moved between two runs: {moving or 'none'} "
        f"[{gpu}]")
    return worst, moving


_IMG = _fl(2, 4, 6, 6)
_IMG5 = _fl(2, 3, 5, 6, 7)
_POS = lambda *shape: lambda r: (r.rand(*shape) + 0.5).astype(np.float32)
_TREE = _const(np.array([[[0, 1], [0, 2], [1, 3], [1, 4]]] * 2))
# the op library's rest in paddle_tpu_torch.ops (the channels-last convs
# aside); each has a case in OPS_REST_CASES
NEW_OP_NAMES = (
    "pool2d", "adaptive_pool3d", "image_resize", "resize_bilinear",
    "resize_nearest", "resize_trilinear", "pixel_unshuffle",
    "space_to_depth", "shuffle_channel", "im2sequence", "grid_sampler",
    "deformable_conv", "l2_normalize", "data_norm", "lrn",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "floor_mod", "sums", "reshape_", "reverse", "top_k",
    "transpose_", "range_", "uniform_random", "gaussian", "gaussian_random",
    "cos_sim", "dice_loss", "huber_loss", "rank_loss", "margin_rank_loss",
    "bpr_loss", "center_loss", "teacher_student_sigmoid_loss", "mean_iou",
    "multiplex", "crop_tensor", "unstack", "bilinear_tensor_product",
    "add_position_encoding", "temporal_shift", "affine_channel",
    "gather_tree", "sampling_id", "ctc_greedy_decoder", "fsp_matrix",
    "clip_by_norm", "brelu", "soft_relu", "unique_with_counts", "hash",
    "similarity_focus", "polygon_box_transform", "tree_conv")
# phase 26(b): (name, call(m, d, *inputs), inputs, flags) as TENSOR_CASES;
# "bits": the card's outputs must equal the CPU's bit for bit (ops that
# only move, select or clip values; their gradients may sum overlapping
# windows in another order: within LAYER_F32_TOL)
OPS_REST_CASES = [
    ("conv2d", lambda m, d, x, w: m.ops.conv2d(
        x, w, padding=1, data_format="NHWC"),
     [_fl(2, 6, 6, 4), _fl(3, 3, 4, 5)], "grad"),
    ("conv1d", lambda m, d, x, w: m.ops.conv1d(
        x, w, stride=2, data_format="NLC"), [_fl(2, 9, 4), _fl(3, 4, 5)],
     "grad"),
    ("conv3d", lambda m, d, x, w: m.ops.conv3d(
        x, w, bias=None, data_format="NDHWC"),
     [_fl(2, 4, 4, 4, 3), _fl(2, 2, 2, 3, 4)], "grad"),
    ("pool2d", lambda m, d, x: m.ops.pool2d(x, 2, "max", 2), [_IMG],
     "grad bits"),
    ("pool2d", lambda m, d, x: m.ops.pool2d(x, 3, "avg", 1, 1), [_IMG],
     "grad"),
    ("pool2d", lambda m, d, x: m.ops.pool2d(x, 2, "avg",
                                            global_pooling=True), [_IMG],
     "grad"),
    ("adaptive_pool3d", lambda m, d, x: m.ops.adaptive_pool3d(
        x, (2, 3, 4)), [_IMG5], "grad bits"),
    ("adaptive_pool3d", lambda m, d, x: m.ops.adaptive_pool3d(
        x, 3, "avg"), [_IMG5], "grad"),
    *[("image_resize", lambda m, d, x, k=k: m.ops.image_resize(
        x, (8, 9), resample=k), [_fl(2, 3, 5, 7)], "grad")
      for k in ("BILINEAR", "NEAREST", "BICUBIC")],
    ("image_resize", lambda m, d, x: m.ops.image_resize(
        x, (4, 5, 6), resample="TRILINEAR", align_corners=False),
     [_IMG5], "grad"),
    ("resize_bilinear", lambda m, d, x: m.ops.resize_bilinear(
        x, (9, 4), align_corners=False, align_mode=0), [_fl(2, 3, 5, 7)],
     "grad"),
    ("resize_nearest", lambda m, d, x: m.ops.resize_nearest(x, scale=2),
     [_fl(2, 3, 5, 7)], "grad bits"),
    ("resize_trilinear", lambda m, d, x: m.ops.resize_trilinear(
        x, (7, 4, 9)), [_IMG5], "grad"),
    ("pixel_unshuffle", lambda m, d, x: m.ops.pixel_unshuffle(x, 2),
     [_IMG], "grad bits"),
    ("space_to_depth", lambda m, d, x: m.ops.space_to_depth(x, 3), [_IMG],
     "grad bits"),
    ("shuffle_channel", lambda m, d, x: m.ops.shuffle_channel(x, 2),
     [_IMG], "grad bits"),
    ("im2sequence", lambda m, d, x: m.ops.im2sequence(x, 3, 2, 1), [_IMG],
     "grad bits"),
    ("grid_sampler", lambda m, d, x, g: m.ops.grid_sampler(x, g),
     [_IMG, lambda r: (r.rand(2, 3, 5, 2) * 2.2 - 1.1).astype(np.float32)],
     "grad"),
    ("deformable_conv", lambda m, d, x, o, k, w: m.ops.deformable_conv(
        x, o, k, 3, 3, padding=1, weight=w),
     [_IMG, _fl(2, 18, 6, 6), _POS(2, 9, 6, 6), _fl(3, 4, 3, 3)], "grad"),
    ("deformable_conv", lambda m, d, x, o, w: m.ops.deformable_conv(
        x, o, None, 4, 3, stride=2, groups=2, deformable_groups=2,
        weight=w), [_IMG, _fl(2, 36, 2, 2), _fl(4, 2, 3, 3)], "grad"),
    ("l2_normalize", lambda m, d, x: m.ops.l2_normalize(x, 1),
     [_fl(4, 5)], "grad"),
    ("data_norm", lambda m, d, x: m.ops.data_norm(x), [_fl(6, 5, 3)],
     "grad"),
    ("data_norm", lambda m, d, x, n, s, q: m.ops.data_norm(
        x, act="relu", stats=(n, s, q)),
     [_fl(6, 5), _const(np.full(5, 8.0, np.float32)), _fl(5),
      _POS(5)], "grad"),
    ("lrn", lambda m, d, x: m.ops.lrn(x, 3), [_fl(*_X)], "grad"),
    *[(n, lambda m, d, x, y, n=n: getattr(m.ops, n)(x, y),
       [_fl(4, 5), _POS(4, 5)], "grad")
      for n in ("elementwise_add", "elementwise_sub", "elementwise_mul",
                "elementwise_div")],
    ("floor_mod", lambda m, d, x, y: m.ops.floor_mod(x, y),
     [_ints(9, 4, 5), _const(np.array([2, 3, 4, 5, 7]))], ""),
    ("sums", lambda m, d, x, y: m.ops.sums([x, y]), [_fl(4, 5), _fl(4, 5)],
     "grad"),
    ("reshape_", lambda m, d, x: m.ops.reshape_(x, [5, 4]), [_fl(4, 5)],
     "grad bits"),
    ("reverse", lambda m, d, x: m.ops.reverse(x, 0), [_fl(4, 5)],
     "grad bits"),
    ("top_k", lambda m, d, x: m.ops.top_k(x, 2), [_fl(4, 5)], "grad bits"),
    ("transpose_", lambda m, d, x: m.ops.transpose_(x, 0, 2), [_fl(*_X)],
     "grad bits"),
    ("range_", lambda m, d: m.ops.range_(1, 11, 3, **d), [], ""),
    ("uniform_random", lambda m, d: m.ops.uniform_random([3, 4], **d), [],
     "random"),
    ("gaussian", lambda m, d: m.ops.gaussian(1.0, 2.0, [3, 4], **d), [],
     "random"),
    ("gaussian_random", lambda m, d: m.ops.gaussian_random(
        shape=[5], **d), [], "random"),
    ("cos_sim", lambda m, d, x, y: m.ops.cos_sim(x, y),
     [_fl(4, 5), _fl(4, 5)], "grad"),
    ("dice_loss", lambda m, d, x, y: m.ops.dice_loss(x, y),
     [_PROB, _ints(6, 4, 1)], "grad"),
    ("huber_loss", lambda m, d, x, y: m.ops.huber_loss(x, y, 0.7),
     [_fl(4, 5), _fl(4, 5)], "grad"),
    ("rank_loss", lambda m, d, y, a, b: m.ops.rank_loss(y, a, b),
     [_Y01, _fl(4, 5), _fl(4, 5)], "grad"),
    ("margin_rank_loss", lambda m, d, y, a, b: m.ops.margin_rank_loss(
        y, a, b, 0.3), [_PM1, _fl(4), _fl(4)], "grad"),
    ("bpr_loss", lambda m, d, x, y: m.ops.bpr_loss(x, y),
     [_fl(4, 5), _ints(5, 4, 1)], "grad"),
    ("center_loss", lambda m, d, x, y, c: m.ops.center_loss(
        x, y, 3, 0.5, centers=c), [_fl(6, 4), _ints(3, 6, 1), _fl(3, 4)],
     "grad"),
    ("teacher_student_sigmoid_loss",
     lambda m, d, x, y: m.ops.teacher_student_sigmoid_loss(
         x, y, 2.0, -2.0), [_fl(4, 5, scale=3.0), _Y01], "grad"),
    ("mean_iou", lambda m, d, p, y: m.ops.mean_iou(p, y, 4),
     [_ints(4, 2, 9), _ints(4, 2, 9)], ""),
    ("multiplex", lambda m, d, a, b, c, i: m.ops.multiplex([a, b, c], i),
     [_fl(4, 5), _fl(4, 5), _fl(4, 5), _ints(3, 4, 1)], "grad bits"),
    ("crop_tensor", lambda m, d, x: m.ops.crop_tensor(
        x, [2, -1, 3], [1, 2, 3]), [_fl(4, 6, 5)], "grad bits"),
    ("unstack", lambda m, d, x: m.ops.unstack(x, 1), [_fl(3, 4, 2)],
     "grad bits"),
    ("bilinear_tensor_product",
     lambda m, d, x, y, w, b: m.ops.bilinear_tensor_product(
         x, y, 2, weight=w, bias=b, act="tanh"),
     [_fl(4, 3), _fl(4, 5), _fl(2, 3, 5), _fl(2)], "grad"),
    ("add_position_encoding",
     lambda m, d, x: m.ops.add_position_encoding(x, 0.5, 2.0),
     [_fl(2, 6, 7)], "grad"),
    ("temporal_shift", lambda m, d, x: m.ops.temporal_shift(x, 2),
     [_fl(4, 8, 3, 3)], "grad bits"),
    ("affine_channel", lambda m, d, x, s, b: m.ops.affine_channel(
        x, s, b, act="relu"), [_IMG, _fl(4), _fl(4)], "grad"),
    ("gather_tree", lambda m, d, i, p: m.ops.gather_tree(i, p),
     [_ints(10, 5, 2, 3), _ints(3, 5, 2, 3)], ""),
    ("sampling_id", lambda m, d, p: m.ops.sampling_id(p), [_POS(6, 5)],
     "random"),
    ("ctc_greedy_decoder", lambda m, d, x, n: m.ops.ctc_greedy_decoder(
        x, 0, n), [_fl(3, 7, 4), _const(np.array([7, 4, 6]))], ""),
    ("fsp_matrix", lambda m, d, x, y: m.ops.fsp_matrix(x, y),
     [_fl(2, 3, 4, 4), _fl(2, 5, 4, 4)], "grad"),
    ("clip_by_norm", lambda m, d, x: m.ops.clip_by_norm(x, 1.0),
     [_fl(4, 5)], "grad"),
    ("brelu", lambda m, d, x: m.ops.brelu(x, -1.0, 2.0),
     [_fl(4, 5, scale=3.0)], "grad bits"),
    ("soft_relu", lambda m, d, x: m.ops.soft_relu(x, 2.0),
     [_fl(4, 5, scale=3.0)], "grad"),
    ("unique_with_counts", lambda m, d, x: m.ops.unique_with_counts(x),
     [_ints(5, 12)], ""),
    ("hash", lambda m, d, x: m.ops.hash(x, 97, 3), [_ints(1000, 4, 3)], ""),
    ("similarity_focus", lambda m, d, x: m.ops.similarity_focus(
        x, 1, [0, 2]), [_fl(2, 3, 4, 5)], "bits"),
    ("polygon_box_transform",
     lambda m, d, x: m.ops.polygon_box_transform(x), [_fl(2, 4, 3, 5)],
     "grad bits"),
    ("tree_conv", lambda m, d, x, e, w: m.ops.tree_conv(
        x, e, 2, 2, max_depth=3, weight=w),
     [_fl(2, 5, 3), _TREE, _fl(3, 3, 2, 2)], "grad"),
]


def ops_rest_card_check(gpu, device="cuda"):
    """Phase 26(b): every name of the op library's rest
    (``NEW_OP_NAMES``, and the channels-last convs) at a small size,
    forward and (where differentiable) backward, on the card against the
    port on the CPU (``_tensor_run``): floats within LAYER_F32_TOL of the
    largest |value|, or, where a case says ``bits``, its outputs bit for
    bit; integers exactly; a random maker held to its shape and type.
    Each case runs twice on the card; the names whose bits move are
    listed. Returns them.
    (``device="cpu"`` runs the checks with the CPU in the card's
    place.)"""
    import torch

    t0 = time.perf_counter()
    worst, moving = 0.0, []
    for name, call, inputs, flags in OPS_REST_CASES:
        rng = np.random.RandomState(0)
        arrays = [make(rng) for make in inputs]
        seed = 5 if "random" in flags else None
        want = _tensor_run(call, arrays, flags, "cpu", None, seed)
        runs = [_tensor_run(call, arrays, flags, device, want[2], seed)
                for _ in range(2)]
        got = runs[0]
        check(len(got[0]) == len(want[0]) and len(got[1]) == len(want[1]),
              f"vision (b) {name}: another count of outputs or gradients")
        outs = len(got[0])
        for k, (g, w) in enumerate(list(zip(got[0], want[0]))
                                   + list(zip(got[1], want[1]))):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"vision (b) {name}: {tuple(g.shape)} {g.dtype} vs the "
                  f"CPU's {tuple(w.shape)} {w.dtype}")
            if "random" in flags:
                continue
            if not w.is_floating_point() or ("bits" in flags and k < outs):
                check(torch.equal(g, w), f"vision (b) {name}: the card's "
                      f"result is not the CPU's bit for bit")
                continue
            err = _share(g, w) if w.numel() else 0.0
            worst = max(worst, err)
            check(err <= LAYER_F32_TOL, f"vision (b) {name}: card vs CPU "
                  f"{err:.3g} of the largest |value|, limit {LAYER_F32_TOL}")
        flat = lambda r: r[0] + r[1]
        if not all(torch.equal(a, b) for a, b in zip(flat(runs[0]),
                                                        flat(runs[1]))):
            moving.append(name)
    names = {c[0] for c in OPS_REST_CASES}
    check(set(NEW_OP_NAMES) <= names,
          f"vision (b): no case for {sorted(set(NEW_OP_NAMES) - names)}")
    log(f"vision (b): {len(OPS_REST_CASES)} cases of {len(NEW_OP_NAMES)} new "
        f"op names and the channels-last convs on the card = on the CPU "
        f"within {worst:.3g} of the largest |value| (limit "
        f"{LAYER_F32_TOL}; the movement and clipping ops bit for bit), "
        f"forward and backward; bits that changed between two runs on the "
        f"card: {moving or 'none'}; took {time.perf_counter() - t0:.1f} s "
        f"[{gpu}]")
    return moving


def vision_phase(gpu):
    """Phase 26: (a) ``vgg16()``, ``MobileNetV1()`` and ``MobileNetV2()``
    at full width, each as bench_resnet50 trains ResNet-50 (224 x 224,
    1000 classes, its default dropout, batch 128 from RandomState(0),
    ``bfloat16()``, Momentum(0.1, 0.9, multi_precision), the float32
    cross-entropy) through ``image_train_check`` against its float32
    reference forward; (b) the op library's rest on the card:
    ``channels_last_check``, ``deformable_check``,
    ``ops_rest_card_check``."""
    t0 = time.perf_counter()
    refs = {"vgg16": vgg_reference_forward,
            "mobilenet_v1": mobilenet_reference_forward,
            "mobilenet_v2": mobilenet_reference_forward}
    out = {}
    for config in VISION_CONFIGS:
        name = TRAIN_CONFIGS[config]["model"]
        out[name] = image_phase(f"vision {name}", config, gpu, refs[name])
    channels_last_check(gpu)
    deformable_check(gpu)
    ops_rest_card_check(gpu)
    log(f"vision: phase took {time.perf_counter() - t0:.1f} s [{gpu}]")
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
        import paddle_tpu_torch.ops.kernels._build  # noqa: F401
        import paddle_tpu_torch.serving  # noqa: F401
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
        import paddle_tpu_torch.static_  # noqa: F401
        import paddle_tpu_torch.analysis  # noqa: F401
        import paddle_tpu_torch.quant.passes  # noqa: F401
        import paddle_tpu_torch.utils.envspec  # noqa: F401
        import paddle_tpu_torch.nn.initializer  # noqa: F401
        import paddle_tpu_torch.obs.report  # noqa: F401
        import paddle_tpu_torch.models.nlp.sentiment  # noqa: F401
        import paddle_tpu_torch.models.rec  # noqa: F401
        import paddle_tpu_torch.modules_compat  # noqa: F401
        import paddle_tpu_torch.tensor.math  # noqa: F401
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
           "paddle_tpu_torch.obs.reqtrace", "paddle_tpu_torch.obs.fleet",
           "paddle_tpu_torch.obs.report", "paddle_tpu_torch.nn.initializer",
           "paddle_tpu_torch.nn.param_attr", "paddle_tpu_torch.optim.optimizer",
           "paddle_tpu_torch.models.nlp.sentiment",
           "paddle_tpu_torch.nn.layers.rnn", "paddle_tpu_torch.nn.layers.loss",
           "paddle_tpu_torch.ops.reduction",
           "paddle_tpu_torch.ops.control_flow", "paddle_tpu_torch.ops.linalg",
           "paddle_tpu_torch.models.nlp.word2vec",
           "paddle_tpu_torch.models.rec.recommender",
           "paddle_tpu_torch.nn.layer", "paddle_tpu_torch.core.device",
           "paddle_tpu_torch.core.dtype", "paddle_tpu_torch.core.tensor",
           "paddle_tpu_torch.core.autograd", "paddle_tpu_torch.modules_compat"}
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

    import shutil
    import tempfile

    # the journals phases 13 and 19 write and phase 22 reads
    journals = tempfile.mkdtemp(prefix="chip_smoke_journals_")
    try:
        return phases(gpu, journals)
    finally:
        shutil.rmtree(journals, ignore_errors=True)


def phases(gpu, journals):
    """Phases 1-26 in order, the journals of 13, 19 and 22 under
    ``journals``; prints the ``kernels`` and ``ok`` lines."""
    import torch

    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.serving import PagedKVCache, TinyLM

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
    fleet_phase(prompts, gpu, journals)
    train_graph_phase(gpu)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    decode_phase(gpu)
    log(f"decode: phase took {time.perf_counter() - t0:.1f} s")
    train_resnet_phase(gpu)
    checkpoint_phase(gpu)
    static_phase(gpu)
    serve_bench_phase(gpu, journals)
    int8_phase(gpu)
    torch.cuda.empty_cache()
    f16_errs, f16_t, f16_launches = amp_phase(gpu)
    torch.cuda.empty_cache()
    rare_phase(gpu, journals)
    torch.cuda.empty_cache()
    layers_phase(gpu)
    torch.cuda.empty_cache()
    tensor_phase(gpu)
    torch.cuda.empty_cache()
    surface_phase(gpu)
    torch.cuda.empty_cache()
    vision_phase(gpu)
    check(not any(m.split(".")[0] in ("jax", "paddle_tpu", "ml_dtypes")
                  for m in sys.modules),
          "the JAX side was imported by a phase")

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
    # the float16 variants: flash timed and launched under O1, LayerNorm
    # and cross-entropy under O2 (phase 21)
    for name, tt in f16_t.items():
        rows.append({"name": f"{name}[float16]", "route": "cuda",
                     "source": kernels.KERNELS[name].SOURCE,
                     "replaces": getattr(kernels.KERNELS[name],
                                         name).replaces,
                     "launches": f16_launches[name],
                     "max_abs_err": f16_errs[name], **tt})
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
