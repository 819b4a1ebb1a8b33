"""paddle_tpu_torch on the card: the CUDA kernels, the engine, the GPT
training step on CUDA, the step as one CUDA graph, decoding as one CUDA
graph, and checkpoints and guards around the graphed step (an in-place
load replays the same graph; an async save's snapshot is complete when
the call returns; a guarded skip keeps one graph).

Every test here needs a Hopper card and skips without one (the
decision is made inside the ``hopper`` fixture). The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances, kernel against its plain PyTorch version on the same
inputs (atol and rtol): paged attention 2e-5 for float32 pools, 2e-2 for
bfloat16 pools; LayerNorm and softmax-cross-entropy 1e-5 in float32 and
2e-2 in bfloat16, with dgamma/dbeta (sums over N rows) and dlogits
(``p * g - onehot * g``, most entries ~g/V) held at that tolerance times
the sum of the magnitudes of their terms; flash attention as
``chip_smoke.flash_close``: float32 1e-5 (rtol, and atol of 1 for O and
lse, of the largest entry for a gradient), bfloat16 one bfloat16 step
(rtol 2^-7) with the same atol.
"""
import numpy as np
import pytest
import torch

from chip_smoke import flash_close
from paddle_tpu_torch import amp, core, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.nlp import gpt
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import layernorm as ln
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.kernels import softmax_ce as ce
from paddle_tpu_torch.serving import (ManualClock, PagedKVCache,
                                      Scheduler, ServeEngine, TinyLM)

pytestmark = pytest.mark.cuda

F32_TOL = 2e-5
BF16_TOL = 2e-2
TRAIN_TOLS = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) card")
    return torch.device("cuda")


def _inputs(lengths, H, D, page, P, W, pool_dtype, device, seed=0):
    """Random pools, shuffled distinct pages per lane, tail entries 0."""
    g = torch.Generator().manual_seed(seed)
    B = len(lengths)
    q = torch.randn(B, H, D, generator=g)
    k = torch.randn(P, page, H, D, generator=g).to(pool_dtype)
    v = torch.randn(P, page, H, D, generator=g).to(pool_dtype)
    perm = torch.randperm(P - 1, generator=g) + 1
    table = torch.zeros(B, W, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lengths):
        need = -(-n // page)
        table[b, :need] = perm[used:used + need].int()
        used += need
    lengths = torch.tensor(lengths, dtype=torch.int32)
    return tuple(t.to(device) for t in (q, k, v, table, lengths))


# one chunk of the kernel's split over pages at page 16, in tokens
CHUNK = pa.chunk_pages(16) * 16


@pytest.mark.parametrize("pool_dtype, tol", [(torch.float32, F32_TOL),
                                             (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("geom", [
    # (lengths, H, D, page, P, W)
    ([1, 7, 8, 23, 0], 2, 8, 8, 32, 5),
    ([0, 1, 15, 16, 17, 2000], 12, 64, 16, 512, 128),
    # exactly one chunk, one token past it, a 2049-token lane
    ([CHUNK, CHUNK + 1, 2049, 0, 3], 12, 64, 16, 512, 129),
    ([CHUNK, CHUNK + 1, 2049, 0], 2, 100, 16, 512, 160),
])
def test_kernel_matches_plain_version(hopper, geom, pool_dtype, tol):
    lengths, H, D, page, P, W = geom
    args = _inputs(lengths, H, D, page, P, W, pool_dtype, hopper)
    before = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(*args)
    again = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 2
    ref = pa.paged_decode_attention_reference(*args)
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
    zero = args[4] == 0
    assert torch.all(out[zero] == 0)
    # the chunks are combined in a fixed order: the same bits every call
    assert torch.equal(out, again)


def test_kernel_raises_on_cuda_instead_of_falling_back(hopper):
    args = _inputs([3], 2, 8, 4, 8, 1, torch.float32, hopper)
    bad = (args[0].double(),) + args[1:]
    with pytest.raises(ValueError):
        pa.paged_decode_attention(*bad)


def test_engine_on_card_matches_its_oracle(hopper):
    model = TinyLM(vocab_size=64, num_heads=2, head_dim=8, seed=0)
    cache = PagedKVCache(6, 4, 2, 8, max_seq_len=16)
    assert model.embedding.device.type == "cuda"
    assert cache.k_pages.device.type == "cuda"
    clock = ManualClock()
    eng = ServeEngine(model, cache, scheduler=Scheduler(
        cache, token_budget=64, clock=clock))
    rng = np.random.RandomState(2)
    pairs = []
    for _ in range(3):
        prompt = list(rng.randint(0, 64, 5))
        pairs.append((eng.submit(prompt, max_new_tokens=8), prompt))
        clock.advance(0.01)
    before = pa.paged_decode_attention.launches
    eng.run(max_steps=300)
    assert eng.scheduler.preemptions >= 1
    assert pa.paged_decode_attention.launches - before == \
        eng.usage.decode_steps > 0
    for r, prompt in pairs:
        assert r.generated == model.reference_generate(prompt, 8)
    assert cache.stats()["used_pages"] == 0 and cache.verify()


def _close(out, ref, tol, scale=None):
    """|out - ref| <= tol * (1 + |ref|), or tol * scale (plus the least
    normal float32) for a value whose terms' magnitudes sum to scale."""
    err = (out.float() - ref.float()).abs()
    bound = (tol * (1 + ref.float().abs()) if scale is None else
             tol * scale + torch.finfo(torch.float32).tiny)
    assert bool((err <= bound).all()), f"max abs err {err.max().item()}"


def _ce_bwd_scale(x, lab, lse, g):
    """p * g + onehot * g per dlogits entry, p = exp(x - lse); 0 on
    ignore_index rows."""
    valid = lab != -100
    gv = g.float() * valid
    scale = torch.exp(x.float() - lse[:, None]) * gv[:, None]
    rows = valid.nonzero()[:, 0]
    scale[rows, lab[rows].long()] += gv[rows]
    return scale


def _off16(t):
    """``t``'s values one element past a 16-byte boundary: the dispatch
    then sends the LayerNorm kernels to their scalar versions."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view_as(t)


@pytest.mark.parametrize("dtype, tol", TRAIN_TOLS)
@pytest.mark.parametrize("N, D", [(8, 128), (13, 768), (1024, 256),
                                  (37, 100), (5, ln.MAX_D), (9, 1024),
                                  (9, 1028), (9, 1032)])
def test_layer_norm_kernels_match_plain_versions(hopper, N, D, dtype, tol):
    """Every path of the dispatch on D: 16-byte vectors with the row in
    registers (128, 768, 256; 100 in float32; the backward's last
    vector width, 1024 = 8 float32 or 4 bfloat16 vectors a lane), scalar
    loads (100 in bfloat16, not a whole number of 8-wide vectors; 1028
    and 1032, one vector past the backward's vector path in bfloat16 and
    float32; MAX_D, wider than the register tile)."""
    g = torch.Generator().manual_seed(N + D)
    x, dy = ((torch.randn(N, D, generator=g) * 2 + 0.5).to(hopper, dtype)
             for _ in range(2))
    gamma, beta = (torch.randn(D, generator=g).to(hopper, dtype)
                   for _ in range(2))
    _check_layer_norm(x, dy, gamma, beta, tol)


@pytest.mark.parametrize("dtype, tol", TRAIN_TOLS)
def test_layer_norm_kernels_off_16_byte_alignment(hopper, dtype, tol):
    """An x one element off a 16-byte boundary at D = 768 takes the
    scalar kernels, with the same checks."""
    g = torch.Generator().manual_seed(768)
    x, dy = ((torch.randn(13, 768, generator=g) * 2 + 0.5).to(hopper, dtype)
             for _ in range(2))
    gamma, beta = (torch.randn(768, generator=g).to(hopper, dtype)
                   for _ in range(2))
    _check_layer_norm(_off16(x), dy, gamma, beta, tol)


def _check_layer_norm(x, dy, gamma, beta, tol):
    before = kernels.launches()
    y, mean, rstd = ln.layer_norm_fwd(x, gamma, beta, 1e-5)
    dx, dg, db = ln.layer_norm_bwd(x, gamma, mean, rstd, dy)
    dx2, dg2, db2 = ln.layer_norm_bwd(x, gamma, mean, rstd, dy)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert after["layer_norm_fwd"] == before["layer_norm_fwd"] + 1
    assert after["layer_norm_bwd"] == before["layer_norm_bwd"] + 2
    yr, mr, rr = ln.layer_norm_fwd_reference(x, gamma, beta, 1e-5)
    dxr, dgr, dbr = ln.layer_norm_bwd_reference(x, gamma, mean, rstd, dy)
    _close(y, yr, tol)
    _close(mean, mr, 1e-5)
    _close(rstd, rr, 1e-5)
    _close(dx, dxr, tol)
    xhat = (x.float() - mean) * rstd
    _close(dg, dgr, tol, (dy.float() * xhat).abs().sum(0))
    _close(db, dbr, tol, dy.float().abs().sum(0))
    # no atomics: the same bits on every run
    assert torch.equal(dg, dg2) and torch.equal(db, db2)
    assert torch.equal(dx, dx2)


def test_cuda_sqrt_is_correctly_rounded(hopper):
    """The Adam update keeps ``torch.sqrt`` on the card
    (``optim/optimizer.py`` ``_sqrt``): CUDA's float32 root equals the
    float64 root rounded to float32, bitwise, over 2^20 random inputs in
    each of three ranges (the CPU's does not on every host)."""
    g = torch.Generator(device=hopper).manual_seed(0)
    for hi in (1e-4, 1.0, 1e4):
        v = torch.rand(1 << 20, generator=g, device=hopper) * hi
        assert torch.equal(torch.sqrt(v), torch.sqrt(v.double()).float())


@pytest.mark.parametrize("dtype, tol", TRAIN_TOLS)
@pytest.mark.parametrize("N, V, scale", [(16, 384, 3.0), (7, 1000, 3.0),
                                         (8, 4096, 1e3)])
def test_softmax_ce_kernels_match_plain_versions(hopper, N, V, scale, dtype,
                                                 tol):
    g = torch.Generator().manual_seed(N + V)
    x = (torch.randn(N, V, generator=g) * scale).to(hopper, dtype)
    lab = torch.randint(0, V, (N,), generator=g)
    lab[::3] = -100
    lab = lab.to(hopper)
    grad = torch.rand(N, generator=g).to(hopper)
    before = kernels.launches()
    loss, lse = ce.softmax_ce_fwd(x, lab)        # int64 labels
    dx = ce.softmax_ce_bwd(x, lab, lse, grad)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert after["softmax_ce_fwd"] == before["softmax_ce_fwd"] + 1
    assert after["softmax_ce_bwd"] == before["softmax_ce_bwd"] + 1
    lr, lser = ce.softmax_ce_fwd_reference(x, lab)
    _close(loss, lr, 1e-5)
    _close(lse, lser, 1e-5)
    _close(dx, ce.softmax_ce_bwd_reference(x, lab, lse, grad), tol,
           _ce_bwd_scale(x, lab, lse, grad))
    assert torch.all(loss[::3] == 0) and torch.all(dx[::3] == 0)


def test_train_kernel_wrappers_raise_on_bad_arguments(hopper):
    x = torch.randn(8, 128, device=hopper)
    with pytest.raises(ValueError):
        ln.layer_norm_fwd(x.double(), torch.ones(128, device=hopper),
                          torch.zeros(128, device=hopper))
    with pytest.raises(ValueError):
        ln.layer_norm_fwd(x.t(), torch.ones(8, device=hopper),
                          torch.zeros(8, device=hopper))
    with pytest.raises(ValueError):
        ce.softmax_ce_fwd(x, torch.zeros(8, device=hopper))  # float labels


def _tiny_gpt(hopper, dropout):
    cfg = gpt.GPTConfig(vocab_size=512, hidden=128, layers=2, heads=2,
                        max_seq=128, dropout=dropout)
    return gpt.GPT(cfg, device=hopper, generator=torch.Generator(
        device=hopper).manual_seed(0))


def test_tiny_gpt_step_launches_every_training_kernel(hopper):
    """One step at dropout 0.1: 2 LayerNorms a block plus ln_f, forward
    and backward; one cross-entropy forward and backward."""
    m = _tiny_gpt(hopper, 0.1)
    ids = np.random.RandomState(0).randint(0, 512, (8, 128))
    opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=1e-3,
                      grad_clip=optim.ClipGradByGlobalNorm(1.0))
    step = TrainStep(m, opt, gpt.gpt_loss)
    kernels.reset_launches()
    loss = step(ids, np.roll(ids, -1, axis=1))
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    assert kernels.launches() == {
        "paged_decode_attention": 0, "layer_norm_fwd": 5,
        "layer_norm_bwd": 5, "softmax_ce_fwd": 1, "softmax_ce_bwd": 1,
        "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkv": 0}


def _flash_close(out, ref, grad):
    ok, err = flash_close(out, ref, grad)
    assert ok, f"max abs err {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq, Lk, D, causal", [
    (128, 128, 64, True), (128, 384, 64, True), (256, 256, 128, False),
    (100, 300, 64, True), (200, 328, 128, True), (136, 264, 128, False),
    (128, 128, 192, False), (64, 128, 256, True)])
def test_flash_kernels_match_plain_versions(hopper, Lq, Lk, D, causal,
                                            dtype):
    g = torch.Generator().manual_seed(Lq + Lk + D)
    q, k, v, do = (torch.randn(2, 3, L, D, generator=g).to(hopper, dtype)
                   for L in (Lq, Lk, Lk, Lq))
    scale = D ** -0.5
    before = kernels.launches()
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    args = (q, k, v, do, lse, fa.flash_delta(o, do), causal, scale)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    dk2, dv2 = fa.flash_attention_bwd_dkv(*args)
    dq2 = fa.flash_attention_bwd_dq(*args)
    torch.cuda.synchronize()
    after = kernels.launches()
    for name, n in (("flash_attention_fwd", 1), ("flash_attention_bwd_dq", 2),
                    ("flash_attention_bwd_dkv", 2)):
        assert after[name] == before[name] + n
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    _flash_close(o, ro, False)
    _flash_close(lse, rlse, False)
    _flash_close(dq, fa.flash_attention_bwd_dq_reference(*args), True)
    rdk, rdv = fa.flash_attention_bwd_dkv_reference(*args)
    _flash_close(dk, rdk, True)
    _flash_close(dv, rdv, True)
    # no atomics: the same bits on every run
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, dq2)


def test_flash_wrappers_raise_on_bad_arguments(hopper):
    q = torch.randn(1, 2, 128, 96, device=hopper)     # D = 96: not taken
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q, True, 0.1)
    q = torch.randn(1, 128, 2, 64, device=hopper).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q, q, q, True, 0.125)
    q = torch.randn(1, 2, 128, 64, device=hopper)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q.double(), q.double(), q.double(), True,
                               0.125)


def test_tiny_gpt_bf16_step_launches_flash(hopper):
    """One bench_gpt-style step at dropout 0, bfloat16, multi_precision:
    every attention takes the flash kernels (2 blocks), and the logits of
    the trained model match its plain versions'."""
    m = _tiny_gpt(hopper, 0.0)
    m.bfloat16()
    ids = np.random.RandomState(0).randint(0, 512, (8, 128))
    opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=1e-3,
                      multi_precision=True,
                      grad_clip=optim.ClipGradByGlobalNorm(1.0))
    step = TrainStep(m, opt, gpt.gpt_loss)
    kernels.reset_launches()
    loss = step(ids, np.roll(ids, -1, axis=1))
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    assert kernels.launches() == {
        "paged_decode_attention": 0, "layer_norm_fwd": 5,
        "layer_norm_bwd": 5, "softmax_ce_fwd": 1, "softmax_ce_bwd": 1,
        "flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
        "flash_attention_bwd_dkv": 2}
    x = torch.from_numpy(ids).to(hopper)
    with torch.no_grad():
        got = m.eval()(x).float()
        with kernels.plain_versions():
            want = m(x).float()
    # bfloat16 activations: one step at |logit| < 4 where a rounding flips
    torch.testing.assert_close(got, want, atol=2 ** -5, rtol=0)


def test_tiny_bert_step_launches_the_layer_norm_kernels(hopper):
    """One bench_bert-style step of a 2-layer BERT (bfloat16,
    multi_precision, dropout 0.1, an attention mask) at vocab 1000: 6
    LayerNorms forward and backward (the embeddings', two a layer, the
    MLM head's), no cross-entropy kernel (the vocab is not a multiple of
    128) and no flash (the mask). Then the eval forward without a mask:
    2 non-causal flash forwards and 6 LayerNorm forwards, its logits
    within 2^-6 of the largest |logit| of the plain versions' (two
    bfloat16 steps)."""
    from paddle_tpu_torch.models.nlp import bert

    m = bert.BertForPretraining(
        bert.bert_tiny(vocab_size=1000), device=hopper,
        generator=torch.Generator(device=hopper).manual_seed(0)).bfloat16()
    rng = np.random.RandomState(0)
    B, L = 4, 128
    ids = rng.randint(0, 1000, (B, L)).astype("int32")
    tt = np.zeros((B, L), "int32")
    am = np.ones((B, L), "int32")
    am[::2, 100:] = 0
    mlm = np.where(rng.rand(B, L) < 0.15, ids, -100).astype("int32")
    nsp = rng.randint(0, 2, (B,)).astype("int32")
    opt = optim.AdamW(parameters=m.named_parameters(), learning_rate=1e-4,
                      multi_precision=True,
                      grad_clip=optim.ClipGradByGlobalNorm(1.0))
    step = TrainStep(m, opt, bert.bert_pretrain_loss)
    kernels.reset_launches()
    loss = step(ids, tt, am, mlm, nsp)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    none = dict.fromkeys(kernels.launches(), 0)
    assert kernels.launches() == dict(none, layer_norm_fwd=6,
                                      layer_norm_bwd=6)
    x, t = (torch.from_numpy(a).to(hopper) for a in (ids, tt))
    m.eval()
    with torch.no_grad():
        kernels.reset_launches()
        got = m(x, t)[0].float()
        torch.cuda.synchronize()
        assert kernels.launches() == dict(none, layer_norm_fwd=6,
                                          flash_attention_fwd=2)
        with kernels.plain_versions():
            want = m(x, t)[0].float()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=2 ** -6 * want.abs().max().item())


# -- the step as one CUDA graph ----------------------------------------------


def _ids(seed, B=8):
    ids = np.random.RandomState(seed).randint(0, 512, (B, 128))
    return ids, np.roll(ids, -1, axis=1)


def _graph_twins(hopper, dropout, make_opt, calls, bf16=False, **kw):
    """The same tiny GPT trained twice from seed 1's dropout stream:
    through ``TrainStep`` (a graph from its second call) and through
    ``_eager_step``. ``calls(step, fn)`` drives each. Returns ``(graphed
    step, eager step, graphed outputs, eager outputs, launches of the
    graphed run, launches of the eager run)``."""
    out = []
    for graphed in (True, False):
        m = _tiny_gpt(hopper, dropout)
        if bf16:
            m.bfloat16()
        core.seed(1)
        step = TrainStep(m, make_opt(m), gpt.gpt_loss, **kw)
        kernels.reset_launches()
        res = calls(step, step if graphed else step._eager_step)
        torch.cuda.synchronize()
        out.append((step, res, kernels.launches()))
    (gs, gres, gl), (es, eres, el) = out
    return gs, es, gres, eres, gl, el


def _same_parameters(a, b):
    for (n, x), (_, y) in zip(a.model.named_parameters(),
                              b.model.named_parameters()):
        assert torch.equal(x, y), n


def _adamw(m, lr=1e-3, **kw):
    return optim.AdamW(parameters=m.named_parameters(), learning_rate=lr,
                       grad_clip=optim.ClipGradByGlobalNorm(1.0), **kw)


def test_graphed_step_is_the_eager_step_bitwise(hopper):
    """Three steps at dropout 0.1: the first op by op, the second captured
    and replayed, the third replayed. Losses and parameters are the eager
    step's bits (the same kernels, and the same dropout masks from the
    registered generator), and the launches counted over the replays are
    the eager run's: 5 LayerNorms and 1 cross-entropy a step."""
    gs, es, gl, el, gla, ela = _graph_twins(
        hopper, 0.1, _adamw,
        lambda step, fn: [fn(*_ids(i)) for i in range(3)])
    assert torch.equal(torch.stack(gl), torch.stack(el))
    _same_parameters(gs, es)
    assert gla == ela and gla["layer_norm_fwd"] == 15
    assert gla["softmax_ce_bwd"] == 3
    assert [type(g).__name__ for g in gs._graphs.values()] == ["_Graph"]
    assert not es._graphs


def test_scheduler_reaches_every_replay(hopper):
    """Five steps under LinearWarmup into CosineAnnealingDecay: each
    step reads float32(get_lr()) of its call, and the graphed parameters
    are the eager twin's bits."""
    def calls(step, fn):
        sched = step.optimizer._learning_rate
        out, lrs = [], []
        for i in range(5):
            want = np.float32(step.optimizer.get_lr())
            out.append(fn(*_ids(i)))
            dev = next(step.model.parameters()).device
            lrs.append((step.optimizer._lr_tensor(dev).item(), want))
            sched.step()
        assert all(a == b for a, b in lrs) and len(set(lrs)) == 5
        return out

    def make_opt(m):
        return _adamw(m, optim.lr.LinearWarmup(
            optim.lr.CosineAnnealingDecay(1e-3, T_max=5), warmup_steps=2,
            start_lr=1e-4, end_lr=1e-3))

    gs, es, gl, el, _, _ = _graph_twins(hopper, 0.0, make_opt, calls)
    assert torch.equal(torch.stack(gl), torch.stack(el))
    _same_parameters(gs, es)


def test_dropout_draws_new_masks_every_replay(hopper):
    """At lr 0 the parameters never move, so a replay's loss on the same
    batch changes only with its dropout masks."""
    m = _tiny_gpt(hopper, 0.1)
    step = TrainStep(m, optim.SGD(0.0, parameters=m.named_parameters()),
                     gpt.gpt_loss)
    losses = [float(step(*_ids(0))) for _ in range(5)]
    assert len(set(losses[1:])) == 4, losses


def test_poisoned_step_is_skipped_on_the_card(hopper):
    """bfloat16 with masters and a dynamic loss scaler, the third step
    (a replay) poisoned: it leaves parameters, masters and moments
    bitwise, halves the scale and sets the flag; the eager twin gives
    the same bits and scales."""
    def loss_fn_calls(step, fn):
        out = []
        for i in range(5):
            poison = np.array(np.inf if i == 2 else 1.0, np.float32)
            before = [p.detach().clone() for p in step.model.parameters()]
            state = {n: {k: v.clone() for k, v in s.items()}
                     for n, s in step.optimizer._accumulators.items()}
            loss = fn(*_ids(i), poison)
            if i == 2:
                assert all(torch.equal(a, p) for a, p in
                           zip(before, step.model.parameters()))
                assert all(torch.equal(state[n][k], v)
                           for n, s in step.optimizer._accumulators.items()
                           for k, v in s.items())
            out.append((float(loss), bool(step.last_found_inf),
                        float(step._scaler_state["scale"])))
        return out

    def make_opt(m):
        return _adamw(m, multi_precision=True)

    out = []
    for graphed in (True, False):
        m = _tiny_gpt(hopper, 0.0).bfloat16()
        step = TrainStep(m, make_opt(m),
                         lambda model, ids, labels, poison:
                         gpt.gpt_loss(model, ids, labels) * poison,
                         scaler=amp.DynamicLossScaler(
                             2.0 ** 15, incr_every_n_steps=2))
        out.append((step, loss_fn_calls(
            step, step if graphed else step._eager_step)))
    (gs, g), (es, e) = out
    assert g == e
    assert [x[1] for x in g] == [False, False, True, False, False]
    assert [x[2] for x in g] == [2.0 ** 15, 2.0 ** 16, 2.0 ** 15,
                                 2.0 ** 15, 2.0 ** 16]
    _same_parameters(gs, es)


def test_moved_storage_forces_a_new_capture(hopper):
    m = _tiny_gpt(hopper, 0.0)
    step = TrainStep(m, _adamw(m), gpt.gpt_loss)
    for i in range(3):
        step(*_ids(i))
    (old,) = step._graphs.values()
    with torch.no_grad():
        for p in m.parameters():
            p.data = p.data.clone()
    step(*_ids(3))                        # a new key: op by op
    assert list(step._graphs.values()) == [None]
    step(*_ids(4))                        # captured anew
    (new,) = step._graphs.values()
    assert new is not None and new is not old
    twin = _tiny_gpt(hopper, 0.0)
    eager = TrainStep(twin, _adamw(twin), gpt.gpt_loss)
    for i in range(5):
        eager._eager_step(*_ids(i))
    _same_parameters(step, eager)


def test_run_fused_is_four_graphed_calls(hopper):
    """Two windows of 4 (the first op by op, the second one graph of four
    steps) against 8 calls: the same losses and parameters, bitwise."""
    batches = [_ids(i) for i in range(8)]
    out = []
    for fused in (True, False):
        m = _tiny_gpt(hopper, 0.1)
        core.seed(1)
        step = TrainStep(m, _adamw(m), gpt.gpt_loss)
        kernels.reset_launches()
        if fused:
            losses = torch.cat([step.run_fused(batches[:4]),
                                step.run_fused(batches[4:])])
        else:
            losses = torch.stack([step(*b) for b in batches])
        torch.cuda.synchronize()
        out.append((step, losses, kernels.launches()))
    (fs, fl, fla), (cs, cl, cla) = out
    assert torch.equal(fl, cl)
    _same_parameters(fs, cs)
    assert fla == cla and fla["softmax_ce_fwd"] == 8
    assert fs.optimizer._global_step == 8


def test_embedding_gradient_is_repeatable(hopper):
    """BERT's token-type lookups in float32, 8192 of one row: PyTorch's
    default CUDA embedding backward gave other bits in some of 300 runs
    on an H100; the port's ``nn.functional.embedding`` gives the same bits
    every time."""
    from paddle_tpu_torch.nn import functional as PF

    ids = torch.zeros(64, 128, dtype=torch.long, device=hopper)
    g = torch.randn(64, 128, 768, device=hopper,
                    generator=torch.Generator(device=hopper).manual_seed(0))
    first = None
    for _ in range(200):
        w = torch.zeros(2, 768, device=hopper, requires_grad=True)
        PF.embedding(ids, w).backward(g)
        if first is None:
            first = w.grad.clone()
        assert torch.equal(first, w.grad)
    assert not torch.are_deterministic_algorithms_enabled()


# -- decoding as one CUDA graph ----------------------------------------------


def test_generate_xla_graph_is_op_by_op_bitwise(hopper):
    """``GPT.generate_xla`` as one graph a signature, bfloat16 at prompt
    128: greedy and sampled (one seed) tokens are the op-by-op decode's
    bits on every call, 5 LayerNorm launches a token are counted for a
    replay, and a weight written in place between calls is honoured."""
    g = torch.Generator(device=hopper).manual_seed(0)
    m = gpt.GPT(gpt.GPTConfig(vocab_size=512, hidden=128, layers=2, heads=2,
                              max_seq=256, dropout=0.0, dtype="bfloat16"),
                generator=g).eval()
    # 8 rows a token step: the LayerNorm kernel's row multiple
    ids = torch.randint(0, 512, (8, 128), device=hopper, generator=g)

    def op_by_op(temperature, top_k):
        gen = None if temperature == 0.0 else \
            torch.Generator(device=hopper).manual_seed(3)
        with torch.no_grad():
            return m._traced_generate(ids, gen, max_new_tokens=8,
                                      temperature=temperature,
                                      top_k=top_k)[0]

    for temperature, top_k in ((0.0, None), (0.8, 5)):
        want = op_by_op(temperature, top_k)
        for _ in range(3):
            got = m.generate_xla(ids, 8, temperature=temperature,
                                 top_k=top_k, seed=3)
            assert torch.equal(got, want), temperature
    kernels.reset_launches()
    m.generate_xla(ids, 8)
    assert kernels.launches()["layer_norm_fwd"] == 5 * 8
    before = op_by_op(0.0, None)
    with torch.no_grad():
        m.wte.weight.mul_(-1.0)
    after = op_by_op(0.0, None)
    assert not torch.equal(after, before)
    assert torch.equal(m.generate_xla(ids, 8), after)
    assert len(m._xla_gen_cache) == 2


def test_beam_search_decode_xla_graph_is_op_by_op_bitwise(hopper):
    """``WMTTransformer.beam_search_decode_xla`` as one graph a
    signature, bfloat16: tokens and scores of every beam are the
    op-by-op decode's bits on every call, the LayerNorm launches of a
    replay are the encoder's 4 and 6 a step, and a weight written in
    place between calls is honoured."""
    from paddle_tpu_torch.models.nlp.transformer import WMTTransformer

    g = torch.Generator(device=hopper).manual_seed(0)
    m = WMTTransformer(300, 300, d_model=128, nhead=2, num_layers=2,
                       dim_feedforward=128, dropout=0.0, max_len=16,
                       generator=g).bfloat16().eval()
    src = torch.randint(2, 300, (4, 8), device=hopper, generator=g)
    kw = dict(beam_size=2, max_len=10, return_all=True)

    def op_by_op():
        with torch.no_grad():
            return m._traced_beam_decode(src, src_pad_id=None,
                                         length_penalty=0.6, **kw)

    want = op_by_op()
    for _ in range(3):
        got = m.beam_search_decode_xla(src, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    kernels.reset_launches()
    m.beam_search_decode_xla(src, **kw)
    assert kernels.launches()["layer_norm_fwd"] == 4 + 6 * 9
    with torch.no_grad():
        m.tgt_embed.weight.mul_(-1.0)
    after = op_by_op()
    assert not torch.equal(after[1], want[1])
    got = m.beam_search_decode_xla(src, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, after))
    assert len(m._xla_decode_cache) == 1


# -- ResNet: conv, pooling and BatchNorm -------------------------------------


def _resnet_backward(hopper, op):
    """A bfloat16 backward of one of ResNet-50's ops at a reduced batch:
    a function returning its gradients."""
    from paddle_tpu_torch.nn import functional as PF

    g = torch.Generator(device=hopper).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device=hopper, generator=g).to(
            torch.bfloat16).requires_grad_()

    if op == "conv":
        x, w = randn(16, 128, 56, 56), randn(128, 128, 3, 3)
        inputs = (x, w)
        out = PF.conv2d(x, w, stride=2, padding=1)
    elif op == "max_pool":
        x = torch.relu(randn(16, 64, 112, 112)).detach().requires_grad_()
        inputs = (x,)
        out = PF.max_pool2d(x, 3, 2, 1)
    else:
        x, w, b = randn(16, 64, 56, 56), randn(64), randn(64)
        inputs = (x, w, b)
        out = PF.batch_norm(x, torch.zeros(64, device=hopper),
                            torch.ones(64, device=hopper), w, b,
                            training=True)
    dy = torch.randn(out.shape, device=hopper, generator=g).to(out.dtype)
    return lambda: torch.autograd.grad(out, inputs, dy, retain_graph=True)


@pytest.mark.parametrize("op", ["conv", "max_pool", "batch_norm"])
def test_resnet_backwards_are_repeatable(hopper, op):
    """The conv's data and weight gradients (the 3 x 3 / 2 conv of
    ResNet-50's second stage, deterministic cuDNN), the max pool's on
    windows of tied zeros and BatchNorm's: the same bits in 20 runs."""
    bwd = _resnet_backward(hopper, op)
    first = [t.clone() for t in bwd()]
    for _ in range(19):
        assert all(torch.equal(a, b) for a, b in zip(first, bwd()))


def test_float32_conv_is_not_tf32(hopper):
    """With cuDNN's TF32 flag on, as PyTorch starts, the port's float32
    conv and its gradients are float32 ones: within 5e-5 of the largest
    entry of a float64 conv's (float32 sums of 576 and 6272 terms; seen
    1.3e-5), ten times closer than PyTorch's own conv under that flag
    (TF32 keeps 10 bits of each input), and the flag is as it was after
    the call."""
    from paddle_tpu_torch.nn import functional as PF

    g = torch.Generator(device=hopper).manual_seed(0)
    x = torch.randn(8, 64, 28, 28, device=hopper, generator=g)
    w = torch.randn(64, 64, 3, 3, device=hopper, generator=g) * 0.05
    dy = torch.randn(8, 64, 28, 28, device=hopper, generator=g)
    def run(conv, dtype):
        xs = x.to(dtype, copy=True).requires_grad_()
        ws = w.to(dtype, copy=True).requires_grad_()
        out = conv(xs, ws, padding=1)
        out.backward(dy.to(dtype))
        return out, xs.grad, ws.grad

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        port = run(PF.conv2d, torch.float32)
        assert torch.backends.cudnn.allow_tf32
        tf32 = run(torch.nn.functional.conv2d, torch.float32)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    ref = run(torch.nn.functional.conv2d, torch.float64)
    for got, lib, want in zip(port, tf32, ref):
        err, lib_err = ((t.double() - want).abs().max() / want.abs().max()
                        for t in (got, lib))
        assert err < 5e-5 and 10 * err < lib_err, (err.item(),
                                                   lib_err.item())


def test_graphed_tiny_resnet_step_is_the_eager_step(hopper):
    """A bfloat16 ResNet (Bottleneck, [1, 1, 1, 1], width 16) under
    Momentum with multi_precision: three graphed calls (op by op,
    captured, replayed) end at the eager run's bits, BatchNorm buffers,
    velocities and masters included, and launch none of the port's
    kernels."""
    from paddle_tpu_torch.models.vision import resnet

    rng = np.random.RandomState(0)
    x = rng.randn(8, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, (8,)).astype(np.int32)

    def loss_fn(m, x, y):
        from paddle_tpu_torch.nn import functional as PF

        return PF.cross_entropy(m(x.to(torch.bfloat16)).float(), y)

    runs = []
    for graphed in (True, False):
        m = resnet.ResNet(resnet.BottleneckBlock, [1, 1, 1, 1], width=16,
                          num_classes=10, device=hopper,
                          generator=torch.Generator(
                              device=hopper).manual_seed(0)).bfloat16()
        opt = optim.Momentum(0.1, 0.9, parameters=m.named_parameters(),
                             multi_precision=True)
        step = TrainStep(m, opt, loss_fn)
        kernels.reset_launches()
        fn = step if graphed else step._eager_step
        losses = torch.stack([fn(x, y) for _ in range(3)])
        torch.cuda.synchronize()
        assert set(kernels.launches().values()) == {0}
        runs.append((losses, dict(m.named_parameters()),
                     dict(m.named_buffers()), opt._accumulators))
    (gl, gp, gb, gs), (el, ep, eb, es) = runs
    assert torch.equal(gl, el)
    for n in gp:
        assert torch.equal(gp[n], ep[n]), n
    for n in gb:
        assert torch.equal(gb[n], eb[n]), n
    for n in gs:
        for k in gs[n]:
            assert torch.equal(gs[n][k], es[n][k]), (n, k)


def test_in_place_load_keeps_the_graph(hopper, tmp_path):
    """A bfloat16 tiny GPT with masters and a step-decay scheduler: 5
    calls (op by op, captured, replays), a checkpoint after the third
    loaded back into the same model, optimizer and scheduler: calls 4-5
    replay the SAME graph and give the first run's losses bitwise."""
    from paddle_tpu_torch.framework import load_checkpoint, save_checkpoint

    m = _tiny_gpt(hopper, 0.0).bfloat16()
    sched = optim.lr.StepDecay(1e-3, step_size=2)
    opt = _adamw(m, sched, multi_precision=True)
    step = TrainStep(m, opt, gpt.gpt_loss)
    losses = []
    for i in range(5):
        losses.append(step(*_ids(i)))
        sched.step()
        if i == 2:
            save_checkpoint(str(tmp_path), 3, m, opt, sched)
    (graph,) = step._graphs.values()
    assert step.captures == 1 and graph is not None
    assert load_checkpoint(str(tmp_path), m, opt, sched) == 3
    assert opt._global_step == 3 and sched.last_epoch == 3
    again = []
    for i in range(3, 5):
        again.append(step(*_ids(i)))
        sched.step()
    assert step.captures == 1 and list(step._graphs.values()) == [graph]
    assert torch.equal(torch.stack(again), torch.stack(losses[3:]))


def test_async_snapshot_is_complete_when_save_returns(hopper, tmp_path):
    """Every device-to-host copy has finished when ``save_checkpoint(
    async_=True)`` returns: the state overwritten right after it still
    saves as it was."""
    from paddle_tpu_torch.framework import load, save_checkpoint

    m = _tiny_gpt(hopper, 0.0).bfloat16()
    opt = _adamw(m, multi_precision=True)
    step = TrainStep(m, opt, gpt.gpt_loss)
    for i in range(3):
        step(*_ids(i))
    want = {n: p.detach().clone() for n, p in m.named_parameters()}
    slots = {f"{n}.{k}": v.clone() for n, s in opt._accumulators.items()
             for k, v in s.items()}
    h = save_checkpoint(str(tmp_path), 3, m, opt, async_=True)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(1.0)
        for s in opt._accumulators.values():
            for v in s.values():
                v.fill_(-7.0)
    path = h.result(timeout=120)
    model = load(f"{path}/model.pdparams")
    state = load(f"{path}/opt.pdopt")
    for n, t in want.items():
        assert torch.equal(torch.as_tensor(model[n]).to(hopper), t), n
    for k, t in slots.items():
        assert torch.equal(torch.as_tensor(state[k]).to(hopper), t), k


def test_guarded_skip_replays_one_graph(hopper):
    """``GuardedStep(skip_step)`` over the graphed step with a NaN batch
    item at call 3: the other calls equal a run that never saw it,
    bitwise, with one graph captured."""
    from paddle_tpu_torch.resilience import (GuardedStep, RecoveryPolicy,
                                             inject)

    def loss_fn(model, ids, labels, scale):
        return gpt.gpt_loss(model, ids, labels) * scale

    batches = [_ids(i) + (np.ones((), np.float32),) for i in range(6)]
    runs = []
    for guarded in (True, False):
        m = _tiny_gpt(hopper, 0.0).bfloat16()
        step = TrainStep(m, _adamw(m, multi_precision=True), loss_fn,
                         check_nan=True)
        if guarded:
            g = GuardedStep(step, RecoveryPolicy(on_nonfinite="skip_step"))
            with inject.chaos("nan_feed", at=3, var=2):
                losses = [g(*b) for b in batches]
            assert losses[2] is None and g.stats.skipped == 1
            losses = [x for x in losses if x is not None]
        else:
            losses = [step(*b) for i, b in enumerate(batches) if i != 2]
        assert step.captures == 1 and len(step._graphs) == 1
        runs.append((torch.stack(losses), dict(m.named_parameters()),
                     step.optimizer))
    (gl, gp, go), (el, ep, eo) = runs
    assert torch.equal(gl, el) and go._global_step == eo._global_step == 5
    for n in gp:
        assert torch.equal(gp[n], ep[n]), n
