"""``chip_smoke.py``'s cross-entropy checks reject planted faults.

The smoke holds each kernel to its plain version on the card; these
tests hold its checks themselves, on the CPU, with the plain versions
standing in for the kernels. dlogits is ``(p - onehot) * g``, and most
of its entries are ~g/V (about 6e-6 at V = 50304), so the check bounds
each entry by the magnitudes of its own terms: a kernel that wrote 0 off
the label column, or worked from an lse off by 1%, must fail it, and an
honest result (the same function evaluated in float64, then rounded)
must pass.

The flash checks (``flash_close``) get the same treatment, and the
arithmetic of the bfloat16 tensor-core flash kernels (forward, dQ and
dK/dV) is emulated here against them: P and dS split into two bfloat16
halves pass, P and dS rounded once fail. So do the decode phase's
checks: a greedy token off a clear argmax fails ``greedy_agree``, and a
beam search made to take another's decisions (``Decisions``) fails
when one token's logit is off by more than its value limit. And the
ResNet phase's checks: its float32 reference forward
(``resnet_reference_forward``) is the port's model, and the value
check and the stem BatchNorm check, run on the CPU at a small width,
pass an honest model and fail the two faults
``tools/torch_planted_faults.py`` plants on the card (conv weights read
transposed, a BatchNorm momentum taken as 1 - m) and a conv padded
unevenly (the output's shape kept, its windows shifted). And the int8
phase's: an int8 bundle with one weight's scales doubled fails both the
bundle check and ``INT8_PROB_TOL``. And the mixed-precision phase's
(21): ``fp16_close`` passes an honest float16 result and fails planted
faults (a zeroed gradient, an inf where the plain version is finite);
the float16 tensor-core kernels' arithmetic, emulated, passes it with
dS fitted to float16's range by a power of two a row before its split
(``fit_rows``), and fails it without the fit once dO carries a loss
scale of 2^14 (the split halves turn to inf where the plain float32 dS
is finite); ``scaler_rule`` is ``DynamicLossScaler()``'s state machine,
and a scaler that shrinks by 0.8 instead of 0.5 fails it; ``Tally``
passes the kernels' launch counts through. And the rare optimizers'
phase (22): ``rule_value_check`` passes each honest rule on the CPU
(seen: 3.3e-6 of the update at most, limit ``RULE_TOL`` 1e-4) and fails
LarsMomentum planted without its decay term, the fault
``tools/torch_planted_faults.py --rare`` plants on the card. And the
user surface's phase (25): its configuration is bench_gpt's model and
it expects bench_gpt's launches, and the Paddle script reaches the
LayerNorm, flash-attention and cross-entropy wrappers as often as it
expects the card to launch them.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke as cs
from paddle_tpu_torch.ops.kernels import KERNELS
from paddle_tpu_torch.ops.kernels import softmax_ce as ce

from torch_test_threads import torch_threads  # noqa: F401,E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _case(N, V, scale, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(N, V, generator=g) * scale).to(dtype)
    lab = torch.randint(0, V, (N,), generator=g)
    lab[::5] = -100
    gl = torch.rand(N, generator=g)
    _, lse = ce.softmax_ce_fwd_reference(x, lab)
    return x, lab, gl, lse


@pytest.mark.parametrize("dtype, tol", [(torch.float32, cs.TRAIN_F32_TOL),
                                        (torch.bfloat16, cs.BF16_TOL)])
@pytest.mark.parametrize("N, V, scale", [(16, 50304, 1.0), (16, 1000, 3.0),
                                         (16, 4096, 1e3)])
def test_dlogits_check_rejects_planted_faults(N, V, scale, dtype, tol):
    x, lab, gl, lse = _case(N, V, scale, dtype, seed=N + V)
    ref = ce.softmax_ce_bwd_reference(x, lab, lse, gl)
    scale_t = cs.ce_bwd_scale(x, lab, lse, gl)

    honest = ce.softmax_ce_bwd_reference(x.double(), lab, lse.double(),
                                         gl.double()).to(dtype)
    assert cs.within(honest, ref, tol, scale_t)[0]

    rows = torch.arange(N)
    picked = lab.clamp(min=0)
    zero_off_label = torch.zeros_like(ref)
    zero_off_label[rows, picked] = ref[rows, picked]
    assert not cs.within(zero_off_label, ref, tol, scale_t)[0]

    from_bad_lse = ce.softmax_ce_bwd_reference(x, lab, lse * 1.01, gl)
    assert not cs.within(from_bad_lse, ref, tol, scale_t)[0]


def test_lse_check_rejects_one_percent():
    x, lab, _, lse = _case(16, 50304, 1.0, torch.float32, seed=3)
    assert cs.within(lse.clone(), lse, cs.TRAIN_F32_TOL)[0]
    assert not cs.within(lse * 1.01, lse, cs.TRAIN_F32_TOL)[0]


# -- flash attention ----------------------------------------------------------


def _flash_f64(q, k, v, do, lse, delta, causal, scale):
    """An honest flash attention: the same function in float64 (the
    backward from the given lse and delta, as a kernel gets them)."""
    s = torch.matmul(q.double() * scale, k.double().transpose(-1, -2))
    if causal:
        Lq, Lk = s.shape[-2:]
        s = s.masked_fill(~torch.ones(Lq, Lk, dtype=torch.bool)
                          .tril(Lk - Lq), -1e30)
    B, H, Lq, _ = q.shape
    o = torch.matmul(torch.softmax(s, -1), v.double())
    lse_o = torch.logsumexp(s, -1).reshape(B * H, Lq, 1)
    p = torch.exp(s - lse.double().reshape(B, H, Lq, 1))
    dp = torch.matmul(do.double(), v.double().transpose(-1, -2))
    ds = p * (dp - delta.double().reshape(B, H, Lq, 1))
    dq = torch.matmul(ds, k.double()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.double() * scale)
    dv = torch.matmul(p.transpose(-1, -2), do.double())
    return o, lse_o, dq, dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq, Lk, causal", [(128, 128, True),
                                            (64, 192, True),
                                            (128, 128, False)])
def test_flash_check_rejects_planted_faults(Lq, Lk, causal, dtype):
    """``flash_close`` passes the same function computed in float64 and
    rounded, and fails zeroed dV, a dQ without its scale, an O computed
    without the causal mask (or, non-causal, with one) and an lse off by
    1e-4."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator().manual_seed(Lq + Lk)
    q, k, v, do = (torch.randn(1, 2, L, 64, generator=g).to(dtype)
                   for L in (Lq, Lk, Lk, Lq))
    scale = 0.125
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    args = (q, k, v, do, lse, fa.flash_delta(o, do), causal, scale)
    dq = fa.flash_attention_bwd_dq_reference(*args)
    dk, dv = fa.flash_attention_bwd_dkv_reference(*args)
    refs = {"O": o, "lse": lse, "dQ": dq, "dK": dk, "dV": dv}
    honest = dict(zip(refs, _flash_f64(*args)))
    for name, ref in refs.items():
        out = honest[name].to(ref.dtype)
        assert cs.flash_close(out, ref, name.startswith("d"))[0], name

    assert not cs.flash_close(torch.zeros_like(dv), dv, True)[0]
    assert not cs.flash_close((dq.float() / scale).to(dtype), dq, True)[0]
    wrong_mask, _ = fa.flash_attention_fwd_reference(q, k, v, not causal,
                                                     scale)
    assert not cs.flash_close(wrong_mask, o, False)[0]
    assert not cs.flash_close(lse * (1 + 1e-4), lse, False)[0]


def _tc_scores(q, k, causal, scale):
    """S as the tensor-core kernels form it: bfloat16 q and k as stored,
    float32 sums, the scale applied to the float32 product."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        Lq, Lk = s.shape[-2:]
        visible = torch.ones(Lq, Lk, dtype=torch.bool).tril(Lk - Lq)
        s = s + torch.where(visible, 0.0, -1e30)
    return s


def _tc_operand(x, split):
    """The bfloat16 A operand(s) a float32 ``x`` becomes: hi =
    bf16(x) and lo = bf16(x - hi) when ``split``, else hi alone."""
    hi = x.to(torch.bfloat16).float()
    return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)


def _tc_product(x, b, split):
    """``x b`` with ``x`` through ``_tc_operand``: one float32
    accumulator for every half."""
    return sum(torch.matmul(a, b.float()) for a in _tc_operand(x, split))


def _tc_emulation(q, k, v, do, lse, delta, causal, scale, split):
    """O, dK, dV and dQ as the bfloat16 forward, dK/dV and dQ kernels
    compute them (``csrc/flash_attention.cu``), with P and dS split in two
    bfloat16 halves or rounded once."""
    B, H, Lq, _ = q.shape
    s = _tc_scores(q, k, causal, scale)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = _tc_product(p, v, split) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    p = torch.exp(s - lse.reshape(B, H, Lq, 1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta.reshape(B, H, Lq, 1))
    dv = _tc_product(p.transpose(-1, -2), do, split)
    dk = _tc_product(ds.transpose(-1, -2), q, split) * scale
    dq = _tc_product(ds, k, split) * scale
    return o.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dq.to(q.dtype)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Lq, Lk", [(128, 128), (64, 192), (1024, 1024)])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_arithmetic_needs_p_and_ds_in_two_halves(causal, Lq, Lk,
                                                             D):
    """The tensor-core kernels' arithmetic, emulated in torch: bfloat16
    q, k, v and dO, float32 sums, the scale after the product, and P and
    dS split into hi + lo bfloat16 halves, passes ``flash_close`` against
    the plain versions for O, dK, dV and dQ. The same arithmetic with P
    and dS rounded once to bfloat16 fails it on each of the four."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator().manual_seed(Lq + Lk + D)
    q, k, v, do = (torch.randn(1, 2, L, D, generator=g).to(torch.bfloat16)
                   for L in (Lq, Lk, Lk, Lq))
    scale = D ** -0.5
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    args = (q, k, v, do, lse, fa.flash_delta(o, do), causal, scale)
    refs = (o, *fa.flash_attention_bwd_dkv_reference(*args),
            fa.flash_attention_bwd_dq_reference(*args))
    split = _tc_emulation(*args, split=True)
    once = _tc_emulation(*args, split=False)
    for name, ref, two, one in zip(("O", "dK", "dV", "dQ"), refs, split,
                                   once):
        grad = name != "O"
        assert cs.flash_close(two, ref, grad)[0], name
        assert not cs.flash_close(one, ref, grad)[0], name


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_each_wrapper_names_the_pallas_kernel_it_replaces(name):
    """The smoke's JSON line takes ``replaces`` from the wrapper: the
    ``file:line`` in the JAX package where a kernel function of a file
    that calls ``pl.pallas_call`` is defined, used there, and named by no
    other wrapper."""
    site = getattr(KERNELS[name], name).replaces
    path, line = site.split(":")
    src = (ROOT / path).read_text().splitlines()
    fn = re.match(r"def (_\w*kernel)\(", src[int(line) - 1])
    assert fn, src[int(line) - 1]
    uses = [s for s in src if re.search(rf"\b{fn.group(1)}\b", s)]
    assert len(uses) >= 2 and any("pl.pallas_call(" in s for s in src)
    others = [n for n in KERNELS
              if n != name and getattr(KERNELS[n], n).replaces == site]
    assert not others, others


# -- the decode phase's checks -----------------------------------------------


def test_greedy_check_rejects_a_token_off_a_clear_argmax():
    """``greedy_agree``: the argmax passes; a token that is not the
    argmax where the top two are more than GPT_MARGIN apart fails; one
    where they are closer passes."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 6, 50, generator=g)
    toks = logits.argmax(dim=-1)
    cs.greedy_agree("honest", toks, logits)
    top = logits.topk(2, dim=-1)
    gap = top.values[..., 0] - top.values[..., 1]
    b, t = divmod(int(gap.flatten().argmax()), 6)
    bad = toks.clone()
    bad[b, t] = top.indices[b, t, 1]
    with pytest.raises(cs.CheckFailed):
        cs.greedy_agree("planted", bad, logits)
    close = logits.clone()
    close[b, t, top.indices[b, t, 1]] = top.values[b, t, 0] - \
        cs.GPT_MARGIN / 2
    cs.greedy_agree("near tie", bad, close)


def _toy_beam(table, forced=None):
    """``beam_search_xla`` over a stateless toy model (logits indexed by
    step and last token) under ``Decisions``."""
    from paddle_tpu_torch.inference import decoder

    def step(tok, state, t):
        return table[t][tok[:, 0]], state

    with cs.Decisions(forced=forced) as d:
        toks, scores = decoder.beam_search_xla(step, None, 3, 0, 1, 4, 8,
                                               device="cpu")
    return d, toks, scores


def test_beam_decision_check_rejects_planted_faults():
    """``Decisions``: a run made to take another's decisions passes when
    its logits differ by well under the limits, and fails when one
    token's logit is off by more than WMT_VALUE_TOL."""
    g = torch.Generator().manual_seed(1)
    table = torch.randn(7, 16, 16, generator=g) * 20
    made, toks, scores = _toy_beam(table)
    noise = (torch.rand(table.shape, generator=g) - 0.5) * 0.1
    honest, htoks, _ = _toy_beam(table + noise, forced=made)
    held, same, total, drift, _ = honest.agree("honest")
    assert torch.equal(htoks, toks) and drift < cs.WMT_VALUE_TOL
    assert total == 8 * 3 and same >= held      # (7 steps + the order) x 3
    chosen = int(toks[0, 1])
    bad = table.clone()
    bad[:, :, chosen] -= 3 * cs.WMT_VALUE_TOL
    planted, _, _ = _toy_beam(bad, forced=made)
    with pytest.raises(cs.CheckFailed):
        planted.agree("planted")


def _tiny_resnet(dtype=torch.float32):
    from paddle_tpu_torch.models.vision import resnet

    m = resnet.ResNet(resnet.BottleneckBlock, [1, 1, 1, 1], width=8,
                      num_classes=10, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    m = m.to(dtype)
    init = {k: v.clone() for k, v in m.state_dict().items()}
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 3, 64, 64, generator=g).numpy()
    y = torch.randint(0, 10, (4,), generator=g).int().numpy()
    return m, init, (x, y)


def test_resnet_reference_forward_is_the_port_model():
    m, init, (x, y) = _tiny_resnet()
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    want = cs.resnet_reference_forward(init, torch.from_numpy(x))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _planted(monkeypatch, fault):
    from paddle_tpu_torch.nn import functional as F

    if fault == "transposed conv weight":
        real = F.conv2d
        monkeypatch.setattr(F, "conv2d", lambda x, w, *a, **k: real(
            x, torch.transpose(w, 2, 3), *a, **k))
    elif fault == "uneven conv padding":
        real = F.conv2d

        def shifted(x, w, *a, padding=0, **k):
            # the same output shape, the window shifted by one
            p = padding if w.shape[-1] == 1 else [0, 2 * padding, 0,
                                                   2 * padding]
            return real(x, w, *a, padding=p, **k)
        monkeypatch.setattr(F, "conv2d", shifted)
    elif fault == "batch norm momentum 1 - m":
        real = F.batch_norm
        monkeypatch.setattr(F, "batch_norm", lambda *a, momentum=0.9, **k:
                            real(*a, momentum=1 - momentum, **k))


@pytest.mark.parametrize("fault", [None, "transposed conv weight",
                                   "uneven conv padding",
                                   "batch norm momentum 1 - m"])
def test_resnet_checks_reject_planted_faults(monkeypatch, fault):
    m, init, batch = _tiny_resnet(torch.bfloat16)
    _planted(monkeypatch, fault)
    value_fails = fault in ("transposed conv weight", "uneven conv padding")
    if value_fails:
        with pytest.raises(cs.CheckFailed, match="differs from a float32 "
                           "conv of its input"):
            cs.resnet_value_check(m, init, batch)
    else:
        cs.resnet_value_check(m, init, batch)
    # the statistics a step's forward leaves (the wrong conv moves them too)
    with torch.no_grad():
        m.load_state_dict(init)
        m(torch.from_numpy(batch[0]).to(torch.bfloat16))
    if fault is None:
        assert cs.stem_bn_check(m, init, batch[0]) <= 2 ** -7
    else:
        with pytest.raises(cs.CheckFailed, match="stem BatchNorm"):
            cs.stem_bn_check(m, init, batch[0])


def test_int8_checks_reject_a_scale_off_by_two(tmp_path):
    """Phase 20's int8 checks on the CPU, at bench's B = 256: the honest
    bundle passes ``int8_bundle_check`` and its ``max_prob_diff`` stays
    under ``INT8_PROB_TOL``; each weight's scales doubled in turn fail
    both."""
    prefix, _, _, _, quantized = cs.int8_bundles(str(tmp_path), "cpu")
    cs.int8_bundle_check(prefix, quantized)
    x = np.random.RandomState(0).randn(cs.INT8_BATCH, 1, 28, 28).astype(
        "float32")
    _, o32 = cs.int8_predict(prefix, x, "cpu")
    _, o8 = cs.int8_predict(prefix + "_int8", x, "cpu")
    assert cs.max_prob_diff(o32, o8) < cs.INT8_PROB_TOL
    honest = dict(np.load(prefix + "_int8.pdiparams.npz"))
    assert len(quantized) == 4
    for name in quantized:
        planted = dict(honest)
        planted["s!" + name] = planted["s!" + name] * 2
        np.savez(prefix + "_int8.pdiparams", **planted)
        with pytest.raises(cs.CheckFailed, match=name):
            cs.int8_bundle_check(prefix, quantized)
        _, bad = cs.int8_predict(prefix + "_int8", x, "cpu")
        assert cs.max_prob_diff(o32, bad) > cs.INT8_PROB_TOL, name


# -- the mixed-precision phase's checks (21) ---------------------------------


def _f16_case(Lq, Lk, causal, do_mul, seed):
    """Float16 flash inputs; with ``do_mul`` > 1, dO at that multiple of
    its usual scale (|dO| <= 3.5 do_mul) and q three times as large (P
    peaked on a few keys), so that the plain float32 dS passes 65504 at
    these small shapes too (on the card the path's shape does it at
    2^13 unpeaked)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(1, 8, L, 64, generator=g)
                   for L in (Lq, Lk, Lk, Lq))
    if do_mul > 1:
        q = q * 3
    q, k, v = q.half(), k.half(), v.half()
    do = (do.clamp(-3.5, 3.5) * do_mul).half()
    scale = 0.125
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    return (q, k, v, do, lse, fa.flash_delta(o, do), causal, scale), o


def _f16_operand(x, fit):
    """float16 hi and lo halves of a float32 ``x`` (rows on the last
    axis but one... each row of the last axis), after ``fit_rows``'s
    power of two a row when ``fit``: returns the halves and the row
    scale to undo."""
    mul = torch.ones(x.shape[:-1] + (1,))
    if fit:
        m = x.abs().amax(-1, keepdim=True)
        e = torch.where(m > 0, torch.floor(torch.log2(m)),
                        torch.full_like(m, -112.0)).clamp(-112, 127)
        mul = torch.exp2(14 - e)
    y = x * mul
    hi = y.half().float()
    return (hi, (y - hi).half().float()), mul


def _f16_emulation(q, k, v, do, lse, delta, causal, scale, fit):
    """dQ, dK and dV as the float16 dQ and dK/dV kernels compute them:
    float16 operands as stored, float32 sums, dS in two float16 halves
    (after the row fit when ``fit``), the fit undone in float32."""
    B, H, Lq, _ = q.shape
    s = _tc_scores(q, k, causal, scale)
    p = torch.exp(s - lse.reshape(B, H, Lq, 1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta.reshape(B, H, Lq, 1))
    halves, mul = _f16_operand(ds, fit)
    dq = sum(torch.matmul(h, k.float()) for h in halves) / mul * scale
    halves, mul = _f16_operand(ds.transpose(-1, -2), fit)
    dk = sum(torch.matmul(h, q.float()) for h in halves) / mul * scale
    halves, _ = _f16_operand(p.transpose(-1, -2), False)
    dv = sum(torch.matmul(h, do.float()) for h in halves)
    return dq.half(), dk.half(), dv.half()


@pytest.mark.parametrize("causal", [True, False])
def test_fp16_close_rejects_planted_faults(causal):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    args, o = _f16_case(128, 128, causal, 1.0, 7)
    dq = fa.flash_attention_bwd_dq_reference(*args)
    dk, dv = fa.flash_attention_bwd_dkv_reference(*args)
    honest = dict(zip(("O", "lse", "dQ", "dK", "dV"), _flash_f64(*args)))
    for name, ref in (("O", o), ("dQ", dq), ("dK", dk), ("dV", dv)):
        assert cs.fp16_close(honest[name].half(), ref, name != "O")[0], name
    assert not cs.fp16_close(torch.zeros_like(dv), dv, True)[0]
    bad = dq.clone()
    bad.view(-1)[3] = float("inf")
    assert not cs.fp16_close(bad, dq, True)[0]
    # an inf where the plain version has one is not compared
    assert cs.fp16_close(bad, bad, True)[0]


@pytest.mark.parametrize("Lq, Lk, causal", [(128, 128, True),
                                            (128, 256, True),
                                            (256, 256, False)])
def test_fp16_backward_needs_ds_fitted_to_float16(Lq, Lk, causal):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    for do_mul in (1.0, 2.0 ** 14):
        args, _ = _f16_case(Lq, Lk, causal, do_mul, Lq + Lk)
        refs = (fa.flash_attention_bwd_dq_reference(*args),
                *fa.flash_attention_bwd_dkv_reference(*args))
        fitted = _f16_emulation(*args, fit=True)
        for name, ref, out in zip(("dQ", "dK", "dV"), refs, fitted):
            assert cs.fp16_close(out, ref, True)[0], (name, do_mul)
        if do_mul == 1.0:
            continue
        _, ds = fa._p_ds(*args)
        assert ds.abs().max() > 65504
        raw = _f16_emulation(*args, fit=False)
        assert not all(cs.fp16_close(out, ref, True)[0]
                       for out, ref in zip(raw[:2], refs[:2]))


def test_scaler_rule_is_the_dynamic_scalers():
    from paddle_tpu_torch import amp

    sc = amp.DynamicLossScaler()
    state = sc.state("cpu")
    flags = [False, True, True, False, False, True, False]
    for i in range(len(flags)):
        state = sc.update_state(state, torch.tensor(flags[i]))
        assert {k: v.item() for k, v in state.items()} == \
            cs.scaler_rule(flags[:i + 1])
    slow = amp.DynamicLossScaler(decr_ratio=0.8)
    s2 = slow.update_state(slow.state("cpu"), torch.tensor(True))
    assert s2["scale"].item() != cs.scaler_rule([True])["scale"]


def test_tally_passes_the_launch_counts_through():
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import layernorm as ln

    kernels.reset_launches()
    with cs.dtype_tally() as counts:
        assert isinstance(ln.layer_norm_fwd, cs.Tally)
        ln.layer_norm_fwd.launches += 2
        assert kernels.launches()["layer_norm_fwd"] == 2
        x = torch.randn(8, 128)
        ln.layer_norm_fwd(x, torch.ones(128), torch.zeros(128))
        kernels.reset_launches()
    assert not isinstance(ln.layer_norm_fwd, cs.Tally)
    assert ln.layer_norm_fwd.launches == 0 and not counts


@pytest.mark.parametrize("kind", cs.RARE_RULES)
def test_rule_value_check_passes_each_honest_rule(kind):
    assert cs.rule_value_check(kind, device="cpu") <= cs.RULE_TOL


def test_rule_value_check_rejects_lars_without_its_decay_term(monkeypatch):
    import importlib.util

    from paddle_tpu_torch.optim import LarsMomentum

    spec = importlib.util.spec_from_file_location(
        "torch_planted_faults", ROOT / "tools" / "torch_planted_faults.py")
    faults = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(faults)
    monkeypatch.setattr(LarsMomentum, "_update",
                        faults._lars_without_decay(LarsMomentum._update))
    with pytest.raises(cs.CheckFailed, match="plain formula"):
        cs.rule_value_check("lars_momentum", device="cpu")


# -- phase 24: the tensor API ---------------------------------------------------

def _scatter_keeps_the_first(real):
    """``_scatter`` (``real``) whose repeated index keeps its FIRST
    write."""
    def scatter(x, lin, vals, how):
        if how != "set":
            return real(x, lin, vals, how)
        lin, vals = lin.reshape(-1), vals.to(x.dtype).reshape(-1)
        keep = torch.tensor([not bool((lin[:i] == lin[i]).any())
                             for i in range(lin.numel())])
        return real(x, lin[keep], vals[keep], how)

    return scatter


def _stale_read():
    """``control_flow._read`` that reads its first predicate and then keeps
    that value: the branch a stale capture would replay."""
    from paddle_tpu_torch.ops import control_flow

    real, first = control_flow._read, []

    def read(v, op):
        if not first:
            first.append(real(v, op))
        return first[0]

    return read


@pytest.mark.parametrize("fault", ["scatter_first", "argsort_torch",
                                   "cond_stale"])
def test_phase_24_checks_reject_planted_faults(monkeypatch, fault):
    """Phase 24's checks on the CPU pass as they are, and each fails with
    its fault planted: a ``scatter`` whose repeated index keeps the first
    write, a descending ``argsort`` that is torch's stable descending
    sort (not the ascending one reversed), and a ``cond`` that keeps the
    branch of its first read."""
    from paddle_tpu_torch.ops import control_flow, manipulation

    cs.tensor_trap_check("cpu")
    cs.control_flow_check("cpu", device="cpu")
    if fault == "scatter_first":
        monkeypatch.setattr(manipulation, "_scatter",
                            _scatter_keeps_the_first(manipulation._scatter))
        with pytest.raises(cs.CheckFailed, match="scatter"):
            cs.tensor_trap_check("cpu")
    elif fault == "argsort_torch":
        monkeypatch.setitem(
            manipulation._argsort.__wrapped__.__globals__, "torch",
            _TorchStableDescending())
        with pytest.raises(cs.CheckFailed, match="argsort"):
            cs.tensor_trap_check("cpu")
    else:
        monkeypatch.setattr(control_flow, "_read", _stale_read())
        with pytest.raises(cs.CheckFailed, match="branch its flag"):
            cs.control_flow_check("cpu", device="cpu")


class _TorchStableDescending:
    """``torch`` for ``manipulation``'s sorts with ``torch.sort`` taking a
    descending flag: the planted ``argsort`` sorts descending, stably, and
    ``flip`` leaves its result as it is."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def sort(x, dim=-1, stable=True, descending=False):
        return torch.sort(x, dim=dim, stable=True, descending=True)

    @staticmethod
    def flip(x, dims):
        return x


def test_phase_24_tensor_check_runs_on_the_cpu():
    """Phase 24(c) dry-run with the CPU in the card's place: every name of
    the tensor API has a case, and none moves its bits or syncs here."""
    moving, syncing = cs.tensor_card_check("cpu", device="cpu")
    assert moving == [] and syncing == []


# -- phase 25: the Paddle script of tools/paddle_gpt_script.py ---------------


def test_phase_25_expects_bench_gpts_launches_at_bench_gpts_widths():
    """The script's configuration is bench_gpt's model, and phase 25
    expects a step to launch what phase 10's bench_gpt step launches
    (25/25/1/1/12/12/12), a forward 25 LayerNorm and 12 flash forwards."""
    from paddle_tpu_torch.models.nlp import gpt

    S = cs.surface_script()
    cfg, ref = S.CONFIGS[cs.SURFACE_CONFIG], gpt.gpt_small()
    assert (cfg["vocab"], cfg["hidden"], cfg["layers"], cfg["heads"],
            cfg["max_len"], cfg["seq"]) == (ref.vocab_size, ref.hidden,
                                             ref.layers, ref.heads,
                                             ref.max_seq, ref.max_seq)
    assert cfg["batch"] == cs.TRAIN_CONFIGS["bench_gpt"]["batch"]
    assert cfg["dtype"] == "bfloat16"
    assert cs.surface_launches(cfg, 4) == \
        cs.train_launches("bench_gpt", ref, 4)
    fwd = cs.surface_launches(cfg, forward_only=True)
    assert {k: v for k, v in fwd.items() if v} == {
        "layer_norm_fwd": 25, "flash_attention_fwd": 12}


def test_phase_25_script_reaches_every_kernel_wrapper(monkeypatch):
    """At a width that passes the kernels' gates (L 128, head 64, vocab a
    multiple of 128), one step of the script on the CPU goes through the
    LayerNorm, flash-attention and cross-entropy wrappers as often as
    ``surface_launches`` says the card launches them."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn.functional import attention, loss
    from paddle_tpu_torch.ops import norm_ops

    calls = {"layer_norm_fwd": 0, "flash_attention_fwd": 0,
             "softmax_ce_fwd": 0}

    def counted(mod, attr, name):
        real = getattr(mod, attr)

        def wrapper(*a, **k):
            calls[name] += 1
            return real(*a, **k)

        monkeypatch.setattr(mod, attr, wrapper)

    counted(norm_ops, "fused_layer_norm", "layer_norm_fwd")
    counted(attention, "flash_attention", "flash_attention_fwd")
    counted(loss, "softmax_cross_entropy", "softmax_ce_fwd")
    S = cs.surface_script()
    cfg = S.CONFIGS["tiny"]
    place = pt._device.CURRENT[0]
    pt.set_device("cpu")
    try:
        model = S.make_model(pt, cfg)
        losses, _ = S.train(pt, model, S.batches(cfg, 1), cfg)
    finally:
        pt._device.CURRENT[0] = place
    want = cs.surface_launches(cfg)
    assert calls == {k: want[k] for k in calls}, calls
    assert np.isfinite(losses[0]) and abs(losses[0] - np.log(256)) < 0.5


# -- phase 27: the Paddle Tensor's methods ------------------------------------


def test_phase_27_methods_check_runs_on_the_cpu():
    """Phase 27(c) dry-run with the CPU in the card's place: every name of
    the method table has a case that calls it as a method, and none moves
    its bits here."""
    assert cs.methods_card_check("cpu", device="cpu") == []


def test_phase_27_method_form_is_phase_25s_script_bitwise():
    """Phase 27(a) holds the method form's losses to phase 25's bits: on
    the CPU, from the same weights, the two forms give the same losses
    and make the same state names."""
    import paddle_tpu_torch as pt

    S = cs.surface_script()
    M = cs._MethodForm(S)
    cfg = dict(S.CONFIGS["tiny"], layers=1)
    data = S.batches(cfg, 2)
    place = pt._device.CURRENT[0]
    pt.set_device("cpu")
    try:
        func, meth = S.make_model(pt, cfg), M.make_model(pt, cfg)
        assert list(func.state_dict()) == list(meth.state_dict())
        meth.set_state_dict(func.state_dict())
        want, _ = S.train(pt, func, data, cfg)
        got, _ = M.train(pt, meth, data, cfg)
    finally:
        pt._device.CURRENT[0] = place
    assert got == want


# -- phase 26: VGG and MobileNet V1/V2, the op library's rest ----------------

# phase 26(b)'s channels-last shapes, cut for the CPU: a plain conv, a
# depthwise one and a pointwise one
SMALL_CHANNELS_LAST = (("stem 3x3/2", (2, 3, 16, 16), (4, 3, 3, 3), 2, 1, 1),
                       ("depthwise 3x3", (2, 6, 8, 8), (6, 1, 3, 3), 1, 1, 6),
                       ("pointwise", (2, 6, 8, 8), (5, 6, 1, 1), 1, 0, 1))


@pytest.fixture
def one_thread():
    """torch on one thread for a test of many small CPU ops: with a
    thread a core they wait on each other when other test processes hold
    the cores (phase 26's MobileNetV2 forward took 13.7 s beside five
    other pytest workers, under 1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vision_model(name, dtype=torch.float32, **kw):
    kw = dict(dict(scale=0.25) if name.startswith("mobilenet") else {}, **kw)
    m = cs.image_model(name, device="cpu", num_classes=10,
                       generator=torch.Generator().manual_seed(0), **kw)
    return m.to(dtype)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("name", ["vgg", "mobilenet_v1", "mobilenet_v2"])
def test_vision_reference_forwards_are_the_port_models(name):
    """Phase 26's float32 references (``torch.nn.functional`` only) are
    the port's models: the same logits in training mode with dropout
    off, within 2^-12 of the largest (BatchNorm over the few values of a
    batch of 4 small images amplifies float32 roundings through
    MobileNetV2's 52 convs: seen 1.2e-5 of it; a wrong stride, padding
    or group is an error of order 1)."""
    from paddle_tpu_torch.models.vision import VGG

    if name == "vgg":        # VGG-11: the reference walks any depth's layout
        m = VGG(11, num_classes=10, dropout=0.0, device="cpu",
                generator=torch.Generator().manual_seed(0))
    else:
        m = _vision_model(name, **({"dropout": 0.0} if name ==
                                   "mobilenet_v2" else {}))
    init = {k: v.clone() for k, v in m.state_dict().items()}
    size = 32 if name == "vgg" else 64
    x = torch.randn(4, 3, size, size,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = m(x)
    ref = (cs.vgg_reference_forward(init, x, depth=11) if name == "vgg" else
           cs.mobilenet_reference_forward(init, x))
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=0, atol=2 ** -12 * scale)


def _ulp_once(real):
    """``real`` whose first call comes back one float32 step up (its
    gradient kept): the card's side of the planted fault, the check runs
    the CPU's side first."""
    calls = []

    def planted(*a, **k):
        out = real(*a, **k)
        calls.append(1)
        if len(calls) > 1:
            return out
        return out + (torch.nextafter(out, torch.full_like(
            out, float("inf"))) - out).detach()
    return planted


def _drop_bn_update(real):
    """``TrainStep.__call__`` that puts the stem BatchNorm's running mean
    back as it was before the step: a graph that dropped one buffer's
    update."""
    def call(self, *batch):
        bn = self.model.stem.bn
        kept = bn._mean.clone()
        out = real(self, *batch)
        bn._mean.copy_(kept)
        return out
    return call


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("fault", [None, "hwio permute", "bn update dropped",
                                   "misc op one ulp off"])
def test_phase_26_checks_reject_planted_faults(monkeypatch, fault):
    """Phase 26's checks on the CPU (the CPU in the card's place, small
    shapes) pass as they are, and each fails with the fault it aims at
    planted: the channels-last conv's weight permuted to (O, I, W, H)
    instead of OIHW (``channels_last_check``), a step whose running mean
    update is dropped on the graphed side (``graph_compare_check``:
    MobileNetV1 at 0.25 width, 2 steps), and ``brelu`` one float32 step
    off on one side (``ops_rest_card_check``: its output is held bit for
    bit)."""
    from paddle_tpu_torch.framework import TrainStep
    from paddle_tpu_torch.ops import conv, misc

    m = _vision_model("mobilenet_v1", torch.bfloat16)
    init = {k: v.clone() for k, v in m.state_dict().items()}
    rng = np.random.RandomState(0)
    batch = (rng.randn(2, 3, 32, 32).astype(np.float32),
             rng.randint(0, 10, (2,)).astype(np.int32))

    def graph_check():
        cs.graph_compare_check("vision mobilenet_v1", "bench_mobilenet_v1",
                               m, init, cs.resnet_loss, batch, "cpu",
                               steps=2)

    if fault == "hwio permute":
        monkeypatch.setattr(conv, "oihw", lambda w: w.permute(3, 2, 1, 0))
        with pytest.raises(cs.CheckFailed, match="channels-last conv2d"):
            cs.channels_last_check("cpu", device="cpu",
                                   shapes=SMALL_CHANNELS_LAST)
        return
    if fault == "bn update dropped":
        monkeypatch.setattr(TrainStep, "__call__",
                            _drop_bn_update(TrainStep.__call__))
        with pytest.raises(cs.CheckFailed, match="tensors differ"):
            graph_check()
        return
    if fault == "misc op one ulp off":
        monkeypatch.setattr(misc, "_brelu", _ulp_once(misc._brelu))
        with pytest.raises(cs.CheckFailed, match="brelu"):
            cs.ops_rest_card_check("cpu", device="cpu")
        return
    worst, moving, _ = cs.channels_last_check("cpu", device="cpu",
                                              shapes=SMALL_CHANNELS_LAST)
    assert worst <= cs.RESNET_CONV_TOL and moving == []
    graph_check()
    assert cs.ops_rest_card_check("cpu", device="cpu") == []
    cs.deformable_check("cpu", device="cpu",
                        shape=dict(B=1, C=8, H=10, W=10, O=4))
    assert set(cs.NEW_OP_NAMES) <= {c[0] for c in cs.OPS_REST_CASES}


@pytest.mark.usefixtures("one_thread")
def test_step_ranges_put_each_op_in_its_range_and_restore():
    """``step_ranges`` (what phases 16 and 26 and
    ``tools/torch_train_profile.py`` group device time by) names each
    ``nn.functional`` call and the optimizer's update in a profiler range,
    a conv of more than one group as ``depthwise_conv2d``, and puts every
    function back; ``_step_group`` splits a conv's kernels into forward,
    dgrad and wgrad and BatchNorm's into reductions and elementwise
    passes."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.framework import TrainStep
    from paddle_tpu_torch.nn import functional as PF

    m = _vision_model("mobilenet_v1", torch.bfloat16)
    opt = cs.train_optimizer(m, "bench_mobilenet_v1")
    step = TrainStep(m, opt, cs.resnet_loss)
    rng = np.random.RandomState(0)
    batch = (rng.randn(2, 3, 32, 32).astype(np.float32),
             rng.randint(0, 10, (2,)).astype(np.int32))
    real = {n: getattr(PF, n) for n in cs.STEP_RANGES}
    with cs.step_ranges(opt), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        step._eager_step(*batch)
    names = {e.name for e in prof.events()}
    assert any("_ConvBackward" in n for n in names)
    assert {"port::conv2d", "port::depthwise_conv2d", "port::batch_norm",
            "port::relu", "port::adaptive_avg_pool2d", "port::linear",
            "port::cross_entropy", "optimizer.step"} <= names
    assert all(cs.is_step_range(n) for n in names if n.startswith("port::"))
    assert {n: getattr(PF, n) for n in cs.STEP_RANGES} == real
    assert "_apply" not in vars(opt)

    def group(stack, kernel):
        e = None
        for name in reversed(stack):
            e = SimpleNamespace(name=name, cpu_parent=e)
        return cs._step_group(e, kernel)

    assert group(["port::conv2d", "aten::conv2d"], "sm90_fprop") == \
        "conv_forward"
    assert group(["_ConvBackward"], "sm90_dgrad_kernel") == \
        "conv_dgrad"
    assert group(["port::depthwise_conv2d"], "conv_depthwise2d_forward") == \
        "depthwise_conv_forward"
    assert group(["port::batch_norm"], "batch_norm_collect_statistics"
                 "_welford_kernel") == "batch_norm_reductions"
    assert group(["port::batch_norm"], "elementwise_kernel") == \
        "batch_norm_elementwise"
    assert group(["optimizer.step"], "Memcpy HtoD") == "copy"
    assert group(["aten::add"], "elementwise_kernel") == "other"
