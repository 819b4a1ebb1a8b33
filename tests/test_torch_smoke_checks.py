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
unevenly (the output's shape kept, its windows shifted).
"""
import pathlib
import re

import pytest
import torch

import chip_smoke as cs
from paddle_tpu_torch.ops.kernels import KERNELS
from paddle_tpu_torch.ops.kernels import softmax_ce as ce

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
            x, w.transpose(2, 3), *a, **k))
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
