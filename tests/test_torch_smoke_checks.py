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
halves pass, P and dS rounded once fail.
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
