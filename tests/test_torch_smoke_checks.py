"""``chip_smoke.py``'s cross-entropy checks reject planted faults.

The smoke holds each kernel to its plain version on the card; these
tests hold its checks themselves, on the CPU, with the plain versions
standing in for the kernels. dlogits is ``(p - onehot) * g``, and most
of its entries are ~g/V (about 6e-6 at V = 50304), so the check bounds
each entry by the magnitudes of its own terms: a kernel that wrote 0 off
the label column, or worked from an lse off by 1%, must fail it, and an
honest result (the same function evaluated in float64, then rounded)
must pass.
"""
import pytest
import torch

import chip_smoke as cs
from paddle_tpu_torch.ops.kernels import softmax_ce as ce


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
