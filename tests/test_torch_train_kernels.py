"""paddle_tpu_torch's LayerNorm and softmax-cross-entropy against the JAX
package's Pallas kernels.

The same numpy inputs, made from a seed, go through the JAX Pallas
kernels (``interpret=True``, as the JAX package's own tests run them on
the CPU; gradients through ``jax.vjp`` of the ``custom_vjp`` ops) and
the port's plain PyTorch versions — what the port's wrappers run for CPU
tensors — forward and backward, and through the port's
``autograd.Function``s. Tolerances, atol and rtol: 1e-5 in float32,
where the two differ only in summation order; 2e-2 in bfloat16 inputs
and outputs (a bound at bf16 resolution, 2^-7 ~ 7.8e-3 a step; both
sides compute in float32); 2^-9 in float16 (two float16 steps), at one
shape each. dlogits, whose entries off the label column
are ~g/V, is held entry by entry to that tolerance times the magnitudes
of its two terms, ``p * g + onehot * g``. The routing gates are held to
the JAX package's over a grid of shapes.

The CUDA kernels themselves run only on an H100: their tests are in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn.functional import attention as jattention
from paddle_tpu.nn.functional import loss as jloss
from paddle_tpu.ops import norm_ops as jnorm
from paddle_tpu.ops import pallas as pk
from paddle_tpu.ops.pallas import layernorm as jln
from paddle_tpu.ops.pallas import softmax_ce as jce
from paddle_tpu_torch.nn.functional import attention, loss
from paddle_tpu_torch.ops import kernels, norm_ops
from paddle_tpu_torch.ops.kernels import layernorm as ln
from paddle_tpu_torch.ops.kernels import softmax_ce as ce

from torch_test_threads import torch_threads  # noqa: F401,E402

F32_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = [("float32", F32_TOL), ("bfloat16", BF16_TOL)]
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
# float16: two float16 steps (11 significant bits), relative and absolute
FP16_TOL = 2 ** -9


def _both(a, dtype):
    """numpy float32 ``a`` as a JAX array and a torch tensor of ``dtype``
    (the same bf16-rounded values on both sides)."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TORCH[dtype])
    return j, t


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(jnp.asarray(j, jnp.float32)),
                               atol=tol, rtol=tol)


def _close_dlogits(t, j, x, lab, lse, g, tol):
    """|t - j| <= tol * (p * g + onehot * g) + the least normal float32,
    entry by entry, with p = exp(x - lse); 0 on ignore_index rows."""
    valid = lab != -100
    gv = g.float() * valid
    scale = torch.exp(x.float() - lse[:, None]) * gv[:, None]
    rows = valid.nonzero()[:, 0]
    scale[rows, lab[rows].long()] += gv[rows]
    err = (t.detach().float()
           - torch.from_numpy(np.array(jnp.asarray(j, jnp.float32)))).abs()
    bound = tol * scale + torch.finfo(torch.float32).tiny
    assert bool((err <= bound).all()), \
        f"max abs err {err.max().item()}, max excess {(err - bound).max()}"


# -- LayerNorm ---------------------------------------------------------------


@pytest.mark.parametrize("dtype, tol", DTYPES)
@pytest.mark.parametrize("N, D", [(16, 128), (64, 256)])
def test_layer_norm_matches_pallas_kernel(N, D, dtype, tol):
    rng = np.random.RandomState(N + D)
    x_np = (rng.randn(N, D) * 2 + 0.5).astype(np.float32)
    g_np = rng.randn(D).astype(np.float32)
    b_np = rng.randn(D).astype(np.float32)
    dy_np = rng.randn(N, D).astype(np.float32)
    (jx, x), (jg, g), (jb, b), (jdy, dy) = (
        _both(a, dtype) for a in (x_np, g_np, b_np, dy_np))

    jy, jmean, jrstd = jln._ln_call(jx, jg, jb, 1e-5, True)
    y, mean, rstd = ln.layer_norm_fwd(x, g, b, 1e-5)   # CPU: plain version
    _close(y, jy, tol)
    _close(mean, jmean, F32_TOL)   # statistics are float32 either way
    _close(rstd, jrstd, F32_TOL)

    jout, vjp = jax.vjp(
        lambda a, gg, bb: jln.fused_layer_norm(a, gg, bb, 1e-5, True),
        jx, jg, jb)
    jdx, jdg, jdb = vjp(jdy)
    dx, dg, db = ln.layer_norm_bwd(x, g, mean, rstd, dy)
    _close(dx, jdx, tol)
    _close(dg, jdg, tol)
    _close(db, jdb, tol)

    # the autograd.Function the port's layer_norm runs
    xa, ga, ba = (t.clone().requires_grad_() for t in (x, g, b))
    out = kernels.fused_layer_norm(xa, ga, ba, 1e-5)
    out.backward(dy)
    _close(out, jout, tol)
    _close(xa.grad, jdx, tol)
    _close(ga.grad, jdg, tol)
    _close(ba.grad, jdb, tol)


@pytest.mark.parametrize("shape", [(4, 8, 128), (2, 3, 128), (16, 96),
                                   (8, 256), (5, 128), (8, 1, 384)])
def test_layer_norm_routing_agrees_with_jax(shape, monkeypatch):
    """The port's ``layer_norm`` sends a shape to the kernel exactly when
    the JAX package's does, and gives its value either way."""
    rng = np.random.RandomState(1)
    D = shape[-1]
    x_np = rng.randn(*shape).astype(np.float32)
    w_np = rng.randn(D).astype(np.float32)
    b_np = rng.randn(D).astype(np.float32)
    routed = []
    real = pk.fused_layer_norm

    def spy(*a):
        routed.append(True)
        return real(*a)

    pk.set_enabled(True)
    monkeypatch.setattr(pk, "fused_layer_norm", spy)
    try:
        jout = jnorm._layer_norm(jnp.asarray(x_np), jnp.asarray(w_np),
                                 jnp.asarray(b_np), epsilon=1e-5,
                                 begin_norm_axis=len(shape) - 1)
    finally:
        pk.set_enabled(None)
    w, b = torch.from_numpy(w_np), torch.from_numpy(b_np)
    assert norm_ops.fused_ln_ok(shape, len(shape) - 1, w, b) == bool(routed)
    before = kernels.launches()
    out = norm_ops.layer_norm(torch.from_numpy(x_np), None, w, b, 1e-5)
    assert kernels.launches() == before   # CPU: no kernel launch
    _close(out, jout, F32_TOL)


# -- softmax cross-entropy ---------------------------------------------------


def _ce_inputs(N, V, seed, ignore_rows=(), scale=3.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, V) * scale).astype(np.float32)
    lab = rng.randint(0, V, N).astype(np.int32)
    lab[list(ignore_rows)] = -100
    g = rng.rand(N).astype(np.float32)
    return x, lab, g


@pytest.mark.parametrize("dtype, tol", DTYPES)
@pytest.mark.parametrize("N, V, ignore_rows", [
    (16, 384, (1, 7, 8)),   # one vocab block, ignore_index rows
    (8, 4096, (3,)),        # bv = 2048: two vocab blocks, the online path
])
def test_softmax_ce_matches_pallas_kernel(N, V, ignore_rows, dtype, tol):
    x_np, lab_np, g_np = _ce_inputs(N, V, N + V, ignore_rows)
    jx, x = _both(x_np, dtype)
    jlab, lab = jnp.asarray(lab_np), torch.from_numpy(lab_np)
    jg, g = jnp.asarray(g_np), torch.from_numpy(g_np)

    jl, jlse = jce._ce_call(jx, jlab, -100, True)
    l, lse = ce.softmax_ce_fwd(x, lab)            # CPU: plain version
    _close(l, jl, F32_TOL)
    _close(lse, jlse[:, 0], F32_TOL)
    assert torch.all(l[list(ignore_rows)] == 0)

    _, vjp = jax.vjp(lambda a: jce.softmax_cross_entropy(a, jlab, -100, True),
                     jx)
    jdx, = vjp(jg)
    dx = ce.softmax_ce_bwd(x, lab, lse, g)
    assert dx.dtype == x.dtype
    _close_dlogits(dx, jdx, x, lab, lse, g, tol)
    assert torch.all(dx[list(ignore_rows)] == 0)

    xa = x.clone().requires_grad_()
    out = kernels.softmax_cross_entropy(xa, lab.long())   # int64 labels
    out.backward(g)
    _close(out, jl, F32_TOL)
    _close_dlogits(xa.grad, jdx, x, lab, lse, g, tol)


def test_softmax_ce_large_logits_and_all_ignored():
    """Logits of magnitude ~1e3 stay finite and exact; a batch whose rows
    are all ``ignore_index`` has loss 0 and gradient 0 everywhere."""
    x_np, lab_np, g_np = _ce_inputs(8, 256, 5, scale=1e3)
    jl, jlse = jce._ce_call(jnp.asarray(x_np), jnp.asarray(lab_np), -100,
                            True)
    l, lse = ce.softmax_ce_fwd(torch.from_numpy(x_np),
                               torch.from_numpy(lab_np))
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0],
                               rtol=F32_TOL)
    lab_np[:] = -100
    x, lab = torch.from_numpy(x_np), torch.from_numpy(lab_np)
    l, lse = ce.softmax_ce_fwd(x, lab)
    assert torch.all(l == 0)
    assert torch.all(ce.softmax_ce_bwd(x, lab, lse,
                                       torch.from_numpy(g_np)) == 0)
    mean = loss.cross_entropy(x.requires_grad_(), lab)
    assert float(mean.detach()) == 0.0   # 0 / max(valid, 1e-12)


@pytest.mark.parametrize("shape, label_shape, weighted, smoothing", [
    ((16, 384), (16,), False, 0.0),
    ((16, 384), (16, 1), False, 0.0),
    ((12, 384), (12,), False, 0.0),    # N % 8 != 0: dense
    ((16, 300), (16,), False, 0.0),    # V % 128 != 0: dense
    ((16, 384), (16,), True, 0.0),     # class weights: dense
    ((16, 384), (16,), False, 0.1),    # label smoothing: dense
    ((2, 8, 128), (2, 8), False, 0.0),  # 3-D logits: dense
])
def test_cross_entropy_routing_agrees_with_jax(shape, label_shape, weighted,
                                               smoothing):
    rng = np.random.RandomState(2)
    x_np = rng.randn(*shape).astype(np.float32)
    lab_np = rng.randint(0, shape[-1], label_shape).astype(np.int32)
    lab_np.flat[0] = -100
    w_np = rng.rand(shape[-1]).astype(np.float32) if weighted else None
    jw = None if w_np is None else jnp.asarray(w_np)
    pk.set_enabled(True)
    try:
        j_ok = jloss._fused_ce_ok(jnp.asarray(x_np), jnp.asarray(lab_np), jw,
                                  -1, True, smoothing)
        jout = jloss._ce_hard(jnp.asarray(x_np), jnp.asarray(lab_np), jw,
                              axis=-1, ignore_index=-100, reduction="mean",
                              use_softmax=True, label_smoothing=smoothing)
    finally:
        pk.set_enabled(None)
    x, lab = torch.from_numpy(x_np), torch.from_numpy(lab_np)
    w = None if w_np is None else torch.from_numpy(w_np)
    assert loss.fused_ce_ok(x, lab, w, -1, True, smoothing) == bool(j_ok)
    out = loss.cross_entropy(x, lab, weight=w, label_smoothing=smoothing)
    _close(out, jout, F32_TOL)


@pytest.mark.parametrize("Lq, Lk, D, p, masked", [
    (128, 128, 64, 0.0, False), (256, 128, 128, 0.0, False),
    (128, 128, 64, 0.1, False), (128, 128, 64, 0.0, True),
    (96, 128, 64, 0.0, False), (128, 128, 32, 0.0, False),
    (128, 128, 320, 0.0, False), (128, 64, 64, 0.0, False),
])
def test_flash_gate_agrees_with_jax(Lq, Lk, D, p, masked):
    q, k = np.zeros((1, 1, Lq, D), np.float32), np.zeros((1, 1, Lk, D),
                                                          np.float32)
    mask = np.ones((Lq, Lk), bool) if masked else None
    pk.set_enabled(True)
    try:
        want = jattention._flash_ok(jnp.asarray(q), jnp.asarray(k), p,
                                    None if mask is None
                                    else jnp.asarray(mask))
    finally:
        pk.set_enabled(None)
    got = attention.flash_ok(torch.from_numpy(q), torch.from_numpy(k), p,
                             None if mask is None else torch.from_numpy(mask))
    assert got == want


def test_wrappers_raise_off_the_cpu_without_a_kernel_device():
    """Only a CPU tensor (or ``plain_versions()``) takes a plain version:
    any other device must launch the kernel or raise (a meta tensor here,
    which launches nothing)."""
    x = torch.empty(8, 128, device="meta")
    with pytest.raises(ValueError):
        ln.layer_norm_fwd(x, torch.empty(128), torch.empty(128), 1e-5)
    with pytest.raises(ValueError):
        ce.softmax_ce_fwd(x, torch.zeros(8, dtype=torch.int32))


def test_plain_versions_context_is_explicit_and_scoped():
    from paddle_tpu_torch.ops.kernels import _route

    t = torch.empty(1, device="meta")
    assert not _route.plain(t)
    with kernels.plain_versions():
        assert _route.plain(t)
        with kernels.plain_versions():
            assert _route.plain(t)
        assert _route.plain(t)
    assert not _route.plain(t)
    assert _route.plain(torch.empty(1))   # CPU tensors always


@pytest.mark.parametrize("which", ["layer_norm", "softmax_ce"])
def test_float16_plain_versions_match_pallas_kernels(which):
    """The float16 plain versions (float32 inside, rounding only what
    they write, as the kernels do) against the Pallas kernels in
    interpret mode at float16, one shape each, within ``FP16_TOL``."""
    if which == "layer_norm":
        test_layer_norm_matches_pallas_kernel(16, 128, "float16", FP16_TOL)
    else:
        test_softmax_ce_matches_pallas_kernel(16, 384, (1, 7, 8), "float16",
                                              FP16_TOL)
