"""paddle_tpu_torch's flash attention against the JAX package's Pallas
kernels.

The same numpy inputs, made from a seed, go through the JAX Pallas
kernels of ``paddle_tpu/ops/pallas/flash_attention.py``
(``interpret=True``, as the JAX package's own tests run them on the
CPU: ``_flash_fwd`` for O and lse, ``_flash_bwd`` for dQ, dK and dV, and
``jax.vjp`` of the ``custom_vjp`` op) and through the port's plain
PyTorch versions — what the port's wrappers run for CPU tensors — and
its ``autograd.Function``. Cases: causal and not, Lq = Lk and Lq < Lk
(offset Lk - Lq), the JAX kernel's block_q 64 and 128, float32 and
bfloat16; float16 at one shape, within one float16 step (rtol 2^-10).

Tolerances (the two sides differ in the order of their float32 sums and,
in bfloat16, in where a sum that lands near a rounding boundary rounds):

- float32: O and lse 1e-5 (atol and rtol; |O| < 4, lse ~ ln Lk; seen:
  <= 2.7e-7 and 4.8e-7); dQ, dK and dV 1e-5 of each one's largest
  entry (atol) and 1e-5 rtol: sums over up to 256 keys or queries of
  products of order 1 (seen: <= 7.1e-7 of the largest entry).
- bfloat16: lse (float32 on both sides) 1e-5; O, dQ, dK and dV within
  one bfloat16 step of the JAX kernel's value (rtol 2^-7: a bfloat16
  keeps 8 significant bits) plus 1e-5 of the largest entry (atol), for
  the entries that the float32 sums put on either side of a rounding
  boundary at small magnitude.

The CUDA kernels themselves run only on an H100: their tests are in
``tests/test_torch_cuda.py``.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.nn.functional import attention, sdpa_bhld
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as fa

from torch_test_threads import torch_threads  # noqa: F401,E402

# the module: ``paddle_tpu.ops.pallas`` exports its op under the same name
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

F32 = dict(out=1e-5, grad=1e-5, rtol_out=1e-5, rtol_grad=1e-5)
BF16 = dict(out=1e-5, grad=1e-5, rtol_out=2 ** -7, rtol_grad=2 ** -7)
# float16: one float16 step (11 significant bits) relative
F16 = dict(out=1e-5, grad=1e-5, rtol_out=2 ** -10, rtol_grad=2 ** -10)
TOLS = {"float32": F32, "bfloat16": BF16, "float16": F16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
SHAPES = [(128, 128), (128, 256)]   # (Lq, Lk): offset 0 and 128


def _both(a, dtype):
    """numpy float32 ``a`` as a JAX array and a torch tensor of ``dtype``
    (the same bf16-rounded values on both sides)."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TORCH[dtype])
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _close(got, want, atol, rtol, of_largest=False):
    """``|got - want| <= atol + rtol * |want|``, with ``atol`` a share of
    the largest ``|want|`` when ``of_largest``."""
    got, want = _np(got), _np(want)
    if of_largest:
        atol *= float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _inputs(Lq, Lk, dtype, seed, D=64, B=1, H=2):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, H, L, D).astype(np.float32)
                   for L in (Lq, Lk, Lk, Lq))
    return [_both(a, dtype) for a in (q, k, v, do)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_q", [64, 128])
@pytest.mark.parametrize("Lq, Lk", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_match_pallas_kernels(causal, Lq, Lk, block_q,
                                             dtype):
    """O and lse against ``_flash_fwd``; dQ, dK and dV against
    ``_flash_bwd`` on the same (q, k, v, dO, O, lse)."""
    tol = TOLS[dtype]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(Lq, Lk, dtype,
                                                       seed=Lq + Lk)
    scale = 1.0 / 8
    jo, res = jfa._flash_fwd(jq, jk, jv, causal, scale, block_q, True)
    jlse = res[4]
    o, lse = fa.flash_attention_fwd_reference(tq, tk, tv, causal, scale)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == tuple(jlse.shape) == (2, Lq, 1)
    _close(o, jo, tol["out"], tol["rtol_out"])
    _close(lse, jlse, 1e-5, 1e-5)

    jdq, jdk, jdv = jfa._flash_bwd(causal, scale, block_q, True, res, jdo)
    # the backward's inputs are the JAX kernel's own O and lse
    to = torch.from_numpy(_np(jo)).to(tq.dtype)
    tlse = torch.from_numpy(_np(jlse))
    delta = fa.flash_delta(to, tdo)
    args = (tq, tk, tv, tdo, tlse, delta, causal, scale)
    dq = fa.flash_attention_bwd_dq_reference(*args)
    dk, dv = fa.flash_attention_bwd_dkv_reference(*args)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == tq.dtype
        _close(got, want, tol["grad"], tol["rtol_grad"], of_largest=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq, Lk, causal", [(128, 256, True),
                                            (256, 256, False)])
def test_autograd_function_matches_jax_vjp(Lq, Lk, causal, dtype):
    """The port's ``flash_attention`` forward and backward (through
    torch autograd) against ``jax.vjp`` of the JAX ``custom_vjp`` op in
    interpret mode, with the default scale 1/sqrt(D)."""
    tol = TOLS[dtype]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(Lq, Lk, dtype,
                                                       seed=7)
    jo, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, causal, None, 128, True), jq, jk, jv)
    jdq, jdk, jdv = vjp(jdo)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    kernels.reset_launches()
    o = fa.flash_attention(q, k, v, causal)
    o.backward(tdo)
    assert set(kernels.launches().values()) == {0}
    _close(o, jo, tol["out"], tol["rtol_out"])
    for got, want in ((q.grad, jdq), (k.grad, jdk), (v.grad, jdv)):
        _close(got, want, tol["grad"], tol["rtol_grad"], of_largest=True)


def test_sdpa_routes_flash_shapes_to_the_plain_versions_on_the_cpu():
    """At flash-friendly shapes (no mask, no dropout, L % 128 == 0, D =
    64) a CPU tensor takes the flash op's plain version — transposed
    views included — and counts no launch; with a mask it stays dense."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 128, 2, 64, generator=g).transpose(1, 2)
               for _ in range(3))
    assert not q.is_contiguous()
    assert attention.flash_ok(q, k, 0.0, None)
    kernels.reset_launches()
    out = sdpa_bhld(q, k, v, is_causal=True)
    assert set(kernels.launches().values()) == {0}
    want, _ = fa.flash_attention_fwd_reference(
        q.contiguous(), k.contiguous(), v.contiguous(), True, 1 / 8)
    assert torch.equal(out, want)
    # a mask (or dropout in training) keeps the JAX package's dense path
    mask = torch.ones(128, 128, dtype=torch.bool).tril()
    assert not attention.flash_ok(q, k, 0.0, mask)
    dense = sdpa_bhld(q, k, v, attn_mask=mask)
    torch.testing.assert_close(dense, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "layout", "lse",
                                  "rank", "kv"])
def test_kernel_argument_checks_reject_what_the_kernels_do_not_take(case):
    """``_check`` runs before every launch; on the CPU it is exercised on
    its own, since the wrappers take the plain versions there."""
    q = torch.zeros(1, 2, 128, 64)
    k = v = torch.zeros(1, 2, 256, 64)
    lse = delta = torch.zeros(2, 128, 1)
    fa._check(q, k, v, do=q, lse=lse, delta=delta)
    bad = {"head_dim": lambda: fa._check(torch.zeros(1, 2, 128, 96),
                                         torch.zeros(1, 2, 128, 96),
                                         torch.zeros(1, 2, 128, 96)),
           "dtype": lambda: fa._check(q.double(), k.double(), v.double()),
           "layout": lambda: fa._check(
               torch.zeros(1, 128, 2, 64).transpose(1, 2), k, v),
           "lse": lambda: fa._check(q, k, v, do=q, lse=lse[:, :, 0],
                                    delta=delta),
           "rank": lambda: fa._check(q[0], k[0], v[0]),
           "kv": lambda: fa._check(q, k, v[:, :, :128].contiguous())}
    with pytest.raises(ValueError):
        bad[case]()


def test_float16_plain_versions_match_pallas_kernels():
    """The float16 plain versions against the Pallas kernels in
    interpret mode at float16: one shape (causal, Lq = Lk = 128, block_q
    64), O and lse, then dQ, dK and dV, and the autograd Function
    against ``jax.vjp`` (Lq 128 < Lk 256), within one float16 step."""
    test_plain_versions_match_pallas_kernels(True, 128, 128, 64, "float16")
    test_autograd_function_matches_jax_vjp(128, 256, True, "float16")
