"""Row LayerNorm, forward and backward: the CUDA kernels and their plain
versions.

- ``layer_norm_fwd(x, gamma, beta, eps) -> (y, mean, rstd)`` and
  ``layer_norm_bwd(x, gamma, mean, rstd, dy) -> (dx, dgamma, dbeta)``:
  the wrappers. On CUDA tensors each launches its hand-written kernel of
  ``csrc/layernorm.cu`` (and raises if it cannot); on CPU tensors, or
  inside ``plain_versions()``, it runs the plain version. Each counts
  its kernel launches in ``<wrapper>.launches``.
- ``layer_norm_fwd_reference`` / ``layer_norm_bwd_reference``: the plain
  PyTorch versions, the TPU kernels' arithmetic written in torch ops.
- ``fused_layer_norm(x, gamma, beta, eps)``: the differentiable op, a
  ``torch.autograd.Function`` that saves ``mean`` and ``rstd`` ``(N, 1)``
  float32 for its backward, as ``_ln_fwd`` does.

They replace the Pallas kernels ``_fwd_kernel`` and ``_bwd_kernel`` of
``paddle_tpu/ops/pallas/layernorm.py``; the source note in the ``.cu``
file gives the kernels' design and their bound on an H100.

Layout: ``x`` and ``dy`` ``(N, D)`` float32, bfloat16 or float16; ``gamma`` and
``beta`` ``(D,)`` of x's type; statistics in float32 whatever the type.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _route
from ...core.tensor import plain

__all__ = ["layer_norm_fwd", "layer_norm_bwd", "layer_norm_fwd_reference",
           "layer_norm_bwd_reference", "fused_layer_norm", "SOURCE",
           "REPLACES", "REPLACES_BWD"]

SOURCE = "paddle_tpu_torch/csrc/layernorm.cu"
REPLACES = "paddle_tpu/ops/pallas/layernorm.py:20"
REPLACES_BWD = "paddle_tpu/ops/pallas/layernorm.py:33"
MAX_SMEM_BYTES = 232448   # a block's shared memory on sm_90
WARPS = 4                 # a CTA of the kernels (csrc kWarps)
# the scalar backward keeps two float32 accumulator rows per warp in
# shared memory
MAX_D = MAX_SMEM_BYTES // (2 * WARPS * 4)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def layer_norm_fwd_reference(x, gamma, beta, eps=1e-5):
    """Plain PyTorch version of the forward kernel: ``(y, mean, rstd)``,
    y in x's type, mean and rstd ``(N, 1)`` float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * gamma.float() + beta.float()
    return y.to(x.dtype), mean, rstd


def layer_norm_bwd_reference(x, gamma, mean, rstd, dy):
    """Plain PyTorch version of the backward kernel: ``(dx, dgamma,
    dbeta)``, dx in x's type, dgamma and dbeta ``(D,)`` float32."""
    xf = x.float()
    g = dy.float()
    xhat = (xf - mean) * rstd
    wdy = g * gamma.float()
    c1 = (wdy * xhat).mean(dim=-1, keepdim=True)
    c2 = wdy.mean(dim=-1, keepdim=True)
    dx = (wdy - xhat * c1 - c2) * rstd
    return dx.to(x.dtype), (g * xhat).sum(dim=0), g.sum(dim=0)


def _check(x, gamma, **others):
    """Raise ``ValueError`` on anything the kernels do not take: x
    ``(N, D)`` float32, bfloat16 or float16 with D <= MAX_D; ``gamma``/``beta``
    ``(D,)`` and ``dy`` ``(N, D)`` of x's type; ``mean``/``rstd`` ``(N, 1)``
    float32; all contiguous and on x's device."""
    if x.dim() != 2:
        raise ValueError(f"x must be (N, D), got {tuple(x.shape)}")
    N, D = x.shape
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32, bfloat16 or float16, got "
                         f"{x.dtype}")
    if not 0 < D <= MAX_D:
        raise ValueError(f"D = {D} outside 1..{MAX_D} (shared memory)")
    want = {"x": ((N, D), x.dtype), "gamma": ((D,), x.dtype),
            "beta": ((D,), x.dtype), "dy": ((N, D), x.dtype),
            "mean": ((N, 1), torch.float32), "rstd": ((N, 1), torch.float32)}
    for name, t in (("x", x), ("gamma", gamma), *others.items()):
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _library():
    lib = _build.load("layernorm")
    if lib.layer_norm_fwd_launch.argtypes is None:
        lib.layer_norm_fwd_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
            + [ctypes.c_float, ctypes.c_void_p])
        lib.layer_norm_fwd_launch.restype = ctypes.c_int
        lib.layer_norm_bwd_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.layer_norm_bwd_launch.restype = ctypes.c_int
        lib.layer_norm_bwd_ctas.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
            + [ctypes.POINTER(ctypes.c_int)])
        lib.layer_norm_bwd_ctas.restype = ctypes.c_int
        lib.layer_norm_error_string.argtypes = [ctypes.c_int]
        lib.layer_norm_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, rc, what):
    if rc != 0:
        msg = lib.layer_norm_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def layer_norm_fwd(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of ``x (N, D)``: ``(y, mean, rstd)``.

    CPU tensors (or ``plain_versions()``) take the plain version; CUDA
    tensors launch the kernel or raise — there is no fallback."""
    if _route.plain(x):
        return layer_norm_fwd_reference(x, gamma, beta, eps)
    _route.require_cuda(x, "layer_norm_fwd")
    _check(x, gamma, beta=beta)
    N, D = x.shape
    y = torch.empty_like(x)
    mean = torch.empty(N, 1, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if N == 0:
        return y, mean, rstd
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.layer_norm_fwd_launch(
            _DTYPES[x.dtype], x.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            N, D, float(eps), stream)
    _raise_on(lib, rc, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y, mean, rstd


layer_norm_fwd.launches = 0
layer_norm_fwd.replaces = REPLACES


def layer_norm_bwd(x, gamma, mean, rstd, dy):
    """Backward of ``layer_norm_fwd``: ``(dx, dgamma, dbeta)``, dx in x's
    type, dgamma and dbeta ``(D,)`` float32 (deterministic: per-CTA
    partials summed in a fixed order, no atomics; the CTAs are a
    function of the shapes, the alignment and the card).

    CPU tensors (or ``plain_versions()``) take the plain version; CUDA
    tensors launch the kernels or raise — there is no fallback."""
    if _route.plain(x):
        return layer_norm_bwd_reference(x, gamma, mean, rstd, dy)
    _route.require_cuda(x, "layer_norm_bwd")
    _check(x, gamma, mean=mean, rstd=rstd, dy=dy)
    N, D = x.shape
    dx = torch.empty_like(x)
    if N == 0:
        dg = torch.zeros(D, dtype=torch.float32, device=x.device)
        return dx, dg, torch.zeros_like(dg)
    # the reduce writes every entry
    dg = torch.empty(D, dtype=torch.float32, device=x.device)
    db = torch.empty_like(dg)
    lib = _library()
    with torch.cuda.device(x.device):
        # the rows of the (G, D) dgamma/dbeta workspace: the CTAs of the
        # kernel the dispatch picks
        G = ctypes.c_int()
        rc = lib.layer_norm_bwd_ctas(
            _DTYPES[x.dtype], N, D, x.data_ptr(), gamma.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), ctypes.byref(G))
        _raise_on(lib, rc, "layer_norm_bwd")
        ws = torch.empty(2, G.value, D, dtype=torch.float32,
                         device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.layer_norm_bwd_launch(
            _DTYPES[x.dtype], x.data_ptr(), gamma.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dg.data_ptr(), db.data_ptr(),
            ws[0].data_ptr(), ws[1].data_ptr(), N, D, G.value, stream)
    _raise_on(lib, rc, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, dg, db


layer_norm_bwd.launches = 0
layer_norm_bwd.replaces = REPLACES_BWD


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.plain = _route.plain(x)
        y, mean, rstd = layer_norm_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        bwd = layer_norm_bwd_reference if ctx.plain else layer_norm_bwd
        dx, dg, db = bwd(x, gamma, mean, rstd, dy.contiguous())
        return dx, dg.to(gamma.dtype), db.to(gamma.dtype), None


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """Differentiable LayerNorm of ``x (N, D)`` over its last axis, through
    the kernels (or their plain versions, as the wrappers route). Paddle
    ``Tensor``s and ``Parameter``s come in as plain tensors."""
    return _FusedLayerNorm.apply(plain(x), plain(gamma), plain(beta),
                                 float(eps))
