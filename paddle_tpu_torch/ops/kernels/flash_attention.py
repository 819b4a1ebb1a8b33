"""Flash attention, forward and backward: the CUDA kernels and their plain
versions.

- ``flash_attention_fwd(q, k, v, causal, scale) -> (o, lse)``,
  ``flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale) -> dq``
  and ``flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
  -> (dk, dv)``: the wrappers. On CUDA tensors each launches its
  hand-written kernel of ``csrc/flash_attention.cu`` (and raises if it
  cannot); on CPU tensors, or inside ``plain_versions()``, it runs the
  plain version. Each counts its kernel launches in
  ``<wrapper>.launches``.
- ``flash_attention_fwd_reference``, ``flash_attention_bwd_dq_reference``
  and ``flash_attention_bwd_dkv_reference``: the plain PyTorch versions,
  the TPU kernels' arithmetic written in torch ops.
- ``flash_attention(q, k, v, causal, scale)``: the differentiable op, a
  ``torch.autograd.Function`` that saves ``(q, k, v, o, lse)``; its
  backward computes ``delta = rowsum(dO * O)`` in float32 from the
  stored O (``flash_delta``), as ``_flash_bwd`` does, then runs the two
  backward kernels.

They replace the Pallas kernels ``_fwd_kernel``, ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` of ``paddle_tpu/ops/pallas/flash_attention.py``; the
source note in the ``.cu`` file gives the kernels' design and their
bound on an H100.

Layout: q ``(B, H, Lq, D)``, k and v ``(B, H, Lk, D)``, all float32 or
all bfloat16 or all float16; lse and delta ``(B*H, Lq, 1)`` float32. ``causal`` aligns
the last query with the last key (offset ``Lk - Lq``) and masks with an
additive -1e30, as the TPU kernel does. The kernels take D = 64, 128,
192 or 256 (every D the flash gate admits) and any Lq and Lk.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _route
from ...core.tensor import plain

__all__ = ["flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_fwd_reference",
           "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv_reference", "flash_delta",
           "flash_attention", "SOURCE", "REPLACES", "REPLACES_BWD",
           "HEAD_DIMS"]

SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
REPLACES = "paddle_tpu/ops/pallas/flash_attention.py:41"
REPLACES_BWD = "paddle_tpu/ops/pallas/flash_attention.py:81"
HEAD_DIMS = (64, 128, 192, 256)
MAX_BH = 65535    # B * H rides on the grid's y dimension
NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _scores(q, k, causal, scale):
    """``(q * scale) k^T`` in float32 with the additive causal mask."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        Lq, Lk = s.shape[-2], s.shape[-1]
        visible = torch.ones(Lq, Lk, dtype=torch.bool,
                             device=q.device).tril(Lk - Lq)
        s = s + torch.where(visible, 0.0, NEG_INF)
    return s


def flash_attention_fwd_reference(q, k, v, causal, scale):
    """Plain PyTorch version of the forward kernel: ``(o, lse)``, o in
    q's type, lse ``(B*H, Lq, 1)`` float32."""
    B, H, Lq, _ = q.shape
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).reshape(B * H, Lq, 1)


def _p_ds(q, k, v, do, lse, delta, causal, scale):
    """The backward's ``P = exp(S - lse)`` and ``dS = P (dO v^T -
    delta)``, float32."""
    B, H, Lq, _ = q.shape
    p = torch.exp(_scores(q, k, causal, scale) - lse.reshape(B, H, Lq, 1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta.reshape(B, H, Lq, 1))


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                     scale):
    """Plain PyTorch version of the dQ kernel: dq in q's type."""
    _, ds = _p_ds(q, k, v, do, lse, delta, causal, scale)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                      scale):
    """Plain PyTorch version of the dK/dV kernel: ``(dk, dv)`` in k's and
    v's type."""
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float() * scale)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_delta(o, do):
    """``rowsum(dO * O)`` in float32 from O as stored: ``(B*H, Lq, 1)``."""
    B, H, Lq, _ = o.shape
    return (do.float() * o.float()).sum(dim=-1).reshape(B * H, Lq, 1)


def _check(q, k, v, **others):
    """Raise ``ValueError`` on anything the kernels do not take: q
    ``(B, H, Lq, D)``, k and v ``(B, H, Lk, D)``, ``do`` like q, all of
    one type (float32, bfloat16 or float16); ``lse`` and ``delta`` ``(B*H, Lq, 1)``
    float32; D in HEAD_DIMS; B*H <= MAX_BH; all contiguous and on q's
    device."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, Lq, D), got {tuple(q.shape)}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2] if k.dim() == 4 else -1
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32, bfloat16 or float16, got "
                         f"{q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not one of {HEAD_DIMS}")
    if B * H > MAX_BH:
        raise ValueError(f"B * H = {B * H} > {MAX_BH}")
    want = {"q": ((B, H, Lq, D), q.dtype), "k": ((B, H, Lk, D), q.dtype),
            "v": ((B, H, Lk, D), q.dtype), "do": ((B, H, Lq, D), q.dtype),
            "lse": ((B * H, Lq, 1), torch.float32),
            "delta": ((B * H, Lq, 1), torch.float32)}
    for name, t in (("q", q), ("k", k), ("v", v), *others.items()):
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _library():
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd_launch.argtypes is None:
        tail = [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.flash_attention_fwd_launch.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + tail)
        lib.flash_attention_bwd_dq_launch.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + tail)
        lib.flash_attention_bwd_dkv_launch.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + tail)
        for fn in (lib.flash_attention_fwd_launch,
                   lib.flash_attention_bwd_dq_launch,
                   lib.flash_attention_bwd_dkv_launch):
            fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch(what, q, k, causal, scale, *tensors):
    """Launch ``<what>_launch`` on q's device and current stream."""
    B, H, Lq, D = q.shape
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, f"{what}_launch")(
            _DTYPES[q.dtype], D, *(t.data_ptr() for t in tensors), B * H,
            Lq, k.shape[2], float(scale), int(bool(causal)), stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def flash_attention_fwd(q, k, v, causal, scale):
    """Attention of q over k and v: ``(o, lse)``.

    CPU tensors (or ``plain_versions()``) take the plain version; CUDA
    tensors launch the kernel or raise — there is no fallback."""
    if _route.plain(q):
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    _route.require_cuda(q, "flash_attention_fwd")
    _check(q, k, v)
    B, H, Lq, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B * H, Lq, 1, dtype=torch.float32, device=q.device)
    if o.numel() == 0:    # a grid of no blocks is not a launch
        return o, lse
    _launch("flash_attention_fwd", q, k, causal, scale, q, k, v, o, lse)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.replaces = REPLACES


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale):
    """dQ of ``flash_attention_fwd``, in q's type.

    CPU tensors (or ``plain_versions()``) take the plain version; CUDA
    tensors launch the kernel or raise — there is no fallback."""
    if _route.plain(q):
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                causal, scale)
    _route.require_cuda(q, "flash_attention_bwd_dq")
    _check(q, k, v, do=do, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    _launch("flash_attention_bwd_dq", q, k, causal, scale, q, k, v, do,
            lse, delta, dq)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.replaces = REPLACES_BWD


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    """dK and dV of ``flash_attention_fwd``, in k's and v's type
    (deterministic: each k-tile's CTA writes its own rows, no atomics).

    CPU tensors (or ``plain_versions()``) take the plain version; CUDA
    tensors launch the kernel or raise — there is no fallback."""
    if _route.plain(q):
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal, scale)
    _route.require_cuda(q, "flash_attention_bwd_dkv")
    _check(q, k, v, do=do, lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    _launch("flash_attention_bwd_dkv", q, k, causal, scale, q, k, v, do,
            lse, delta, dk, dv)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.replaces = (
    "paddle_tpu/ops/pallas/flash_attention.py:112")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.plain = _route.plain(q)
        ctx.causal, ctx.scale = causal, scale
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_delta(o, do)
        args = (q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        if ctx.plain:
            dq = flash_attention_bwd_dq_reference(*args)
            dk, dv = flash_attention_bwd_dkv_reference(*args)
        else:
            dq = flash_attention_bwd_dq(*args)
            dk, dv = flash_attention_bwd_dkv(*args)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Differentiable attention of q ``(B, H, Lq, D)`` over k and v
    ``(B, H, Lk, D)`` through the kernels (or their plain versions, as
    the wrappers route); ``scale`` defaults to ``1/sqrt(D)``. Views are
    made contiguous first; Paddle ``Tensor``s come in as plain tensors."""
    q, k, v = plain(q), plain(k), plain(v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal), float(scale))
