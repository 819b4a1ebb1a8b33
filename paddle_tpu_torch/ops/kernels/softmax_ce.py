"""Softmax cross-entropy over hard labels, forward and backward: the CUDA
kernels and their plain versions.

- ``softmax_ce_fwd(logits, labels, ignore_index) -> (loss, lse)`` and
  ``softmax_ce_bwd(logits, labels, lse, g, ignore_index) -> dlogits``:
  the wrappers. On CUDA tensors each launches its hand-written kernel of
  ``csrc/softmax_ce.cu`` (and raises if it cannot); on CPU tensors, or
  inside ``plain_versions()``, it runs the plain version. Each counts
  its kernel launches in ``<wrapper>.launches``.
- ``softmax_ce_fwd_reference`` / ``softmax_ce_bwd_reference``: the plain
  PyTorch versions, the TPU kernels' arithmetic written in torch ops.
- ``softmax_cross_entropy(logits, labels, ignore_index)``: the
  differentiable per-row loss ``(N,)`` float32, a
  ``torch.autograd.Function`` that saves ``lse`` for its backward.

They replace the Pallas kernels ``_fwd_kernel`` and ``_bwd_kernel`` of
``paddle_tpu/ops/pallas/softmax_ce.py``; the source note in the ``.cu``
file gives the kernels' design and their bound on an H100.

Layout: logits ``(N, V)`` float32, bfloat16 or float16; labels ``(N,)`` int32
(int64 is cast to int32 before launch); loss, lse and g ``(N,)`` float32.
A row whose label is ``ignore_index`` has loss 0 and gradient 0.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _route
from ...core.tensor import plain

__all__ = ["softmax_ce_fwd", "softmax_ce_bwd", "softmax_ce_fwd_reference",
           "softmax_ce_bwd_reference", "softmax_cross_entropy", "SOURCE",
           "REPLACES", "REPLACES_BWD"]

SOURCE = "paddle_tpu_torch/csrc/softmax_ce.cu"
REPLACES = "paddle_tpu/ops/pallas/softmax_ce.py:25"
REPLACES_BWD = "paddle_tpu/ops/pallas/softmax_ce.py:55"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _picked(xf, labels):
    """x[row, label] in float32, 0 for a label outside [0, V) (the TPU
    kernel's one-hot matches no column)."""
    lab = labels.long()
    inside = (lab >= 0) & (lab < xf.shape[1])
    got = xf.gather(1, lab.clamp(0, xf.shape[1] - 1)[:, None])[:, 0]
    return torch.where(inside, got, torch.zeros_like(got))


def softmax_ce_fwd_reference(logits, labels, ignore_index=-100):
    """Plain PyTorch version of the forward kernel: per-row ``(loss,
    lse)``, both ``(N,)`` float32."""
    xf = logits.float()
    m = xf.amax(dim=-1, keepdim=True)
    s = torch.exp(xf - m).sum(dim=-1)
    lse = m[:, 0] + torch.log(s.clamp_min(1e-30))
    valid = (labels != ignore_index).float()
    return (lse - _picked(xf, labels)) * valid, lse


def softmax_ce_bwd_reference(logits, labels, lse, g, ignore_index=-100):
    """Plain PyTorch version of the backward kernel: ``(exp(x - lse) -
    onehot) * g * valid`` in the logits' type."""
    xf = logits.float()
    p = torch.exp(xf - lse[:, None])
    cols = torch.arange(xf.shape[1], device=xf.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    valid = (labels != ignore_index).float()
    return ((p - onehot) * g.float()[:, None]
            * valid[:, None]).to(logits.dtype)


def _labels32(logits, labels):
    """Check ``labels`` against ``logits`` and return them as int32."""
    if labels.dim() != 1 or labels.shape[0] != logits.shape[0]:
        raise ValueError(f"labels must be ({logits.shape[0]},), got "
                         f"{tuple(labels.shape)}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"labels must be int32 or int64, got {labels.dtype}")
    if labels.device != logits.device:
        raise ValueError(f"labels are on {labels.device}, logits on "
                         f"{logits.device}")
    return labels.to(torch.int32).contiguous()


def _check(logits, *rows):
    """Raise ``ValueError`` on anything the kernels do not take: logits
    ``(N, V)`` float32, bfloat16 or float16, contiguous, with float32 ``(N,)``
    rows (lse, g) beside them on their device."""
    if logits.dim() != 2:
        raise ValueError(f"logits must be (N, V), got {tuple(logits.shape)}")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"logits must be float32, bfloat16 or float16, got "
                         f"{logits.dtype}")
    if logits.shape[1] == 0:
        raise ValueError("logits have no classes")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    for name, t in rows:
        if tuple(t.shape) != (logits.shape[0],) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({logits.shape[0]},) float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != logits.device:
            raise ValueError(f"{name} is on {t.device}, logits on "
                             f"{logits.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _library():
    lib = _build.load("softmax_ce")
    if lib.softmax_ce_fwd_launch.argtypes is None:
        lib.softmax_ce_fwd_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.softmax_ce_fwd_launch.restype = ctypes.c_int
        lib.softmax_ce_bwd_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.softmax_ce_bwd_launch.restype = ctypes.c_int
        lib.softmax_ce_error_string.argtypes = [ctypes.c_int]
        lib.softmax_ce_error_string.restype = ctypes.c_char_p
    return lib


def _launch(logits, what, fn, *args):
    lib = _library()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        rc = getattr(lib, fn)(_DTYPES[logits.dtype], *args, stream)
    if rc != 0:
        msg = lib.softmax_ce_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def softmax_ce_fwd(logits, labels, ignore_index=-100):
    """Per-row softmax cross-entropy of ``logits (N, V)`` against hard
    ``labels (N,)``: ``(loss, lse)``, both ``(N,)`` float32.

    CPU tensors (or ``plain_versions()``) take the plain version; CUDA
    tensors launch the kernel or raise — there is no fallback."""
    if _route.plain(logits):
        return softmax_ce_fwd_reference(logits, labels, ignore_index)
    _route.require_cuda(logits, "softmax_ce_fwd")
    _check(logits)
    lab = _labels32(logits, labels)
    N, V = logits.shape
    loss = torch.empty(N, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    if N == 0:
        return loss, lse
    _launch(logits, "softmax_ce_fwd", "softmax_ce_fwd_launch",
            logits.data_ptr(), lab.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), N, V, int(ignore_index))
    softmax_ce_fwd.launches += 1
    return loss, lse


softmax_ce_fwd.launches = 0
softmax_ce_fwd.replaces = REPLACES


def softmax_ce_bwd(logits, labels, lse, g, ignore_index=-100):
    """Gradient of the per-row loss ``g (N,)`` float32 with respect to the
    logits: ``(softmax - onehot) * g * valid`` in the logits' type,
    without materialising the softmax.

    CPU tensors (or ``plain_versions()``) take the plain version; CUDA
    tensors launch the kernel or raise — there is no fallback."""
    if _route.plain(logits):
        return softmax_ce_bwd_reference(logits, labels, lse, g, ignore_index)
    _route.require_cuda(logits, "softmax_ce_bwd")
    _check(logits, ("lse", lse), ("g", g))
    lab = _labels32(logits, labels)
    N, V = logits.shape
    dx = torch.empty_like(logits)
    if N == 0:
        return dx
    _launch(logits, "softmax_ce_bwd", "softmax_ce_bwd_launch",
            logits.data_ptr(), lab.data_ptr(), lse.data_ptr(), g.data_ptr(),
            dx.data_ptr(), N, V, int(ignore_index))
    softmax_ce_bwd.launches += 1
    return dx


softmax_ce_bwd.launches = 0
softmax_ce_bwd.replaces = REPLACES_BWD


class _SoftmaxCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, ignore_index):
        ctx.plain = _route.plain(logits)
        ctx.ignore_index = ignore_index
        loss, lse = softmax_ce_fwd(logits, labels, ignore_index)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        bwd = softmax_ce_bwd_reference if ctx.plain else softmax_ce_bwd
        g = g.float().contiguous()
        return bwd(logits, labels, lse, g, ctx.ignore_index), None, None


def softmax_cross_entropy(logits, labels, ignore_index=-100):
    """Differentiable per-row loss ``(N,)`` float32 of ``logits (N, V)``
    against hard ``labels (N,)``, through the kernels (or their plain
    versions, as the wrappers route). Paddle ``Tensor``s come in as plain
    tensors."""
    return _SoftmaxCrossEntropy.apply(plain(logits), plain(labels),
                                      int(ignore_index))
