"""Ragged paged decode attention: the CUDA kernel and its plain version.

The serving path keeps every sequence's K/V history in fixed-size pages
scattered across one preallocated pool (``serving.kv_cache``), so a
decode query must gather its K/V through a per-sequence page table, and
the batch is ragged (every sequence has its own context length). One
kernel serves the whole mixed batch with no padding to the longest
context.

- ``paged_decode_attention``: the wrapper. On CUDA tensors it launches
  the hand-written kernel of ``csrc/paged_attention.cu`` (and raises if
  it cannot); on CPU tensors it runs the plain version. It counts its
  kernel launches in ``paged_decode_attention.launches``.
- ``paged_decode_attention_reference``: the plain PyTorch version — a
  gather of every table entry plus a masked softmax, in float32.
- ``dense_decode_reference``: masked dense decode attention over
  contiguous histories, the oracle both are held against (and the
  engine's prefill attention).

It replaces the Pallas kernel ``_decode_kernel`` of
``paddle_tpu/ops/pallas/paged_attention.py``; the source note in the
``.cu`` file gives the kernel's design and its bound on an H100.

Layouts: q ``(B, H, D)`` (one decode token per sequence); k/v pools
``(P, page_size, H, D)``; page_table ``(B, max_pages)`` int32; lengths
``(B,)`` int32 (tokens already *in* the cache that this query attends
over, query included).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _route
from ...core.tensor import plain

__all__ = ["paged_decode_attention", "paged_decode_attention_reference",
           "dense_decode_reference", "check_kernel_args", "SOURCE",
           "REPLACES"]

NEG_INF = -1e30
MAX_HEAD_DIM = 256
MAX_SMEM_BYTES = 232448   # a block's shared memory on sm_90
# the kernel splits each lane's live pages into chunks of this many
# tokens' pages (csrc/paged_attention.cu), and gives a CTA the warps of
# this many heads of one chunk: the fastest of 64-1024 tokens and 1-12
# heads at the serving width on an H100 (tools/torch_paged_sweep.py)
CHUNK_TOKENS = 256
HEADS_PER_CTA = 4
SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
REPLACES = "paddle_tpu/ops/pallas/paged_attention.py:46"

_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def chunk_pages(page):
    """Pages in one chunk of the kernel's split: a function of the page
    size alone, so the chunks, and the output's bits, do not depend on
    the lengths."""
    return max(1, CHUNK_TOKENS // page)


def _scale(D, scale):
    return float(scale) if scale is not None else 1.0 / (D ** 0.5)


def paged_decode_attention_reference(q, k_pages, v_pages, page_table,
                                     lengths, *, scale=None):
    """Plain PyTorch version of the kernel: gather every table entry's
    page, mask positions at or past each length, softmax in float32.
    A zero-length lane yields zeros (no live key: the normaliser is
    guarded by ``max(l, 1e-30)`` as in the kernel). Returns q's dtype."""
    B, H, D = q.shape
    P, page = k_pages.shape[0], k_pages.shape[1]
    W = page_table.shape[1]
    table = page_table.long().clamp(0, P - 1)
    k = k_pages[table].float().reshape(B, W * page, H, D)
    v = v_pages[table].float().reshape(B, W * page, H, D)
    qf = q.float() * _scale(D, scale)
    s = torch.einsum("bhd,blhd->bhl", qf, k)
    pos = torch.arange(W * page, device=q.device)
    live = (pos[None, :] < lengths.long()[:, None])[:, None, :]  # (B,1,L)
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)        # (B,H,1)
    return (torch.einsum("bhl,blhd->bhd", p, v) / l).to(q.dtype)


def dense_decode_reference(q, k, v, lengths=None):
    """Masked dense decode attention in float32 — the oracle the paged
    kernel is pinned against. ``k``/``v`` are ``(B, L, H, D)``
    contiguous histories (L >= every length); ``lengths (B,)`` masks
    the ragged tails (None = all L live)."""
    B, H, D = q.shape
    L = k.shape[1]
    qf = q.float() / (D ** 0.5)
    s = torch.einsum("bhd,blhd->bhl", qf, k.float())
    if lengths is not None:
        pos = torch.arange(L, device=q.device)
        mask = pos[None, None, :] < lengths.long()[:, None, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhl,blhd->bhd", w, v.float()).to(q.dtype)


def check_kernel_args(q, k_pages, v_pages, page_table, lengths):
    """Raise ``ValueError`` on anything the CUDA kernel does not take:
    q float32 ``(B, H, D)`` with D <= 256; pools float32, bfloat16 or float16
    ``(P, page, H, D)`` of one type; int32 ``(B, W)`` table and ``(B,)``
    lengths; all contiguous and on q's device; one page's K and V in
    float32 within a block's shared memory (the kernel itself keeps no
    page in shared memory; the limit keeps the accepted shapes fixed)."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, D), got {tuple(q.shape)}")
    B, H, D = q.shape
    if q.dtype != torch.float32:
        raise ValueError(f"q must be float32, got {q.dtype}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} outside 1..{MAX_HEAD_DIM}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape or \
            tuple(k_pages.shape[2:]) != (H, D):
        raise ValueError(
            f"pools must both be (P, page, {H}, {D}), got "
            f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    if k_pages.dtype not in _POOL_DTYPES or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"pools must be float32, bfloat16 or float16 of "
                         f"one type, "
                         f"got {k_pages.dtype} and {v_pages.dtype}")
    if page_table.dim() != 2 or page_table.shape[0] != B or \
            tuple(lengths.shape) != (B,):
        raise ValueError(
            f"page_table must be ({B}, W) and lengths ({B},), got "
            f"{tuple(page_table.shape)} and {tuple(lengths.shape)}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page_table and lengths must be int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    page = k_pages.shape[1]
    smem = 4 * (D + 2 * page * D + page)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"page_size {page} x head_dim {D} needs {smem} B "
                         f"of shared memory > {MAX_SMEM_BYTES}")


def _library():
    lib = _build.load("paged_attention")
    fn = lib.paged_decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.paged_decode_attention_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           scale=None):
    """Decode attention for ragged sequences through a paged KV pool.

    q: ``(B, H, D)``; k_pages/v_pages: ``(P, page_size, H, D)`` pools;
    page_table: ``(B, max_pages)`` page ids per sequence (entries past a
    sequence's last live page are never read; ids are clamped to the
    pool); lengths: ``(B,)`` context length per sequence (the query's
    own position is ``lengths - 1``). Returns ``(B, H, D)`` in q's dtype.

    CPU tensors (or ``plain_versions()``) take the plain version; CUDA
    tensors launch the kernel or raise — there is no fallback between
    the two. Paddle ``Tensor``s come in as plain tensors."""
    q, k_pages, v_pages, page_table, lengths = (
        plain(t) for t in (q, k_pages, v_pages, page_table, lengths))
    if _route.plain(q):
        return paged_decode_attention_reference(
            q, k_pages, v_pages, page_table, lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    check_kernel_args(q, k_pages, v_pages, page_table, lengths)
    B, H, D = q.shape
    P, page = k_pages.shape[0], k_pages.shape[1]
    W = page_table.shape[1]
    out = torch.empty_like(q)
    if B == 0 or W == 0:
        return out.zero_()
    cp = chunk_pages(page)
    chunks = -(-W // cp)
    # each chunk's (acc, m, l), combined by the second kernel
    part = torch.empty(B, H, chunks, D + 2, dtype=torch.float32,
                       device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode_attention_launch(
            _POOL_DTYPES[k_pages.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part.data_ptr(), B, H, D, P, page, W, cp,
            chunks, min(HEADS_PER_CTA, H), _scale(D, scale), stream)
    if rc != 0:
        msg = lib.paged_decode_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {rc} ({msg})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.replaces = REPLACES
