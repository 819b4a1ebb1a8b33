"""paddle_tpu_torch paged decode attention against the JAX package.

The same numpy inputs, made from a seed, go through the JAX Pallas
kernel (``interpret=True``, as the JAX package's own tests run it on the
CPU) and the port's plain PyTorch version — which is what the port's
wrapper runs for CPU tensors. Tolerances: 2e-5 (atol and rtol) with
float32 pools, where the two differ only in summation order; 2e-2 with
bfloat16 pools, a bound at bf16 resolution (both sides read the same
bf16 values and compute in float32, so they agree far closer than it).

The CUDA kernel itself runs only on an H100: its tests are in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import paged_attention as jax_pa
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import paged_attention as pa

from torch_test_threads import torch_threads  # noqa: F401,E402

F32_TOL = 2e-5
BF16_TOL = 2e-2

# the ragged cases of tests/test_serving.py, each with a zero-length
# lane appended (a padded batch lane)
RAGGED = [
    [1, 7, 8, 23, 0],     # single token, page-1 edge, crossing
    [16, 16, 16, 16, 0],  # uniform, exact page multiples
    [3, 40, 9, 1, 0],     # long vs short mix
]


def _case(lengths, seed=0, H=2, D=16, page=8, P=32, maxp=5):
    """Dense histories scattered into shuffled pages of one pool."""
    rng = np.random.RandomState(seed)
    B = len(lengths)
    lengths = np.asarray(lengths, np.int32)
    L = maxp * page
    k_dense = rng.randn(B, L, H, D).astype(np.float32)
    v_dense = rng.randn(B, L, H, D).astype(np.float32)
    q = rng.randn(B, H, D).astype(np.float32)
    k_pages = np.zeros((P, page, H, D), np.float32)
    v_pages = np.zeros((P, page, H, D), np.float32)
    table = np.zeros((B, maxp), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        for p in range(-(-int(lengths[b]) // page)):
            pid = free.pop()
            table[b, p] = pid
            lo = p * page
            hi = min(lo + page, int(lengths[b]))
            k_pages[pid, :hi - lo] = k_dense[b, lo:hi]
            v_pages[pid, :hi - lo] = v_dense[b, lo:hi]
    # a zero-length lane's table points at live pages: it must still
    # read nothing
    table[lengths == 0] = table[int(np.argmax(lengths))]
    return dict(q=q, k_pages=k_pages, v_pages=v_pages, table=table,
                lengths=lengths, k_dense=k_dense, v_dense=v_dense)


def _jax_kernel(c, pool_dtype=jnp.float32):
    out = jax_pa.paged_decode_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k_pages"], pool_dtype),
        jnp.asarray(c["v_pages"], pool_dtype), jnp.asarray(c["table"]),
        jnp.asarray(c["lengths"]), interpret=True)
    return np.asarray(out, np.float32)


def _torch_args(c, pool_dtype=torch.float32, device="cpu"):
    t = {k: torch.from_numpy(c[k]).to(device)
         for k in ("q", "k_pages", "v_pages", "table", "lengths")}
    t["k_pages"] = t["k_pages"].to(pool_dtype)
    t["v_pages"] = t["v_pages"].to(pool_dtype)
    return (t["q"], t["k_pages"], t["v_pages"], t["table"], t["lengths"])


class TestPlainVersionMatchesJaxKernel:
    @pytest.mark.parametrize("lengths", RAGGED)
    def test_f32_ragged_shuffled_pages(self, lengths):
        c = _case(lengths)
        out = pa.paged_decode_attention_reference(*_torch_args(c))
        np.testing.assert_allclose(out.numpy(), _jax_kernel(c),
                                   atol=F32_TOL, rtol=F32_TOL)
        # the zero-length lane is exactly zero on both sides
        assert np.all(out.numpy()[-1] == 0.0)
        assert np.all(_jax_kernel(c)[-1] == 0.0)

    def test_bf16_pools(self):
        c = _case([5, 17, 0, 33], seed=3)
        out = pa.paged_decode_attention_reference(
            *_torch_args(c, torch.bfloat16))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(),
                                   _jax_kernel(c, jnp.bfloat16),
                                   atol=BF16_TOL, rtol=BF16_TOL)

    @pytest.mark.parametrize("lengths", RAGGED)
    def test_matches_dense_references(self, lengths):
        c = _case(lengths, seed=1)
        out = pa.paged_decode_attention_reference(*_torch_args(c))
        live = np.asarray(lengths) > 0
        dense = pa.dense_decode_reference(
            torch.from_numpy(c["q"]), torch.from_numpy(c["k_dense"]),
            torch.from_numpy(c["v_dense"]),
            torch.from_numpy(c["lengths"])).numpy()
        jax_dense = np.asarray(jax_pa.dense_decode_reference(
            jnp.asarray(c["q"]), jnp.asarray(c["k_dense"]),
            jnp.asarray(c["v_dense"]), jnp.asarray(c["lengths"])))
        np.testing.assert_allclose(dense, jax_dense, atol=F32_TOL,
                                   rtol=F32_TOL)
        np.testing.assert_allclose(out.numpy()[live], dense[live],
                                   atol=F32_TOL, rtol=F32_TOL)

    def test_out_of_range_table_entries_are_clamped(self):
        c = _case([9, 3], seed=2)
        ref = pa.paged_decode_attention_reference(*_torch_args(c))
        bad = dict(c, table=c["table"].copy())
        bad["table"][0, 2:] = 999         # past the live pages: never read
        bad["table"][1, 1:] = -7
        out = pa.paged_decode_attention_reference(*_torch_args(bad))
        np.testing.assert_array_equal(out.numpy(), ref.numpy())
        np.testing.assert_allclose(out.numpy(), _jax_kernel(bad),
                                   atol=F32_TOL, rtol=F32_TOL)


def _fold_chunk(qs, k_pages, v_pages, trow, t0, t1, n, stage):
    """One warp of the chunk kernel, for all heads at once: tokens
    [t0, t1) of a lane whose length is ``n``, folded ``stage`` tokens at
    a time with the online softmax's rescale into float32 (m, l, acc)."""
    P, page = k_pages.shape[:2]
    H, D = qs.shape
    m = torch.full((H,), pa.NEG_INF)
    l, acc = torch.zeros(H), torch.zeros(H, D)
    for s0 in range(t0, t1, stage):
        t = torch.arange(s0, min(s0 + stage, t1))
        pid = trow[t // page].long().clamp(0, P - 1)
        k = k_pages[pid, t % page].float()              # (T, H, D)
        v = v_pages[pid, t % page].float()
        live = (t < n)[None, :]
        sc = torch.where(live, torch.einsum("hd,thd->ht", qs, k),
                         torch.tensor(pa.NEG_INF))
        m_new = torch.maximum(m, sc.max(dim=1).values)
        p = torch.where(live, torch.exp(sc - m_new[:, None]),
                        torch.tensor(0.0))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=1)
        acc = acc * alpha[:, None] + torch.einsum("ht,thd->hd", p, v)
        m = m_new
    return m, l, acc


def _combine(parts, H, D):
    """The combine kernel: chunks folded in order against their largest
    m; zeros through the max(l, 1e-30) guard where there is none."""
    M = torch.full((H,), pa.NEG_INF)
    for m, _, _ in parts:
        M = torch.maximum(M, m)
    l, acc = torch.zeros(H), torch.zeros(H, D)
    for m, lc, ac in parts:
        w = torch.exp(m - M)
        l = l + w * lc
        acc = acc + w[:, None] * ac
    return acc / l.clamp_min(1e-30)[:, None]


def _chunked_decode(q, k_pages, v_pages, table, lengths, cp, stage=16):
    """The kernel's split in plain torch: each lane's live pages
    (min(ceil(len / page), W)) cut into chunks of ``cp`` pages, each
    folded on its own, then combined in chunk order."""
    B, H, D = q.shape
    page, W = k_pages.shape[1], table.shape[1]
    qs = q.float() / D ** 0.5
    out = torch.zeros(B, H, D)
    for b in range(B):
        n = int(lengths[b])
        live_pages = min(-(-n // page), W)
        parts = [_fold_chunk(qs[b], k_pages, v_pages, table[b], p0 * page,
                             min(p0 + cp, live_pages) * page, n, stage)
                 for p0 in range(0, live_pages, cp)]
        out[b] = _combine(parts, H, D)
    return out


class TestChunkedSplit:
    """The chunk kernel's arithmetic (a split over pages, an online
    softmax per chunk, a combine in chunk order), emulated in plain torch
    and held to the plain version within F32_TOL."""

    @pytest.mark.parametrize("cp", [1, 2, 3, 5])
    @pytest.mark.parametrize("lengths", RAGGED)
    def test_chunk_sizes_that_do_and_do_not_divide_the_pages(self, lengths,
                                                             cp):
        args = _torch_args(_case(lengths))
        out = _chunked_decode(*args, cp=cp, stage=4)
        np.testing.assert_allclose(
            out.numpy(), pa.paged_decode_attention_reference(*args).numpy(),
            atol=F32_TOL, rtol=F32_TOL)
        assert np.all(out.numpy()[-1] == 0.0)        # the zero-length lane

    @pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
    def test_the_kernels_chunk_size_across_chunk_edges(self, pool_dtype):
        """Page 16 with the kernel's chunk: exactly one chunk, one token
        past it, a 2049-token lane (a last chunk of one live token), and
        a lane of length 0."""
        page = 16
        cp = pa.chunk_pages(page)
        one = cp * page
        lengths = [one, one + 1, 2049, 0, 7]
        c = _case(lengths, seed=4, H=2, D=8, page=page, P=400,
                  maxp=-(-2049 // page))
        args = _torch_args(c, pool_dtype)
        out = _chunked_decode(*args, cp=cp)
        ref = pa.paged_decode_attention_reference(*args)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=F32_TOL,
                                   rtol=F32_TOL)
        assert np.all(out.numpy()[3] == 0.0)

    def test_table_narrower_than_the_lengths(self):
        """W < ceil(len / page): only the table's W pages are read, all
        of their positions live."""
        c = _case([40, 23, 9], seed=5)
        c["table"] = np.ascontiguousarray(c["table"][:, :2])
        args = _torch_args(c)
        for cp in (1, 3):
            np.testing.assert_allclose(
                _chunked_decode(*args, cp=cp, stage=4).numpy(),
                pa.paged_decode_attention_reference(*args).numpy(),
                atol=F32_TOL, rtol=F32_TOL)

    def test_a_chunk_with_no_live_token_adds_nothing(self):
        c = _case([20, 3], seed=6)
        q, kp, vp, table, _ = _torch_args(c)
        qs = q[0].float() / q.shape[-1] ** 0.5
        parts = [_fold_chunk(qs, kp, vp, table[0], 0, 16, 20, 4)]
        empty = _fold_chunk(qs, kp, vp, table[0], 16, 24, 16, 4)
        assert torch.all(empty[0] == pa.NEG_INF)
        assert torch.all(empty[1] == 0) and torch.all(empty[2] == 0)
        torch.testing.assert_close(_combine(parts + [empty], 2, 16),
                                   _combine(parts, 2, 16), atol=0, rtol=0)
        assert torch.all(_combine([empty], 2, 16) == 0)


class TestWrapper:
    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self):
        c = _case([4, 0, 12])
        kernels.reset_launches()
        out = pa.paged_decode_attention(*_torch_args(c))
        ref = pa.paged_decode_attention_reference(*_torch_args(c))
        np.testing.assert_array_equal(out.numpy(), ref.numpy())
        assert kernels.launches() == dict.fromkeys(kernels.KERNELS, 0)

    @pytest.mark.parametrize("change, match", [
        (lambda a: (a[0].to(torch.bfloat16),) + a[1:], "q must be float32"),
        (lambda a: (a[0][..., :0],) + a[1:], "head_dim"),
        (lambda a: a[:3] + (a[3].long(), a[4]), "int32"),
        (lambda a: (a[0], a[1], a[2][..., :4], a[3], a[4]), "pools"),
        (lambda a: (a[0], a[1].double(), a[2].double()) + a[3:], "float16"),
        (lambda a: a[:3] + (a[3].t().contiguous().t(), a[4]), "contiguous"),
        (lambda a: a[:4] + (a[4][:1],), r"lengths \(3,\)"),
    ])
    def test_kernel_argument_checks(self, change, match):
        args = change(_torch_args(_case([4, 0, 12])))
        with pytest.raises(ValueError, match=match):
            pa.check_kernel_args(*args)

    def test_kernel_limits(self):
        q = torch.zeros(1, 1, 512)
        pool = torch.zeros(2, 4, 1, 512)
        tab, ln = torch.zeros(1, 1, dtype=torch.int32), \
            torch.zeros(1, dtype=torch.int32)
        with pytest.raises(ValueError, match="head_dim 512"):
            pa.check_kernel_args(q, pool, pool, tab, ln)
        q = torch.zeros(1, 1, 256)
        pool = torch.zeros(2, 128, 1, 256)      # 256 KiB of K+V per page
        with pytest.raises(ValueError, match="shared memory"):
            pa.check_kernel_args(q, pool, pool, tab, ln)
        small = pool[:, :16].contiguous()
        pa.check_kernel_args(q, small, small, tab, ln)


class TestBuild:
    def test_nvcc_command_targets_sm90a_shared_library(self):
        src = _build.SOURCES["paged_attention"]
        cmd = _build.nvcc_command("nvcc", src, "/x/lib.so")
        joined = " ".join(cmd)
        assert "-gencode arch=compute_90a,code=sm_90a" in joined
        for flag in ("-O3", "-shared", "-Xcompiler -fPIC", "-std=c++17"):
            assert flag in joined
        assert cmd[-1] == str(src) and src.is_file()

    def test_library_is_named_by_source_digest_under_build(self):
        path = _build.library_path("paged_attention")
        assert path.parent == _build.BUILD_DIR
        assert path.parent.parts[-2:] == ("build", "paddle_tpu_torch")
        assert path == _build.library_path("paged_attention")

    def test_library_path_follows_the_headers_a_source_includes(
            self, tmp_path, monkeypatch):
        """An edited header gives a new library path (so a stale library
        is never loaded); an unrelated file beside it does not. Works on
        a copy of flash_attention.cu and the header it includes."""
        src = _build.SOURCES["flash_attention"]
        header = src.parent / "mma_bf16.cuh"
        assert [p.name for p in _build.source_files(src)] == [
            "flash_attention.cu", "mma_bf16.cuh"]
        for p in (src, header):
            (tmp_path / p.name).write_bytes(p.read_bytes())
        monkeypatch.setitem(_build.SOURCES, "flash_attention",
                            tmp_path / src.name)
        before = _build.library_path("flash_attention")
        (tmp_path / "unrelated.cuh").write_text("// not included\n")
        assert _build.library_path("flash_attention") == before
        copy = tmp_path / header.name
        copy.write_bytes(copy.read_bytes() + b"// edited\n")
        after = _build.library_path("flash_attention")
        assert after != before and after.parent == before.parent

    def test_source_exports_what_the_wrapper_binds(self):
        src = _build.SOURCES["paged_attention"].read_text()
        assert 'extern "C"' in src
        for sym in ("paged_decode_attention_launch",
                    "paged_decode_attention_error_string",
                    "__nv_bfloat16", "cudaGetLastError"):
            assert sym in src

