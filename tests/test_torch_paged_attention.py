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
        (lambda a: (a[0], a[1].half(), a[2].half()) + a[3:], "bfloat16"),
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

