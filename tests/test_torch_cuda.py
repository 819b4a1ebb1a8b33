"""paddle_tpu_torch on the card: the CUDA kernel and the engine on CUDA.

Every test here needs a Hopper card and skips without one (the
decision is made inside the ``hopper`` fixture). The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: 2e-5 (atol and rtol) for float32 pools, 2e-2 for bfloat16
pools, kernel against its plain PyTorch version on the same inputs.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.serving import (ManualClock, PagedKVCache,
                                      Scheduler, ServeEngine, TinyLM)

pytestmark = pytest.mark.cuda

F32_TOL = 2e-5
BF16_TOL = 2e-2


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) card")
    return torch.device("cuda")


def _inputs(lengths, H, D, page, P, W, pool_dtype, device, seed=0):
    """Random pools, shuffled distinct pages per lane, tail entries 0."""
    g = torch.Generator().manual_seed(seed)
    B = len(lengths)
    q = torch.randn(B, H, D, generator=g)
    k = torch.randn(P, page, H, D, generator=g).to(pool_dtype)
    v = torch.randn(P, page, H, D, generator=g).to(pool_dtype)
    perm = torch.randperm(P - 1, generator=g) + 1
    table = torch.zeros(B, W, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lengths):
        need = -(-n // page)
        table[b, :need] = perm[used:used + need].int()
        used += need
    lengths = torch.tensor(lengths, dtype=torch.int32)
    return tuple(t.to(device) for t in (q, k, v, table, lengths))


@pytest.mark.parametrize("pool_dtype, tol", [(torch.float32, F32_TOL),
                                             (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("geom", [
    # (lengths, H, D, page, P, W)
    ([1, 7, 8, 23, 0], 2, 8, 8, 32, 5),
    ([0, 1, 15, 16, 17, 2000], 12, 64, 16, 512, 128),
])
def test_kernel_matches_plain_version(hopper, geom, pool_dtype, tol):
    lengths, H, D, page, P, W = geom
    args = _inputs(lengths, H, D, page, P, W, pool_dtype, hopper)
    before = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 1
    ref = pa.paged_decode_attention_reference(*args)
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
    zero = args[4] == 0
    assert torch.all(out[zero] == 0)


def test_kernel_raises_on_cuda_instead_of_falling_back(hopper):
    args = _inputs([3], 2, 8, 4, 8, 1, torch.float32, hopper)
    bad = (args[0].double(),) + args[1:]
    with pytest.raises(ValueError):
        pa.paged_decode_attention(*bad)


def test_engine_on_card_matches_its_oracle(hopper):
    model = TinyLM(vocab_size=64, num_heads=2, head_dim=8, seed=0)
    cache = PagedKVCache(6, 4, 2, 8, max_seq_len=16)
    assert model.embedding.device.type == "cuda"
    assert cache.k_pages.device.type == "cuda"
    clock = ManualClock()
    eng = ServeEngine(model, cache, scheduler=Scheduler(
        cache, token_budget=64, clock=clock))
    rng = np.random.RandomState(2)
    pairs = []
    for _ in range(3):
        prompt = list(rng.randint(0, 64, 5))
        pairs.append((eng.submit(prompt, max_new_tokens=8), prompt))
        clock.advance(0.01)
    before = pa.paged_decode_attention.launches
    eng.run(max_steps=300)
    assert eng.scheduler.preemptions >= 1
    assert pa.paged_decode_attention.launches - before == \
        eng.usage.decode_steps > 0
    for r, prompt in pairs:
        assert r.generated == model.reference_generate(prompt, 8)
    assert cache.stats()["used_pages"] == 0 and cache.verify()
