"""paddle_tpu_torch's gradient-exchange planning and quantization
(``dist.gradcomm``) against the JAX package's, on the CPU, without
processes: ``plan_buckets`` on the JAX tests' parameter lists
(``tests/test_gradcomm.py:90-160``), the flats' round trip, the options'
refusals, ``hash_uniform`` and ``_quantize_rows`` bit for bit, and the
plain ``TrainStep``'s ``run_fused`` accumulation over its one-process
exchange.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.dist import gradcomm as jgc
from paddle_tpu_torch.dist import gradcomm as gc

from torch_test_threads import torch_threads  # noqa: F401,E402

PLANS = [
    # (entries, bucket_bytes, last_bucket_bytes, ndev)
    ([(f"g{i}", (64,), np.float32) for i in range(3)], 512, 512, 8),
    ([(f"g{i}", (64,), np.float32) for i in range(4)], 768, 256, 8),
    ([("small", (8,), np.float32), ("huge", (1024,), np.float32),
      ("tail", (8,), np.float32)], 256, 64, 8),
    ([("a", (32,), np.float32), ("b", (32,), np.float32),
      ("c", (1,), np.float32)], 256, 256, 8),
    ([("w", (3, 5), np.float32), ("s", (), np.float32),
      ("v", (7,), np.float32), ("m", (2, 2, 2), np.float32)], 64, 32, 3),
]


@pytest.mark.parametrize("case", range(len(PLANS)))
def test_plan_buckets_matches(case):
    entries, cap, last, ndev = PLANS[case]
    want = jgc.plan_buckets(entries, jgc.CommOptions(
        bucket_bytes=cap, last_bucket_bytes=last), ndev)
    got = gc.plan_buckets(entries, gc.CommOptions(
        bucket_bytes=cap, last_bucket_bytes=last), ndev)
    assert got.ndev == want.ndev and got.n_buckets == want.n_buckets
    for a, b in zip(got.buckets, want.buckets):
        assert (a.names, a.shapes, a.sizes, a.offsets, a.numel,
                a.padded) == (b.names, b.shapes, b.sizes, b.offsets,
                              b.numel, b.padded)
    with pytest.raises(ValueError):
        gc.plan_buckets([], gc.CommOptions(), ndev)


def test_implicit_plan_is_one_bucket_a_gradient():
    entries = PLANS[4][0]
    plan = gc.implicit_plan(entries, 2)
    assert [b.names for b in plan.buckets] == [(n,) for n, _, _ in entries]
    assert [b.padded for b in plan.buckets] == [16, 2, 8, 8]
    assert plan.options == gc.CommOptions()


def test_flatten_unflatten_roundtrip():
    entries = [("a", (2, 3), np.float32), ("b", (5,), np.float32)]
    plan = gc.plan_buckets(entries, gc.CommOptions(bucket_bytes=1 << 20),
                           ndev=4)
    rng = np.random.RandomState(0)
    local = {"a": torch.from_numpy(rng.randn(2, 3).astype(np.float32)),
             "b": torch.from_numpy(rng.randn(5).astype(np.float32))}
    flats = plan.flatten_local(local)
    assert [tuple(f.shape) for f in flats] == [(plan.buckets[0].padded,)]
    assert plan.buckets[0].padded == 12 and float(flats[0][11]) == 0.0
    out = plan.unflatten(flats, dtypes={"b": torch.bfloat16})
    assert torch.equal(out["a"], local["a"])
    assert out["b"].dtype == torch.bfloat16
    assert torch.equal(out["b"], local["b"].bfloat16())


@pytest.mark.parametrize("kw", [dict(bucket_bytes=0),
                                dict(last_bucket_bytes=-1),
                                dict(accumulate_steps=0),
                                dict(quantize="fp8"),
                                dict(gradient_scale="median")])
def test_option_validation_matches(kw):
    with pytest.raises(ValueError):
        jgc.CommOptions(**kw)
    with pytest.raises(ValueError):
        gc.CommOptions(**kw)
    assert gc.CommOptions().cache_axis() == jgc.CommOptions().cache_axis()


@pytest.mark.parametrize("shape,salt", [
    ((1024,), 7), ((3, 5), 0), ((2, 4097), 123456789),
    ((7, 13), 2 ** 31), ((64,), 2 ** 32 - 1), ((5, 3, 2), 0xA5A5A5A5)])
def test_hash_uniform_is_bitwise_the_jax_one(shape, salt):
    want = np.asarray(jgc.hash_uniform(shape, jnp.uint32(salt)))
    got = gc.hash_uniform(shape, salt).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    t = gc.hash_uniform(shape, torch.tensor(salt, dtype=torch.int64))
    assert torch.equal(t, torch.from_numpy(got))


def test_hash_uniform_row_offset_is_the_lattice_row():
    want = np.asarray(jgc.hash_uniform((3, 10), jnp.uint32(99)))
    for r in range(3):
        got = gc.hash_uniform((1, 10), 99, offset=r * 10).numpy()
        np.testing.assert_array_equal(got[0], want[r])
    salt = gc._bucket_salt(torch.tensor(2 ** 31 + 5), 3)
    jsalt = jnp.uint32(2 ** 31 + 5) * jnp.uint32(0x9E3779B1) + jnp.uint32(3)
    assert int(salt) == int(jsalt)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4])
def test_quantize_rows_is_bitwise_the_jax_one(scale):
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 257) * scale).astype(np.float32)
    x[2] = 0.0                          # a zero row: the 1e-30 floor
    # halves at scale 1 (max 127): round to even
    x[1] = 0.0
    x[1, :5] = [0.5, -0.5, 1.5, 2.5, 127.0]
    noise = np.array(jgc.hash_uniform(x.shape, jnp.uint32(11)))
    noise[1] = 0.0
    jq, js = jgc._quantize_rows(jnp.asarray(x), jnp.asarray(noise))
    q, s = gc._quantize_rows(torch.from_numpy(x), torch.from_numpy(noise))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and q[1, :5].tolist() == [0, 0, 2, 2, 127]


def test_exchange_of_one_process_scales_by_the_window():
    plan = gc.plan_buckets([("a", (6,), np.float32)],
                           gc.CommOptions(accumulate_steps=2), 1)
    flats = [torch.arange(6, dtype=torch.float32)]
    gc.exchange_bucketed(plan, flats)
    assert torch.equal(flats[0], torch.arange(6, dtype=torch.float32) / 2)
    with pytest.raises(ValueError):
        gc.exchange_bucketed(gc.plan_buckets(
            [("a", (6,), np.float32)], gc.CommOptions(quantize="int8"), 1),
            flats)


def test_a_world_of_one_trains_as_train_step():
    """Without a group, ``DistributedTrainStep`` over ``{"data": 1}`` is
    ``TrainStep`` bit for bit (no exchange); the JAX step's refusal of
    comm options below two devices, and the layouts left to item 6b."""
    from paddle_tpu_torch import dist, optim
    from paddle_tpu_torch.framework import TrainStep
    from paddle_tpu_torch.models.nlp import gpt

    cfg = gpt.GPTConfig(vocab_size=64, hidden=32, layers=1, heads=2,
                        max_seq=16, dropout=0.0)

    def make():
        m = gpt.GPT(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
        return m, optim.AdamW(parameters=m.named_parameters(),
                              learning_rate=1e-2)

    ids = np.random.RandomState(0).randint(0, 64, (4, 16))
    batch = (ids, np.roll(ids, -1, 1))
    dist.init_mesh({"data": 1})
    try:
        m, o = make()
        step = dist.DistributedTrainStep(m, o, gpt.gpt_loss)
        m2, o2 = make()
        ref = TrainStep(m2, o2, gpt.gpt_loss)
        for _ in range(3):
            assert torch.equal(step(*batch), ref(*batch))
        assert step.exchanges == 0 and step.last_exchange is None
        for a, b in zip(m.parameters(), m2.parameters()):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match=">= 2 devices"):
            dist.DistributedTrainStep(m, o, gpt.gpt_loss,
                                      comm_options=gc.CommOptions())
        with pytest.raises(NotImplementedError, match="6b"):
            dist.DistributedTrainStep(m, o, gpt.gpt_loss,
                                      batch_specs=[None, None])
        with pytest.raises(NotImplementedError, match="6b"):
            dist.shard_tensor(torch.zeros(2), spec=("data",))
    finally:
        dist.set_mesh(None)
