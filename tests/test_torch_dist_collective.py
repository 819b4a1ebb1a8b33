"""paddle_tpu_torch's collectives and gradient exchange across processes
against the JAX package's, on the CPU.

The port's ranks run in child processes (``tests/torch_dist_ranks.py``:
a gloo group over a ``FileStore``, one spawn a world size, both started
before the JAX side runs); the JAX side runs here on a mesh of the first
n of the 8 CPU devices. Rank r holds rows [r*k, (r+1)*k) of the JAX
package's global array, so the concatenation of the ranks' results is
the JAX result (``all_gather`` returns the whole array on every rank,
as the JAX eager call returns the global array).

Tolerances: sums, maxima and minima exactly where each element is one
reduction of the same values in rank order (float32 sums of two values
are one rounding; at four ranks the order may differ: 1e-6 relative);
the product within 1e-5 relative (the JAX package takes it as the
exponential of summed logarithms); the fp32 exchange within one float32
spacing; the int8 exchange's reduced values within one phase-2
quantization step of the JAX ones (max |chunk| / 127 of that rank's
chunk) and its residuals within one phase-1 step (max |c_r| / 127).
"""
import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu as jpt
from paddle_tpu import distributed as jdist
from paddle_tpu.dist import gradcomm as jgc

import torch_dist_ranks as ranks
from torch_test_threads import torch_threads  # noqa: F401,E402

WORLDS = (2, 4)
EXCHANGE_F = 96


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_collective")
    procs = {(s, w): ranks.start(s, w, d)
             for s, w in [("collectives", 2), ("collectives", 4),
                          ("exchange", 2)]}
    return {k: ranks.collect(p, k[0], k[1], d) for k, p in procs.items()}


@pytest.fixture
def mesh():
    made = []

    def make(n):
        made.append(jdist.init_mesh({"data": n}, devices=jax.devices()[:n]))
        return made[-1]

    yield make
    jdist.set_mesh(None)


def _cat(res, key):
    return np.concatenate([a[key] for a, _ in res])


def _jax(fn, x):
    out = fn(jpt.to_tensor(x))
    return np.asarray(out._data if hasattr(out, "_data") else out)


@pytest.mark.parametrize("world", WORLDS)
def test_reductions_match(ran, mesh, world):
    mesh(world)
    res = ran["collectives", world]
    g = ranks.collective_inputs(world)
    tol = dict(rtol=0, atol=0) if world == 2 else dict(rtol=1e-6, atol=0)
    for op in ("sum", "max", "min"):
        want = _jax(lambda t: jdist.all_reduce(t, op=op), g["x"])
        np.testing.assert_allclose(_cat(res, f"all_reduce_{op}"), want,
                                   **tol)
    want = _jax(lambda t: jdist.all_reduce(t, op=jdist.ReduceOp.PROD),
                g["prod"])
    np.testing.assert_allclose(_cat(res, "all_reduce_prod"), want,
                               rtol=1e-5)
    want = _jax(jdist.all_reduce, g["ints"])
    np.testing.assert_array_equal(_cat(res, "all_reduce_ints"), want)
    want = _jax(jdist.reduce, g["x"])
    np.testing.assert_allclose(_cat(res, "reduce"), want, **tol)


@pytest.mark.parametrize("world", WORLDS)
def test_moves_match(ran, mesh, world):
    mesh(world)
    res = ran["collectives", world]
    g = ranks.collective_inputs(world)
    for a, meta in res:
        np.testing.assert_array_equal(a["all_gather"],
                                      _jax(jdist.all_gather, g["x"]))
        jparts = jdist.all_gather([], jpt.to_tensor(g["x"]))
        assert meta["all_gather_list_len"] == len(jparts) == world
        for i, p in enumerate(jparts):
            np.testing.assert_array_equal(a[f"all_gather_list_{i}"],
                                          np.asarray(p._data))
    tol = dict(rtol=0, atol=0) if world == 2 else dict(rtol=1e-6, atol=0)
    np.testing.assert_allclose(_cat(res, "reduce_scatter"),
                               _jax(jdist.reduce_scatter, g["rs"]), **tol)
    np.testing.assert_array_equal(
        _cat(res, "broadcast"),
        _jax(lambda t: jdist.broadcast(t, src=world - 1), g["x"]))
    np.testing.assert_array_equal(_cat(res, "all_to_all"),
                                  _jax(jdist.all_to_all, g["a2a"]))
    ring = [(i, (i + 1) % world) for i in range(world)]
    np.testing.assert_array_equal(
        _cat(res, "ppermute"), _jax(lambda t: jdist.ppermute(t, ring),
                                    g["x"]))
    np.testing.assert_array_equal(_cat(res, "scatter"),
                                  _jax(jdist.scatter, g["x"]))
    parts = [jpt.to_tensor(c) for c in np.split(g["x"], world)]
    np.testing.assert_array_equal(_cat(res, "scatter_list"),
                                  np.asarray(jdist.scatter(None, parts)))


@pytest.mark.parametrize("world", WORLDS)
def test_scalar_identity_and_indivisible_dims(ran, mesh, world):
    mesh(world)
    res = ran["collectives", world]
    s = jpt.to_tensor(np.float32(3.0))
    assert float(np.asarray(jdist.all_reduce(s)._data)) == 3.0
    for r, (a, meta) in enumerate(res):
        assert float(a["all_reduce_scalar"]) == r + 1
        assert meta["reduce_scatter_odd"] == "ValueError"
        assert meta["all_to_all_odd"] == "ValueError"
    odd = ranks.collective_inputs(world)["odd"][:world + 1]
    with pytest.raises(ValueError):
        jdist.all_to_all(jpt.to_tensor(odd))
    with pytest.raises(ValueError):
        jdist.reduce_scatter(jpt.to_tensor(odd))


@pytest.mark.parametrize("world", WORLDS)
def test_group_environment(ran, world):
    for r, (_, meta) in enumerate(ran["collectives", world]):
        assert (meta["world"], meta["rank"], meta["backend"]) == \
            (world, r, "gloo")
        stats = meta["stats"]
        assert stats["all_reduce"] == 6 and stats["all_to_all"] == 1
        assert stats["reduce_scatter"] == 1
        assert stats["bytes"] > 0


def _jax_exchange(quantize, world):
    m = jdist.init_mesh({"data": world}, devices=jax.devices()[:world])
    flats, resid, salt = ranks.exchange_inputs(world, EXCHANGE_F)
    entries = [("a", (EXCHANGE_F,), np.float32),
               ("b", (EXCHANGE_F // 2,), np.float32)]
    plan = jgc.plan_buckets(
        entries, jgc.CommOptions(bucket_bytes=EXCHANGE_F * 4,
                                 last_bucket_bytes=EXCHANGE_F * 4,
                                 quantize=quantize), world)
    sh = NamedSharding(m, P("data", None))
    fl = [jax.device_put(f, sh) for f in flats]
    rs = [jax.device_put(r, sh) for r in resid]
    fn = jax.jit(lambda f, r: jgc.exchange_bucketed(
        plan, f, m, residuals=r if quantize else None,
        salt=np.uint32(salt) if quantize else None))
    red, new = fn(fl, rs)
    return ([np.asarray(x) for x in red],
            None if new is None else [np.asarray(x) for x in new],
            flats, resid)


def test_fp32_exchange_within_one_spacing(ran, mesh):
    red, _, _, _ = _jax_exchange(None, 2)
    for r, (a, _) in enumerate(ran["exchange", 2]):
        for i, want in enumerate(red):
            got = a[f"None_reduced_{i}"]
            assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))


def test_int8_exchange_within_one_quantization_step(ran, mesh):
    red, new, flats, resid = _jax_exchange("int8", 2)
    n = 2
    for r, (a, _) in enumerate(ran["exchange", 2]):
        for i, want in enumerate(red):
            got = a[f"int8_reduced_{i}"]
            for c in np.split(np.arange(want.size), n):
                step = np.abs(want[c]).max() / 127 * (1 + 1e-6)
                assert np.abs(got[c] - want[c]).max() <= step
            c_r = flats[i][r] / n + resid[i][r]
            step1 = np.abs(c_r).max() / 127 * (1 + 1e-6)
            assert np.abs(a[f"int8_resid_{i}"] - new[i][r]).max() <= step1
            assert np.abs(a[f"int8_resid_{i}"]).max() > 0
