"""Data-parallel training of the port's tiny GPT at two ranks against the
JAX package's ``DistributedTrainStep`` on a 2-device mesh, on the CPU.

``tests/test_torch_gpt.py``'s configuration (vocab 512, hidden 128, 2
layers, 2 heads, 128 positions), float32, dropout 0, the JAX package's
weights from seed 0 (its tensor-parallel marks cleared: the JAX
explicit exchange needs replicated parameters, and a pure ``data`` mesh
has no ``model`` axis) carried across with ``convert.gpt_params_from_jax``,
8 global batches of 8 x 128 ids from RandomState(0), AdamW(3e-3) with
global-norm clip 1.0. The port's two ranks run in child processes
(``tests/torch_dist_ranks.py``'s ``train`` scenario), started before the
JAX runs.

Held: the implicit and the bucketed trajectories within ``LOSS_TOL``
(``tests/test_torch_gpt.py``'s) of the JAX ones; in the port, bucketed
= implicit bitwise (two ranks: each element one addition of two
terms, whatever the buckets) in losses, parameters and moments, and
strictly fewer all-reduces a step; the replicas bitwise equal; int8
within the JAX test's bound (rtol 0.05, atol 0.02,
``tests/test_gradcomm.py:228-233``) of the JAX int8 run, its residuals
nonzero and its salt counter at the step count; the int8 state through
``state_dict``/``set_state_dict`` and through ``framework.io``'s
checkpoint continuing bitwise as the unbroken run; and each error the
JAX step raises.
"""
import os
import warnings

import numpy as np
import pytest

import jax

import paddle_tpu as jpt
from paddle_tpu import amp as jamp
from paddle_tpu import distributed as jdist
from paddle_tpu import optim as joptim
from paddle_tpu.dist import gradcomm as jgc
from paddle_tpu.models.nlp import gpt as jgpt
from paddle_tpu_torch import convert

import torch_dist_ranks as ranks
from torch_test_threads import torch_threads  # noqa: F401,E402

LOSS_TOL = 5e-5          # tests/test_torch_gpt.py
INT8_RTOL, INT8_ATOL = 0.05, 0.02


def jax_model():
    """The JAX GPT from seed 0, its tensor-parallel marks cleared."""
    jpt.seed(0)
    jm = jgpt.GPT(jgpt.GPTConfig(**ranks.GPT_CFG))
    for p in jm.parameters():
        p.sharding_spec = None
    return jm


def jax_opt(jm):
    return joptim.AdamW(parameters=jm.parameters(),
                        learning_rate=ranks.GPT_LR,
                        grad_clip=joptim.ClipGradByGlobalNorm(1.0))


def write_init(d):
    jm = jax_model()
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    port = convert.gpt_params_from_jax(sd)
    np.savez(os.path.join(d, "gpt_init.npz"),
             **{k: v.numpy() for k, v in port.items()})


def jax_mesh(axes=None):
    return jdist.init_mesh(axes or {"data": 2}, devices=jax.devices()[:2])


def jax_run(comm=None, wrap=None):
    jm = jax_model()
    model = wrap(jm) if wrap is not None else jm
    step = jdist.DistributedTrainStep(model, jax_opt(jm), jgpt.gpt_loss,
                                      mesh=jax_mesh(), comm_options=comm)
    return np.array([float(np.asarray(step(*b)._data))
                     for b in ranks.gpt_batches()])


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_train")
    write_init(d)
    procs = ranks.start("train", 2, d)
    try:
        want = {
            "implicit": jax_run(),
            "bucketed": jax_run(wrap=lambda m: jdist.DataParallel(
                m, comm_buffer_size=ranks.BUCKET_BYTES / jgc.MB,
                last_comm_buffer_size=ranks.LAST_BUCKET_BYTES / jgc.MB)),
            "int8": jax_run(jgc.CommOptions(quantize="int8")),
        }
    finally:
        res = ranks.collect(procs, "train", 2, d)
        jdist.set_mesh(None)
    return res, want


@pytest.mark.parametrize("kind", ["implicit", "bucketed"])
def test_trajectory_matches_the_jax_step(ran, kind):
    res, want = ran
    for a, _ in res:
        np.testing.assert_allclose(a[kind], want[kind], atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
    assert res[0][0][kind][-1] < res[0][0][kind][0] + 0.05


def test_bucketed_is_implicit_bitwise_with_fewer_all_reduces(ran):
    res, _ = ran
    a, meta = res[0]
    keys = [k[len("implicit."):] for k in a if k.startswith("implicit.")]
    assert keys and all(np.array_equal(a["implicit." + k], a["bucketed." + k])
                        for k in keys)
    assert np.array_equal(a["implicit"], a["bucketed"])
    imp, buck = meta["implicit_exchange"], meta["bucketed_exchange"]
    # one all-reduce a parameter and the loss's, against one a bucket
    assert imp["all_reduce"] == 29
    assert buck["all_reduce"] == meta["bucketed_buckets"] + 1 < \
        imp["all_reduce"]
    assert imp["bytes"] == buck["bytes"] and imp["ms"] > 0
    assert meta["exchanges"] == [ranks.GPT_STEPS, ranks.GPT_STEPS]


def test_replicas_are_bitwise_equal(ran):
    res, _ = ran
    (a, _), (b, _) = res
    rank_own = [k for k in a if k.startswith("int8.resid.")]
    same = [k for k in a if k not in rank_own]
    assert len(same) > 100
    bad = [k for k in same if not np.array_equal(a[k], b[k])]
    assert not bad, bad[:5]


def test_int8_within_the_jax_bound_of_the_jax_int8_run(ran):
    res, want = ran
    for a, meta in res:
        assert np.isfinite(a["int8"]).all()
        np.testing.assert_allclose(a["int8"], want["int8"], rtol=INT8_RTOL,
                                   atol=INT8_ATOL)
        np.testing.assert_allclose(a["int8"], want["implicit"],
                                   rtol=INT8_RTOL, atol=INT8_ATOL)
        assert meta["int8_count"] == ranks.GPT_STEPS
        resid = [a[k] for k in a if k.startswith("int8.resid.")]
        assert len(resid) == 2 and all(np.abs(r).max() > 0 for r in resid)
        ex = meta["int8_exchange"]
        assert ex["all_to_all"] == 2 and ex["all_gather"] == 6
        assert ex["bytes"] < meta["implicit_exchange"]["bytes"] / 2


def test_error_feedback_state_survives_a_checkpoint(ran):
    res, _ = ran
    for a, _ in res:
        np.testing.assert_array_equal(a["resumed"], a["int8"][:5])
        np.testing.assert_array_equal(a["resumed_io"], a["int8"][:5])


def _jax_error(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__
    return None


def test_errors_are_the_jax_steps(ran):
    res, _ = ran
    jm = jax_model()
    mesh = jax_mesh()
    q = jgc.CommOptions(quantize="int8")
    b = ranks.gpt_batches()
    try:
        want = {
            "int8_scaler": _jax_error(lambda: jdist.DistributedTrainStep(
                jm, jax_opt(jm), jgpt.gpt_loss, mesh=mesh, comm_options=q,
                scaler=jamp.GradScaler())),
            "not_pure_dp": _jax_error(lambda: jdist.DistributedTrainStep(
                jm, jax_opt(jm), jgpt.gpt_loss,
                mesh=jax_mesh({"data": 2, "model": 1}),
                comm_options=jgc.CommOptions())),
            "indivisible": _jax_error(lambda: jdist.DistributedTrainStep(
                jm, jax_opt(jm), jgpt.gpt_loss, mesh=mesh,
                comm_options=jgc.CommOptions())(b[0][0][:3], b[0][1][:3])),
            "call_accumulate": _jax_error(lambda: jdist.DistributedTrainStep(
                jm, jax_opt(jm), jgpt.gpt_loss, mesh=mesh,
                comm_options=jgc.CommOptions(accumulate_steps=2))(*b[0])),
            "window": _jax_error(lambda: jdist.DistributedTrainStep(
                jm, jax_opt(jm), jgpt.gpt_loss, mesh=mesh,
                comm_options=jgc.CommOptions(accumulate_steps=2))
                .run_fused(b[:3])),
            "no_mesh": _jax_error(lambda: (jdist.set_mesh(None),
                                           jdist.DistributedTrainStep(
                                               jm, jax_opt(jm),
                                               jgpt.gpt_loss))),
        }
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            jdist.DistributedTrainStep(
                jdist.DataParallel(jm, comm_buffer_size=1), jax_opt(jm),
                jgpt.gpt_loss, mesh=jax_mesh({"data": 2, "model": 1}))
        want["inherited_warns"] = [type(x.message).__name__ for x in w]
    finally:
        jdist.set_mesh(None)
    assert all(v == "ValueError" for k, v in want.items()
               if k != "inherited_warns")
    assert want["inherited_warns"] == ["RuntimeWarning"]
    for _, meta in res:
        errs = meta["errors"]
        for k, v in want.items():
            assert errs[k] == v, (k, errs[k], v)
        # what the JAX package has and the port leaves to item 6b
        assert errs["shard_opt_state"] == "NotImplementedError"
        assert errs["model_axis"] == "NotImplementedError"
