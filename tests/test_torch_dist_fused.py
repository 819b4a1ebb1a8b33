"""``run_fused`` accumulation and fleet's ``build_train_step`` at two
ranks against the JAX package's, on the CPU.

The tiny GPT, weights and batches of ``tests/test_torch_dist_train.py``
(its ``jax_model`` and ``write_init``); the port's ranks run
``tests/torch_dist_ranks.py``'s ``fused`` scenario. Held:
``run_fused`` over 8 global batches with ``accumulate_steps=2`` (4
exchanges, each of the mean gradient over 2 x 8 rows) within
``LOSS_TOL`` of the JAX ``DistributedTrainStep``'s with
``CommOptions(accumulate_steps=2)``, and the implicit step's
``run_fused(..., accumulate_steps=2)`` the same bits as the bucketed
one's; the same window under plain SGD, whose update is the exchanged
gradient times the rate (AdamW's does not follow the gradient's
scale), in losses within ``LOSS_TOL`` and in each parameter's update
within ``SGD_UPDATE_TOL`` of the JAX one; ``fleet.init`` with a strategy of AMP O1 bfloat16 and
``build_train_step``'s 8 steps within ``BF16_LOSS_TOL``
(``tests/test_torch_gpt.py``'s) of the JAX fleet's (no loss scaler for
bfloat16 in either); the worker queries; ``strategy.sharding``
refused as waiting for item 6b.
"""
import importlib

import numpy as np
import pytest

import jax

from paddle_tpu import distributed as jdist
from paddle_tpu import optim as joptim
from paddle_tpu.dist import gradcomm as jgc
from paddle_tpu.models.nlp import gpt as jgpt
from paddle_tpu_torch import convert

import torch_dist_ranks as ranks
from test_torch_dist_train import jax_model, jax_opt, write_init
from torch_test_threads import torch_threads  # noqa: F401,E402

LOSS_TOL = 5e-5          # tests/test_torch_gpt.py
BF16_LOSS_TOL = 3e-2     # tests/test_torch_gpt.py
# the SGD window's parameter updates against the JAX ones: the largest
# difference over the largest update, float32 sums in another order
SGD_UPDATE_TOL = 1e-3


def jax_accumulate():
    jm = jax_model()
    mesh = jdist.init_mesh({"data": 2}, devices=jax.devices()[:2])
    step = jdist.DistributedTrainStep(
        jm, jax_opt(jm), jgpt.gpt_loss, mesh=mesh,
        comm_options=jgc.CommOptions(accumulate_steps=2))
    return np.asarray(step.run_fused(ranks.gpt_batches())._data)


def jax_sgd_accumulate():
    """The SGD window's losses and the parameters it leaves, in the
    port's names."""
    jm = jax_model()
    mesh = jdist.init_mesh({"data": 2}, devices=jax.devices()[:2])
    step = jdist.DistributedTrainStep(
        jm, joptim.SGD(learning_rate=ranks.GPT_SGD_LR,
                       parameters=jm.parameters()),
        jgpt.gpt_loss, mesh=mesh,
        comm_options=jgc.CommOptions(accumulate_steps=2))
    losses = np.asarray(step.run_fused(ranks.gpt_batches())._data)
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    return losses, {k: v.numpy()
                    for k, v in convert.gpt_params_from_jax(sd).items()}


def jax_fleet_amp():
    fleet = importlib.import_module("paddle_tpu.dist.fleet").fleet
    saved = (fleet._strategy, fleet._inited)
    try:
        jdist.init_mesh({"data": 2}, devices=jax.devices()[:2])
        strategy = jdist.DistributedStrategy()
        strategy.amp = True
        strategy.amp_configs = {"dtype": "bfloat16", "level": "O1"}
        fleet.init(is_collective=True, strategy=strategy)
        jm = jax_model()
        step = fleet.build_train_step(fleet.distributed_model(jm),
                                      fleet.distributed_optimizer(
                                          jax_opt(jm)), jgpt.gpt_loss)
        assert step.scaler is None
        return np.array([float(np.asarray(step(*b)._data))
                         for b in ranks.gpt_batches()])
    finally:
        fleet._strategy, fleet._inited = saved


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_fused")
    write_init(d)
    procs = ranks.start("fused", 2, d)
    try:
        want = {"accumulate": jax_accumulate(),
                "sgd": jax_sgd_accumulate(),
                "init": dict(np.load(d / "gpt_init.npz")),
                "fleet_amp": jax_fleet_amp()}
    finally:
        res = ranks.collect(procs, "fused", 2, d)
        jdist.set_mesh(None)
    return res, want


def test_accumulation_matches_the_jax_window(ran):
    res, want = ran
    for a, meta in res:
        assert a["accumulate"].shape == (ranks.GPT_STEPS,)
        np.testing.assert_allclose(a["accumulate"], want["accumulate"],
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        assert meta["accumulate_exchanges"] == ranks.GPT_STEPS // 2


def test_accumulation_by_argument_is_the_same_bits(ran):
    res, _ = ran
    (a, _), (b, _) = res
    np.testing.assert_array_equal(a["accumulate_kw"], a["accumulate"])
    np.testing.assert_array_equal(a["accumulate_kw.params"],
                                  a["accumulate.params"])
    np.testing.assert_array_equal(a["accumulate.params"],
                                  b["accumulate.params"])


def test_sgd_accumulation_follows_the_jax_gradient_scale(ran):
    res, want = ran
    losses, params = want["sgd"]
    moved = {k: v - want["init"][k] for k, v in params.items()}
    top = max(float(np.abs(v).max()) for v in moved.values())
    assert top > 1e-3
    for a, _ in res:
        np.testing.assert_allclose(a["sgd"], losses, atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        gap = max(float(np.abs(a[f"sgd.{k}"] - want["init"][k] - v).max())
                  for k, v in moved.items())
        assert gap <= SGD_UPDATE_TOL * top, (gap, top)
    np.testing.assert_array_equal(res[0][0]["sgd"], res[1][0]["sgd"])


def test_fleet_amp_matches_the_jax_fleet(ran):
    res, want = ran
    for r, (a, meta) in enumerate(res):
        np.testing.assert_allclose(a["fleet_amp"], want["fleet_amp"],
                                   atol=BF16_LOSS_TOL, rtol=0)
        assert meta["fleet"] == [2, r, r == 0]
        assert meta["fleet_scaler"] is None
        assert meta["sharding"] == "NotImplementedError"
    np.testing.assert_array_equal(res[0][0]["fleet_amp"],
                                  res[1][0]["fleet_amp"])
