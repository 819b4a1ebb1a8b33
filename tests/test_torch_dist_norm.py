"""``SyncBatchNorm`` and BatchNorm under data parallelism at two ranks
against the JAX package, on the CPU.

The JAX ``SyncBatchNorm`` is a BatchNorm whose batch-axis mean becomes a
cross-replica sum when GSPMD shards the batch: it normalises over the
global batch, and so does a plain BatchNorm inside the JAX implicit
``DistributedTrainStep``; under the explicit exchange the JAX step vmaps
over the shards, so each normalises its own rows and the running
statistics are averaged (``jit.py:148-150, 191-197``). Held, with the
port's ranks in child processes (``tests/torch_dist_ranks.py``'s
``norm`` scenario):

- ``SyncBatchNorm`` in training on each rank's rows of an (8, 4, 5, 5)
  batch = the JAX layer on the whole batch: the output and the input
  gradient (concatenated over ranks), the weight and bias gradients
  (summed over ranks: each rank's own, which the exchange averages) and
  the running statistics;
- a conv-BN net's 4 SGD steps: BatchNorm under the implicit exchange =
  the JAX implicit step (global statistics); BatchNorm under the explicit
  exchange = the JAX explicit step (rank by rank, statistics averaged);
  ``SyncBatchNorm`` under the explicit exchange = the JAX implicit step:
  the port's keeps syncing where the JAX layer normalises each shard,
  as the reference's ``sync_batch_norm`` does (ROADMAP Queue 3, "not
  port faults").

Tolerance: float32 sums in another order, 1e-5 absolute and relative
(values of order 1), losses and every parameter and buffer.
"""
import os

import numpy as np
import pytest

import jax

import paddle_tpu as jpt
from paddle_tpu import distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu import optim as joptim
from paddle_tpu.dist import gradcomm as jgc
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import convert

import torch_dist_ranks as ranks
from torch_test_threads import torch_threads  # noqa: F401,E402

TOL = dict(rtol=1e-5, atol=1e-5)


def jax_net():
    jpt.seed(0)
    H, W = ranks.BN_BATCH[2:]
    return jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1), jnn.BatchNorm2D(4),
                          jnn.ReLU(), jnn.Flatten(),
                          jnn.Linear(4 * H * W, ranks.BN_CLASSES))


def jax_state(net):
    return {k: np.asarray(v._data) for k, v in net.state_dict().items()}


def jax_train(comm):
    net = jax_net()
    mesh = jdist.init_mesh({"data": 2}, devices=jax.devices()[:2])
    opt = joptim.SGD(ranks.BN_LR, parameters=net.parameters())
    step = jdist.DistributedTrainStep(
        net, opt, lambda m, x, y: JF.cross_entropy(m(x), y), mesh=mesh,
        comm_options=comm)
    losses = np.array([float(np.asarray(step(*b)._data))
                       for b in ranks.bn_batches()])
    return losses, jax_state(net)


def jax_sync_layer():
    rng = np.random.RandomState(3)
    x = rng.randn(8, 4, 5, 5).astype(np.float32) * 3 + 1
    w = rng.randn(8, 4, 5, 5).astype(np.float32)
    layer = jnn.SyncBatchNorm(4)
    layer.weight.set_value(np.linspace(0.5, 2.0, 4).astype(np.float32))
    layer.bias.set_value(np.linspace(-1.0, 1.0, 4).astype(np.float32))
    layer.train()
    xt = jpt.to_tensor(x, stop_gradient=False)
    y = layer(xt)
    (y * jpt.to_tensor(w)).sum().backward()
    g = lambda t: np.asarray(t._data)  # noqa: E731
    return {"y": g(y), "dx": g(xt.grad), "dw": g(layer.weight.grad),
            "db": g(layer.bias.grad), "mean": g(layer._mean),
            "var": g(layer._variance)}


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    from paddle_tpu_torch import nn

    d = tmp_path_factory.mktemp("dist_norm")
    H, W = ranks.BN_BATCH[2:]
    port = nn.Sequential(nn.Conv2D(3, 4, 3, padding=1, device="cpu"),
                         nn.BatchNorm2D(4, device="cpu"), nn.ReLU(),
                         nn.Flatten(),
                         nn.Linear(4 * H * W, ranks.BN_CLASSES,
                                   device="cpu"))
    init = convert.layer_params_from_jax(jax_state(jax_net()), port)
    np.savez(os.path.join(d, "bn_init.npz"),
             **{k: v.numpy() for k, v in init.items()})
    procs = ranks.start("norm", 2, d)
    try:
        want = {"implicit": jax_train(None),
                "explicit": jax_train(jgc.CommOptions()),
                "sync": jax_sync_layer()}
    finally:
        res = ranks.collect(procs, "norm", 2, d)
        jdist.set_mesh(None)
    return res, want


def _cat(res, key):
    return np.concatenate([a[key] for a, _ in res])


def test_sync_batch_norm_is_the_global_batch_norm(ran):
    res, want = ran
    w = want["sync"]
    np.testing.assert_allclose(_cat(res, "sync.y"), w["y"], **TOL)
    np.testing.assert_allclose(_cat(res, "sync.dx"), w["dx"], **TOL)
    for k in ("dw", "db"):
        np.testing.assert_allclose(sum(a[f"sync.{k}"] for a, _ in res),
                                   w[k], **TOL)
    for a, _ in res:
        np.testing.assert_allclose(a["sync.mean"], w["mean"], **TOL)
        np.testing.assert_allclose(a["sync.var"], w["var"], **TOL)


@pytest.mark.parametrize("tag,kind", [("bn_implicit", "implicit"),
                                      ("bn_explicit", "explicit"),
                                      ("sync_explicit", "implicit")])
def test_conv_bn_training_matches_the_jax_step(ran, tag, kind):
    res, want = ran
    losses, state = want[kind]
    for a, _ in res:
        np.testing.assert_allclose(a[tag], losses, **TOL)
        for name, v in state.items():
            np.testing.assert_allclose(a[f"{tag}.{name}"], v, **TOL,
                                       err_msg=name)
    (a, _), (b, _) = res
    for k in a:
        if k.startswith(tag + "."):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_the_two_jax_paths_differ_where_the_port_follows_each(ran):
    _, want = ran
    assert not np.allclose(want["implicit"][0], want["explicit"][0], **TOL)
