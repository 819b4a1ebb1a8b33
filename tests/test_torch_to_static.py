"""The same Paddle script (``tools/paddle_gpt_script.py``) through the JAX
package and through paddle_tpu_torch, on the CPU, at a tiny width (2
layers, 2 heads x 64, L 128, vocab 256, float32; the port with
``set_device("cpu")``).

The JAX model's weights cross to the port's by ``paddle_tpu.save`` ->
``paddle_tpu_torch.load`` -> ``set_state_dict``; each model is built
under a fresh ``unique_name.guard()``. Held to the JAX package:

- the model's ``state_dict`` names and order, and the parameters' names;
- the 8-step ``multi_precision`` AdamW losses of ``TrainStep`` within
  5e-5 (BERT's ``LOSS_TOL``), against the JAX step run dense and with
  its Pallas kernels in interpret mode (``ops.pallas.set_enabled``);
- the optimizer's ``state_dict`` keys;
- the ``to_static`` forward within rtol 1e-5 (atol 1e-5 x the largest
  logit) of the JAX ``to_static``, at two input signatures, and a plain
  function's outputs in the same pytree shape.

On the CPU ``to_static`` runs op by op; its key is recorded all the
same, one a signature.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.ops.pallas as pk
import paddle_tpu_torch as pt
from test_torch_layers import numpy_initializers  # noqa: F401

from torch_test_threads import torch_threads  # noqa: F401,E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import paddle_gpt_script as S  # noqa: E402

LOSS_TOL = 5e-5
CFG = S.CONFIGS["tiny"]
DATA = S.batches(CFG, steps=8)


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want._data) if isinstance(want, jpt.Tensor) else want
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, numpy_initializers):
    """The JAX model (dense and Pallas-interpret runs of 8 steps, from
    the same weights) and the port's, each trained 8 steps."""
    path = str(tmp_path_factory.mktemp("script") / "gpt.pdparams")
    place = pt._device.CURRENT[0]
    pt.set_device("cpu")
    try:
        with jpt.utils.unique_name.guard():
            jm = S.make_model(jpt, CFG)
        jpt.save(jm.state_dict(), path)
        with pt.utils.unique_name.guard():
            tm = S.make_model(pt, CFG)
        loaded = tm.set_state_dict(pt.load(path))
        names = ([p.name for p in jm.parameters()],
                 [p.name for p in tm.parameters()])
        jlosses, jstep = {}, None
        for pallas in (False, True):
            if pallas:
                with jpt.utils.unique_name.guard():
                    jm = S.make_model(jpt, CFG)
                jm.set_state_dict(jpt.load(path))
            pk.set_enabled(pallas)
            try:
                jlosses[pallas], jstep = S.train(jpt, jm, DATA, CFG)
            finally:
                pk.set_enabled(None)
        tlosses, tstep = S.train(pt, tm, DATA, CFG)
        yield dict(jm=jm, tm=tm, jstep=jstep, tstep=tstep, loaded=loaded,
                   jlosses=jlosses, tlosses=tlosses, names=names,
                   path=path)
    finally:
        pt._device.CURRENT[0] = place


def test_weights_cross_under_the_same_names(runs):
    assert runs["loaded"] == ([], [])
    assert list(runs["tm"].state_dict()) == list(runs["jm"].state_dict())
    jnames, tnames = runs["names"]
    assert tnames == jnames and tnames[0] == "g_p_t_script_0_w_0"
    assert all(p.device.type == "cpu" for p in runs["tm"].parameters())


@pytest.mark.parametrize("pallas", [False, True],
                         ids=["jax_dense", "jax_pallas_interpret"])
def test_eight_adamw_steps_match_the_jax_trainstep(runs, pallas):
    got, want = np.array(runs["tlosses"]), np.array(runs["jlosses"][pallas])
    assert got.shape == (8,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)


def test_optimizer_state_dict_keys_are_the_jax_ones(runs):
    tkeys = set(runs["tstep"].optimizer.state_dict())
    assert tkeys == set(runs["jstep"].optimizer.state_dict())
    assert "g_p_t_script_0_w_0.moment1" in tkeys


def test_to_static_forward_matches_at_two_signatures(runs):
    jm, tm = runs["jm"], runs["tm"]
    # the port's weights after its 8 steps into the JAX model too
    jm.set_state_dict({k: v.numpy() for k, v in tm.state_dict().items()})
    jfn, jout = S.static_forward(jpt, jm, DATA[0][0])
    tfn, tout = S.static_forward(pt, tm, DATA[0][0])
    assert isinstance(tout, torch.Tensor) and not tout.requires_grad
    assert tuple(tout.shape) == tuple(jout.shape) == (2, 128, 256)
    _close(tout, jout, "batch 2")
    with torch.no_grad():
        _close(tfn(torch.from_numpy(DATA[0][0])), tm(torch.from_numpy(
            DATA[0][0])), "to_static = eager")
    assert tm._static_forward is tfn and len(tfn._cache) == 1
    one = DATA[1][0][:1]
    _close(tfn(one), jfn(jpt.to_tensor(one)), "batch 1 (numpy in)")
    assert len(tfn._cache) == 2


def test_to_static_function_returns_the_pytree_it_returned():
    def f(m):
        return lambda x, y: {"sum": m.add(x, y), "parts": [x * 2.0, (y,)]}

    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.ones((2, 3), np.float32)
    want = jpt.to_static(f(jpt))(jpt.to_tensor(a), jpt.to_tensor(b))
    got = pt.to_static(f(pt))(torch.from_numpy(a), b)
    assert set(got) == set(want) == {"sum", "parts"}
    assert isinstance(got["parts"], list) and isinstance(
        got["parts"][1], tuple)
    for g, w in ((got["sum"], want["sum"]), (got["parts"][0],
                                               want["parts"][0]),
                 (got["parts"][1][0], want["parts"][1][0])):
        _close(g, w, "pytree leaf")

    @pt.jit
    def g(x):
        return x + 1.0

    assert float(g(torch.zeros(())).item()) == 1.0
    with pt.framework.no_jit():
        pass
