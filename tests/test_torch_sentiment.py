"""paddle_tpu_torch's sentiment nets (``models.nlp.ConvSentiment`` and
``StackedLSTMSentiment``) against the JAX package's, at the JAX book
test's sizes (``tests/book/test_nlp_models.py:45-63``: vocabulary 120,
``ConvSentiment(120, 32, 16)``, ``StackedLSTMSentiment(120, 32, 32,
num_layers=2)``), dropout 0, batch 32 x 16 from ``RandomState(0)``; the
LSTM gets ragged lengths in [4, 16].

- Logits and every gradient: float32, rtol 1e-5 and atol 1e-5 x the
  largest magnitude of the JAX array (the same arithmetic; XLA and
  torch sum the matmuls and convs in other orders).
- An 8-step ``TrainStep`` under ``Adam(1e-2)`` (the book test's ``_fit``)
  against the JAX ``TrainStep``: losses within rtol 1e-5 (the two
  differed by at most 1.7e-6 relative when this was written).
- A static Program that records ``ConvSentiment`` and its loss runs
  through the port's ``Executor`` equal to the eager model bitwise,
  loss and gradients.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn.functional as JF
from paddle_tpu import optim as joptim
from paddle_tpu.models.nlp import sentiment as jsent
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, optim
from paddle_tpu_torch.framework import TrainStep
from paddle_tpu_torch.models.nlp import ConvSentiment, StackedLSTMSentiment
from paddle_tpu_torch.nn import functional as F

from torch_test_threads import torch_threads  # noqa: F401,E402

VOCAB, B, L = 120, 32, 16
NETS = {"conv": (jsent.ConvSentiment, ConvSentiment, (32, 16)),
        "lstm": (jsent.StackedLSTMSentiment, StackedLSTMSentiment,
                 (32, 32))}
TRAJ_RTOL = 1e-5


def _data():
    rng = np.random.RandomState(0)
    ids = rng.randint(2, VOCAB, (B, L)).astype("int64")
    y = (ids[:, 0] > VOCAB // 2).astype("int64")
    lengths = rng.randint(4, L + 1, B).astype("int64")
    return ids, y, lengths


def _nets(kind):
    jcls, tcls, widths = NETS[kind]
    kw = dict(num_layers=2) if kind == "lstm" else {}
    jpt.seed(0)
    jm = jcls(VOCAB, *widths, dropout=0.0, **kw)
    tm = tcls(VOCAB, *widths, dropout=0.0, device="cpu", **kw)
    tm.load_state_dict(convert.sentiment_params_from_jax(
        {k: np.asarray(v._data) for k, v in jm.state_dict().items()}))
    return jm, tm


def _loss(kind, fn):
    if kind == "lstm":
        return lambda m, ids, y, n: fn(m(ids, n), y)
    return lambda m, ids, y, n: fn(m(ids), y)


def _close(got, want, what):
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("kind", ["conv", "lstm"])
def test_logits_and_every_gradient_match(kind):
    jm, tm = _nets(kind)
    ids, y, n = _data()
    args = (ids, jpt.to_tensor(n)) if kind == "lstm" else (ids,)
    jlog = jm(jpt.to_tensor(args[0]), *args[1:])
    tlog = tm(torch.from_numpy(ids), *[torch.from_numpy(n)]
              [:len(args) - 1])
    _close(tlog.detach().numpy(), np.asarray(jlog._data), "logits")
    JF.cross_entropy(jlog, jpt.to_tensor(y)).backward()
    F.cross_entropy(tlog, torch.from_numpy(y)).backward()
    jp = dict(jm.named_parameters())
    names = [name for name, _ in tm.named_parameters()]
    assert sorted(names) == sorted(jp)
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), np.asarray(jp[name].grad._data), name)


@pytest.mark.parametrize("kind", ["conv", "lstm"])
def test_eight_adam_steps_follow_the_reference(kind):
    jm, tm = _nets(kind)
    jstep = jpt.TrainStep(jm, joptim.Adam(1e-2, parameters=jm.parameters()),
                          _loss(kind, JF.cross_entropy))
    step = TrainStep(tm, optim.Adam(1e-2, parameters=tm.named_parameters()),
                     _loss(kind, F.cross_entropy))
    batch = _data()
    want = [float(np.asarray(jstep(*batch)._data)) for _ in range(8)]
    got = [float(step(*batch)) for _ in range(8)]
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert got[-1] < got[0]


def test_static_conv_program_equals_eager():
    ids, y, _ = _data()
    scope = pt.static.Scope()
    pt.enable_static()
    try:
        main = pt.static.Program()
        with pt.static.scope_guard(scope), \
                pt.static.program_guard(main, pt.static.Program()):
            x = pt.static.data("ids", [B, L], "int64")
            lab = pt.static.data("y", [B], "int64")
            net = ConvSentiment(VOCAB, 32, 16, dropout=0.0, device="cpu")
            loss = F.cross_entropy(net(x), lab)
            pg = pt.static.append_backward(loss)
    finally:
        pt.disable_static()
    types = [op.type for op in main.global_block.ops]
    for t in ("embedding", "transpose", "conv1d", "reduce_max", "concat",
              "linear", "cross_entropy_hard"):
        assert t in types, (t, types)
    with pt.static.scope_guard(scope):
        got = pt.static.Executor("cpu").run(
            main, feed={"ids": ids, "y": y},
            fetch_list=[loss] + [g for _, g in pg])
    eager = ConvSentiment(VOCAB, 32, 16, dropout=0.0, device="cpu")
    with torch.no_grad():
        for (name, q), (p, _) in zip(eager.named_parameters(), pg):
            q.copy_(scope.find_var(p.name))
    el = F.cross_entropy(eager(torch.from_numpy(ids)), torch.from_numpy(y))
    el.backward()
    assert got[0] == el.detach().numpy()
    for (name, q), g in zip(eager.named_parameters(), got[1:]):
        assert np.array_equal(g, q.grad.numpy()), name


def test_sentiment_params_from_jax_checks_shapes():
    jm, _ = _nets("conv")
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    state["convs.1.bias"] = np.zeros(17, np.float32)
    with pytest.raises(ValueError, match="convs.1.bias"):
        convert.sentiment_params_from_jax(state)
    jm, _ = _nets("lstm")
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    state["fc.weight"] = np.zeros((33, 2), np.float32)
    with pytest.raises(ValueError, match="fc.weight"):
        convert.sentiment_params_from_jax(state)


def test_phase_23_layer_check_runs_on_the_cpu_and_rejects_a_fault(
        monkeypatch):
    """``chip_smoke.layer_card_check`` with the CPU in the card's place:
    every layer class has a case, all agree and repeat; a second copy
    whose outputs are off by 1e-3 of their scale fails it."""
    import chip_smoke as cs

    assert cs.layer_card_check("cpu", device="cpu") == []
    run = cs._layer_run

    def planted(layer, call, arrays, device, grads_g):
        out = run(layer, call, arrays, device, grads_g)
        if grads_g is not None and type(layer).__name__ == "GLU":
            out[0][0] += 1e-3 * float(out[0][0].abs().max())
        return out

    monkeypatch.setattr(cs, "_layer_run", planted)
    with pytest.raises(cs.CheckFailed, match="GLU"):
        cs.layer_card_check("cpu", device="cpu")


def test_phase_23_batch_is_the_readers_shape():
    import chip_smoke as cs

    ids, y, n = cs.sentiment_batch("cpu")
    assert ids.shape == (cs.SENT_BATCH, cs.SENT_LEN)
    assert int(n.min()) >= cs.SENT_MIN_LEN and int(n.max()) <= cs.SENT_LEN
    pad = torch.arange(cs.SENT_LEN)[None] >= n[:, None]
    assert not ids[pad].any() and (ids[~pad] >= 2).all()
    assert set(y.tolist()) == {0, 1}


@pytest.mark.parametrize("kind", ["conv", "lstm"])
def test_phase_23_reference_loss_is_the_first_step(kind):
    """``chip_smoke.sentiment_reference_loss`` (float64, plain torch)
    recomputes the first ``TrainStep`` loss of a small net at dropout 0.2,
    mask included, within ``SENT_REF_TOL``; a net whose FC bias moved
    fails it."""
    import chip_smoke as cs

    from paddle_tpu_torch import core

    _, tcls, widths = NETS[kind]
    kw = dict(num_layers=2) if kind == "lstm" else {}
    m = tcls(VOCAB, *widths, dropout=0.2, device="cpu", **kw)
    init = {k: v.clone() for k, v in m.state_dict().items()}
    ids, y, n = (torch.from_numpy(a) for a in _data())
    core.seed(1)
    step = TrainStep(m, optim.Adam(1e-2, parameters=m.named_parameters()),
                     _loss(kind, F.cross_entropy))
    first = float(step(ids, y, n))
    ref = cs.sentiment_reference_loss(kind, init, (ids, y, n), "cpu", 0.2)
    assert abs(first - ref) < cs.SENT_REF_TOL
    init["fc.bias"] = init["fc.bias"] + torch.tensor([0.1, -0.1])
    bad = cs.sentiment_reference_loss(kind, init, (ids, y, n), "cpu", 0.2)
    assert abs(first - bad) > cs.SENT_REF_TOL
