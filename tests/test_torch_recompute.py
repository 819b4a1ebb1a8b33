"""paddle_tpu_torch's recompute (``framework.recompute``) and GPT's
``use_recompute``, against the port without recompute and against the
JAX package's.

- A tiny GPT (the configuration of ``tests/test_torch_gpt.py``, float32)
  with ``use_recompute=True``: loss and every gradient bitwise equal to
  the same model without recompute, at dropout 0 and at dropout 0.1 from
  the same generator state (the recomputed forward takes the masks its
  forward drew), and the generator afterwards where it is without
  recompute; a recompute that draws new masks (a planted fault) differs.
  The blocks' forward runs twice a training step, once in eval and once
  with a cache.
- The same model against the JAX ``GPT`` with ``use_recompute=True``
  (``jax.checkpoint`` per block), weights through
  ``convert.gpt_params_from_jax``, dropout 0: logits and loss within
  1e-5, every gradient within 1e-5 of its largest entry
  (``tests/test_torch_gpt.py``'s tolerances: float32 sums in another
  order).
- Three ``TrainStep`` steps at dropout 0.1 with and without recompute:
  the same losses and parameters, bitwise.
- Under ``auto_cast`` the recomputed forward casts as the forward did,
  also when the backward runs in another thread (the cast state is the
  calling thread's): gradients bitwise those without recompute.
- ``recompute`` of a callable with ``models=``, ``Recompute``, and no
  graph without a gradient to take.
"""
import importlib
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.models.nlp import gpt as jgpt
from paddle_tpu_torch import amp, convert, core, optim
from paddle_tpu_torch.framework import Recompute, TrainStep, recompute
from paddle_tpu_torch.models.nlp import gpt
from paddle_tpu_torch.nn import Linear

from torch_test_threads import torch_threads  # noqa: F401,E402

CFG = dict(vocab_size=512, hidden=128, layers=2, heads=2, max_seq=128)
TOL = 1e-5
# the module (the package's attribute of that name is the function)
rc_mod = importlib.import_module("paddle_tpu_torch.framework.recompute")


def _ids(B=2, L=64, seed=0):
    ids = np.random.RandomState(seed).randint(0, CFG["vocab_size"], (B, L))
    return torch.from_numpy(ids), torch.from_numpy(np.roll(ids, -1, 1))


def _model(dropout, use_recompute, dtype="float32"):
    g = torch.Generator().manual_seed(0)
    return gpt.GPT(gpt.GPTConfig(**CFG, dropout=dropout, dtype=dtype,
                                 use_recompute=use_recompute),
                   device="cpu", generator=g)


def _grads(m, ids, labels, seed=3):
    core.seed(seed)
    loss = gpt.gpt_loss(m, ids, labels)
    loss.backward()
    after = core.random.default_generator("cpu").get_state()
    return loss.detach(), {n: p.grad for n, p in m.named_parameters()}, after


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_recompute_is_bitwise_the_plain_backward(dropout):
    ids, labels = _ids()
    ref = _grads(_model(dropout, False), ids, labels)
    got = _grads(_model(dropout, True), ids, labels)
    assert torch.equal(got[0], ref[0])
    assert sorted(got[1]) == sorted(ref[1])
    assert all(torch.equal(got[1][n], ref[1][n]) for n in ref[1])
    assert torch.equal(got[2], ref[2])


def test_new_masks_in_the_recompute_are_caught(monkeypatch):
    # a planted fault: the recomputed forward draws its own masks
    monkeypatch.setattr(rc_mod._Tape, "replaying", rc_mod._Tape.recording)
    ids, labels = _ids()
    ref = _grads(_model(0.1, False), ids, labels)
    got = _grads(_model(0.1, True), ids, labels)
    assert torch.equal(got[0], ref[0])
    assert not all(torch.equal(got[1][n], ref[1][n]) for n in ref[1])


def test_blocks_run_twice_only_in_training_without_a_cache():
    m = _model(0.0, False)
    m.set_recompute(True)
    assert m.cfg.use_recompute
    calls = []
    for blk in m.blocks:
        blk.register_forward_hook(lambda *a: calls.append(1))
    ids, labels = _ids(1, 32)
    gpt.gpt_loss(m, ids, labels).backward()
    assert len(calls) == 2 * CFG["layers"]
    calls.clear()
    m.eval()
    with torch.no_grad():
        m(ids)
        m.generate(ids[:, :8], max_new_tokens=2)
    assert len(calls) == CFG["layers"] * 3


def test_recompute_matches_the_jax_package():
    jpt.seed(0)
    jm = jgpt.GPT(jgpt.GPTConfig(**CFG, dropout=0.0, use_recompute=True))
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    m = _model(0.0, True)
    m.load_state_dict(convert.gpt_params_from_jax(sd))
    ids, labels = _ids()
    jl = jgpt.gpt_loss(jm, jpt.to_tensor(ids.numpy().astype("int32")),
                       jpt.to_tensor(labels.numpy().astype("int32")))
    jl.backward()
    loss = gpt.gpt_loss(m, ids, labels)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()),
                               float(np.asarray(jl._data)),
                               rtol=TOL)
    want = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}
    for n, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n], rtol=TOL,
                                   atol=TOL * np.abs(want[n]).max(),
                                   err_msg=n)


def test_train_steps_with_recompute_are_bitwise():
    out = []
    for rc in (False, True):
        m = _model(0.1, rc)
        opt = optim.AdamW(parameters=m.named_parameters(),
                          learning_rate=3e-3)
        step = TrainStep(m, opt, gpt.gpt_loss)
        core.seed(5)
        losses = [float(step(*_ids(seed=i))) for i in range(3)]
        out.append((losses, [p.detach().clone() for p in m.parameters()]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("thread", [False, True])
def test_recompute_under_auto_cast_casts_as_the_forward(thread):
    ids, labels = _ids(1, 32)
    res = []
    for rc in (False, True):
        m = _model(0.0, rc)
        with amp.auto_cast(dtype="bfloat16"):
            loss = gpt.gpt_loss(m, ids, labels)
        if thread:
            t = threading.Thread(target=loss.backward)
            t.start()
            t.join()
        else:
            loss.backward()
        res.append({n: p.grad for n, p in m.named_parameters()})
    assert all(torch.equal(res[0][n], res[1][n]) for n in res[0])


def test_recompute_of_a_callable_and_the_wrapper():
    torch.manual_seed(0)
    a, b = Linear(8, 8, device="cpu"), Linear(8, 8, device="cpu")
    x = torch.randn(4, 8, requires_grad=True)

    def f(t):
        return b(torch.relu(a(t)))

    ref = f(x).square().sum()
    gr = torch.autograd.grad(ref, [x, a.weight, b.bias])
    out = recompute(f, x, models=[a, b]).square().sum()
    go = torch.autograd.grad(out, [x, a.weight, b.bias])
    assert torch.equal(out, ref)
    assert all(torch.equal(u, v) for u, v in zip(go, gr))
    w = Recompute(a)
    assert w.weight is a.weight
    assert torch.equal(w(x), a(x))
    with torch.no_grad():
        assert recompute(a, x).grad_fn is None
