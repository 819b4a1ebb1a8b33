"""The tensor API and the recurrent run in paddle_tpu_torch's static graph,
against the JAX package's static Executor.

Each program is recorded in both packages under a fresh unique-name
generator and Scope (``test_torch_static._recording``), so parameters
and optimizer slots are named alike; the JAX Scope's values are copied
into the port's with ``convert.scope_from_jax``, and both Executors run
3 steps on ``RandomState(0)`` feeds (the JAX one jitted, as its own
tests run it; the port's op by op on the CPU):

- ``DeepFM`` over three fields (embed 8, hidden (32, 32)), BCE on a
  0/1 label, Adam(5e-3): its program holds the tensor API's registry ops
  (``reduce_sum``, ``pow``, ``stack``, ``subtract``, ``multiply``,
  ``reshape``, ``squeeze``) and their ``@grad``s;
- ``StackedLSTMSentiment`` with 2 layers and no ``sequence_length``,
  SGD(0.1): one ``rnn_scan`` op a layer, none of the cell's own ops.

Losses within rtol 1e-5 and parameters within atol 1e-5 (float32 sums
in another order). The ops ``pt.sum``, ``pt.topk``, ``pt.scatter`` and
the rest record are the JAX registry's names, op for op; a static
recurrent run with a ``sequence_length`` raises in both packages.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn.functional as JF
from paddle_tpu import optim as joptim
from paddle_tpu.models.nlp import sentiment as jsent
from paddle_tpu.models.rec import recommender as jrec
from paddle_tpu.static_ import program as jprog
from paddle_tpu.utils import unique_name as jun

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, optim
from paddle_tpu_torch.models.nlp import StackedLSTMSentiment
from paddle_tpu_torch.models.rec import DeepFM
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.static_ import program as tprog
from paddle_tpu_torch.utils import unique_name as tun

from test_torch_static import _recording

from torch_test_threads import torch_threads  # noqa: F401,E402

B, FIELDS, VOCAB, L = 16, [10, 20, 30], 50, 6
STEPS = 3


def _deepfm(m, Fm, jax, feeds):
    ids = [m.static.data(f"f{k}", [B], "int64") for k in range(3)]
    y = m.static.data("y", [B], "float32")
    net = (jrec.DeepFM(FIELDS, embed_dim=8, hidden=(32, 32)) if jax else
           DeepFM(FIELDS, embed_dim=8, hidden=(32, 32), device="cpu"))
    loss = Fm.binary_cross_entropy_with_logits(net(*ids), y)
    opt = (joptim.Adam if jax else optim.Adam)(
        5e-3, parameters=net.parameters())
    return loss, opt


def _lstm(m, Fm, jax, feeds):
    x = m.static.data("ids", [B, L], "int64")
    y = m.static.data("y", [B], "int64")
    net = (jsent.StackedLSTMSentiment(VOCAB, 16, 16, num_layers=2,
                                      dropout=0.0) if jax else
           StackedLSTMSentiment(VOCAB, 16, 16, num_layers=2, dropout=0.0,
                                device="cpu"))
    loss = Fm.cross_entropy(net(x), y)
    opt = (joptim.SGD if jax else optim.SGD)(0.1,
                                             parameters=net.parameters())
    return loss, opt


def _feeds(kind):
    rng = np.random.RandomState(0)
    if kind == "deepfm":
        ids = [rng.randint(0, v, (B,)).astype("int64") for v in FIELDS]
        y = ((ids[0] + ids[1]) % 2).astype("float32")
        return {"f0": ids[0], "f1": ids[1], "f2": ids[2], "y": y}
    return {"ids": rng.randint(2, VOCAB, (B, L)).astype("int64"),
            "y": rng.randint(0, 2, B).astype("int64")}


class Static:
    """A program of ``kind`` recorded in one package and trained with
    ``minimize``."""

    def __init__(self, jax, kind):
        self.jax = jax
        m, Fm = (jpt, JF) if jax else (pt, F)
        self.scope = (jprog.Scope if jax else tprog.Scope)()
        m.seed(0)
        with _recording(m.static, jun if jax else tun, self.scope):
            self.main, startup = m.static.Program(), m.static.Program()
            with m.program_guard(self.main, startup):
                build = _deepfm if kind == "deepfm" else _lstm
                self.loss, opt = build(m, Fm, jax, None)
                opt.minimize(self.loss)
        self.exe = jpt.static.Executor() if jax else \
            pt.static.Executor("cpu")
        self.run(startup)

    def run(self, program, **kw):
        static = jpt.static if self.jax else pt.static
        with static.scope_guard(self.scope):
            return self.exe.run(program, **kw)

    def step(self, feed):
        return float(self.run(self.main, feed=feed,
                              fetch_list=[self.loss])[0])

    def values(self):
        return {n: np.asarray(v).copy() if self.jax
                else v.detach().numpy().copy()
                for n, v in self.scope._vars.items()}


@pytest.mark.parametrize("kind", ["deepfm", "lstm"])
def test_static_program_trains_as_the_jax_executor(kind):
    j, t = Static(True, kind), Static(False, kind)
    convert.scope_from_jax(j.values(), t.main, t.scope)
    feed = _feeds(kind)
    want = [j.step(feed) for _ in range(STEPS)]
    got = [t.step(feed) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    jv, tv = j.values(), t.values()
    for name in tv:
        np.testing.assert_allclose(tv[name], jv[name], rtol=0, atol=1e-5,
                                   err_msg=name)
    types = [op.type for op in t.main.global_block.ops]
    if kind == "deepfm":
        for op in ("reduce_sum", "pow", "stack", "subtract", "multiply",
                   "reshape", "squeeze", "concat", "embedding"):
            assert op in types and op + "@grad" in types, op
    else:
        assert types.count("rnn_scan") == types.count("rnn_scan@grad") == 2
        assert "linear" in types and types.count("linear") == 1


def _api_ops(m, x, idx, upd, cond):
    """Tensor-API calls on static Variables, one op each."""
    m.sum(x, axis=1)
    m.mean(x)
    m.prod(x, axis=0)
    m.logsumexp(x, axis=1)
    m.argmax(x, axis=1)
    m.std(x, axis=1)
    m.median(x, axis=1)
    m.topk(x, 2)
    m.sort(x, axis=1, descending=True)
    m.argsort(x)
    m.scatter(x, idx, upd)
    m.gather(x, idx)
    m.take_along_axis(x, m.argsort(x), 1)
    m.where(cond, x, upd)
    m.cumsum(x, axis=1)
    m.clip(x, -0.5, 0.5)
    m.pow(x, 2.0)
    m.subtract(x, upd)
    m.maximum(x, upd)
    m.exp(x)
    m.tile(x, [1, 2])
    m.flip(x, [0])
    m.roll(x, 1, 0)
    m.norm(x, p=2, axis=1)
    m.cross(upd, upd, axis=0)
    m.equal(x, upd)
    m.logical_and(cond, cond)
    m.isclose(x, upd)
    m.kron(x, upd)
    m.diagonal(x)
    m.tril(x)
    m.cast(x, "int32")


def test_tensor_api_records_the_jax_registry_names():
    """The ops the tensor API records in a static Program, in order, are
    the JAX package's (``reduce_sum``, ``topk``, ``scatter``, ...)."""
    lists = []
    for m, un in ((jpt, jun), (pt, tun)):
        scope = (jprog.Scope if m is jpt else tprog.Scope)()
        with _recording(m.static, un, scope):
            main = m.static.Program()
            with m.program_guard(main, m.static.Program()):
                x = m.static.data("x", [3, 5], "float32")
                idx = m.static.data("idx", [3], "int64")
                upd = m.static.data("u", [3, 5], "float32")
                cond = m.static.data("c", [3, 5], "bool")
                _api_ops(m, x, idx, upd, cond)
        lists.append([op.type for op in main.global_block.ops])
    assert lists[1] == lists[0]
    assert "reduce_sum" in lists[1] and "topk" in lists[1]


def test_static_rnn_with_a_sequence_length_raises():
    """A static recurrent run with a ``sequence_length`` raises
    ``NotImplementedError`` here; the JAX package's raises ``TypeError``
    while it infers the ``rnn_scan`` op's shapes."""
    for jax in (True, False):
        m = jpt if jax else pt
        scope = (jprog.Scope if jax else tprog.Scope)()
        with _recording(m.static, jun if jax else tun, scope):
            main = m.static.Program()
            with m.program_guard(main, m.static.Program()):
                x = m.static.data("ids", [B, L], "int64")
                n = m.static.data("n", [B], "int64")
                net = (jsent.StackedLSTMSentiment(VOCAB, 16, 16, 2,
                                                  dropout=0.0) if jax else
                       StackedLSTMSentiment(VOCAB, 16, 16, 2, dropout=0.0,
                                            device="cpu"))
                err = TypeError if jax else NotImplementedError
                with pytest.raises(err):
                    net(x, n)


def test_static_rnn_scan_equals_the_eager_stack():
    """The port's recorded ``rnn_scan`` program gives the eager
    ``LSTM``'s loss and gradients bitwise (the same time loop, the same
    autograd graph)."""
    feed = _feeds("lstm")
    t = Static(False, "lstm")
    params = [v for v in t.main.global_block.vars.values() if v.is_parameter]
    eager = StackedLSTMSentiment(VOCAB, 16, 16, num_layers=2, dropout=0.0,
                                 device="cpu")
    with torch.no_grad():
        for (_, q), v in zip(eager.named_parameters(), params):
            q.copy_(t.scope.find_var(v.name))
    grads = [t.main.global_block.var(v.name + "@GRAD") for v in params]
    loss = F.cross_entropy(eager(torch.from_numpy(feed["ids"])),
                           torch.from_numpy(feed["y"]))
    loss.backward()
    got = t.run(t.main, feed=feed, fetch_list=[t.loss] + grads)
    assert got[0] == loss.detach().numpy()
    for (name, q), g in zip(eager.named_parameters(), got[1:]):
        assert np.array_equal(g, q.grad.numpy()), name
