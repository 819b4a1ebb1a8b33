"""paddle_tpu_torch's recurrent layers against the JAX package's.

The same numpy inputs and weights (carried by ``convert``) go through a
JAX cell, runner or stack and its port, on the CPU: outputs, final
states, and the gradients of ``sum(out * g) + sum(state * g_s)`` for
random ``g`` with respect to the inputs, the initial states and every
parameter. Tolerance, float32: rtol 1e-5 and atol 1e-5 x the largest
magnitude of the JAX result (the same arithmetic, summed in another
order by XLA's and torch's matmuls); gradients through a stack's time
loop at atol 1e-5 x the largest magnitude of their array, as each
step's rounding differences feed the next.

The constructed tie: an LSTM whose outputs are all negative on a unit,
max-pooled over padded steps (which the JAX ``rnn`` writes as 0): the
gradient splits evenly over the tied zeros in both packages
(``ops.max`` is ``amax``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
from paddle_tpu import ops as jops
from paddle_tpu_torch import convert, ops
from paddle_tpu_torch.nn.layers import rnn as trnn
from paddle_tpu_torch import static_ as sprog

from torch_test_threads import torch_threads  # noqa: F401,E402

B, T, IN, H = 3, 6, 5, 4
LENGTHS = np.array([6, 2, 4])


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._data).astype(np.float32)


def _close(got, want, what="", tol=1e-5):
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _jstate(layer):
    return {k: np.asarray(v._data) for k, v in layer.state_dict().items()}


def _port(jlayer, tlayer):
    tlayer.load_state_dict(convert.rnn_params_from_jax(_jstate(jlayer)))
    return tlayer


def _leaves(s):
    if isinstance(s, (tuple, list)):
        return [x for v in s for x in _leaves(v)]
    return [s]


def _run_both(jlayer, tlayer, x, init=None, seq=None, call=None):
    """Forward both with ``x`` (and initial states ``init``, a list of
    numpy arrays, and lengths ``seq``), then backward through ``sum(out
    * g)`` plus each final state times its own ``g``. Returns the
    (port, JAX) pairs of outputs, final states, and gradients of the
    input, the initial states and every parameter."""
    call = call or (lambda layer, x, init, seq: layer(x, init, seq))
    jx = pt.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    jinit = tinit = None
    if init is not None:
        jinit = [pt.to_tensor(a, stop_gradient=False) for a in init]
        tinit = [torch.from_numpy(a).requires_grad_() for a in init]
    jout = call(jlayer, jx, None if jinit is None else
                (tuple(jinit) if len(jinit) > 1 else jinit[0]),
                None if seq is None else pt.to_tensor(seq))
    tout = call(tlayer, tx, None if tinit is None else
                (tuple(tinit) if len(tinit) > 1 else tinit[0]),
                None if seq is None else torch.from_numpy(seq))
    jl, tl = _leaves(jout), _leaves(tout)
    rng = np.random.RandomState(1)
    gs = [rng.randn(*t.shape).astype(np.float32) for t in tl]
    jloss = sum((j * pt.to_tensor(g)).sum() for j, g in zip(jl, gs))
    tloss = sum((t * torch.from_numpy(g)).sum() for t, g in zip(tl, gs))
    jloss.backward()
    tloss.backward()
    pairs = [(_np(t), _np(j), f"output {i}") for i, (t, j)
             in enumerate(zip(tl, jl))]
    grads = [(_np(tx.grad), _np(jx.grad), "dx")]
    if init is not None:
        grads += [(_np(t.grad), _np(j.grad), f"d init {i}")
                  for i, (t, j) in enumerate(zip(tinit, jinit))]
    jp = dict(jlayer.named_parameters())
    for name, p in tlayer.named_parameters():
        grads.append((_np(p.grad), _np(jp[name].grad), f"d {name}"))
    return pairs, grads


CELLS = [("SimpleRNNCell", dict(activation="tanh")),
         ("SimpleRNNCell", dict(activation="relu")),
         ("LSTMCell", {}), ("GRUCell", {})]


@pytest.mark.parametrize("name, kw", CELLS,
                         ids=["simple-tanh", "simple-relu", "lstm", "gru"])
def test_cell_step_matches(name, kw):
    rng = np.random.RandomState(0)
    jcell = getattr(jnn, name)(IN, H, **kw)
    tcell = _port(jcell, getattr(trnn, name)(IN, H, device="cpu", **kw))
    x = rng.randn(B, IN).astype(np.float32)
    n_states = 2 if name == "LSTMCell" else 1
    init = [rng.randn(B, H).astype(np.float32) for _ in range(n_states)]
    pairs, grads = _run_both(jcell, tcell, x, init,
                             call=lambda c, x, s, _: c(x, s))
    for got, want, what in pairs + grads:
        _close(got, want, what)


STACKS = [(cls, d) for cls in ("SimpleRNN", "LSTM", "GRU")
          for d in ("forward", "bidirect")]


@pytest.mark.parametrize("cls, direction", STACKS)
def test_two_layer_stack_with_lengths_and_initial_states(cls, direction):
    """2 layers, ragged ``sequence_length`` and Paddle-layout initial
    states ((layers * D, B, H) per component)."""
    rng = np.random.RandomState(2)
    D = 2 if direction == "bidirect" else 1
    jlayer = getattr(jnn, cls)(IN, H, num_layers=2, direction=direction)
    tlayer = _port(jlayer, getattr(trnn, cls)(IN, H, num_layers=2,
                                              direction=direction,
                                              device="cpu"))
    x = rng.randn(B, T, IN).astype(np.float32)
    init = [rng.randn(2 * D, B, H).astype(np.float32)
            for _ in range(2 if cls == "LSTM" else 1)]
    pairs, grads = _run_both(jlayer, tlayer, x, init, LENGTHS)
    out = pairs[0][0]
    # masked steps write zeros: the JAX semantics, held here directly too
    for b, n in enumerate(LENGTHS):
        assert not out[b, n:].any()
    for got, want, what in pairs + grads:
        _close(got, want, what)


def test_lstm_without_lengths_time_major():
    rng = np.random.RandomState(3)
    jlayer = jnn.LSTM(IN, H, num_layers=2, time_major=True)
    tlayer = _port(jlayer, trnn.LSTM(IN, H, num_layers=2, time_major=True,
                                     device="cpu"))
    x = rng.randn(T, B, IN).astype(np.float32)
    pairs, grads = _run_both(jlayer, tlayer, x)
    for got, want, what in pairs + grads:
        _close(got, want, what)


@pytest.mark.parametrize("wrapper", ["RNN-reverse", "BiRNN"])
def test_runners_match(wrapper):
    rng = np.random.RandomState(4)
    if wrapper == "BiRNN":
        jlayer = jnn.BiRNN(jnn.GRUCell(IN, H), jnn.GRUCell(IN, H))
        tlayer = trnn.BiRNN(trnn.GRUCell(IN, H, device="cpu"),
                            trnn.GRUCell(IN, H, device="cpu"))
    else:
        jlayer = jnn.RNN(jnn.LSTMCell(IN, H), is_reverse=True)
        tlayer = trnn.RNN(trnn.LSTMCell(IN, H, device="cpu"),
                          is_reverse=True)
    _port(jlayer, tlayer)
    x = rng.randn(B, T, IN).astype(np.float32)
    pairs, grads = _run_both(jlayer, tlayer, x, seq=LENGTHS)
    for got, want, what in pairs + grads:
        _close(got, want, what)


def test_max_over_padded_steps_splits_ties_like_the_reference():
    """Unit 0's LSTM outputs are all negative (a large negative output-
    gate bias under a positive cell), so max over time ties on the zeros
    of the padded steps: the gradient goes 1/k to each of the k tied
    steps, in both packages; ``torch.max(dim).values`` would not."""
    jlayer = jnn.LSTM(IN, H)
    state = _jstate(jlayer)
    state = {k: np.zeros_like(v) for k, v in state.items()}
    # i = f = o = sigmoid(b), g = tanh(b_g): unit 0's h = o * tanh(c) < 0
    # with c < 0 (g negative), every other unit positive
    b = np.zeros(4 * H, np.float32)
    b[:H], b[H:2 * H], b[3 * H:] = 3.0, 3.0, 3.0
    b[2 * H:3 * H] = 2.0
    b[2 * H] = -2.0
    state["0.bias_ih"] = b
    jlayer.set_state_dict({k: pt.to_tensor(v) for k, v in state.items()})
    tlayer = trnn.LSTM(IN, H, device="cpu")
    tlayer.load_state_dict(convert.rnn_params_from_jax(state))
    x = np.random.RandomState(5).randn(B, T, IN).astype(np.float32)
    jx = pt.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    jout, _ = jlayer(jx, sequence_length=pt.to_tensor(LENGTHS))
    tout, _ = tlayer(tx, sequence_length=torch.from_numpy(LENGTHS))
    tout.retain_grad()
    jops.max(jout, axis=1).sum().backward()
    ops.max(tout, axis=1).sum().backward()
    out = _np(tout)
    assert (out[:, :, 0][np.arange(T)[None] < LENGTHS[:, None]] < 0).all()
    g = _np(tout.grad)[:, :, 0]
    for r, n in enumerate(LENGTHS):
        ties = T - n
        want = np.zeros(T, np.float32)
        want[n:] = 1.0 / ties if ties else 0.0
        if not ties:
            want[np.argmax(out[r, :, 0])] = 1.0
        np.testing.assert_allclose(g[r], want, rtol=1e-6)
    _close(_np(tx.grad), _np(jx.grad), "dx through the tied max")


def test_static_program_run_raises_naming_the_queue_item():
    """A static recurrent run is ported (ROADMAP Queue 1 item 11b): one
    ``rnn_scan`` op a layer; with a ``sequence_length`` it raises, naming
    the JAX package's own ``TypeError`` there
    (``test_torch_static_tensor.py`` trains the recorded program)."""
    import paddle_tpu_torch as ptt

    ptt.enable_static()
    try:
        main = sprog.Program()
        with sprog.program_guard(main, sprog.Program()):
            x = sprog.data("x", [B, T, IN], "float32")
            n = sprog.data("n", [B], "int64")
            with pytest.raises(NotImplementedError, match="TypeError"):
                trnn.LSTM(IN, H, device="cpu")(x, sequence_length=n)
            trnn.LSTM(IN, H, num_layers=2, device="cpu")(x)
    finally:
        ptt.disable_static()
    types = [op.type for op in main.global_block.ops]
    assert types.count("rnn_scan") == 2 and "linear" not in types


def test_rnn_params_from_jax_checks_shapes():
    state = _jstate(jnn.GRU(IN, H, num_layers=2))
    state["1.weight_hh"] = np.zeros((3 * H, H + 1), np.float32)
    with pytest.raises(ValueError, match="1.weight_hh"):
        convert.rnn_params_from_jax(state)
    with pytest.raises(ValueError, match="missing"):
        convert.rnn_params_from_jax({k: v for k, v in _jstate(
            jnn.LSTMCell(IN, H)).items() if k != "bias_hh"})
