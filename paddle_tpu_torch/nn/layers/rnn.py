"""Recurrent layers, the counterparts of ``paddle_tpu/nn/layers/rnn.py``'s
(``:51-379``): ``rnn``/``birnn``, the cells ``SimpleRNNCell``,
``LSTMCell`` (gates i, f, g, o) and ``GRUCell`` (gates r, z, c; ``h' =
z h + (1 - z) c``), the runners ``RNN`` and ``BiRNN``, and the stacks
``SimpleRNN``/``LSTM``/``GRU``.

The JAX package runs a sequence as one ``lax.scan`` op (``rnn_scan``);
here the time loop is plain torch ops, one cell call a step, so it runs
op by op, captures into ``TrainStep``'s CUDA graph and replays bitwise
(no cuDNN RNN, no host read inside the loop). It keeps the JAX
semantics:

- a step at ``t >= sequence_length[b]`` keeps row ``b``'s carried state
  and writes a zero output; the mask is ``t < sequence_length``, taken
  on the device once a run;
- the reverse direction runs from step T - 1 down to 0, so over the
  padded steps first, whose state it keeps;
- initial states of a stack come in Paddle's layout, ``(layers * D, B,
  H)`` per state component;
- a stack's dropout applies between layers only.

The stacks are ``nn.LayerList``s of their cells, layer by layer and
direction by direction, so a state dict names ``0.weight_ih`` as the JAX
package's ``LayerList`` does. Each cell's four parameters are drawn from
U(-1/sqrt(hidden), 1/sqrt(hidden)) unless their attrs say otherwise.

A run inside a static Program records one ``rnn_scan`` op, as the JAX
package's does (``rnn.py:97-100``): its inputs are the inputs, the flat
initial states (zeros, the Program's constants, unless given) and the
cell's parameters; its attributes ``time_major``, ``is_reverse`` and
``n_state``; its function (``_RnnScan``) the same time loop over the
cell called with those parameters (``torch.func.functional_call``), so
the Executor's replay runs it once a step and its ``@grad`` op takes the
loop's autograd graph. A static run with a ``sequence_length`` raises
``NotImplementedError``: the JAX package's fails there, with a
``TypeError`` while it infers the op's shapes (``rnn.py:86``).
"""
from __future__ import annotations

import math

import torch
from torch.func import functional_call

from ..layer import Layer, LayerList
from ..._device import resolve_device
from ...ops._base import RECORDER
from ...ops.manipulation import concat, split, stack
from .. import functional as F
from ..initializer import Uniform
from .common import create_parameter

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


def _leaves(states):
    """A cell's state (a tensor or a tuple of them) as a list."""
    return list(states) if isinstance(states, (tuple, list)) else [states]


def _like(states, leaves):
    return tuple(leaves) if isinstance(states, (tuple, list)) else leaves[0]


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False):
    """``cell`` over the time axis of ``inputs`` ((B, T, ...), or (T, B,
    ...) with ``time_major``): ``(outputs, final states)``, the outputs
    stacked on the time axis (zero at the steps a row's
    ``sequence_length`` masks), the final states those of each row's
    last valid step. ``initial_states`` default to
    ``cell.get_initial_states`` (zeros)."""
    rec = RECORDER[0]
    batch_dim = 1 if time_major else 0
    if rec is not None and rec.sees((inputs, sequence_length), {}):
        if sequence_length is not None:
            raise NotImplementedError(
                "a recurrent run with a sequence_length in a static "
                "Program: the JAX package's rnn raises TypeError there "
                "while it infers the rnn_scan op's shapes (nn/layers/"
                "rnn.py:86)")
        if initial_states is None:   # zeros on the host: constants
            initial_states = cell.get_initial_states(
                torch.empty(inputs.shape[batch_dim], device="cpu"))
        flat = _leaves(initial_states)
        names, params = zip(*cell.named_parameters())
        out = rec.record_op(
            "rnn_scan", _RnnScan(cell, names, isinstance(
                initial_states, (tuple, list))),
            [inputs, *flat, *params],
            dict(time_major=bool(time_major), is_reverse=bool(is_reverse),
                 n_state=len(flat)))
        return out[0], _like(initial_states, list(out[1:]))
    if initial_states is None:
        initial_states = cell.get_initial_states(inputs,
                                                 batch_dim_idx=batch_dim)
    return _time_loop(cell, inputs, initial_states, sequence_length,
                      time_major, is_reverse)


def _time_loop(step, inputs, initial_states, sequence_length, time_major,
               is_reverse):
    """``step(x_t, states) -> (out, states)`` over the time axis:
    ``(outputs, final states)``, masked by ``sequence_length``."""
    xs = inputs if time_major else inputs.transpose(0, 1)
    T = xs.shape[0]
    carry = _leaves(initial_states)
    keep = None
    if sequence_length is not None:
        steps = torch.arange(T, device=xs.device)
        keep = steps[:, None] < torch.as_tensor(sequence_length,
                                                device=xs.device)[None]
    zero = xs.new_zeros(())
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
        out, new = step(xs[t], _like(initial_states, carry))
        new = _leaves(new)
        if keep is not None:
            k = keep[t].reshape((-1,) + (1,) * (out.dim() - 1))
            new = [torch.where(k, n, c) for n, c in zip(new, carry)]
            out = torch.where(k, out, zero)
        carry, outs[t] = new, out
    ys = torch.stack(outs)
    return (ys if time_major else ys.transpose(0, 1),
            _like(initial_states, carry))


class _RnnScan:
    """The function of a static Program's ``rnn_scan`` op: the time loop
    of ``cell``, called with the parameter tensors the op reads in place
    of its own (``names``), over the inputs and the ``n_state`` flat
    initial states; returns ``(outputs, *final states)``."""

    def __init__(self, cell, names, tuple_state):
        self.cell, self.names, self.tuple_state = cell, names, tuple_state

    def __call__(self, x, *flat, time_major, is_reverse, n_state):
        params = dict(zip(self.names, flat[n_state:]))
        states = flat[:n_state]
        init = tuple(states) if self.tuple_state else states[0]

        def step(xt, st):
            return functional_call(self.cell, params, (xt, st))

        # the cell's own ops are this op's body: none records itself
        rec, RECORDER[0] = RECORDER[0], None
        try:
            ys, final = _time_loop(step, x, init, None, time_major,
                                   is_reverse)
        finally:
            RECORDER[0] = rec
        return (ys, *_leaves(final))

    def __repr__(self):
        return f"_RnnScan({type(self.cell).__name__})"


def birnn(cell_fw, cell_bw, inputs, initial_states=None,
          sequence_length=None, time_major=False):
    """``rnn`` forward with ``cell_fw`` and reversed with ``cell_bw``:
    the outputs joined on the last axis, and ``(forward final states,
    backward final states)``."""
    fw_init, bw_init = (None, None) if initial_states is None \
        else initial_states
    out_fw, st_fw = rnn(cell_fw, inputs, fw_init, sequence_length,
                        time_major=time_major)
    out_bw, st_bw = rnn(cell_bw, inputs, bw_init, sequence_length,
                        time_major=time_major, is_reverse=True)
    return concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """``init_value``-filled states for ``batch_ref``'s batch (its axis
        ``batch_dim_idx``), one per shape of ``shape`` (default: the
        cell's ``state_shape``), float32 unless ``dtype`` says
        otherwise."""
        batch = batch_ref.shape[batch_dim_idx]
        shape = self.state_shape if shape is None else shape
        dt = getattr(torch, dtype) if isinstance(dtype, str) else \
            (dtype or torch.float32)

        def build(s):
            return torch.full((batch, *s), init_value, dtype=dt,
                              device=batch_ref.device)

        if isinstance(shape, tuple) and shape and \
                isinstance(shape[0], (tuple, list)):
            return tuple(build(tuple(s)) for s in shape)
        return build(tuple(shape))

    def _make(self, gates, input_size, hidden_size, attrs, device,
              generator):
        """The four parameters of a cell with ``gates`` gate blocks."""
        std = 1.0 / math.sqrt(hidden_size)
        kw = dict(default_initializer=Uniform(-std, std),
                  device=resolve_device(device), generator=generator,
                  owner=self)
        w_ih, w_hh, b_ih, b_hh = attrs
        self.weight_ih = create_parameter((gates * hidden_size, input_size),
                                          w_ih, **kw)
        self.weight_hh = create_parameter((gates * hidden_size, hidden_size),
                                          w_hh, **kw)
        self.bias_ih = create_parameter((gates * hidden_size,), b_ih,
                                        is_bias=True, **kw)
        self.bias_hh = create_parameter((gates * hidden_size,), b_hh,
                                        is_bias=True, **kw)
        self.input_size, self.hidden_size = input_size, hidden_size

    def _gates(self, inputs, h):
        """``(x W_ih^T + b_ih, h W_hh^T + b_hh)``."""
        return (F.linear(inputs, self.weight_ih.t(), self.bias_ih),
                F.linear(h, self.weight_hh.t(), self.bias_hh))

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class SimpleRNNCell(RNNCellBase):
    """``h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh)``, ``act`` tanh or
    relu."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, device=None, generator=None):
        super().__init__()
        self._make(1, input_size, hidden_size, (weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                   generator)
        self.activation = activation

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        act = F.tanh if self.activation == "tanh" else F.relu
        gi, gh = self._gates(inputs, states)
        h = act(gi + gh)
        return h, h


class LSTMCell(RNNCellBase):
    """Gate order i, f, g (cell), o, as the reference's ``lstm_op``:
    ``c' = f c + i g``, ``h' = o tanh(c')``; states ``(h, c)``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 device=None, generator=None):
        super().__init__()
        self._make(4, input_size, hidden_size, (weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                   generator)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        gi, gh = self._gates(inputs, h)
        i, f, g, o = split(gi + gh, 4, axis=-1)
        i, f, o = F.sigmoid(i), F.sigmoid(f), F.sigmoid(o)
        new_c = f * c + i * F.tanh(g)
        new_h = o * F.tanh(new_c)
        return new_h, (new_h, new_c)


class GRUCell(RNNCellBase):
    """Gate order r, z, c, as the reference's ``gru_op``: ``c = tanh(x_c +
    r h_c)``, ``h' = z h + (1 - z) c``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 device=None, generator=None):
        super().__init__()
        self._make(3, input_size, hidden_size, (weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                   generator)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = states
        gi, gh = self._gates(inputs, h)
        i_r, i_z, i_c = split(gi, 3, axis=-1)
        h_r, h_z, h_c = split(gh, 3, axis=-1)
        r = F.sigmoid(i_r + h_r)
        z = F.sigmoid(i_z + h_z)
        c = F.tanh(i_c + r * h_c)
        new_h = z * h + (1.0 - z) * c
        return new_h, new_h


class RNN(Layer):
    """``cell`` run over a sequence (``rnn``)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse, self.time_major = is_reverse, time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        return rnn(self.cell, inputs, initial_states, sequence_length,
                   time_major=self.time_major, is_reverse=self.is_reverse)


class BiRNN(Layer):
    """``cell_fw`` forward and ``cell_bw`` reversed (``birnn``)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw, self.cell_bw = cell_fw, cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        return birnn(self.cell_fw, self.cell_bw, inputs, initial_states,
                     sequence_length, time_major=self.time_major)


class _RNNBase(LayerList):
    """A stack of ``num_layers`` (bidirectional: two a layer) cells."""

    CELL = None

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation=None, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, device=None,
                 generator=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers, self.time_major = num_layers, time_major
        self.dropout, self.direction = dropout, direction
        self.num_directions = 2 if direction in ("bidirect",
                                                 "bidirectional") else 1
        kw = dict(weight_ih_attr=weight_ih_attr,
                  weight_hh_attr=weight_hh_attr, bias_ih_attr=bias_ih_attr,
                  bias_hh_attr=bias_hh_attr, device=device,
                  generator=generator)
        if activation is not None:
            kw["activation"] = activation
        for layer in range(num_layers):
            size = input_size if layer == 0 else \
                hidden_size * self.num_directions
            for _ in range(self.num_directions):
                self.append(type(self).CELL(size, hidden_size, **kw))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """``(outputs, final states)``: the last layer's outputs (both
        directions joined on the last axis) and each state component
        stacked to ``(layers * D, B, H)`` (an LSTM's ``(h, c)``)."""
        D = self.num_directions
        lstm = type(self).CELL is LSTMCell
        init = None
        if initial_states is not None:
            init = initial_states if isinstance(initial_states,
                                                (tuple, list)) \
                else (initial_states,)
        out, finals = inputs, []
        for layer in range(self.num_layers):
            runs = []
            for d in range(D):
                st = None
                if init is not None:
                    st = tuple(s[layer * D + d] for s in init)
                    st = st if lstm else st[0]
                ys, fs = rnn(self[layer * D + d], out, st, sequence_length,
                             time_major=self.time_major, is_reverse=bool(d))
                runs.append(ys)
                finals.append(fs)
            out = concat(runs, axis=-1) if D == 2 else runs[0]
            if self.dropout and layer < self.num_layers - 1:
                out = F.dropout(out, p=self.dropout, training=self.training)
        if lstm:
            return out, (stack([f[0] for f in finals], axis=0),
                         stack([f[1] for f in finals], axis=0))
        return out, stack(finals, axis=0)


class SimpleRNN(_RNNBase):
    CELL = SimpleRNNCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, device=None,
                 generator=None):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                         generator)


class LSTM(_RNNBase):
    CELL = LSTMCell


class GRU(_RNNBase):
    CELL = GRUCell
