"""The decode library: beam search, greedy search, ``dynamic_decode``.

The counterpart of ``paddle_tpu/inference/decoder.py`` (:65-427). The
model plugs in as ``step_fn(tokens, state, t) -> (logits, state)`` with
``tokens (batch*beam, 1)``, ``t`` the step (a Python int) and any nest
of tuples, lists, dicts and namedtuples of tensors as the state, each
tensor of one or more dimensions carrying the merged batch*beam leading
dim (0-d tensors, such as a static cache's write index, are the same
for every beam and are left as they are).

Everything works on fixed-shape tensors: the token history is a
``(batch, beam, max_len)`` buffer, beams and batch stay merged on the
leading axis, and a finished beam keeps running with EOS forced at no
cost.

- ``beam_search`` is the eager loop: it reads ``all(finished)`` on the
  host after every step and stops early, as the reference does.
- ``beam_search_xla`` never syncs: where the reference's
  ``lax.while_loop`` stops once every beam has finished, it runs all
  ``max_len - 1`` steps and commits a step's tokens, scores, lengths
  and flags only while the device flag ``~all(finished)`` holds, so it
  leaves them as the reference's loop does, bit for bit. A captured
  CUDA graph (``WMTTransformer.beam_search_decode_xla``) replays it.

Ranking is the reference's: the top K of a row in ``lax.top_k``'s order
(larger first, the lower index first among equal values) through a
stable descending sort (``torch.topk`` promises no order among ties on
CUDA), and the final order by a stable ``argsort(-scores)`` as
``jnp.argsort`` gives it. Greedy steps take ``argmax``, the first
maximum, as ``jnp.argmax`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode",
           "beam_search", "beam_search_xla", "greedy_search", "tile_beam",
           "gather_beams"]

_NEG_INF = -1e9


def _map_state(fn, state):
    """``fn`` over every tensor of a nest of tuples, lists, dicts and
    namedtuples."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    if isinstance(state, dict):
        return {k: _map_state(fn, v) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):  # namedtuple
        return type(state)(*(_map_state(fn, v) for v in state))
    if isinstance(state, (list, tuple)):
        return type(state)(_map_state(fn, v) for v in state)
    return state


def _first_device(state):
    """The device of the first tensor in ``state``, or None."""
    found = []
    _map_state(lambda t: found.append(t.device), state)
    return found[0] if found else None


def _device_of(state, device):
    if device is not None:
        return resolve_device(device)
    dev = _first_device(state)
    return dev if dev is not None else resolve_device(None)


def tile_beam(state, beam_size):
    """Tile every tensor ``(B, ...)`` to ``(B*beam, ...)``, the beams of
    one batch item contiguous (ref: ``tile_beam_merge_with_batch``)."""
    return _map_state(lambda t: t if t.dim() == 0 else
                      t.repeat_interleave(beam_size, dim=0), state)


def _flat(beam_idx, batch_size, beam_size):
    """``(B, K)`` parent beams -> rows of the merged ``B*K`` axis."""
    rows = torch.arange(batch_size, device=beam_idx.device) * beam_size
    return (beam_idx + rows[:, None]).reshape(-1)


def gather_beams(state, beam_idx, batch_size, beam_size):
    """Reorder every tensor's merged ``(B*K, ...)`` leading dim by the
    chosen parent beams ``beam_idx (B, K)``."""
    flat = _flat(beam_idx, batch_size, beam_size)
    return _map_state(lambda t: t if t.dim() == 0 else
                      t.index_select(0, flat), state)


def _length_penalty(lengths, alpha):
    """GNMT length normalisation ``((5 + len) / 6) ** alpha``, float32."""
    lengths = lengths.float()
    if not alpha:
        return torch.ones_like(lengths)
    return torch.pow((lengths + 5.0) / 6.0, float(alpha))


def _top_k(x, k):
    """The ``k`` largest entries of each row of ``x`` and their indices,
    in ``lax.top_k``'s order: larger first, the lower index first among
    equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _order(scores):
    """``jnp.argsort(-scores, axis=-1)``: best first, stable."""
    return torch.argsort(-scores, dim=-1, stable=True)


def _initial(B, K, max_len, bos_id, eos_id, dev):
    """The decode's start: ``(cur, tokens, log_probs, finished,
    lengths)``. Beam 0 is live and the rest dead on arrival, so that
    identical initial beams do not crowd the first top K."""
    cur = torch.full((B * K, 1), bos_id, dtype=torch.int64, device=dev)
    tokens = torch.full((B, K, max_len), eos_id, dtype=torch.int64,
                        device=dev)
    tokens[:, :, 0].fill_(bos_id)
    log_probs = torch.full((B, K), _NEG_INF, dtype=torch.float32,
                           device=dev)
    log_probs[:, 0].fill_(0.0)
    finished = torch.zeros(B, K, dtype=torch.bool, device=dev)
    lengths = torch.ones(B, K, dtype=torch.int64, device=dev)
    return cur, tokens, log_probs, finished, lengths


def _expand(logits, log_probs, finished, eos_id, B, K):
    """One step's candidates: the float32 log-softmax of ``logits`` (a
    finished beam may only emit EOS, at no cost) added to each beam's
    log-probability, then the top K over ``(beam, token)``. Returns
    ``(top values (B, K), parent beams, tokens)``."""
    V = logits.shape[-1]
    lp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
    eos_row = torch.full((V,), _NEG_INF, dtype=torch.float32,
                         device=lp.device)
    eos_row[eos_id:eos_id + 1].fill_(0.0)
    lp = torch.where(finished[:, :, None], eos_row, lp)
    total = log_probs[:, :, None] + lp
    top_v, top_i = _top_k(total.reshape(B, K * V), K)
    return top_v, top_i // V, top_i % V


def _advance(tokens, finished, lengths, beam_idx, tok, t, eos_id, B, K):
    """The bookkeeping of one step: the histories, flags and lengths of
    the chosen parents, the new token at column ``t + 1``, the length of
    every beam that had not finished grown by one."""
    max_len = tokens.shape[-1]
    tokens = gather_beams(tokens.reshape(B * K, max_len), beam_idx, B,
                          K).reshape(B, K, max_len)
    tokens[:, :, t + 1] = tok
    finished = gather_beams(finished.reshape(B * K), beam_idx, B,
                            K).reshape(B, K)
    lengths = gather_beams(lengths.reshape(B * K), beam_idx, B,
                           K).reshape(B, K)
    lengths = lengths + (~finished).long()
    return tokens, finished | (tok == eos_id), lengths


def _final(tokens, log_probs, lengths, length_penalty, return_all, B, K):
    """Length-normalised scores, beams sorted best first."""
    scores = log_probs / _length_penalty(lengths, length_penalty)
    order = _order(scores)
    scores = scores.gather(1, order)
    max_len = tokens.shape[-1]
    tokens = gather_beams(tokens.reshape(B * K, max_len), order, B,
                          K).reshape(B, K, max_len)
    if return_all:
        return tokens, scores
    return tokens[:, 0], scores[:, 0]


@torch.no_grad()
def beam_search(step_fn, init_state, batch_size, bos_id, eos_id, beam_size,
                max_len, length_penalty=0.6, return_all=False,
                state_is_tiled=False, device=None):
    """Batched beam search over a stepwise model.

    Returns ``(tokens, scores)``: the best sequence of each batch item
    ``(B, max_len)`` int64 and its length-normalised score ``(B,)``
    float32; with ``return_all=True`` every beam, best first: ``(B, K,
    max_len)`` and ``(B, K)``. Pass ``state_is_tiled=True`` when
    ``init_state`` already carries the merged batch*beam leading dim.
    The tensors are made on ``device``, by default the state's (else
    ``cuda``). Reads ``all(finished)`` on the host after each step."""
    B, K = batch_size, beam_size
    state = init_state if (init_state is None or state_is_tiled) \
        else tile_beam(init_state, K)
    cur, tokens, log_probs, finished, lengths = _initial(
        B, K, max_len, bos_id, eos_id, _device_of(state, device))
    for t in range(max_len - 1):
        logits, state = step_fn(cur, state, t)
        log_probs, beam_idx, tok = _expand(logits, log_probs, finished,
                                           eos_id, B, K)
        tokens, finished, lengths = _advance(
            tokens, finished, lengths, beam_idx, tok, t, eos_id, B, K)
        if state is not None:
            state = gather_beams(state, beam_idx, B, K)
        cur = tok.reshape(B * K, 1)
        if bool(finished.all()):
            break
    return _final(tokens, log_probs, lengths, length_penalty, return_all,
                  B, K)


@torch.no_grad()
def beam_search_xla(step_fn, init_state, batch_size, bos_id, eos_id,
                    beam_size, max_len, length_penalty=0.6,
                    return_all=False, device=None):
    """Beam search with no host sync: ``max_len - 1`` steps, each
    committed only while the device flag ``~all(finished)`` holds (the
    reference's ``lax.while_loop`` condition), so tokens and scores are
    the reference loop's. Contract as ``beam_search`` with
    ``state_is_tiled=True``; the state must keep its shapes from step to
    step (``TransformerDecoder.gen_static_cache``, not the growing
    ``gen_cache``), and every tensor of it whose leading dim is B*K is
    reordered by the chosen beams after each step. It runs op by op, or
    inside a CUDA graph capture."""
    B, K = batch_size, beam_size
    cur, tokens, log_probs, finished, lengths = _initial(
        B, K, max_len, bos_id, eos_id, _device_of(init_state, device))

    def gather(t, flat):
        return t.index_select(0, flat) \
            if t.dim() >= 1 and t.shape[0] == B * K else t

    state = init_state
    for t in range(max_len - 1):
        go = ~finished.all()
        logits, state = step_fn(cur, state, t)
        top_v, beam_idx, tok = _expand(logits, log_probs, finished, eos_id,
                                       B, K)
        new_tokens, new_finished, new_lengths = _advance(
            tokens, finished, lengths, beam_idx, tok, t, eos_id, B, K)
        flat = _flat(beam_idx, B, K)
        state = _map_state(lambda x: gather(x, flat), state)
        cur = tok.reshape(B * K, 1)
        tokens = torch.where(go, new_tokens, tokens)
        log_probs = torch.where(go, top_v, log_probs)
        finished = torch.where(go, new_finished, finished)
        lengths = torch.where(go, new_lengths, lengths)
    return _final(tokens, log_probs, lengths, length_penalty, return_all,
                  B, K)


@torch.no_grad()
def greedy_search(step_fn, init_state, batch_size, bos_id, eos_id, max_len,
                  device=None):
    """Argmax decode through the same ``step_fn`` contract: ``(tokens
    (B, max_len), lengths (B,))``, int64, EOS after a sequence ends and
    as padding once every one has (read on the host after each step)."""
    dev = _device_of(init_state, device)
    state = init_state
    cur = torch.full((batch_size, 1), bos_id, dtype=torch.int64,
                     device=dev)
    toks = [cur]
    finished = torch.zeros(batch_size, dtype=torch.bool, device=dev)
    lengths = torch.ones(batch_size, dtype=torch.int64, device=dev)
    for t in range(max_len - 1):
        logits, state = step_fn(cur, state, t)
        nxt = logits.argmax(dim=-1)
        nxt = torch.where(finished, torch.full_like(nxt, eos_id), nxt)
        lengths = lengths + (~finished).long()
        finished = finished | (nxt == eos_id)
        cur = nxt.reshape(batch_size, 1)
        toks.append(cur)
        if bool(finished.all()):
            break
    out = torch.cat(toks, dim=1)
    if out.shape[1] < max_len:
        pad = torch.full((batch_size, max_len - out.shape[1]), eos_id,
                         dtype=torch.int64, device=dev)
        out = torch.cat([out, pad], dim=1)
    return out, lengths


# -- fluid-style Decoder objects -------------------------------------------


class Decoder:
    """Abstract stepwise decoder (ref: fluid ``layers/rnn.py`` Decoder)."""

    def initialize(self, inits):
        """-> (initial_inputs, initial_states, initial_finished)"""
        raise NotImplementedError

    def step(self, time, inputs, states):
        """-> (outputs, next_states, next_inputs, finished)"""
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam-search decoding as a ``Decoder``, for ``dynamic_decode``.

    ``step_fn(tokens (B*K, 1), states, t) -> (logits, next_states)``.
    The decoder's tensors are made on ``device``, by default the model
    state's (else ``cuda``)."""

    def __init__(self, step_fn, start_token, end_token, beam_size,
                 length_penalty=0.6, device=None):
        self._step_fn = step_fn
        self.bos = int(start_token)
        self.eos = int(end_token)
        self.beam_size = int(beam_size)
        self.length_penalty = length_penalty
        self._device = device
        self._B = None

    def initialize(self, inits):
        """``inits``: ``(batch_size, model state)``."""
        B, state = inits
        self._B = int(B)
        K = self.beam_size
        state = tile_beam(state, K) if state is not None else None
        inputs, _, lp0, finished, lengths = _initial(
            self._B, K, 1, self.bos, self.eos,
            _device_of(state, self._device))
        states = {"cell": state, "log_probs": lp0, "finished": finished,
                  "lengths": lengths}
        return inputs, states, finished.clone()

    def step(self, time, inputs, states):
        B, K = self._B, self.beam_size
        logits, cell = self._step_fn(inputs, states["cell"], time)
        top_v, beam_idx, tok = _expand(logits, states["log_probs"],
                                       states["finished"], self.eos, B, K)
        fin = gather_beams(states["finished"].reshape(B * K), beam_idx,
                           B, K).reshape(B, K)
        lens = gather_beams(states["lengths"].reshape(B * K), beam_idx,
                            B, K).reshape(B, K)
        lens = lens + (~fin).long()
        fin = fin | (tok == self.eos)
        cell = gather_beams(cell, beam_idx, B, K) if cell is not None \
            else None
        next_states = {"cell": cell, "log_probs": top_v, "finished": fin,
                       "lengths": lens}
        outputs = {"token": tok, "parent": beam_idx}
        return outputs, next_states, tok.reshape(B * K, 1), fin

    @property
    def tracks_own_finished(self):
        return True

    def finalize(self, outputs, final_states, sequence_lengths):
        """Backtrace the parent pointers into whole sequences (ref:
        ``beam_search_decode``, ``rnn.py:2849``), on the host; beams
        sorted best first. Returns ``((sequences (B, K, T + 1) int64,
        scores (B, K)), final_states)``."""
        B, K = self._B, self.beam_size
        toks = [o["token"].cpu().numpy() for o in outputs]
        parents = [o["parent"].cpu().numpy() for o in outputs]
        T = len(toks)
        seq = np.full((B, K, T + 1), self.eos, np.int64)
        seq[:, :, 0] = self.bos
        beam = np.tile(np.arange(K)[None], (B, 1))
        cols = np.empty((B, K, T), np.int64)
        for t in range(T - 1, -1, -1):
            cols[:, :, t] = np.take_along_axis(toks[t], beam, axis=1)
            beam = np.take_along_axis(parents[t], beam, axis=1)
        seq[:, :, 1:] = cols
        scores = final_states["log_probs"] / _length_penalty(
            final_states["lengths"], self.length_penalty)
        order = _order(scores)
        scores = scores.gather(1, order)
        seq = np.take_along_axis(seq, order.cpu().numpy()[:, :, None],
                                 axis=1)
        return (torch.from_numpy(seq).to(scores.device), scores), \
            final_states


@torch.no_grad()
def dynamic_decode(decoder, inits=None, max_step_num=64,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Drive a ``Decoder`` until every sequence finishes (read on the host
    after each step) or ``max_step_num`` steps (ref: fluid
    ``layers/rnn.py:1052``)."""
    inputs, states, finished = decoder.initialize(inits)
    outputs = []
    for t in range(max_step_num):
        step_out, next_states, next_inputs, next_finished = \
            decoder.step(t, inputs, states)
        if not decoder.tracks_own_finished:
            next_finished = next_finished | finished
        outputs.append(step_out)
        inputs, states, finished = next_inputs, next_states, next_finished
        if bool(finished.all()):
            break
    final, final_states = decoder.finalize(
        outputs, states, states.get("lengths")
        if isinstance(states, dict) else None)
    if return_length:
        lens = states["lengths"] if isinstance(states, dict) else None
        return final, final_states, lens
    return final, final_states
