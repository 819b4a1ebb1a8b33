"""paddle_tpu_torch's WMT Transformer and decode library against the JAX
package's.

The model of ``tests/test_beam_xla.py`` (source vocab 30, target 40,
d_model 16, 2 heads, 2 + 2 layers, feed-forward 32, dropout 0,
``max_len`` 16), trained 8 Adam steps by the JAX package on its copy
task, then carried to the port through ``convert.wmt_params_from_jax``;
the same numpy source ids go through both, the port on the CPU (the
kernels' plain versions).

Tolerances: logits and the encoder's memory 1e-5 absolute and relative
(seen: <= 5.0e-6); the loss 1e-5 relative; greedy and beam tokens
equal; beam scores within 1e-5 absolute (float32 length-normalised
log-probabilities, |score| < 4; seen: <= 3.4e-6; the two log-softmaxes
and powers round differently in the last place). The decode library's
rankings are held to the reference's exactly on scores that tie:
``lax.top_k`` puts the lower index first, ``jnp.argsort`` is stable,
``jnp.argmax`` takes the first maximum.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.optim as joptim
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.inference import decoder as jdec
from paddle_tpu.models.nlp import transformer as jwmt
from paddle_tpu_torch import convert
from paddle_tpu_torch.inference import decoder as tdec
from paddle_tpu_torch.models.nlp import transformer as wmt

from torch_test_threads import torch_threads  # noqa: F401,E402

TOL = 1e-5
SCORE_TOL = 1e-5
DIMS = dict(d_model=16, nhead=2, num_layers=2, dim_feedforward=32,
            dropout=0.0, max_len=16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x._data if hasattr(x, "_data") else x)


@pytest.fixture(scope="module")
def trained():
    """``(JAX model, the port's copy, source ids (8, 6), targets (8, 7))``:
    ``tests/test_beam_xla.py``'s ``_tiny_trained_model``."""
    pt.seed(0)
    rng = np.random.RandomState(0)
    src = rng.randint(2, 30, (8, 6)).astype("int64")
    tgt = np.concatenate([np.zeros((8, 1), "int64"), (src + 1) % 40],
                         axis=1)
    jm = jwmt.WMTTransformer(30, 40, **DIMS)
    opt = joptim.Adam(3e-3, parameters=jm.parameters())
    step = pt.TrainStep(jm, opt, lambda m, s, ti, tl: jwmt.wmt_loss(
        m, s, ti, tl, pad_id=None))
    for _ in range(8):
        step(src, tgt[:, :-1], tgt[:, 1:])
    jm.eval()
    m = wmt.WMTTransformer(30, 40, **DIMS, device="cpu")
    m.load_state_dict(convert.wmt_params_from_jax(
        {k: _np(v) for k, v in jm.state_dict().items()}))
    return jm, m.eval(), src, tgt


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("smooth_eps", [0.1, 0.0])
@pytest.mark.parametrize("pad_id", [None, 5])
def test_logits_and_loss_match(trained, smooth_eps, pad_id):
    """Teacher-forced logits (with a source padding mask when ``pad_id``
    is set) and ``wmt_loss``, label-smoothed or not, over all target
    positions or those that are not ``pad_id``."""
    jm, m, src, tgt = trained
    args = (src, tgt[:, :-1], tgt[:, 1:])
    want = jm(*(pt.to_tensor(a) for a in args[:2]), src_pad_id=pad_id)
    with torch.no_grad():
        _close(m(*args[:2], src_pad_id=pad_id), want)
        got = wmt.wmt_loss(m, *args, smooth_eps=smooth_eps, pad_id=pad_id)
    want = jwmt.wmt_loss(jm, *(pt.to_tensor(a) for a in args),
                         smooth_eps=smooth_eps, pad_id=pad_id)
    np.testing.assert_allclose(float(got), float(_np(want)), rtol=TOL)


def test_encode_and_decode_steps_match(trained):
    """The encoder's memory, then three ``decode_step``s through the
    growing caches and through the static ones: logits as the
    reference's."""
    jm, m, src, tgt = trained
    jmem, _ = jm.encode(pt.to_tensor(src))
    with torch.no_grad():
        mem, mask = m.encode(src)
        assert mask is None
        _close(mem, jmem)
        for kind in ("growing", "static"):
            if kind == "growing":
                jc = jm.transformer.decoder.gen_cache(jmem)
                tc = m.transformer.decoder.gen_cache(mem)
            else:
                jc = jm.transformer.decoder.gen_static_cache(jmem, 4)
                tc = m.transformer.decoder.gen_static_cache(mem, 4)
            for t in range(3):
                tok = tgt[:, t:t + 1]
                jl, jc = jm.decode_step(pt.to_tensor(tok), jmem, jc, t)
                tl, tc = m.decode_step(torch.from_numpy(tok), mem, tc, t)
                _close(tl, jl)


@pytest.mark.parametrize("pad_id", [None, 5])
def test_greedy_decode_matches(trained, pad_id):
    jm, m, src, _ = trained
    want = _np(jm.greedy_decode(pt.to_tensor(src), max_len=12,
                                src_pad_id=pad_id))
    got = m.greedy_decode(src, max_len=12, src_pad_id=pad_id)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("path", ["eager", "xla"])
@pytest.mark.parametrize("return_all", [False, True])
def test_beam_search_decode_matches(trained, path, return_all):
    """``beam_search_decode`` (growing caches) and
    ``beam_search_decode_xla`` (static caches) against the reference's
    of the same name: equal tokens, scores within SCORE_TOL, beams best
    first; the two paths agree with each other too."""
    jm, m, src, _ = trained
    name = "beam_search_decode" + ("_xla" if path == "xla" else "")
    kw = dict(beam_size=3, max_len=10, return_all=return_all)
    jt, js = getattr(jm, name)(pt.to_tensor(src[:4]), **kw)
    tt, ts = getattr(m, name)(src[:4], **kw)
    np.testing.assert_array_equal(tt.numpy(), _np(jt))
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=SCORE_TOL, rtol=0)
    if return_all:
        assert tt.shape == (4, 3, 10) and ts.shape == (4, 3)
        assert bool((ts[:, :-1] >= ts[:, 1:]).all())
    other = "beam_search_decode" if path == "xla" else \
        "beam_search_decode_xla"
    ot, os_ = getattr(m, other)(src[:4], **kw)
    np.testing.assert_array_equal(ot.numpy(), tt.numpy())
    np.testing.assert_allclose(os_.numpy(), ts.numpy(), atol=SCORE_TOL,
                               rtol=0)


def test_beam_search_decode_xla_with_padding_matches(trained):
    jm, m, src, _ = trained
    kw = dict(beam_size=2, max_len=8, src_pad_id=5, length_penalty=1.0)
    jt, js = jm.beam_search_decode_xla(pt.to_tensor(src), **kw)
    tt, ts = m.beam_search_decode_xla(src, **kw)
    np.testing.assert_array_equal(tt.numpy(), _np(jt))
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=SCORE_TOL, rtol=0)


def test_xla_decode_keeps_one_entry_per_signature(trained):
    _, m, src, _ = trained
    m._xla_decode_cache = None
    m.beam_search_decode_xla(src[:2], beam_size=2, max_len=8)
    m.beam_search_decode_xla(src[2:4], beam_size=2, max_len=8)
    assert len(m._xla_decode_cache) == 1
    m.beam_search_decode_xla(src[:2], beam_size=3, max_len=8)
    assert len(m._xla_decode_cache) == 2


def _model_step(model, memory):
    def step(tok, caches, t):
        return model.decode_step(tok, memory, caches, t)
    return step


def test_greedy_search_and_beam_search_decoder_match(trained):
    """``greedy_search`` and ``BeamSearchDecoder`` with
    ``dynamic_decode`` over the model's growing caches: tokens, lengths,
    sequences and scores as the reference's."""
    jm, m, src, _ = trained
    B = src.shape[0]
    jmem, _ = jm.encode(pt.to_tensor(src))
    with torch.no_grad():
        mem, _ = m.encode(src)
    want = jdec.greedy_search(_model_step(jm, jmem),
                              jm.transformer.decoder.gen_cache(jmem), B,
                              0, 1, 9)
    got = tdec.greedy_search(_model_step(m, mem),
                             m.transformer.decoder.gen_cache(mem), B, 0, 1,
                             9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    # the beam state is tiled: fixed-size caches (the reference cannot
    # tile an empty growing one); the memory itself is read through them
    jd = jdec.BeamSearchDecoder(_model_step(jm, jmem), 0, 1, 3)
    td = tdec.BeamSearchDecoder(_model_step(m, mem), 0, 1, 3)
    (jseq, jsc), _, jlen = jdec.dynamic_decode(
        jd, inits=(B, jm.transformer.decoder.gen_static_cache(jmem, 8)),
        max_step_num=7, return_length=True)
    (tseq, tsc), _, tlen = tdec.dynamic_decode(
        td, inits=(B, m.transformer.decoder.gen_static_cache(mem, 8)),
        max_step_num=7, return_length=True)
    assert tseq.dtype == torch.int64 and tseq.shape == (B, 3, 8)
    np.testing.assert_array_equal(tseq.numpy(), _np(jseq))
    np.testing.assert_allclose(tsc.numpy(), _np(jsc), atol=SCORE_TOL,
                               rtol=0)
    np.testing.assert_array_equal(tlen.numpy(), _np(jlen))


def _table(seed, T, V, eos_bias):
    """Per-step logits ``(T, V, V)`` indexed by the last token: a toy
    model whose EOS (id 1) grows likelier, so beams finish early."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(T, V, V).astype("float32") * 2
    logits[:, :, 1] += eos_bias * np.arange(T, dtype="float32")[:, None]
    return logits


def _steps(table):
    """The toy model as a ``step_fn`` for each package."""
    jt = jnp.asarray(table)
    tt = torch.from_numpy(table)

    def jstep(tok, state, t):
        return JTensor(jt[t][tok._data[:, 0]], _internal=True), state

    def tstep(tok, state, t):
        return tt[t][tok[:, 0]], state

    return jstep, tstep


@pytest.mark.parametrize("eos_bias", [0.0, 1.5])
@pytest.mark.parametrize("length_penalty", [0.6, 0.0])
def test_beam_search_on_a_toy_model_matches(eos_bias, length_penalty):
    """``beam_search`` and ``beam_search_xla`` over a stateless toy model
    (V 12, batch 3, beam 4, 9 steps): with ``eos_bias`` every beam
    finishes before the end, the eager search stops early and the xla one
    freezes; tokens equal and scores within SCORE_TOL of the reference's,
    every beam."""
    table = _table(0, 9, 12, eos_bias)
    jstep, tstep = _steps(table)
    kw = dict(length_penalty=length_penalty, return_all=True)
    for jfn, tfn, extra in ((jdec.beam_search, tdec.beam_search,
                             dict(state_is_tiled=True)),
                            (jdec.beam_search_xla, tdec.beam_search_xla,
                             {})):
        jt, js = jfn(jstep, None, 3, 0, 1, 4, 10, **kw, **extra)
        tt, ts = tfn(tstep, None, 3, 0, 1, 4, 10, **kw, **extra,
                     device="cpu")
        np.testing.assert_array_equal(tt.numpy(), _np(jt))
        np.testing.assert_allclose(ts.numpy(), _np(js), atol=SCORE_TOL,
                                   rtol=0)
    if eos_bias:
        assert bool((tt[:, :, -1] == 1).all())


def test_constructed_ties_rank_as_the_reference():
    """Logits with exact ties everywhere: each step's top K puts the
    lower (beam, token) index first, equal final scores keep their beam
    order, and greedy takes the first maximum — in the eager and xla
    beam searches, ``BeamSearchDecoder`` and ``greedy_search``, as the
    reference does."""
    row = np.array([1.0, 3.0, 3.0, 0.0, 3.0, 2.0, 3.0], "float32")
    table = np.broadcast_to(row, (6, 7, 7)).copy()
    jstep, tstep = _steps(table)
    for jfn, tfn, extra in ((jdec.beam_search, tdec.beam_search,
                             dict(state_is_tiled=True)),
                            (jdec.beam_search_xla, tdec.beam_search_xla,
                             {})):
        jt, js = jfn(jstep, None, 2, 0, 1, 3, 5, return_all=True, **extra)
        tt, ts = tfn(tstep, None, 2, 0, 1, 3, 5, return_all=True,
                     device="cpu", **extra)
        np.testing.assert_array_equal(tt.numpy(), _np(jt))
        np.testing.assert_array_equal(ts.numpy(), _np(js))
    # of the four tied at 3.0, the top 3 are the first three
    np.testing.assert_array_equal(
        tdec._top_k(torch.from_numpy(row[None]), 3)[1].numpy(), [[1, 2, 4]])
    jd = jdec.BeamSearchDecoder(jstep, 0, 1, 3)
    td = tdec.BeamSearchDecoder(tstep, 0, 1, 3, device="cpu")
    (jseq, jsc), _ = jdec.dynamic_decode(jd, inits=(2, None), max_step_num=4)
    (tseq, tsc), _ = tdec.dynamic_decode(td, inits=(2, None), max_step_num=4)
    np.testing.assert_array_equal(tseq.numpy(), _np(jseq))
    np.testing.assert_array_equal(tsc.numpy(), _np(jsc))
    jg = jdec.greedy_search(jstep, None, 2, 0, 1, 5)
    tg = tdec.greedy_search(tstep, None, 2, 0, 1, 5, device="cpu")
    np.testing.assert_array_equal(tg[0].numpy(), _np(jg[0]))
    assert bool((tg[0][:, 1] == 1).all())     # the first of the maxima
    x = np.random.RandomState(3).randint(0, 4, (5, 40)).astype("float32")
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    tv, ti = tdec._top_k(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tdec._order(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.argsort(-jnp.asarray(x),
                                                         axis=-1)))


def test_tile_and_gather_beams_match_the_reference():
    """``tile_beam`` and ``gather_beams`` over a nest of a dict, a list
    and a namedtuple; a 0-d tensor is left as it is."""
    Rec = collections.namedtuple("Rec", ["a", "idx"])
    rng = np.random.RandomState(2)
    x, y = (rng.randn(*s).astype("float32") for s in ((2, 3), (2, 2, 2)))
    jst = {"x": pt.to_tensor(x), "r": [Rec(pt.to_tensor(y), 7)]}
    tst = {"x": torch.from_numpy(x),
           "r": [Rec(torch.from_numpy(y), torch.tensor(7))]}
    jt, tt = jdec.tile_beam(jst, 3), tdec.tile_beam(tst, 3)
    np.testing.assert_array_equal(tt["x"].numpy(), _np(jt["x"]))
    beams = np.array([[2, 0, 0], [1, 1, 2]])
    jg = jdec.gather_beams(jt, pt.to_tensor(beams), 2, 3)
    tg = tdec.gather_beams(tt, torch.from_numpy(beams), 2, 3)
    np.testing.assert_array_equal(tg["x"].numpy(), _np(jg["x"]))
    np.testing.assert_array_equal(tg["r"][0].a.numpy(), _np(jg["r"][0].a))
    assert int(tg["r"][0].idx) == 7


def test_wmt_params_from_jax_rejects_what_does_not_fit(trained):
    jm = trained[0]
    sd = {k: _np(v) for k, v in jm.state_dict().items()}
    assert set(convert.wmt_params_from_jax(sd)) == set(sd)
    bad = dict(sd)
    del bad["transformer.decoder.layers.1.norm3.bias"]
    with pytest.raises(ValueError, match="missing"):
        convert.wmt_params_from_jax(bad)
    bad = dict(sd, **{"transformer.decoder.layers.0.linear1.bias":
                      np.zeros(31, "float32")})
    with pytest.raises(ValueError, match="shape"):
        convert.wmt_params_from_jax(bad)
    bad = dict(sd, extra=np.zeros(1, "float32"))
    with pytest.raises(ValueError, match="extra"):
        convert.wmt_params_from_jax(bad)
    with pytest.raises(ValueError):
        convert.wmt_params_from_jax({k: v for k, v in sd.items()
                                     if k != "tgt_embed.weight"})


def test_positions_past_max_len_raise(trained):
    _, m, src, _ = trained
    with pytest.raises(ValueError, match="max_len"):
        m.greedy_decode(src, max_len=DIMS["max_len"] + 2)
    with pytest.raises(ValueError, match="max_len"):
        m.beam_search_decode_xla(src, beam_size=2,
                                 max_len=DIMS["max_len"] + 2)
    with pytest.raises(ValueError, match="max_len"):
        m.encode(np.zeros((1, DIMS["max_len"] + 1), "int64"))
    # steps read positions 0..max_len-2: max_len + 1 fits
    out = m.greedy_decode(src[:1], max_len=DIMS["max_len"] + 1)
    assert out.shape == (1, DIMS["max_len"] + 1)
