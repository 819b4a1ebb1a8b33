"""paddle_tpu_torch's decode path against the JAX package's: the
Transformer layers' KV caches, ``static_kv_attention``, the decoder
layers and stacks, and GPT's cached forward, ``generate`` and
``generate_xla``.

The same numpy inputs go through both packages, with the JAX modules'
weights copied to the port's (``state_dict`` as numpy, or
``convert.gpt_params_from_jax``); the port runs on the CPU (the
kernels' plain versions).

The layers (embed 32, 4 heads, float32; feed-forward 64): outputs and
caches within 1e-5 absolute and relative (seen: <= 1.4e-6; the two sum
in another order).

GPT at vocab 1024, hidden 128, 2 heads (D 64), 2 layers, ``max_seq``
256, batch 2, prompt 128 (the flash gate's length), 8 new tokens,
float32, dropout 0; the JAX side dense and with its Pallas kernels in
interpret mode (``pallas.set_enabled(True)``), so its growing-cache
prefill takes the non-causal flash kernel. Greedy tokens of
``generate`` and ``generate_xla`` must be equal; cached logits within
1e-5 (seen: <= 6.6e-7). The reference's growing-cache prefill attends
to the whole prompt (``is_causal=cache is None``): its logits differ
from the causal forward's by up to 0.6 here, and the port's must differ
by the same amounts within 1e-5 (seen: 1.1e-6).

Sampling draws from Philox in the port and threefry in the reference,
so sampled tokens are held to shape, range and membership in the
top-k set, as the reference's own test holds them
(``tests/book/test_nlp_models.py:147-151``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.nlp import gpt as jgpt
from paddle_tpu.nn.layers import transformer as jtr
from paddle_tpu.ops import pallas as pk
from paddle_tpu_torch import convert
from paddle_tpu_torch.models.nlp import gpt
from paddle_tpu_torch.nn.layers import transformer as tr

from torch_test_threads import torch_threads  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
E, H, FF = 32, 4, 64
GPT_CFG = dict(vocab_size=1024, hidden=128, layers=2, heads=2, max_seq=256,
               dropout=0.0)
B, PROMPT, NEW = 2, 128, 8


def _np(x):
    """A JAX Tensor's, a torch tensor's or an array's values as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x._data if hasattr(x, "_data") else x)


def _copy(jmod, tmod):
    """The JAX module's weights into the port's module of the same
    names."""
    sd = {k: torch.from_numpy(np.array(_np(v), np.float32))
          for k, v in jmod.state_dict().items()}
    tmod.load_state_dict(sd)
    return tmod


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _mha():
    pt.seed(0)
    j = jtr.MultiHeadAttention(E, H)
    j.eval()
    return j, _copy(j, tr.MultiHeadAttention(E, H, device="cpu")).eval()


# -- MultiHeadAttention's caches --------------------------------------------


def test_growing_cache_from_empty_matches_the_reference():
    """``gen_cache(key)``: an empty cache, grown over a 3-token prompt
    and two one-token steps; outputs and the caches each step."""
    j, t = _mha()
    jc = j.gen_cache(pt.to_tensor(_rand(2, 1, E)))
    tc = t.gen_cache(torch.from_numpy(_rand(2, 1, E)))
    assert tuple(tc.k.shape) == (2, H, 0, E // H)
    assert isinstance(tc, tr.MultiHeadAttention.Cache)
    for i, L in enumerate((3, 1, 1)):
        x = _rand(2, L, E, seed=i + 1)
        jo, jc = j(pt.to_tensor(x), None, None, None, jc)
        to, tc = t(torch.from_numpy(x), None, None, None, tc)
        _close(to, jo)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
    assert tc.k.shape[2] == 5


def test_cache_of_key_and_value_and_static_cache_match_the_reference():
    """``gen_cache(key, value)`` (a ``Cache`` of their K/V, then grown)
    and ``gen_cache(memory, type=StaticCache)`` (cross-attention,
    unchanged by the call), with an additive mask."""
    j, t = _mha()
    mem, x = _rand(2, 5, E, seed=1), _rand(2, 2, E, seed=2)
    jc = j.gen_cache(pt.to_tensor(mem), pt.to_tensor(mem))
    tc = t.gen_cache(torch.from_numpy(mem), torch.from_numpy(mem))
    jo, jc = j(pt.to_tensor(x), None, None, None, jc)
    to, tc = t(torch.from_numpy(x), None, None, None, tc)
    _close(to, jo)
    _close(tc.k, jc.k)
    js = j.gen_cache(pt.to_tensor(mem),
                     type=jtr.MultiHeadAttention.StaticCache)
    ts = t.gen_cache(torch.from_numpy(mem),
                     type=tr.MultiHeadAttention.StaticCache)
    assert isinstance(ts, tr.MultiHeadAttention.StaticCache)
    mask = np.where(np.arange(5) < 4, 0.0, -1e30).astype("float32")
    mask = mask.reshape(1, 1, 1, 5)
    jo = j(pt.to_tensor(x), pt.to_tensor(mem), pt.to_tensor(mem),
           pt.to_tensor(mask), js)
    to = t(torch.from_numpy(x), torch.from_numpy(mem), torch.from_numpy(mem),
           torch.from_numpy(mask), ts)
    _close(to, jo)


@pytest.mark.parametrize("mask", [None, "bool", "additive"])
def test_static_kv_cache_steps_match_the_reference(mask):
    """``gen_static_kv_cache`` (one zeroed buffer as k and v) through a
    2-token prefill and two one-token steps; the write index advances on
    the device; with a key mask folded into the validity window."""
    j, t = _mha()
    jc = j.gen_static_kv_cache(2, 6, "float32")
    tc = t.gen_static_kv_cache(2, 6, "float32")
    assert tc.idx.dtype == torch.int64 and tc.idx.dim() == 0
    keep = np.array([True, True, False, True, True, True])
    for i, L in enumerate((2, 1, 1)):
        x = _rand(2, L, E, seed=i + 3)
        if mask == "bool":
            m = keep.reshape(1, 1, 1, 6)
        elif mask == "additive":
            m = np.where(keep, 0.0, -1e30).astype("float32")
            m = m.reshape(1, 1, 1, 6)
        else:
            m = None
        jo, jc = j(pt.to_tensor(x), None, None,
                   None if m is None else pt.to_tensor(m), jc)
        to, tc = t(torch.from_numpy(x), None, None,
                   None if m is None else torch.from_numpy(m), tc)
        _close(to, jo)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
        assert int(tc.idx) == int(_np(jc.idx))
    assert int(tc.idx) == 4


def test_static_kv_attention_clamps_the_write_as_the_reference():
    """A write past the buffer's end lands at ``Lmax - L``
    (``dynamic_update_slice``'s clamp) while the mask keeps the given
    index; the index still advances by L."""
    q, k, v = (_rand(1, 2, 2, 8, seed=s) for s in (1, 2, 3))
    kb, vb = _rand(1, 2, 4, 8, seed=4), _rand(1, 2, 4, 8, seed=5)
    jo, jc = jtr.static_kv_attention(
        pt.to_tensor(q), pt.to_tensor(k), pt.to_tensor(v),
        jtr.MultiHeadAttention.StaticKVCache(
            pt.to_tensor(kb), pt.to_tensor(vb), np.int32(3)))
    to, tc = tr.static_kv_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tr.MultiHeadAttention.StaticKVCache(
            torch.from_numpy(kb), torch.from_numpy(vb), 3))
    _close(to, jo)
    _close(tc.k, jc.k)
    assert int(tc.idx) == int(_np(jc.idx)) == 5


# -- the encoder's and decoder's caches, Transformer --------------------------


def _enc_dec(normalize_before):
    pt.seed(1)
    jenc = jtr.TransformerEncoder(jtr.TransformerEncoderLayer(
        E, H, FF, 0.0, normalize_before=normalize_before), 2)
    jdec = jtr.TransformerDecoder(jtr.TransformerDecoderLayer(
        E, H, FF, 0.0, normalize_before=normalize_before), 2)
    tenc = tr.TransformerEncoder(tr.TransformerEncoderLayer(
        E, H, FF, 0.0, normalize_before=normalize_before, device="cpu"), 2)
    tdec = tr.TransformerDecoder(tr.TransformerDecoderLayer(
        E, H, FF, 0.0, normalize_before=normalize_before, device="cpu"), 2)
    for m in (jenc, jdec, tenc, tdec):
        m.eval()
    return jenc, _copy(jenc, tenc), jdec, _copy(jdec, tdec)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_cache_matches_the_reference(normalize_before):
    jenc, tenc, _, _ = _enc_dec(normalize_before)
    x = _rand(2, 3, E, seed=7)
    jo, jc = jenc(pt.to_tensor(x), cache=jenc.gen_cache(pt.to_tensor(x)))
    to, tc = tenc(torch.from_numpy(x),
                  cache=tenc.gen_cache(torch.from_numpy(x)))
    _close(to, jo)
    assert len(tc) == 2
    for a, b in zip(tc, jc):
        _close(a.k, b.k)
        _close(a.v, b.v)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_forward_and_both_caches_match_the_reference(
        normalize_before):
    """The decoder's teacher-forced forward with a causal ``tgt_mask`` and
    a key mask on the memory, then three one-token steps through
    ``gen_cache`` and through ``gen_static_cache``: each step's output
    equals the reference's, and the two caches equal each other."""
    _, _, jdec, tdec = _enc_dec(normalize_before)
    mem, tgt = _rand(2, 5, E, seed=8), _rand(2, 3, E, seed=9)
    mm = np.zeros((2, 1, 1, 5), "float32")
    mm[1, ..., 4] = -1e30
    tm = _np(jtr.Transformer.generate_square_subsequent_mask(3))
    tm_t = tr.Transformer.generate_square_subsequent_mask(3, device="cpu")
    np.testing.assert_array_equal(tm_t.numpy(), tm)
    assert tm_t.dtype == torch.float32
    jo = jdec(pt.to_tensor(tgt), pt.to_tensor(mem), pt.to_tensor(tm),
              pt.to_tensor(mm))
    to = tdec(torch.from_numpy(tgt), torch.from_numpy(mem), tm_t,
              torch.from_numpy(mm))
    _close(to, jo)
    jm, tmem = pt.to_tensor(mem), torch.from_numpy(mem)
    jg, tg = jdec.gen_cache(jm), tdec.gen_cache(tmem)
    js, ts = jdec.gen_static_cache(jm, 3), tdec.gen_static_cache(tmem, 3)
    zipped = tdec.gen_cache(tmem, do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2
    assert isinstance(zipped[1][0], tr.MultiHeadAttention.StaticCache)
    for i in range(3):
        x = tgt[:, i:i + 1]
        jo, jg = jdec(pt.to_tensor(x), jm, None, pt.to_tensor(mm), jg)
        to, tg = tdec(torch.from_numpy(x), tmem, None, torch.from_numpy(mm),
                      tg)
        _close(to, jo)
        jso, js = jdec(pt.to_tensor(x), jm, None, pt.to_tensor(mm), js)
        tso, ts = tdec(torch.from_numpy(x), tmem, None,
                       torch.from_numpy(mm), ts)
        _close(tso, jso)
        _close(tso, to)
    assert int(ts[0][0].idx) == 3 and tg[0][0].k.shape[2] == 3


def test_transformer_forward_matches_the_reference():
    """``Transformer`` (post-norm, and pre-norm with its final norms)
    through ``convert.transformer_params_from_jax``."""
    for nb in (False, True):
        pt.seed(2)
        j = jtr.Transformer(E, H, 2, 1, FF, 0.0, normalize_before=nb)
        j.eval()
        t = tr.Transformer(E, H, 2, 1, FF, 0.0, normalize_before=nb,
                           device="cpu")
        t.load_state_dict(convert.transformer_params_from_jax(
            {k: _np(v) for k, v in j.state_dict().items()}))
        t.eval()
        src, tgt = _rand(2, 4, E, seed=10), _rand(2, 3, E, seed=11)
        tm = jtr.Transformer.generate_square_subsequent_mask(3)
        jo = j(pt.to_tensor(src), pt.to_tensor(tgt), tgt_mask=tm)
        to = t(torch.from_numpy(src), torch.from_numpy(tgt),
               tgt_mask=torch.from_numpy(np.array(_np(tm))))
        _close(to, jo)


def test_decoder_layers_are_deep_copies():
    dec = tr.TransformerDecoder(tr.TransformerDecoderLayer(
        E, H, FF, device="cpu"), 3)
    ws = [layer.cross_attn.q_proj.weight for layer in dec.layers]
    assert all(torch.equal(ws[0], w) for w in ws)
    assert len({w.data_ptr() for w in ws}) == 3


# -- GPT ---------------------------------------------------------------------


@pytest.fixture(params=[False, True], ids=["jax-dense", "jax-pallas"])
def pallas(request):
    pk.set_enabled(request.param)
    yield request.param
    pk.set_enabled(None)


def _gpt_pair(seed=0):
    pt.seed(seed)
    jm = jgpt.GPT(jgpt.GPTConfig(**GPT_CFG))
    jm.eval()
    m = gpt.GPT(gpt.GPTConfig(**GPT_CFG), device="cpu")
    m.load_state_dict(convert.gpt_params_from_jax(
        {k: _np(v) for k, v in jm.state_dict().items()}))
    return jm, m.eval()


def _prompt(seed=0):
    return np.random.RandomState(seed).randint(
        0, GPT_CFG["vocab_size"], (B, PROMPT)).astype("int64")


def test_gpt_greedy_generate_and_generate_xla_match(pallas):
    """Greedy tokens of both decodes equal the reference's at prompt 128:
    ``generate``'s prefill is the non-causal flash forward on the JAX
    side with ``pallas``."""
    jm, m = _gpt_pair()
    ids = _prompt()
    want = _np(jm.generate(pt.to_tensor(ids), max_new_tokens=NEW,
                           temperature=0.0))
    got = m.generate(ids, max_new_tokens=NEW, temperature=0.0)
    assert got.dtype == torch.int64 and got.shape == (B, PROMPT + NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    want = _np(jm.generate_xla(ids, max_new_tokens=NEW))
    np.testing.assert_array_equal(
        m.generate_xla(ids, max_new_tokens=NEW).numpy(), want)


def test_growing_cache_prefill_differs_from_causal_as_the_reference(pallas):
    """The reference's growing-cache prefill is not causal: the port's
    differs from its causal forward by the reference's differences; the
    static-cache prefill equals the causal forward."""
    jm, m = _gpt_pair(seed=3)
    ids = _prompt(seed=1)
    jc = _np(jm(pt.to_tensor(ids), cache=jm.init_cache(B))[0])
    jf = _np(jm(pt.to_tensor(ids)))
    with torch.no_grad():
        tc = m(torch.from_numpy(ids), cache=m.init_cache(B))[0].numpy()
        tf = m(torch.from_numpy(ids)).numpy()
        ts = m(torch.from_numpy(ids),
               cache=m.init_static_cache(B, PROMPT + 4))[0].numpy()
    assert np.abs(jc - jf).max() > 0.1
    np.testing.assert_allclose(tc - tf, jc - jf, atol=TOL, rtol=TOL)
    _close(tc, jc)
    np.testing.assert_allclose(ts, tf, atol=TOL, rtol=TOL)


def test_gpt_cached_forward_steps_match_the_reference():
    """A 4-token prompt then two one-token steps through each cache:
    logits, cache lengths and write indices as the reference's."""
    jm, m = _gpt_pair()
    ids = _prompt()[:, :6]
    for kind in ("growing", "static"):
        jc = jm.init_cache(B) if kind == "growing" else \
            jm.init_static_cache(B, 8)
        tc = m.init_cache(B) if kind == "growing" else \
            m.init_static_cache(B, 8)
        for a, b in ((0, 4), (4, 5), (5, 6)):
            jl, jc = jm(pt.to_tensor(ids[:, a:b]), cache=jc)
            with torch.no_grad():
                tl, tc = m(torch.from_numpy(ids[:, a:b]), cache=tc)
            _close(tl, jl)
        if kind == "growing":
            assert tc[0][0].shape[2] == 6
            _close(tc[1][1], jc[1][1])
        else:
            assert all(int(c.idx) == 6 for c in tc)
            _close(tc[0].k, jc[0].k)


def test_generate_xla_sees_weight_updates_and_keys_signatures():
    """A weight written in place between calls changes the tokens as it
    changes the reference's; a second signature is a second entry, and
    a model whose parameters moved (``bfloat16()``) drops the old
    storage's entries."""
    jm, m = _gpt_pair()
    ids = _prompt()
    first = m.generate_xla(ids, max_new_tokens=4)
    np.testing.assert_array_equal(first.numpy(),
                                  _np(jm.generate_xla(ids, 4)))
    assert len(m._xla_gen_cache) == 1
    rng = np.random.RandomState(5)
    delta = rng.randn(*m.wte.weight.shape).astype("float32") * 0.05
    with torch.no_grad():
        m.wte.weight.add_(torch.from_numpy(delta))
    jm.wte.weight.set_value(_np(jm.wte.weight) + delta)
    again = m.generate_xla(ids, max_new_tokens=4)
    want = _np(jm.generate_xla(ids, 4))
    np.testing.assert_array_equal(again.numpy(), want)
    assert not np.array_equal(again.numpy(), first.numpy())
    assert len(m._xla_gen_cache) == 1
    m.generate_xla(ids[:1], max_new_tokens=4)
    m.generate_xla(ids, max_new_tokens=3)
    assert len(m._xla_gen_cache) == 3
    m.bfloat16()
    m.generate_xla(ids, max_new_tokens=4)
    assert len(m._xla_gen_cache) == 1


@pytest.mark.parametrize("path", ["generate", "generate_xla"])
def test_sampled_tokens_lie_in_the_top_k_set(path):
    """Sampled tokens: the right shape, in range, and each among the
    ``top_k`` largest logits of a teacher-forced pass over its context
    (the growing cache for ``generate``, the causal forward for
    ``generate_xla``); ``generate_xla`` draws the same tokens for one
    seed."""
    _, m = _gpt_pair()
    ids = _prompt()
    k = 5
    if path == "generate":
        g = torch.Generator().manual_seed(3)
        out = m.generate(ids, 6, temperature=0.8, top_k=k, generator=g)
        with torch.no_grad():
            cache, rows = m.init_cache(B), []
            for i in range(6):
                x = out[:, :PROMPT] if i == 0 else \
                    out[:, PROMPT + i - 1:PROMPT + i]
                logits, cache = m(x, cache=cache)
                rows.append(logits[:, -1])
        logits = torch.stack(rows, dim=1)
    else:
        out = m.generate_xla(ids, 6, temperature=0.8, top_k=k, seed=7)
        torch.testing.assert_close(
            out, m.generate_xla(ids, 6, temperature=0.8, top_k=k, seed=7),
            rtol=0, atol=0)
        with torch.no_grad():
            logits = m(out[:, :-1])[:, PROMPT - 1:]
    assert out.shape == (B, PROMPT + 6)
    assert torch.equal(out[:, :PROMPT], torch.from_numpy(ids))
    new = out[:, PROMPT:]
    top = logits.topk(k, dim=-1).indices
    assert bool((top == new[..., None]).any(dim=-1).all())


def test_positions_past_max_seq_raise():
    _, m = _gpt_pair()
    ids = _prompt()
    with pytest.raises(ValueError, match="max_seq"):
        m.generate(ids, max_new_tokens=GPT_CFG["max_seq"] - PROMPT + 2,
                   temperature=0.0)
    with pytest.raises(ValueError, match="max_seq"):
        m.generate_xla(ids, max_new_tokens=GPT_CFG["max_seq"] - PROMPT + 2)
    cache = m.init_cache(B)
    with torch.no_grad():
        _, cache = m(torch.from_numpy(ids), cache=cache)
        with pytest.raises(ValueError, match="max_seq"):
            m(torch.zeros(B, PROMPT + 1, dtype=torch.int64), cache=cache)
    # the last token needs no forward: prompt + new - 1 positions fit
    out = m.generate_xla(ids[:, :8], max_new_tokens=GPT_CFG["max_seq"] - 7)
    assert out.shape == (B, GPT_CFG["max_seq"] + 1)


_JAX_FREE = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from paddle_tpu_torch import convert, inference
from paddle_tpu_torch.models.nlp import gpt, transformer
from paddle_tpu_torch.nn.layers import transformer as layers
m = gpt.GPT(gpt.GPTConfig(vocab_size=64, hidden=128, layers=1, heads=2,
                          max_seq=16, dropout=0.0), device="cpu").eval()
ids = np.random.RandomState(0).randint(0, 64, (2, 4))
assert m.generate(ids, 3, temperature=0.0).shape == (2, 7)
assert m.generate_xla(ids, 3).shape == (2, 7)
w = transformer.WMTTransformer(20, 20, d_model=16, nhead=2, num_layers=1,
                               dim_feedforward=16, dropout=0.0, max_len=8,
                               device="cpu").eval()
toks, scores = w.beam_search_decode_xla(ids % 20, beam_size=2, max_len=6)
assert toks.shape == (2, 6)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
print("JAX-FREE OK")
"""


def test_decode_modules_import_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _JAX_FREE, REPO],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX-FREE OK" in out.stdout
