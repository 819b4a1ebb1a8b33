"""Carry weights from the JAX package's models into this package's.

The JAX side hands its arrays over as numpy (``np.asarray`` of each),
so this module never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["tinylm_params_from_jax", "gpt_params_from_jax",
           "bert_params_from_jax"]

_TINYLM = ("embedding", "wq", "wk", "wv", "wo")


def tinylm_params_from_jax(params):
    """The JAX ``TinyLM``'s arrays — a dict of numpy arrays under
    ``embedding`` ``(V, E)`` and ``wq``/``wk``/``wv``/``wo`` ``(E, E)``,
    the names of its attributes — as a state dict for the port's
    ``TinyLM`` (float32 CPU tensors; ``load_state_dict`` moves them to
    the model's device). Raises ``ValueError`` on a missing or extra
    name or an inconsistent shape."""
    if set(params) != set(_TINYLM):
        raise ValueError(f"expected arrays {sorted(_TINYLM)}, got "
                         f"{sorted(params)}")
    arrs = {k: np.asarray(params[k], np.float32) for k in _TINYLM}
    V, E = arrs["embedding"].shape
    for k in _TINYLM[1:]:
        if arrs[k].shape != (E, E):
            raise ValueError(f"{k} has shape {arrs[k].shape}, expected "
                             f"({E}, {E}) for embed dim {E}")
    return {k: torch.from_numpy(a.copy()) for k, a in arrs.items()}


# a GPT block's arrays: name -> shape in units of the hidden width E
_GPT_BLOCK = {"ln1.weight": (1,), "ln1.bias": (1,),
              "attn.qkv.weight": (1, 3), "attn.qkv.bias": (3,),
              "attn.proj.weight": (1, 1), "attn.proj.bias": (1,),
              "ln2.weight": (1,), "ln2.bias": (1,),
              "fc1.weight": (1, 4), "fc1.bias": (4,),
              "fc2.weight": (4, 1), "fc2.bias": (1,)}


def _is_bfloat16(a):
    """True for a bfloat16 array (``ml_dtypes``' type, which is what
    ``np.asarray`` of a JAX bfloat16 array gives)."""
    return np.asarray(a).dtype.name == "bfloat16"


def _numbered(arrs, prefix):
    """How many of ``prefix.<i>.`` there are; raises ``ValueError`` unless
    they are numbered 0..n-1."""
    seen = {k[len(prefix):].split(".")[0] for k in arrs
            if k.startswith(prefix)}
    n = len(seen)
    if seen != {str(i) for i in range(n)}:
        raise ValueError(f"{prefix}* must be numbered 0..{n - 1}, got "
                         f"{sorted(seen)}")
    return n


def _checked(arrs, bf16, want, dims):
    """``arrs`` as CPU tensors once their names are ``want``'s and their
    shapes fit; bfloat16 where the array was."""
    if set(arrs) != set(want):
        raise ValueError(f"missing {sorted(set(want) - set(arrs))}, extra "
                         f"{sorted(set(arrs) - set(want))}")
    for k, shape in want.items():
        if arrs[k].shape != shape:
            raise ValueError(f"{k} has shape {arrs[k].shape}, expected "
                             f"{shape} for {dims}")
    return {k: torch.from_numpy(arrs[k].copy()).to(
        torch.bfloat16 if k in bf16 else torch.float32) for k in want}


def gpt_params_from_jax(state):
    """The JAX ``GPT``'s ``state_dict`` — names to numpy arrays (or
    anything ``np.asarray`` takes) — as a state dict for the port's
    ``GPT`` (CPU tensors under the same names; ``load_state_dict`` moves
    them to the model's device and type). A bfloat16 array stays
    bfloat16 (exactly); every other array becomes float32. Vocabulary,
    width, depth and ``max_seq`` are read from the arrays. Raises
    ``ValueError`` on a missing or extra name or a shape that does not
    fit the others."""
    bf16 = {k for k, v in state.items() if _is_bfloat16(v)}
    arrs = {k: np.asarray(v, np.float32) for k, v in state.items()}
    if "wte.weight" not in arrs or arrs["wte.weight"].ndim != 2:
        raise ValueError("expected a (vocab, hidden) array wte.weight")
    V, E = arrs["wte.weight"].shape
    layers = _numbered(arrs, "blocks.")
    max_seq = arrs["wpe.weight"].shape[0] if "wpe.weight" in arrs else 0
    want = {"wte.weight": (V, E), "wpe.weight": (max_seq, E),
            "ln_f.weight": (E,), "ln_f.bias": (E,)}
    for i in range(layers):
        for k, units in _GPT_BLOCK.items():
            want[f"blocks.{i}.{k}"] = tuple(u * E for u in units)
    return _checked(arrs, bf16, want, f"vocab {V}, hidden {E}")


def _bert_layer(E, F):
    """A BERT encoder layer's arrays: name -> shape, at width ``E`` and
    feed-forward width ``F``."""
    shapes = {"linear1.weight": (E, F), "linear1.bias": (F,),
              "linear2.weight": (F, E), "linear2.bias": (E,)}
    for p in ("q", "k", "v", "out"):
        shapes[f"self_attn.{p}_proj.weight"] = (E, E)
        shapes[f"self_attn.{p}_proj.bias"] = (E,)
    for n in ("norm1", "norm2"):
        shapes[f"{n}.weight"] = shapes[f"{n}.bias"] = (E,)
    return shapes


def bert_params_from_jax(state):
    """The JAX ``BertForPretraining``'s ``state_dict`` — names to numpy
    arrays (or anything ``np.asarray`` takes) — as a state dict for the
    port's ``BertForPretraining`` (CPU tensors under the same names;
    ``load_state_dict`` moves them to the model's device and type). A
    bfloat16 array stays bfloat16 (exactly); every other array becomes
    float32. Vocabulary, width, depth, feed-forward width, positions
    and token types are read from the arrays. Raises ``ValueError`` on
    a missing or extra name or a shape that does not fit the others."""
    bf16 = {k for k, v in state.items() if _is_bfloat16(v)}
    arrs = {k: np.asarray(v, np.float32) for k, v in state.items()}
    emb = "bert.embeddings."
    for k in ("word", "position", "token_type"):
        if arrs.get(f"{emb}{k}.weight", np.zeros(0)).ndim != 2:
            raise ValueError(f"expected a 2-D array {emb}{k}.weight")
    V, E = arrs[f"{emb}word.weight"].shape
    P = arrs[f"{emb}position.weight"].shape[0]
    T = arrs[f"{emb}token_type.weight"].shape[0]
    enc = "bert.encoder.layers."
    layers = _numbered(arrs, enc)
    F = arrs.get(f"{enc}0.linear1.bias", np.zeros(0)).shape[0]
    want = {"mlm_bias": (V,), f"{emb}word.weight": (V, E),
            f"{emb}position.weight": (P, E),
            f"{emb}token_type.weight": (T, E),
            f"{emb}norm.weight": (E,), f"{emb}norm.bias": (E,),
            "bert.pooler.weight": (E, E), "bert.pooler.bias": (E,),
            "transform.weight": (E, E), "transform.bias": (E,),
            "transform_norm.weight": (E,), "transform_norm.bias": (E,),
            "nsp.weight": (E, 2), "nsp.bias": (2,)}
    for i in range(layers):
        for k, shape in _bert_layer(E, F).items():
            want[f"{enc}{i}.{k}"] = shape
    return _checked(arrs, bf16, want, f"vocab {V}, hidden {E}, "
                    f"feed-forward {F}")
