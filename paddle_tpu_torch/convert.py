"""Carry weights, optimizer state, loss-scaler state and a static
program's scope from the JAX package into this package's.

The JAX side hands its arrays over as numpy (``np.asarray`` of each),
so this module never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["tinylm_params_from_jax", "gpt_params_from_jax",
           "bert_params_from_jax", "transformer_params_from_jax",
           "wmt_params_from_jax", "resnet_params_from_jax",
           "vgg_params_from_jax", "mobilenet_params_from_jax",
           "lenet_params_from_jax", "rnn_params_from_jax",
           "sentiment_params_from_jax", "layer_params_from_jax",
           "scope_from_jax",
           "optimizer_state_from_jax", "optimizer_state_dict_from_jax",
           "scaler_state_from_jax"]

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


def _attention(prefix, E):
    return {f"{prefix}.{p}_proj.{w}": (E, E) if w == "weight" else (E,)
            for p in ("q", "k", "v", "out") for w in ("weight", "bias")}


def _transformer_arrays(arrs, prefix):
    """Name -> shape of a ``Transformer`` under ``prefix`` (``""`` or
    ``"transformer."``): depths, width, feed-forward width and the final
    norms read from ``arrs``. Returns ``(shapes, description)``."""
    enc, dec = f"{prefix}encoder.layers.", f"{prefix}decoder.layers."
    n_enc, n_dec = _numbered(arrs, enc), _numbered(arrs, dec)
    if not n_enc or not n_dec:
        raise ValueError(f"expected {enc}0.* and {dec}0.*")
    if arrs.get(f"{enc}0.linear1.weight", np.zeros(0)).ndim != 2:
        raise ValueError(f"expected a 2-D array {enc}0.linear1.weight")
    E, F = arrs[f"{enc}0.linear1.weight"].shape
    want = {}
    for i in range(n_enc):
        for k, shape in _bert_layer(E, F).items():
            want[f"{enc}{i}.{k}"] = shape
    for i in range(n_dec):
        layer = f"{dec}{i}."
        want.update(_attention(f"{layer}self_attn", E))
        want.update(_attention(f"{layer}cross_attn", E))
        want.update({f"{layer}linear1.weight": (E, F),
                     f"{layer}linear1.bias": (F,),
                     f"{layer}linear2.weight": (F, E),
                     f"{layer}linear2.bias": (E,)})
        for n in ("norm1", "norm2", "norm3"):
            want[f"{layer}{n}.weight"] = want[f"{layer}{n}.bias"] = (E,)
    for stack in ("encoder", "decoder"):   # normalize_before's final norms
        if f"{prefix}{stack}.norm.weight" in arrs:
            for w in ("weight", "bias"):
                want[f"{prefix}{stack}.norm.{w}"] = (E,)
    return want, E, f"width {E}, feed-forward {F}"


def transformer_params_from_jax(state):
    """The JAX ``nn.Transformer``'s ``state_dict`` — names to numpy arrays
    (or anything ``np.asarray`` takes) — as a state dict for the port's
    ``Transformer`` (CPU tensors under the same names; bfloat16 arrays
    stay bfloat16, every other array becomes float32). Depths, width,
    feed-forward width and the final norms (``normalize_before``) are
    read from the arrays. Raises ``ValueError`` on a missing or extra
    name or a shape that does not fit the others."""
    bf16 = {k for k, v in state.items() if _is_bfloat16(v)}
    arrs = {k: np.asarray(v, np.float32) for k, v in state.items()}
    want, _, dims = _transformer_arrays(arrs, "")
    return _checked(arrs, bf16, want, dims)


def wmt_params_from_jax(state):
    """The JAX ``WMTTransformer``'s ``state_dict`` as a state dict for the
    port's ``WMTTransformer``, as ``transformer_params_from_jax`` does it:
    the two embeddings ``src_embed.weight (source vocab, width)`` and
    ``tgt_embed.weight (target vocab, width)`` and the ``Transformer``
    under ``transformer.``. (The position table is no parameter in
    either package.)"""
    bf16 = {k for k, v in state.items() if _is_bfloat16(v)}
    arrs = {k: np.asarray(v, np.float32) for k, v in state.items()}
    want, E, dims = _transformer_arrays(arrs, "transformer.")
    for name in ("src_embed.weight", "tgt_embed.weight"):
        a = arrs.get(name, np.zeros(0))
        if a.ndim != 2:
            raise ValueError(f"expected a 2-D array {name}")
        want[name] = (a.shape[0], E)
    return _checked(arrs, bf16, want, dims)


def _conv_bn(prefix, cin, cout, k):
    """A ``ConvBN``'s arrays: the conv's weight (no bias) and the
    BatchNorm's parameters and running statistics."""
    shapes = {f"{prefix}.conv.weight": (cout, cin, k, k)}
    for n in ("weight", "bias", "_mean", "_variance"):
        shapes[f"{prefix}.bn.{n}"] = (cout,)
    return shapes


def resnet_params_from_jax(state):
    """The JAX ``ResNet``'s ``state_dict`` — parameters and the
    BatchNorms' ``_mean``/``_variance`` buffers, names to numpy arrays
    (or anything ``np.asarray`` takes) — as a state dict for the port's
    ``ResNet`` (CPU tensors under the same names; ``load_state_dict``
    copies them into the model's tensors). A bfloat16 array stays
    bfloat16 (exactly); every other array becomes float32. Width, input
    channels, the block type (``conv3`` present: bottleneck), the stage
    depths and the classes are read from the arrays. Raises
    ``ValueError`` on a missing or extra name or a shape that does not
    fit the others."""
    bf16 = {k for k, v in state.items() if _is_bfloat16(v)}
    arrs = {k: np.asarray(v, np.float32) for k, v in state.items()}
    for name, ndim in (("stem.conv.weight", 4), ("fc.weight", 2)):
        if arrs.get(name, np.zeros(0)).ndim != ndim:
            raise ValueError(f"expected a {ndim}-D array {name}")
    width, cin = arrs["stem.conv.weight"].shape[:2]
    classes = arrs["fc.weight"].shape[1]
    bottleneck = "layers.0.0.conv3.conv.weight" in arrs
    expansion = 4 if bottleneck else 1
    want = _conv_bn("stem", cin, width, 7)
    inplanes, depths = width, []
    for i in range(_numbered(arrs, "layers.")):
        planes = width * 2 ** i
        depths.append(_numbered(arrs, f"layers.{i}."))
        for j in range(depths[-1]):
            p = f"layers.{i}.{j}"
            if bottleneck:
                want.update(_conv_bn(f"{p}.conv1", inplanes, planes, 1))
                want.update(_conv_bn(f"{p}.conv2", planes, planes, 3))
                want.update(_conv_bn(f"{p}.conv3", planes, planes * 4, 1))
            else:
                want.update(_conv_bn(f"{p}.conv1", inplanes, planes, 3))
                want.update(_conv_bn(f"{p}.conv2", planes, planes, 3))
            if j == 0 and (i > 0 or inplanes != planes * expansion):
                want.update(_conv_bn(f"{p}.downsample", inplanes,
                                     planes * expansion, 1))
            inplanes = planes * expansion
    want["fc.weight"], want["fc.bias"] = (inplanes, classes), (classes,)
    return _checked(arrs, bf16, want, f"width {width}, "
                    f"{'bottleneck' if bottleneck else 'basic'} blocks "
                    f"{depths}, {classes} classes")


def _arrays(state):
    """(float32 numpy arrays by name, the names that were bfloat16)."""
    bf16 = {k for k, v in state.items() if _is_bfloat16(v)}
    return {k: np.asarray(v, np.float32) for k, v in state.items()}, bf16


def _vgg_shapes(depth, batch_norm, cin, classes):
    """Name -> shape of ``VGG(depth, classes, batch_norm, cin)``'s state:
    ``features.<i>`` numbers the convs, BatchNorms, ReLUs and pools in
    order, ``classifier.<0, 3, 6>`` the three ``Linear``s."""
    from .models.vision.vgg import _CFGS

    want, i = {}, 0
    for v in _CFGS[depth]:
        if v == "M":
            i += 1
            continue
        want[f"features.{i}.weight"] = (v, cin, 3, 3)
        want[f"features.{i}.bias"] = (v,)
        i += 1
        if batch_norm:
            for n in ("weight", "bias", "_mean", "_variance"):
                want[f"features.{i}.{n}"] = (v,)
            i += 1
        i += 1                       # the ReLU
        cin = v
    for j, (a, b) in zip((0, 3, 6), ((512 * 49, 4096), (4096, 4096),
                                     (4096, classes))):
        want[f"classifier.{j}.weight"], want[f"classifier.{j}.bias"] = \
            (a, b), (b,)
    return want


def vgg_params_from_jax(state):
    """The JAX ``VGG``'s ``state_dict`` (parameters and the BatchNorms'
    ``_mean``/``_variance``, names to numpy arrays or anything
    ``np.asarray`` takes) as a state dict for the port's ``VGG`` (CPU
    tensors under the same names), as ``resnet_params_from_jax`` does it:
    a bfloat16 array stays bfloat16, every other becomes float32. The
    depth (11, 13, 16 or 19) and whether it has BatchNorms are read from
    the names, the input channels from the first conv and the classes
    from the last ``Linear``. Raises ``ValueError`` when the names are
    no VGG's or a shape does not fit the others."""
    arrs, bf16 = _arrays(state)
    first = arrs.get("features.0.weight", np.zeros(0))
    last = arrs.get("classifier.6.weight", np.zeros(0))
    if first.ndim != 4 or last.ndim != 2:
        raise ValueError("expected a 4-D features.0.weight and a 2-D "
                         "classifier.6.weight")
    for depth in (11, 13, 16, 19):
        for bn in (True, False):
            want = _vgg_shapes(depth, bn, first.shape[1], last.shape[1])
            if set(want) == set(arrs):
                return _checked(arrs, bf16, want, f"vgg{depth}"
                                f"{' with BatchNorm' if bn else ''}, "
                                f"{last.shape[1]} classes")
    raise ValueError(f"no VGG's names: {sorted(arrs)[:8]} ...")


def _rows(arrs, name):
    """The first dimension of ``arrs[name]``: a conv's output channels."""
    a = arrs.get(name, np.zeros(0))
    if a.ndim < 1 or a.shape[0] == 0:
        raise ValueError(f"expected an array {name}")
    return a.shape[0]


# MobileNetV2's expansion factor a block, in order (mobilenet.py:87-96)
_V2_EXPANSIONS = (1,) + (6,) * 16


def _mobilenet_shapes(arrs):
    """Name -> shape of the ``MobileNetV1`` or ``MobileNetV2`` (``head``
    present) whose widths ``arrs`` holds (any ``scale``): the stem's
    and each block's output width read from its last conv, the rest
    following from the reference's layout."""
    depthwise = lambda p, c: _conv_bn(p, 1, c, 3)     # noqa: E731
    cin = _rows(arrs, "stem.conv.weight")
    want = _conv_bn("stem", arrs["stem.conv.weight"].shape[1], cin, 3)
    v2 = "head.conv.weight" in arrs
    n = _numbered(arrs, "blocks.")
    if n != (17 if v2 else 13):
        raise ValueError(f"{n} blocks: MobileNetV{2 if v2 else 1} has "
                         f"{17 if v2 else 13}")
    for j in range(n):
        p = f"blocks.{j}"
        if not v2:
            cout = _rows(arrs, f"{p}.pw.conv.weight")
            want.update(depthwise(f"{p}.dw", cin))
            want.update(_conv_bn(f"{p}.pw", cin, cout, 1))
        else:
            t = _V2_EXPANSIONS[j]
            hidden, convs = int(round(cin * t)), []
            if t != 1:
                convs.append((cin, hidden, 1))
            cout = _rows(arrs, f"{p}.block.{len(convs) + 1}.conv.weight")
            want.update(depthwise(f"{p}.block.{len(convs)}", hidden))
            convs += [None, (hidden, cout, 1)]
            for i, c in enumerate(convs):
                if c is not None:
                    want.update(_conv_bn(f"{p}.block.{i}", *c))
        cin = cout
    if v2:
        head = _rows(arrs, "head.conv.weight")
        want.update(_conv_bn("head", cin, head, 1))
        cin = head
    classes = arrs.get("fc.weight", np.zeros((0, 0)))
    if classes.ndim != 2:
        raise ValueError("expected a 2-D fc.weight")
    want["fc.weight"] = (cin, classes.shape[1])
    want["fc.bias"] = (classes.shape[1],)
    return want, f"MobileNetV{2 if v2 else 1}, {classes.shape[1]} classes"


def mobilenet_params_from_jax(state):
    """The JAX ``MobileNetV1``'s or ``MobileNetV2``'s ``state_dict``
    (parameters and BatchNorm buffers) as a state dict for the port's
    model of the same name, as ``resnet_params_from_jax`` does it (a
    bfloat16 array stays bfloat16). The version (``head`` present: V2),
    the widths (whatever ``scale`` made them), the input channels and
    the classes are read from the arrays. Raises ``ValueError`` on a
    missing or extra name, a block count that is not the reference's or
    a shape that does not fit the others."""
    arrs, bf16 = _arrays(state)
    want, dims = _mobilenet_shapes(arrs)
    return _checked(arrs, bf16, want, dims)


def lenet_params_from_jax(state):
    """The JAX ``LeNet``'s ``state_dict`` (names to numpy arrays, or
    anything ``np.asarray`` takes) as a state dict for the port's
    ``LeNet``: float32 CPU tensors under the same names. The classes are
    read from the last layer. Raises ``ValueError`` on a missing or extra
    name or a shape that does not fit."""
    arrs = {k: np.asarray(v, np.float32) for k, v in state.items()}
    classes = arrs.get("fc.4.weight", np.zeros((84, 0))).shape[1]
    want = {"features.0.weight": (6, 1, 3, 3), "features.0.bias": (6,),
            "features.3.weight": (16, 6, 5, 5), "features.3.bias": (16,),
            "fc.0.weight": (400, 120), "fc.0.bias": (120,),
            "fc.2.weight": (120, 84), "fc.2.bias": (84,),
            "fc.4.weight": (84, classes), "fc.4.bias": (classes,)}
    return _checked(arrs, set(), want, f"{classes} classes")


def _rnn_cells(arrs, prefix):
    """Name -> shape of the recurrent cells under ``prefix``: a stack
    (``<prefix>0.``, ``<prefix>1.``, ...), a ``BiRNN``
    (``<prefix>cell_fw.``/``cell_bw.``), an ``RNN`` (``<prefix>cell.``)
    or one cell. The gate count (1 SimpleRNN, 3 GRU, 4 LSTM) and hidden
    width come from the first cell's ``weight_hh``. Returns ``(shapes,
    gates, hidden)``."""
    if f"{prefix}0.weight_ih" in arrs:
        cells = [f"{prefix}{i}." for i in range(_numbered(arrs, prefix))]
    elif f"{prefix}cell_fw.weight_ih" in arrs:
        cells = [f"{prefix}cell_fw.", f"{prefix}cell_bw."]
    elif f"{prefix}cell.weight_ih" in arrs:
        cells = [f"{prefix}cell."]
    else:
        cells = [prefix]
    hh = arrs.get(f"{cells[0]}weight_hh", np.zeros(0))
    if hh.ndim != 2 or not hh.shape[1] or hh.shape[0] % hh.shape[1] or \
            hh.shape[0] // hh.shape[1] not in (1, 3, 4):
        raise ValueError(f"{cells[0]}weight_hh has shape {hh.shape}, not "
                         f"(gates * hidden, hidden) for 1, 3 or 4 gates")
    H = hh.shape[1]
    G = hh.shape[0] // H
    want = {}
    for c in cells:
        ih = arrs.get(f"{c}weight_ih", np.zeros(0))
        if ih.ndim != 2:
            raise ValueError(f"expected a 2-D array {c}weight_ih")
        want.update({f"{c}weight_ih": (G * H, ih.shape[1]),
                     f"{c}weight_hh": (G * H, H),
                     f"{c}bias_ih": (G * H,), f"{c}bias_hh": (G * H,)})
    return want, G, H


_GATES = {1: "SimpleRNN", 3: "GRU", 4: "LSTM"}


def rnn_params_from_jax(state):
    """The ``state_dict`` of a JAX ``SimpleRNN``/``LSTM``/``GRU`` stack
    (uni- or bidirectional; ``0.weight_ih`` ...), a ``BiRNN``, an ``RNN``
    or one cell — names to numpy arrays — as a state dict for the port's
    counterpart: float32 CPU tensors under the same names (bfloat16
    arrays stay bfloat16). Raises ``ValueError`` on a missing or extra
    name or a shape that does not fit the first cell's gates and
    width."""
    bf16 = {k for k, v in state.items() if _is_bfloat16(v)}
    arrs = {k: np.asarray(v, np.float32) for k, v in state.items()}
    want, G, H = _rnn_cells(arrs, "")
    return _checked(arrs, bf16, want, f"{_GATES[G]} cells of width {H}")


def sentiment_params_from_jax(state):
    """The JAX ``ConvSentiment``'s or ``StackedLSTMSentiment``'s
    ``state_dict`` (an ``lstm.0.weight_ih`` names the second) as a state
    dict for the port's model of the same class: float32 CPU tensors
    under the same names. Vocabulary, widths, conv widths, depth and
    classes are read from the arrays. Raises ``ValueError`` on a missing
    or extra name or a shape that does not fit."""
    arrs = {k: np.asarray(v, np.float32) for k, v in state.items()}
    if arrs.get("embed.weight", np.zeros(0)).ndim != 2:
        raise ValueError("expected a (vocab, embed) array embed.weight")
    V, E = arrs["embed.weight"].shape
    want = {"embed.weight": (V, E)}
    if "lstm.0.weight_ih" in arrs:
        cells, G, feat = _rnn_cells(arrs, "lstm.")
        if G != 4:
            raise ValueError(f"lstm.* holds {_GATES[G]} cells, not LSTM")
        want.update(cells)
        dims = f"vocab {V}, embed {E}, LSTM width {feat}"
    else:
        n = _numbered(arrs, "convs.")
        if not n or arrs["convs.0.weight"].ndim != 3:
            raise ValueError("expected (filters, embed, width) arrays "
                             "convs.<i>.weight")
        F = arrs["convs.0.weight"].shape[0]
        for i in range(n):
            w = arrs.get(f"convs.{i}.weight", np.zeros((0, 0, 0)))
            want[f"convs.{i}.weight"] = (F, E, w.shape[-1])
            want[f"convs.{i}.bias"] = (F,)
        feat = F * n
        dims = f"vocab {V}, embed {E}, {n} convs of {F} filters"
    C = arrs.get("fc.bias", np.zeros(0)).shape[0]
    want.update({"fc.weight": (feat, C), "fc.bias": (C,)})
    return _checked(arrs, set(), want, dims)


def layer_params_from_jax(state, module):
    """A JAX layer's or model's ``state_dict`` as a state dict for
    ``module``, the port's of the same class: every name of
    ``module.state_dict()`` at its shape, buffers included (a
    ``SpectralNorm``'s ``weight_u`` and ``weight_v``, a BatchNorm's
    ``_mean`` and ``_variance``), and a ``PReLU``'s ``weight``. The book's
    word2vec and recommender nets (``models.nlp.NGramLM``/``SkipGram``,
    ``models.rec.TwoTowerRecommender``/``DeepFM``, whose ``LayerList``s
    are ``ModuleList``s of the same names) load through it too. float32 CPU tensors (bfloat16 arrays stay
    bfloat16). Raises ``ValueError`` on a missing or extra name or
    another shape."""
    bf16 = {k for k, v in state.items() if _is_bfloat16(v)}
    arrs = {k: np.asarray(v, np.float32) for k, v in state.items()}
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    return _checked(arrs, bf16, want, type(module).__name__)


def scope_from_jax(arrays, program, scope=None):
    """Copy a JAX static ``Scope``'s values — ``{name: array}``, e.g.
    ``{n: np.asarray(v) for n, v in jax_scope._vars.items()}`` — into the
    port's ``scope`` (default: ``static_.global_scope()``) for every
    persistable of the port's ``program``: parameters and the
    ``<param>@OPT@<slot>`` optimizer slots, which a program recorded in
    both packages names alike. Each value is copied into the tensor the
    scope already holds (its storage, which a captured replay reads,
    stays). Names of other programs in ``arrays`` are left alone. Raises
    ``ValueError`` on a persistable missing from ``arrays`` or a shape
    that does not fit."""
    from .static_.program import global_scope

    scope = scope if scope is not None else global_scope()
    for name, v in program.global_block.vars.items():
        if not v.persistable:
            continue
        if name not in arrays:
            raise ValueError(f"persistable {name!r} is not in the JAX scope")
        a = np.asarray(arrays[name])
        a = a.astype(np.float32) if _is_bfloat16(a) else a
        src = torch.from_numpy(np.array(a))
        dst = scope.find_var(name)
        if dst is None:
            raise ValueError(f"persistable {name!r} has no value in the "
                             "port's scope to copy into")
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name} has shape {tuple(src.shape)}, the "
                             f"port's {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)


def _inner(opt):
    """The optimizer a wrapper (anything with an ``inner``) steps."""
    while "inner" in vars(opt):
        opt = vars(opt)["inner"]
    return opt


def optimizer_state_from_jax(jax_opt, torch_opt, names=None):
    """Write the JAX optimizer's state — moments, velocities, accumulators,
    beta powers, masters, per parameter, and its step count — into the
    port's optimizer of the same kind, in place (the port's tensors keep
    their storage, so a captured step goes on using them). ``names`` maps
    each JAX parameter's ``.name`` to the port's name; by default the two
    optimizers' parameters are paired in order. The port's state is made
    first where it is missing; every value must have the port's shape and
    state keys, and is copied into the port's type (a bfloat16 value is
    exact in float32). A wrapper on either side (``LookAhead``,
    ``RecomputeOptimizer``, ``PipelineOptimizer``) stands for its inner
    optimizer, whose state it is. Raises ``ValueError`` on a parameter,
    key or shape that does not fit."""
    jax_opt, torch_opt = _inner(jax_opt), _inner(torch_opt)
    jparams = list(jax_opt._param_groups)
    tparams = dict(torch_opt._named_params)
    if names is None:
        if len(jparams) != len(tparams):
            raise ValueError(f"{len(jparams)} JAX parameters, "
                             f"{len(tparams)} in the port's optimizer")
        names = {jp.name: tn for jp, (tn, _) in
                 zip(jparams, torch_opt._named_params)}
    for jp in jparams:
        js = jax_opt._accumulators.get(jp.name)
        if js is None:
            continue
        if names.get(jp.name) not in tparams:
            raise ValueError(f"JAX parameter {jp.name} maps to no parameter "
                             f"of the port's optimizer")
        tn = names[jp.name]
        ts = torch_opt._state_for(tn, tparams[tn])
        if set(js) != set(ts):
            raise ValueError(f"{tn}: JAX state {sorted(js)}, the port's "
                             f"{sorted(ts)}")
        for k, v in js.items():
            a = np.asarray(v)
            a = a.astype(np.float32) if _is_bfloat16(a) else a
            if tuple(a.shape) != tuple(ts[k].shape):
                raise ValueError(f"{tn}.{k} has shape {a.shape}, the port's "
                                 f"{tuple(ts[k].shape)}")
            ts[k].copy_(torch.from_numpy(np.array(a)))
    torch_opt._global_step = int(jax_opt._global_step)


def optimizer_state_dict_from_jax(state, torch_opt, names=None):
    """A JAX optimizer's ``state_dict()`` — what a JAX checkpoint's
    ``opt.pdopt`` holds: ``<JAX parameter name>.<slot>`` (Paddle's unique
    names, such as ``linear_0.w_0.moment1``), ``@global_step`` and
    ``@lr`` — with each parameter name replaced by the port's, for
    ``torch_opt.set_state_dict``. Values are kept as they are.

    ``names`` maps each JAX parameter name to the port's. By default the
    JAX parameters are paired in order with ``torch_opt``'s parameters,
    as ``optimizer_state_from_jax`` pairs them, the JAX order being the
    one in which the names first appear in ``state``: the JAX optimizer's
    first update, over its parameters in order (every one that had a
    gradient; otherwise pass ``names``, e.g. from
    ``[p.name for p in jax_opt._param_groups]``). Model state needs no
    renaming: the port's names are the JAX ``state_dict`` names
    (``gpt_params_from_jax``). A rule without state (Dpsgd without
    masters) has only the ``@`` entries. Raises ``ValueError`` when the
    counts differ or a name has no counterpart."""
    if names is None:
        jnames = list(dict.fromkeys(
            k.rsplit(".", 1)[0] for k in state if not k.startswith("@")))
        tnames = [n for n, _ in torch_opt._named_params]
        if jnames and len(jnames) != len(tnames):
            raise ValueError(f"{len(jnames)} JAX parameters, "
                             f"{len(tnames)} in the port's optimizer")
        names = dict(zip(jnames, tnames))
    out = {}
    for k, v in state.items():
        if k.startswith("@"):
            out[k] = v
            continue
        jn, slot = k.rsplit(".", 1)
        if jn not in names:
            raise ValueError(f"{k}: JAX parameter {jn!r} maps to no "
                             f"parameter of the port's optimizer")
        out[f"{names[jn]}.{slot}"] = v
    return out


def scaler_state_from_jax(state, step):
    """Write a JAX ``TrainStep``'s loss-scaler state (its ``_scaler_state``:
    ``scale``, ``good`` and, dynamic, ``bad``) into the port's
    ``TrainStep`` ``step``'s, in place. Raises ``ValueError`` when the
    keys differ."""
    ts = step._scaler_state
    if ts is None or set(state) != set(ts):
        raise ValueError(f"JAX scaler state {sorted(state)}, the port's "
                         f"{None if ts is None else sorted(ts)}")
    for k, v in state.items():
        ts[k].fill_(np.asarray(v).item())
