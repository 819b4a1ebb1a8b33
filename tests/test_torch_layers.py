"""paddle_tpu_torch's layer library against the JAX package's: every
name of ``nn.functional`` (but ``sequence_mask``) and every class of
``nn/layers/{activation,common,conv,pooling,norm,loss}.py``.

The same numpy inputs, made from a seed, go through the JAX function or
layer and the port's on the CPU (a layer's weights and buffers carried
by ``convert.layer_params_from_jax``), forward and backward: the
gradient of ``sum(out * g)`` for a random ``g`` with respect to every
float input and every parameter. Tolerance, float32: rtol 1e-5 and atol
1e-5 x the largest magnitude of the JAX array (the same arithmetic, in
another order where XLA and torch sum differently). Random ops
(dropouts, Gumbel noise) cannot draw the same bits in both packages:
their deterministic parts are held to the JAX functions, and their
masks to the rules they follow.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.nn.initializer as JI
from paddle_tpu import ops as jops
from paddle_tpu.ops import _base as jbase
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import convert, ops as tops
from paddle_tpu_torch.ops import activation as tact
from paddle_tpu_torch.ops import norm_ops, random_ops

from torch_test_threads import torch_threads  # noqa: F401,E402

R = np.random.RandomState(0)


@pytest.fixture(autouse=True, scope="module")
def numpy_initializers():
    """The JAX package's initializers (``Constant``, ``Normal``,
    ``Uniform``, ``XavierUniform``: all these layers use) drawing from
    numpy while the module's tests run: the same laws, without compiling
    a JAX random op for every parameter shape (~2 s each here). The
    weights are copied into the port's layers either way."""
    rng = np.random.RandomState(0)
    real = JI.Initializer.__call__

    def draw(init, shape, dtype="float32", key=None):
        shape = tuple(int(s) for s in shape)
        if isinstance(init, JI.Constant):
            a = np.full(shape, init.value)
        elif isinstance(init, JI.Normal):
            a = rng.normal(init.mean, init.std, shape)
        elif isinstance(init, JI.Uniform):
            a = rng.uniform(init.low, init.high, shape)
        elif isinstance(init, JI.XavierUniform):
            fan_in, fan_out = JI._fans(shape)
            limit = init.gain * math.sqrt(6.0 / (fan_in + fan_out))
            a = rng.uniform(-limit, limit, shape)
        else:
            return real(init, shape, dtype, key)
        return jnp.asarray(a.astype(np.dtype(dtype)))

    JI.Initializer.__call__ = draw
    yield
    JI.Initializer.__call__ = real


def _f(*shape, scale=1.0, shift=0.0):
    return (R.randn(*shape) * scale + shift).astype(np.float32)


def _i(high, *shape, low=0):
    return R.randint(low, high, shape).astype(np.int64)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._data).astype(np.float32)


def _close(got, want, what=""):
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _compare(jfn, tfn, arrays, jlayer=None, tlayer=None, grad=True):
    """``jfn``/``tfn`` on JAX/torch tensors of ``arrays``: outputs, and
    (``grad``) the gradients of every float input and every parameter of
    ``jlayer``/``tlayer``."""
    floats = [a.dtype == np.float32 for a in arrays]
    jin = [jpt.to_tensor(a, stop_gradient=not (grad and f))
           for a, f in zip(arrays, floats)]
    tin = [torch.from_numpy(a.copy()).requires_grad_(grad and f)
           for a, f in zip(arrays, floats)]
    jout, tout = _leaves(jfn(*jin)), _leaves(tfn(*tin))
    assert len(jout) == len(tout)
    for i, (t, j) in enumerate(zip(tout, jout)):
        assert tuple(t.shape) == tuple(j.shape), (i, t.shape, j.shape)
        _close(_np(t), _np(j), f"output {i}")
    if not grad or not (any(floats) or tlayer is not None and
                        any(True for _ in tlayer.parameters())):
        return
    rng = np.random.RandomState(1)
    gs = [np.asarray(rng.randn(*t.shape), np.float32) for t in tout
          if t.is_floating_point()]
    pairs = [(t, j) for t, j in zip(tout, jout) if t.is_floating_point()]
    sum((j * jpt.to_tensor(g)).sum() for (_, j), g in zip(pairs, gs)) \
        .backward()
    sum((t * torch.from_numpy(g)).sum() for (t, _), g in zip(pairs, gs)) \
        .backward()
    for k, (t, j, f) in enumerate(zip(tin, jin, floats)):
        if not f:
            continue
        if j.grad is None or t.grad is None:
            # no path from this input (a label): none, or zeros
            assert all(g is None or not _np(g).any()
                       for g in (j.grad, t.grad)), k
            continue
        _close(_np(t.grad), _np(j.grad), f"input {k} gradient")
    if tlayer is not None:
        jp = dict(jlayer.named_parameters())
        for name, p in tlayer.named_parameters():
            _close(_np(p.grad), _np(jp[name].grad), f"d {name}")


# -- nn.functional ------------------------------------------------------------

X = _f(2, 6, 5, 4)            # an NCHW input with some |x| > 6
X8 = _f(3, 8, scale=4.0)      # wide enough to cross every threshold
LOGP = _f(4, 5)
PROB = (1 / (1 + np.exp(-_f(4, 5)))).astype(np.float32)
LAB5 = _i(5, 4)
Y01 = (R.rand(4, 5) > 0.5).astype(np.float32)
PM1 = np.where(R.rand(4) > 0.5, 1.0, -1.0).astype(np.float32)

# (id, F -> function of tensors, inputs): F is the JAX or the port's
# nn.functional, which take the same names and arguments
FUNCTIONAL = [
    ("relu", lambda F: F.relu, [X8]),
    ("relu6", lambda F: F.relu6, [X8]),
    ("sigmoid", lambda F: F.sigmoid, [X8]),
    ("tanh", lambda F: F.tanh, [X8]),
    ("log_sigmoid", lambda F: F.log_sigmoid, [X8]),
    ("softplus", lambda F: lambda x: F.softplus(x, 2.0, 6.0), [X8]),
    ("leaky_relu", lambda F: lambda x: F.leaky_relu(x, 0.2), [X8]),
    ("elu", lambda F: lambda x: F.elu(x, 0.7), [X8]),
    ("celu", lambda F: lambda x: F.celu(x, 1.5), [X8]),
    ("selu", lambda F: F.selu, [X8]),
    ("prelu-scalar", lambda F: F.prelu, [X8, np.array([0.3], np.float32)]),
    ("prelu-channels", lambda F: F.prelu, [X, _f(6)]),
    ("hardtanh", lambda F: lambda x: F.hardtanh(x, -2.0, 3.0), [X8]),
    ("hardshrink", lambda F: lambda x: F.hardshrink(x, 1.0), [X8]),
    ("softshrink", lambda F: lambda x: F.softshrink(x, 1.0), [X8]),
    ("thresholded_relu", lambda F: lambda x: F.thresholded_relu(x, 1.5),
     [X8]),
    ("softsign", lambda F: F.softsign, [X8]),
    ("silu", lambda F: F.silu, [X8]),
    ("swish", lambda F: F.swish, [X8]),
    ("mish", lambda F: F.mish, [X8]),
    ("hardswish", lambda F: F.hardswish, [X8]),
    ("hardsigmoid", lambda F: F.hardsigmoid, [X8]),
    ("tanhshrink", lambda F: F.tanhshrink, [X8]),
    ("gelu", lambda F: lambda x: F.gelu(x, True), [X8]),
    ("softmax", lambda F: lambda x: F.softmax(x, axis=1), [X]),
    ("log_softmax", lambda F: lambda x: F.log_softmax(x, axis=0), [X8]),
    ("maxout", lambda F: lambda x: F.maxout(x, 3), [X]),
    ("glu", lambda F: lambda x: F.glu(x, axis=1), [X]),
    ("conv1d", lambda F: lambda x, w, b: F.conv1d(x, w, b, stride=2,
                                                  padding=[1, 2]),
     [_f(2, 4, 9), _f(6, 4, 3), _f(6)]),
    ("conv1d-groups-dilation", lambda F: lambda x, w: F.conv1d(
        x, w, padding="SAME", dilation=2, groups=2),
     [_f(2, 4, 9), _f(6, 2, 3)]),
    ("conv2d", lambda F: lambda x, w, b: F.conv2d(x, w, b, padding=1),
     [X, _f(3, 6, 3, 3), _f(3)]),
    ("conv3d", lambda F: lambda x, w, b: F.conv3d(x, w, b, stride=(1, 2, 1),
                                                  padding=1),
     [_f(2, 3, 4, 5, 4), _f(4, 3, 3, 3, 3), _f(4)]),
    ("conv1d_transpose", lambda F: lambda x, w, b: F.conv1d_transpose(
        x, w, b, stride=2, padding=1, output_padding=1),
     [_f(2, 4, 7), _f(4, 3, 3), _f(3)]),
    ("conv2d_transpose-groups", lambda F: lambda x, w: F.conv2d_transpose(
        x, w, stride=2, padding=[1, 0], dilation=2, groups=2),
     [_f(2, 4, 5, 5), _f(4, 3, 3, 3)]),
    ("conv2d_transpose-output_size", lambda F: lambda x, w: F.conv2d_transpose(
        x, w, stride=2, padding=1, output_size=[10, 9]),
     [_f(2, 4, 5, 5), _f(4, 3, 3, 3)]),
    ("conv3d_transpose", lambda F: lambda x, w, b: F.conv3d_transpose(
        x, w, b, stride=2, padding=1),
     [_f(1, 3, 3, 4, 3), _f(3, 2, 3, 3, 3), _f(2)]),
    ("max_pool1d", lambda F: lambda x: F.max_pool1d(x, 3, 2, 1),
     [_f(2, 4, 9)]),
    ("max_pool2d-uneven", lambda F: lambda x: F.max_pool2d(
        x, 3, 2, [0, 1, 1, 2]), [X]),
    ("max_pool2d-nhwc", lambda F: lambda x: F.max_pool2d(
        x, 2, data_format="NHWC"), [_f(2, 4, 6, 3)]),
    ("max_pool3d", lambda F: lambda x: F.max_pool3d(x, 2, 1, 1),
     [_f(2, 3, 4, 5, 4)]),
    ("avg_pool1d-exclusive", lambda F: lambda x: F.avg_pool1d(x, 3, 2, 1),
     [_f(2, 4, 9)]),
    ("avg_pool1d-inclusive", lambda F: lambda x: F.avg_pool1d(
        x, 3, 2, 1, exclusive=False), [_f(2, 4, 9)]),
    ("avg_pool2d-inclusive", lambda F: lambda x: F.avg_pool2d(x, 3, 2, 1),
     [X]),
    ("avg_pool2d-exclusive", lambda F: lambda x: F.avg_pool2d(
        x, 3, 2, "SAME", count_include_pad=False), [X]),
    ("avg_pool3d", lambda F: lambda x: F.avg_pool3d(x, 2, 2, 1),
     [_f(2, 3, 4, 5, 4)]),
    ("adaptive_avg_pool1d", lambda F: lambda x: F.adaptive_avg_pool1d(x, 4),
     [_f(2, 3, 9)]),
    ("adaptive_avg_pool2d", lambda F: lambda x: F.adaptive_avg_pool2d(
        x, (2, 3)), [X]),
    ("adaptive_max_pool1d", lambda F: lambda x: F.adaptive_max_pool1d(x, 4),
     [_f(2, 3, 9)]),
    ("adaptive_max_pool2d-even", lambda F: lambda x: F.adaptive_max_pool2d(
        x, 2), [_f(2, 3, 4, 6)]),
    ("interpolate-nearest", lambda F: lambda x: F.interpolate(
        x, scale_factor=2), [X]),
    ("interpolate-nearest-corners", lambda F: lambda x: F.interpolate(
        x, size=(7, 3), align_corners=True), [X]),
    ("interpolate-bilinear", lambda F: lambda x: F.interpolate(
        x, size=(7, 9), mode="bilinear"), [X]),
    ("interpolate-bilinear-mode1", lambda F: lambda x: F.interpolate(
        x, size=(3, 7), mode="bilinear", align_mode=1), [X]),
    ("interpolate-bilinear-corners", lambda F: lambda x: F.upsample(
        x, size=(10, 8), mode="bilinear", align_corners=True), [X]),
    ("interpolate-bicubic", lambda F: lambda x: F.interpolate(
        x, size=(7, 6), mode="bicubic"), [X]),
    ("interpolate-linear", lambda F: lambda x: F.interpolate(
        x, size=[11], mode="linear"), [_f(2, 3, 6)]),
    ("interpolate-trilinear", lambda F: lambda x: F.interpolate(
        x, scale_factor=1.5, mode="trilinear"), [_f(1, 2, 3, 4, 4)]),
    ("interpolate-area", lambda F: lambda x: F.interpolate(
        x, size=(2, 2), mode="area"), [X]),
    ("pixel_shuffle", lambda F: lambda x: F.pixel_shuffle(x, 2),
     [_f(2, 8, 3, 4)]),
    ("unfold", lambda F: lambda x: F.unfold(x, [2, 3], 1, 1, [1, 2]), [X]),
    ("affine_grid", lambda F: lambda t: F.affine_grid(t, [2, 3, 5, 4]),
     [_f(2, 2, 3)]),
    ("affine_grid-centres", lambda F: lambda t: F.affine_grid(
        t, [2, 3, 4, 6], align_corners=False), [_f(2, 2, 3)]),
    ("batch_norm-eval", lambda F: lambda x, m, v, w, b: F.batch_norm(
        x, m, v, w, b), [X, _f(6), np.abs(_f(6)) + 0.5, _f(6), _f(6)]),
    ("layer_norm", lambda F: lambda x, w, b: F.layer_norm(x, [5, 4], w, b),
     [X, _f(5, 4), _f(5, 4)]),
    ("group_norm", lambda F: lambda x, w, b: F.group_norm(x, 3, w, b), [
        X, _f(6), _f(6)]),
    ("group_norm-nhwc", lambda F: lambda x: F.group_norm(
        x, 2, data_format="NHWC"), [_f(2, 3, 4, 6)]),
    ("instance_norm", lambda F: lambda x, w, b: F.instance_norm(
        x, weight=w, bias=b), [X, _f(6), _f(6)]),
    ("normalize", lambda F: lambda x: F.normalize(x, p=3, axis=2), [X]),
    ("local_response_norm", lambda F: lambda x: F.local_response_norm(
        x, 3, alpha=0.1), [X]),
    ("dropout-eval", lambda F: lambda x: F.dropout(
        x, 0.4, training=False, mode="downscale_in_infer"), [X]),
    ("dropout2d-eval", lambda F: lambda x: F.dropout2d(x, 0.4,
                                                       training=False), [X]),
    ("dropout3d-eval", lambda F: lambda x: F.dropout3d(
        x, 0.4, training=False), [_f(2, 3, 2, 3, 2)]),
    ("alpha_dropout-eval", lambda F: lambda x: F.alpha_dropout(
        x, 0.4, training=False), [X]),
    ("channel_shuffle", lambda F: lambda x: F.channel_shuffle(x, 3), [X]),
    ("pad-constant", lambda F: lambda x: F.pad(x, [1, 2, 0, 1], value=0.5),
     [X]),
    ("pad-every-axis", lambda F: lambda x: F.pad(
        x, [0, 1, 1, 0, 2, 2, 1, 1]), [X]),
    ("pad-reflect", lambda F: lambda x: F.pad(x, [2, 1, 1, 2],
                                              mode="reflect"), [X]),
    ("pad-replicate-nhwc", lambda F: lambda x: F.pad(
        x, [1, 2, 2, 1], mode="replicate", data_format="NHWC"), [X]),
    ("pad-circular", lambda F: lambda x: F.pad(x, [1, 2], mode="circular"),
     [_f(2, 3, 5)]),
    ("linear", lambda F: F.linear, [_f(3, 4), _f(4, 5), _f(5)]),
    ("embedding", lambda F: lambda i, w: F.embedding(i, w, padding_idx=2),
     [_i(7, 3, 4), _f(7, 5)]),
    ("one_hot", lambda F: lambda i: F.one_hot(i, 6), [_i(6, 3, 4)]),
    ("cosine_similarity", lambda F: lambda a, b: F.cosine_similarity(
        a, b, axis=-1), [_f(4, 6), _f(4, 6)]),
    ("pairwise_distance", lambda F: lambda a, b: F.pairwise_distance(
        a, b, p=3.0, keepdim=True), [_f(4, 6), _f(4, 6)]),
    ("label_smooth", lambda F: lambda y: F.label_smooth(y, epsilon=0.2),
     [Y01]),
    ("label_smooth-prior", lambda F: lambda y, p: F.label_smooth(
        y, p, epsilon=0.2), [Y01, PROB]),
    ("bilinear", lambda F: F.bilinear, [_f(4, 3), _f(4, 5), _f(2, 3, 5),
                                        _f(1, 2)]),
    ("scaled_dot_product_attention", lambda F: lambda q, k, v:
        F.scaled_dot_product_attention(q, k, v, is_causal=True),
     [_f(2, 6, 2, 8), _f(2, 6, 2, 8), _f(2, 6, 2, 8)]),
    ("cross_entropy", lambda F: lambda x, y: F.cross_entropy(
        x, y, label_smoothing=0.1), [LOGP, LAB5]),
    ("cross_entropy-soft", lambda F: lambda x, y: F.cross_entropy(
        x, y, soft_label=True), [LOGP, PROB]),
    ("softmax_with_cross_entropy", lambda F: lambda x, y:
        F.softmax_with_cross_entropy(x, y, return_softmax=True),
     [LOGP, LAB5[:, None]]),
    ("nll_loss", lambda F: lambda x, y, w: F.nll_loss(
        x, y, w, ignore_index=1), [LOGP, LAB5, np.abs(_f(5))]),
    ("nll_loss-nchw", lambda F: lambda x, y: F.nll_loss(
        x, y, reduction="sum"), [_f(2, 5, 3), _i(5, 2, 3)]),
    ("kl_div", lambda F: lambda x, y: F.kl_div(x, y, "batchmean"),
     [LOGP, PROB]),
    ("binary_cross_entropy", lambda F: lambda x, y, w:
        F.binary_cross_entropy(x, y, w), [PROB, Y01, np.abs(_f(5))]),
    ("binary_cross_entropy_with_logits", lambda F: lambda x, y, p:
        F.binary_cross_entropy_with_logits(x, y, pos_weight=p,
                                           reduction="none"),
     [LOGP, Y01, np.abs(_f(5))]),
    ("mse_loss", lambda F: F.mse_loss, [LOGP, PROB]),
    ("l1_loss", lambda F: lambda x, y: F.l1_loss(x, y, "sum"),
     [LOGP, PROB]),
    ("smooth_l1_loss", lambda F: lambda x, y: F.smooth_l1_loss(
        x, y, delta=0.5), [LOGP, PROB]),
    ("margin_ranking_loss", lambda F: lambda a, b, y: F.margin_ranking_loss(
        a, b, y, margin=0.3), [_f(4), _f(4), PM1]),
    ("cosine_embedding_loss", lambda F: lambda a, b, y:
        F.cosine_embedding_loss(a, b, y, margin=0.2), [_f(4, 6), _f(4, 6),
                                                      PM1]),
    ("square_error_cost", lambda F: F.square_error_cost, [LOGP, PROB]),
    ("log_loss", lambda F: F.log_loss, [PROB, Y01]),
    ("sigmoid_focal_loss", lambda F: lambda x, y, n: F.sigmoid_focal_loss(
        x, y, n), [LOGP, Y01, np.array(3.0, np.float32)]),
    ("hinge_embedding_loss", lambda F: lambda x, y:
        F.hinge_embedding_loss(x, y, reduction="none"), [LOGP, Y01 * 2 - 1]),
    ("triplet_margin_loss", lambda F: lambda a, p, n:
        F.triplet_margin_loss(a, p, n, swap=True), [_f(4, 6), _f(4, 6),
                                                    _f(4, 6)]),
    ("npair_loss", lambda F: F.npair_loss, [_f(4, 6), _f(4, 6),
                                            np.array([0, 1, 0, 2])]),
]


@pytest.mark.parametrize("case", FUNCTIONAL, ids=[c[0] for c in FUNCTIONAL])
def test_functional_matches(case):
    _, make, arrays = case
    _compare(make(JF), make(TF), arrays)


def test_adaptive_max_pool2d_mask_matches():
    """Values and argmax mask; forward only: the JAX op gives its input
    no gradient through this two-output variant."""
    _compare(lambda x: JF.adaptive_max_pool2d(x, (2, 3), return_mask=True),
             lambda x: TF.adaptive_max_pool2d(x, (2, 3), return_mask=True),
             [X], grad=False)


def test_transposed_conv_refuses_string_padding_as_the_reference():
    x, w = _f(2, 4, 5, 5), _f(4, 3, 3, 3)
    for F, t in ((JF, jpt.to_tensor), (TF, torch.from_numpy)):
        with pytest.raises(ValueError):
            F.conv2d_transpose(t(x), t(w), stride=2, padding="SAME")


TIES = np.array([[0.0, 0.0, -1.0, 0.0], [2.0, -3.0, 2.0, 1.0]], np.float32)

# the reductions and shape ops of ``ops`` that the layers call (O is the
# JAX package's or the port's ``ops``)
OPS = [
    ("max-ties", lambda O: lambda x: O.max(x, axis=1), [TIES]),
    ("max-all", lambda O: O.max, [X]),
    ("amax-keepdim", lambda O: lambda x: O.amax(x, axis=[0, 2],
                                                keepdim=True), [X]),
    ("min-ties", lambda O: lambda x: O.min(x, axis=-1), [-TIES]),
    ("mean", lambda O: lambda x: O.mean(x, axis=(1, 3)), [X]),
    ("transpose", lambda O: lambda x: O.transpose(x, [2, 0, 3, 1]), [X]),
    ("concat", lambda O: lambda a, b: O.concat([a, b], axis=-1),
     [_f(2, 3), _f(2, 4)]),
    ("stack", lambda O: lambda a, b: O.stack([a, b], axis=1),
     [_f(2, 3), _f(2, 3)]),
    ("split-sections", lambda O: lambda x: O.split(x, [2, -1, 1], axis=1),
     [X]),
    ("split-equal", lambda O: lambda x: O.split(x, 3, axis=1), [X]),
    ("squeeze", lambda O: lambda x: O.squeeze(x, [1, 2]), [_f(2, 1, 3, 1)]),
    ("unsqueeze", lambda O: lambda x: O.unsqueeze(x, [0, -1]), [_f(2, 3)]),
]


@pytest.mark.parametrize("case", OPS, ids=[c[0] for c in OPS])
def test_ops_match(case):
    """Ties split the gradient evenly in both (``amax``'s rule)."""
    _, make, arrays = case
    _compare(make(jops), make(tops), arrays)


def _grid(n, h, w):
    """Sampling points that reach past [-1, 1] and off the pixel grid."""
    return (R.rand(n, h, w, 2) * 2.6 - 1.3).astype(np.float32)


@pytest.mark.parametrize("mode, padding_mode, align", [
    ("bilinear", "zeros", True), ("bilinear", "reflection", False),
    ("nearest", "border", False)])
def test_grid_sample_matches(mode, padding_mode, align):
    def fn(F):
        return lambda x, g: F.grid_sample(x, g, mode=mode,
                                          padding_mode=padding_mode,
                                          align_corners=align)

    # the grid's own gradient has kinks at pixel edges: held only for x
    x, g = _f(2, 3, 5, 4), _grid(2, 3, 6)
    _compare(lambda jx: fn(JF)(jx, jpt.to_tensor(g)),
             lambda tx: fn(TF)(tx, torch.from_numpy(g)), [x])


_T, _B, _C = 9, 3, 5
CTC_LOGP = _f(_T, _B, _C)
CTC_LOGP -= np.log(np.exp(CTC_LOGP).sum(-1, keepdims=True))
# labels in 1..3, so that both blanks below are free; each row's length
CTC_INTS = [np.array([[1, 2, 2], [3, 1, 0], [1, 0, 0]]), np.array([9, 6, 4]),
            np.array([3, 2, 1])]


@pytest.mark.parametrize("how", ["functional", "layer"])
def test_ctc_loss_matches(how):
    """``F.ctc_loss`` with blank 4 and no reduction; ``CTCLoss`` with blank
    0, ``mean`` and ``norm_by_times``: the same shapes, so the JAX side
    compiles its scan once."""
    if how == "functional":
        kw = dict(reduction="none", blank=4)
        jfn = lambda x, *a: JF.ctc_loss(x, *a, **kw)
        tfn = lambda x, *a: TF.ctc_loss(x, *a, **kw)
    else:
        jl, tl = jnn.CTCLoss(), tnn.CTCLoss()
        jfn = lambda x, *a: jl(x, *a, norm_by_times=True)
        tfn = lambda x, *a: tl(x, *a, norm_by_times=True)
    _compare(lambda x: jfn(x, *[jpt.to_tensor(a) for a in CTC_INTS]),
             lambda x: tfn(x, *[torch.from_numpy(a) for a in CTC_INTS]),
             [CTC_LOGP])


def test_gumbel_softmax_is_the_reference_on_the_same_noise():
    """The deterministic part on the same Gumbel noise ``g`` (soft and
    hard, straight-through); the port's draw is a Gumbel sample."""
    x, g = _f(4, 6), _f(4, 6)
    for hard in (False, True):
        _compare(lambda t: jbase.apply("gumbel_softmax_det", t,
                                       jpt.to_tensor(g), temperature=0.7,
                                       hard=hard, axis=-1),
                 lambda t: tact._gumbel_softmax_det(
                     t, torch.from_numpy(g), temperature=0.7, hard=hard,
                     axis=-1), [x])
    gen = torch.Generator().manual_seed(0)
    y = TF.gumbel_softmax(torch.zeros(20000, 3), hard=True, generator=gen)
    assert ((y == 0) | (y == 1)).all() and (y.sum(-1) == 1).all()
    assert abs(float(y.mean(0).std())) < 0.01   # every class ~1/3


@pytest.mark.parametrize("fn, axis", [
    ("dropout2d", (0, 1)), ("dropout3d", (0, 1))])
def test_channel_dropouts_drop_whole_maps(fn, axis):
    x = torch.ones(8, 16, 3, 4) if fn == "dropout2d" else \
        torch.ones(8, 16, 2, 3, 2)
    gen = torch.Generator().manual_seed(0)
    y = getattr(random_ops, fn)(x, 0.5, generator=gen)
    per_map = y.reshape(8, 16, -1)
    assert ((per_map == 0).all(-1) | (per_map == 2.0).all(-1)).all()
    assert 0.3 < float((per_map[..., 0] == 0).float().mean()) < 0.7


def test_alpha_dropout_keeps_mean_and_variance():
    """Each element is ``a x + b`` or ``a alpha' + b`` (the JAX formula,
    ``random_ops.py:74-82``), and over SELU-normal data the mean and
    variance stay ~0 and ~1."""
    p = 0.3
    x = torch.randn(200000, generator=torch.Generator().manual_seed(1))
    y = TF.alpha_dropout(x, p, generator=torch.Generator().manual_seed(2))
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = ((1 - p) + alpha_p ** 2 * (1 - p) * p) ** -0.5
    b = -a * alpha_p * p
    kept = torch.isclose(y, a * x + b)
    assert (kept | torch.isclose(y, torch.tensor(a * alpha_p + b))).all()
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.01
    assert abs(float(y.mean())) < 0.02 and abs(float(y.var()) - 1) < 0.03


def test_functional_exports_every_reference_name_but_sequence_mask():
    assert set(JF.__all__) - set(TF.__all__) == {"sequence_mask"}


# -- the layer classes --------------------------------------------------------

def _xs(*shape):
    return [_f(*shape)]


# (id, (ns, kw) -> layer, inputs): ns is the JAX or the port's nn, kw
# device="cpu" for the port's layers with parameters or buffers. Most
# take a functional case's arguments and shapes, so that the JAX side
# reuses that case's compiled ops
LAYERS = [
    ("ReLU", lambda n, d: n.ReLU(), [X8]),
    ("ReLU6", lambda n, d: n.ReLU6(), [X8]),
    ("LeakyReLU", lambda n, d: n.LeakyReLU(0.2), [X8]),
    ("PReLU", lambda n, d: n.PReLU(6, 0.1, **d), [X]),
    ("ELU", lambda n, d: n.ELU(0.7), [X8]),
    ("CELU", lambda n, d: n.CELU(1.5), [X8]),
    ("SELU", lambda n, d: n.SELU(), [X8]),
    ("GELU", lambda n, d: n.GELU(True), [X8]),
    ("Sigmoid", lambda n, d: n.Sigmoid(), [X8]),
    ("LogSigmoid", lambda n, d: n.LogSigmoid(), [X8]),
    ("Tanh", lambda n, d: n.Tanh(), [X8]),
    ("Tanhshrink", lambda n, d: n.Tanhshrink(), [X8]),
    ("Softmax", lambda n, d: n.Softmax(1), [X]),
    ("LogSoftmax", lambda n, d: n.LogSoftmax(0), [X8]),
    ("Softplus", lambda n, d: n.Softplus(2.0, 6.0), [X8]),
    ("Softshrink", lambda n, d: n.Softshrink(1.0), [X8]),
    ("Softsign", lambda n, d: n.Softsign(), [X8]),
    ("Swish", lambda n, d: n.Swish(), [X8]),
    ("Silu", lambda n, d: n.Silu(), [X8]),
    ("Mish", lambda n, d: n.Mish(), [X8]),
    ("Hardtanh", lambda n, d: n.Hardtanh(-2.0, 3.0), [X8]),
    ("Hardshrink", lambda n, d: n.Hardshrink(1.0), [X8]),
    ("Hardsigmoid", lambda n, d: n.Hardsigmoid(), [X8]),
    ("Hardswish", lambda n, d: n.Hardswish(), [X8]),
    ("ThresholdedReLU", lambda n, d: n.ThresholdedReLU(1.5), [X8]),
    ("Maxout", lambda n, d: n.Maxout(3), [X]),
    ("GLU", lambda n, d: n.GLU(1), [X]),
    ("Identity", lambda n, d: n.Identity(), [X]),
    ("Linear", lambda n, d: n.Linear(4, 5, **d), _xs(3, 4)),
    ("Dropout-eval", lambda n, d: n.Dropout(0.3, mode="downscale_in_infer"),
     [X]),
    ("Dropout2D-eval", lambda n, d: n.Dropout2D(0.3), [X]),
    ("Dropout3D-eval", lambda n, d: n.Dropout3D(0.3), _xs(2, 3, 2, 2, 2)),
    ("AlphaDropout-eval", lambda n, d: n.AlphaDropout(0.3), [X]),
    ("Embedding", lambda n, d: n.Embedding(7, 5, padding_idx=2, **d),
     [_i(7, 3, 4)]),
    ("Flatten", lambda n, d: n.Flatten(1, 2), [X]),
    ("Pad1D", lambda n, d: n.Pad1D([1, 2], mode="reflect"), _xs(2, 3, 5)),
    ("Pad2D", lambda n, d: n.Pad2D([1, 2, 0, 1], value=0.5), [X]),
    ("Pad3D", lambda n, d: n.Pad3D([1, 1, 0, 1, 1, 0], mode="replicate"),
     _xs(1, 2, 3, 3, 4)),
    ("ZeroPad2D", lambda n, d: n.ZeroPad2D([2, 1, 0, 1]), [X]),
    ("Upsample", lambda n, d: n.Upsample(scale_factor=1.5, mode="bicubic"),
     [X]),
    ("UpsamplingNearest2D", lambda n, d: n.UpsamplingNearest2D(
        scale_factor=2), [X]),
    ("UpsamplingBilinear2D", lambda n, d: n.UpsamplingBilinear2D(
        scale_factor=2), [X]),
    ("CosineSimilarity", lambda n, d: n.CosineSimilarity(axis=-1),
     [_f(4, 6), _f(4, 6)]),
    ("PairwiseDistance", lambda n, d: n.PairwiseDistance(3.0, keepdim=True),
     [_f(4, 6), _f(4, 6)]),
    ("Bilinear", lambda n, d: n.Bilinear(3, 5, 2, **d), [_f(4, 3),
                                                         _f(4, 5)]),
    ("Unfold", lambda n, d: n.Unfold([2, 3], 1, 1, [1, 2]), [X]),
    ("PixelShuffle", lambda n, d: n.PixelShuffle(2), _xs(2, 8, 3, 4)),
    ("ChannelShuffle", lambda n, d: n.ChannelShuffle(3), [X]),
    ("Conv1D", lambda n, d: n.Conv1D(4, 6, 3, stride=2, padding=[1, 2],
                                     **d), _xs(2, 4, 9)),
    ("Conv2D", lambda n, d: n.Conv2D(6, 3, 3, padding=1, **d), [X]),
    ("Conv3D", lambda n, d: n.Conv3D(3, 4, 3, stride=(1, 2, 1), padding=1,
                                     **d), _xs(2, 3, 4, 5, 4)),
    ("Conv1DTranspose", lambda n, d: n.Conv1DTranspose(
        4, 3, 3, stride=2, padding=1, output_padding=1, **d),
     _xs(2, 4, 7)),
    ("Conv2DTranspose", lambda n, d: n.Conv2DTranspose(
        4, 6, 3, stride=2, padding=[1, 0], dilation=2, groups=2, **d),
     _xs(2, 4, 5, 5)),
    ("Conv3DTranspose", lambda n, d: n.Conv3DTranspose(
        3, 2, 3, stride=2, padding=1, **d), _xs(1, 3, 3, 4, 3)),
    ("MaxPool1D", lambda n, d: n.MaxPool1D(3, 2, 1), _xs(2, 4, 9)),
    ("MaxPool2D", lambda n, d: n.MaxPool2D(3, 2, [0, 1, 1, 2]), [X]),
    ("MaxPool3D", lambda n, d: n.MaxPool3D(2, 1, 1), _xs(2, 3, 4, 5, 4)),
    ("AvgPool1D", lambda n, d: n.AvgPool1D(3, 2, 1), _xs(2, 4, 9)),
    ("AvgPool2D", lambda n, d: n.AvgPool2D(3, 2, 1), [X]),
    ("AvgPool3D", lambda n, d: n.AvgPool3D(2, 2, 1), _xs(2, 3, 4, 5, 4)),
    ("AdaptiveAvgPool1D", lambda n, d: n.AdaptiveAvgPool1D(4),
     _xs(2, 3, 9)),
    ("AdaptiveAvgPool2D", lambda n, d: n.AdaptiveAvgPool2D((2, 3)), [X]),
    ("AdaptiveMaxPool1D", lambda n, d: n.AdaptiveMaxPool1D(4),
     _xs(2, 3, 9)),
    ("AdaptiveMaxPool2D", lambda n, d: n.AdaptiveMaxPool2D(2),
     _xs(2, 3, 4, 6)),
    ("LayerNorm", lambda n, d: n.LayerNorm([5, 4], **d), [X]),
    ("BatchNorm-act", lambda n, d: n.BatchNorm(6, act="relu", **d), [X]),
    ("BatchNorm1D", lambda n, d: n.BatchNorm1D(6, **d), _xs(5, 6)),
    ("BatchNorm2D", lambda n, d: n.BatchNorm2D(6, momentum=0.8, **d), [X]),
    ("BatchNorm3D", lambda n, d: n.BatchNorm3D(3, **d),
     _xs(2, 3, 2, 3, 2)),
    ("SyncBatchNorm", lambda n, d: n.SyncBatchNorm(6, **d), [X]),
    ("GroupNorm", lambda n, d: n.GroupNorm(3, 6, **d), [X]),
    ("InstanceNorm1D", lambda n, d: n.InstanceNorm1D(3, **d), _xs(2, 3, 7)),
    ("InstanceNorm2D", lambda n, d: n.InstanceNorm2D(6, **d), [X]),
    ("InstanceNorm3D", lambda n, d: n.InstanceNorm3D(
        3, weight_attr=False, **d), _xs(2, 3, 2, 3, 2)),
    ("LocalResponseNorm", lambda n, d: n.LocalResponseNorm(3, 0.1), [X]),
    ("SpectralNorm", lambda n, d: n.SpectralNorm((6, 5, 4), dim=1,
                                                 power_iters=3, **d),
     _xs(6, 5, 4)),
    ("CrossEntropyLoss", lambda n, d: n.CrossEntropyLoss(
        label_smoothing=0.1), [LOGP, LAB5]),
    ("NLLLoss", lambda n, d: n.NLLLoss(reduction="none"), [LOGP, LAB5]),
    ("KLDivLoss", lambda n, d: n.KLDivLoss("batchmean"), [LOGP, PROB]),
    ("BCELoss", lambda n, d: n.BCELoss(), [PROB, Y01]),
    ("BCEWithLogitsLoss", lambda n, d: n.BCEWithLogitsLoss(), [LOGP, Y01]),
    ("MSELoss", lambda n, d: n.MSELoss(), [LOGP, PROB]),
    ("L1Loss", lambda n, d: n.L1Loss("sum"), [LOGP, PROB]),
    ("SmoothL1Loss", lambda n, d: n.SmoothL1Loss(delta=0.5), [LOGP, PROB]),
    ("MarginRankingLoss", lambda n, d: n.MarginRankingLoss(0.3),
     [_f(4), _f(4), PM1]),
    ("CosineEmbeddingLoss", lambda n, d: n.CosineEmbeddingLoss(0.2),
     [_f(4, 6), _f(4, 6), PM1]),
    ("HingeEmbeddingLoss", lambda n, d: n.HingeEmbeddingLoss(
        reduction="none"),
     [LOGP, Y01 * 2 - 1]),
    ("TripletMarginLoss", lambda n, d: n.TripletMarginLoss(swap=True),
     [_f(4, 6), _f(4, 6), _f(4, 6)]),
]


def _port_layer(make, jlayer):
    tlayer = make(tnn, dict(device="cpu"))
    state = {k: np.asarray(v._data) for k, v in jlayer.state_dict().items()}
    if state or len(tlayer.state_dict()):
        tlayer.load_state_dict(convert.layer_params_from_jax(state, tlayer))
    return tlayer


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_layer_matches(case):
    name, make, arrays = case
    jlayer = make(jnn, {})
    tlayer = _port_layer(make, jlayer)
    if name.endswith("-eval"):
        jlayer.eval()
        tlayer.eval()
    _compare(jlayer, tlayer, arrays, jlayer, tlayer)
    if hasattr(jlayer, "_mean"):   # a BatchNorm's running statistics
        for buf in ("_mean", "_variance"):
            _close(_np(getattr(tlayer, buf)), _np(getattr(jlayer, buf)),
                   buf)


def test_rnn_layer_classes_are_covered_by_their_own_file():
    """The recurrent classes are held to the JAX ones in
    ``test_torch_rnn.py``; here only that every class of the seven
    modules exists in the port."""
    import paddle_tpu.nn.layers as jl

    names = set()
    for mod in ("activation", "common", "conv", "pooling", "norm", "loss",
                "rnn"):
        names |= set(getattr(jl, mod).__all__)
    assert not names - set(dir(tnn))
    held = {c[0].split("-")[0] for c in LAYERS} | {"CTCLoss"}
    assert names - set(jl.rnn.__all__) - held == set()


def test_train_mode_dropouts_keep_or_drop_whole_maps():
    x = torch.ones(4, 6, 3, 3)
    y = tnn.Dropout2D(0.5)(x)
    maps = y.reshape(4, 6, -1)
    assert ((maps == 0).all(-1) | (maps == 2.0).all(-1)).all()
    assert torch.equal(tnn.AlphaDropout(0.0)(x), x)


def test_sync_batch_norm_converts_and_shares_parameters():
    model = torch.nn.Sequential(tnn.Conv2D(3, 4, 3, device="cpu"),
                                tnn.BatchNorm2D(4, device="cpu"))
    bn = model[1]
    out = tnn.SyncBatchNorm.convert_sync_batchnorm(model)
    assert isinstance(out[1], tnn.SyncBatchNorm)
    assert out[1].weight is bn.weight and out[1]._mean is bn._mean
    x = torch.from_numpy(_f(2, 3, 6, 6))
    torch.testing.assert_close(out(x), torch.nn.Sequential(
        model[0], bn)(x), rtol=0, atol=0)


def test_prelu_and_spectral_norm_state_crosses_by_name():
    """``layer_params_from_jax`` carries a ``PReLU``'s weight and a
    ``SpectralNorm``'s ``weight_u``/``weight_v`` buffers, and refuses a
    wrong shape."""
    j = jnn.SpectralNorm((4, 5))
    t = tnn.SpectralNorm((4, 5), device="cpu")
    state = {k: np.asarray(v._data) for k, v in j.state_dict().items()}
    t.load_state_dict(convert.layer_params_from_jax(state, t))
    assert np.array_equal(t.weight_u.numpy(), state["weight_u"])
    state["weight_v"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="weight_v"):
        convert.layer_params_from_jax(state, t)
    with pytest.raises(ValueError, match="weight"):
        convert.layer_params_from_jax({"weight": np.zeros(2, np.float32)},
                                      tnn.PReLU(3, device="cpu"))


def test_spectral_norm_op_matches():
    _compare(lambda w: jbase.apply("spectral_norm_op", w, dim=1,
                                   power_iters=2, eps=1e-12),
             lambda w: norm_ops.spectral_norm(w, 1, 2),
             [_f(3, 4, 5)])
