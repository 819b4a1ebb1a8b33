"""paddle_tpu_torch's conv, pooling and BatchNorm ops against the JAX
package's.

The same numpy inputs, made from a seed, go through the JAX function
(``paddle_tpu.nn.functional``) and the port's (on the CPU), forward and
backward (the gradient of ``sum(out * g)`` for a random ``g``), in
float32 and bfloat16. Tolerances, each against the JAX result's largest
magnitude ``M``:

- float32: rtol 1e-5 and atol 1e-5 x M (float32 sums in another order);
- bfloat16: atol 2^-7 x M, rtol 0: two bfloat16 steps at the largest
  value (both round the same float32 sums to bfloat16; a sum that lies
  near a rounding boundary in one order rounds the other way in the
  other); a conv bias's gradient against the exact sum of its bfloat16
  cotangents, and eval BatchNorm's weight and bias gradients at two
  steps of the sum of their terms' magnitudes, as the JAX package sums
  those bfloat16 terms in bfloat16;
- ``max_pool2d``'s gradient on constructed ties: exactly (integer
  cotangents, so sums of several windows' are exact in any order): the
  gradient must go to the element the JAX package picks;
- BatchNorm's running statistics: float32 rtol 1e-5 (the port's
  ``var_mean`` against ``jnp.mean``/``jnp.var``); bfloat16 rtol 2^-8, one
  rounding step (the update itself runs in bfloat16 in both, with
  momentum and 1 - momentum rounded to bfloat16 first).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import ops
from paddle_tpu_torch.nn import functional as F

from torch_test_threads import torch_threads  # noqa: F401,E402

DTYPES = ["float32", "bfloat16"]
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax(a, dtype):
    return pt.to_tensor(a, dtype=dtype, stop_gradient=False)


def _torch(a, dtype):
    return torch.from_numpy(a).to(TORCH[dtype]).requires_grad_()


def _np(t):
    """A JAX or torch tensor as float32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._data).astype(np.float32)


def _close(got, want, dtype, what=""):
    scale = float(np.abs(want).max()) or 1.0
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -7 * scale,
                                   err_msg=what)


def _both(jfn, tfn, arrays, dtype, g_seed=1):
    """``jfn`` on JAX tensors and ``tfn`` on torch tensors of ``arrays``:
    ``(outputs, gradients of sum(out * g))`` of each, as float32 numpy."""
    jin = [_jax(a, dtype) for a in arrays]
    tin = [_torch(a, dtype) for a in arrays]
    jout, tout = jfn(*jin), tfn(*tin)
    g = np.random.RandomState(g_seed).randn(*tout.shape).astype(np.float32)
    (jout * pt.to_tensor(g, dtype=dtype)).sum().backward()
    (tout * torch.from_numpy(g).to(TORCH[dtype])).sum().backward()
    return ((_np(tout), _np(jout)),
            [(_np(t.grad), _np(j.grad)) for t, j in zip(tin, jin)])


CONV_CASES = [
    # stride, padding, dilation, groups, (C, H, W), (O, kh)
    (1, 0, 1, 1, (6, 11, 11), (9, 3)),
    (2, 1, 1, 1, (6, 11, 11), (9, 3)),
    (1, 2, 2, 1, (6, 11, 11), (9, 3)),
    (1, 1, 1, 3, (6, 11, 11), (9, 3)),
    (2, [1, 2, 0, 1], 1, 1, (6, 11, 11), (9, 3)),   # uneven padding
    (2, "SAME", 1, 1, (6, 11, 11), (9, 3)),
    (1, "VALID", 1, 1, (6, 11, 11), (9, 3)),
    (2, 3, 1, 1, (3, 16, 16), (8, 7)),              # ResNet's stem
    (2, 0, 1, 1, (8, 8, 8), (16, 1)),               # a 1x1/2 downsample
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride, padding, dilation, groups, chw, ok",
                         CONV_CASES)
def test_conv2d_matches(stride, padding, dilation, groups, chw, ok, dtype):
    rng = np.random.RandomState(0)
    C, H, W = chw
    O, k = ok
    x = rng.randn(2, C, H, W).astype(np.float32)
    w = rng.randn(O, C // groups, k, k).astype(np.float32)
    b = rng.randn(O).astype(np.float32)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups)
    out, grads = _both(lambda *a: JF.conv2d(*a, **kw),
                       lambda *a: F.conv2d(*a, **kw), [x, w, b], dtype)
    _close(*out, dtype, "out")
    for name, (got, want) in zip(("dx", "dw"), grads):
        _close(got, want, dtype, name)
    got, want = grads[2]
    if dtype == "bfloat16":
        # the JAX package sums the bias's bfloat16 cotangents in bfloat16
        # (0.133 for an exact 0.039 here); the port sums in float32: held
        # to the exact sum instead
        g = np.random.RandomState(1).randn(*out[0].shape).astype(np.float32)
        g = torch.from_numpy(g).to(torch.bfloat16).double().numpy()
        want = g.sum(axis=(0, 2, 3))
    _close(got, want, dtype, "db")


def _tied(seed):
    """Inputs full of ties: small integers, and the all-zero windows
    that follow ResNet's stem ReLU."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 3, (2, 3, 9, 9)).astype(np.float32)
    x[:, :, :4, :4] = 0.0
    x[0, 1] = 1.0
    return x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel, stride, padding", [(3, 2, 1), (2, 2, 0),
                                                     (3, 1, 1)])
def test_max_pool2d_sends_tied_gradients_where_the_reference_does(
        kernel, stride, padding, dtype):
    x = _tied(0)
    jin, tin = _jax(x, dtype), _torch(x, dtype)
    jout = JF.max_pool2d(jin, kernel, stride, padding)
    tout = F.max_pool2d(tin, kernel, stride, padding)
    np.testing.assert_array_equal(_np(tout), _np(jout))
    # integer cotangents: a sum over overlapping windows is exact
    g = np.random.RandomState(1).randint(1, 9, tout.shape).astype(np.float32)
    (jout * pt.to_tensor(g, dtype=dtype)).sum().backward()
    (tout * torch.from_numpy(g).to(TORCH[dtype])).sum().backward()
    np.testing.assert_array_equal(_np(tin.grad), _np(jin.grad))


@pytest.mark.parametrize("padding", [[1, 2, 0, 1], "SAME"])
def test_max_pool2d_uneven_padding_matches(padding):
    x = np.random.RandomState(0).randn(2, 3, 10, 9).astype(np.float32)
    out, grads = _both(lambda a: JF.max_pool2d(a, 3, 2, padding),
                       lambda a: F.max_pool2d(a, 3, 2, padding), [x],
                       "float32")
    np.testing.assert_array_equal(*out)
    _close(*grads[0], "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw, size", [((7, 7), 1), ((8, 6), (2, 3)),
                                      ((10, 7), (3, 2)), ((5, 5), 3)],
                         ids=["global", "divisible", "uneven", "overlap"])
def test_adaptive_avg_pool2d_matches(hw, size, dtype):
    x = np.random.RandomState(0).randn(2, 3, *hw).astype(np.float32)
    out, grads = _both(lambda a: JF.adaptive_avg_pool2d(a, size),
                       lambda a: F.adaptive_avg_pool2d(a, size), [x], dtype)
    _close(*out, dtype)
    _close(*grads[0], dtype)


def _bn_inputs(seed=0, C=6):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, C, 5, 5) * 2.0 + rng.randn(1, C, 1, 1) * 3.0)
    w = rng.randn(C) * 0.5 + 1.0
    b = rng.randn(C)
    rm = rng.randn(C)
    rv = rng.rand(C) + 0.5
    return [a.astype(np.float32) for a in (x, w, b, rm, rv)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("momentum", [0.9, 0.7])
def test_batch_norm_matches(training, momentum, dtype):
    x, w, b, rm, rv = _bn_inputs()
    jrm, jrv = (pt.to_tensor(a, dtype=dtype) for a in (rm, rv))
    trm, trv = (torch.tensor(a, dtype=TORCH[dtype]) for a in (rm, rv))
    starts = (trm.clone(), trv.clone())
    kw = dict(training=training, momentum=momentum, epsilon=1e-5)
    out, grads = _both(lambda *a: JF.batch_norm(a[0], jrm, jrv, *a[1:], **kw),
                       lambda *a: F.batch_norm(a[0], trm, trv, *a[1:], **kw),
                       [x, w, b], dtype)
    _close(*out, dtype, "out")
    _close(*grads[0], dtype, "dx")
    if training or dtype == "float32":
        for name, (got, want) in zip(("dweight", "dbias"), grads[1:]):
            _close(got, want, dtype, name)
    else:
        # eval in bfloat16: the JAX package sums the 100 bfloat16 terms
        # of each in bfloat16, the port in float32: two bfloat16 steps of
        # the sum of the terms' magnitudes
        g = np.abs(np.random.RandomState(1).randn(*x.shape))
        xhat = np.abs(x - rm[:, None, None]) / np.sqrt(rv[:, None, None])
        for name, (got, want), terms in zip(("dweight", "dbias"), grads[1:],
                                            (g * xhat, g)):
            np.testing.assert_allclose(
                got, want, rtol=0, err_msg=name,
                atol=2 ** -7 * terms.sum(axis=(0, 2, 3)).max())
    rtol = 1e-5 if dtype == "float32" else 2 ** -8
    for name, t, j, start in zip(("mean", "variance"), (trm, trv),
                                 (jrm, jrv), starts):
        assert t.dtype == TORCH[dtype]
        np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=0,
                                   err_msg=name)
        assert torch.equal(t, start) != training, name


def test_batch_norm_momentum_is_the_share_kept():
    """Paddle's semantics: running = running * m + batch * (1 - m), the
    variance unbiased by n / (n - 1); float32 by hand."""
    x, w, b, rm, rv = _bn_inputs()
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    F.batch_norm(torch.from_numpy(x), trm, trv, torch.from_numpy(w),
                 torch.from_numpy(b), training=True, momentum=0.9)
    xd = x.astype(np.float64)
    n = x.size // x.shape[1]
    mean = xd.mean(axis=(0, 2, 3))
    var = xd.var(axis=(0, 2, 3)) * n / (n - 1)
    np.testing.assert_allclose(trm.numpy(), rm * 0.9 + mean * 0.1,
                               rtol=1e-5)
    np.testing.assert_allclose(trv.numpy(), rv * 0.9 + var * 0.1, rtol=1e-5)


def test_batch_norm_updates_its_buffers_in_place():
    x, w, b, rm, rv = _bn_inputs()
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    ptrs = (trm.data_ptr(), trv.data_ptr())
    F.batch_norm(torch.from_numpy(x), trm, trv, torch.from_numpy(w),
                 torch.from_numpy(b), training=True)
    assert (trm.data_ptr(), trv.data_ptr()) == ptrs
    assert not np.array_equal(trm.numpy(), rm)


def test_flatten_matches():
    x = np.random.RandomState(0).randn(2, 3, 4, 5).astype(np.float32)
    for start, stop in ((1, -1), (0, 1), (2, 3)):
        want = np.asarray(pt.flatten(pt.to_tensor(x), start, stop)._data)
        got = ops.flatten(torch.from_numpy(x), start, stop).numpy()
        np.testing.assert_array_equal(got, want)
