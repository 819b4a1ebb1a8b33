"""paddle_tpu_torch's initializers against the JAX package's
(``paddle_tpu/nn/initializer.py``), ``set_global_initializer`` through
``create_parameter`` (``paddle_tpu/nn/layer.py:82``) and
``WeightNormParamAttr``/``do_model_average``.

- ``Bilinear``, ``Assign``, ``Dirac``, ``calculate_gain`` and the fans:
  exactly the reference's values.
- The random initializers draw from torch generators, which cannot give
  JAX's numbers: each is held to its distribution over a 512 x 768
  draw (393216 values): the bounds of a uniform exactly, its mean within
  5 standard errors and its standard deviation within 1%; a normal's
  standard deviation within 1% of the one the fans give; a truncated
  normal inside mean +- 2 std with the truncated law's standard
  deviation (0.8796 std) within 1%. The same generator seed gives the
  same bits, another seed other bits.
- ``Orthogonal``: QᵀQ = I (or QQᵀ) within 1e-5, for tall, wide and
  convolution shapes, with the reference's sign convention.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import nn as jnn
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layers.common import create_parameter

from torch_test_threads import torch_threads  # noqa: F401,E402

SHAPE = (512, 768)
ORTHO_TOL = 1e-5
STD_RTOL = 0.01
TRUNC_STD = 0.8796256610342398   # std of N(0, 1) truncated to [-2, 2]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("shape", [(), (7,), (12, 5), (6, 4, 3, 3),
                                   (8, 2, 5)])
def test_fans_are_the_reference(shape):
    assert I._fans(shape) == JI._fans(shape)


@pytest.mark.parametrize("name", ["sigmoid", "linear", "conv2d", "tanh",
                                  "relu", "leaky_relu", "selu",
                                  "conv3d_transpose"])
def test_calculate_gain_is_the_reference(name):
    assert I.calculate_gain(name) == JI.calculate_gain(name)
    assert I.calculate_gain("leaky_relu", 0.2) == \
        JI.calculate_gain("leaky_relu", 0.2)
    with pytest.raises(ValueError):
        I.calculate_gain("gelu")


@pytest.mark.parametrize("case", [
    ("bilinear", (4, 4, 4, 4)), ("bilinear", (6, 2, 5, 3)),
    ("dirac", (4, 4, 3, 3)), ("dirac", (6, 2, 3)), ("dirac_groups", (4, 2, 3, 3)),
    ("assign", (3, 4)), ("assign_reshape", (2, 6)),
    ("assign_tensor", (3, 4))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_initializers_are_the_reference(case, dtype):
    kind, shape = case
    vals = np.arange(12, dtype=np.float64).reshape(3, 4) / 7.0
    make = {
        "bilinear": lambda m: m.Bilinear(),
        "dirac": lambda m: m.Dirac(),
        "dirac_groups": lambda m: m.Dirac(groups=2),
        "assign": lambda m: m.Assign(vals),
        "assign_reshape": lambda m: m.Assign(vals),
        "assign_tensor": lambda m: m.Assign(
            torch.from_numpy(vals) if m is I else vals),
    }[kind]
    want = make(JI)(shape, dtype)
    got = make(I)(shape, getattr(torch, dtype), device="cpu")
    assert tuple(got.shape) == shape and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


def test_bilinear_needs_a_4d_weight():
    with pytest.raises(ValueError, match="4-D"):
        I.Bilinear()((3, 3), device="cpu")


RANDOM = {
    # name: (initializer, ("uniform", limit) | ("normal", std) |
    #        ("truncated", std))
    "uniform": (I.Uniform(-0.3, 0.5), ("uniform", (-0.3, 0.5))),
    "normal": (I.Normal(0.1, 0.2), ("normal", (0.1, 0.2))),
    "truncated_normal": (I.TruncatedNormal(0.05, 0.02),
                         ("truncated", (0.05, 0.02))),
    "xavier_uniform": (I.XavierUniform(),
                       ("uniform", math.sqrt(6 / (512 + 768)))),
    "xavier_normal": (I.XavierNormal(), ("normal", math.sqrt(2 / 1280))),
    "kaiming_uniform": (I.KaimingUniform(),
                        ("uniform", math.sqrt(2) * math.sqrt(3 / 512))),
    "kaiming_normal": (I.KaimingNormal(),
                       ("normal", math.sqrt(2) / math.sqrt(512))),
    "kaiming_leaky": (I.KaimingNormal(negative_slope=0.1,
                                      nonlinearity="leaky_relu"),
                      ("normal", math.sqrt(2 / 1.01) / math.sqrt(512))),
    "kaiming_fan_in": (I.KaimingUniform(fan_in=64, nonlinearity="tanh"),
                       ("uniform", 5 / 3 * math.sqrt(3 / 64))),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_initializer_statistics(name):
    init, (law, arg) = RANDOM[name]
    x = init(SHAPE, device="cpu", generator=_gen()).double()
    n = x.numel()
    if law == "uniform":
        lo, hi = arg if isinstance(arg, tuple) else (-arg, arg)
        assert float(x.min()) >= lo and float(x.max()) < hi
        mean, std = (lo + hi) / 2, (hi - lo) / math.sqrt(12)
    elif law == "normal":
        mean, std = arg if isinstance(arg, tuple) else (0.0, arg)
    else:
        m, s = arg
        assert float(x.min()) >= m - 2 * s and float(x.max()) <= m + 2 * s
        mean, std = m, s * TRUNC_STD
    assert abs(float(x.mean()) - mean) < 5 * std / math.sqrt(n)
    assert abs(float(x.std()) / std - 1) < STD_RTOL
    same = init(SHAPE, device="cpu", generator=_gen())
    assert torch.equal(same.double(), x)
    assert not torch.equal(init(SHAPE, device="cpu",
                                generator=_gen(1)).double(), x)


@pytest.mark.parametrize("shape", [(64, 32), (32, 64), (16, 4, 3, 3)])
def test_orthogonal_is_orthonormal(shape):
    q = I.Orthogonal(gain=1.0)(shape, device="cpu", generator=_gen())
    assert tuple(q.shape) == shape
    m = q.reshape(shape[0], -1).double()
    gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
    np.testing.assert_allclose(gram.numpy(), np.eye(gram.shape[0]),
                               atol=ORTHO_TOL)
    g2 = I.Orthogonal(gain=2.0)(shape, device="cpu", generator=_gen())
    assert torch.allclose(g2, 2 * q, rtol=0, atol=1e-7)
    want = np.asarray(JI.Orthogonal()(shape))
    w = want.reshape(shape[0], -1).astype(np.float64)
    wgram = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
    np.testing.assert_allclose(wgram, np.eye(wgram.shape[0]),
                               atol=ORTHO_TOL)


@pytest.fixture
def global_init():
    yield
    I.set_global_initializer(None)
    JI.set_global_initializer(None)


def test_global_initializer_reaches_create_parameter(global_init):
    """As ``paddle_tpu/nn/layer.py:82``: the attr's initializer, else the
    layer's default, else the global one, else Constant(0)/Xavier."""
    for mod in (I, JI):
        mod.set_global_initializer(mod.Constant(0.5), mod.Constant(0.25))
    jpt.seed(0)
    jl, tl = jnn.Linear(4, 3), nn.Linear(4, 3, device="cpu")
    for a, b in ((tl.weight, jl.weight), (tl.bias, jl.bias)):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      np.asarray(b._data))
    assert float(tl.weight.detach()[0, 0]) == 0.5
    assert float(tl.bias.detach()[0]) == 0.25
    # the layer's own default (LayerNorm's ones) wins over the global
    ln, jln = nn.LayerNorm(3, device="cpu"), jnn.LayerNorm(3)
    np.testing.assert_array_equal(ln.weight.detach().numpy(),
                                  np.asarray(jln.weight._data))
    # and the attr's over both
    p = create_parameter((2, 2), attr=I.Constant(3.0), device="cpu")
    assert torch.equal(p.detach(), torch.full((2, 2), 3.0))
    assert I.global_initializer(False) is not None
    I.set_global_initializer(None)
    assert I.global_initializer(False) is None and \
        I.global_initializer(True) is None
    b = create_parameter((3,), is_bias=True, device="cpu")
    assert torch.equal(b.detach(), torch.zeros(3))


def test_param_attrs_as_the_reference():
    from paddle_tpu.nn import param_attr as jpa

    a, ja = nn.ParamAttr(), jpa.ParamAttr()
    assert a.do_model_average is ja.do_model_average is True
    w = nn.WeightNormParamAttr(dim=1, name="v", learning_rate=0.5)
    jw = jpa.WeightNormParamAttr(dim=1, name="v", learning_rate=0.5)
    for k in ("dim", "name", "learning_rate", "trainable",
              "do_model_average", "need_clip"):
        assert getattr(w, k) == getattr(jw, k), k
    assert nn.ParamAttr._to_attr(w) is w
    assert I.MSRA is I.KaimingNormal and I.Xavier is I.XavierUniform
    assert I.NumpyArrayInitializer is I.Assign
