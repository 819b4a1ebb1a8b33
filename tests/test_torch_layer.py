"""paddle_tpu_torch's ``nn.Layer`` and its containers against the JAX
package's (``paddle_tpu/nn/layer.py``), on the CPU.

One layer class is written once against a package handle ``m`` and
built in both packages, each under a fresh ``unique_name.guard()`` so
the names do not depend on what ran before: the ``state_dict`` names
and order (parameters, then persistable buffers), the parameters'
names, ``full_name``, the traversals, ``set_state_dict``'s ``(missing,
unexpected)`` and its shape error, the forward hooks and their removal,
and ``astype``. Weights cross from the JAX layer by ``paddle_tpu.save``
-> ``paddle_tpu_torch.load`` -> ``set_state_dict``, and the forwards
agree within rtol 1e-5 (atol 1e-5 x the largest magnitude). Every layer
class of the port is an ``nn.Layer`` and a ``torch.nn.Module``; the
``nn.Layer`` subclasses of ``tests/test_stats.py`` are ready cases.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from test_torch_layers import LAYERS, numpy_initializers  # noqa: F401

from torch_test_threads import torch_threads  # noqa: F401,E402

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def fresh_names_on_the_cpu():
    """Each test under a fresh name generator in both packages, the port
    on the CPU; the current place and default dtype put back after."""
    place, dtype = pt._device.CURRENT[0], pt.get_default_dtype()
    pt.set_device("cpu")
    try:
        yield
    finally:
        pt.set_default_dtype(dtype)
        pt._device.CURRENT[0] = place


def _in(m, fn):
    with m.utils.unique_name.guard():
        return fn()


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._data, np.float32)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


def net(m):
    """Parameters made directly and by sublayers, a persistable and a
    non-persistable buffer, a BatchNorm's statistics, and each
    container."""
    nn = m.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 3)
            self.scale = self.create_parameter([3])
            self.bn = nn.BatchNorm1D(3)
            self.register_buffer("seen", m.to_tensor(np.ones(3, np.float32)))
            self.register_buffer("scratch",
                                 m.to_tensor(np.zeros(2, np.float32)),
                                 persistable=False)
            self.seq = nn.Sequential(("a", nn.Linear(3, 3)), ("b", nn.ReLU()))
            self.stack = nn.LayerList([nn.Linear(3, 2), nn.Linear(2, 2)])
            self.heads = nn.LayerDict({"x": nn.Linear(2, 2)})
            self.extra = nn.ParameterList(
                [self.create_parameter([2], is_bias=True)])

        def forward(self, x):
            h = self.bn(self.fc(x) * self.scale + self.seen)
            h = self.seq(h)
            for layer in self.stack:
                h = layer(h)
            return self.heads["x"](h) + self.extra[0]

    return Net()


def _pair(tmp_path, make=net):
    """The JAX layer and the port's, the JAX weights and buffers carried
    over by ``save`` -> ``load`` -> ``set_state_dict``."""
    jl = _in(jpt, lambda: make(jpt))
    tl = _in(pt, lambda: make(pt))
    path = str(tmp_path / "layer.pdparams")
    jpt.save(jl.state_dict(), path)
    assert tl.set_state_dict(pt.load(path)) == ([], [])
    return jl, tl


def test_state_dict_names_order_and_values_follow_the_jax_layer(tmp_path):
    jl, tl = _pair(tmp_path)
    names = list(tl.state_dict())
    assert names == list(jl.state_dict())
    assert names[-3:] == ["seen", "bn._mean", "bn._variance"]
    assert "scratch" not in names
    sd = tl.state_dict()
    for name, p in tl.named_parameters():
        assert sd[name].data_ptr() == p.data_ptr(), name
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    jl.eval()
    tl.eval()
    _close(tl(torch.from_numpy(x)), jl(jpt.to_tensor(x)), "forward")


def test_names_and_traversals_follow_the_jax_layer(tmp_path):
    jl, tl = _pair(tmp_path)
    assert tl.full_name() == jl.full_name() == "net_0"
    assert [p.name for p in tl.parameters()] == \
        [p.name for p in jl.parameters()]
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    assert [n for n, _ in tl.named_buffers()] == \
        [n for n, _ in jl.named_buffers()]
    assert [n for n, _ in tl.named_sublayers(include_self=True)] == \
        [n for n, _ in jl.named_sublayers(include_self=True)]
    assert [l.full_name() for l in tl.sublayers()] == \
        [l.full_name() for l in jl.sublayers()]
    assert [n for n, _ in tl.named_children()] == \
        [n for n, _ in jl.named_children()]
    assert len(tl.parameters(include_sublayers=False)) == \
        len(jl.parameters(include_sublayers=False)) == 1
    assert isinstance(tl.parameters(), list)
    assert next(tl.parameters()) is tl.scale   # torch's idiom
    assert len(tl.seq) == 2 and len(tl.stack) == 2 and "x" in tl.heads
    assert all(isinstance(p, pt.Parameter) and
               isinstance(p, torch.nn.Parameter) for p in tl.parameters())


def test_set_state_dict_reports_and_refuses_as_the_jax_layer(tmp_path):
    jl, tl = _pair(tmp_path)
    state = {"fc.weight": np.ones((4, 3), np.float32),
             "nope": np.zeros(1, np.float32)}
    want = jl.set_state_dict(dict(state))
    ptr = tl.fc.weight.data_ptr()
    got = tl.set_state_dict(dict(state))
    assert got == want and got[1] == ["nope"] and "fc.bias" in got[0]
    assert tl.fc.weight.data_ptr() == ptr
    np.testing.assert_array_equal(_np(tl.fc.weight), np.ones((4, 3)))
    bad = {"fc.weight": np.ones((3, 4), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        jl.set_state_dict(bad)
    with pytest.raises(ValueError, match="shape"):
        tl.set_state_dict(bad)
    tl.scale = torch.full((3,), 2.0)   # a tensor into the parameter
    assert isinstance(tl.scale, pt.Parameter)
    np.testing.assert_array_equal(_np(tl.scale), [2.0, 2.0, 2.0])


def test_hooks_change_inputs_and_outputs_until_removed(tmp_path):
    jl, tl = _pair(tmp_path)
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    outs = []
    for m, layer, xt in ((jpt, jl.fc, jpt.to_tensor(x)),
                         (pt, tl.fc, torch.from_numpy(x))):
        pre = layer.register_forward_pre_hook(
            lambda lyr, inputs: (inputs[0] * 2.0,))
        post = layer.register_forward_post_hook(
            lambda lyr, inputs, out: out + 1.0)
        hooked = layer(xt)
        pre.remove()
        post.remove()
        outs.append((hooked, layer(xt)))
    (jh, jp), (th, tp) = outs
    _close(th, jh, "hooked")
    _close(tp, jp, "after remove")
    assert not np.allclose(_np(th), _np(tp))


def test_astype_casts_floating_state_as_the_jax_layer(tmp_path):
    jl, tl = _pair(tmp_path)
    jl.astype("bfloat16")
    assert tl.astype("bfloat16") is tl
    for (jn, jv), (tn, tv) in zip(jl.state_dict().items(),
                                  tl.state_dict().items()):
        assert jn == tn and str(tv.dtype) == "torch." + jv.dtype.name, tn
    assert tl._dtype == torch.bfloat16
    extra = tl.create_parameter([2])
    assert extra.dtype == torch.bfloat16 and extra.device.type == "cpu"
    tl.float()
    assert {str(v.dtype) for v in tl.state_dict().values()} == \
        {"torch.float32"}
    tl.to("cpu", "float16")
    assert tl.fc.weight.dtype == torch.float16
    tl.clear_gradients()
    assert all(p.grad is None for p in tl.parameters())


def test_sequential_containers_index_and_slice():
    seq = pt.nn.Sequential(pt.nn.Linear(2, 3, **CPU), pt.nn.ReLU(),
                           pt.nn.Linear(3, 1, **CPU))
    assert [n for n, _ in seq.named_children()] == ["0", "1", "2"]
    assert isinstance(seq[1:], pt.nn.Sequential) and len(seq[1:]) == 2
    assert seq(torch.ones(4, 2)).shape == (4, 1)
    lst = pt.nn.LayerList([pt.nn.ReLU()])
    lst.append(pt.nn.Tanh())
    lst.insert(0, pt.nn.Sigmoid())
    assert [type(l).__name__ for l in lst] == ["Sigmoid", "ReLU", "Tanh"]
    assert type(lst[-1]).__name__ == "Tanh"
    with pytest.raises(IndexError):
        lst[3]
    d = pt.nn.LayerDict([("a", pt.nn.ReLU())])
    d["b"] = pt.nn.Tanh()
    assert list(d.keys()) == ["a", "b"] and isinstance(d.pop("a"),
                                                       pt.nn.Layer)
    ps = pt.nn.ParameterList([pt.Parameter(torch.ones(2), name="p")])
    assert ps[-1].name == "p" and len(ps.parameters()) == 1
    with pytest.raises(TypeError):
        pt.nn.Layer().add_parameter("w", torch.ones(2))


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_every_layer_class_is_a_layer_and_a_module(case):
    layer = case[1](pt.nn, CPU)
    assert isinstance(layer, pt.nn.Layer) and \
        isinstance(layer, torch.nn.Module)
    assert all(isinstance(p, pt.Parameter) for p in layer.parameters())


def test_every_exported_class_subclasses_layer():
    from paddle_tpu_torch import models, quant, serving
    from paddle_tpu_torch.dist import tp_layers
    from paddle_tpu_torch.models.nlp import bert, gpt, sentiment, word2vec
    from paddle_tpu_torch.models.nlp import transformer as wmt
    from paddle_tpu_torch.models.rec import recommender
    from paddle_tpu_torch.models.vision import lenet, resnet

    modules = [pt.nn, tp_layers, bert, gpt, sentiment, word2vec, wmt,
               recommender, lenet, resnet, quant, serving.engine, models]
    classes = {getattr(mod, n) for mod in modules for n in dir(mod)
               if isinstance(getattr(mod, n), type)
               and issubclass(getattr(mod, n), torch.nn.Module)}
    assert len(classes) > 110
    assert not [c for c in classes if not issubclass(c, pt.nn.Layer)]


def with_direct(m):
    """``tests/test_stats.py:75-84``'s ``WithDirect``."""

    class WithDirect(m.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = m.nn.Linear(4, 4)
            self.extra = self.create_parameter((7,))

        def forward(self, v):
            return self.fc(v) + self.extra[:4]

    return WithDirect()


def odd_net(m):
    """``tests/test_stats.py:117-128``'s ``Odd`` inside ``Net``."""

    class Odd(m.nn.Layer):
        def forward(self, v):
            return v * 2.0

    class Net(m.nn.Layer):
        def __init__(self):
            super().__init__()
            self.odd = Odd()
            self.fc = m.nn.Linear(4, 4)

        def forward(self, v):
            return self.fc(self.odd(v))

    return Net()


@pytest.mark.parametrize("make,count,size", [(with_direct, 3, 27),
                                             (odd_net, 2, 20)])
def test_stats_layers_run_as_the_jax_ones(tmp_path, make, count, size):
    jl, tl = _pair(tmp_path, make)
    for layer in (jl, tl):
        assert len(layer.parameters()) == count
        assert sum(int(np.prod(p.shape)) for p in layer.parameters()) == size
    x = np.random.RandomState(2).randn(2, 4).astype(np.float32)
    _close(tl(torch.from_numpy(x)), jl(jpt.to_tensor(x)), make.__name__)
