"""The rest of paddle_tpu_torch's op library against the JAX package's,
on the CPU: the channels-last convs, the resize/pool2d/deformable family
and the shuffles of ``ops/conv.py``, ``l2_normalize``/``data_norm``/
``lrn`` of ``ops/norm_ops.py``, fluid's aliases, and ``ops/misc.py``'s
28 names. One ``torch_tensor_parity.Case`` a call, written once for both
packages (``m.ops.<name>``), the same numpy inputs from
``RandomState(0)`` through both, gradients of every float input held to
the JAX tape's where the case says ``grad``.

Tolerances (``torch_tensor_parity.TOL``): ``special``, rtol 1e-5 and
1e-5 of the largest |value|, for float32 arithmetic (convs, resizes,
sums in another order; the transcendental losses); ``exact`` for what
only moves, selects or clips values, and for integers. Three ops of the
JAX package take a ``data_format`` and pool as NCHW whatever it says
(``avg_pool2d``, ``pool2d``, ``adaptive_avg_pool2d``; ``pool2d`` also
takes ``ceil_mode`` and does not read it): the port follows, and a test
asserts it (ROADMAP Queue 3). ``sampling_id`` draws from torch's
generator, not the JAX key stream: it is held to its distribution and
its bounds, not to the JAX package's ids.

The JAX side of a case runs as one ``jax.jit`` of the case's call and
its ``jax.vjp`` (the JAX package's ops take its ``Tensor``s over
tracers, as its ``TrainStep`` does), not op by op: the eager JAX
package compiles each op for each shape, 88 s for these cases against
1 s for the port's. The host-side ops
(``unique_with_counts``, ``ctc_greedy_decoder``: ``EAGER``) run eagerly,
as the JAX package runs them.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.ops import detection, labeling, misc as jmisc, rcnn, sequence

from torch_tensor_parity import (Case, _floats, arrays_of, c,
                                 check_case, close, f, flat, i, ids,
                                 run_port)

from torch_test_threads import torch_threads  # noqa: F401,E402

IMG = f(2, 4, 6, 6)
IMG5 = f(2, 3, 5, 6, 7)
POS = f(4, 5, lo=0.5, hi=1.5)
PROB = f(4, 5, lo=0.01, hi=1.0)


def _s(name, call, inputs, grad=True, label=None):
    """A float32 arithmetic case, rtol 1e-5."""
    return Case(name, call, inputs, tol="special", grad=grad, label=label)


def _e(name, call, inputs, grad=True, label=None):
    """A case that moves, selects or clips values: exact."""
    return Case(name, call, inputs, tol="exact", grad=grad, label=label)


# -- ops/conv.py --------------------------------------------------------------

CONV = [
    _s("conv2d", lambda m, d, x, w, b: m.ops.conv2d(
        x, w, b, stride=2, padding=1, data_format="NHWC"),
       [f(2, 7, 7, 4), f(3, 3, 4, 6), f(6)], label="conv2d_nhwc_hwio"),
    _s("conv2d", lambda m, d, x, w: m.ops.conv2d(
        x, w, padding="SAME", groups=2, dilation=2, data_format="NHWC"),
       [f(2, 8, 8, 4), f(3, 3, 2, 6)], label="conv2d_nhwc_grouped_same"),
    _s("conv1d", lambda m, d, x, w, b: m.ops.conv1d(
        x, w, b, padding=[1, 2], data_format="NLC"),
       [f(2, 9, 4), f(3, 4, 5), f(5)], label="conv1d_nlc_hio"),
    _s("conv3d", lambda m, d, x, w, b: m.ops.conv3d(
        x, w, b, stride=(1, 2, 1), data_format="NDHWC"),
       [f(2, 4, 5, 4, 3), f(2, 2, 2, 3, 4), f(4)], label="conv3d_ndhwc"),
    _s("conv2d_transpose", lambda m, d, x, w, b: m.ops.conv2d_transpose(
        x, w, b, stride=2, padding=1, data_format="NHWC"),
       [f(2, 5, 5, 4), f(4, 3, 3, 3), f(3)], label="conv2d_transpose_nhwc"),
    _e("pool2d", lambda m, d, x: m.ops.pool2d(x, 2, "max", 2), [IMG],
       label="pool2d_max"),
    _s("pool2d", lambda m, d, x: m.ops.pool2d(x, 3, "avg", 2, 1), [IMG],
       label="pool2d_avg_exclusive"),
    _s("pool2d", lambda m, d, x: m.ops.pool2d(x, 3, "avg", 1, 1,
                                              exclusive=False), [IMG],
       label="pool2d_avg_padding_counted"),
    _s("pool2d", lambda m, d, x: m.ops.pool2d(x, 2, "avg",
                                              global_pooling=True), [IMG],
       label="pool2d_global"),
    _e("adaptive_pool3d", lambda m, d, x: m.ops.adaptive_pool3d(
        x, (2, 4, 3)), [IMG5], label="adaptive_pool3d_max"),
    _s("adaptive_pool3d", lambda m, d, x: m.ops.adaptive_pool3d(
        x, 3, "avg"), [IMG5], label="adaptive_pool3d_avg"),
    _e("pixel_unshuffle", lambda m, d, x: m.ops.pixel_unshuffle(x, 3),
       [IMG]),
    _e("space_to_depth", lambda m, d, x: m.ops.space_to_depth(x, 2),
       [IMG]),
    _e("shuffle_channel", lambda m, d, x: m.ops.shuffle_channel(x, 2),
       [IMG]),
    _e("im2sequence", lambda m, d, x: m.ops.im2sequence(x, [3, 2], 2, 1),
       [IMG]),
    _s("grid_sampler", lambda m, d, x, g: m.ops.grid_sampler(
        x, g, align_corners=False), [IMG, f(2, 3, 5, 2, lo=-1.2, hi=1.2)]),
]
# the resizes over align_corners x align_mode, as fluid spells them
RESIZE = [
    *[_s("image_resize", lambda m, d, x, ac=ac, am=am: m.ops.image_resize(
        x, (9, 4), align_corners=ac, align_mode=am), [f(2, 3, 5, 7)],
        label=f"image_resize_bilinear_{ac}_{am}")
      for ac in (True, False) for am in (0, 1)],
    *[_s("image_resize", lambda m, d, x, k=k, ac=ac: m.ops.image_resize(
        x, scale=1.5, resample=k, align_corners=ac), [f(2, 3, 6, 4)],
        label=f"image_resize_{k.lower()}_{ac}")
      for k in ("NEAREST", "BICUBIC") for ac in (True, False)],
    *[_s("image_resize", lambda m, d, x, ac=ac, am=am: m.ops.image_resize(
        x, (4, 7, 3), resample="trilinear", align_corners=ac,
        align_mode=am), [IMG5], label=f"image_resize_trilinear_{ac}_{am}")
      for ac in (True, False) for am in (0, 1)],
    *[_s("resize_bilinear", lambda m, d, x, ac=ac, am=am:
         m.ops.resize_bilinear(x, [8, 11], align_corners=ac, align_mode=am),
         [f(2, 3, 5, 7)], label=f"resize_bilinear_{ac}_{am}")
      for ac in (True, False) for am in (0, 1)],
    *[_e("resize_nearest", lambda m, d, x, ac=ac: m.ops.resize_nearest(
        x, [10, 3], align_corners=ac), [f(2, 3, 5, 7)],
        label=f"resize_nearest_{ac}") for ac in (True, False)],
    *[_s("resize_trilinear", lambda m, d, x, ac=ac, am=am:
         m.ops.resize_trilinear(x, [6, 3, 9], align_corners=ac,
                                align_mode=am), [IMG5],
         label=f"resize_trilinear_{ac}_{am}")
      for ac in (True, False) for am in (0, 1)],
    _s("resize_trilinear", lambda m, d, x: m.ops.resize_trilinear(
        x, scale=2), [f(1, 2, 2, 3, 2)], label="resize_trilinear_scale"),
    _s("resize_trilinear", lambda m, d, x: m.ops.resize_trilinear(
        x, [1, 1, 1], actual_shape=[2, 3, 4, 5, 3]), [IMG5],
       label="resize_trilinear_actual_shape"),
]
DEFORM = [
    _s("deformable_conv", lambda m, d, x, o, k, w, b: m.ops.deformable_conv(
        x, o, k, 3, 3, padding=1, weight=w, bias=b),
       [IMG, f(2, 18, 6, 6, lo=-2.5, hi=2.5), f(2, 9, 6, 6, lo=0, hi=1),
        f(3, 4, 3, 3), f(3)], label="deformable_conv_v2"),
    _s("deformable_conv", lambda m, d, x, o, w: m.ops.deformable_conv(
        x, o, None, 4, 2, stride=2, padding=1, dilation=2, groups=2,
        deformable_groups=2, weight=w), [IMG, f(2, 16, 3, 3, lo=-2, hi=2),
                                         f(4, 2, 2, 2)],
       label="deformable_conv_v1_groups"),
]

# -- ops/norm_ops.py ----------------------------------------------------------

NORM = [
    _s("l2_normalize", lambda m, d, x: m.ops.l2_normalize(x, 1), [f(4, 5)]),
    _s("l2_normalize", lambda m, d, x: m.ops.l2_normalize(x, epsilon=0.5),
       [f(4, 5, lo=-0.1, hi=0.1)], label="l2_normalize_epsilon"),
    _s("data_norm", lambda m, d, x: m.ops.data_norm(x), [f(6, 5, 3)],
       label="data_norm_batch_statistics"),
    _s("data_norm", lambda m, d, x, n, s, q: m.ops.data_norm(
        x, act="relu", epsilon=1e-3, stats=(n, s, q)),
       [f(6, 5), c(np.full(5, 8.0, np.float32)), f(5), f(5, lo=8, hi=12)],
       label="data_norm_given_statistics"),
    _s("lrn", lambda m, d, x: m.ops.lrn(x, 3, 1e-2, 0.5, 2.0),
       [f(2, 6, 5, 4)]),
]

# -- fluid's aliases ----------------------------------------------------------

ALIASES = [
    *[_s(n, lambda m, d, x, y, n=n: getattr(m.ops, n)(x, y), [f(4, 5), POS])
      for n in ("elementwise_add", "elementwise_sub", "elementwise_mul",
                "elementwise_div")],
    Case("floor_mod", lambda m, d, x, y: m.ops.floor_mod(x, y),
         [i(-9, 9, 4, 5), c([2, 3, 4, 5, 7])], tol="exact"),
    _s("sums", lambda m, d, x, y: m.ops.sums([x, y]), [f(4, 5), f(4, 5)]),
    _e("reshape_", lambda m, d, x: m.ops.reshape_(x, [5, -1]), [f(4, 5)]),
    _e("reverse", lambda m, d, x: m.ops.reverse(x, [0, 1]), [f(4, 5)]),
    _e("top_k", lambda m, d, x: m.ops.top_k(x, 2), [f(4, 5)], grad=False),
    _e("transpose_", lambda m, d, x: m.ops.transpose_(x, 0, 2),
       [f(2, 3, 4)]),
]

# -- ops/misc.py --------------------------------------------------------------

MISC = [
    _s("cos_sim", lambda m, d, x, y: m.ops.cos_sim(x, y), [f(4, 5), f(4, 5)]),
    _s("dice_loss", lambda m, d, x, y: m.ops.dice_loss(x, y),
       [PROB, i(0, 6, 4, 1)]),
    _s("huber_loss", lambda m, d, x, y: m.ops.huber_loss(x, y, 0.7),
       [f(4, 5), f(4, 5)]),
    _s("rank_loss", lambda m, d, y, a, b: m.ops.rank_loss(y, a, b),
       [f(4, 1, lo=0, hi=1), f(4, 1), f(4, 1)]),
    _s("margin_rank_loss", lambda m, d, y, a, b: m.ops.margin_rank_loss(
        y, a, b, 0.3), [c([[1.0], [-1.0], [1.0], [-1.0]], np.float32),
                        f(4, 1), f(4, 1)]),
    _s("bpr_loss", lambda m, d, x, y: m.ops.bpr_loss(x, y),
       [f(4, 5), i(0, 5, 4, 1)]),
    _s("center_loss", lambda m, d, x, y, cen: m.ops.center_loss(
        x, y, 3, 0.4, centers=cen), [f(6, 4), c([[0], [2], [0], [1], [0],
                                                 [2]]), f(3, 4)]),
    _s("center_loss", lambda m, d, x, y, cen: m.ops.center_loss(
        x, y, 3, centers=cen, update_center=False),
       [f(6, 4), i(0, 3, 6, 1), f(3, 4)], label="center_loss_kept"),
    _s("teacher_student_sigmoid_loss",
       lambda m, d, x, y: m.ops.teacher_student_sigmoid_loss(x, y, 2.0,
                                                             -2.0),
       [f(4, 5, lo=-4, hi=4), f(4, 5, lo=0, hi=1)]),
    Case("mean_iou", lambda m, d, p, y: m.ops.mean_iou(p, y, 5),
         [i(-1, 5, 2, 9), i(0, 6, 2, 9)], tol="special"),
    _e("multiplex", lambda m, d, a, b, cc, k: m.ops.multiplex([a, b, cc], k),
       [f(4, 5), f(4, 5), f(4, 5), i(0, 3, 4, 1)]),
    _e("crop_tensor", lambda m, d, x: m.ops.crop_tensor(
        x, [3, -1, 3], [2, 2, 3]), [f(4, 6, 5)]),
    _e("unstack", lambda m, d, x: m.ops.unstack(x, 1), [f(3, 4, 2)]),
    _s("bilinear_tensor_product",
       lambda m, d, x, y, w, b: m.ops.bilinear_tensor_product(
           x, y, 2, weight=w, bias=b, act="tanh"),
       [f(4, 3), f(4, 5), f(2, 3, 5), f(2)]),
    _s("add_position_encoding",
       lambda m, d, x: m.ops.add_position_encoding(x, 0.5, 2.0),
       [f(2, 6, 7)]),
    _e("temporal_shift", lambda m, d, x: m.ops.temporal_shift(x, 2, 0.25),
       [f(4, 8, 3, 3)]),
    _s("affine_channel", lambda m, d, x, s, b: m.ops.affine_channel(
        x, s, b, act="relu"), [IMG, f(4), f(4)]),
    Case("gather_tree", lambda m, d, k, p: m.ops.gather_tree(k, p),
         [i(0, 10, 5, 2, 3), i(0, 3, 5, 2, 3)], tol="exact"),
    Case("ctc_greedy_decoder", lambda m, d, x, n: m.ops.ctc_greedy_decoder(
        x, 0, n, padding_value=-1), [f(3, 7, 4), c([7, 4, 6])],
         tol="exact"),
    _s("fsp_matrix", lambda m, d, x, y: m.ops.fsp_matrix(x, y),
       [f(2, 3, 4, 4), f(2, 5, 4, 4)]),
    _s("clip_by_norm", lambda m, d, x: m.ops.clip_by_norm(x, 1.0),
       [f(4, 5)]),
    _s("clip_by_norm", lambda m, d, x: m.ops.clip_by_norm(x, 100.0),
       [f(4, 5)], label="clip_by_norm_below"),
    _e("brelu", lambda m, d, x: m.ops.brelu(x, -1.0, 2.0),
       [f(4, 5, lo=-3, hi=3)]),
    _s("soft_relu", lambda m, d, x: m.ops.soft_relu(x, 2.0),
       [f(4, 5, lo=-4, hi=4)]),
    Case("unique_with_counts", lambda m, d, x: m.ops.unique_with_counts(x),
         [i(0, 5, 12)], tol="exact"),
    Case("hash", lambda m, d, x: m.ops.hash(x, 97, 3),
         [i(-2 ** 31, 2 ** 31, 4, 3)], tol="exact"),
    Case("hash", lambda m, d, x: m.ops.hash(x, 2 ** 31 - 1, 2),
         [i(0, 10 ** 6, 5, 4)], tol="exact", label="hash_wide_buckets"),
    Case("similarity_focus", lambda m, d, x: m.ops.similarity_focus(
        x, 1, [0, 2]), [f(2, 3, 4, 5)], tol="exact"),
    _e("polygon_box_transform",
       lambda m, d, x: m.ops.polygon_box_transform(x), [f(2, 4, 3, 5)]),
    _s("tree_conv", lambda m, d, x, e, w: m.ops.tree_conv(
        x, e, 2, 2, max_depth=3, weight=w),
       [f(2, 6, 3), c([[[0, 1], [0, 2], [1, 3], [1, 4], [2, 5], [5, 5]],
                       [[0, 3], [3, 1], [3, 2], [1, 4], [4, 5], [0, 0]]]),
        f(3, 3, 2, 2)]),
]
CASES = CONV + RESIZE + DEFORM + NORM + ALIASES + MISC


EAGER = {"unique_with_counts", "ctc_greedy_decoder"}


def _jax_fn(case, arrays, grad_at):
    """The case's JAX outputs as arrays of the inputs ``arrays``; the
    ones at ``grad_at`` passed separately, for the vjp."""
    def outs(diff):
        xs = list(arrays)
        for k, v in zip(grad_at, diff):
            xs[k] = v
        res = flat(case.call(jpt, {}, *[JTensor(jnp.asarray(x),
                                                _internal=True)
                                        for x in xs]))
        return [r._data if isinstance(r, JTensor) else jnp.asarray(r)
                for r in res]
    return outs


def run_jax_jit(case, arrays):
    """``run_jax``'s outputs and input gradients from one jit of the
    forward and its vjp."""
    grad_at = _floats(arrays) if case.grad else []
    fn = _jax_fn(case, [jnp.asarray(a) for a in arrays], grad_at)
    diff = [jnp.asarray(arrays[k]) for k in grad_at]
    if not grad_at:
        return [np.asarray(o) for o in jax.jit(fn)(diff)], None
    def both(diff):
        outs, back = jax.vjp(fn, diff)
        # _cotangents' draws, from the traced shapes (constants of the
        # jit); an integer output takes a float0 cotangent, whose value
        # is unused
        rng = np.random.RandomState(1)
        ct = [rng.randn(*o.shape).astype(np.float32)
              if np.dtype(o.dtype).kind == "f" else
              np.zeros(o.shape, jax.dtypes.float0) for o in outs]
        return outs, back(ct)[0]

    outs, grads = jax.jit(both)(diff)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def check_jit(case):
    """``check_case`` with the JAX side jitted (``run_jax_jit``)."""
    if case.name in EAGER:
        return check_case(case)
    arrays = arrays_of(case)
    got, tgrads = run_port(case, arrays)
    want, jgrads = run_jax_jit(case, arrays)
    assert len(got) == len(want), (len(got), len(want))
    for k, (g, w) in enumerate(zip(got, want)):
        close(g, w, case.tol, f"{case.id} output {k}")
    if case.grad:
        tol = "f32" if case.tol == "exact" else case.tol
        for k, (g, w) in enumerate(zip(tgrads, jgrads)):
            ref = arrays[_floats(arrays)[k]]
            close(np.zeros_like(ref) if g is None else g, w, tol,
                  f"{case.id} gradient {k}")


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op_matches_the_jax_package(case):
    check_jit(case)


# the op modules the port does not have yet (ROADMAP Queue 1, item 10) and
# the JAX registry's internals
NOT_PORTED = (sequence, labeling, detection, rcnn)
REGISTRY = {"OP_REGISTRY", "apply", "monkey_patch_tensor"}


def _public(mod):
    names = getattr(mod, "__all__", None) or dir(mod)
    return {n for n in names if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


def test_every_jax_op_name_resolves_but_the_listed_ones():
    listed = REGISTRY.union(*(_public(mod) for mod in NOT_PORTED))
    missing = {n for n in _public(jpt.ops) if not hasattr(pt.ops, n)}
    assert missing <= listed, sorted(missing - listed)
    assert REGISTRY <= missing
    assert set(jmisc.__all__) <= set(pt.ops.misc.__all__)
    assert len(jmisc.__all__) == 28
    names = {c.name for c in CASES} | {"range_", "uniform_random",
                                       "gaussian", "gaussian_random",
                                       "sampling_id"}
    assert set(jmisc.__all__) - {"sampling_id"} <= names


def test_fluid_aliases_are_the_functions_they_name():
    o = pt.ops
    assert o.transpose_ is o.swapaxes and o.transpose_ is not o.transpose
    for alias, name in (("reshape_", "reshape"), ("reverse", "flip"),
                        ("top_k", "topk"), ("sums", "add_n"),
                        ("floor_mod", "remainder"),
                        ("elementwise_add", "add"), ("lrn",
                                                     "local_response_norm"),
                        ("grid_sampler", "grid_sample")):
        assert getattr(o, alias) is getattr(o, name), alias
    cr = o.creation
    assert cr.range_ is cr.arange and cr.uniform_random is cr.uniform
    assert cr.gaussian is cr.normal and cr.gaussian_random is cr.normal
    np.testing.assert_array_equal(
        o.range_(1, 11, 3, device="cpu").numpy(),
        np.asarray(jpt.ops.creation.range_(1, 11, 3)._data))
    g = o.gaussian(1.0, 2.0, [4000], device="cpu")
    u = o.uniform_random([4000], min=-2.0, max=3.0, device="cpu")
    assert abs(float(g.mean()) - 1.0) < 0.15 and abs(float(g.std()) - 2.0) \
        < 0.15
    assert float(u.min()) >= -2.0 and float(u.max()) < 3.0


def test_reference_pools_ignore_data_format():
    """The JAX package's ``avg_pool2d``, ``pool2d`` and
    ``adaptive_avg_pool2d`` take ``data_format`` and pool as NCHW
    whatever it says (``pool2d`` also takes ``ceil_mode`` and does not
    read it): the port follows, on an NHWC-laid-out array."""
    x = np.random.RandomState(0).randn(2, 6, 6, 4).astype(np.float32)
    calls = [lambda m, t, fmt: m.ops.avg_pool2d(t, 2, data_format=fmt),
             lambda m, t, fmt: m.ops.pool2d(t, 3, "max", 2, ceil_mode=True,
                                            data_format=fmt),
             lambda m, t, fmt: m.ops.adaptive_avg_pool2d(t, 3,
                                                         data_format=fmt)]
    for call in calls:
        nhwc = call(pt, torch.from_numpy(x), "NHWC").numpy()
        nchw = call(pt, torch.from_numpy(x), "NCHW").numpy()
        want = np.asarray(call(jpt, jpt.to_tensor(x), "NHWC")._data)
        np.testing.assert_array_equal(nhwc, nchw)
        np.testing.assert_allclose(nhwc, want, rtol=1e-6, atol=1e-6)
    assert pt.ops.pool2d(torch.from_numpy(x), 4, "max", 4,
                         ceil_mode=True).shape == (2, 6, 1, 1)


def test_sampling_id_draws_by_the_probabilities():
    """``sampling_id`` from torch's generator: ids in [0, C), each drawn
    about as often as its probability says (and a 0 never), the same ids
    for the same seed, like the JAX package's in shape."""
    p = np.array([[0.1, 0.0, 0.6, 0.3]] * 4000, np.float32)
    ids_ = pt.ops.sampling_id(torch.from_numpy(p), seed=7)
    assert ids_.shape == (4000,) and ids_.dtype == torch.int64
    counts = np.bincount(ids_.numpy(), minlength=4) / 4000
    np.testing.assert_allclose(counts, [0.1, 0.0, 0.6, 0.3], atol=0.03)
    assert counts[1] == 0
    again = pt.ops.sampling_id(torch.from_numpy(p), seed=7)
    assert torch.equal(ids_, again)
    want = jpt.ops.sampling_id(jpt.to_tensor(p[:8]), seed=3)
    assert tuple(want.shape) == tuple(pt.ops.sampling_id(
        torch.from_numpy(p[:8]), seed=3).shape)


def test_center_loss_returns_the_updated_centres():
    """The reference's update: each class's centre moves by alpha times
    the sum of (centre - x) over its samples, over their count + 1."""
    rng = np.random.RandomState(0)
    x, cen = rng.randn(5, 3).astype(np.float32), rng.randn(4, 3).astype(
        np.float32)
    lab = np.array([[1], [3], [1], [0], [1]])
    loss, new = pt.ops.center_loss(torch.from_numpy(x), torch.from_numpy(lab),
                                   4, 0.5, centers=torch.from_numpy(cen))
    want = cen.copy()
    for k in range(4):
        rows = lab[:, 0] == k
        want[k] -= 0.5 * (cen[k] - x[rows]).sum(0) / (rows.sum() + 1.0)
    np.testing.assert_allclose(new.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        loss.numpy()[:, 0], 0.5 * ((x - cen[lab[:, 0]]) ** 2).sum(1),
        rtol=1e-6)


def test_the_reference_refusals_are_kept():
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(NotImplementedError, match="input_image_size"):
        pt.ops.im2sequence(x, 2, input_image_size=torch.ones(1, 2))
    with pytest.raises(NotImplementedError, match="out_stride"):
        pt.ops.im2sequence(x, 2, out_stride=2)
    with pytest.raises(ValueError, match="weight"):
        pt.ops.deformable_conv(x, x, None, 2, 3)
    with pytest.raises(ValueError, match="resample"):
        pt.ops.image_resize(x, (2, 2), resample="AREA")
    with pytest.raises(ValueError, match="divisible"):
        pt.ops.shuffle_channel(torch.zeros(1, 3, 2, 2), 2)
    with pytest.raises(ValueError, match="centers"):
        pt.ops.center_loss(x, x)
    with pytest.raises(ValueError, match="weight"):
        pt.ops.tree_conv(torch.zeros(1, 3, 2), torch.zeros(1, 2, 2), 2)
    with pytest.raises(ValueError, match="data_format"):
        pt.ops.conv2d(x, torch.zeros(1, 2, 1, 1), data_format="NWHC")


def test_deformable_conv_backward_repeats_its_bits():
    """The scatter of the taps' gradient into x adds through
    ``index_put_`` in deterministic mode: two backwards, the same bits,
    with taps that land on one pixel many times (offsets of 0)."""
    case = DEFORM[0]
    arrays = arrays_of(case)
    arrays[1] = np.zeros_like(arrays[1])
    got = [run_port(case, arrays) for _ in range(2)]
    for a, b in zip(got[0][1], got[1][1]):
        np.testing.assert_array_equal(a, b)
