"""paddle_tpu_torch's top level against the JAX package's, on the CPU:
every name of ``paddle_tpu.__all__`` resolves on the port but the ones
listed in ``ABSENT`` (each with its ROADMAP Queue 1 item); ``to_tensor``,
``grad``, ``no_grad``, ``set_device``/``get_device`` and the places,
the dtype names and ``set_default_dtype``; the 2.x module spellings
(``modules_compat``); the subpackages' names the JAX package binds
(``ops``, ``nn``, ``framework``, ``obs``, ``static``); and torch's own
global state, which none of these touch.
"""
import importlib
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt

from torch_test_threads import torch_threads  # noqa: F401,E402

# names of paddle_tpu.__all__ the port does not have yet -> ROADMAP item
ABSENT = {
    **{n: "item 10" for n in (
        "Model", "DataLoader", "batch", "reader", "summary", "flops",
        "metrics", "distribution", "slim", "hapi", "dataset", "vision",
        "fluid", "io", "io_", "metric", "imperative", "compat", "version",
        "sysconfig", "check_import_scipy")},
    "runtime": "item 8",
    "set_compilation_cache": "item 8",
}


@pytest.fixture(autouse=True)
def place_and_dtype_restored():
    place, dtype = pt._device.CURRENT[0], pt.get_default_dtype()
    try:
        yield
    finally:
        pt.set_default_dtype(dtype)
        pt._device.CURRENT[0] = place


def test_every_jax_top_level_name_resolves_but_the_listed():
    names = set(jpt.__all__)
    assert set(ABSENT) <= names
    missing = sorted(n for n in names - set(ABSENT) if not hasattr(pt, n))
    assert not missing, missing
    present = sorted(n for n in ABSENT if hasattr(pt, n))
    assert not present, present
    for n in ("nn", "optim", "amp", "inference", "serving", "quant",
              "static", "framework", "resilience", "obs"):
        assert type(getattr(pt, n)).__name__ == "module", n
    assert pt.in_dynamic_mode() and jpt.in_dynamic_mode()


def test_to_tensor_types_places_and_gradients_follow_the_jax_package():
    pt.set_device("cpu")
    cases = [([1, 2, 3], None), (2.5, None), ([[0.5, 1.5]], None),
             (np.arange(4.0), None), (np.array([True, False]), None),
             ([1, 2], "float32"), (np.ones(3, np.float32), "bfloat16")]
    for data, dtype in cases:
        want = jpt.to_tensor(data, dtype=dtype)
        got = pt.to_tensor(data, dtype=dtype)
        jname, tname = want.dtype.name, str(got.dtype).replace("torch.", "")
        # the port keeps int64 where the JAX package folds it to int32
        assert tname == {"int32": "int64"}.get(jname, jname), (data, tname)
        assert got.device.type == "cpu" and not got.requires_grad
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want._data, np.float32))
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False, place=pt.CPUPlace())
    assert x.requires_grad and x.is_leaf
    src = torch.ones(2)
    assert pt.to_tensor(src).data_ptr() != src.data_ptr()   # a copy
    assert issubclass(pt.Tensor, torch.Tensor) and isinstance(x, pt.Tensor)
    assert pt.Tensor is not torch.Tensor and type(src) is torch.Tensor
    p = pt.Parameter(np.ones(2, np.float32), name="w", trainable=False)
    assert isinstance(p, torch.nn.Parameter) and p.name == "w"
    assert not p.requires_grad and p.stop_gradient and not p.trainable


def test_grad_and_no_grad_follow_the_jax_package():
    pt.set_device("cpu")
    a = np.array([1.0, -2.0, 3.0], np.float32)
    jx = jpt.to_tensor(a, stop_gradient=False)
    jy = jpt.to_tensor(a, stop_gradient=False)
    jgx, = jpt.grad(jpt.sum(jx * jx * 3.0), jx)
    tx = pt.to_tensor(a, stop_gradient=False)
    ty = pt.to_tensor(a, stop_gradient=False)
    tgx, = pt.grad(pt.sum(tx * tx * 3.0), tx)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx._data))
    assert not tgx.requires_grad
    out = jpt.grad([jpt.sum(jx * 2.0)], [jx, jy], allow_unused=True)
    got = pt.grad([pt.sum(tx * 2.0)], [tx, ty], allow_unused=True)
    assert out[1] is None and got[1] is None
    np.testing.assert_allclose(got[0].numpy(), np.asarray(out[0]._data))
    with pytest.raises(RuntimeError):
        pt.grad(pt.sum(tx * 2.0), [ty])
    g = pt.grad(pt.sum(tx ** 3), tx, grad_outputs=pt.to_tensor(2.0),
                create_graph=True)[0]
    assert g.requires_grad   # the port keeps it on the tape
    with pt.no_grad():
        assert not pt.is_grad_enabled() and not (tx * 2).requires_grad
        with pt.enable_grad():
            assert (tx * 2).requires_grad

    @pt.no_grad()
    def f(v):
        return v * 2

    assert not f(tx).requires_grad and pt.is_grad_enabled()


def test_set_device_names_the_place_and_refuses_a_missing_card():
    assert pt.get_device() == "gpu:0"   # the default place stays the card
    assert pt.TPUPlace(0) == pt.CUDAPlace(0) == pt.Place("gpu", 0)
    assert pt.CPUPlace().torch_device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.zeros([2])    # no fallback to the host
        for spec in ("gpu", "gpu:0", "cuda", "tpu", pt.CUDAPlace(0)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pt.set_device(spec)
        assert pt.device_count() == 0 and not pt.is_compiled_with_tpu()
    assert pt.set_device("cpu") == pt.CPUPlace()
    assert pt.get_device() == "cpu:0"
    layer = pt.nn.Linear(2, 3)
    assert layer.weight.device.type == "cpu"
    assert pt.zeros([2]).device.type == "cpu"
    assert pt.ones([2], device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        pt.set_device("npu")


def test_dtype_names_and_the_default_dtype():
    pt.set_device("cpu")
    for n in ("float16", "bfloat16", "float32", "int8", "int16", "int32",
              "uint8", "complex64"):
        assert getattr(pt, n) is getattr(torch, n), n
    # the port keeps the 64-bit types the JAX package folds to 32 bits
    assert pt.float64 is torch.float64 and jpt.float64 == jpt.float32
    assert pt.int64 is torch.int64 and pt.complex128 is torch.complex128
    assert pt.bool is pt.bool_ is torch.bool
    assert pt.get_default_dtype() == jpt.get_default_dtype() == "float32"
    torch_default = torch.get_default_dtype()
    pt.set_default_dtype("float64")
    assert pt.get_default_dtype() == "float64"
    assert pt.zeros([2]).dtype == torch.float64
    assert pt.to_tensor([0.5]).dtype == torch.float64
    assert pt.nn.Linear(2, 2).weight.dtype == torch.float32  # a layer's own
    assert pt.static.create_parameter([2], dtype=None).dtype == torch.float64
    pt.set_default_dtype("float32")
    assert torch.get_default_dtype() == torch_default


def test_torch_global_state_is_untouched():
    dtype = torch.get_default_dtype()
    device = torch.empty(0).device
    pt.set_device("cpu")
    pt.set_default_dtype("float16")
    pt.set_default_dtype("float32")
    assert torch.get_default_dtype() == dtype
    assert torch.empty(0).device == device


def test_module_spellings_are_the_real_modules():
    import paddle_tpu_torch.tensor.logic as logic
    import paddle_tpu_torch.tensor.math as tmath
    from paddle_tpu_torch.tensor import creation

    assert tmath is pt.ops.math and creation is pt.ops.creation
    assert logic is pt.ops.compare
    assert sys.modules["paddle_tpu_torch.tensor"] is pt.ops
    assert pt.tensor is pt.ops and pt.optimizer is pt.optim
    assert pt.static is pt.static_ and pt.device is pt.core.device
    assert pt.regularizer is pt.optim.regularizer
    assert importlib.import_module("paddle_tpu_torch.tensor.linalg") is \
        pt.ops.linalg
    assert pt.distributed is pt.dist
    a = torch.tensor([0.0, 3.0])
    np.testing.assert_allclose(float(pt.distributed(a, torch.zeros(2))),
                               3.0)   # still the tensor API's dist
    for alias, item in (("io", 10), ("metric", 10), ("imperative", 10)):
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"paddle_tpu_torch.{alias}")
        assert ABSENT[alias] == f"item {item}"
    # fleet: the collective front end (dist.fleet), as the JAX package's
    # paddle.fleet re-exports it
    assert importlib.import_module("paddle_tpu_torch.fleet") is pt.fleet
    assert pt.fleet.fleet is pt.dist.fleet and "fleet" not in ABSENT
    for name in ("init", "distributed_optimizer", "worker_num",
                 "worker_index", "is_first_worker", "build_train_step",
                 "DistributedStrategy"):
        assert hasattr(jpt.fleet, name) and hasattr(pt.fleet, name), name
    finder = next(f for f in sys.meta_path
                  if getattr(f, "_pkg_prefix", None) == "paddle_tpu_torch.")
    assert finder.find_spec("paddle_tpu.tensor") is None
    assert finder.find_spec("numpy.linalg") is None


def test_one_x_aliases_and_create_tensor():
    pt.set_device("cpu")
    a, b = torch.tensor([4.0, 9.0]), torch.tensor([2.0, 3.0])
    np.testing.assert_array_equal(pt.div(a, b).numpy(), [2.0, 3.0])
    assert pt.elementwise_equal(a, a).all()
    np.testing.assert_array_equal(pt.elementwise_sum([a, b]).numpy(),
                                  [6.0, 12.0])
    t = pt.create_tensor("int64")
    assert t.shape == (1,) and t.dtype == torch.int64
    assert jpt.create_tensor("float32").shape == [1]


# the flat ``ops.*`` names of the JAX package the port's op modules define
FLAT_OPS = (
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_max_pool1d",
    "adaptive_max_pool2d", "affine_grid", "alpha_dropout", "angle",
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "batch_norm", "celu",
    "channel_shuffle", "conj", "conv1d", "conv1d_transpose", "conv2d",
    "conv2d_transpose", "conv3d", "conv3d_transpose", "deg2rad", "dropout",
    "dropout2d", "dropout3d", "elu", "frac", "gelu", "glu", "grid_sample",
    "group_norm", "gumbel_softmax", "hardshrink", "hardsigmoid",
    "hardswish", "hardtanh", "instance_norm", "interpolate", "layer_norm",
    "leaky_relu", "local_response_norm", "log_sigmoid", "log_softmax",
    "logsigmoid", "max_pool1d", "max_pool2d", "max_pool3d", "maxout",
    "mish", "mode", "normalize", "pixel_shuffle", "prelu", "rad2deg",
    "register", "relu", "relu6", "selu", "sigmoid", "silu", "softmax",
    "softplus", "softshrink", "softsign", "spectral_norm", "swish",
    "tanhshrink", "thresholded_relu", "unfold", "upsample", "Tensor",
    "to_tensor",
    # the op library's rest (conv, norm_ops, misc, fluid's aliases)
    "adaptive_pool3d", "add_position_encoding", "affine_channel",
    "bilinear_tensor_product", "bpr_loss", "brelu", "center_loss",
    "clip_by_norm", "cos_sim", "crop_tensor", "ctc_greedy_decoder",
    "data_norm", "deformable_conv", "dice_loss", "elementwise_add",
    "elementwise_div", "elementwise_mul", "elementwise_sub", "floor_mod",
    "fsp_matrix", "gather_tree", "grid_sampler", "hash", "huber_loss",
    "im2sequence", "image_resize", "l2_normalize", "lrn",
    "margin_rank_loss", "mean_iou", "multiplex", "pixel_unshuffle",
    "polygon_box_transform", "pool2d", "rank_loss", "reshape_",
    "resize_bilinear", "resize_nearest", "resize_trilinear", "reverse",
    "sampling_id", "shuffle_channel", "similarity_focus", "soft_relu",
    "space_to_depth", "sums", "teacher_student_sigmoid_loss",
    "temporal_shift", "top_k", "transpose_", "tree_conv",
    "unique_with_counts", "unstack")


def test_subpackage_names_the_jax_package_binds():
    assert len(FLAT_OPS) == 71 + 53
    for n in FLAT_OPS:
        assert hasattr(jpt.ops, n) and callable(getattr(pt.ops, n)), n
    assert not set(FLAT_OPS) & set(pt.ops.__all__)   # not the tensor API
    x = torch.tensor([[-1.0, 2.0]])
    np.testing.assert_allclose(pt.ops.relu(x).numpy(), [[0.0, 2.0]])
    for n in ("Layer", "LayerList", "LayerDict", "ParameterList",
              "Sequential", "conv2d", "conv3d", "conv2d_transpose",
              "conv3d_transpose", "ClipGradByGlobalNorm", "ClipGradByNorm",
              "ClipGradByValue", "functional_api"):
        assert hasattr(jpt.nn, n) and hasattr(pt.nn, n), n
    for n in ("to_static", "no_jit", "save_inference_model",
              "load_inference_model"):
        assert hasattr(jpt.framework, n) and hasattr(pt.framework, n), n
    for n in jpt.obs.__all__:
        if n in ("spmd", "enable_op_sampling", "disable_op_sampling",
                 "op_sampling_enabled"):   # item 7
            assert not hasattr(pt.obs, n), n
        else:
            assert hasattr(pt.obs, n), n
    assert pt.static.ProgramTracer is pt.static.ProgramRecorder
    assert callable(pt.static.create_parameter)
    assert hasattr(jpt.static, "nn") and not hasattr(pt.static, "nn")
