"""Fluid-era deploy API: AnalysisConfig / create_paddle_predictor /
zero-copy tensors, the counterpart of ``paddle_tpu/inference/analysis.py``
(ref: paddle/fluid/pybind/inference_api.cc — the
``from paddle.fluid.core import AnalysisConfig, create_paddle_predictor``
entry every 1.x deployment script uses; C++ AnalysisPredictor in
paddle/fluid/inference/api/analysis_predictor.cc).

The execution engine is ``inference.Predictor`` (one CUDA graph per feed
signature). The device switches choose its device: the card by default,
the CPU after ``disable_gpu()``. The graph-optimization knobs the
reference exposes (IR passes, MKLDNN, memory optim) are accepted and
recorded; TensorRT raises. ``ZeroCopyTensor.copy_from_cpu`` stages its
array in a tensor on the Predictor's device, and ``zero_copy_run`` keeps
the fetches there until ``copy_to_cpu``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .predictor import Config, Predictor

__all__ = ["AnalysisConfig", "AnalysisPredictor", "ZeroCopyTensor",
           "PaddleTensor", "create_paddle_predictor"]


def _resolve_prefix(model_arg):
    """Accept a save_inference_model prefix, a <prefix>.pdmodel path, or
    a directory containing exactly one bundle."""
    m = str(model_arg)
    if m.endswith(".pdmodel"):
        return m[: -len(".pdmodel")]
    if os.path.isdir(m):
        bundles = [f for f in os.listdir(m) if f.endswith(".pdmodel")]
        if len(bundles) == 1:
            return os.path.join(m, bundles[0][: -len(".pdmodel")])
        if not bundles:
            raise ValueError(f"no .pdmodel bundle under {m}")
        raise ValueError(f"multiple bundles under {m}: {bundles}; pass "
                         "the prefix explicitly")
    return m


class AnalysisConfig:
    """ref: inference_api.cc AnalysisConfig bindings."""

    class Precision:
        Float32 = "float32"
        Half = "float16"
        Int8 = "int8"

    def __init__(self, model_dir=None, params_file=None):
        self._model_arg = model_dir
        self._params_file = params_file
        self._device = None          # the card
        self._use_feed_fetch_ops = True
        self._specify_input_names = False
        self._ir_optim = True
        self._memory_optim = False
        self._cpu_threads = 1
        self._glog_info = True
        self._mkldnn = False

    # -- model location -----------------------------------------------------
    def set_model(self, model_dir, params_file=None):
        self._model_arg = model_dir
        self._params_file = params_file

    def model_dir(self):
        return str(self._model_arg)

    def prog_file(self):
        return _resolve_prefix(self._model_arg) + ".pdmodel"

    def params_file(self):
        return self._params_file or \
            _resolve_prefix(self._model_arg) + ".pdiparams"

    # -- device -----------------------------------------------------------
    def disable_gpu(self):
        """Run on the CPU."""
        self._device = "cpu"

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        """Run on CUDA device ``device_id`` (PyTorch's caching allocator
        owns the memory pool; its size is not read)."""
        self._device = f"cuda:{int(device_id)}"

    def use_gpu(self):
        return self._device != "cpu"

    def gpu_device_id(self):
        if self._device in (None, "cpu"):
            return 0
        return torch.device(self._device).index

    # -- engine knobs (recorded) --------------------------------------------
    def switch_use_feed_fetch_ops(self, x=True):
        self._use_feed_fetch_ops = bool(x)

    def switch_specify_input_names(self, x=True):
        self._specify_input_names = bool(x)

    def switch_ir_optim(self, x=True):
        self._ir_optim = bool(x)

    def ir_optim(self):
        return self._ir_optim

    def enable_memory_optim(self):
        self._memory_optim = True

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_threads = int(n)

    def cpu_math_library_num_threads(self):
        return self._cpu_threads

    def disable_glog_info(self):
        self._glog_info = False

    def glog_info_disabled(self):
        return not self._glog_info

    def enable_mkldnn(self):
        self._mkldnn = True

    def mkldnn_enabled(self):
        return self._mkldnn

    def enable_tensorrt_engine(self, *a, **k):
        raise NotImplementedError(
            "TensorRT is not part of paddle_tpu_torch: the Predictor "
            "replays the program as a CUDA graph of its own")

    def to_native_config(self):
        return self


class ZeroCopyTensor:
    """ref: zero-copy input/output tensors: an input is staged once, in a
    tensor on the Predictor's device; an output stays on the device until
    ``copy_to_cpu``."""

    def __init__(self, name, predictor, is_input):
        self.name = name
        self._pred = predictor
        self._is_input = is_input
        self._shape = None

    def reshape(self, shape):
        self._shape = tuple(int(s) for s in shape)

    def copy_from_cpu(self, arr):
        if not self._is_input:
            raise ValueError(f"{self.name} is an output tensor")
        arr = np.ascontiguousarray(arr)
        if self._shape is not None:
            arr = arr.reshape(self._shape)
        self._pred._staged[self.name] = torch.from_numpy(arr).to(
            self._pred._pred.device)

    def copy_to_cpu(self):
        if self._is_input:
            return self._pred._staged[self.name].cpu().numpy()
        outs = self._pred._last_outputs
        if outs is None:
            raise RuntimeError("call zero_copy_run() first")
        return outs[self.name].cpu().numpy()

    def shape(self):
        if self._is_input:
            a = self._pred._staged.get(self.name)
            return list(a.shape) if a is not None else list(
                self._shape or [])
        return list(self.copy_to_cpu().shape)


class PaddleTensor:
    """ref: PaddleTensor — the feed-fetch-ops run() data holder."""

    def __init__(self, data=None, name=None, lod=None):
        arr = np.asarray(data) if data is not None else None
        self.name = name
        self.data = arr
        self.shape = list(arr.shape) if arr is not None else []
        self.lod = lod or []

    def as_ndarray(self):
        return self.data


class AnalysisPredictor:
    """ref: analysis_predictor.cc — served by ``inference.Predictor`` on
    the config's device."""

    def __init__(self, config):
        prefix = _resolve_prefix(config.model_dir())
        self._config = config
        self._pred = Predictor(Config(prefix, device=config._device))
        self._staged = {}
        self._last_outputs = None

    def get_input_names(self):
        return self._pred.get_input_names()

    def get_output_names(self):
        return self._pred.get_output_names()

    def get_input_tensor(self, name):
        if name not in self.get_input_names():
            raise KeyError(f"{name} not an input "
                           f"(inputs: {self.get_input_names()})")
        return ZeroCopyTensor(name, self, is_input=True)

    def get_output_tensor(self, name):
        if name not in self.get_output_names():
            raise KeyError(f"{name} not an output "
                           f"(outputs: {self.get_output_names()})")
        return ZeroCopyTensor(name, self, is_input=False)

    def zero_copy_run(self):
        missing = [n for n in self.get_input_names()
                   if n not in self._staged]
        if missing:
            raise ValueError(f"inputs not staged: {missing}")
        outs = self._pred.run(dict(self._staged), return_numpy=False)
        self._last_outputs = dict(zip(self.get_output_names(), outs))
        return True

    def run(self, inputs):
        """Feed-fetch-ops path: list of PaddleTensor in input order (or
        by .name) -> list of PaddleTensor."""
        names = self.get_input_names()
        feed = {}
        for i, t in enumerate(inputs):
            feed[t.name or names[i]] = t.data
        outs = self._pred.run(feed)
        return [PaddleTensor(o, name=n)
                for n, o in zip(self.get_output_names(), outs)]


def create_paddle_predictor(config, *a, **k):
    """ref: inference_api.cc create_paddle_predictor."""
    return AnalysisPredictor(config)
