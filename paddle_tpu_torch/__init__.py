"""paddle_tpu_torch: the PyTorch/CUDA counterpart of ``paddle_tpu``.

A package of its own beside the JAX one, with the same module layout so
each module's counterpart is easy to find. It imports ``torch`` and
numpy, never ``jax`` and nothing of ``paddle_tpu``. Every Pallas kernel
on a ported path is a kernel written by hand for Hopper (``sm_90a``),
under ``csrc/``, built with ``nvcc`` at first use.

What is ported so far is the serving path, the GPT, BERT and ResNet-50
training steps, decoding, checkpointed and guarded training, the static
graph, inference and the layer library:

- ``serving``: paged KV cache, continuous-batching scheduler and
  ``ServeEngine`` with the one-layer ``TinyLM``;
- ``ops.kernels.paged_attention``: the paged decode attention kernel
  (CUDA C++) with its plain PyTorch version;
- ``obs`` and ``resilience``: the metrics, lockdep, trace, journal,
  usage, retry and chaos pieces the serve loop and the training guards
  call;
- ``models.nlp.gpt`` with ``nn`` (layers, functional ops, initializers),
  ``dist.tp_layers`` (single device), ``optim`` (Adam, AdamW, global-norm
  clip), ``framework.TrainStep`` and ``core.random``: the eager training
  step of the GPT decoder;
- ``ops.kernels.layernorm`` and ``ops.kernels.softmax_ce``: the
  LayerNorm and softmax-cross-entropy kernels, forward and backward
  (CUDA C++), with their plain PyTorch versions;
- ``models.nlp.bert`` with ``nn.layers.transformer`` (the Transformer
  encoder without a cache), ``nn.ParamAttr``, the Xavier and uniform
  initializers and ``optim.regularizer``: BERT pretraining as
  ``bench.py:bench_bert`` runs it, on the LayerNorm kernels;
- decoding: the Transformer layers' KV caches and decoder,
  ``models.nlp.gpt``'s ``generate``/``generate_xla``, ``inference``
  (beam search, greedy search, ``dynamic_decode``) and
  ``models.nlp.transformer.WMTTransformer``, the graphed decodes as one
  CUDA graph per signature (``framework.ProgramCache``);
- ``models.vision.resnet`` with ``nn.Conv2D``, ``nn.BatchNorm2D``,
  ``nn.MaxPool2D``, ``nn.AdaptiveAvgPool2D``, ``ops.conv`` and
  ``ops.norm_ops.batch_norm``: ResNet-50 training as
  ``bench.py:bench_resnet50`` runs it, on cuDNN's conv (deterministic,
  no TF32) and no kernel of this package (the JAX package runs no Pallas
  kernel there either);
- ``framework.io`` and ``resilience.guard``: ``save``/``load`` and
  crash-safe training checkpoints in the JAX package's format (a
  manifest of crc32s, a fallback to the newest intact checkpoint, an
  async writer), loaded into the live storage so a graphed step replays
  on; ``GuardedStep`` (skip or roll back a non-finite step, retry a
  transient failure) with the chaos injectors that drill them,
  ``utils.nan_guard`` and the journal's step records with ``obs.mfu``;
- ``static_`` (also ``paddle_tpu_torch.static``) and ``analysis``: the
  static graph — ``Program``, recording in static mode
  (``enable_static``, ``program_guard``), ``append_backward``, the
  verifier and the compile passes, and ``Executor.run``/``run_steps``
  as one CUDA graph per cache key — with ``models.vision.LeNet``, as
  ``bench.py:bench_lenet_exec`` runs it;
- ``framework.io``'s inference bundles and program-level I/O, ``quant``
  (PTQ, QAT, the int8 bundle pass) and ``inference``'s ``Predictor``
  (one CUDA graph per feed signature) and analysis API, as
  ``bench.py:bench_int8_predictor`` runs them; ``bench.py:bench_serve``'s
  legs are ``tools/torch_serve_bench.py``'s ``bench_serve_leg``;
- ``nn``'s layer library: every class of the JAX package's
  ``nn/layers`` (the recurrent stacks and cells, the activations, conv,
  pooling, norm and loss layers) and every name of ``nn.functional``
  but ``sequence_mask``, with ``models.nlp``'s ``ConvSentiment`` and
  ``StackedLSTMSentiment`` (the book's chapter 6 nets) trained through
  ``TrainStep``'s graph;
- the Paddle tensor API (``ops``: creation, math, reductions,
  manipulation, comparison, linear algebra, control flow), every name
  the JAX package exports at its top level from its op modules, also
  here at the top (``pt.sum``, ``pt.topk``, ``pt.scatter``);
  ``paddle_tpu_torch.dist`` calls as the tensor API's ``dist``; ``models.nlp.word2vec`` and
  ``models.rec`` (the book's chapters 4 and 5), and the recurrent run
  of a static Program as one ``rnn_scan`` op;
- ``convert``: weights of the JAX ``TinyLM``, ``GPT``,
  ``BertForPretraining``, ``Transformer``, ``WMTTransformer``,
  ``ResNet``, the sentiment nets, the recurrent stacks and any layer
  into this package's, and a JAX optimizer's state dict under this
  package's parameter names.

- the Paddle user surface (``paddle_tpu/__init__.py:62-83, 126-218``):
  ``nn.Layer`` and its containers, which every layer and model of the
  package subclasses; ``to_tensor``, ``Tensor``, ``Parameter``,
  ``grad`` and the grad modes; the dtype names and the default dtype;
  the places and ``set_device``; ``to_static``/``jit`` (a Layer's
  forward or a function as one CUDA graph a signature); ``TrainStep``,
  ``save``/``load``, ``recompute`` and the rest of the top level; and
  the 2.x module spellings (``paddle_tpu_torch.tensor``, ``.optimizer``,
  ``.static``, ``.device``, ``.distributed``, ``.regularizer``;
  ``modules_compat``). Subpackages are imported at first use.

- data parallelism (``dist``, also ``distributed``; ``fleet``): the
  process group and the mesh, the collectives, the launcher
  (``python -m paddle_tpu_torch.dist.launch``), ``DataParallel`` and
  ``DistributedTrainStep`` with the bucketed and int8 gradient exchange
  and ``run_fused`` accumulation, fleet's collective front end and
  ``nn.SyncBatchNorm`` across ranks.

Entry points run on the current place: the CUDA card, unless the caller
passes ``device="cpu"`` or chose the host with ``set_device("cpu")``;
without a card they raise instead of falling back.

Not here yet (ROADMAP Queue 1): ``Model``, ``DataLoader``, ``batch``,
``reader``, ``summary``, ``flops``, ``metrics``, ``distribution``,
``slim``, ``hapi``, ``dataset``, ``vision``, ``fluid``, ``io``,
``metric``, ``imperative``, ``compat``, ``version``, ``sysconfig`` and
``check_import_scipy`` (item 10); ``runtime`` and
``set_compilation_cache`` (item 8).
"""
from __future__ import annotations

from . import modules_compat as _modules_compat
from . import ops
from ._device import resolve_device, resolve_dtype
from .core import (Parameter, Tensor, enable_grad, grad, is_grad_enabled,
                   no_grad, to_tensor)
from .core.device import (CPUPlace, CUDAPlace, Place, TPUPlace, device_count,
                          get_device, is_compiled_with_tpu, set_device)
from .core.dtype import (bfloat16, bool_, complex64, complex128, float16,
                         float32, float64, get_default_dtype, int8, int16,
                         int32, int64, set_default_dtype, uint8)
from .ops import __all__ as _TENSOR_API

# the subpackages, imported at first use
_SUBPACKAGES = ("nn", "optim", "amp", "inference", "serving", "quant",
                "static_", "framework", "resilience", "obs", "analysis",
                "convert", "models", "utils", "core", "dist")

# names bound lazily: name -> (module, attribute; None: the module)
_LAZY = {
    "enable_static": ("static_", "enable_static"),
    "disable_static": ("static_", "disable_static"),
    "in_static_mode": ("static_", "in_static_mode"),
    "program_guard": ("static_", "program_guard"),
    "global_scope": ("static_", "global_scope"),
    "seed": ("core", "seed"),
    "TrainStep": ("framework.jit", "TrainStep"),
    "to_static": ("framework.jit", "to_static"),
    "jit": ("framework.jit", "jit"),
    "save": ("framework.io", "save"),
    "load": ("framework.io", "load"),
    "recompute": ("framework.recompute", "recompute"),
    "Recompute": ("framework.recompute", "Recompute"),
    "ParamAttr": ("nn.param_attr", "ParamAttr"),
    "unique_name": ("utils.unique_name", None),
}

__all__ = [
    "resolve_device", "resolve_dtype", "Tensor", "Parameter", "to_tensor",
    "no_grad", "enable_grad", "is_grad_enabled", "grad", "float16",
    "bfloat16", "float32", "float64", "int8", "int16", "int32", "int64",
    "uint8", "bool_", "bool", "complex64", "complex128",
    "set_default_dtype", "get_default_dtype", "set_device", "get_device",
    "device_count", "is_compiled_with_tpu", "TPUPlace", "CPUPlace",
    "CUDAPlace", "Place", "in_dynamic_mode", "div", "elementwise_equal",
    "elementwise_sum", "create_tensor", "static", "ops",
    *[n for n in _SUBPACKAGES if n not in ("core", "utils", "convert",
                                           "models", "analysis")],
    *_LAZY, *_modules_compat.ALIASES, *_TENSOR_API]


def in_dynamic_mode():
    """Whether the process runs eagerly (not in static mode)."""
    from .static_ import in_static_mode

    return not in_static_mode()


# 1.x tensor-API aliases (ref: python/paddle/tensor/math.py)
div = ops.divide
elementwise_equal = ops.equal
elementwise_sum = ops.add_n


def create_tensor(dtype, name=None, persistable=False):
    """ref: ``tensor/creation.py`` ``create_tensor``: a zero tensor of
    shape ``[1]`` and ``dtype`` on the current place."""
    return ops.zeros([1], dtype=dtype)


def __getattr__(name):
    import importlib

    if name in _modules_compat.ALIASES:
        return _modules_compat.resolve(__name__, name)
    if name in _SUBPACKAGES:
        # ``dist`` is the package, which also calls as the tensor API's
        # ``dist``
        return importlib.import_module("." + name, __name__)
    if name in _LAZY:
        mod, attr = _LAZY[name]
        m = importlib.import_module("." + mod, __name__)
        return m if attr is None else getattr(m, attr)
    if name in _TENSOR_API:
        return getattr(ops, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_modules_compat.install(__name__)

bool = bool_  # paddle.bool
