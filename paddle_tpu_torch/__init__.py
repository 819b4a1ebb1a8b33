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
  ``paddle_tpu_torch.dist`` is the tensor-parallel layers' package and
  calls as the tensor API's ``dist``; ``models.nlp.word2vec`` and
  ``models.rec`` (the book's chapters 4 and 5), and the recurrent run
  of a static Program as one ``rnn_scan`` op;
- ``convert``: weights of the JAX ``TinyLM``, ``GPT``,
  ``BertForPretraining``, ``Transformer``, ``WMTTransformer``,
  ``ResNet``, the sentiment nets, the recurrent stacks and any layer
  into this package's, and a JAX optimizer's state dict under this
  package's parameter names.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
from ._device import resolve_device, resolve_dtype
from .ops import __all__ as _TENSOR_API

__all__ = ["resolve_device", "resolve_dtype", "static", "framework",
           "enable_static",
           "disable_static", "in_static_mode", "program_guard", "seed",
           *_TENSOR_API]

# the static-graph surface under the names paddle scripts use
# (``bench.py:bench_lenet_exec``), imported at first use
_LAZY = {"enable_static": "static_", "disable_static": "static_",
         "in_static_mode": "static_", "program_guard": "static_",
         "seed": "core"}


def __getattr__(name):
    import importlib

    if name in ("static", "framework"):
        # ``pt.framework.io.save_inference_model`` as bench.py spells it
        return importlib.import_module(
            ".static_" if name == "static" else ".framework", __name__)
    if name in _LAZY:
        return getattr(importlib.import_module("." + _LAZY[name], __name__),
                       name)
    if name == "dist":
        # the subpackage, which also calls as the tensor API's ``dist``
        return importlib.import_module(".dist", __name__)
    if name in _TENSOR_API:
        return getattr(importlib.import_module(".ops", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
