"""paddle_tpu_torch: the PyTorch/CUDA counterpart of ``paddle_tpu``.

A package of its own beside the JAX one, with the same module layout so
each module's counterpart is easy to find. It imports ``torch`` and
numpy, never ``jax`` and nothing of ``paddle_tpu``. Every Pallas kernel
on a ported path is a kernel written by hand for Hopper (``sm_90a``),
under ``csrc/``, built with ``nvcc`` at first use.

What is ported so far is the serving path, the GPT, BERT and ResNet-50
training steps, decoding, and checkpointed and guarded training:

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
- ``convert``: weights of the JAX ``TinyLM``, ``GPT``,
  ``BertForPretraining``, ``Transformer``, ``WMTTransformer`` and
  ``ResNet`` into this package's, and a JAX optimizer's state dict under
  this package's parameter names.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
from ._device import resolve_device, resolve_dtype

__all__ = ["resolve_device", "resolve_dtype"]
