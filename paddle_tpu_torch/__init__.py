"""paddle_tpu_torch: the PyTorch/CUDA counterpart of ``paddle_tpu``.

A package of its own beside the JAX one, with the same module layout so
each module's counterpart is easy to find. It imports ``torch`` and
numpy, never ``jax`` and nothing of ``paddle_tpu``. Every Pallas kernel
on a ported path is a kernel written by hand for Hopper (``sm_90a``),
under ``csrc/``, built with ``nvcc`` at first use.

What is ported so far is the serving path, the GPT and BERT training
steps and decoding:

- ``serving``: paged KV cache, continuous-batching scheduler and
  ``ServeEngine`` with the one-layer ``TinyLM``;
- ``ops.kernels.paged_attention``: the paged decode attention kernel
  (CUDA C++) with its plain PyTorch version;
- ``obs`` and ``resilience``: the metrics, lockdep, trace, journal,
  usage, retry and chaos pieces the serve loop calls;
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
- ``convert``: weights of the JAX ``TinyLM``, ``GPT``,
  ``BertForPretraining``, ``Transformer`` and ``WMTTransformer`` into
  this package's.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
from ._device import resolve_device, resolve_dtype

__all__ = ["resolve_device", "resolve_dtype"]
