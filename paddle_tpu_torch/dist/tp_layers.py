"""Tensor-parallel layers, single-device form.

The counterparts of ``ColumnParallelLinear``, ``RowParallelLinear`` and
``VocabParallelEmbedding`` in ``paddle_tpu/dist/tp_layers.py`` as they
run without a mesh (``tp_layers.py:46-120`` with ``get_mesh()`` None:
every sharding constraint is a no-op), with the same parameter names
and layouts, so a JAX state dict maps onto them name by name. Under data
parallelism (``dist.DistributedTrainStep``) they are replicated on every
rank, as any layer is. Sharding them over a ``model`` axis, and
``ParallelCrossEntropy`` and ``mark_sharding``, wait for ROADMAP Queue 1
item 6b (``dist.init_mesh`` refuses such an axis).
"""
from __future__ import annotations

from ..nn.initializer import Normal
from ..nn.layers.common import Embedding, Linear

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]


class ColumnParallelLinear(Linear):
    """``y = x @ W + b``, ``W (in, out)`` (sharded on ``out`` on a mesh)."""


class RowParallelLinear(Linear):
    """``y = x @ W + b``, ``W (in, out)`` (sharded on ``in`` on a mesh)."""


class VocabParallelEmbedding(Embedding):
    """Embedding table ``(num_embeddings, dim)`` (sharded over the
    vocabulary on a mesh); default initializer N(0, 0.02**2)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 device=None, generator=None):
        super().__init__(num_embeddings, embedding_dim,
                         weight_attr=weight_attr or Normal(0.0, 0.02),
                         device=device, generator=generator)
