"""word2vec, the counterparts of ``paddle_tpu/models/nlp/word2vec.py``'s
(the reference's book chapter 4, ``test_word2vec.py``): the N-gram
language model (``NGramLM``: ``context_size`` embedded words joined, a
hidden ReLU layer, logits over the vocabulary) and the skip-gram model
with negative sampling (``SkipGram``, ``skipgram_loss``), under the JAX
models' parameter names."""
from __future__ import annotations

from ...nn.layer import Layer
from ..._device import resolve_device
from ... import ops
from ...nn import functional as F
from ...nn.layers.common import Embedding, Linear

__all__ = ["NGramLM", "SkipGram", "skipgram_loss"]


class NGramLM(Layer):
    """Embeds ``context_size`` words and predicts the next one: ``words``
    (B, context_size) -> (B, vocab) logits."""

    def __init__(self, vocab_size, embed_dim=32, hidden=256, context_size=4,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.context_size = context_size
        self.embed = Embedding(vocab_size, embed_dim, **kw)
        self.fc1 = Linear(context_size * embed_dim, hidden, **kw)
        self.fc2 = Linear(hidden, vocab_size, **kw)

    def forward(self, words):
        e = self.embed(words)                       # (B, C, E)
        e = ops.reshape(e, [e.shape[0], -1])
        return self.fc2(F.relu(self.fc1(e)))


class SkipGram(Layer):
    """Center and context embedding towers; a candidate's logit is the
    dot product: (B,) center ids x (B, K) candidate ids -> (B, K)."""

    def __init__(self, vocab_size, embed_dim=64, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.center = Embedding(vocab_size, embed_dim, **kw)
        self.context = Embedding(vocab_size, embed_dim, **kw)

    def forward(self, center, context):
        c = self.center(center)                     # (B, E)
        t = self.context(context)                   # (B, K, E)
        return ops.squeeze(ops.matmul(t, ops.unsqueeze(c, -1)), -1)


def skipgram_loss(model, center, context, label):
    """Negative-sampling BCE: label 1 for the true context, 0 for the
    negatives."""
    return F.binary_cross_entropy_with_logits(model(center, context), label)
