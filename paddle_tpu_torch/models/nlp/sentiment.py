"""Sentiment classification, the counterparts of
``paddle_tpu/models/nlp/sentiment.py``'s (ref: the reference's book
chapter 6, ``test_understand_sentiment.py``): the text-CNN
(``convolution_net``) and the stacked LSTM (``stacked_lstm_net``),
under the JAX models' parameter names. ``StackedLSTMSentiment`` max-pools
its LSTM's outputs over time with ``ops.max``, whose gradient splits
over ties, as the reference's does: the zeros the LSTM writes at padded
steps tie on every unit whose valid outputs are all negative."""
from __future__ import annotations

from ...nn.layer import Layer, LayerList
from ..._device import resolve_device
from ... import ops
from ...nn import functional as F
from ...nn.layers.common import Dropout, Embedding, Linear
from ...nn.layers.conv import Conv1D
from ...nn.layers.rnn import LSTM

__all__ = ["ConvSentiment", "StackedLSTMSentiment"]


class ConvSentiment(Layer):
    """Text-CNN: parallel conv widths -> tanh -> max-pool over time -> FC.
    ``ids`` (B, L) -> (B, num_classes) logits."""

    def __init__(self, vocab_size, embed_dim=128, num_filters=128,
                 widths=(3, 4), num_classes=2, dropout=0.2, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.embed = Embedding(vocab_size, embed_dim, **kw)
        self.convs = LayerList([
            Conv1D(embed_dim, num_filters, w, padding=w // 2, **kw)
            for w in widths])
        self.drop = Dropout(dropout)
        self.fc = Linear(num_filters * len(widths), num_classes, **kw)

    def forward(self, ids):
        x = ops.transpose(self.embed(ids), [0, 2, 1])   # (B, E, L)
        feats = [ops.max(F.tanh(conv(x)), axis=-1) for conv in self.convs]
        return self.fc(self.drop(ops.concat(feats, axis=-1)))


class StackedLSTMSentiment(Layer):
    """A ``num_layers``-deep LSTM over the embedded ids, its outputs
    max-pooled over time -> FC. ``seq_len`` (B,), on the ids' device,
    masks each row's padded steps."""

    def __init__(self, vocab_size, embed_dim=128, hidden=128, num_layers=3,
                 num_classes=2, dropout=0.2, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.embed = Embedding(vocab_size, embed_dim, **kw)
        self.lstm = LSTM(embed_dim, hidden, num_layers=num_layers, **kw)
        self.drop = Dropout(dropout)
        self.fc = Linear(hidden, num_classes, **kw)

    def forward(self, ids, seq_len=None):
        out, _ = self.lstm(self.embed(ids), sequence_length=seq_len)
        return self.fc(self.drop(ops.max(out, axis=1)))
