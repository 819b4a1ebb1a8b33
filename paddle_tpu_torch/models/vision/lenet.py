"""LeNet-5 for MNIST, the counterpart of
``paddle_tpu/models/vision/lenet.py`` (ref: the reference's book ch.2
recognize-digits CNN): two conv + pool blocks, then three ``Linear``
layers, under the JAX model's parameter names (``features.0.weight``
... ``fc.4.bias``). ``bench.py:bench_lenet_exec`` builds it in static
mode and trains it through the Executor."""
from __future__ import annotations

from ...nn.layer import Layer, Sequential
from ..._device import resolve_device
from ... import ops
from ...nn.layers.activation import ReLU
from ...nn.layers.common import Linear
from ...nn.layers.conv import Conv2D
from ...nn.layers.pooling import MaxPool2D

__all__ = ["LeNet"]


class LeNet(Layer):
    """Classic LeNet-5 (``num_classes`` logits; feed (B, 1, 28, 28))."""

    def __init__(self, num_classes=10, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **kw), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **kw), ReLU(),
            MaxPool2D(2, 2))
        self.fc = Sequential(
            Linear(400, 120, **kw), ReLU(),
            Linear(120, 84, **kw), ReLU(),
            Linear(84, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        x = ops.flatten(x, 1)
        return self.fc(x)
