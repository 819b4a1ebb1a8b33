"""VGG family (11/13/16/19, BatchNorm by default).

The counterpart of ``paddle_tpu/models/vision/vgg.py``: ``VGG(depth)``
and ``vgg11`` to ``vgg19``, the reference's layout and names (the 3 x 3
convs with their bias, each followed by ``BatchNorm2D`` and ``ReLU``, a
2 x 2 max pool after each stage, in ``features``; the 7 x 7 adaptive
average pool; the classifier ``Linear(512 * 49, 4096)``, ``ReLU``,
``Dropout``, ``Linear(4096, 4096)``, ``ReLU``, ``Dropout``,
``Linear(4096, classes)``), so that its state dict maps on name by name
(``convert.vgg_params_from_jax``). Weights are drawn as the reference
draws them: every conv N(0, 2 / fan_in) and a bias of 0, BatchNorm 1
and 0, each ``Linear`` Xavier-uniform and 0.

``model.bfloat16()`` casts every floating parameter and buffer, as
``bench.py:bench_resnet50`` casts ResNet-50. No kernel of this package
is on this path: conv, pooling, BatchNorm and the classifier's matmuls
are outside any Pallas kernel in the JAX package too, and the
1000-class cross-entropy takes the dense path in both.
"""
from __future__ import annotations

from ... import ops
from ..._device import resolve_device
from ...nn.layer import Layer, Sequential
from ...nn.layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                          Linear, MaxPool2D, ReLU)

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(Layer):
    """``VGG(depth)`` on ``device`` (``cuda`` unless the caller asks for
    ``"cpu"``), random weights from ``generator`` (default: the
    device's)."""

    def __init__(self, depth=16, num_classes=1000, batch_norm=True,
                 in_channels=3, dropout=0.5, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        layers, cin = [], in_channels
        for v in _CFGS[depth]:
            if v == "M":
                layers.append(MaxPool2D(2, 2))
                continue
            layers.append(Conv2D(cin, v, 3, padding=1, **kw))
            if batch_norm:
                layers.append(BatchNorm2D(v, device=kw["device"]))
            layers.append(ReLU())
            cin = v
        self.features = Sequential(*layers)
        self.avgpool = AdaptiveAvgPool2D(7)
        self.classifier = Sequential(
            Linear(512 * 7 * 7, 4096, **kw), ReLU(), Dropout(dropout),
            Linear(4096, 4096, **kw), ReLU(), Dropout(dropout),
            Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(ops.flatten(x, 1))


def vgg11(**kw):
    return VGG(11, **kw)


def vgg13(**kw):
    return VGG(13, **kw)


def vgg16(**kw):
    return VGG(16, **kw)


def vgg19(**kw):
    return VGG(19, **kw)
