"""ResNet family (18/34/50/101/152).

The counterpart of ``paddle_tpu/models/vision/resnet.py``: ``ConvBN``,
``BasicBlock``, ``BottleneckBlock``, ``ResNet`` and ``resnet18`` to
``resnet152``, with the reference's layout (the stride in the 3 x 3
conv, a 1 x 1 ``ConvBN`` downsample) and its parameter and buffer
names (``nn.Sequential`` numbers the stages and blocks:
``layers.0.0.conv1.conv.weight``, ``stem.bn._mean``), so its state dict
maps on name by name (``convert.resnet_params_from_jax``). Weights are
drawn as the reference draws them: every conv N(0, 2 / fan_in) with no
bias, BatchNorm 1 and 0, the classifier ``Linear`` Xavier-uniform and 0.

``model.bfloat16()`` casts every floating parameter and buffer, the
BatchNorms' too, as ``bench.py:bench_resnet50`` does; BatchNorm keeps
float32 statistics and arithmetic inside (``ops.norm_ops.batch_norm``).
No kernel of this package is on this path: conv, pooling and BatchNorm
are outside any Pallas kernel in the JAX package too, and the 1000-class
cross-entropy takes the dense path in both (1000 is not a multiple of
128).
"""
from __future__ import annotations

from ...nn.layer import Layer, Sequential
from ... import ops
from ..._device import resolve_device
from ...nn import functional as F
from ...nn.layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                          MaxPool2D)

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "BasicBlock", "BottleneckBlock", "ConvBN"]


class ConvBN(Layer):
    def __init__(self, cin, cout, k, stride=1, groups=1, act=True,
                 device=None, generator=None):
        super().__init__()
        self.conv = Conv2D(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                           groups=groups, bias_attr=False, device=device,
                           generator=generator)
        self.bn = BatchNorm2D(cout, device=device)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, cin, cout, stride=1, downsample=None, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = ConvBN(cin, cout, 3, stride=stride, **kw)
        self.conv2 = ConvBN(cout, cout, 3, act=False, **kw)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.conv2(self.conv1(x))
        return F.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, cin, cout, stride=1, downsample=None, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = ConvBN(cin, cout, 1, **kw)
        self.conv2 = ConvBN(cout, cout, 3, stride=stride, **kw)
        self.conv3 = ConvBN(cout, cout * 4, 1, act=False, **kw)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(out + identity)


class ResNet(Layer):
    """``ResNet(block, depths)`` on ``device`` (``cuda`` unless the caller
    asks for ``"cpu"``), random weights from ``generator`` (default: the
    device's)."""

    def __init__(self, block, depths, num_classes=1000, in_channels=3,
                 width=64, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.stem = ConvBN(in_channels, width, 7, stride=2, **kw)
        self.pool = MaxPool2D(3, stride=2, padding=1)
        self.inplanes = width
        self.layers = Sequential(*[
            self._make_layer(block, width * (2 ** i), n,
                             stride=1 if i == 0 else 2, **kw)
            for i, n in enumerate(depths)])
        self.avgpool = AdaptiveAvgPool2D(1)
        self.fc = Linear(width * (2 ** (len(depths) - 1)) * block.expansion,
                         num_classes, **kw)

    def _make_layer(self, block, planes, n, stride, **kw):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = ConvBN(self.inplanes, planes * block.expansion, 1,
                                stride=stride, act=False, **kw)
        blocks = [block(self.inplanes, planes, stride, downsample, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, n):
            blocks.append(block(self.inplanes, planes, **kw))
        return Sequential(*blocks)

    def forward(self, x):
        x = self.pool(self.stem(x))
        x = self.layers(x)
        x = self.avgpool(x)
        return self.fc(ops.flatten(x, 1))


def resnet18(**kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], **kw)


def resnet34(**kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], **kw)


def resnet50(**kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], **kw)


def resnet101(**kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], **kw)


def resnet152(**kw):
    return ResNet(BottleneckBlock, [3, 8, 36, 3], **kw)
