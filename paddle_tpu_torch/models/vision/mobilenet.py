"""MobileNet V1 and V2.

The counterpart of ``paddle_tpu/models/vision/mobilenet.py``:
``MobileNetV1`` (depthwise-separable blocks: a 3 x 3 depthwise conv and
a 1 x 1 pointwise conv, each with BatchNorm and ReLU) and
``MobileNetV2`` (inverted residuals: a 1 x 1 expansion, a 3 x 3
depthwise conv, each with BatchNorm and ReLU6, and a linear 1 x 1
projection, with the identity added where the stride is 1 and the width
stays), both with ``scale`` (every width ``max(8, int(c * scale))``) and
V2 with ``dropout`` before its classifier. The layout and the names are
the reference's (``stem.conv.weight``, ``blocks.0.dw.bn._mean``,
``blocks.1.block.0.conv.weight``), so that a state dict maps on name by
name (``convert.mobilenet_params_from_jax``). Weights are drawn as the
reference draws them: every conv N(0, 2 / fan_in) with no bias,
BatchNorm 1 and 0, the classifier ``Linear`` Xavier-uniform and 0.

A depthwise conv is ``Conv2D(c, c, 3, groups=c)``: ``ops.conv2d``'s
``groups``, through cuDNN under the port's deterministic flags, like
every conv. No kernel of this package is on this path.
"""
from __future__ import annotations

from ... import ops
from ..._device import resolve_device
from ...nn import functional as F
from ...nn.layer import Layer, Sequential
from ...nn.layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                          Linear)

__all__ = ["MobileNetV1", "MobileNetV2"]


class _ConvBNAct(Layer):
    def __init__(self, cin, cout, k, stride=1, groups=1, act="relu6",
                 device=None, generator=None):
        super().__init__()
        self.conv = Conv2D(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                           groups=groups, bias_attr=False, device=device,
                           generator=generator)
        self.bn = BatchNorm2D(cout, device=device)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act == "relu6":
            return F.relu6(x)
        if self.act == "relu":
            return F.relu(x)
        return x


class _DepthwiseSeparable(Layer):
    def __init__(self, cin, cout, stride, **kw):
        super().__init__()
        self.dw = _ConvBNAct(cin, cin, 3, stride=stride, groups=cin,
                             act="relu", **kw)
        self.pw = _ConvBNAct(cin, cout, 1, act="relu", **kw)

    def forward(self, x):
        return self.pw(self.dw(x))


def _widths(scale):
    return lambda ch: max(8, int(ch * scale))


class MobileNetV1(Layer):
    """``MobileNetV1`` on ``device`` (``cuda`` unless the caller asks for
    ``"cpu"``), random weights from ``generator`` (default: the
    device's)."""

    def __init__(self, num_classes=1000, scale=1.0, in_channels=3,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        c = _widths(scale)
        cfg = [(c(32), c(64), 1), (c(64), c(128), 2), (c(128), c(128), 1),
               (c(128), c(256), 2), (c(256), c(256), 1), (c(256), c(512), 2),
               *[(c(512), c(512), 1)] * 5,
               (c(512), c(1024), 2), (c(1024), c(1024), 1)]
        self.stem = _ConvBNAct(in_channels, c(32), 3, stride=2, act="relu",
                               **kw)
        self.blocks = Sequential(*[_DepthwiseSeparable(a, b, s, **kw)
                                   for a, b, s in cfg])
        self.pool = AdaptiveAvgPool2D(1)
        self.fc = Linear(c(1024), num_classes, **kw)

    def forward(self, x):
        x = self.pool(self.blocks(self.stem(x)))
        return self.fc(ops.flatten(x, 1))


class _InvertedResidual(Layer):
    def __init__(self, cin, cout, stride, expand, **kw):
        super().__init__()
        hidden = int(round(cin * expand))
        self.use_res = stride == 1 and cin == cout
        layers = []
        if expand != 1:
            layers.append(_ConvBNAct(cin, hidden, 1, **kw))
        layers += [_ConvBNAct(hidden, hidden, 3, stride=stride, groups=hidden,
                              **kw),
                   _ConvBNAct(hidden, cout, 1, act=None, **kw)]
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


class MobileNetV2(Layer):
    """``MobileNetV2`` on ``device`` (``cuda`` unless the caller asks for
    ``"cpu"``), random weights from ``generator`` (default: the
    device's)."""

    def __init__(self, num_classes=1000, scale=1.0, in_channels=3,
                 dropout=0.2, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        c = _widths(scale)
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        self.stem = _ConvBNAct(in_channels, c(32), 3, stride=2, **kw)
        blocks, cin = [], c(32)
        for t, ch, n, s in cfg:
            for i in range(n):
                blocks.append(_InvertedResidual(cin, c(ch),
                                                s if i == 0 else 1, t, **kw))
                cin = c(ch)
        self.blocks = Sequential(*blocks)
        self.head = _ConvBNAct(cin, c(1280), 1, **kw)
        self.pool = AdaptiveAvgPool2D(1)
        self.drop = Dropout(dropout)
        self.fc = Linear(c(1280), num_classes, **kw)

    def forward(self, x):
        x = self.head(self.blocks(self.stem(x)))
        x = self.drop(ops.flatten(self.pool(x), 1))
        return self.fc(x)
