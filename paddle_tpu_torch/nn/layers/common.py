"""Common layers — ``Linear``, ``Dropout``, ``Embedding``, ``Identity``,
``Flatten``, ``Dropout2D``/``3D``, ``AlphaDropout``, ``Pad1D``/``2D``/
``3D``, ``ZeroPad2D``, ``Upsample*``, ``CosineSimilarity``,
``PairwiseDistance``, ``Bilinear``, ``Unfold``, ``PixelShuffle``,
``ChannelShuffle`` — and ``create_parameter``.

The counterparts of ``paddle_tpu/nn/layers/common.py``'s, as
``nn.Layer``s (``torch.nn.Module``s) with the same parameter names
(``weight``, ``bias``) and Paddle's ``Linear`` layout: the weight is ``(in, out)``
and ``y = x @ W + b``. ``Bilinear``'s weight is ``(out, in1, in2)`` and
its bias ``(1, out)``. The ``Upsample`` layers pass no ``align_mode``
(0: half-pixel centres), as the JAX ones do. Each layer makes its
parameters with ``create_parameter`` on ``device`` (the current place,
``core.device``, unless the caller passes one), drawing random ones
from ``generator`` (default: the device's).
"""
from __future__ import annotations

import torch

from ..._device import resolve_device
from ...core import dtype as _dtype
from ...core.tensor import Parameter
from ...ops._base import RECORDER
from ...ops.manipulation import flatten, pad
from ...utils import unique_name
from .. import functional as F
from ..initializer import (Constant, Normal, XavierUniform,
                           global_initializer)
from ..layer import Layer, _camel_to_snake
from ..param_attr import ParamAttr

__all__ = ["Linear", "Dropout", "Embedding", "create_parameter",
           "copy_parameter_attrs", "Identity", "Flatten", "Dropout2D",
           "Dropout3D", "AlphaDropout", "Pad1D", "Pad2D", "Pad3D",
           "ZeroPad2D", "Upsample", "UpsamplingNearest2D",
           "UpsamplingBilinear2D", "CosineSimilarity", "PairwiseDistance",
           "Bilinear", "Unfold", "PixelShuffle", "ChannelShuffle"]

# what create_parameter sets on a parameter beside requires_grad
_ATTRS = ("optimize_attr", "regularizer", "need_clip")


def _full_name(owner):
    """The layer's name in the JAX package's scheme (``Layer.__init__``,
    ``paddle_tpu/nn/layer.py:38-42``): its class in snake case, numbered;
    a ``Layer`` has it from its making, any other module gets it at its
    first parameter."""
    if owner is None:
        return "param"
    if not hasattr(owner, "_full_name"):
        owner._full_name = unique_name.generate(
            _camel_to_snake(type(owner).__name__))
    return owner._full_name


def create_parameter(shape, attr=None, is_bias=False,
                     default_initializer=None, device=None, generator=None,
                     owner=None, dtype=None):
    """A ``core.Parameter`` of ``shape`` made as ``attr``
    (anything ``ParamAttr._to_attr`` takes) says, or ``None`` for
    ``attr=False``. The initializer is the attr's, else
    ``default_initializer``, else the global one
    (``initializer.set_global_initializer``), else ``Constant(0)`` for a
    bias and ``XavierUniform`` otherwise
    (``paddle_tpu/nn/layer.py:75-88``). Its type is ``dtype``, else the
    ``owner`` layer's, else the default dtype
    (``core.dtype.set_default_dtype``); it lies on ``device`` (default:
    the current place). The parameter is named ``attr.name`` or
    ``<owner's name>_w_<n>`` / ``_b_<n>`` as in the JAX package
    (``owner``: the layer making it), carries ``optimize_attr =
    {"learning_rate": ...}``, ``regularizer`` and ``need_clip``, and
    ``requires_grad`` is the attr's ``trainable``.

    In static mode (``static_.enable_static``) it is a persistable
    parameter Variable of the default main program instead, of the same
    name, and its value, made now on ``device``, goes into
    ``static_.global_scope()``
    (``paddle_tpu/nn/layer.py:89-104``): the startup program has nothing
    left to do."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = (attr.initializer or default_initializer
            or global_initializer(is_bias)
            or (Constant(0.0) if is_bias else XavierUniform()))
    if dtype is None:
        dtype = getattr(owner, "_dtype", None)
    dt = _dtype.convert_dtype(dtype)
    value = init(shape, dt, resolve_device(device), generator)
    name = attr.name or unique_name.generate(
        _full_name(owner) + ("_b" if is_bias else "_w"))
    if RECORDER[0] is not None:
        from ...static_.program import default_main_program, global_scope

        v = default_main_program().global_block.create_var(
            name=name, shape=shape, dtype=dt, persistable=True,
            stop_gradient=not attr.trainable)
        v.is_parameter = True
        v.trainable = bool(attr.trainable)
        v.optimize_attr = {"learning_rate": attr.learning_rate}
        v.regularizer = attr.regularizer
        v.need_clip = attr.need_clip
        global_scope().set(name, value)
        return v
    p = Parameter(value, name=name, trainable=bool(attr.trainable))
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p


def copy_parameter_attrs(src, dst):
    """Set the ``create_parameter`` attributes of ``src``'s parameters
    on ``dst``'s of the same names (``copy.deepcopy`` of a module copies
    a parameter's values but not the attributes set on it)."""
    theirs = dict(src.named_parameters())
    for name, p in dst.named_parameters():
        for a in _ATTRS:
            if hasattr(theirs[name], a):
                setattr(p, a, getattr(theirs[name], a))


class Linear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = create_parameter((in_features, out_features),
                                       weight_attr, device=device,
                                       generator=generator, owner=self)
        # bias_attr=False: no bias (None)
        self.bias = create_parameter((out_features,), bias_attr,
                                     is_bias=True, device=device,
                                     generator=generator, owner=self)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.weight.shape[0]}, out={self.weight.shape[1]}"


class Dropout(Layer):
    """Dropout with the reference's ``axis`` (a mask broadcast along the
    other axes) and ``mode`` (``upscale_in_train`` or
    ``downscale_in_infer``); see ``ops.random_ops.dropout``."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class Embedding(Layer):
    """Rows of ``weight (num_embeddings, embedding_dim)``, N(0, 1) unless
    ``weight_attr`` says otherwise. With ``padding_idx`` (negative counts
    from the end) that row starts at 0 and every lookup of it gives 0
    (``paddle_tpu/nn/layers/common.py:87-101``)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 weight_attr=None, device=None, generator=None):
        super().__init__()
        self._padding_idx = (padding_idx if padding_idx is None
                             or padding_idx >= 0
                             else num_embeddings + padding_idx)
        self.weight = create_parameter(
            (num_embeddings, embedding_dim), weight_attr,
            default_initializer=Normal(0.0, 1.0),
            device=resolve_device(device), generator=generator, owner=self)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Identity(Layer):
    def forward(self, x):
        return x


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)


class Dropout2D(Layer):
    """Whole feature maps dropped (``functional.dropout2d``)."""

    def __init__(self, p=0.5, data_format="NCHW"):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    """Whole volumes dropped (``functional.dropout3d``)."""

    def __init__(self, p=0.5, data_format="NCDHW"):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class _PadNd(Layer):
    nsp = 2

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format or "NC" + "DHW"[-self.nsp:]

    def forward(self, x):
        return pad(x, self.padding, mode=self.mode, value=self.value,
                   data_format=self.data_format)


class Pad1D(_PadNd):
    nsp = 1


class Pad2D(_PadNd):
    nsp = 2


class Pad3D(_PadNd):
    nsp = 3


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW"):
        super().__init__(padding, mode="constant", value=0.0,
                         data_format=data_format)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW"):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size,
                             scale_factor=self.scale_factor, mode=self.mode,
                             align_corners=self.align_corners,
                             data_format=self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size=size, scale_factor=scale_factor,
                         mode="nearest", data_format=data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size=size, scale_factor=scale_factor,
                         mode="bilinear", align_corners=True,
                         data_format=data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, p=self.p, epsilon=self.epsilon,
                                   keepdim=self.keepdim)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = create_parameter(
            (out_features, in1_features, in2_features), weight_attr,
            device=device, generator=generator, owner=self)
        self.bias = create_parameter((1, out_features), bias_attr,
                                     is_bias=True, device=device,
                                     generator=generator, owner=self)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self.kernel_sizes, self.strides = kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW"):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW"):
        super().__init__()
        self.groups = groups

    def forward(self, x):
        return F.channel_shuffle(x, self.groups)
