"""``ParamAttr``: how a layer makes one of its parameters; and
``WeightNormParamAttr``.

The counterparts of ``paddle_tpu/nn/param_attr.py``'s: the initializer,
the learning-rate multiplier, a regularizer, whether the parameter is
trained, whether it joins a model average (``do_model_average``, kept
and not read, as in the reference) and whether global-norm clipping
counts its gradient. ``WeightNormParamAttr`` adds the norm's ``dim``. A layer
hands the attr to ``nn.layers.common.create_parameter``, which sets
them on the parameter for the optimizer and the clip to read.
"""
from __future__ import annotations

from .initializer import Initializer

__all__ = ["ParamAttr", "WeightNormParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        """A layer's ``weight_attr``/``bias_attr`` argument as an attr:
        ``None`` -> the default attr; ``False`` -> ``False`` (no
        parameter); a ``str`` -> an attr of that name; an initializer ->
        an attr that holds it; an attr -> itself; a list or tuple -> a
        list of attrs."""
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if arg is False:
            return False
        raise TypeError(f"invalid ParamAttr spec: {arg!r}")


class WeightNormParamAttr(ParamAttr):
    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
