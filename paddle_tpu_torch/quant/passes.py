"""1.x quantization pass classes, the counterpart of
``paddle_tpu/quant/passes.py`` (ref:
python/paddle/fluid/contrib/slim/quantization/quantization_pass.py and
fluid/contrib/quantize/quantize_transpiler.py).

The reference passes rewrite IrGraph/ProgramDesc: insert fake_quant /
fake_dequant ops, freeze trained scales, swap weights to int8. As in the
JAX package, the passes here rewrite models (``torch.nn.Module``s built
from this package's layers) with the ``quant`` machinery, so the pass
verbs map onto model rewrites:

- QuantizationTransformPass.apply(model)  -> QAT fake-quant wrapping
- AddQuantDequantPass.apply(model)        -> the same
- QuantizationFreezePass.apply(model)     -> QAT wrappers -> int8 layers
- ConvertToInt8Pass.apply(model)          -> weight-only int8 layers
- OutScaleForTrainingPass.apply(model)    -> abs-max output observers
- OutScaleForInferencePass.apply(model)   -> freeze observed out scales
- TransformForMobilePass                  -> no-op (no mobile kernel set)

A saved static bundle is quantized by ``quant.quantize_inference_model``.
"""
from __future__ import annotations

from torch import nn

from . import QAT, QuantizedConv2D, QuantizedLinear, quantize_model

__all__ = [
    "QuantizationTransformPass", "QuantizationFreezePass",
    "ConvertToInt8Pass", "TransformForMobilePass",
    "OutScaleForTrainingPass", "OutScaleForInferencePass",
    "AddQuantDequantPass", "QuantizeTranspiler",
]


def _as_model(graph):
    model = getattr(graph, "_model", graph)
    if not isinstance(model, nn.Module):
        raise TypeError(
            "quantization passes operate on torch.nn.Module models "
            f"(got {type(graph).__name__}); for saved static bundles "
            "use quant.quantize_inference_model")
    return model


class QuantizationTransformPass:
    """ref: quantization_pass.py QuantizationTransformPass — insert
    trainable fake-quant on weights (+ inputs)."""

    def __init__(self, scope=None, place=None, weight_bits=8,
                 activation_bits=8, activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", **kw):
        self._weight_bits = weight_bits
        self._activation_bits = activation_bits

    def apply(self, graph):
        model = _as_model(graph)
        QAT(bits=self._weight_bits,
            quantize_inputs=self._activation_bits > 0).quantize(model)
        return graph


class AddQuantDequantPass(QuantizationTransformPass):
    """ref: quantization_pass.py AddQuantDequantPass — quant/dequant on
    activations of additional op types; here the same fake-quant
    wrapping with input quantization on."""


class QuantizationFreezePass:
    """ref: quantization_pass.py QuantizationFreezePass — replace the
    trained fake-quant wrappers with real int8-weight layers."""

    def __init__(self, scope=None, place=None, weight_bits=8,
                 activation_bits=8, weight_quantize_type="abs_max", **kw):
        self._weight_bits = weight_bits

    def apply(self, graph):
        model = _as_model(graph)
        QAT(bits=self._weight_bits).convert(model)
        return graph


class ConvertToInt8Pass:
    """ref: quantization_pass.py ConvertToInt8Pass — weight-only int8
    layers (int8 weights and scales resident on the device)."""

    def __init__(self, scope=None, place=None, quantizable_op_type=None,
                 **kw):
        pass

    def apply(self, graph):
        model = _as_model(graph)
        quantize_model(model)
        return graph


class TransformForMobilePass:
    """ref: quantization_pass.py TransformForMobilePass — renames quant
    ops for the Paddle-Lite mobile kernel set, which this package does
    not target: a documented no-op, as in the JAX package."""

    def __init__(self, **kw):
        pass

    def apply(self, graph):
        return graph


class OutScaleForTrainingPass:
    """ref: quantization_pass.py OutScaleForTrainingPass — observe each
    quantizable layer's output abs-max during training (forward hooks;
    a moving average with ``moving_rate`` after the first)."""

    _TYPES = ("Linear", "Conv2D", "QATLinear", "QATConv2D")

    def __init__(self, scope=None, place=None, moving_rate=0.9, **kw):
        self._moving_rate = moving_rate
        self.out_scales = {}
        self._handles = []

    def apply(self, graph):
        model = _as_model(graph)
        for name, layer in model.named_modules():
            if isinstance(layer, (QuantizedLinear, QuantizedConv2D)) or \
                    type(layer).__name__ in self._TYPES:
                self._handles.append(layer.register_forward_hook(
                    self._observer(name)))
        return graph

    def _observer(self, name):
        def hook(layer, inputs, output):
            mx = float(output.detach().abs().max())
            prev = self.out_scales.get(name)
            self.out_scales[name] = mx if prev is None else (
                self._moving_rate * prev + (1 - self._moving_rate) * mx)

        return hook

    def remove(self):
        for h in self._handles:
            h.remove()


class OutScaleForInferencePass:
    """ref: quantization_pass.py OutScaleForInferencePass — freeze the
    observed output scales onto the model for inference consumers."""

    def __init__(self, scope=None, training_pass=None, **kw):
        self._training_pass = training_pass

    def apply(self, graph):
        model = _as_model(graph)
        if self._training_pass is not None:
            model._out_threshold = dict(self._training_pass.out_scales)
        return graph


class QuantizeTranspiler:
    """ref: contrib/quantize/quantize_transpiler.py — the pre-slim
    three-verb quantization flow over a model."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", window_size=10000,
                 moving_rate=0.9):
        self._weight_bits = weight_bits
        self._activation_bits = activation_bits

    def training_transpile(self, program=None, startup_program=None):
        """Fake-quant wrap for QAT (ref: training_transpile)."""
        return QuantizationTransformPass(
            weight_bits=self._weight_bits,
            activation_bits=self._activation_bits).apply(program)

    def freeze_program(self, program, place=None, fuse_bn=False,
                       scope=None):
        """Trained wrappers -> real int8 layers (ref: freeze_program)."""
        return QuantizationFreezePass(
            weight_bits=self._weight_bits).apply(program)

    def convert_to_int8(self, program, place=None, scope=None):
        """Weight-only int8 (ref: convert_to_int8)."""
        return ConvertToInt8Pass().apply(program)
