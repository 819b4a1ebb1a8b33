"""Quantization: post-training int8 (PTQ) and quant-aware training (QAT).

The counterpart of ``paddle_tpu/quant/__init__.py`` (ref: the
reference's slim quantization suite — post_training_quantization.py and
quantization_pass.py's fake_quantize_abs_max with straight-through
gradients).

- ``quantize_abs_max`` stays numpy, as in the JAX package, so both give
  the same int8 arrays and scales bit for bit; ``dequantize`` is
  ``q.to(dtype) * scale``.
- ``QuantizedLinear``/``QuantizedConv2D`` hold int8 weights and float32
  per-output-channel scales as buffers on the wrapped layer's device and
  dequantize before the matmul or conv. The JAX package leaves XLA to
  fuse that multiply into the consumer; here PyTorch writes the float
  weight first, so the int8 copy saves memory, not weight traffic
  (PERF.md §7).
- ``fake_quantize_abs_max`` is a registered op (``ops._base``) whose
  straight-through gradient (``jax.custom_vjp`` in the JAX package,
  ``:44-64``) is a ``torch.autograd.Function``: the gradient passes
  where ``|x| <= scale`` and is 0 elsewhere and for the scale.
- ``quantize_model``, ``PostTrainingQuantization`` and ``QAT`` swap the
  port's ``nn.Linear``/``nn.Conv2D`` for their int8 or fake-quant
  twins; ``quantize_inference_model`` rewrites a saved bundle
  (``framework.io.save_inference_model``) into an int8 one that
  ``load_inference_model`` and the ``inference.Predictor`` run.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..nn.layer import Layer
from ..nn import functional as F
from ..nn.layers.common import Linear
from ..nn.layers.conv import Conv2D
from ..ops._base import register

__all__ = [
    "fake_quantize_abs_max", "fake_quantize_dequantize",
    "quantize_abs_max", "dequantize",
    "QuantizedLinear", "QuantizedConv2D", "QATLinear", "QATConv2D",
    "PostTrainingQuantization", "quantize_model", "QAT",
    "quantize_inference_model",
]


# ---------------------------------------------------------------------------
# fake-quant ops (STE gradients)
# ---------------------------------------------------------------------------


class _FakeQuant(torch.autograd.Function):
    """``round(x / s * qmax)`` clipped to ``[-qmax, qmax]``, times
    ``s / qmax`` (``s`` = the scale, at least 1e-8); the gradient goes
    straight through where ``|x| <= s``."""

    @staticmethod
    def forward(ctx, x, scale, qmax):
        s = torch.clamp(scale, min=1e-8)
        ctx.save_for_backward((x.abs() <= s).to(x.dtype))
        q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
        return q * s / qmax

    @staticmethod
    def backward(ctx, g):
        (in_range,) = ctx.saved_tensors
        return g * in_range, None, None


@register("fake_quantize_abs_max", inputs=("x",))
def _fake_quantize_abs_max(x, *, bits, channel_axis):
    qmax = float(2 ** (bits - 1) - 1)
    if channel_axis is None:
        scale = x.detach().abs().max()
    else:
        red = tuple(i for i in range(x.dim()) if i != channel_axis)
        scale = x.detach().abs().amax(dim=red, keepdim=True)
    return _FakeQuant.apply(x, scale, qmax)


def fake_quantize_abs_max(x, bits=8, channel_axis=None, name=None):
    """Simulated quantization with abs-max scaling and straight-through
    gradients (ref: quantization_pass.py fake_quantize_abs_max)."""
    return _fake_quantize_abs_max(x, bits=int(bits),
                                  channel_axis=channel_axis)


fake_quantize_dequantize = fake_quantize_abs_max


def quantize_abs_max(w, bits=8, channel_axis=None):
    """Real quantization on the host: ``(int8 values, float32 scale)``.
    ``w`` is an array or a tensor (copied to the host)."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    arr = np.asarray(w, np.float32)
    qmax = 2 ** (bits - 1) - 1
    if channel_axis is None:
        scale = np.maximum(np.abs(arr).max(), 1e-8)
    else:
        red = tuple(i for i in range(arr.ndim) if i != channel_axis)
        scale = np.maximum(np.abs(arr).max(axis=red, keepdims=True), 1e-8)
    q = np.clip(np.round(arr / scale * qmax), -qmax, qmax).astype(np.int8)
    return q, (scale / qmax).astype(np.float32)


def dequantize(q, scale, dtype=torch.float32):
    """``q`` times ``scale``, both cast to ``dtype`` (tensors or arrays;
    a tensor's device is kept)."""
    return torch.as_tensor(q).to(dtype) * torch.as_tensor(scale).to(dtype)


# ---------------------------------------------------------------------------
# quantized layers
# ---------------------------------------------------------------------------


class _Int8Weight(Layer):
    """The int8 weight of ``layer`` with per-channel scales on
    ``channel_axis``, as buffers on the layer's device."""

    def __init__(self, layer, bits, channel_axis):
        super().__init__()
        w = layer.weight
        q, s = quantize_abs_max(w, bits=bits, channel_axis=channel_axis)
        self.register_buffer("qweight", torch.from_numpy(q).to(w.device))
        self.register_buffer("wscale", torch.from_numpy(s).to(w.device))
        self.bias = layer.bias
        self._dtype = w.dtype

    def dequantized(self):
        return dequantize(self.qweight, self.wscale, self._dtype)


class QuantizedLinear(_Int8Weight):
    """``Linear`` with an int8 weight and per-output-channel scales
    (axis 1 of the ``(in, out)`` weight)."""

    def __init__(self, linear, bits=8):
        super().__init__(linear, bits, channel_axis=1)

    def forward(self, x):
        return F.linear(x, self.dequantized(), self.bias)


class QuantizedConv2D(_Int8Weight):
    """``Conv2D`` with int8 weights (per-out-channel scales on axis 0)."""

    def __init__(self, conv, bits=8):
        super().__init__(conv, bits, channel_axis=0)
        self._cfg = dict(stride=conv._stride, padding=conv._padding,
                         dilation=conv._dilation, groups=conv._groups)

    def forward(self, x):
        return F.conv2d(x, self.dequantized(), self.bias, **self._cfg)


def quantize_model(model, bits=8, quantizable=(Linear, Conv2D)):
    """Swap every Linear/Conv2D in place for its int8 twin; returns the
    model (weight-only PTQ — the core of the reference's PTQ pipeline)."""
    for name, child in list(model.named_children()):
        if isinstance(child, Linear) and Linear in quantizable:
            setattr(model, name, QuantizedLinear(child, bits=bits))
        elif isinstance(child, Conv2D) and Conv2D in quantizable:
            setattr(model, name, QuantizedConv2D(child, bits=bits))
        else:
            quantize_model(child, bits=bits, quantizable=quantizable)
    return model


class PostTrainingQuantization:
    """ref: post_training_quantization.py — calibrate activation ranges
    on sample data, then emit the quantized model.

    >>> ptq = PostTrainingQuantization(model, loader, algo="abs_max")
    >>> qmodel = ptq.quantize()

    ``data_loader`` yields batches (an array or tensor, or a tuple whose
    first item is the input). Weight quantization is exact (per-channel
    abs-max); each quantizable layer's input peak is collected during
    calibration and stored on its int8 twin (``act_scale``)."""

    def __init__(self, model, data_loader=None, batch_nums=4,
                 algo="abs_max", bits=8,
                 quantizable_op_type=("mul", "conv2d")):
        if algo not in ("abs_max", "avg"):
            raise NotImplementedError(
                f"algo={algo!r} not implemented (have 'abs_max', 'avg'; "
                "the reference's KL/hist/mse calibrators are not)")
        self.model = model
        self.loader = data_loader
        self.batch_nums = batch_nums
        self.algo = algo
        self.bits = bits
        self._acts = {}

    def _hook(self, name):
        def fn(layer, inputs, output):
            peak = float(inputs[0].detach().abs().max())
            if self.algo == "avg":
                self._acts.setdefault(name, []).append(peak)
            else:
                self._acts[name] = max(self._acts.get(name, 0.0), peak)

        return fn

    def quantize(self):
        targets = [(n, m) for n, m in self.model.named_modules()
                   if isinstance(m, (Linear, Conv2D))]
        if self.loader is not None:
            handles = [m.register_forward_hook(self._hook(n))
                       for n, m in targets]
            device = next(self.model.parameters()).device
            self.model.eval()
            try:
                with torch.no_grad():
                    for i, batch in enumerate(self.loader):
                        if i >= self.batch_nums:
                            break
                        xs = batch[0] if isinstance(batch, (list, tuple)) \
                            else batch
                        self.model(torch.as_tensor(xs, device=device))
            finally:
                for h in handles:
                    h.remove()
        quantize_model(self.model, bits=self.bits)
        # attach calibrated activation scales to the swapped-in layers
        for n, m in self.model.named_modules():
            if isinstance(m, (QuantizedLinear, QuantizedConv2D)):
                peak = self._acts.get(n)
                if isinstance(peak, list):
                    peak = float(np.mean(peak))
                if peak is not None:
                    m.act_scale = peak / (2 ** (self.bits - 1) - 1)
        return self.model


class QATLinear(Layer):
    """Fake-quant wrapper owning the original Linear (the same Parameter
    objects, so an optimizer built after wrapping trains the float32
    weights; gradients go straight through the fake-quant)."""

    def __init__(self, linear, bits=8, quantize_inputs=True):
        super().__init__()
        self.inner = linear
        self.bits = bits
        self.quantize_inputs = quantize_inputs

    def forward(self, x):
        if self.quantize_inputs:
            x = fake_quantize_abs_max(x, bits=self.bits)
        w = fake_quantize_abs_max(self.inner.weight, bits=self.bits,
                                  channel_axis=1)
        return F.linear(x, w, self.inner.bias)


class QATConv2D(Layer):
    def __init__(self, conv, bits=8, quantize_inputs=True):
        super().__init__()
        self.inner = conv
        self.bits = bits
        self.quantize_inputs = quantize_inputs

    def forward(self, x):
        if self.quantize_inputs:
            x = fake_quantize_abs_max(x, bits=self.bits)
        w = fake_quantize_abs_max(self.inner.weight, bits=self.bits,
                                  channel_axis=0)
        c = self.inner
        return F.conv2d(x, w, c.bias, stride=c._stride, padding=c._padding,
                        dilation=c._dilation, groups=c._groups)


class QAT:
    """Quant-aware training (ref: quantization_pass.py QAT transform):
    swap Linear/Conv2D for fake-quant wrappers, train as usual (build
    the optimizer AFTER quantize()), then convert to real int8 layers.

    >>> qat = QAT(bits=8); qat.quantize(model)   # train as usual
    >>> qat.convert(model)                       # -> real int8 layers
    """

    def __init__(self, bits=8, quantize_inputs=True):
        self.bits = bits
        self.quantize_inputs = quantize_inputs

    def quantize(self, model):
        for name, child in list(model.named_children()):
            if isinstance(child, Linear):
                setattr(model, name, QATLinear(child, self.bits,
                                               self.quantize_inputs))
            elif isinstance(child, Conv2D):
                setattr(model, name, QATConv2D(child, self.bits,
                                               self.quantize_inputs))
            else:
                self.quantize(child)
        return model

    def convert(self, model):
        for name, child in list(model.named_children()):
            if isinstance(child, QATLinear):
                setattr(model, name,
                        QuantizedLinear(child.inner, bits=self.bits))
            elif isinstance(child, QATConv2D):
                setattr(model, name,
                        QuantizedConv2D(child.inner, bits=self.bits))
            else:
                self.convert(child)
        return model


# ---------------------------------------------------------------------------
# static inference-bundle quantization (save -> PTQ pass -> Predictor)
# ---------------------------------------------------------------------------

# weight-consuming op types and the output-channel axis of their weight
# operand (input slot 1); ref quantization_pass.py _weight_quantize_type
_QUANT_OPS = {
    "conv2d": 0,          # weight (out, in, kh, kw)
    "linear": 1,          # weight (in, out)
    "linear_nobias": 1,
    "matmul": 1,
}


def quantize_inference_model(path_prefix, out_prefix=None, bits=8,
                             min_elems=512, quantizable_op_type=None):
    """Post-training int8 pass over a ``save_inference_model`` bundle
    (ref: post_training_quantization.py:60 + the freeze pass in
    quantization_pass.py:703), file for file the JAX package's
    (``quant/__init__.py:329``): the same numpy, so the same bundle in
    gives the same bundle out.

    Weights feeding matmul-like/conv ops (input slot 1) are stored int8
    with per-output-channel scales (``q!``/``s!`` entries);
    ``load_inference_model`` rebuilds them as int8 persistables and a
    prepended ``dequantize_weight`` op. Weights also consumed by other
    ops, smaller than ``min_elems``, of fewer than 2 dims or not
    floating-point stay float32. Returns the list of quantized weight
    names. ``out_prefix`` defaults to ``path_prefix + "_int8"``."""
    op_types = dict(_QUANT_OPS)
    if quantizable_op_type is not None:
        op_types = {k: v for k, v in op_types.items()
                    if k in set(quantizable_op_type)}
    out_prefix = out_prefix or (path_prefix + "_int8")
    with open(path_prefix + ".pdmodel", "rb") as f:
        desc = pickle.load(f)
    params_path = (path_prefix + ".pdiparams.npz"
                   if os.path.exists(path_prefix + ".pdiparams.npz")
                   else path_prefix + ".pdiparams")
    data = np.load(params_path, allow_pickle=True)
    if any(k.startswith("q!") for k in data.files):
        raise ValueError(
            f"{path_prefix!r} is already an int8 bundle (contains q!/s! "
            "entries); quantize the original fp32 bundle instead")
    weights = {k[2:]: data[k] for k in data.files if k.startswith("w!")}
    consts = {k[2:]: data[k] for k in data.files if k.startswith("c!")}

    # role scan: weight name -> channel axis; conflicted/other-use -> None
    roles: dict = {}
    for type_, in_names, out_names, attrs in desc["ops"]:
        axis = op_types.get(type_)
        for slot, name in enumerate(in_names):
            if name not in weights:
                continue
            if axis is not None and slot == 1:
                roles[name] = axis if roles.get(name, axis) == axis else None
            else:
                roles[name] = None  # consumed elsewhere: keep exact

    quantized = []
    out_arrays = {}
    for name, arr in weights.items():
        axis = roles.get(name)
        if (axis is None or arr.size < min_elems or arr.ndim < 2
                or not np.issubdtype(arr.dtype, np.floating)):
            out_arrays["w!" + name] = arr
            continue
        q, s = quantize_abs_max(arr, bits=bits, channel_axis=axis)
        out_arrays["q!" + name] = q
        out_arrays["s!" + name] = s.astype(np.float32)
        quantized.append(name)

    desc = dict(desc)
    desc["quant"] = {"bits": bits, "weights": sorted(quantized)}
    d = os.path.dirname(out_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out_prefix + ".pdmodel", "wb") as f:
        pickle.dump(desc, f, protocol=4)
    np.savez(out_prefix + ".pdiparams",
             __consts__=np.array(list(consts)),
             **{("c!" + k): v for k, v in consts.items()},
             **out_arrays)
    return quantized
