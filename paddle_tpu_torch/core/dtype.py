"""Dtype names: the counterpart of ``paddle_tpu/core/dtype.py``.

Paddle's dtype names are torch's dtypes here (``pt.float32 is
torch.float32``), with ``bool_`` for ``torch.bool`` and the reference's
aliases (``"float"``, ``"fp16"``, ``"long"``, ...). Two names differ
from the JAX package, which folds the 64-bit types into 32-bit ones for
lack of a TPU unit (``core/dtype.py:46-50``): here ``int64`` stays
int64 (Paddle's index type, as the port's indices are) and ``float64``
stays float64, which the card computes. Data without a type of its own
follows the JAX package all the same: a Python int is int64, a Python
float and a float64 array take the default dtype when they become a
tensor (``core.tensor.to_tensor``).

The default dtype (``set_default_dtype``, float32 to start) is this
package's own setting, read by ``convert_dtype(None)``: the tensor
makers and ``nn.create_parameter`` without a layer. It never touches
``torch.set_default_dtype``, whose state other torch code in the
process shares.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["float16", "bfloat16", "float32", "float64", "int8", "int16",
           "int32", "int64", "uint8", "bool_", "complex64", "complex128",
           "set_default_dtype", "get_default_dtype", "convert_dtype",
           "dtype_name", "is_floating", "is_integer"]

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_NAMES = {"float16": float16, "bfloat16": bfloat16, "float32": float32,
          "float64": float64, "int8": int8, "int16": int16, "int32": int32,
          "int64": int64, "uint8": uint8, "bool": bool_,
          "complex64": complex64, "complex128": complex128}

_ALIASES = {"float": "float32", "double": "float64", "half": "float16",
            "int": "int32", "long": "int64", "bf16": "bfloat16",
            "fp16": "float16", "fp32": "float32", "fp64": "float64"}

_DEFAULT = [torch.float32]


def convert_dtype(d):
    """Any dtype spec (a name or alias, a torch or numpy dtype, the
    Python types; ``None``: the default dtype) as a torch dtype."""
    if d is None:
        return _DEFAULT[0]
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        name = _ALIASES.get(d, d)
        if name not in _NAMES:
            raise ValueError(f"unknown dtype {d!r}")
        return _NAMES[name]
    if d is float:
        return _DEFAULT[0]
    if d is int:
        return torch.int64
    if d is bool:
        return torch.bool
    return convert_dtype(np.dtype(d).name)


def dtype_name(d) -> str:
    """``"float32"`` for any spec of float32."""
    return str(convert_dtype(d)).replace("torch.", "")


def set_default_dtype(d):
    """The dtype ``convert_dtype(None)`` gives from now on."""
    _DEFAULT[0] = convert_dtype(d)


def get_default_dtype():
    """The default dtype's name (``"float32"``)."""
    return dtype_name(_DEFAULT[0])


def is_floating(d) -> bool:
    return convert_dtype(d).is_floating_point


def is_integer(d) -> bool:
    dt = convert_dtype(d)
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)
