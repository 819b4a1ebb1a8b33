"""``dequantize_weight``, the counterpart of ``paddle_tpu/ops/misc.py``'s
(``:579-587``): an int8 inference bundle's weight as its consumer reads
it (``framework.io.load_inference_model`` prepends one such op for each
int8 weight).

The JAX package computes it in jnp, outside any Pallas kernel, and
leaves XLA to fuse the multiply into the consuming matmul or conv; here
it is PyTorch's cast and multiply, which write the weight's float copy
before the consumer reads it (PERF.md §7: the port's int8 path moves no
fewer weight bytes than the float32 one)."""
from __future__ import annotations

import torch

from ._base import register

__all__ = ["dequantize_weight"]


def torch_dtype(name):
    """A dtype's name (``"float32"``) or a torch dtype -> the torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@register("dequantize_weight", inputs=("q", "s"))
def dequantize_weight(q, s, *, dtype="float32"):
    """``q`` (int8) times its scales ``s``, both in ``dtype``."""
    dt = torch_dtype(dtype)
    return q.to(dt) * s.to(dt)
