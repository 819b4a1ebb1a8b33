"""Device resolution for the package's entry points.

Every entry point (``PagedKVCache``, ``TinyLM``) runs on the current
place: the CUDA card, unless its caller passes ``device="cpu"`` or
chose the CPU with ``core.device.set_device("cpu")``. Without a CUDA
device, a request for anything but the CPU raises: the package never
falls back to the CPU on its own, so a run that meant to use the card
cannot quietly measure the host instead. Besides torch's names, a
device may be spelt as Paddle spells it: ``"gpu"``, ``"gpu:1"``,
``"tpu"`` (the accelerator, as scripts written for the JAX package pick
it) or a ``core.device.Place``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "resolve_dtype", "as_ids", "torch_device"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# the current place (``core.device.set_device``): a torch device, or None
# for the card
CURRENT = [None]

# Paddle's names for the accelerator
_ACCELERATORS = ("gpu", "cuda", "tpu", "xpu")


def torch_device(device):
    """A device as torch names it: a ``Place`` (``.torch_device``), a
    torch device, or a string in torch's or Paddle's spelling
    (``"gpu:0"`` and ``"tpu"`` are ``cuda``)."""
    if hasattr(device, "torch_device"):
        return device.torch_device
    if isinstance(device, str):
        name, sep, idx = device.partition(":")
        if name in _ACCELERATORS:
            return torch.device("cuda", int(idx)) if sep else \
                torch.device("cuda")
    return torch.device(device)


def resolve_device(device=None):
    """``None`` -> the current place (the card unless
    ``set_device("cpu")``); ``"cpu"`` only when asked for. Raises
    ``RuntimeError`` for a CUDA device when none is present."""
    if device is None:
        device = CURRENT[0]
    dev = torch.device("cuda") if device is None else torch_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host")
        if dev.index is None:   # "cuda" and "cuda:0" name one device
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!r} (cuda or cpu)")
    return dev


def resolve_dtype(dtype):
    """``"float32"``/``"bfloat16"``/``"float16"`` -> the torch dtype."""
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r} "
                         f"(one of {sorted(_DTYPES)})") from None


def as_ids(ids, device):
    """Token ids (a tensor, numpy array or nested list) as an int64 tensor
    on ``device``: the decoding entry points' inputs."""
    if isinstance(ids, torch.Tensor):
        return ids.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(ids), dtype=torch.int64, device=device)
