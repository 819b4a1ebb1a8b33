"""Device resolution for the package's entry points.

Every entry point (``PagedKVCache``, ``TinyLM``) runs on the CUDA card
unless its caller passes ``device="cpu"``. Without a CUDA device, a
request for anything but the CPU raises: the package never falls back
to the CPU on its own, so a run that meant to use the card cannot
quietly measure the host instead.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "resolve_dtype", "as_ids"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def resolve_device(device=None):
    """``None`` -> ``cuda``; ``"cpu"`` only when asked for. Raises
    ``RuntimeError`` for a CUDA device when none is present."""
    dev = torch.device("cuda" if device is None else device)
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
