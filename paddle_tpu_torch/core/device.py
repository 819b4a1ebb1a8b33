"""Places and the current device: the counterpart of
``paddle_tpu/core/device.py:14-96``.

A ``Place`` names a device as Paddle does, ``gpu:<n>`` or ``cpu:0``;
``torch_device`` is the torch device it stands for. ``set_device``
chooses the place every entry point given no ``device`` runs on
(``_device.resolve_device(None)``): ``"gpu"``, ``"gpu:0"``, ``"cuda"``
and ``"tpu"`` (as scripts written for the JAX package pick the
accelerator) name the card, ``"cpu"`` the host, which counts as the
caller asking for the CPU. Without a card, a request for it raises at
once; nothing falls back to the CPU. The default place stays the card.
``torch.set_default_device`` is never touched: the choice is this
package's own.

``TPUPlace`` and ``CUDAPlace`` both name the card (the JAX package's
``CUDAPlace`` is its ``TPUPlace``, ``:50-51``); ``device_count`` counts
cards, and ``is_compiled_with_tpu`` says whether there is one, the
accelerator a script asking it means. ``set_compilation_cache`` waits
for the AOT cache (ROADMAP Queue 1, item 8).
"""
from __future__ import annotations

import torch

from .. import _device

__all__ = ["Place", "TPUPlace", "CPUPlace", "CUDAPlace", "set_device",
           "get_device", "current_place", "device_count",
           "is_compiled_with_tpu"]


class Place:
    """A device placement (ref: ``platform::Place``): ``kind`` is
    ``"gpu"`` or ``"cpu"``."""

    def __init__(self, kind: str, index: int = 0):
        self.kind = kind
        self.index = index

    def __repr__(self):
        return f"Place({self.kind}:{self.index})"

    def __eq__(self, other):
        return (isinstance(other, Place) and self.kind == other.kind
                and self.index == other.index)

    def __hash__(self):
        return hash((self.kind, self.index))

    @property
    def torch_device(self):
        if self.kind == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.index)


def TPUPlace(index: int = 0) -> Place:
    return Place("gpu", index)


def CUDAPlace(index: int = 0) -> Place:
    return Place("gpu", index)


def CPUPlace(index: int = 0) -> Place:
    return Place("cpu", 0)


def _place(device) -> Place:
    if isinstance(device, Place):
        return device
    try:
        dev = _device.torch_device(device)
    except RuntimeError:
        raise ValueError(f"unsupported device {device!r} (gpu, tpu or "
                         "cpu)") from None
    if dev.type == "cpu":
        return Place("cpu", 0)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (gpu, tpu or cpu)")
    return Place("gpu", 0 if dev.index is None else dev.index)


def set_device(device) -> Place:
    """Make ``device`` (a ``Place``, a torch device or a string:
    ``"gpu"``, ``"gpu:1"``, ``"cuda"``, ``"tpu"``, ``"cpu"``) the current
    place and return it. A card that is not there raises
    ``RuntimeError``."""
    place = _place(device)
    if place.kind == "gpu":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if place.index >= n:
            raise RuntimeError(
                f"no CUDA device {place.index} ({n} present); "
                "set_device('cpu') runs on the host")
    _device.CURRENT[0] = place.torch_device
    return place


def current_place() -> Place:
    """The current place: the card (its current index) unless
    ``set_device`` chose another."""
    dev = _device.CURRENT[0]
    if dev is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() \
            else 0
        return Place("gpu", index)
    return _place(dev)


def get_device() -> str:
    """The current place as a string, ``"gpu:0"`` or ``"cpu:0"``."""
    p = current_place()
    return f"{p.kind}:{p.index}"


def device_count(kind: str = None) -> int:
    """The number of cards (``kind="cpu"``: 1, the host)."""
    if kind == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_compiled_with_tpu() -> bool:
    """Whether the accelerator is there: a CUDA card."""
    return torch.cuda.is_available()
