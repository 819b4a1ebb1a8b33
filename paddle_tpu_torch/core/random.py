"""Global random state: one ``torch.Generator`` per device.

The counterpart of ``paddle_tpu/core/random.py``. The JAX package keeps
one root key and splits it; here every device has its own explicit
generator, seeded from the one global seed, and every stochastic op of
the package (initializers, dropout) draws from the generator of the
device its tensor lives on unless the caller hands it another. The two
packages give different numbers from the same seed: tests carry weights
across and run dropout-free, or compare distributions.
"""
from __future__ import annotations

import torch

from .._device import resolve_device

__all__ = ["seed", "global_seed", "default_generator"]

_STATE = {"seed": 0, "generators": {}}


def seed(s: int) -> None:
    """Set the global seed and restart every device's generator from it."""
    _STATE["seed"] = int(s)
    for g in _STATE["generators"].values():
        g.manual_seed(_STATE["seed"])


def global_seed():
    """The global seed: ``seed``'s last argument, 0 before any call."""
    return _STATE["seed"]


def default_generator(device=None):
    """The generator of ``device`` (``cuda`` unless the caller asks for
    ``"cpu"``; raises without a card), made (from the global seed) at
    first use."""
    dev = resolve_device(device)
    gens = _STATE["generators"]
    if dev not in gens:
        gens[dev] = torch.Generator(device=dev)
        gens[dev].manual_seed(_STATE["seed"])
    return gens[dev]
