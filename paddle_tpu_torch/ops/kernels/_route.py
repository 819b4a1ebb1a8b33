"""Which version of a kernel a wrapper runs.

A wrapper runs its kernel's plain PyTorch version for a tensor on the
CPU, and inside ``plain_versions()``; otherwise, on a CUDA tensor, it
launches its kernel or raises. ``plain_versions()`` is only ever entered
on purpose: ``chip_smoke.py`` and the tests use it to run the same path
through the plain versions on the card and hold the two runs against
each other. Nothing chooses it automatically.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["plain_versions", "forced", "plain", "require_cuda"]

_state = threading.local()


@contextlib.contextmanager
def plain_versions():
    """Inside this context (in this thread) every kernel wrapper runs its
    plain PyTorch version, on any device, and counts no launch. A
    ``torch.autograd.Function`` keeps the choice its forward made for
    its backward, which autograd may run in another thread."""
    depth = getattr(_state, "depth", 0)
    _state.depth = depth + 1
    try:
        yield
    finally:
        _state.depth = depth


def forced():
    """True inside ``plain_versions()`` (in this thread)."""
    return getattr(_state, "depth", 0) > 0


def plain(t):
    """True when a wrapper given tensor ``t`` runs the plain version."""
    return t.device.type == "cpu" or forced()


def require_cuda(t, what):
    """Raise ``ValueError`` unless ``t`` lies on a CUDA device: past
    ``plain()``, a wrapper launches its kernel or raises."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
