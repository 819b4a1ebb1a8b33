"""The package's hand-written Hopper kernels.

Each kernel module holds the wrapper (which launches the kernel on CUDA
tensors and counts its launches in ``<wrapper>.launches``), the plain
PyTorch version the wrapper uses for CPU tensors, and ``SOURCE`` /
``REPLACES``: the kernel's source in the repo and the Pallas kernel it
replaces. ``KERNELS`` maps each kernel's name to its module.
"""
from . import paged_attention
from .paged_attention import (dense_decode_reference,
                              paged_decode_attention,
                              paged_decode_attention_reference)

KERNELS = {"paged_decode_attention": paged_attention}


def reset_launches():
    """Set every kernel's launch count to 0."""
    for name, module in KERNELS.items():
        getattr(module, name).launches = 0


def launches():
    """``{kernel name: launches since the last reset}``."""
    return {name: getattr(module, name).launches
            for name, module in KERNELS.items()}


__all__ = ["KERNELS", "reset_launches", "launches",
           "paged_decode_attention", "paged_decode_attention_reference",
           "dense_decode_reference"]
