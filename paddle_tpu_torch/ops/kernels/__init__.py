"""The package's hand-written Hopper kernels.

Each kernel module holds the wrapper (which launches the kernel on CUDA
tensors and counts its launches in ``<wrapper>.launches``), the plain
PyTorch version the wrapper uses for CPU tensors (and inside
``plain_versions()``), and ``SOURCE``: the kernel's source in the repo.
Each wrapper's ``.replaces`` is the ``file:line`` of the Pallas kernel
it replaces. ``KERNELS`` maps each kernel's name — its wrapper's name —
to its module.
"""
from . import flash_attention, layernorm, paged_attention, softmax_ce
from ._route import plain_versions
from .flash_attention import (flash_attention_bwd_dkv,
                              flash_attention_bwd_dq, flash_attention_fwd)
from .layernorm import fused_layer_norm, layer_norm_bwd, layer_norm_fwd
from .paged_attention import (dense_decode_reference,
                              paged_decode_attention,
                              paged_decode_attention_reference)
from .softmax_ce import (softmax_ce_bwd, softmax_ce_fwd,
                         softmax_cross_entropy)

KERNELS = {"paged_decode_attention": paged_attention,
           "layer_norm_fwd": layernorm, "layer_norm_bwd": layernorm,
           "softmax_ce_fwd": softmax_ce, "softmax_ce_bwd": softmax_ce,
           "flash_attention_fwd": flash_attention,
           "flash_attention_bwd_dq": flash_attention,
           "flash_attention_bwd_dkv": flash_attention}


def reset_launches():
    """Set every kernel's launch count to 0."""
    for name, module in KERNELS.items():
        getattr(module, name).launches = 0


def launches():
    """``{kernel name: launches since the last reset}``."""
    return {name: getattr(module, name).launches
            for name, module in KERNELS.items()}


__all__ = ["KERNELS", "reset_launches", "launches", "plain_versions",
           "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv",
           "paged_decode_attention", "paged_decode_attention_reference",
           "dense_decode_reference", "layer_norm_fwd", "layer_norm_bwd",
           "fused_layer_norm", "softmax_ce_fwd", "softmax_ce_bwd",
           "softmax_cross_entropy"]
