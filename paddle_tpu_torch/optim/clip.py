"""Gradient clipping: ``ClipGradByGlobalNorm``.

The counterpart of ``paddle_tpu/optim/clip.py``'s (:52-71), with
Paddle's scale ``clip_norm / max(global_norm, clip_norm)`` — not
``torch.nn.utils.clip_grad_norm_``'s ``clip / (norm + 1e-6)``. The norm
is taken in float32 over every gradient whose parameter does not set
``need_clip = False``; it stays on the device (no host sync).
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


def _clipped(p):
    return getattr(p, "need_clip", True)


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        """``[(param, grad)] -> [(param, clipped grad)]``."""
        sq = [torch.sum(torch.square(g.float())) for p, g in params_grads
              if g is not None and _clipped(p)]
        if not sq:
            return params_grads
        global_norm = torch.sqrt(torch.stack(sq).sum())
        scale = self.clip_norm / torch.clamp_min(global_norm, self.clip_norm)
        return [(p, g if g is None or not _clipped(p)
                 else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]
