"""Gradient clipping: ``ClipGradByValue``, ``ClipGradByNorm`` and
``ClipGradByGlobalNorm``.

The counterparts of ``paddle_tpu/optim/clip.py``'s (:21-71): a clamp of
each gradient to ``[min, max]``; each gradient scaled by ``min(clip_norm
/ max(norm, 1e-12), 1)`` with its own norm; and every gradient scaled by
Paddle's ``clip_norm / max(global_norm, clip_norm)`` — not
``torch.nn.utils.clip_grad_norm_``'s ``clip / (norm + 1e-6)``. Norms are
taken in float32 and skip every gradient whose parameter sets
``need_clip = False``; everything stays on the device (no host sync), so
a clip can run inside a captured step.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


def _clipped(p):
    return getattr(p, "need_clip", True)


class ClipGradByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        """``[(param, grad)] -> [(param, clipped grad)]``."""
        return [(p, g if g is None or not _clipped(p)
                 else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        """``[(param, grad)] -> [(param, clipped grad)]``."""
        out = []
        for p, g in params_grads:
            if g is None or not _clipped(p):
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g.float())))
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(norm, 1e-12), 1.0)
            out.append((p, (g.float() * scale).to(g.dtype)))
        return out


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
