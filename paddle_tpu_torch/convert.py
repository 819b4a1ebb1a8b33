"""Carry weights from the JAX package's models into this package's.

The JAX side hands its arrays over as numpy (``np.asarray`` of each),
so this module never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["tinylm_params_from_jax"]

_TINYLM = ("embedding", "wq", "wk", "wv", "wo")


def tinylm_params_from_jax(params):
    """The JAX ``TinyLM``'s arrays — a dict of numpy arrays under
    ``embedding`` ``(V, E)`` and ``wq``/``wk``/``wv``/``wo`` ``(E, E)``,
    the names of its attributes — as a state dict for the port's
    ``TinyLM`` (float32 CPU tensors; ``load_state_dict`` moves them to
    the model's device). Raises ``ValueError`` on a missing or extra
    name or an inconsistent shape."""
    if set(params) != set(_TINYLM):
        raise ValueError(f"expected arrays {sorted(_TINYLM)}, got "
                         f"{sorted(params)}")
    arrs = {k: np.asarray(params[k], np.float32) for k in _TINYLM}
    V, E = arrs["embedding"].shape
    for k in _TINYLM[1:]:
        if arrs[k].shape != (E, E):
            raise ValueError(f"{k} has shape {arrs[k].shape}, expected "
                             f"({E}, {E}) for embed dim {E}")
    return {k: torch.from_numpy(a.copy()) for k, a in arrs.items()}
