"""NaN/Inf detection: ``NanInfError``, ``nonfinite_summary``,
``check_numerics`` (the port's copy of ``paddle_tpu/utils/nan_guard.py``).

The fused-step mode is the one the port runs: ``TrainStep(check_nan=True)``
computes a found-nonfinite flag on the device (loss and gradients) and
raises ``NanInfError`` on the host after the step, carrying the loss's
``nonfinite_summary`` when the loss itself is non-finite.

The reference's eager per-op mode (``enable_check_nan``,
``disable_check_nan``, ``check_nan_enabled``) is not here: its only
reader is the op dispatch hook, which waits with ``nan_op`` (ROADMAP
Queue 1 item 7).

Values are torch tensors (any device; one host copy each), numpy arrays
or Python numbers.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["check_numerics", "NanInfError", "nonfinite_summary"]


class NanInfError(FloatingPointError):
    """Nonfinite value detected. ``summary`` (also attached as an
    attribute) carries the bounded postmortem record built by
    ``nonfinite_summary``: counts, first bad flat index, finite range —
    the producing values are gone by the time the error unwinds, so this
    is what makes the report actionable."""

    def __init__(self, msg, summary=None):
        super().__init__(msg)
        self.summary = dict(summary or {})


def _host(value):
    """``(numpy array, dtype name)`` of ``value``: a tensor's name is its
    torch dtype's (``float32``, ``bfloat16``), read before a bfloat16
    tensor is widened to float32 for numpy."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        dtype = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy(), dtype
    a = np.asarray(value)
    return a, str(a.dtype)


def nonfinite_summary(value):
    """Bounded description of the nonfinite content of one array: counts,
    the first bad flat index, and the finite min/max — O(n) scan, O(1)
    output, so it is safe to compute on any tensor at fault time."""
    a, dtype = _host(value)  # ONE device->host transfer
    if a.dtype.kind != "f":
        a = a.astype(np.float64)
    bad = ~np.isfinite(a)
    n_bad = int(bad.sum())
    finite = a[~bad]
    return {
        "shape": tuple(a.shape),
        "dtype": dtype,
        "num_nan": int(np.isnan(a).sum()),
        "num_inf": int(np.isinf(a).sum()),
        "first_bad_index": int(np.argmax(bad.ravel())) if n_bad else -1,
        "finite_min": float(finite.min()) if finite.size else None,
        "finite_max": float(finite.max()) if finite.size else None,
    }


def _summary_text(s):
    return (f"nan={s['num_nan']} inf={s['num_inf']} "
            f"first_bad_flat_index={s['first_bad_index']} "
            f"finite_range=[{s['finite_min']}, {s['finite_max']}]")


def _bad(v):
    if isinstance(v, torch.Tensor):
        return v.is_floating_point() and not bool(torch.isfinite(v).all())
    a = np.asarray(v)
    return np.issubdtype(a.dtype, np.inexact) and \
        not bool(np.isfinite(a).all())


def check_numerics(value, name="tensor"):
    """Raise NanInfError if any leaf of ``value`` holds NaN/Inf.

    Accepts tensors, arrays, or nested lists/tuples/dicts of them.
    """
    def walk(v, path):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(x, f"{path}.{k}")
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(x, f"{path}[{i}]")
        elif hasattr(v, "dtype"):
            if _bad(v):
                s = nonfinite_summary(v)
                raise NanInfError(
                    f"NaN/Inf found in {path}: shape={tuple(v.shape)} "
                    f"{_summary_text(s)}", summary=s)

    walk(value, name)
    return value
