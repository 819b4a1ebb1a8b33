"""MFU / goodput accounting: turn step timings into utilization numbers.

The port of ``paddle_tpu/obs/mfu.py`` (:41-342): step time, model-FLOPs
utilization (achieved FLOP/s over the card's peak) and goodput (how
much of the attempted step work advanced the model), accumulated by
``MFUAccounting`` from the run journal's step records
(``obs.journal.RunJournal.record_step``).

Peak FLOP/s is configurable (``set_peak_flops`` / env
``PADDLE_TPU_PEAK_FLOPS``) with a table of NVIDIA's dense bfloat16
tensor-core rates keyed on ``torch.cuda.get_device_name``; on the host
CPU, or a card not in the table, MFU is reported as ``None`` rather than
a made-up number.

Not ported: ``executable_flops`` and ``entry_analysis*``, which read
XLA's cost analysis of a compiled executable (they wait for an AOT
artifact with a cost model, ROADMAP Queue 1 item 8), and the
collective-bytes roofline of ``summary`` (``obs/spmd``, item 7). A step
record's ``flops`` is whatever its caller passes.
"""
from __future__ import annotations

import os

__all__ = ["PEAK_FLOPS_BY_KIND", "peak_flops", "set_peak_flops",
           "MFUAccounting", "goodput"]

# dense bfloat16 tensor-core FLOP/s of one card, from NVIDIA's H100 data
# sheet; matched in order against the device name, so the PCIe and NVL
# parts come before the SXM one ("NVIDIA H100 80GB HBM3")
PEAK_FLOPS_BY_KIND = {
    "H100 PCIe": 756e12,
    "H100 NVL": 835e12,
    "H100": 989e12,
}

_peak_override = None


def set_peak_flops(value):
    """Pin the peak FLOP/s used for MFU (``None`` reverts to
    autodetect). Env ``PADDLE_TPU_PEAK_FLOPS`` does the same per
    process."""
    global _peak_override
    _peak_override = float(value) if value is not None else None


def peak_flops():
    """Peak FLOP/s for MFU: explicit ``set_peak_flops`` wins, then env
    ``PADDLE_TPU_PEAK_FLOPS``, then the table keyed on the name of CUDA
    device 0. ``None`` when nothing is known (the host CPU, a card not in
    the table), or when this process has not initialised CUDA: the
    journal calls this at exit, which must not start a CUDA context as a
    side effect."""
    if _peak_override is not None:
        return _peak_override
    env = os.environ.get("PADDLE_TPU_PEAK_FLOPS", "")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    import torch

    if not torch.cuda.is_initialized():
        return None
    kind = torch.cuda.get_device_name(0)
    for k, v in PEAK_FLOPS_BY_KIND.items():
        if k.lower() in kind.lower():
            return v
    return None


def goodput(productive, skipped=0, retried=0):
    """Fraction of attempted step work that advanced the model:
    ``productive / (productive + skipped + retried)``. Skipped steps
    (nonfinite discard/rollback) and transient retries both burned a
    step's wall time without contributing. ``None`` with no steps."""
    total = productive + skipped + retried
    if total <= 0:
        return None
    return productive / float(total)


class MFUAccounting:
    """Accumulates per-step (step_ms, flops, examples) and renders the
    run-level summary: achieved FLOP/s, MFU vs the configured peak, and
    goodput from productive/skipped/retried counts."""

    def __init__(self, peak=None):
        self._peak = peak
        self.productive = 0
        self.skipped = 0
        self.retried = 0
        self._timed_ms = 0.0
        self._timed_steps = 0
        self._flop_ms = 0.0   # step_ms summed only where flops known
        self._flops = 0.0
        self._examples = 0

    def record(self, step_ms=None, flops=None, examples=None,
               productive=True, weight=1):
        """``weight`` is the number of optimizer steps this record
        covers — 1 normally, K for a fused window (whose
        step_ms/flops/examples already describe the whole window, so only
        the step COUNTS need the weight)."""
        weight = max(1, int(weight))
        if productive:
            self.productive += weight
        else:
            self.skipped += weight
        if step_ms is not None and step_ms > 0:
            self._timed_ms += step_ms
            self._timed_steps += 1
            if flops:
                self._flops += float(flops)
                self._flop_ms += step_ms
        if examples:
            self._examples += int(examples)

    def note_retry(self, n=1):
        self.retried += n

    def summary(self):
        peak = self._peak if self._peak is not None else peak_flops()
        achieved = (self._flops / (self._flop_ms / 1e3)
                    if self._flop_ms > 0 else None)
        out = {
            "productive_steps": self.productive,
            "skipped_steps": self.skipped,
            "retries": self.retried,
            "goodput": goodput(self.productive, self.skipped, self.retried),
            "mean_step_ms": (self._timed_ms / self._timed_steps
                             if self._timed_steps else None),
            "achieved_flops_per_s": achieved,
            "peak_flops_per_s": peak,
            "mfu": (achieved / peak if achieved and peak else None),
        }
        if self._examples and self._timed_ms > 0:
            out["examples_per_s"] = self._examples / (self._timed_ms / 1e3)
        return out
