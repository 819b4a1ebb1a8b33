"""Stateful anomaly detectors over the run journal's step stream.

Each detector sees every step record (a plain dict, see
``obs.journal.RunJournal.record_step``) and decides whether this run is
going sideways — the automatic "page someone" signal operations
playbooks keep in scattered log-scraping. Firing is cheap
and host-side only: rolling windows of floats, no device work.

A fired anomaly becomes three things (wired by ``AnomalyEngine``):

- an ``obs`` counter tick under ``anomaly.<name>``,
- a journal ``anomaly`` record, and
- an optional user callback (e.g. to flip a ``resilience.RecoveryPolicy``
  to a more conservative mode, or to trigger an early checkpoint).

Detectors re-arm per streak: a 50-step plateau fires once, not 50 times.

The port's journal records no training steps yet; the fleet uses the
serving detectors through ``obs.slo``.

Thresholds are constructor kwargs; env ``PADDLE_TPU_ANOMALY`` overrides
them process-wide with the chaos-spec grammar
(``"loss_spike:factor=10;throughput_drop:factor=3"``, or ``"off"`` to
disable every detector the journal would otherwise install).
"""
from __future__ import annotations

import math
import os
from collections import deque

from . import metrics as _metrics

__all__ = [
    "Detector", "LossSpike", "LossPlateau", "NonfiniteStreak",
    "ThroughputDrop", "DataloaderStarvation", "TtftSpike",
    "TenantHog", "AnomalyEngine", "default_detectors",
    "serving_detectors", "DETECTORS", "SERVING_DETECTORS",
]


def _finite(v):
    return v is not None and isinstance(v, (int, float)) \
        and math.isfinite(v)


def _median(values):
    s = sorted(values)
    n = len(s)
    if not n:
        return None
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class Detector:
    """One stateful check; ``update(record)`` returns a detail dict when
    the anomaly fires (``None`` otherwise)."""

    name = "detector"

    def update(self, rec):  # pragma: no cover - overridden
        return None


class LossSpike(Detector):
    """Loss jumps far above its rolling median: fired when
    ``loss > median + factor * max(MAD, floor)`` over the last
    ``window`` finite losses (MAD = median absolute deviation, so a
    noisy-but-stable loss doesn't false-positive)."""

    name = "loss_spike"

    def __init__(self, window=32, factor=8.0, min_steps=5):
        self.window = int(window)
        self.factor = float(factor)
        self.min_steps = int(min_steps)
        self._losses = deque(maxlen=self.window)
        self._armed = True

    def update(self, rec):
        loss = rec.get("loss")
        if not _finite(loss):
            return None
        fired = None
        if len(self._losses) >= self.min_steps:
            med = _median(self._losses)
            mad = _median([abs(v - med) for v in self._losses])
            floor = 1e-3 * max(1.0, abs(med))
            threshold = med + self.factor * max(mad, floor)
            if loss > threshold:
                if self._armed:  # once per excursion, not per step
                    self._armed = False
                    fired = {"loss": loss, "median": med,
                             "threshold": threshold}
            else:
                self._armed = True
        self._losses.append(loss)
        return fired


class LossPlateau(Detector):
    """No meaningful improvement for a full window: the best loss in
    the last ``window`` steps failed to improve on the best before the
    window by ``rel_eps`` (relative). Fires once per plateau."""

    name = "loss_plateau"

    def __init__(self, window=50, rel_eps=1e-3):
        self.window = int(window)
        self.rel_eps = float(rel_eps)
        self._recent = deque(maxlen=self.window)
        self._best_before = None
        self._armed = True

    def update(self, rec):
        loss = rec.get("loss")
        if not _finite(loss):
            return None
        if len(self._recent) == self.window:
            leaving = self._recent[0]
            self._best_before = leaving if self._best_before is None \
                else min(self._best_before, leaving)
        self._recent.append(loss)
        if self._best_before is None or len(self._recent) < self.window:
            return None
        best_recent = min(self._recent)
        margin = self.rel_eps * max(abs(self._best_before), 1e-12)
        if best_recent > self._best_before - margin:
            if self._armed:
                self._armed = False
                return {"best_before": self._best_before,
                        "best_recent": best_recent,
                        "window": self.window}
            return None
        self._armed = True
        return None


class NonfiniteStreak(Detector):
    """``threshold`` consecutive steps that were nonfinite (skipped /
    rolled back / NaN loss). Fires once per streak — the signal that a
    skip policy has stopped recovering and is just discarding work."""

    name = "nonfinite_streak"

    def __init__(self, threshold=3):
        self.threshold = int(threshold)
        self._streak = 0

    def update(self, rec):
        loss = rec.get("loss")
        bad = rec.get("nonfinite") or rec.get("skipped") or \
            (loss is not None and isinstance(loss, float)
             and not math.isfinite(loss))
        if not bad:
            self._streak = 0
            return None
        self._streak += 1
        if self._streak == self.threshold:
            return {"streak": self._streak}
        return None


class ThroughputDrop(Detector):
    """Step time degrades to ``factor`` x its rolling median (same
    windowing as LossSpike, on ``step_ms``)."""

    name = "throughput_drop"

    def __init__(self, window=32, factor=2.5, min_steps=8):
        self.window = int(window)
        self.factor = float(factor)
        self.min_steps = int(min_steps)
        self._times = deque(maxlen=self.window)
        self._armed = True

    def update(self, rec):
        ms = rec.get("step_ms")
        if not _finite(ms) or ms <= 0:
            return None
        fired = None
        if len(self._times) >= self.min_steps:
            med = _median(self._times)
            if med and ms > self.factor * med:
                if self._armed:  # once per slowdown, not per slow step
                    self._armed = False
                    fired = {"step_ms": ms, "median_ms": med}
            else:
                self._armed = True
        self._times.append(ms)
        return fired


class DataloaderStarvation(Detector):
    """The train loop spent more than ``ratio`` of a step waiting on
    input (per-step consumer-wait delta vs step time, both host-side
    numbers the journal already carries) — the input pipeline, not the
    device, is the bottleneck."""

    name = "dataloader_starvation"

    def __init__(self, ratio=0.5, min_wait_ms=1.0, min_steps=3):
        self.ratio = float(ratio)
        self.min_wait_ms = float(min_wait_ms)
        self.min_steps = int(min_steps)
        self._seen = 0
        self._armed = True

    def update(self, rec):
        ms, wait = rec.get("step_ms"), rec.get("dl_wait_ms")
        if not _finite(ms) or not _finite(wait) or ms <= 0:
            return None
        self._seen += 1
        if self._seen < self.min_steps:
            return None
        if wait >= self.min_wait_ms and wait / ms > self.ratio:
            if self._armed:  # once per starvation episode
                self._armed = False
                return {"dl_wait_ms": wait, "step_ms": ms,
                        "ratio": wait / ms}
            return None
        self._armed = True
        return None


class TtftSpike(Detector):
    """The serve path's LossSpike: windowed TTFT p99 (ms, from
    ``obs.timeseries`` via the SLO evaluator's tick record) jumps
    above ``median + factor * max(MAD, floor)`` over the last
    ``window`` observations. Same once-per-excursion re-arm as the
    training detectors — a sustained latency excursion fires once,
    recovery re-arms it."""

    name = "ttft_spike"

    def __init__(self, window=32, factor=6.0, min_steps=5,
                 floor_ms=0.5):
        self.window = int(window)
        self.factor = float(factor)
        self.min_steps = int(min_steps)
        self.floor_ms = float(floor_ms)
        self._values = deque(maxlen=self.window)
        self._armed = True

    def update(self, rec):
        v = rec.get("ttft_ms")
        if not _finite(v) or v < 0:
            return None
        fired = None
        if len(self._values) >= self.min_steps:
            med = _median(self._values)
            mad = _median([abs(x - med) for x in self._values])
            threshold = med + self.factor * max(mad, self.floor_ms)
            if v > threshold:
                if self._armed:  # once per excursion, not per tick
                    self._armed = False
                    fired = {"ttft_ms": v, "median_ms": med,
                             "threshold_ms": threshold}
            else:
                self._armed = True
        self._values.append(v)
        return fired


class TenantHog(Detector):
    """One tenant's measured served-token share runs ``margin`` above
    its configured weight share for ``patience`` consecutive
    observations — a tenant is eating more of the fleet than its
    weight entitles it to, persistently (transient overshoot right
    after a burst is normal for a work-conserving scheduler; the
    streak filters it). Reads the ``tenant_shares`` field
    (``{tenant: {share, weight_share}}``) the router folds into its
    throttled SLO tick record via ``obs.usage.fairness_record``.
    Same once-per-episode discipline as StragglerDetector: fires when
    the SAME tenant holds the worst overshoot for ``patience``
    straight ticks; the overshoot dropping under ``margin`` (or the
    hog changing) resets the streak and re-arms."""

    name = "tenant_hog"

    def __init__(self, margin=0.2, patience=3, min_served=32):
        self.margin = float(margin)
        self.patience = max(1, int(patience))
        self.min_served = int(min_served)
        self._tenant = None
        self._streak = 0

    def update(self, rec):
        shares = rec.get("tenant_shares")
        if not isinstance(shares, dict) or len(shares) < 2:
            return None
        served = rec.get("tenant_served_total")
        if _finite(served) and served < self.min_served:
            return None  # too few tokens for a share to mean anything
        worst, over = None, 0.0
        for tenant, d in shares.items():
            share, wshare = d.get("share"), d.get("weight_share")
            if not _finite(share) or not _finite(wshare):
                continue
            o = share - wshare
            if worst is None or o > over:
                worst, over = tenant, o
        if worst is None or over < self.margin:
            self._tenant, self._streak = None, 0
            return None
        if worst != self._tenant:
            self._tenant = worst
            self._streak = 0
        self._streak += 1
        if self._streak == self.patience:  # once per episode
            d = shares[worst]
            return {"tenant": worst, "share": d.get("share"),
                    "weight_share": d.get("weight_share"),
                    "over": over, "streak": self._streak}
        return None


DETECTORS = {cls.name: cls for cls in
             (LossSpike, LossPlateau, NonfiniteStreak, ThroughputDrop,
              DataloaderStarvation, TtftSpike, TenantHog)}

# the serve-path subset: ttft_spike reads the windowed TTFT p99,
# throughput_drop reads the per-token latency implied by the windowed
# token rate (both fed by obs.slo.SLOEvaluator's tick record), so the
# detectors see serving signals and not only training step records;
# tenant_hog reads the per-tenant share fields the router folds into
# the same tick (obs.usage.fairness_record).
SERVING_DETECTORS = ("ttft_spike", "throughput_drop", "tenant_hog")


def serving_detectors(env=None):
    """The serving detector set (``ttft_spike`` + ``throughput_drop``)
    with thresholds overridden by the same ``PADDLE_TPU_ANOMALY`` spec
    grammar ``default_detectors`` honors (non-serving names in the
    spec are ignored here, not errors — one env var configures both
    engines); ``"off"`` returns no detectors."""
    from ..utils.envspec import parse_spec

    spec = env if env is not None \
        else os.environ.get("PADDLE_TPU_ANOMALY", "")
    if spec.strip().lower() in ("off", "0", "false", "none"):
        return []
    overrides = {}
    for name, cfg in parse_spec(spec):
        if name in SERVING_DETECTORS:
            overrides[name] = cfg
    return [DETECTORS[name](**overrides.get(name, {}))
            for name in SERVING_DETECTORS]


def default_detectors(env=None):
    """One instance of every detector, with thresholds overridden by
    the ``PADDLE_TPU_ANOMALY`` spec (the shared
    ``utils.envspec`` grammar ``"name:key=val,key=val;name2"``, same as
    ``PADDLE_TPU_CHAOS``; ``"off"`` returns no detectors)."""
    from ..utils.envspec import parse_spec

    spec = env if env is not None \
        else os.environ.get("PADDLE_TPU_ANOMALY", "")
    if spec.strip().lower() in ("off", "0", "false", "none"):
        return []
    overrides = {}
    for name, cfg in parse_spec(spec):
        if name not in DETECTORS:
            raise KeyError(
                f"PADDLE_TPU_ANOMALY names unknown detector '{name}' "
                f"(registered: {sorted(DETECTORS)})")
        overrides[name] = cfg
    return [cls(**overrides.get(name, {}))
            for name, cls in DETECTORS.items()]


class AnomalyEngine:
    """Fans one step record out to every detector; a firing ticks
    ``anomaly.<name>`` in the metrics registry, is returned to the
    caller (the journal records it), and reaches each registered
    callback — exceptions in callbacks are swallowed so a buggy
    reaction can't kill the train loop."""

    def __init__(self, detectors=None, callback=None):
        self.detectors = list(detectors) if detectors is not None \
            else default_detectors()
        self.callbacks = [callback] if callback is not None else []
        self.fired = []  # (name, step, detail) history, bounded
        self._fired_cap = 256

    def add_callback(self, fn):
        self.callbacks.append(fn)

    def observe(self, rec):
        out = []
        for det in self.detectors:
            try:
                detail = det.update(rec)
            except Exception:
                continue  # a broken detector must not break the step
            if detail is None:
                continue
            _metrics.counter("anomaly." + det.name).inc()
            fired = {"name": det.name, "step": rec.get("step"),
                     "detail": detail}
            out.append(fired)
            if len(self.fired) < self._fired_cap:
                self.fired.append(fired)
            for cb in self.callbacks:
                try:
                    cb(fired)
                except Exception:
                    pass
        return out
