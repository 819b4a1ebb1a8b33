"""Fixed-interval rolling windows over the metrics plane.

The registry (``obs.metrics``) and the Prometheus exposition
(``obs.export``) are CUMULATIVE views: a counter only ever grows, a
histogram's ``_bucket`` series only ever fills. Production questions
are WINDOWED: "what is the reject rate over the last 5 minutes", "what
is TTFT p99 over the last half hour" — the inputs the SLO engine
(``obs.slo``) burns error budget against and a canary
scoring compares across releases.

This module is that windowing layer, and nothing else:

- :class:`SeriesStore` keeps a bounded ring of ``(t, value)`` samples
  per series — counters and gauges as floats, histograms as cumulative
  bucket-count tuples — and answers window queries by DIFFERENCING two
  ring entries: ``counter_delta``/``counter_rate``, ``gauge_last``/
  ``gauge_delta``, ``hist_window`` (per-bucket count deltas) and
  ``percentile``/``fraction_above`` derived from them. Memory is
  bounded by ``horizon_s / interval_s`` samples per series no matter
  how long the process lives.
- Two snapshot builders feed it with the SAME shape:
  :func:`registry_snapshot` (in-process ``obs.metrics`` instruments)
  and :func:`exposition_snapshot` (a scraped/merged Prometheus text —
  the multi-process fleet path), so a window query does not care which
  side of a process boundary the samples came from.
- Every timestamp comes from the caller (or an injectable ``clock``),
  so tests drive a ``ManualClock`` and the window math is EXACT — the
  property the burn-rate acceptance fixtures rest on.

Pull-only and caller-driven: nothing here samples on its own, nothing
runs unless ``observe()``/``sample()`` is called — the zero-overhead
hook contract holds trivially (the poison test pins it).
"""
from __future__ import annotations

import bisect
import math
import time
from collections import deque

from . import metrics as _metrics
from .metrics import Counter, Gauge, Histogram

__all__ = [
    "SeriesStore", "registry_snapshot", "exposition_snapshot",
    "percentile_from_buckets", "WINDOWS",
]

# the canonical window ladder (label -> seconds): the 1m/5m/30m panes
# the statusz tables render and the 5m/30m/3h pairs the SRE-style
# burn-rate policies in obs.slo are built from
WINDOWS = {"1m": 60.0, "5m": 300.0, "30m": 1800.0, "3h": 10800.0}


def percentile_from_buckets(buckets, counts, q):
    """Interpolated q-th percentile from per-bucket counts (``counts``
    has one overflow slot past the last bound) — the windowed twin of
    ``Histogram.percentile``, with the window's bucket deltas standing
    in for the instrument's lifetime counts. Without min/max the first
    bucket interpolates from 0 and the overflow clamps to the last
    finite bound. Returns None on an empty window."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = (q / 100.0) * total
    seen = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if seen + c >= rank:
            hi = buckets[i] if i < len(buckets) else buckets[-1]
            lo = buckets[i - 1] if i > 0 else min(0.0, hi)
            frac = (rank - seen) / c
            return float(lo + (hi - lo) * max(0.0, min(1.0, frac)))
        seen += c
    return float(buckets[-1])


def _cumulative(counts):
    out = []
    cum = 0
    for c in counts:
        cum += c
        out.append(cum)
    return tuple(out)


def registry_snapshot(registry=None):
    """One ``{name: (type, payload)}`` snapshot of the in-process
    metrics registry: counters/gauges as floats, histograms as
    ``(buckets, cumulative_counts, count, sum)`` — cumulative counts
    carry the overflow slot, so ``cumulative_counts[-1] == count``."""
    reg = registry if registry is not None else _metrics.REGISTRY
    out = {}
    for name in reg.names():
        inst = reg.get(name)
        if isinstance(inst, Counter):
            out[name] = ("counter", float(inst.value))
        elif isinstance(inst, Histogram):
            buckets, counts, count, total = inst.bucket_counts()
            out[name] = ("histogram",
                         (buckets, _cumulative(counts), count, total))
        elif isinstance(inst, Gauge):
            out[name] = ("gauge", float(inst.value))
    return out


def exposition_snapshot(text):
    """The same snapshot shape from Prometheus exposition text (one
    exporter's render, or a ``merge_expositions`` fusion of a whole
    fleet) — so windowing over scraped out-of-process replicas is the
    identical code path as windowing over the local registry.

    Series names keep their exposition form including labels
    (``paddle_tpu_serving_slo_ttft_ms{replica="0",q="p99"}``);
    histogram families collapse their ``_bucket``/``_sum``/``_count``
    series back into ONE histogram payload under the family name.
    Samples without a ``# TYPE`` declaration default to gauge."""
    types = {}
    samples = []   # (key, value-string) in exposition order
    for line in str(text).splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) >= 4:
                types.setdefault(parts[2], parts[3])
            continue
        if line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        if key:
            samples.append((key, val))
    out = {}
    hists = {}     # family -> {"le": [(bound, cum)], "sum": s, "count": n}
    for key, val in samples:
        family = key.split("{", 1)[0]
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            if family.endswith(suffix) and \
                    types.get(family[:-len(suffix)]) == "histogram":
                base = (family[:-len(suffix)], suffix)
                break
        if base is not None:
            fam, suffix = base
            h = hists.setdefault(fam, {"le": [], "sum": 0.0,
                                       "count": 0})
            try:
                fval = float(val)
            except ValueError:
                continue
            if suffix == "_bucket":
                m = key.partition("{")[2]
                le = None
                for part in m.rstrip("}").split(","):
                    k, _, v = part.partition("=")
                    if k.strip() == "le":
                        le = v.strip().strip('"')
                if le is None:
                    continue
                try:
                    bound = float(le)
                except ValueError:
                    continue
                if not math.isfinite(bound):
                    # the +Inf bucket is the overflow slot, which the
                    # payload derives from _count (float("+Inf") parses
                    # fine, so this must be an explicit skip)
                    continue
                h["le"].append((bound, fval))
            elif suffix == "_sum":
                h["sum"] = fval
            else:
                h["count"] = int(fval)
            continue
        try:
            fval = float(val)
        except ValueError:
            continue
        typ = types.get(family, "gauge")
        if typ == "counter":
            out[key] = ("counter", fval)
        else:
            out[key] = ("gauge", fval)
    for fam, h in hists.items():
        pairs = sorted(h["le"])
        buckets = tuple(b for b, _ in pairs)
        cum = tuple(int(c) for _, c in pairs) + (int(h["count"]),)
        out[fam] = ("histogram", (buckets, cum, int(h["count"]),
                                  float(h["sum"])))
    return out


class _Ring:
    """Bounded ring of ``(t, payload)`` samples, timestamps
    monotonically appended."""

    __slots__ = ("samples",)

    def __init__(self, cap):
        self.samples = deque(maxlen=cap)

    def append(self, t, payload):
        self.samples.append((t, payload))

    def at_or_before(self, t):
        """Latest sample with timestamp <= t; falls back to the OLDEST
        retained sample when the window predates the ring (a partial
        window reads what history exists rather than nothing)."""
        best = None
        for ts, payload in self.samples:
            if ts <= t:
                best = (ts, payload)
            else:
                break
        if best is None and self.samples:
            return self.samples[0]
        return best

    def last(self):
        return self.samples[-1] if self.samples else None


class SeriesStore:
    """Bounded rings of metric samples + window queries over them.

    ``interval_s`` is the nominal sampling cadence ``sample()``
    enforces (``observe()`` records unconditionally — tests and the
    SLO evaluator own their cadence); ``horizon_s`` bounds retention.
    All query ``now`` defaults resolve to the newest sample time, so a
    ManualClock test never races a wall clock.
    """

    def __init__(self, interval_s=1.0, horizon_s=3 * 3600.0,
                 clock=None):
        self.interval_s = float(interval_s)
        self.horizon_s = float(horizon_s)
        self.clock = clock if clock is not None else time.monotonic
        self._cap = max(2, int(self.horizon_s / self.interval_s) + 2)
        self._rings = {}      # name -> _Ring
        self._kinds = {}      # name -> "counter"|"gauge"|"histogram"
        self._last_t = None

    # -- feeding -------------------------------------------------------------
    def observe(self, snapshot, now=None):
        """Record one snapshot (``registry_snapshot`` /
        ``exposition_snapshot`` shape, or several merged) at ``now``."""
        now = self.clock() if now is None else float(now)
        for name, (kind, payload) in snapshot.items():
            ring = self._rings.get(name)
            if ring is None:
                ring = self._rings[name] = _Ring(self._cap)
                self._kinds[name] = kind
            ring.append(now, payload)
        self._last_t = now
        return now

    def sample(self, snapshot_fn, now=None):
        """Cadence-gated feed: calls ``snapshot_fn()`` and records it
        only when ``interval_s`` has elapsed since the last sample —
        the cheap form a polling loop calls every iteration. Returns
        the sample time, or None when not yet due."""
        now = self.clock() if now is None else float(now)
        if self._last_t is not None and \
                now < self._last_t + self.interval_s:
            return None
        return self.observe(snapshot_fn(), now=now)

    @property
    def last_t(self):
        return self._last_t

    def names(self):
        return sorted(self._rings)

    def kind(self, name):
        return self._kinds.get(name)

    # -- window plumbing -----------------------------------------------------
    def _pair(self, name, window_s, now=None):
        ring = self._rings.get(name)
        if ring is None or not ring.samples:
            return None
        now = self._last_t if now is None else float(now)
        new = ring.at_or_before(now)
        old = ring.at_or_before(now - float(window_s))
        if new is None or old is None:
            return None
        return old, new

    # -- counters ------------------------------------------------------------
    def counter_delta(self, name, window_s, now=None):
        """Increment over the window (clamped at 0: a reset/restart
        shows as a flat window, not a negative rate)."""
        pair = self._pair(name, window_s, now)
        if pair is None:
            return None
        (_, v0), (_, v1) = pair
        return max(0.0, float(v1) - float(v0))

    def counter_rate(self, name, window_s, now=None):
        """Increments per second over the window (None when the window
        holds fewer than two distinct samples)."""
        pair = self._pair(name, window_s, now)
        if pair is None:
            return None
        (t0, v0), (t1, v1) = pair
        if t1 <= t0:
            return None
        return max(0.0, float(v1) - float(v0)) / (t1 - t0)

    # -- gauges --------------------------------------------------------------
    def gauge_last(self, name, now=None):
        ring = self._rings.get(name)
        if ring is None:
            return None
        now = self._last_t if now is None else float(now)
        s = ring.at_or_before(now)
        return None if s is None else float(s[1])

    def gauge_delta(self, name, window_s, now=None):
        """Trend: newest minus window-start value (signed)."""
        pair = self._pair(name, window_s, now)
        if pair is None:
            return None
        (_, v0), (_, v1) = pair
        return float(v1) - float(v0)

    # -- histograms ----------------------------------------------------------
    def hist_window(self, name, window_s, now=None):
        """``(buckets, counts, count, sum)`` for observations INSIDE
        the window: per-bucket deltas of the cumulative rings (counts
        carries the overflow slot, like ``Histogram.bucket_counts``).
        None when the series is absent or the window is empty of
        samples."""
        pair = self._pair(name, window_s, now)
        if pair is None:
            return None
        (_, h0), (_, h1) = pair
        b0, c0, n0, s0 = h0
        b1, c1, n1, s1 = h1
        if b0 != b1:       # bucket layout changed (restart): no delta
            c0, n0, s0 = (0,) * len(c1), 0, 0.0
        counts = tuple(max(0, int(a) - int(b))
                       for a, b in zip(c1, c0))
        # de-cumulate: ring payloads are cumulative-within-snapshot
        flat = []
        prev = 0
        for c in counts:
            flat.append(max(0, c - prev))
            prev = c
        return (b1, tuple(flat), max(0, int(n1) - int(n0)),
                float(s1) - float(s0))

    def percentile(self, name, q, window_s, now=None):
        """Windowed interpolated percentile over a histogram series
        (p50/p99 over the last 1m/5m/30m — the statusz table cell)."""
        win = self.hist_window(name, window_s, now)
        if win is None:
            return None
        buckets, counts, _count, _sum = win
        return percentile_from_buckets(buckets, counts, q)

    def fraction_above(self, name, threshold, window_s, now=None):
        """Fraction of the window's observations STRICTLY above
        ``threshold`` — the latency-SLO bad-event fraction. Exact when
        ``threshold`` equals a bucket upper bound (the histogram's
        ``observe`` bisects left, so a sample equal to a bound lands in
        that bound's bucket); between bounds it is conservative,
        counting the whole straddling bucket as above. Returns
        ``(bad, total)`` so callers can pool windows, or None on an
        empty/absent window."""
        win = self.hist_window(name, window_s, now)
        if win is None:
            return None
        buckets, counts, total, _sum = win
        if total <= 0:
            return (0.0, 0.0)
        i = bisect.bisect_left(buckets, float(threshold))
        if i < len(buckets) and buckets[i] == float(threshold):
            i += 1
        bad = sum(counts[i:])
        return (float(bad), float(total))
