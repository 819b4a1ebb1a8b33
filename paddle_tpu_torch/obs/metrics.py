"""Process-wide metrics registry: Counters, Gauges, fixed-bucket Histograms.

The reference exposes runtime health through the C++ profiler's per-op
records and assorted VLOG counters; here every subsystem ticks named
instruments in one registry instead, and anything — the report CLI, a
test, a serving health endpoint — reads a consistent ``snapshot()``.

Design constraints (they shape the whole module):

- **Cheap when ignored.** An ``inc()``/``observe()`` is a lock-guarded
  int add on the host — no allocation beyond the first registration, no
  device sync, nothing proportional to data size. Instrument objects are
  interned by name, so hot paths hold a direct reference and skip the
  registry dict entirely.
- **Thread-safe.** DataLoader workers, the chaos supervisor, and the
  train loop all tick concurrently; every mutation takes the
  instrument's own lock (never the registry lock), so contention is
  per-instrument.
- **Reset keeps registrations.** ``reset()`` zeroes values but leaves
  the instruments interned — references cached by hot paths stay live,
  which is what makes per-test resets safe.
"""
from __future__ import annotations

import bisect
import math
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram", "snapshot", "reset",
    "exact_percentile", "DEFAULT_MS_BUCKETS", "WIDE_MS_BUCKETS",
]


def exact_percentile(xs, q):
    """Exact q-th percentile by nearest rank over raw samples (the
    complement of Histogram's bounded-bucket interpolation, for readers
    that kept every sample — per-request journal records, bench traces).
    One definition shared by tools/run_report.py and
    tools/serve_bench.py so their p50/p99 columns stay comparable."""
    if not xs:
        return None
    xs = sorted(xs)
    i = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[i]

# upper bounds (ms) covering µs-scale op dispatch through multi-second
# kernel builds; +inf is implicit as the overflow bucket
DEFAULT_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                      50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0, 30000.0)

# the default set tops out at 30s — fine for steps and compiles, but
# whole-gang events (elastic resume = failure detection -> every worker
# beating again, which includes process spawn + backend init + a
# checkpoint load) live in the seconds-to-minutes band; this extension
# keeps percentile resolution out to 10 minutes instead of clamping
# everything past 30s into the overflow bucket
WIDE_MS_BUCKETS = DEFAULT_MS_BUCKETS + (60000.0, 120000.0, 300000.0,
                                        600000.0)


class Counter:
    """Monotonic count (events, hits, retries)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def _reset(self):
        with self._lock:
            self._value = 0

    def _snapshot(self):
        return self._value

    def __repr__(self):
        return f"Counter({self.name}={self._value})"


class Gauge:
    """Last-set level (queue depth, cache size, active workers)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        return self._value

    def _reset(self):
        with self._lock:
            self._value = 0.0

    def _snapshot(self):
        return self._value

    def __repr__(self):
        return f"Gauge({self.name}={self._value})"


class Histogram:
    """Fixed-bucket distribution (latencies, wait times).

    Buckets are upper bounds chosen at registration and never change, so
    ``observe()`` is a bisect + two int adds — no per-sample storage, a
    bounded footprint no matter how many billions of steps tick it.
    Percentiles come from linear interpolation inside the owning bucket
    (exact enough for dashboards; tests wanting exact quantiles keep raw
    samples themselves, as ``utils.profiler.StepTimer`` does).
    """

    __slots__ = ("name", "buckets", "_counts", "_count", "_sum", "_min",
                 "_max", "_lock")

    def __init__(self, name, buckets=DEFAULT_MS_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram buckets must be sorted ascending "
                             f"upper bounds, got {buckets!r}")
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # +1 overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def percentile(self, q):
        """Approximate q-th percentile (q in [0, 100]) by interpolating
        within the bucket holding the rank; the overflow bucket clamps to
        the observed max."""
        with self._lock:
            total = self._count
            if total == 0:
                return None
            rank = (q / 100.0) * total
            seen = 0.0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if seen + c >= rank:
                    hi = self.buckets[i] if i < len(self.buckets) \
                        else self._max
                    lo = self.buckets[i - 1] if i > 0 else \
                        min(self._min, hi)
                    frac = (rank - seen) / c
                    v = lo + (hi - lo) * max(0.0, min(1.0, frac))
                    return float(min(max(v, self._min), self._max))
                seen += c
            return float(self._max)

    def bucket_counts(self):
        """Consistent ``(buckets, counts, count, sum)`` snapshot —
        ``counts`` has one extra overflow slot past the last bound. The
        raw-distribution accessor Prometheus exposition needs
        (``obs.export`` turns it into cumulative ``_bucket`` series);
        ``_snapshot()`` stays the human-facing percentile view."""
        with self._lock:
            return (self.buckets, tuple(self._counts), self._count,
                    self._sum)

    def _reset(self):
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    def _snapshot(self):
        with self._lock:
            if self._count == 0:
                return {"count": 0}
            snap = {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    "mean": self._sum / self._count}
        snap["p50"] = self.percentile(50)
        snap["p90"] = self.percentile(90)
        snap["p99"] = self.percentile(99)
        return snap

    def __repr__(self):
        return f"Histogram({self.name}, count={self._count})"


class Registry:
    """Name -> instrument interning. One process-wide instance
    (``REGISTRY``) backs the module-level helpers; private registries
    exist only for tests that must not see global state."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict = {}

    def _get(self, name, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"instrument {name!r} is a {type(inst).__name__}, "
                    f"requested as {cls.__name__}")
            return inst

    def counter(self, name) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name, buckets=DEFAULT_MS_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets)

    def names(self):
        with self._lock:
            return sorted(self._instruments)

    def get(self, name):
        with self._lock:
            return self._instruments.get(name)

    def snapshot(self):
        """{name: value} for counters/gauges, {name: stats-dict} for
        histograms — a plain-data copy safe to json.dumps."""
        with self._lock:
            items = list(self._instruments.items())
        return {name: inst._snapshot() for name, inst in sorted(items)}

    def reset(self):
        """Zero every instrument, KEEPING registrations (cached hot-path
        references stay valid)."""
        with self._lock:
            items = list(self._instruments.values())
        for inst in items:
            inst._reset()


REGISTRY = Registry()


def counter(name) -> Counter:
    return REGISTRY.counter(name)


def gauge(name) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name, buckets=DEFAULT_MS_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, buckets)


def snapshot():
    return REGISTRY.snapshot()


def reset():
    REGISTRY.reset()
