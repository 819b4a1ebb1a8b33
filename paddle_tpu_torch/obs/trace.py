"""Wall-time span tracer with Chrome-trace export.

``span("executor.compile", uid=3)`` records one complete event into a
bounded in-memory ring buffer; ``export_chrome_trace(path)`` dumps the
buffer as ``chrome://tracing`` / Perfetto JSON. This is the host-side
timeline complement to ``torch.profiler`` (which owns the device/CUDA
view): serve steps, prefills, decodes and request lifecycle markers.

Off by default. ``span()`` with tracing disabled returns one shared
no-op context manager — no allocation, no clock read, one module-bool
check (the same discipline as the ``resilience.inject`` ``if ACTIVE``
hooks). Opt in per process with env ``PADDLE_TPU_TRACE=1`` or at runtime
with ``enable_tracing()``.

The ring buffer is bounded (default 65536 spans): a week-long serving
process can leave tracing on and the newest spans win.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time

__all__ = [
    "span", "enable_tracing", "disable_tracing", "tracing_enabled",
    "clear_trace", "trace_events", "export_chrome_trace",
    "device_counter", "set_rank", "current_rank",
    "flow_start", "flow_finish",
    "DEFAULT_CAPACITY", "DEVICE_PID_BASE", "RANK_PID_STRIDE",
]

DEFAULT_CAPACITY = 65536
# per-device lanes render as separate Chrome-trace processes; their pids
# are offset far above any real host pid so they never collide with the
# host lane
DEVICE_PID_BASE = 1 << 20
# per-RANK namespace inside the device pid band: rank r's device d lane
# is DEVICE_PID_BASE + r * RANK_PID_STRIDE + d, so a merged fleet trace
# (obs.fleet.merge_chrome_traces) never interleaves two ranks' device
# counter lanes under one pid. 4096 devices per process is far above
# any real per-host device count
RANK_PID_STRIDE = 1 << 12

# this process's rank identity (multi-process gangs: the supervisor
# hands each worker PADDLE_TPU_RANK). None = single-process, exports
# keep the historical os.getpid()/DEVICE_PID_BASE+id lanes exactly
_rank = None


def set_rank(rank):
    """Adopt a rank identity for trace exports: host spans land on
    pid=rank (a stable lane a merged fleet trace can line up, unlike
    OS pids that recycle across elastic relaunches) and device counter
    lanes shift into the rank's namespace slice."""
    global _rank
    _rank = None if rank is None else int(rank)


def current_rank():
    return _rank

_enabled = False
_events: collections.deque = collections.deque(maxlen=DEFAULT_CAPACITY)
# per-device counter samples (obs.spmd.update_device_gauges feeds this):
# (device_id, name, ts µs, value); bounded like the span ring
_device_samples: collections.deque = collections.deque(maxlen=16384)
_device_labels: dict = {}  # device_id -> lane label for the trace meta
# one perf-counter epoch per process: every span's ts is an offset from
# here, so spans from different threads land on one comparable timeline
_EPOCH = time.perf_counter()

_NULL = contextlib.nullcontext()  # stateless + reentrant: safe to share


class _Span:
    __slots__ = ("name", "attrs", "_t0")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        # deque.append with maxlen is atomic under the GIL: no lock on
        # the record path
        _events.append((self.name,
                        (self._t0 - _EPOCH) * 1e6,  # ts µs
                        (t1 - self._t0) * 1e6,      # dur µs
                        threading.get_ident(),
                        self.attrs))
        return False


def span(name, **attrs):
    """Context manager timing one named span. A no-op (shared null
    context) unless tracing is enabled."""
    if not _enabled:
        return _NULL
    return _Span(name, attrs)


def enable_tracing(capacity=None):
    """Turn span recording on; ``capacity`` resizes (and clears) the
    ring buffer."""
    global _enabled, _events
    if capacity is not None and capacity != _events.maxlen:
        _events = collections.deque(maxlen=int(capacity))
    _enabled = True


def disable_tracing():
    """Stop recording; already-recorded spans stay exportable."""
    global _enabled
    _enabled = False


def tracing_enabled():
    return _enabled


def clear_trace():
    _events.clear()
    _device_samples.clear()
    _device_labels.clear()


def device_counter(device_id, name, value, label=None):
    """Record one per-device counter sample (e.g. HBM bytes in use) for
    the Chrome trace's per-device pid lanes. A no-op when tracing is
    disabled — callers on a hot path should gate on
    ``tracing_enabled()`` themselves (``obs.spmd.update_device_gauges``
    does)."""
    if not _enabled:
        return
    if label is not None:
        _device_labels[int(device_id)] = label
    _device_samples.append((int(device_id), name,
                            (time.perf_counter() - _EPOCH) * 1e6,
                            float(value)))


def flow_start(name, flow_id, pid, tid, ts_us, **args):
    """One Chrome-trace flow-start event ("s"): the tail of an arrow
    Perfetto draws between two slices — possibly on different pid
    lanes. Pair with :func:`flow_finish` under the same ``flow_id``
    (``obs.reqtrace`` uses these to draw a requeued request crossing
    from the victim replica's lane to the re-dispatched one's)."""
    return {"ph": "s", "cat": "req", "name": str(name),
            "id": int(flow_id), "pid": pid, "tid": tid,
            "ts": float(ts_us), "args": dict(args)}


def flow_finish(name, flow_id, pid, tid, ts_us, **args):
    """The matching flow-finish ("f") for :func:`flow_start`.
    ``bp="e"`` binds the arrowhead to the ENCLOSING slice at this
    timestamp rather than the next slice to start — the binding that
    keeps the arrow on the re-dispatch segment itself."""
    return {"ph": "f", "bp": "e", "cat": "req", "name": str(name),
            "id": int(flow_id), "pid": pid, "tid": tid,
            "ts": float(ts_us), "args": dict(args)}


def trace_events():
    """Snapshot of recorded spans as dicts (newest-capped by the ring)."""
    return [{"name": n, "ts": ts, "dur": dur, "tid": tid, "args": attrs}
            for n, ts, dur, tid, attrs in list(_events)]


def export_chrome_trace(path):
    """Write the span buffer as Chrome trace-event JSON (load in
    chrome://tracing or https://ui.perfetto.dev). Returns the number of
    spans exported. With a rank identity set (:func:`set_rank` / env
    ``PADDLE_TPU_RANK``) the host lane is pid=rank and device lanes are
    rank-namespaced, so per-rank exports fuse collision-free."""
    rank = _rank
    pid = os.getpid() if rank is None else rank
    host_name = "paddle_tpu_torch" if rank is None \
        else f"paddle_tpu_torch rank {rank:02d}"
    events = [{"ph": "X", "pid": pid, "tid": tid, "name": n,
               "ts": ts, "dur": dur, "args": attrs}
              for n, ts, dur, tid, attrs in list(_events)]
    events.append({"ph": "M", "pid": pid, "name": "process_name",
                   "args": {"name": host_name}})
    # per-device pid lanes: counter samples (HBM gauges) render as one
    # Chrome-trace "process" per device, below the host span lane —
    # inside this rank's namespace slice of the device pid band
    dev_base = DEVICE_PID_BASE + (rank or 0) * RANK_PID_STRIDE
    lanes = set()
    for dev_id, name, ts, value in list(_device_samples):
        lane = dev_base + dev_id
        lanes.add((lane, dev_id))
        events.append({"ph": "C", "pid": lane, "name": name, "ts": ts,
                       "args": {"value": value}})
    for lane, dev_id in sorted(lanes):
        label = _device_labels.get(dev_id, f"device {dev_id}")
        if rank is not None:
            label = f"rank {rank:02d} {label}"
        events.append({"ph": "M", "pid": lane, "name": "process_name",
                       "args": {"name": label}})
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        # default=str: span attrs may carry shapes/dtypes/paths — never
        # let an exotic attr make the whole export unserializable
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  default=str)
    return sum(1 for e in events if e["ph"] == "X")


if os.environ.get("PADDLE_TPU_TRACE", "").lower() not in ("", "0", "false"):
    enable_tracing()

# a supervised gang worker inherits its rank from the launcher
# (GangSupervisor / dist.launch hand each worker PADDLE_TPU_RANK)
try:
    set_rank(int(os.environ["PADDLE_TPU_RANK"]))
except (KeyError, ValueError):
    pass
