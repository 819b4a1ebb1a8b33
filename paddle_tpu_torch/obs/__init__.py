"""paddle_tpu_torch.obs: the host-side observability the serve path calls.

- ``metrics``: counters, gauges and fixed-bucket histograms;
- ``lockdep``: opt-in runtime lock-order validation;
- ``trace``: wall-time spans with Chrome-trace export;
- ``journal``: the run journal's event, request and step records;
- ``mfu``: peak FLOP/s of the card, goodput and the MFU accounting the
  journal's step records feed;
- ``usage``: per-tenant device-second and page-second attribution;
- ``export``: the registry and the serving/fleet SLO gauges as
  Prometheus text over a localhost ``/metrics`` endpoint or a textfile;
- ``timeseries``, ``slo``: windowed SLO series and the burn-rate
  evaluator the fleet router ticks;
- ``anomaly``: stateful detectors over step and serving signals;
- ``reqtrace``: per-request timelines across router and replicas;
- ``fleet``: cross-rank aggregation over per-rank journals and the
  merged Chrome trace;
- ``report``: the metrics registry rendered as a table or JSON.

The package binds the metrics, trace, journal and exporter names as the
JAX package's ``obs`` does. The JAX package's SPMD views, op sampling
and XLA cost analyses are not ported yet (ROADMAP Queue 1, item 7).
"""
from . import (anomaly, export, fleet, journal, lockdep, metrics, mfu,
               report, reqtrace, slo, timeseries, trace, usage)
from .export import MetricsExporter
from .journal import RunJournal, end_run, start_run
from .metrics import (REGISTRY, Counter, Gauge, Histogram, Registry, counter,
                      gauge, histogram, reset, snapshot)
from .trace import (clear_trace, disable_tracing, enable_tracing,
                    export_chrome_trace, span, trace_events, tracing_enabled)

__all__ = ["anomaly", "export", "fleet", "journal", "lockdep", "metrics",
           "mfu", "report", "reqtrace", "slo", "timeseries", "trace",
           "usage", "counter", "gauge", "histogram", "snapshot", "reset",
           "Counter", "Gauge", "Histogram", "Registry", "REGISTRY", "span",
           "enable_tracing", "disable_tracing", "tracing_enabled",
           "clear_trace", "trace_events", "export_chrome_trace",
           "RunJournal", "start_run", "end_run", "MetricsExporter"]
