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

The JAX package's SPMD views and XLA cost analyses are not ported yet.
"""
from . import (anomaly, export, fleet, journal, lockdep, metrics, mfu,
               report, reqtrace, slo, timeseries, trace, usage)

__all__ = ["anomaly", "export", "fleet", "journal", "lockdep", "metrics",
           "mfu", "report", "reqtrace", "slo", "timeseries", "trace",
           "usage"]
