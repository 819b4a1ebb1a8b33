"""paddle_tpu_torch.obs: the host-side observability the serve loop calls.

- ``metrics``: counters, gauges and fixed-bucket histograms;
- ``lockdep``: opt-in runtime lock-order validation;
- ``trace``: wall-time spans with Chrome-trace export;
- ``journal``: the run journal's event and request records;
- ``usage``: per-tenant device-second and page-second attribution.

The JAX package's anomaly detectors, MFU accounting, SLO engine,
exporters and fleet views are not ported yet.
"""
from . import journal, lockdep, metrics, trace, usage

__all__ = ["journal", "lockdep", "metrics", "trace", "usage"]
