"""Render the metrics registry for humans (table) or machines (JSON): the
counterpart of ``paddle_tpu/obs/report.py``.

The reference prints its profiler report as a sorted per-op table
(``print_profiler`` in the C++ platform profiler); this is the same idea
over the ``obs.metrics`` registry: counters and gauges one per line,
histograms with count / mean / p50 / p90 / p99 / max, grouped by the
dotted instrument prefix (``executor.*``, ``dataloader.*``, ...).
"""
from __future__ import annotations

import json

from . import metrics as _metrics

__all__ = ["render", "render_json", "report"]


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.3f}".rstrip("0").rstrip(".") if v else "0"
    return str(v)


def render(snapshot=None):
    """Aligned text table of one metrics snapshot (default: the live
    registry)."""
    snap = _metrics.snapshot() if snapshot is None else snapshot
    if not snap:
        return "(no instruments registered)"
    rows = []
    for name, val in snap.items():
        if isinstance(val, dict):  # histogram
            if not val.get("count"):
                rows.append((name, "(no samples)"))
                continue
            rows.append((name, (
                f"n={val['count']} mean={_fmt(val['mean'])} "
                f"p50={_fmt(val['p50'])} p90={_fmt(val['p90'])} "
                f"p99={_fmt(val['p99'])} max={_fmt(val['max'])}")))
        else:
            rows.append((name, _fmt(val)))
    width = max(len(n) for n, _ in rows)
    lines, prev_group = [], None
    for name, text in rows:
        group = name.split(".", 1)[0]
        if prev_group is not None and group != prev_group:
            lines.append("")
        prev_group = group
        lines.append(f"{name:<{width}}  {text}")
    return "\n".join(lines)


def render_json(snapshot=None, indent=1):
    snap = _metrics.snapshot() if snapshot is None else snapshot
    return json.dumps(snap, indent=indent, sort_keys=True, default=str)


def report(as_json=False, file=None):
    """Render the live registry; returns the string and additionally
    prints it to ``file`` when one is given."""
    text = render_json() if as_json else render()
    if file is not None:
        print(text, file=file)
    return text
