"""The shared env-spec grammar: ``"name:key=val,key=val;name2"``.

One parser for every env knob that configures a registry of named
things — chaos points (``PADDLE_TPU_CHAOS``), anomaly detectors
(``PADDLE_TPU_ANOMALY``). Values coerce int -> float -> str.
Stdlib-only: both ``resilience.inject`` and ``obs.anomaly`` import this,
so it must never pull torch or another subsystem of the package.
"""
from __future__ import annotations

__all__ = ["parse_scalar", "parse_spec"]


def parse_scalar(s):
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            return s


def parse_spec(spec):
    """``"a:x=1,y=2;b"`` -> ``[("a", {"x": 1, "y": 2}), ("b", {})]``."""
    out = []
    for entry in filter(None, (e.strip() for e in (spec or "").split(";"))):
        name, _, rest = entry.partition(":")
        cfg = {}
        for kv in filter(None, (p.strip() for p in rest.split(","))):
            k, _, v = kv.partition("=")
            cfg[k.strip()] = parse_scalar(v.strip())
        out.append((name.strip(), cfg))
    return out
