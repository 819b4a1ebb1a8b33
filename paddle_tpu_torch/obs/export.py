"""Live SLO export: the metrics registry + serving/fleet SLO gauges as
Prometheus text, over a localhost HTTP endpoint and/or an atomic
textfile.

The journal (``obs.journal``) and the fleet aggregator (``obs.fleet``)
are post-hoc readers; a router or autoscaler needs the SAME signals
LIVE — queue depth, running count, TTFT/TPOT percentiles, per-rank
heartbeat age (the scale-up/down inputs, and the TTFT/TPOT/
throughput axes serving comparisons are framed in). This module is
that signal plane:

- :func:`prometheus_text` — one Prometheus text-format snapshot:
  every ``obs.metrics`` instrument (counters/gauges/histograms with
  cumulative ``_bucket`` series) plus derived SLO gauges.
- SLO gauges per serve replica (``ServeEngine.stats()`` — the EXACT
  per-instance percentiles, labelled ``replica="N"``) and per rank
  (``paddle_tpu_rank_heartbeat_age_seconds`` from the rank journals'
  last flush under a fleet run dir).
- :class:`MetricsExporter` — ``GET /metrics`` on a localhost HTTP
  endpoint (``port=0`` picks an ephemeral port), and
  :func:`write_textfile` for node-exporter-style textfile collection
  (tmp + atomic rename: a scraper never reads a torn file).
- The multi-process path: ``live_engines()`` only ever discovers THIS
  process's replicas, so a fleet front-end composes
  :func:`router_lines` (``serving.fleet.Router`` truth, bitwise) with
  :func:`scrape` + :func:`merge_expositions` over each worker
  replica's own exporter (URL or textfile) — one exposition covering
  out-of-process replicas, which is what the autoscaler consumes.

Pull-only by design: nothing here runs on a step path, nothing ticks
unless scraped — the zero-overhead hook contract holds trivially.
Engines register themselves at construction (``serving.engine``'s
process-wide weak registry), so ``MetricsExporter()`` with no
arguments exports every live replica in the process.
"""
from __future__ import annotations

import math
import os
import re
import threading

from . import metrics as _metrics
from .metrics import Counter, Gauge, Histogram

__all__ = [
    "prometheus_text", "registry_lines", "slo_lines", "router_lines",
    "tenant_lines", "slo_engine_lines", "statusz_data",
    "render_statusz_html", "write_textfile", "parse_prometheus_text",
    "scrape", "merge_expositions", "MetricsExporter", "PREFIX",
]

PREFIX = "paddle_tpu_"
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _name(name):
    return PREFIX + _NAME_RE.sub("_", str(name))


def _fmt(v):
    """Prometheus sample value. ``repr(float)`` is the shortest
    round-trip form, so a scraped value parses back to EXACTLY the
    source float — the property the exporter's acceptance gate
    (scraped TTFT/TPOT == ``ServeEngine.stats()``) rests on."""
    if v is None:
        return "NaN"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


class _Lines:
    """Ordered exposition lines with one ``# TYPE`` declaration per
    metric family (Prometheus rejects duplicates)."""

    def __init__(self):
        self.lines = []
        self._declared = set()

    def add(self, family, typ, value, labels=None):
        if family not in self._declared:
            self._declared.add(family)
            self.lines.append(f"# TYPE {family} {typ}")
        lbl = ""
        if labels:
            lbl = "{" + ",".join(
                f'{k}="{v}"' for k, v in labels.items()) + "}"
        self.lines.append(f"{family}{lbl} {_fmt(value)}")

    def raw(self, line):
        self.lines.append(line)


def registry_lines(registry=None):
    """Every ``obs.metrics`` instrument as Prometheus lines: counters
    and gauges verbatim, histograms as cumulative ``_bucket{le=...}``
    series + ``_sum``/``_count`` (the native Prometheus histogram
    shape, so server-side ``histogram_quantile`` works)."""
    reg = registry if registry is not None else _metrics.REGISTRY
    out = _Lines()
    for name in reg.names():
        inst = reg.get(name)
        n = _name(name)
        if isinstance(inst, Counter):
            out.add(n, "counter", inst.value)
        elif isinstance(inst, Histogram):
            buckets, counts, count, total = inst.bucket_counts()
            out.raw(f"# TYPE {n} histogram")
            cum = 0
            for b, c in zip(buckets, counts):
                cum += c
                out.raw(f'{n}_bucket{{le="{_fmt(b)}"}} {cum}')
            out.raw(f'{n}_bucket{{le="+Inf"}} {count}')
            out.raw(f"{n}_sum {_fmt(total)}")
            out.raw(f"{n}_count {count}")
        elif isinstance(inst, Gauge):
            out.add(n, "gauge", inst.value)
    return out.lines


def slo_lines(engines=None, run_dir=None, now=None):
    """Derived SLO gauges: per serve replica (queue depth, running,
    finished, exact TTFT/TPOT/e2e p50/p99 from that engine's OWN
    finished requests, KV-pool occupancy) and per rank (journal
    heartbeat age under a fleet ``run_dir``). ``engines=None``
    discovers every live ``ServeEngine`` in the process."""
    if engines is None:
        try:
            from ..serving.engine import live_engines

            engines = live_engines()
        except Exception:
            engines = []
    out = _Lines()
    s = PREFIX + "serving_slo_"
    for i, eng in enumerate(engines):
        rep = str(getattr(eng, "replica_id", i))
        try:
            st = eng.stats()
        except Exception:
            continue
        lbl = {"replica": rep}
        out.add(s + "queue_depth", "gauge", st.get("queue_depth"), lbl)
        out.add(s + "running", "gauge", st.get("running"), lbl)
        out.add(s + "finished", "gauge", st.get("finished"), lbl)
        out.add(s + "preemptions", "gauge", st.get("preemptions"), lbl)
        kv = st.get("kv") or {}
        if kv:
            out.add(s + "kv_used_pages", "gauge",
                    kv.get("used_pages"), lbl)
            out.add(s + "kv_utilization", "gauge",
                    kv.get("utilization"), lbl)
        for key in ("ttft_ms", "tpot_ms", "e2e_ms"):
            d = st.get(key)
            if not d:
                continue
            for q in ("p50", "p99"):
                out.add(s + key, "gauge", d.get(q),
                        {"replica": rep, "q": q})
            out.add(s + key + "_count", "gauge", d.get("count"), lbl)
        # reqtrace phase attribution: where this replica's request
        # time went, as shares of total (queue + prefill + preempt +
        # decode over its finished requests) — the signal that says
        # whether a p99 breach is queueing or compute
        ph = st.get("phase_ms") or {}
        total = sum(v for v in ph.values()
                    if isinstance(v, (int, float)))
        if ph and total > 0:
            for phase in sorted(ph):
                out.add(s + "phase_share", "gauge",
                        float(ph[phase]) / total,
                        {"replica": rep, "phase": phase})
    if run_dir:
        from . import fleet as _fleet

        for rank, age in _fleet.heartbeat_ages(run_dir,
                                               now=now).items():
            out.add(PREFIX + "rank_heartbeat_age_seconds", "gauge",
                    age, {"rank": str(rank)})
    return out.lines


def router_lines(router):
    """The serve-fleet router's truth (``serving.fleet.Router.stats()``)
    as ``paddle_tpu_fleet_router_*`` gauges. Values are emitted in
    ``repr`` round-trip form like everything else here, so a scraped
    gauge parses back BITWISE equal to the stats dict — the router
    acceptance gate."""
    st = router.stats()
    out = _Lines()
    r = PREFIX + "fleet_router_"
    for key in ("queue_depth", "inflight", "dispatched", "requeued",
                "rejected", "completed", "replicas", "scale_ups",
                "scale_downs"):
        out.add(r + key, "gauge", st.get(key))
    for rep, d in sorted((st.get("per_replica") or {}).items()):
        lbl = {"replica": str(rep)}
        out.add(r + "outstanding_tokens", "gauge",
                d.get("outstanding_tokens"), lbl)
        out.add(r + "replica_inflight", "gauge", d.get("inflight"),
                lbl)
    for tenant, d in sorted((st.get("tenants") or {}).items()):
        lbl = {"tenant": str(tenant)}
        out.add(r + "tenant_served_tokens", "gauge",
                d.get("served_tokens"), lbl)
        out.add(r + "tenant_share", "gauge", d.get("share"), lbl)
        out.add(r + "tenant_queued", "gauge", d.get("queued"), lbl)
    for key in ("ttft_ms", "tpot_ms", "e2e_ms"):
        d = st.get(key)
        if not d:
            continue
        for q in ("p50", "p99"):
            out.add(r + key, "gauge", d.get(q), {"q": q})
        out.add(r + key + "_count", "gauge", d.get("count"))
    return out.lines


def tenant_lines(router=None, engines=None):
    """The per-tenant chargeback plane (``obs.usage``) as labeled
    ``paddle_tpu_tenant_*{tenant="..."}`` gauges, in ``repr``
    round-trip form like everything else here — a scraped gauge parses
    back BITWISE equal to the rollup float. Merge-safe across
    replicas: router-level families carry only the tenant label and
    are emitted by exactly one router; engine-level families
    (``tenant_replica_*``) carry a distinguishing ``replica`` label,
    so :func:`merge_expositions` passes every series through verbatim
    (never sums two sources into one key)."""
    from . import usage as _usage

    out = _Lines()
    t = PREFIX + "tenant_"
    if router is not None:
        tu = _usage.router_tenant_usage(router)
        for tenant, d in sorted(tu["tenants"].items()):
            lbl = {"tenant": str(tenant)}
            for key in ("weight", "weight_share", "served_tokens",
                        "share", "queued", "requests", "completed",
                        "cancelled", "rejected", "rate_holds",
                        "requeued", "preemptions", "prompt_tokens",
                        "decode_tokens"):
                out.add(t + key, "gauge", d.get(key, 0), lbl)
            for key in ("queue_ms", "ttft_ms", "tpot_ms", "e2e_ms"):
                for q in ("p50", "p99"):
                    v = d.get(f"{key}_{q}")
                    if v is not None:
                        out.add(t + key, "gauge", v,
                                {"tenant": str(tenant), "q": q})
    for i, eng in enumerate(engines or ()):
        try:
            eu = _usage.engine_tenant_usage(eng)
        except Exception:
            continue
        rep = str(eu.get("replica", i))
        rlbl = {"replica": rep}
        out.add(t + "replica_busy_ns", "gauge", eu["busy_ns"], rlbl)
        out.add(t + "replica_page_open", "gauge", eu["page_open"],
                rlbl)
        out.add(t + "replica_page_bytes", "gauge", eu["page_bytes"],
                rlbl)
        for tenant, d in sorted(eu["tenants"].items()):
            lbl = {"tenant": str(tenant), "replica": rep}
            for key in ("device_ns", "page_ns", "prompt_tokens",
                        "decode_tokens", "completed", "preemptions"):
                out.add(t + "replica_" + key, "gauge", d.get(key, 0),
                        lbl)
    return out.lines


def slo_engine_lines(evaluator):
    """The live SLO engine's truth (``obs.slo.SLOEvaluator``) as
    gauges: per-objective ``slo_burn_rate{objective=,window=}``,
    ``slo_budget_remaining{objective=}`` and
    ``slo_alert_active{objective=,severity=}``. Values are emitted in
    ``repr`` round-trip form like everything else here, so a scraped
    burn rate parses back BITWISE equal to the evaluator's float — the
    guarantee an alertmanager rule rests on."""
    out = _Lines()
    s = PREFIX + "slo_"
    for spec in evaluator.specs:
        obj = spec.name
        for label in evaluator.windows:
            v = evaluator.burn.get((obj, label))
            if v is None:
                continue
            out.add(s + "burn_rate", "gauge", v,
                    {"objective": obj, "window": label})
        rem = evaluator.budget_left.get(obj)
        if rem is not None:
            out.add(s + "budget_remaining", "gauge", rem,
                    {"objective": obj})
        out.add(s + "target", "gauge", spec.target,
                {"objective": obj})
    for st in evaluator._alerts.values():
        out.add(s + "alert_active", "gauge",
                1.0 if st["active"] else 0.0,
                {"objective": st["objective"],
                 "severity": st["severity"]})
    return out.lines


def prometheus_text(engines=None, run_dir=None, registry=None,
                    now=None, router=None, sources=None, slo=None):
    """The full exposition: registry + SLO gauges (+ router gauges,
    the live SLO engine's burn/budget gauges, and scraped-and-merged
    remote ``sources``, for a fleet front-end), newline-terminated
    Prometheus text format."""
    lines = registry_lines(registry) + slo_lines(engines, run_dir,
                                                 now=now)
    if router is not None:
        lines += router_lines(router)
    if router is not None or engines:
        # the per-tenant chargeback gauges: router-level shares/weights
        # when fronting a fleet, per-replica device/page integrals when
        # exporting engines (each worker's own exporter emits these, so
        # the router's scrape-and-merge carries them fleet-wide)
        lines += tenant_lines(router=router, engines=engines)
    if slo is not None:
        lines += slo_engine_lines(slo)
    if sources:
        texts = ["\n".join(lines) + "\n"]
        for target in sources:
            try:
                texts.append(scrape(target))
            except Exception:
                continue  # a restarting replica misses one scrape tick
        return merge_expositions(texts)
    return "\n".join(lines) + "\n"


def scrape(target, timeout=5.0):
    """Fetch one exposition: an ``http(s)://`` URL (a per-replica
    :class:`MetricsExporter`) or a textfile path — the two transports a
    multi-process serve fleet exports over."""
    t = str(target)
    if t.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(t, timeout=timeout) as resp:
            return resp.read().decode("utf-8")
    with open(t, encoding="utf-8") as f:
        return f.read()


def merge_expositions(texts):
    """Fuse N Prometheus expositions into one: ``# TYPE`` declared once
    per family (first seen wins), and samples with IDENTICAL keys
    (name + labels) SUMMED — correct for counters and histogram
    ``_bucket``/``_sum``/``_count`` series, and for additive gauges
    (queue depths, running counts); non-additive gauges must carry a
    distinguishing label, which the per-replica SLO gauges
    (``replica="N"``) and router gauges do. This is the router-side
    merge that extends the signal plane to OUT-of-process
    replicas (``live_engines()`` only ever saw this process's)."""
    types = {}        # family -> type
    order = []        # sample keys, first-seen order
    values = {}       # key -> summed float (or raw string passthrough)
    raw = {}          # key -> original value string (single source)
    counts = {}
    for text in texts:
        for line in text.splitlines():
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
            if not key:
                continue
            if key not in values:
                order.append(key)
                values[key] = 0.0
                counts[key] = 0
            try:
                values[key] += float(val)
            except ValueError:
                pass
            raw[key] = val
            counts[key] += 1
    out = _Lines()
    for key in order:
        family = key.split("{", 1)[0]
        if family not in types:
            # histogram samples carry suffixes; their TYPE is declared
            # on the base family (an exact-name match — e.g. the SLO
            # ``*_count`` gauges — always wins over the strip)
            for suffix in ("_bucket", "_sum", "_count"):
                if family.endswith(suffix) and \
                        family[:-len(suffix)] in types:
                    family = family[:-len(suffix)]
                    break
        if family in types and family not in out._declared:
            out._declared.add(family)
            out.raw(f"# TYPE {family} {types[family]}")
        if counts[key] == 1:
            # single source: pass the value through VERBATIM so the
            # merge is bitwise-lossless (the common per-replica case)
            out.raw(f"{key} {raw[key]}")
        else:
            out.raw(f"{key} {_fmt(values[key])}")
    return "\n".join(out.lines) + "\n"


def statusz_data(router=None, slo=None, engines=None, now=None):
    """The live fleet pane as plain data (the ``/statusz?format=json``
    body): fleet topology (replica id / state / incarnation from the
    pool), per-replica SLO table (the evaluator's cached last scrape,
    falling back to local engine stats — NO new HTTP calls on render),
    burn/budget/active alerts, and the router's recent scale/requeue
    events. Pull-only: rendered per GET, nothing on the serve path."""
    data = {"now": now, "fleet": [], "router": None, "slo": None,
            "events": [], "replica_slo": {}, "tenants": {},
            "fairness": None}
    pool = getattr(router, "pool", None)
    if pool is not None:
        data["fleet"] = pool.topology()
    if router is not None:
        st = router.stats()
        data["router"] = {k: st.get(k) for k in
                          ("queue_depth", "inflight", "dispatched",
                           "requeued", "rejected", "completed",
                           "replicas", "scale_ups", "scale_downs")}
        for key in ("ttft_ms", "tpot_ms", "e2e_ms"):
            if st.get(key):
                data["router"][key] = st[key]
        data["events"] = [dict(e) for e in
                          getattr(router, "recent_events", ())]
        # the tenant chargeback/fairness pane (obs.usage, pull-only)
        from . import usage as _usage

        tu = _usage.router_tenant_usage(router)
        data["tenants"] = tu["tenants"]
        data["fairness"] = _usage.fairness_audit(tu["tenants"])
    if slo is not None:
        s = slo.status()
        data["slo"] = s
        data["replica_slo"] = s.get("replica_slo") or {}
    if not data["replica_slo"] and engines:
        for i, eng in enumerate(engines):
            try:
                st = eng.stats()
            except Exception:
                continue
            rep = str(getattr(eng, "replica_id", i))
            row = {}
            for key in ("ttft_ms", "tpot_ms"):
                d = st.get(key) or {}
                for q in ("p50", "p99"):
                    if d.get(q) is not None:
                        row[f"{key[:-3]}_{q}_ms"] = d[q]
            if row:
                data["replica_slo"][rep] = row
    return data


def _esc(v):
    return (str(v).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def _td(v):
    if isinstance(v, float):
        return f"{v:.4g}"
    return "-" if v is None else _esc(v)


def _html_table(headers, rows):
    h = "".join(f"<th>{_esc(c)}</th>" for c in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{_td(c)}</td>" for c in row) + "</tr>"
        for row in rows)
    return f"<table><tr>{h}</tr>{body}</table>"


def render_statusz_html(data):
    """``/statusz`` as a dependency-free single HTML page: fleet
    topology, per-replica SLO table, per-objective burn/budget, active
    alerts, recent router events."""
    parts = ["<!DOCTYPE html><html><head><title>statusz</title>",
             "<style>body{font-family:monospace;margin:1em}",
             "table{border-collapse:collapse;margin:0.5em 0}",
             "td,th{border:1px solid #999;padding:2px 8px;",
             "text-align:right}th{background:#eee}",
             ".firing{color:#b00;font-weight:bold}</style>",
             "</head><body><h1>paddle_tpu fleet statusz</h1>"]
    slo = data.get("slo") or {}
    active = slo.get("active_alerts") or []
    if active:
        parts.append('<p class="firing">FIRING: ' + ", ".join(
            f'{_esc(a["objective"])} [{_esc(a["severity"])}]'
            for a in active) + "</p>")
    else:
        parts.append("<p>no active SLO alerts</p>")
    if data.get("fleet"):
        parts.append("<h2>fleet topology</h2>")
        parts.append(_html_table(
            ["replica", "state", "incarnation", "outstanding_tokens",
             "inflight"],
            [[r.get("replica"), r.get("state"), r.get("incarnation"),
              r.get("outstanding_tokens"), r.get("inflight")]
             for r in data["fleet"]]))
    if slo.get("objectives"):
        parts.append("<h2>SLO burn &amp; budget</h2>")
        windows = sorted(
            {w for o in slo["objectives"] for w in (o.get("burn")
                                                    or {})})
        parts.append(_html_table(
            ["objective", "target"] + [f"burn {w}" for w in windows]
            + ["budget remaining"],
            [[o.get("name"), o.get("target")]
             + [(o.get("burn") or {}).get(w) for w in windows]
             + [o.get("budget_remaining")]
             for o in slo["objectives"]]))
    if data.get("replica_slo"):
        keys = sorted({k for v in data["replica_slo"].values()
                       for k in v})
        parts.append("<h2>per-replica SLO</h2>")
        parts.append(_html_table(
            ["replica"] + keys,
            [[rep] + [vals.get(k) for k in keys]
             for rep, vals in sorted(data["replica_slo"].items())]))
    if data.get("tenants"):
        fair = data.get("fairness") or {}
        flag = "" if fair.get("ok", True) else \
            f' <span class="firing">DRIFT {fair.get("max_drift"):.3f}' \
            f' &gt; {fair.get("threshold"):.3f}' \
            f' ({_esc(fair.get("worst_tenant"))})</span>'
        parts.append(f"<h2>tenants</h2>{flag}" if flag
                     else "<h2>tenants</h2>")
        parts.append(_html_table(
            ["tenant", "weight", "weight_share", "share",
             "served_tokens", "queued", "completed", "rejected",
             "rate_holds", "requeued", "preemptions", "ttft_p99_ms",
             "e2e_p99_ms"],
            [[tname, d.get("weight"), d.get("weight_share"),
              d.get("share"), d.get("served_tokens"), d.get("queued"),
              d.get("completed"), d.get("rejected"),
              d.get("rate_holds"), d.get("requeued"),
              d.get("preemptions"), d.get("ttft_ms_p99"),
              d.get("e2e_ms_p99")]
             for tname, d in sorted(data["tenants"].items())]))
    if data.get("router"):
        r = data["router"]
        parts.append("<h2>router</h2>")
        parts.append(_html_table(
            sorted(k for k in r if not isinstance(r[k], dict)),
            [[r[k] for k in sorted(r) if not isinstance(r[k], dict)]]))
    if data.get("events"):
        parts.append("<h2>recent router events</h2>")
        parts.append(_html_table(
            ["t", "kind", "detail"],
            [[e.get("t"), e.get("kind"),
              "; ".join(f"{k}={v}" for k, v in sorted(e.items())
                        if k not in ("t", "kind"))]
             for e in data["events"]]))
    log = slo.get("alert_log") or []
    if log:
        parts.append("<h2>alert history</h2>")
        parts.append(_html_table(
            ["at", "kind", "objective", "severity", "burn_short",
             "burn_long", "worst_replica"],
            [[e.get("at"), e.get("kind"), e.get("objective"),
              e.get("severity"), e.get("burn_short"),
              e.get("burn_long"), e.get("worst_replica")]
             for e in log]))
    parts.append("</body></html>")
    return "".join(parts)


def write_textfile(path, engines=None, run_dir=None, registry=None,
                   router=None, sources=None, slo=None):
    """Atomic textfile export (node_exporter textfile-collector
    convention): write to a tmp sibling, fsync-free rename — a scraper
    reading mid-write sees the previous complete snapshot, never a torn
    one. Returns ``path``."""
    body = prometheus_text(engines=engines, run_dir=run_dir,
                           registry=registry, router=router,
                           sources=sources, slo=slo)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(body)
    os.replace(tmp, path)
    return path


def parse_prometheus_text(text):
    """``{metric-with-labels: float}`` from exposition text — the test
    and bench-side inverse of :func:`prometheus_text` (floats parse
    back exactly: values are emitted in ``repr`` round-trip form)."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        try:
            out[key] = float(val)
        except ValueError:
            pass
    return out


class MetricsExporter:
    """Serve :func:`prometheus_text` on ``GET /metrics`` over localhost
    HTTP (``port=0`` → ephemeral, read ``.port``/``.url`` after
    :meth:`start`). The handler renders on each scrape — pull-based, so
    an idle exporter costs nothing between scrapes. Also usable as a
    context manager, and as a handle for periodic
    :meth:`write_textfile` snapshots."""

    def __init__(self, engines=None, run_dir=None, host="127.0.0.1",
                 port=0, registry=None, router=None, sources=None,
                 slo=None):
        self.engines = None if engines is None else list(engines)
        self.run_dir = run_dir
        self.host = str(host)
        self.port = int(port)
        self.registry = registry
        # fleet front-end mode: a serving.fleet.Router's gauges, plus
        # remote per-replica exporters scraped-and-merged per render,
        # plus the live SLO engine's burn/budget gauges + /statusz
        self.router = router
        self.sources = None if sources is None else list(sources)
        self.slo = slo
        self._httpd = None
        self._thread = None

    def register_engine(self, engine):
        """Pin an explicit engine set (otherwise every live engine in
        the process is exported)."""
        if self.engines is None:
            self.engines = []
        self.engines.append(engine)

    def render(self):
        return prometheus_text(engines=self.engines,
                               run_dir=self.run_dir,
                               registry=self.registry,
                               router=self.router,
                               sources=self.sources,
                               slo=self.slo)

    def render_statusz(self, fmt="html"):
        """The /statusz body: live fleet topology + SLO pane (the
        pane a post-mortem fleet report only reconstructs).
        ``fmt="json"`` returns the machine-readable form."""
        import json as _json

        data = statusz_data(router=self.router, slo=self.slo,
                            engines=self.engines)
        if fmt == "json":
            return _json.dumps(data, default=str, indent=1)
        return render_statusz_html(data)

    def write_textfile(self, path):
        return write_textfile(path, engines=self.engines,
                              run_dir=self.run_dir,
                              registry=self.registry,
                              router=self.router,
                              sources=self.sources,
                              slo=self.slo)

    @property
    def url(self):
        return f"http://{self.host}:{self.port}/metrics"

    def start(self):
        """Bind + serve on a daemon thread; returns the bound port."""
        if self._httpd is not None:
            return self.port
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib handler contract)
                path, _, query = self.path.partition("?")
                if path == "/statusz":
                    fmt = "json" if "format=json" in query else "html"
                    ctype = ("application/json; charset=utf-8"
                             if fmt == "json"
                             else "text/html; charset=utf-8")
                    try:
                        body = exporter.render_statusz(fmt) \
                            .encode("utf-8")
                    except Exception as e:
                        self.send_error(500,
                                        f"{type(e).__name__}: {e}")
                        return
                elif path in ("/metrics", "/"):
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                    try:
                        body = exporter.render().encode("utf-8")
                    except Exception as e:  # surface, don't kill
                        self.send_error(500,
                                        f"{type(e).__name__}: {e}")
                        return
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not stdout news
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          Handler)
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="pt-metrics-exporter", daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
