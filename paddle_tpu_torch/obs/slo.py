"""Declarative serving SLOs: error budgets, burn rates, and
multi-window multi-burn-rate alerting.

The windowing layer (``obs.timeseries``) answers "what happened over
the last N minutes"; this module answers the production question on
top of it: *are we currently violating our SLO, how fast are we
burning error budget, and which replica is responsible* — the signal
canary scoring depends on, and the serving-SLO framing of serving
comparisons treats as
the primary serving metric alongside the TTFT/TPOT decomposition.

Shape (Google SRE workbook, chapter 5, scaled to serve-fleet windows):

- An :class:`SLOSpec` declares one objective: a latency target
  ("99% of requests first-token within 250 ms"), an availability
  floor (``1 - rejects/requests >= 0.999``), or a goodput floor
  (tokens/s). The error budget is ``1 - target``.
- Each evaluation tick, the bad-event fraction over a window divided
  by the budget is that window's **burn rate**: burning at 1x spends
  exactly the budget over the budget period; 14.4x exhausts it ~14x
  early. An alert condition needs BOTH a long window (evidence) and a
  short window (fast clear) over the threshold: the fast page is
  burn >= 14.4 over 5m AND 30m, the slow warn burn >= 6 over 30m AND
  3h (:data:`DEFAULT_POLICIES`).
- Alerts latch: one ``slo.fire`` when the condition becomes true, one
  ``slo.clear`` when it stops — never a refire while latched. Both
  are ACTIVE-guarded journal events carrying per-replica attribution
  (the worst offender parsed from the same per-replica scrape the
  autoscaler reads), and tick ``slo.fire``/``slo.clear`` counters.

Everything is clock-injectable and caller-driven: the Router feeds
:meth:`SLOEvaluator.observe` from its EXISTING throttled autoscale
exposition (zero additional HTTP calls), tests feed hand-built
snapshots under a ManualClock and assert exact fire/clear instants.
With no evaluator installed nothing here runs — the zero-overhead
poison test pins that.

:func:`evaluate_run` is the post-hoc twin: the same spec evaluated
against a finished run dir's journal (post-hoc SLO reports and bench
exit gates).
"""
from __future__ import annotations

import json
import os
import time

from . import journal as _journal
from . import metrics as _metrics
from . import timeseries as _timeseries
from .timeseries import WINDOWS

__all__ = [
    "SLOSpec", "AlertPolicy", "DEFAULT_POLICIES", "SLOEvaluator",
    "specs_from_dict", "parse_spec_arg", "evaluate_run", "load_any",
]


class SLOSpec:
    """One declarative objective.

    ``kind`` selects the math:

    - ``"latency"``: fraction of requests with ``metric`` (a latency
      histogram, ms) at or under ``threshold_ms`` must be >= ``target``
      (bad fraction = windowed fraction above the threshold).
    - ``"availability"``: ``1 - bad/total`` must be >= ``target``
      (bad/total are counter deltas — router rejects over submits).
    - ``"goodput"``: the windowed token rate must stay >= ``floor``
      tokens/s (binary bad fraction; budget still ``1 - target``).
    """

    KINDS = ("latency", "availability", "goodput")

    def __init__(self, name, kind, target=0.99, threshold_ms=None,
                 floor=None, metric=None, bad_metric=None,
                 good_metric=None):
        if kind not in self.KINDS:
            raise ValueError(f"unknown SLO kind {kind!r} "
                             f"(one of {self.KINDS})")
        self.name = str(name)
        self.kind = kind
        self.target = float(target)
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"SLO target must be in (0, 1), got {self.target!r} "
                f"for {name!r} — a target of 1.0 has zero error budget")
        if kind == "latency" and threshold_ms is None:
            raise ValueError(f"latency SLO {name!r} needs threshold_ms")
        if kind == "goodput" and floor is None:
            raise ValueError(f"goodput SLO {name!r} needs floor")
        self.threshold_ms = None if threshold_ms is None \
            else float(threshold_ms)
        self.floor = None if floor is None else float(floor)
        # candidate series names, registry-form first then the
        # exposition (scraped fleet) form — the store holds whichever
        # side of the process boundary fed it
        if kind == "latency":
            base = metric or ("serving.ttft_ms" if "ttft" in self.name
                              else "serving.tpot_ms")
            self.metrics = (base, "paddle_tpu_" +
                            base.replace(".", "_"))
        elif kind == "availability":
            bad = bad_metric or "serving.router.rejected"
            good = good_metric or "serving.router.dispatched"
            self.bad_metrics = (bad, "paddle_tpu_fleet_router_rejected")
            self.good_metrics = (good,
                                 "paddle_tpu_fleet_router_dispatched")
        else:
            base = metric or "serving.tokens_generated"
            self.metrics = (base, "paddle_tpu_" +
                            base.replace(".", "_"))

    @property
    def budget(self):
        """Error budget: the allowed bad-event fraction."""
        return 1.0 - self.target

    def describe(self):
        d = {"name": self.name, "kind": self.kind,
             "target": self.target}
        if self.threshold_ms is not None:
            d["threshold_ms"] = self.threshold_ms
        if self.floor is not None:
            d["floor"] = self.floor
        return d

    def __repr__(self):
        return f"SLOSpec({self.name!r}, {self.kind!r}, " \
               f"target={self.target})"


class AlertPolicy:
    """One multi-window burn-rate condition: fire when burn over BOTH
    the short and the long window is >= ``burn`` (short = fast clear,
    long = evidence); clear when either drops below."""

    def __init__(self, severity, short, long, burn):
        self.severity = str(severity)
        self.short = str(short)    # WINDOWS label, e.g. "5m"
        self.long = str(long)
        self.burn = float(burn)
        if WINDOWS[self.short] >= WINDOWS[self.long]:
            raise ValueError("short window must be < long window")

    def __repr__(self):
        return (f"AlertPolicy({self.severity!r}, {self.short}+"
                f"{self.long}, burn>={self.burn:g})")


# the SRE-workbook ladder scaled to serve-fleet windows:
# fast page at 14.4x over 5m+30m, slow warn at 6x over 30m+3h
DEFAULT_POLICIES = (AlertPolicy("page", "5m", "30m", 14.4),
                    AlertPolicy("warn", "30m", "3h", 6.0))


def specs_from_dict(d):
    """``SLOSpec`` list from the flat JSON objective form shared by
    ``serve_bench --slo`` and ``slo_report --spec``::

        {"ttft_p99_ms": 250, "tpot_p99_ms": 20,
         "availability": 0.999, "goodput_tps": 100}

    Latency keys take the threshold in ms (target 0.99 from the p99
    framing, or a ``{"threshold_ms": .., "target": ..}`` dict);
    ``availability`` takes the target fraction; ``goodput_tps`` the
    floor in tokens/s (target 0.99 of evaluation windows unless given
    as a dict)."""
    specs = []
    for key, val in dict(d).items():
        cfg = dict(val) if isinstance(val, dict) else {}
        if key in ("ttft_p99_ms", "tpot_p99_ms"):
            thr = cfg.pop("threshold_ms", None if cfg else val)
            specs.append(SLOSpec(key, "latency", threshold_ms=thr,
                                 target=cfg.pop("target", 0.99),
                                 **cfg))
        elif key == "availability":
            tgt = cfg.pop("target", None if cfg else val)
            specs.append(SLOSpec(key, "availability", target=tgt,
                                 **cfg))
        elif key == "goodput_tps":
            floor = cfg.pop("floor", None if cfg else val)
            specs.append(SLOSpec(key, "goodput", floor=floor,
                                 target=cfg.pop("target", 0.99),
                                 **cfg))
        else:
            raise KeyError(
                f"unknown SLO objective {key!r} (known: ttft_p99_ms, "
                "tpot_p99_ms, availability, goodput_tps)")
    return specs


def parse_spec_arg(arg):
    """CLI spec loader: inline JSON, or ``@path``/path to a JSON
    file."""
    s = str(arg).strip()
    if s.startswith("@"):
        s = s[1:]
    if not s.startswith("{") and os.path.exists(s):
        with open(s, encoding="utf-8") as f:
            s = f.read()
    return specs_from_dict(json.loads(s))


class SLOEvaluator:
    """Live windowed SLO evaluation + latched burn-rate alerting.

    Feed it one merged exposition (and/or the in-process registry) per
    tick via :meth:`observe`; read burn/budget gauges back through
    ``obs.export.slo_engine_lines`` (bitwise: the scraped gauge parses
    back equal to :meth:`burn_rate`'s float) and the live pane through
    :meth:`status` (the /statusz JSON).
    """

    def __init__(self, specs, clock=None, policies=None, store=None,
                 interval_s=None, include_registry=True, registry=None,
                 anomaly_engine=None):
        if isinstance(specs, dict):
            specs = specs_from_dict(specs)
        self.specs = list(specs)
        if not self.specs:
            raise ValueError("SLOEvaluator needs at least one SLOSpec")
        self.clock = clock if clock is not None else time.monotonic
        self.policies = tuple(policies if policies is not None
                              else DEFAULT_POLICIES)
        horizon = max(WINDOWS[p.long] for p in self.policies) * 2
        self.store = store if store is not None else \
            _timeseries.SeriesStore(
                interval_s=interval_s if interval_s is not None
                else 1.0, horizon_s=horizon, clock=self.clock)
        self.include_registry = bool(include_registry)
        self.registry = registry
        self.anomaly_engine = anomaly_engine
        # burn labels to compute: the policy windows plus the 1m pane
        labels = {"1m"}
        for p in self.policies:
            labels.add(p.short)
            labels.add(p.long)
        self.windows = tuple(sorted(labels, key=lambda w: WINDOWS[w]))
        self.burn = {}           # (objective, label) -> float|None
        self.budget_left = {}    # objective -> float|None
        self.replica_slo = {}    # replica -> {metric_qXX_ms: value}
        self._alerts = {}        # (objective, severity) -> state dict
        for spec in self.specs:
            for pol in self.policies:
                self._alerts[(spec.name, pol.severity)] = {
                    "objective": spec.name, "severity": pol.severity,
                    "active": False, "since": None, "fires": 0,
                    "clears": 0}
        self.alert_log = []      # bounded fire/clear history
        self._log_cap = 256
        self.ticks = 0
        self.last_t = None

    # -- signal math ---------------------------------------------------------
    def _first_series(self, names):
        for n in names:
            if self.store.kind(n) is not None:
                return n
        return None

    def bad_fraction(self, spec, window_s, now=None):
        """The windowed bad-event fraction for one objective, or None
        when the store holds no signal for it yet."""
        if spec.kind == "latency":
            name = self._first_series(spec.metrics)
            if name is None:
                return None
            bt = self.store.fraction_above(name, spec.threshold_ms,
                                           window_s, now=now)
            if bt is None:
                return None
            bad, total = bt
            return (bad / total) if total > 0 else 0.0
        if spec.kind == "availability":
            bad_name = self._first_series(spec.bad_metrics)
            good_name = self._first_series(spec.good_metrics)
            if bad_name is None or good_name is None:
                return None
            bad = self.store.counter_delta(bad_name, window_s, now=now)
            good = self.store.counter_delta(good_name, window_s,
                                            now=now)
            if bad is None or good is None:
                return None
            total = bad + good
            return (bad / total) if total > 0 else 0.0
        # goodput: binary — the window's token rate under the floor
        name = self._first_series(spec.metrics)
        if name is None:
            return None
        rate = self.store.counter_rate(name, window_s, now=now)
        if rate is None:
            return None
        return 1.0 if rate < spec.floor else 0.0

    def burn_rate(self, objective, window, now=None):
        """Burn over one window label ("5m"): bad fraction divided by
        the error budget (1.0 = spending exactly the budget). None
        without signal. Recomputed fresh so tests can probe arbitrary
        instants; :meth:`observe` caches the per-tick values in
        ``self.burn``."""
        spec = self._spec(objective)
        frac = self.bad_fraction(spec, WINDOWS[window], now=now)
        if frac is None:
            return None
        return frac / spec.budget

    def budget_remaining(self, objective, now=None):
        """1 - (budget consumed over the evaluator's full retained
        history); negative when overspent. None without signal."""
        spec = self._spec(objective)
        frac = self.bad_fraction(spec, float("inf"), now=now)
        if frac is None:
            return None
        return 1.0 - frac / spec.budget

    def _spec(self, objective):
        for s in self.specs:
            if s.name == objective:
                return s
        raise KeyError(f"unknown objective {objective!r}")

    # -- the tick ------------------------------------------------------------
    def observe(self, text=None, registry=None, now=None, extra=None):
        """One evaluation tick: snapshot the inputs into the store,
        recompute burn/budget, run the alert state machines (journal
        ``slo.fire``/``slo.clear``, tick ``slo.*`` counters), feed the
        serving anomaly detectors. ``extra`` (a dict) is folded into
        the anomaly record verbatim — the router's per-tenant fairness
        fields (``obs.usage.fairness_record``) ride the same tick the
        latency detectors read. Returns the alert transitions
        (``slo.fire``/``slo.clear`` dicts) of this tick."""
        now = self.clock() if now is None else float(now)
        snap = {}
        if self.include_registry or registry is not None:
            snap.update(_timeseries.registry_snapshot(
                registry if registry is not None else self.registry))
        if text is not None:
            if isinstance(text, dict):
                snap.update(text)
            else:
                snap.update(_timeseries.exposition_snapshot(text))
                self._note_replicas(text)
        self.store.observe(snap, now=now)
        self.ticks += 1
        self.last_t = now
        _metrics.counter("slo.ticks").inc()

        for spec in self.specs:
            for label in self.windows:
                self.burn[(spec.name, label)] = \
                    self.burn_rate(spec.name, label, now=now)
            self.budget_left[spec.name] = \
                self.budget_remaining(spec.name, now=now)

        transitions = []
        for spec in self.specs:
            for pol in self.policies:
                transitions.extend(
                    self._drive_alert(spec, pol, now))
        self._observe_anomalies(now, extra=extra)
        return transitions

    def _drive_alert(self, spec, pol, now):
        st = self._alerts[(spec.name, pol.severity)]
        bs = self.burn.get((spec.name, pol.short))
        bl = self.burn.get((spec.name, pol.long))
        firing = bs is not None and bl is not None and \
            bs >= pol.burn and bl >= pol.burn
        out = []
        if firing and not st["active"]:
            st["active"] = True
            st["since"] = now
            st["fires"] += 1
            worst, worst_value = self._worst_offender(spec)
            rec = {"at": now, "kind": "slo.fire",
                   "objective": spec.name, "severity": pol.severity,
                   "burn_short": bs, "burn_long": bl,
                   "window_short": pol.short, "window_long": pol.long,
                   "threshold": pol.burn, "worst_replica": worst,
                   "worst_value": worst_value}
            self._log(rec)
            out.append(rec)
            _metrics.counter("slo.fire").inc()
            if _journal.ACTIVE is not None:
                _journal.ACTIVE.event(
                    "slo.fire", at=now, objective=spec.name,
                    severity=pol.severity, burn_short=bs, burn_long=bl,
                    window_short=pol.short, window_long=pol.long,
                    threshold=pol.burn, worst_replica=worst,
                    worst_value=worst_value,
                    budget_remaining=self.budget_left.get(spec.name))
        elif st["active"] and not firing:
            st["active"] = False
            st["clears"] += 1
            rec = {"at": now, "kind": "slo.clear",
                   "objective": spec.name, "severity": pol.severity,
                   "burn_short": bs, "burn_long": bl,
                   "window_short": pol.short, "window_long": pol.long,
                   "threshold": pol.burn,
                   "since": st["since"]}
            st["since"] = None
            self._log(rec)
            out.append(rec)
            _metrics.counter("slo.clear").inc()
            if _journal.ACTIVE is not None:
                _journal.ACTIVE.event(
                    "slo.clear", at=now, objective=spec.name,
                    severity=pol.severity, burn_short=bs, burn_long=bl,
                    window_short=pol.short, window_long=pol.long,
                    threshold=pol.burn,
                    budget_remaining=self.budget_left.get(spec.name))
        return out

    def _log(self, rec):
        if len(self.alert_log) < self._log_cap:
            self.alert_log.append(rec)

    def _note_replicas(self, text):
        """Cache the per-replica SLO gauges from the tick's scrape
        (the attribution table statusz renders and the worst-offender
        lookup reads) — same signal surface as the autoscaler's
        ``signals_from_scrape``."""
        from ..serving.fleet.autoscale import per_replica_slo_from_scrape

        try:
            per = per_replica_slo_from_scrape(text)
        except Exception:
            return
        if per:
            self.replica_slo = per

    def _worst_offender(self, spec):
        """Worst replica for a latency objective: the argmax of the
        per-replica p99 gauge from the last scrape (pooled fleet
        percentiles don't attribute — the per-replica scrape does).
        None for fleet-scoped objectives (availability/goodput)."""
        if spec.kind != "latency" or not self.replica_slo:
            return None, None
        key = "ttft_p99_ms" if "ttft" in spec.name else "tpot_p99_ms"
        worst, worst_value = None, None
        for rep, vals in sorted(self.replica_slo.items()):
            v = vals.get(key)
            if v is None:
                continue
            if worst_value is None or v > worst_value:
                worst, worst_value = rep, v
        return worst, worst_value

    def _observe_anomalies(self, now, extra=None):
        """Feed the serving anomaly detectors one windowed record:
        TTFT p99 over the 1m pane, the per-token latency implied by
        the 1m token rate (``throughput_drop``'s serving signal), and
        any caller-supplied ``extra`` fields (``tenant_hog``'s
        fairness signal)."""
        if self.anomaly_engine is None:
            return
        rec = {"step": self.ticks}
        if extra:
            rec.update(extra)
        for spec in self.specs:
            if spec.kind != "latency":
                continue
            name = self._first_series(spec.metrics)
            if name is None:
                continue
            p99 = self.store.percentile(name, 99, WINDOWS["1m"],
                                        now=now)
            if p99 is not None and "ttft" in spec.name:
                rec["ttft_ms"] = p99
        for spec in self.specs:
            if spec.kind != "goodput":
                continue
            name = self._first_series(spec.metrics)
            if name is None:
                continue
            rate = self.store.counter_rate(name, WINDOWS["1m"],
                                           now=now)
            if rate and rate > 0:
                rec["step_ms"] = 1e3 / rate
        if len(rec) <= 1:
            return
        for fired in self.anomaly_engine.observe(rec):
            if _journal.ACTIVE is not None:
                _journal.ACTIVE.event("anomaly.serving",
                                      name=fired["name"], at=now,
                                      detail=fired["detail"])

    # -- introspection -------------------------------------------------------
    def active_alerts(self):
        return [dict(st) for st in self._alerts.values()
                if st["active"]]

    def status(self):
        """The live SLO pane as plain data (the /statusz JSON body's
        ``slo`` section)."""
        objectives = []
        for spec in self.specs:
            objectives.append({
                **spec.describe(),
                "burn": {label: self.burn.get((spec.name, label))
                         for label in self.windows},
                "budget_remaining": self.budget_left.get(spec.name),
                "alerts": [
                    {"severity": pol.severity,
                     "active": self._alerts[(spec.name,
                                             pol.severity)]["active"],
                     "since": self._alerts[(spec.name,
                                            pol.severity)]["since"],
                     "burn_threshold": pol.burn,
                     "windows": f"{pol.short}+{pol.long}"}
                    for pol in self.policies],
            })
        return {"last_t": self.last_t, "ticks": self.ticks,
                "objectives": objectives,
                "active_alerts": self.active_alerts(),
                "replica_slo": {str(k): dict(v) for k, v in
                                sorted(self.replica_slo.items())},
                "alert_log": list(self.alert_log)}

    def journal_summary(self):
        """One ``slo.summary`` event with the final per-objective
        truth (fires/clears/budget) — the record ``tools/
        slo_report.py`` renders; last wins."""
        if _journal.ACTIVE is None:
            return
        per = {}
        for spec in self.specs:
            fires = sum(self._alerts[(spec.name, p.severity)]["fires"]
                        for p in self.policies)
            clears = sum(
                self._alerts[(spec.name, p.severity)]["clears"]
                for p in self.policies)
            per[spec.name] = {
                "budget_remaining": self.budget_left.get(spec.name),
                "fires": fires, "clears": clears,
                "burn_5m": self.burn.get((spec.name, "5m"))}
        _journal.ACTIVE.event("slo.summary", ticks=self.ticks,
                              objectives=per)


# -- post-hoc evaluation ------------------------------------------------------


def load_any(run_dir):
    """Pool every journal under ``run_dir`` (top-level single-engine,
    ``router/``, ``rank_NN/``) into one ``{requests, events}`` view —
    the loader shared by :func:`evaluate_run` and
    ``tools/slo_report.py`` so single-engine bench runs and routed
    fleet runs evaluate identically."""
    from . import fleet as _fleet

    run_dir = str(run_dir)
    requests, events, runs = [], [], []
    top = os.path.join(run_dir, _journal.JOURNAL_FILE)
    if os.path.isfile(top):
        runs.append(_fleet.load_journal(run_dir))
    rd = _fleet.router_dir(run_dir)
    if rd:
        runs.append(_fleet.load_journal(rd))
    for _rank, path in sorted(_fleet.rank_dirs(run_dir).items()):
        runs.append(_fleet.load_journal(path))
    if not runs:
        raise FileNotFoundError(
            f"no journals under {run_dir!r} (looked for "
            f"{_journal.JOURNAL_FILE}, router/, rank_NN/)")
    for run in runs:
        requests += run.get("requests") or []
        events += run.get("events") or []
    return {"run_dir": run_dir, "requests": requests,
            "events": events, "runs": runs}


def evaluate_run(run_dir, specs, duration_s=None):
    """Evaluate a finished run's journal against the spec: exact
    nearest-rank percentiles over the pooled per-request records
    (``fleet.request_summary`` — per-replica percentiles don't
    average), availability from reject events over submits, goodput
    from output tokens over the serving-clock span (or an explicit
    ``duration_s``). Returns ``{"objectives": [...], "violations":
    [names], "summary": ...}`` — an objective without signal reports
    ``ok=None`` and does NOT count as a violation."""
    from . import fleet as _fleet

    if isinstance(specs, dict):
        specs = specs_from_dict(specs)
    pooled = run_dir if isinstance(run_dir, dict) else \
        load_any(run_dir)
    summary = _fleet.request_summary(
        {"requests": pooled["requests"]})
    events = pooled["events"]
    rejects = sum(1 for e in events
                  if e.get("kind") == "router.reject")
    requests = len(pooled["requests"])
    tokens = sum(int(r.get("output_tokens") or 0)
                 for r in pooled["requests"])
    if duration_s is None:
        arr = [r["arrival_t"] for r in pooled["requests"]
               if isinstance(r.get("arrival_t"), (int, float))]
        fin = [r["finish_t"] for r in pooled["requests"]
               if isinstance(r.get("finish_t"), (int, float))]
        if arr and fin and max(fin) > min(arr):
            duration_s = max(fin) - min(arr)

    objectives, violations = [], []
    for spec in specs:
        row = spec.describe()
        value, ok = None, None
        if spec.kind == "latency":
            key = ("ttft_ms_p99" if "ttft" in spec.name
                   else "tpot_ms_p99")
            value = (summary or {}).get(key)
            if value is not None:
                ok = value <= spec.threshold_ms
        elif spec.kind == "availability":
            total = requests + rejects
            if total > 0:
                value = 1.0 - rejects / total
                ok = value >= spec.target
        else:  # goodput
            if duration_s and duration_s > 0 and tokens:
                value = tokens / duration_s
                ok = value >= spec.floor
        row["value"] = value
        row["ok"] = ok
        objectives.append(row)
        if ok is False:
            violations.append(spec.name)
    return {"objectives": objectives, "violations": violations,
            "summary": summary,
            "rejects": rejects, "requests": requests,
            "output_tokens": tokens, "duration_s": duration_s}
