"""SLO-aware autoscaling: queue-depth + TTFT/TPOT signals -> replica
count decisions.

The decision layer between the live signal plane and the pool: the
:class:`Autoscaler` consumes the SAME Prometheus exposition a human's
dashboard scrapes (``obs.export`` — router gauges, per-replica
``serving_slo_*``), via :meth:`Autoscaler.signals_from_scrape`, and
answers one question per observation: scale up, scale down, or hold.

Discipline (each rule pinned by tests/test_serve_fleet.py on synthetic
SLO series under a ManualClock):

- **Hysteresis, not hair-trigger.** A breach (router queue depth over
  ``queue_high``, or TTFT/TPOT p99 over its SLO) must persist for
  ``breach_patience`` CONSECUTIVE observations before a scale-up; a
  quiet fleet (queue at/below ``queue_low``, SLOs met) must persist
  for ``low_patience`` observations before a scale-down. One noisy
  scrape never moves the fleet.
- **Cooldown.** After any decision, ``cooldown_s`` of clock time must
  pass before the next — scale-up takes effect only after the new
  replica warms, and reacting to the pre-warm signal again would
  double-scale.
- **Bounds.** Never below ``min_replicas`` or above ``max_replicas``.
- **Scale-down drains.** The autoscaler only *decides*; the router
  picks the least-loaded replica and ``drain()``s it — in-flight
  decodes finish where they are, the replica retires empty. Nothing is
  killed mid-decode for capacity reasons.
"""
from __future__ import annotations

import re
import time

__all__ = ["Autoscaler", "per_replica_slo_from_scrape"]

# exposition keys (obs.export naming): one place, shared with the
# signal parser's regexes below
_QUEUE_KEY = "paddle_tpu_fleet_router_queue_depth"
_SLO_RE = re.compile(
    r"^paddle_tpu_serving_slo_(ttft|tpot)_ms\{"
    r"(?=[^}]*\breplica=\"(?P<rep>[^\"]*)\")"
    r"(?=[^}]*\bq=\"(?P<q>p\d+)\")[^}]*\}$")
_RUNNING_RE = re.compile(
    r"^paddle_tpu_serving_slo_running\{[^}]*\breplica=\"([^\"]*)\"")
_ENGINE_QUEUE_RE = re.compile(
    r"^paddle_tpu_serving_slo_queue_depth\{")


def per_replica_slo_from_scrape(text):
    """Per-replica SLO latencies from the same exposition
    :meth:`Autoscaler.signals_from_scrape` reads, UNpooled:
    ``{replica: {"ttft_p99_ms": v, "tpot_p50_ms": v, ...}}``. The
    attribution complement of the autoscaler's worst-of signal — the
    SLO evaluator's worst-offender lookup and the /statusz per-replica
    table both read this."""
    from ...obs.export import parse_prometheus_text

    vals = text if isinstance(text, dict) \
        else parse_prometheus_text(text)
    out = {}
    for key, v in vals.items():
        m = _SLO_RE.match(key)
        if not m:
            continue
        rep = m.group("rep")
        out.setdefault(rep, {})[
            f"{m.group(1)}_{m.group('q')}_ms"] = v
    return out


class Autoscaler:
    """Deterministic scale decisions over scraped SLO signals."""

    def __init__(self, min_replicas=1, max_replicas=4, *,
                 queue_high=8.0, queue_low=1.0, ttft_p99_slo_ms=None,
                 tpot_p99_slo_ms=None, breach_patience=2,
                 low_patience=4, cooldown_s=30.0, clock=None):
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        if self.min_replicas < 1 or \
                self.max_replicas < self.min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.ttft_p99_slo_ms = ttft_p99_slo_ms
        self.tpot_p99_slo_ms = tpot_p99_slo_ms
        self.breach_patience = int(breach_patience)
        self.low_patience = int(low_patience)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock if clock is not None else time.monotonic
        self._breaches = 0
        self._lows = 0
        self._last_decision_t = None
        self.decisions = []   # [(t, "up"/"down", reason)] — the trace

    # -- signal extraction ---------------------------------------------------
    @staticmethod
    def signals_from_scrape(text):
        """Autoscaler inputs from a Prometheus exposition (text or an
        already-parsed ``parse_prometheus_text`` dict): router queue
        depth (falling back to the per-replica engine queue gauges
        summed), worst per-replica TTFT/TPOT p99, and the replica count
        visible in the scrape."""
        from ...obs.export import parse_prometheus_text

        vals = text if isinstance(text, dict) \
            else parse_prometheus_text(text)
        sig = {}
        replicas = set()
        engine_queue = 0.0
        saw_engine_queue = False
        for key, v in vals.items():
            if key == _QUEUE_KEY:
                sig["queue_depth"] = v
                continue
            m = _SLO_RE.match(key)
            if m and m.group("q") == "p99":
                k = f"{m.group(1)}_p99_ms"
                sig[k] = max(sig.get(k, 0.0), v)
                continue
            m = _RUNNING_RE.match(key)
            if m:
                replicas.add(m.group(1))
                continue
            if _ENGINE_QUEUE_RE.match(key):
                engine_queue += v
                saw_engine_queue = True
        if "queue_depth" not in sig and saw_engine_queue:
            sig["queue_depth"] = engine_queue
        if replicas:
            sig["replicas"] = len(replicas)
        return sig

    # -- the decision --------------------------------------------------------
    def _breached(self, sig):
        if sig.get("queue_depth", 0.0) > self.queue_high:
            return f"queue_depth {sig['queue_depth']:g} > " \
                   f"{self.queue_high:g}"
        for name, slo in (("ttft", self.ttft_p99_slo_ms),
                          ("tpot", self.tpot_p99_slo_ms)):
            if slo is None:
                continue
            v = sig.get(f"{name}_p99_ms")
            if v is not None and v > float(slo):
                return f"{name}_p99 {v:g}ms > SLO {float(slo):g}ms"
        return None

    def _low(self, sig):
        if sig.get("queue_depth", 0.0) > self.queue_low:
            return False
        for name, slo in (("ttft", self.ttft_p99_slo_ms),
                          ("tpot", self.tpot_p99_slo_ms)):
            if slo is None:
                continue
            v = sig.get(f"{name}_p99_ms")
            if v is not None and v > float(slo):
                return False
        return True

    def observe(self, signals, replicas=None, now=None,
                max_replicas=None):
        """One observation -> ``"up"`` / ``"down"`` / ``None``.
        ``signals`` is a :meth:`signals_from_scrape` dict (or any dict
        with ``queue_depth`` / ``*_p99_ms``); ``replicas`` overrides
        the scrape-visible replica count with pool truth.
        ``max_replicas`` tightens the up-bound for THIS observation
        (the router passes the pool's remaining capacity, which counts
        STARTING/DRAINING replicas and backoff-pending relaunches the
        active count misses) — clamping inside the decision keeps a
        can't-scale observation from committing an "up": no cooldown
        burned, no breach streak reset, no phantom decisions entry."""
        now = self.clock() if now is None else now
        n = int(replicas if replicas is not None
                else signals.get("replicas", self.min_replicas))
        cap = self.max_replicas if max_replicas is None \
            else min(self.max_replicas, int(max_replicas))
        breach = self._breached(signals)
        if breach:
            self._breaches += 1
            self._lows = 0
        elif self._low(signals):
            self._lows += 1
            self._breaches = 0
        else:
            self._breaches = 0
            self._lows = 0
        if self._last_decision_t is not None and \
                now - self._last_decision_t < self.cooldown_s:
            return None
        if breach and self._breaches >= self.breach_patience and \
                n < cap:
            self._breaches = 0
            self._lows = 0
            self._last_decision_t = now
            self.decisions.append((now, "up", breach))
            return "up"
        if self._lows >= self.low_patience and n > self.min_replicas:
            self._lows = 0
            self._last_decision_t = now
            self.decisions.append((now, "down", "idle"))
            return "down"
        return None
