"""SLO engine: declarative objectives + multi-window burn-rate alerts.

The port of the JAX package's module (host Python over the port's
registry and health engine).

Health verdicts (:mod:`.health`) are instantaneous — a chunk was slow,
recall dipped *now*.  An SLO is the production framing: an objective
("99% of chunks dispatch without a retry", "canary recall stays above
0.7") with an **error budget** (the tolerated 1%), and alerting on the
**burn rate** — how fast the budget is being consumed — over two
windows at once, per the standard multi-window practice: the *fast*
window catches a cliff within seconds-to-minutes, the *slow* window
confirms it is sustained, and requiring BOTH suppresses the one-bad-
sample page.  A burn rate of 1 consumes exactly the budget over the
budget window; 14.4 exhausts a 30-day budget in 2 days (scaled here to
survey-run magnitudes).

:class:`SLOSpec` declares an objective over the metric time-series
(:mod:`.timeseries`):

* ``kind="ratio"`` — a bad-events / total-events pair of counter
  series (rates per point); bad fraction over a window is the
  rate-weighted ratio;
* ``kind="threshold"`` — one series/field sampled per point (a gauge
  value, a histogram p95) against a bound; the bad fraction is the
  fraction of window samples in breach.

:class:`SLOEngine` evaluates every spec per time-series point, raises
:class:`Alert` objects when both windows of a rule burn past its
threshold, feeds them into a :class:`~.health.HealthEngine` as
``slo:<name>`` conditions (page → CRITICAL, ticket → DEGRADED,
resolved when the burn stops), serves ``/alerts``
(:mod:`.server`), and logs the one-line ``ALERTS_JSON`` footer.  All
of it is read-only over telemetry: science bytes cannot move.
"""

from __future__ import annotations

import json
import threading

from . import metrics as _metrics
from .health import CRITICAL, DEGRADED

__all__ = ["ALERTS_SCHEMA_VERSION", "Alert", "SLOSpec", "SLOEngine",
           "default_slos"]

ALERTS_SCHEMA_VERSION = 1

#: default multi-window burn rules, scaled to survey-run magnitudes
#: (a bench/CI run lives minutes, not months): (fast_s, slow_s,
#: burn threshold, severity).  Both windows must burn past the
#: threshold for the rule to fire.
DEFAULT_WINDOWS = ((30.0, 120.0, 14.4, "page"),
                   (120.0, 600.0, 6.0, "ticket"))


class SLOSpec:
    """One declarative objective over the metric time-series.

    ``objective`` is the good fraction target (0.99 = 1% error
    budget).  For ``kind="ratio"``: ``bad`` / ``total`` name counter
    series whose per-point ``rate`` fields weigh the bad fraction.
    For ``kind="threshold"``: ``series``/``field`` select one value
    per point and ``bound``/``op`` define a breach (``op="<="`` means
    values must stay <= bound; ``">="`` must stay >= bound).
    ``windows`` overrides :data:`DEFAULT_WINDOWS`;
    ``budget_window_s`` is the horizon "budget remaining" is quoted
    over.
    """

    def __init__(self, name, *, objective, kind, description="",
                 bad=None, total=None, series=None, field="value",
                 bound=None, op="<=", windows=DEFAULT_WINDOWS,
                 budget_window_s=600.0):
        if kind not in ("ratio", "threshold"):
            raise ValueError(f"SLO {name}: kind={kind!r}")
        if kind == "ratio" and not (bad and total):
            raise ValueError(f"SLO {name}: ratio needs bad= and total=")
        if kind == "threshold" and (series is None or bound is None):
            raise ValueError(
                f"SLO {name}: threshold needs series= and bound=")
        if op not in ("<=", ">="):
            raise ValueError(f"SLO {name}: op={op!r}")
        if not 0.0 < float(objective) < 1.0:
            raise ValueError(f"SLO {name}: objective must be in (0, 1)")
        self.name = str(name)
        self.description = str(description)
        self.objective = float(objective)
        self.kind = kind
        self.bad = bad
        self.total = total
        self.series = series
        self.field = field
        self.bound = None if bound is None else float(bound)
        self.op = op
        self.windows = tuple(windows)
        self.budget_window_s = float(budget_window_s)

    # -- bad fraction over a window ------------------------------------------

    def bad_fraction(self, points, t0, t1):
        """Bad-event fraction over ``[t0, t1]``, or ``None`` when the
        window holds no evidence (series absent / zero traffic) — no
        evidence must mean *no verdict*, never a clean bill."""
        window = [p for p in points if t0 <= p["t"] <= t1]
        if not window:
            return None
        if self.kind == "ratio":
            bad = tot = 0.0
            seen = False
            for p in window:
                b = p["series"].get(self.bad)
                t = p["series"].get(self.total)
                if t is None:
                    continue
                seen = True
                tot += float(t.get("rate") or 0.0)
                bad += float((b or {}).get("rate") or 0.0)
            if not seen or tot <= 0.0:
                return None
            return min(bad / tot, 1.0)
        n = breached = 0
        for p in window:
            rec = p["series"].get(self.series)
            v = None if rec is None else rec.get(self.field)
            if v is None:
                continue
            n += 1
            v = float(v)
            ok = v <= self.bound if self.op == "<=" else v >= self.bound
            breached += not ok
        if n == 0:
            return None
        return breached / n

    def burn_rate(self, points, window_s, now):
        """Budget burn rate over the trailing window: bad fraction
        divided by the error budget (``1 - objective``); ``None``
        without evidence."""
        frac = self.bad_fraction(points, now - float(window_s), now)
        if frac is None:
            return None
        return frac / (1.0 - self.objective)

    def doc(self):
        out = {"name": self.name, "kind": self.kind,
               "objective": self.objective,
               "description": self.description,
               "windows": [list(w) for w in self.windows],
               "budget_window_s": self.budget_window_s}
        if self.kind == "ratio":
            out.update(bad=self.bad, total=self.total)
        else:
            out.update(series=self.series, field=self.field,
                       bound=self.bound, op=self.op)
        return out


class Alert:
    """One fired burn rule: both windows burned past the threshold."""

    __slots__ = ("slo", "severity", "fast_s", "slow_s", "threshold",
                 "burn_fast", "burn_slow", "budget_remaining", "t")

    def __init__(self, slo, severity, fast_s, slow_s, threshold,
                 burn_fast, burn_slow, budget_remaining, t):
        self.slo = slo
        self.severity = severity
        self.fast_s = fast_s
        self.slow_s = slow_s
        self.threshold = threshold
        self.burn_fast = burn_fast
        self.burn_slow = burn_slow
        self.budget_remaining = budget_remaining
        self.t = t

    def doc(self):
        return {"slo": self.slo, "severity": self.severity,
                "window_s": [self.fast_s, self.slow_s],
                "burn_threshold": self.threshold,
                "burn_fast": round(self.burn_fast, 4),
                "burn_slow": round(self.burn_slow, 4),
                "budget_remaining": (None if self.budget_remaining is None
                                     else round(self.budget_remaining, 4)),
                "t": round(self.t, 3)}


def default_slos(*, chunk_wall_p95_s=60.0, recall_floor=0.7,
                 dispatch_objective=0.95, lease_objective=0.9,
                 candidate_latency_p95_s=30.0, queue_wait_p95_s=10.0):
    """The framework's stock SLO set: dispatch
    success, chunk-wall p95, the canary recall floor, fleet lease
    success, end-to-end candidate latency p95, and fleet queue-wait
    p95.  Bounds are constructor knobs — a deployment tunes them per
    hardware; the defaults are deliberately loose (the engine flags
    budget *burn*, not scheduler noise)."""
    return [
        SLOSpec("dispatch-success", objective=dispatch_objective,
                kind="ratio", bad="putpu_dispatch_retries_total",
                total="putpu_dispatches_total",
                description="chunk dispatches that complete without a "
                            "retry"),
        SLOSpec("chunk-wall-p95", objective=0.9, kind="threshold",
                series="putpu_chunk_wall_seconds", field="p95",
                bound=chunk_wall_p95_s, op="<=",
                description="p95 chunk wall stays under the latency "
                            "bound"),
        SLOSpec("canary-recall", objective=0.9, kind="threshold",
                series="putpu_canary_window_recall", field="value",
                bound=recall_floor, op=">=",
                description="windowed injection-recovery recall holds "
                            "the floor — the science SLO: a slow "
                            "recall bleed must page before the survey "
                            "is wasted"),
        SLOSpec("fleet-lease-success", objective=lease_objective,
                kind="ratio", bad="putpu_fleet_leases_expired_total",
                total="putpu_fleet_leases_granted_total",
                description="granted leases that resolve without "
                            "expiring (a silent worker burns these)"),
        SLOSpec("candidate-latency-p95", objective=0.9,
                kind="threshold",
                series="putpu_candidate_latency_seconds", field="p95",
                bound=candidate_latency_p95_s, op="<=",
                description="p95 end-to-end candidate latency (sample "
                            "read to persist complete, the lineage "
                            "histogram) stays under the real-time "
                            "alerting bound"),
        SLOSpec("queue-wait-p95", objective=0.9, kind="threshold",
                series="putpu_lease_wait_seconds", field="p95",
                bound=queue_wait_p95_s, op="<=",
                description="p95 grant-to-work lease wait stays under "
                            "the queueing bound — a sustained breach "
                            "means units sit granted while workers "
                            "churn, the saturation signal the capacity "
                            "layer classifies"),
    ]


class SLOEngine:
    """Evaluate SLO specs over a time-series; hold the active alerts.

    ``health`` (a :class:`~.health.HealthEngine`) receives each firing
    rule as an ``slo:<name>`` condition — page → CRITICAL, ticket →
    DEGRADED — resolved when the burn stops, so the fleet's existing
    lease gating and ``/healthz`` probes act on budget burn with zero
    new plumbing.  Thread-safe: the sampler thread evaluates while HTTP
    threads read :meth:`alerts_doc`.
    """

    def __init__(self, specs=None, health=None):
        self.specs = list(specs if specs is not None else default_slos())
        self.health = health
        self._lock = threading.Lock()
        self._active = {}        # slo name -> Alert (worst severity)
        self._status = {}        # slo name -> last status row
        self._evaluations = 0
        self._fired_total = 0

    def evaluate(self, timeseries, now=None):
        """One evaluation pass over ``timeseries`` (anything with
        ``.points()``); returns the currently-active alerts."""
        points = timeseries.points()
        if not points:
            return []
        t = points[-1]["t"] if now is None else float(now)
        fired = {}
        status = {}
        for spec in self.specs:
            budget_frac = spec.bad_fraction(
                points, t - spec.budget_window_s, t)
            budget_remaining = None if budget_frac is None else max(
                1.0 - budget_frac / (1.0 - spec.objective), 0.0)
            row = {"slo": spec.name, "objective": spec.objective,
                   "budget_remaining": budget_remaining, "burns": []}
            for fast_s, slow_s, threshold, severity in spec.windows:
                burn_fast = spec.burn_rate(points, fast_s, t)
                burn_slow = spec.burn_rate(points, slow_s, t)
                row["burns"].append(
                    {"window_s": [fast_s, slow_s],
                     "threshold": threshold, "severity": severity,
                     "fast": burn_fast, "slow": burn_slow})
                if burn_fast is None or burn_slow is None:
                    continue
                if burn_fast >= threshold and burn_slow >= threshold:
                    alert = Alert(spec.name, severity, fast_s, slow_s,
                                  threshold, burn_fast, burn_slow,
                                  budget_remaining, t)
                    # keep the worst severity per SLO (pages outrank
                    # tickets; windows are ordered fast-first)
                    if spec.name not in fired:
                        fired[spec.name] = alert
            status[spec.name] = row
            if budget_remaining is not None:
                _metrics.gauge("putpu_slo_budget_remaining",
                               slo=spec.name).set(
                    round(budget_remaining, 4))
        with self._lock:
            self._evaluations += 1
            newly = {n: a for n, a in fired.items()
                     if n not in self._active}
            resolved = [n for n in self._active if n not in fired]
            self._active = fired
            self._status = status
            self._fired_total += len(newly)
        _metrics.counter("putpu_slo_evaluations_total").inc()
        for name, alert in newly.items():
            _metrics.counter("putpu_slo_alerts_total", slo=name,
                             severity=alert.severity).inc()
        if self.health is not None:
            for name, alert in fired.items():
                self.health.note_alert(
                    f"slo:{name}",
                    CRITICAL if alert.severity == "page" else DEGRADED,
                    f"burn {alert.burn_fast:.1f}x/{alert.burn_slow:.1f}x "
                    f"over {alert.fast_s:g}s/{alert.slow_s:g}s windows "
                    f"(threshold {alert.threshold:g}; budget remaining "
                    + ("n/a" if alert.budget_remaining is None
                       else f"{100 * alert.budget_remaining:.0f}%") + ")")
            for name in resolved:
                self.health.resolve_alert(f"slo:{name}")
        return list(fired.values())

    # -- read side -----------------------------------------------------------

    def alerts_doc(self):
        """The ``/alerts`` document: active alerts + per-SLO status."""
        with self._lock:
            return {"schema_version": ALERTS_SCHEMA_VERSION,
                    "evaluations": self._evaluations,
                    "alerts_fired_total": self._fired_total,
                    "alerts": [a.doc() for a in
                               sorted(self._active.values(),
                                      key=lambda a: a.slo)],
                    "slos": [self._status[s.name] for s in self.specs
                             if s.name in self._status]
                            # never-evaluated fallback: the same row
                            # shape evaluation produces, so consumers
                            # (to_json, the report table) read "slo"
                            or [{"slo": s.name,
                                 "objective": s.objective,
                                 "budget_remaining": None,
                                 "burns": []} for s in self.specs]}

    def to_json(self):
        """Compact end-of-run record (the ``ALERTS_JSON`` footer and
        the report's "SLOs & alerts" section)."""
        doc = self.alerts_doc()
        return {"schema_version": doc["schema_version"],
                "evaluations": doc["evaluations"],
                "alerts_fired_total": doc["alerts_fired_total"],
                "active_alerts": doc["alerts"],
                "slos": [
                    {"slo": r.get("slo"),
                     "objective": r.get("objective"),
                     "budget_remaining": r.get("budget_remaining")}
                    for r in doc["slos"]]}

    def footer(self, log=None):
        """Log the one-line machine-readable ``ALERTS_JSON`` footer
        (BUDGET_JSON-style: artifact parsers grep for the prefix)."""
        if log is None:
            from ..utils.logging_utils import logger as log
        log.info("ALERTS_JSON %s", json.dumps(self.to_json()))
