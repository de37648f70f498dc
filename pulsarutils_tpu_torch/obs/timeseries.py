"""Metric time-series: a bounded ring-buffer sampler over the registry.

The port of the JAX package's module, over the port's registry.

The registry (:mod:`.metrics`) answers "what is the value *now*"; a
production survey needs trends — is chunks/s bleeding, is headroom
shrinking, did recall step down an hour ago — and the SLO engine
(:mod:`.slo`) needs windows of history to compute burn rates over.
:class:`TimeSeriesSampler` closes that gap without a metrics database:

* each :meth:`sample` folds one registry snapshot into a point:
  **counters → rates** (delta / delta-t against the previous sample),
  **gauges → values**, **histograms → p50/p95/p99** (interpolated from
  the cumulative buckets) plus count and observation rate;
* points live in a bounded ring buffer (``capacity`` — memory never
  grows with run length) and optionally **spill to JSONL** (one point
  per line, append-only) so a post-mortem has more history than the
  ring held;
* ``/metrics/history`` (:mod:`.server`) serves :meth:`history_doc`
  live, and the fleet coordinator scrapes each worker's endpoint on
  its sweep loop so the fleet report shows per-worker chunks/s,
  headroom and recall *over time* instead of final numbers.

Sampling cost is one registry snapshot (the same locks a Prometheus
scrape takes) — safe at second cadence beside a running survey, and
entirely byte-inert for science outputs: nothing here touches the
candidate/ledger path.
"""

from __future__ import annotations

import json
import threading
import time

from . import metrics as _metrics

__all__ = ["HISTORY_SCHEMA_VERSION", "TimeSeriesSampler",
           "histogram_quantile", "series_key"]

#: bumped whenever a point's meaning changes — ``/metrics/history``
#: consumers (the fleet scraper, artifact parsers) refuse drift instead
#: of mis-reading it
HISTORY_SCHEMA_VERSION = 1

#: the quantiles a histogram series carries per point
_QUANTILES = ((0.5, "p50"), (0.95, "p95"), (0.99, "p99"))


def series_key(name, labels=None):
    """Stable series identity: ``name`` or ``name{k="v",...}`` (sorted
    labels, the Prometheus spelling)."""
    if not labels:
        return name
    return name + _metrics._fmt_labels(sorted(labels.items()))


def histogram_quantile(q, edges, counts):
    """Quantile estimate from a fixed-edge histogram sample.

    ``counts`` are the per-bucket (non-cumulative) counts as
    :meth:`~.metrics.Histogram._sample` reports them — one per edge
    plus the final overflow bucket.  Linear interpolation within the
    bucket that crosses the target rank (the Prometheus
    ``histogram_quantile`` rule); the overflow bucket clamps to the
    last edge — an estimate can never exceed the instrumented range.
    Returns ``None`` for an empty histogram.
    """
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if cum + c >= target and c > 0:
            if i >= len(edges):          # overflow bucket: clamp
                return float(edges[-1]) if edges else None
            lo = float(edges[i - 1]) if i > 0 else 0.0
            hi = float(edges[i])
            return lo + (hi - lo) * (target - cum) / c
        cum += c
    return float(edges[-1]) if edges else None


class TimeSeriesSampler:
    """Ring-buffer history of one metrics registry.

    ``interval_s`` paces the background thread (:meth:`start` /
    :meth:`stop`; tests call :meth:`sample` directly with a fake
    clock); ``capacity`` bounds the ring; ``spill_path`` appends every
    point as one JSONL line; ``on_sample`` is called with each new
    point after it lands (the SLO engine's evaluation hook — it runs on
    the sampler thread, so it must stay cheap and never raise:
    exceptions are contained and logged).
    """

    def __init__(self, registry=None, interval_s=5.0, capacity=720,
                 spill_path=None, on_sample=None):
        self.registry = registry if registry is not None \
            else _metrics.REGISTRY
        self.interval_s = float(interval_s)
        self.capacity = max(int(capacity), 2)
        self.spill_path = str(spill_path) if spill_path else None
        self.on_sample = on_sample
        self._lock = threading.Lock()
        self._points = []
        self._prev = {}          # counter series key -> (t, total)
        self._stop = threading.Event()
        self._thread = None

    # -- one sample ----------------------------------------------------------

    def _fold(self, rec, t, prev, series):
        key = series_key(rec["name"], rec.get("labels"))
        kind = rec.get("type")
        if kind == "counter":
            total = float(rec.get("value", 0.0))
            last = prev.get(key)
            rate = 0.0
            if last is not None and t > last[0]:
                rate = max(total - last[1], 0.0) / (t - last[0])
            prev[key] = (t, total)
            series[key] = {"rate": round(rate, 6), "total": total}
        elif kind == "gauge":
            series[key] = {"value": rec.get("value")}
        elif kind == "histogram":
            edges = rec.get("edges") or []
            counts = rec.get("counts") or []
            point = {"count": rec.get("count", 0)}
            for q, tag in _QUANTILES:
                v = histogram_quantile(q, edges, counts)
                point[tag] = None if v is None else round(v, 6)
            last = prev.get(key)
            n = float(rec.get("count", 0))
            point["rate"] = (round(max(n - last[1], 0.0)
                                   / (t - last[0]), 6)
                             if last is not None and t > last[0] else 0.0)
            prev[key] = (t, n)
            series[key] = point

    def sample(self, now=None):
        """Fold one registry snapshot into the ring; returns the point."""
        t = time.time() if now is None else float(now)
        snap = self.registry.snapshot()
        with self._lock:
            series = {}
            for rec in snap:
                self._fold(rec, t, self._prev, series)
            point = {"t": round(t, 3), "series": series}
            self._points.append(point)
            del self._points[:-self.capacity]
        _metrics.counter("putpu_metric_history_samples_total").inc()
        if self.spill_path:
            try:
                with open(self.spill_path, "a") as f:
                    f.write(json.dumps(point) + "\n")
            except OSError as exc:  # spill is best-effort, never fatal
                import logging

                logging.getLogger("pulsarutils_tpu_torch").warning(
                    "metric-history spill to %s failed (%r)",
                    self.spill_path, exc)
        hook = self.on_sample
        if hook is not None:
            try:
                hook(point)
            except Exception as exc:  # observability must not kill the run
                import logging

                logging.getLogger("pulsarutils_tpu_torch").warning(
                    "time-series on_sample hook failed (%r)", exc)
        return point

    # -- read side -----------------------------------------------------------

    def points(self, last=None):
        """The newest ``last`` points (all, when ``None``), oldest
        first."""
        with self._lock:
            pts = list(self._points)
        if last is not None:
            last = int(last)
            # NOT a plain pts[-last:]: last=0 would slice the WHOLE
            # ring (pts[-0:] == pts), the opposite of the request
            pts = pts[-last:] if last > 0 else []
        return pts

    def series(self, key, field):
        """``[(t, value), ...]`` for one series/field, skipping points
        where the series (or field) is absent — the SLO engine's view."""
        out = []
        for p in self.points():
            rec = p["series"].get(key)
            if rec is None:
                continue
            v = rec.get(field)
            if v is None:
                continue
            out.append((p["t"], v))
        return out

    def history_doc(self, last=None):
        """The ``/metrics/history`` document."""
        return {"schema_version": HISTORY_SCHEMA_VERSION,
                "interval_s": self.interval_s,
                "capacity": self.capacity,
                "samples": self.points(last=last)}

    # -- background thread ---------------------------------------------------

    def start(self):
        """Start the sampling thread (idempotent); returns ``self``."""
        if self._thread is None or not self._thread.is_alive():
            # lifecycle fields are owner-thread-only (start/stop callers;
            # the sampler thread never writes them) — the lock guards the
            # ring, not the lifecycle
            self._stop.clear()  # putpu-lint: disable=lock-discipline — owner-thread lifecycle, see above
            self._thread = threading.Thread(  # putpu-lint: disable=lock-discipline — owner-thread lifecycle
                target=self._loop, name="metric-history", daemon=True)
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception as exc:  # a sample must never kill the thread
                import logging

                logging.getLogger("pulsarutils_tpu_torch").warning(
                    "time-series sample failed (%r)", exc)

    def stop(self, final_sample=True):
        """Stop the thread; by default take one last sample so the tail
        of the run is recorded."""
        self._stop.set()
        if self._thread is not None:
            # join CANNOT hold the lock (the sampler thread takes it in
            # sample()); lifecycle fields are owner-thread-only
            self._thread.join(timeout=self.interval_s + 5.0)
            self._thread = None  # putpu-lint: disable=lock-discipline — owner-thread lifecycle
        if final_sample:
            self.sample()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
