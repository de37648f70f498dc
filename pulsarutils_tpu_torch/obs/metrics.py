"""Process-wide counters, named as the JAX package names them.

The counter part of the JAX package's metrics registry: the faults, the
resilience ladder and the chunk loop count what they contain
(quarantined chunks, retries, dead letters, OOM events) under the same
``putpu_*`` names and labels, so a test can compare the two packages'
counter deltas.  Gauges, histograms and the exporters are not ported.

Thread-safe: the reader thread, the persist worker and the main loop
update counters concurrently.  Instruments are get-or-create by
``(name, labels)``.
"""

from __future__ import annotations

import threading

__all__ = ["Counter", "MetricsRegistry", "REGISTRY", "counter"]


class Counter:
    """Monotonic count: ``inc(n)`` with ``n >= 0``; ``value`` reads it."""

    kind = "counter"

    def __init__(self, name, labels=()):
        self.name = name
        self.labels = labels  # sorted tuple of (key, value)
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) < 0")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class MetricsRegistry:
    """Get-or-create counter store (one per process, :data:`REGISTRY`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}  # (name, labels) -> Counter

    def counter(self, name, **labels):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = Counter(name, labels=key[1])
            return m

    def snapshot(self):
        """``[{"name", "type", "labels", "value"}, ...]`` sorted by name
        and labels, as the JAX registry's snapshot lists counters."""
        with self._lock:
            items = sorted(self._metrics.items())
        return [{"name": name, "type": m.kind, "labels": dict(labels),
                 "value": m.value} for (name, labels), m in items]


#: the process-wide registry
REGISTRY = MetricsRegistry()


def counter(name, **labels):
    """The process-wide counter ``name`` with ``labels``."""
    return REGISTRY.counter(name, **labels)
