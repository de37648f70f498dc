"""Distributed trace collector: N processes -> ONE Perfetto timeline.

The port of the JAX package's module (host Python, no torch).

Each process's :class:`~.trace.Tracer` records spans on its own
``perf_counter`` timescale, anchored to its own wall clock
(``epoch_unix``).  Wall clocks across a fleet disagree — NTP keeps them
within milliseconds at best, and a chunk dispatch is milliseconds — so
naive merging shows a worker finishing a unit before the coordinator
granted it.  The collector stitches honestly:

* **one process group per worker** (plus the coordinator): each
  contributed trace becomes its own ``pid`` with named, sorted tracks,
  so the merged file reads as "coordinator row, worker w1 rows, worker
  w2 rows" in Perfetto;
* **clock skew corrected from the wire**: the worker measures its
  offset against the coordinator on every register/lease
  request–response using the midpoint rule
  (:func:`clock_offset`: ``offset = server_time - (t0 + t1) / 2`` —
  the symmetric-delay assumption of NTP's clock filter, good to half
  the round trip), ships it beside its drained events, and the
  collector shifts that process's events by the offset onto the
  coordinator's clock domain.  The applied offset is recorded as an
  attribute on each process's ``clock_sync`` span — the correction is
  auditable in the trace itself, never silent;
* **absolute alignment**: event timestamps become
  ``(epoch_unix + offset) * 1e6 + ts`` microseconds, re-zeroed to the
  earliest event across all processes, so one lease's coordinator and
  worker spans sit on the same axis.

Live path: the fleet coordinator feeds :meth:`TraceCollector.ingest`
from each ``complete`` message's ``trace`` payload.  Post-hoc path:
:func:`merge_trace_files` rebuilds
the same merge from per-process ``Tracer.export`` JSON files when no
collector was running.
"""

from __future__ import annotations

import json
import os
import threading

from . import metrics as _metrics

__all__ = ["TraceCollector", "clock_offset", "merge_trace_files"]


def clock_offset(t0, t1, server_time):
    """Midpoint-rule clock offset: the server's clock minus ours,
    estimated from one request–response exchange (``t0``/``t1`` our
    clock at send/receive, ``server_time`` the server's clock while
    handling).  Positive = the server's clock runs ahead.  Error is
    bounded by half the round trip — record it, don't hide it."""
    return float(server_time) - (float(t0) + float(t1)) / 2.0


class _Process:
    __slots__ = ("name", "events", "tracks", "epoch_unix", "offset_s",
                 "sort_index")

    def __init__(self, name, epoch_unix, offset_s, sort_index):
        self.name = name
        self.events = []
        self.tracks = {}          # source tid -> track name
        self.epoch_unix = float(epoch_unix)
        self.offset_s = float(offset_s)
        self.sort_index = sort_index


class TraceCollector:
    """Accumulate per-process span events; export one merged trace.

    Thread-safe: the coordinator's HTTP handler threads ingest worker
    payloads while the shutdown path exports.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._procs = {}          # name -> _Process

    def _proc_locked(self, name, epoch_unix, offset_s):
        proc = self._procs.get(name)
        if proc is None:
            proc = _Process(name, epoch_unix, offset_s,
                            len(self._procs) + 1)
            self._procs[name] = proc
        else:
            # later payloads refresh the clock story (a re-registered
            # worker re-measures its offset; the newest estimate wins)
            proc.epoch_unix = float(epoch_unix)
            proc.offset_s = float(offset_s)
        return proc

    def ingest(self, name, trace_doc):
        """Fold one process's drained payload in: ``{"events": [...],
        "tracks": {name: tid}, "epoch_unix": float,
        "clock_offset_s": float}`` (the fleet ``complete`` message's
        ``trace`` shape).  Unknown/malformed payloads are dropped with
        a count, never raised — observability must not fail a
        completion."""
        if not isinstance(trace_doc, dict) \
                or not isinstance(trace_doc.get("events"), list):
            return 0
        events = [e for e in trace_doc["events"] if isinstance(e, dict)]
        tracks = trace_doc.get("tracks") or {}
        with self._lock:
            proc = self._proc_locked(
                str(name), trace_doc.get("epoch_unix", 0.0) or 0.0,
                trace_doc.get("clock_offset_s", 0.0) or 0.0)
            proc.events.extend(events)
            if isinstance(tracks, dict):
                for track, tid in tracks.items():
                    proc.tracks[int(tid)] = str(track)
        n = sum(e.get("ph") in ("X", "b") for e in events)
        if n:
            _metrics.counter("putpu_trace_spans_collected_total").inc(n)
        return n

    def ingest_tracer(self, name, tracer, offset_s=0.0):
        """Fold a local :class:`~.trace.Tracer`'s full event list in
        (the coordinator's own spans ride this seam at export time)."""
        events, _mark = tracer.events_since(0)
        return self.ingest(name, {
            "events": events,
            "tracks": tracer.tracks(),
            "epoch_unix": tracer.epoch_unix,
            "clock_offset_s": offset_s})

    # -- merged export -------------------------------------------------------

    def processes(self):
        with self._lock:
            return {name: len(p.events) for name, p in self._procs.items()}

    def to_chrome(self):
        """The merged Chrome trace-event dict: one pid per process,
        clock-skew-corrected timestamps on one shared axis."""
        with self._lock:
            procs = sorted(self._procs.values(),
                           key=lambda p: p.sort_index)
            events = {p.name: list(p.events) for p in procs}
            tracks = {p.name: dict(p.tracks) for p in procs}
        # the shared zero: the earliest corrected event across processes
        base = None
        for proc in procs:
            shift = (proc.epoch_unix + proc.offset_s) * 1e6
            for ev in events[proc.name]:
                ts = shift + float(ev.get("ts", 0.0))
                base = ts if base is None else min(base, ts)
        base = base or 0.0
        out = []
        for proc in procs:
            pid = proc.sort_index
            shift = (proc.epoch_unix + proc.offset_s) * 1e6
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "args": {"name": proc.name,
                                 "clock_offset_s": proc.offset_s}})
            out.append({"name": "process_sort_index", "ph": "M",
                        "pid": pid, "args": {"sort_index": pid}})
            tids = set()
            for ev in events[proc.name]:
                tids.add(int(ev.get("tid", 0)))
            for tid in sorted(tids):
                track = tracks[proc.name].get(tid, f"thread-{tid}")
                out.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": track}})
                out.append({"name": "thread_sort_index", "ph": "M",
                            "pid": pid, "tid": tid,
                            "args": {"sort_index": tid}})
            # the auditable correction: one span per process stating the
            # offset that was applied to its timeline
            first = min((float(e.get("ts", 0.0))
                         for e in events[proc.name]), default=0.0)
            out.append({"name": "clock_sync", "ph": "X", "pid": pid,
                        "tid": 0, "ts": round(shift + first - base, 3),
                        "dur": 1,
                        "args": {"clock_offset_s": proc.offset_s,
                                 "epoch_unix": proc.epoch_unix,
                                 "rule": "midpoint of register/lease "
                                         "request-response"}})
            for ev in events[proc.name]:
                ev = dict(ev)
                ev["pid"] = pid
                ev["ts"] = round(shift + float(ev.get("ts", 0.0)) - base,
                                 3)
                if "id" in ev:
                    # async b/e pairs are matched by (cat, id): keep ids
                    # from different processes from pairing with each
                    # other
                    ev["id"] = pid * 1_000_000 + int(ev["id"])
                out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path):
        """Write the merged trace; returns span-event count."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        n = sum(ev.get("ph") in ("X", "b") for ev in doc["traceEvents"])
        from ..utils.logging_utils import logger

        logger.info("merged trace: %d spans across %d process(es) -> %s",
                    n, len(self._procs), path)
        return n


def merge_trace_files(paths, names=None):
    """Post-hoc stitch: merge per-process ``Tracer.export`` JSON files
    into one :class:`TraceCollector` (returned; call ``export`` on
    it).  Each file's ``putpu.epoch_unix`` anchor and optional
    ``putpu.clock_offset_s`` place it on the shared axis; files
    without the anchor merge at offset 0 with a warning — legacy
    traces still load, just uncorrected."""
    from ..utils.logging_utils import logger

    collector = TraceCollector()
    for i, path in enumerate(paths):
        with open(path) as f:
            doc = json.load(f)
        meta = doc.get("putpu") or {}
        if "epoch_unix" not in meta:
            logger.warning("%s carries no putpu.epoch_unix anchor — "
                           "merged at offset 0 (an uncorrected trace)",
                           path)
        events = [e for e in doc.get("traceEvents", [])
                  if e.get("ph") not in ("M",)]
        tracks = {}
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") == "M" and ev.get("name") == "thread_name":
                tracks[(ev.get("args") or {}).get("name",
                                                  f"thread-{ev.get('tid')}")
                       ] = int(ev.get("tid", 0))
        name = (names[i] if names and i < len(names)
                else os.path.splitext(os.path.basename(path))[0])
        collector.ingest(name, {
            "events": events, "tracks": tracks,
            "epoch_unix": meta.get("epoch_unix", 0.0),
            "clock_offset_s": meta.get("clock_offset_s", 0.0)})
    return collector
