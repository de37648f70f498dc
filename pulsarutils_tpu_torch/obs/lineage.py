"""Per-candidate lineage: stamp every hit's life from sample to alert.

The port's copy of the JAX package's recorder.  :class:`LineageRecorder`
follows one **candidate** from the chunk that held it to the artifact
that records it:

* the driver marks (:meth:`mark`) the seams — the reader's read, the dispatch
  of the search, the result's readback — with monotonic stamps
  (``time.perf_counter`` against one wall-clock anchor);
* at the sift verdict, :meth:`candidate` freezes those marks into a
  **lineage doc** (trace id, chunk, ledger fingerprint, stage offsets)
  and opens a ``candidate`` span on the chunk's track;
* :meth:`persisted` stamps persist-complete, writes the doc **beside the
  candidate npz pair** through the caller's atomic writer, and feeds the
  ``putpu_candidate_stage_seconds{stage=…}`` and
  ``putpu_candidate_latency_seconds`` histograms;
* :meth:`delivered` stamps alert delivery (the
  :class:`~.push.AlertBroker`'s success hook) and writes the doc again.

The driver only builds a recorder when lineage is armed: off, the
output directory is unchanged.

Stage semantics (durations, in seconds)::

    read      read start           -> dispatch begin   (decode + queue)
    dispatch  dispatch begin       -> device ready     (search wall)
    sift      device ready         -> sift verdict
    persist   sift verdict         -> persist complete (durable npz)
    alert     sift verdict         -> first delivery   (parallel path)

End-to-end latency is read start -> persist complete; alert delivery
races persist on the broker's thread and is accounted apart.
"""

from __future__ import annotations

import threading
import time

from . import metrics as _metrics
from .trace import begin_span, current_trace_context, new_trace_id

__all__ = ["LINEAGE_SCHEMA_VERSION", "STAGES", "CandidateLineage",
           "LineageRecorder"]

LINEAGE_SCHEMA_VERSION = 1

#: stage keys in causal order; ``alert`` is monotone vs ``sift`` (the
#: delivery path runs parallel to persist — see the module docstring)
STAGES = ("read", "dispatch", "ready", "sift", "persist", "alert")


class CandidateLineage:
    """One candidate's lineage doc + open span, sift verdict onward.

    Thread-safe: :meth:`LineageRecorder.persisted` runs on the persist
    executor while :meth:`LineageRecorder.delivered` runs on the push
    broker's worker thread; both mutate ``doc`` under ``_lock``.
    """

    __slots__ = ("doc", "span", "_anchor", "_lock", "_writer",
                 "_persisted")

    def __init__(self, doc, span, anchor):
        self.doc = doc
        self.span = span
        self._anchor = anchor       # exact perf_counter of the "read"
        self._lock = threading.Lock()   # stamp: later offsets stay
        self._writer = None             # monotone vs the frozen ones
        self._persisted = False


class LineageRecorder:
    """Stamp chunk-stage marks; freeze them into per-candidate docs.

    ``fingerprint`` is the run's ledger/config fingerprint (stamped
    into every doc so a candidate can be joined back to the exact
    search configuration); ``source`` names the driver.
    """

    def __init__(self, *, fingerprint=None, source="search_by_chunks"):
        self.fingerprint = fingerprint
        self.source = str(source)
        self._lock = threading.Lock()
        self._marks = {}            # istart -> {stage: perf_counter t}
        self._stage_durs = {}       # stage -> [seconds, ...]
        self._latencies = []        # end-to-end seconds
        self._docs = 0
        # one wall anchor + one monotonic anchor: stage offsets are
        # perf_counter deltas (monotone), the doc's t0_unix places them
        # on the wall clock for cross-process joins
        self._epoch_unix = time.time()
        self._epoch_perf = time.perf_counter()

    # -- chunk-stage marks (cheap dict writes on the hot path) ---------------

    def mark(self, istart, stage):
        """Stamp ``stage`` ("read" / "dispatch" / "ready") for a chunk
        NOW.  Idempotent per (chunk, stage): retries keep the first
        stamp — latency measures the first attempt's start."""
        now = time.perf_counter()
        with self._lock:
            self._marks.setdefault(int(istart), {}).setdefault(stage, now)

    def discard(self, istart):
        """Drop a chunk's marks (quarantined / failed chunk: no
        candidate will reference them)."""
        with self._lock:
            self._marks.pop(int(istart), None)

    # -- candidate lifecycle -------------------------------------------------

    def _wall(self, t_perf):
        return self._epoch_unix + (t_perf - self._epoch_perf)

    def candidate(self, istart, iend, *, name=None, dm=None, snr=None,
                  width=None):
        """Freeze a hit's lineage at the sift verdict.

        Returns a :class:`CandidateLineage` whose ``doc`` holds the
        stage offsets stamped so far (a missing seam is simply absent)
        and whose ``span`` is
        an open async ``candidate`` span on the chunk's track, ended at
        persist complete.
        """
        now = time.perf_counter()
        istart = int(istart)
        with self._lock:
            marks = dict(self._marks.get(istart, {}))
        marks["sift"] = now
        anchor = marks.get("read", min(marks.values()))
        stages = {s: round(marks[s] - anchor, 6)
                  for s in STAGES if s in marks}
        ctx = current_trace_context()
        trace_id = ctx["trace_id"] if ctx else new_trace_id()
        doc = {
            "schema_version": LINEAGE_SCHEMA_VERSION,
            "trace_id": trace_id,
            "source": self.source,
            "chunk": istart,
            "iend": int(iend),
            "fingerprint": self.fingerprint,
            "t0_unix": round(self._wall(anchor), 3),
            "stages": stages,
            "delivered_to": [],
        }
        if name is not None:
            doc["candidate"] = str(name)
        if dm is not None:
            doc["dm"] = float(dm)
        if snr is not None:
            doc["snr"] = float(snr)
        if width is not None:
            doc["width"] = float(width)
        # the explicit trace_id attr: without a bound context nothing
        # else stamps it; the span ends in persisted(), on the persist
        # worker
        span = begin_span("candidate", track=f"chunk {istart}",
                          chunk=istart, trace_id=trace_id,
                          **({"snr": round(float(snr), 3)}
                             if snr is not None else {}))
        cl = CandidateLineage(doc, span, anchor)
        self._observe_stage("read", stages, "read", "dispatch")
        self._observe_stage("dispatch", stages, "dispatch", "ready")
        self._observe_stage("sift", stages, "ready", "sift")
        return cl

    def _observe_stage(self, label, stages, frm, to):
        if frm in stages and to in stages:
            dur = max(stages[to] - stages[frm], 0.0)
            _metrics.histogram("putpu_candidate_stage_seconds",
                               stage=label).observe(dur)
            with self._lock:
                self._stage_durs.setdefault(label, []).append(dur)

    def persisted(self, cl, writer=None):
        """Stamp persist-complete on ``cl``; write the doc through
        ``writer(doc)`` (the driver's atomic-write closure, called
        again on later delivery stamps); feed the stage + end-to-end
        histograms; end the candidate span."""
        now = time.perf_counter()
        with cl._lock:
            stages = cl.doc["stages"]
            stages["persist"] = max(round(now - cl._anchor, 6),
                                    stages.get("sift", 0.0))
            cl._writer = writer
            cl._persisted = True
            doc = dict(cl.doc)
        self._observe_stage("persist", stages, "sift", "persist")
        latency = max(stages["persist"] - stages.get("read", 0.0), 0.0)
        _metrics.histogram("putpu_candidate_latency_seconds").observe(
            latency)
        with self._lock:
            self._latencies.append(latency)
            self._docs += 1
        if writer is not None:
            writer(doc)
            _metrics.counter("putpu_lineage_docs_total").inc()
        cl.span.end(latency_s=round(latency, 6))

    def delivered(self, cl, subscriber=""):
        """Stamp first alert delivery (the broker's success hook, run
        on the broker thread); re-persist the doc when it is already on
        disk so the artifact records the delivery."""
        now = time.perf_counter()
        with cl._lock:
            stages = cl.doc["stages"]
            stages.setdefault("alert", max(round(now - cl._anchor, 6),
                                           stages.get("sift", 0.0)))
            if subscriber:
                cl.doc["delivered_to"].append(str(subscriber))
            writer = cl._writer if cl._persisted else None
            doc = dict(cl.doc)
        self._observe_stage("alert", stages, "sift", "alert")
        if writer is not None:
            writer(doc)

    # -- report side ---------------------------------------------------------

    def summary(self):
        """The report's "Candidate latency" section data: per-stage
        duration stats (the waterfall table) + end-to-end latency."""
        def stats(vals):
            if not vals:
                return None
            v = sorted(vals)
            return {"n": len(v),
                    "p50": round(v[len(v) // 2], 6),
                    "p95": round(v[min(int(0.95 * len(v)),
                                       len(v) - 1)], 6),
                    "max": round(v[-1], 6)}
        with self._lock:
            return {
                "candidates": self._docs,
                "latency": stats(self._latencies),
                "stages": {s: stats(self._stage_durs.get(s, []))
                           for s in ("read", "dispatch", "sift",
                                     "persist", "alert")
                           if self._stage_durs.get(s)},
            }
