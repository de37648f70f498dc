"""Per-stage timing and the chunk loop's budget accountant.

The port of the JAX package's module.  :class:`BudgetAccountant` assigns
every second of a chunk's wall to a named bucket, with an explicit
``unattributed`` residual per chunk and in the run's footer, and logs
the whole ledger as one ``BUDGET_JSON`` line.  Its buckets and chunks
are measured by :mod:`..obs.trace` spans (one clock for the ledger and
the trace timeline); its counters are mirrored into the process metrics
registry (:mod:`..obs.metrics`).

What the JAX package observes through ``jax.monitoring`` (XLA compiles)
is, here, the port's own compile step: every ``nvcc`` build and first
load of a kernel library (:mod:`.nvcc`).  A build in any chunk after a
stream's first is flagged as a retrace.  :func:`measure_device_rtt`
prices one CUDA round trip: a one-element launch and a
``torch.cuda.synchronize``.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import threading
import time

from ..obs import metrics as _metrics
from ..obs import trace as _trace
#: the ``BUDGET_JSON`` record's schema version (its home is the gate)
from ..obs.gate import SCHEMA_VERSION

logger = logging.getLogger("pulsarutils_tpu_torch")


class StageTimer:
    """Accumulates wall-clock per named stage; ``report()`` logs a table."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, log=logger):
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            log.info("stage %-20s %8.3fs total, %6d calls, %8.4fs/call",
                     name, total, n, total / n)


#: the accountant deeper code attributes to (:func:`budget_bucket`,
#: :func:`budget_count`): a ContextVar, so the reader and persist threads
#: never land in the main thread's serial buckets
_ACTIVE_BUDGET = contextvars.ContextVar("putpu_budget", default=None)

#: chunk-wall histogram edges
_CHUNK_WALL_EDGES = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0)


def _percentile(sorted_values, q):
    """Linear-interpolation percentile of a sorted list (NumPy's default
    rule, in the standard library so the ledger is deterministic)."""
    n = len(sorted_values)
    if n == 0:
        return None
    if n == 1:
        return float(sorted_values[0])
    pos = q * (n - 1)
    lo = int(pos)
    frac = pos - lo
    if lo + 1 >= n:
        return float(sorted_values[-1])
    return float(sorted_values[lo] * (1.0 - frac)
                 + sorted_values[lo + 1] * frac)


def compile_snapshot():
    """Cumulative ``(count, seconds)`` of kernel builds and first loads
    in this process (:data:`.nvcc.COMPILES`)."""
    from . import nvcc

    with nvcc.COMPILES_LOCK:
        return nvcc.COMPILES["count"], nvcc.COMPILES["secs"]


def measure_device_rtt(n=5, device=None):
    """Median seconds of one trivial launch and its
    ``torch.cuda.synchronize`` on ``device`` (the current card by
    default): the floor every device round trip pays.  One warm-up call
    first.  ``None`` without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    x = torch.ones(1, device=device if device is not None else "cuda")
    x.add_(1.0)
    torch.cuda.synchronize(x.device)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        x.add_(1.0)
        torch.cuda.synchronize(x.device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


class BudgetAccountant(StageTimer):
    """Per-chunk wall-clock budget: buckets, counters and the residual.

    A superset of :class:`StageTimer` (every bucket second also lands in
    the stage totals):

    * :meth:`chunk` opens a chunk's budget; within it
      :meth:`bucket`/:func:`budget_bucket` charge main-thread, serial
      time to named buckets and :meth:`count` bumps counters
      (``dispatches``, ``readbacks``, ``prefetch_uploads``).  Names may
      nest with ``/``: the residual uses top-level names only;
    * kernel builds and first loads are recorded per chunk
      (``compiles``/``compile_s``); one in any chunk after a stream's
      first is a **retrace** (``putpu_retraces_total``), logged, and a
      warning once three chunks have one;
    * time on other threads (the reader's decode, the persist worker) is
      recorded with :meth:`add_async`: reported, never part of a chunk's
      serial budget;
    * ``unattributed`` = chunk wall - the top-level buckets, per chunk
      and in :meth:`footer`; :meth:`to_json` is the ``BUDGET_JSON``
      record, with the JAX package's keys.

    ``rtt_s`` (:func:`measure_device_rtt`) prices the trips: the footer
    reports ``(dispatches + readbacks) x rtt``.
    """

    def __init__(self, rtt_s=None):
        super().__init__()
        self.rtt_s = rtt_s
        #: the mesh shape of a sharded run (None on one device)
        self.mesh_shape = None
        self.chunks = []
        self.async_totals = {}
        self.counters_total = {}
        self._async_lock = threading.Lock()
        self._active = None
        self._retrace_chunks = 0
        self._stream_chunks = 0
        self._truncation_warned = False
        self._autotune_mark = self._autotune_seq()

    @staticmethod
    def _autotune_seq():
        """Current position in the process's autotune decision log (lazy
        import: the tuning package imports this module)."""
        from ..tuning.autotune import decision_seq

        return decision_seq()

    def begin_stream(self):
        """Mark the start of a run on a reused accountant: retraces are
        counted from the first chunk of each stream, and the record's
        ``autotune`` list holds the decisions made since."""
        self._stream_chunks = 0
        self._retrace_chunks = 0
        self._autotune_mark = self._autotune_seq()

    # -- per-chunk budget ----------------------------------------------------

    @contextlib.contextmanager
    def chunk(self, label):
        if self._active is not None:
            raise RuntimeError("budget chunks cannot nest")
        c0, s0 = compile_snapshot()
        rec = {"chunk": label, "wall_s": 0.0, "buckets": {}, "counters": {}}
        self._active = rec
        token = _ACTIVE_BUDGET.set(self)
        # the chunk's wall is a span: its nested spans land on the
        # chunk's own track
        track_token = _trace.push_track(f"chunk {label}")
        s = _trace.open_span("chunk", {"chunk": label})
        try:
            yield rec
        finally:
            _trace.close_span(s)
            _trace.pop_track(track_token)
            rec["wall_s"] = s.dur
            _ACTIVE_BUDGET.reset(token)
            self._active = None
            self._stream_chunks += 1
            c1, s1 = compile_snapshot()
            if c1 > c0:
                rec["counters"]["compiles"] = c1 - c0
                rec["counters"]["compile_s"] = round(s1 - s0, 4)
                if self._stream_chunks > 1:
                    rec["retrace"] = True
                    self._retrace_chunks += 1
                    _metrics.counter("putpu_retraces_total").inc()
                    log = (logger.warning if self._retrace_chunks >= 3
                           else logger.info)
                    log("retrace in chunk %s: %d kernel build(s) or "
                        "load(s), %.2fs (%s)", label, c1 - c0, s1 - s0,
                        "builds in several chunks: every chunk should "
                        "reuse the first chunk's kernels"
                        if self._retrace_chunks >= 3 else
                        "expected for a kernel's first use; repeated "
                        "occurrences escalate to a warning")
            top = sum(v for k, v in rec["buckets"].items() if "/" not in k)
            rec["unattributed_s"] = round(rec["wall_s"] - top, 4)
            rec["wall_s"] = round(rec["wall_s"], 4)
            _metrics.histogram("putpu_chunk_wall_seconds",
                               edges=_CHUNK_WALL_EDGES).observe(
                rec["wall_s"])
            rec["buckets"] = {k: round(v, 4)
                              for k, v in rec["buckets"].items()}
            self.chunks.append(rec)
            _metrics.counter("putpu_chunks_total").inc()
            logger.debug("chunk %s budget: wall=%.3fs %s "
                         "unattributed=%.3fs counters=%s", label,
                         rec["wall_s"],
                         " ".join(f"{k}={v:.3f}" for k, v in
                                  sorted(rec["buckets"].items(),
                                         key=lambda kv: -kv[1])
                                  if "/" not in k),
                         rec["unattributed_s"], rec["counters"])

    @contextlib.contextmanager
    def bucket(self, name):
        """Serial main-thread time, measured as one span (the budget and
        an active tracer read the same interval)."""
        s = _trace.open_span(name)
        try:
            yield
        finally:
            _trace.close_span(s)
            self.add(name, s.dur)

    def add(self, name, dt):
        if self._active is not None:
            b = self._active["buckets"]
            b[name] = b.get(name, 0.0) + dt
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def count(self, name, n=1):
        if self._active is not None:
            c = self._active["counters"]
            c[name] = c.get(name, 0) + n
        self.counters_total[name] = self.counters_total.get(name, 0) + n
        # the names are enumerated as BUDGET_COUNTERS in obs/names.py
        # putpu-lint: disable=metric-name-dynamic — enumerated manifest seam
        _metrics.counter(f"putpu_{name}_total").inc(n)

    def add_async(self, name, dt):
        """Seconds off the critical path, from any thread."""
        with self._async_lock:
            self.async_totals[name] = self.async_totals.get(name, 0.0) + dt

    def trips(self):
        """Device round trips counted so far (dispatches + readbacks)."""
        return (self.counters_total.get("dispatches", 0)
                + self.counters_total.get("readbacks", 0))

    def stage_seconds(self):
        """``{stage: seconds}``: the serial buckets' totals (inside and
        outside chunks) plus the seconds off the critical path."""
        out = dict(self.totals)
        with self._async_lock:
            for k, v in self.async_totals.items():
                out[k] = out.get(k, 0.0) + v
        return out

    # -- reporting -----------------------------------------------------------

    def to_json(self, max_per_chunk=32):
        nchunks = len(self.chunks)
        wall = sum(c["wall_s"] for c in self.chunks)
        buckets = {}
        for c in self.chunks:
            for k, v in c["buckets"].items():
                buckets[k] = buckets.get(k, 0.0) + v
        top = sum(v for k, v in buckets.items() if "/" not in k)
        unattributed = wall - top
        walls = sorted(c["wall_s"] for c in self.chunks)
        out = {
            "schema_version": SCHEMA_VERSION,
            "chunks": nchunks,
            "wall_s": round(wall, 3),
            "chunk_wall_s": ({
                "p50": round(_percentile(walls, 0.50), 4),
                "p95": round(_percentile(walls, 0.95), 4),
                "p99": round(_percentile(walls, 0.99), 4)}
                if walls else None),
            "buckets_s": {k: round(v, 3) for k, v in sorted(
                buckets.items(), key=lambda kv: -kv[1])},
            "unattributed_s": round(unattributed, 3),
            "attributed_pct": round(100.0 * top / wall, 1) if wall else None,
            "counters": dict(self.counters_total),
            "async_s": {k: round(v, 3)
                        for k, v in self.async_totals.items()},
            # head and tail chunks of a long stream (the aggregates above
            # cover every chunk); 0 drops the per-chunk detail
            "per_chunk": (self.chunks if nchunks <= max_per_chunk
                          else self.chunks[:max_per_chunk // 2]
                          + self.chunks[nchunks - max_per_chunk // 2:]),
        }
        if self.mesh_shape:
            out["mesh"] = list(self.mesh_shape)
        if nchunks > max_per_chunk:
            out["per_chunk_truncated"] = True
            out["truncated_chunks"] = nchunks - 2 * (max_per_chunk // 2)
            if max_per_chunk > 0 and not self._truncation_warned:
                self._truncation_warned = True
                logger.warning(
                    "budget JSON truncated: per-chunk detail for %d of %d "
                    "chunks dropped (head+tail of %d kept; aggregates "
                    "cover all chunks — raise max_per_chunk for the full "
                    "ledger)", out["truncated_chunks"], nchunks,
                    max_per_chunk)
        if self.rtt_s is not None:
            out["rtt_s"] = round(self.rtt_s, 6)
            out["trips"] = self.trips()
            out["trips_x_rtt_s"] = round(self.trips() * self.rtt_s, 3)
        # the kernel tuner's decisions since this run's begin_stream; the
        # key is absent when nothing resolved this run, as in the JAX
        # package's record
        from ..tuning.autotune import decisions_since

        decisions = decisions_since(self._autotune_mark)
        if decisions:
            out["autotune"] = decisions
        return out

    def footer(self, log=logger):
        """Log the run's budget: every bucket's share of the summed chunk
        wall, the residual, trip pricing and overlapped work."""
        if not self.chunks:
            return
        j = self.to_json()
        wall = j["wall_s"] or 1.0
        log.info("chunk budget over %d chunks, %.2fs wall "
                 "(%.1f%% attributed):", j["chunks"], j["wall_s"],
                 j["attributed_pct"] or 0.0)
        cw = j.get("chunk_wall_s")
        if cw:
            log.info("  chunk wall p50/p95/p99: %.3f / %.3f / %.3f s",
                     cw["p50"], cw["p95"], cw["p99"])
        buckets = j["buckets_s"]
        tops = sorted((k for k in buckets if "/" not in k),
                      key=lambda k: -buckets[k])
        for top in tops:
            log.info("  %-22s %8.3fs  %5.1f%%", top, buckets[top],
                     100.0 * buckets[top] / wall)
            kids = sorted((k for k in buckets
                           if k.startswith(top + "/")),
                          key=lambda k: -buckets[k])
            for k in kids:
                log.info("    %-20s %8.3fs  %5.1f%%",
                         k[len(top) + 1:], buckets[k],
                         100.0 * buckets[k] / wall)
        log.info("  %-22s %8.3fs  %5.1f%%", "unattributed",
                 j["unattributed_s"], 100.0 * j["unattributed_s"] / wall)
        if j.get("counters"):
            log.info("  counters: %s", json.dumps(j["counters"]))
        if self.rtt_s is not None:
            log.info("  device RTT %.4fs x %d trips = %.2fs (floor "
                     "inside the blocking buckets)", j["rtt_s"],
                     j["trips"], j["trips_x_rtt_s"])
        for k, v in sorted(j["async_s"].items(), key=lambda kv: -kv[1]):
            log.info("  overlapped %-17s %8.3fs (off critical path)", k, v)
        if j["wall_s"]:
            _metrics.gauge("putpu_chunks_per_s").set(
                round(j["chunks"] / j["wall_s"], 4))
        from ..obs import roofline as _roofline

        _roofline.log_table(log)  # no-op unless roofline accounting ran


def current_budget():
    """The :class:`BudgetAccountant` whose chunk context encloses this
    call on this thread, or ``None``."""
    return _ACTIVE_BUDGET.get()


@contextlib.contextmanager
def budget_bucket(name):
    """Charge the block to ``name`` in the active chunk budget, if any,
    and record it as a span when a tracer is active; a plain yield when
    neither is."""
    acct = _ACTIVE_BUDGET.get()
    if acct is None and not _trace.is_tracing():
        yield
        return
    s = _trace.open_span(name)
    try:
        yield
    finally:
        _trace.close_span(s)
        if acct is not None:
            acct.add(name, s.dur)


def budget_count(name, n=1):
    """Bump a counter in the active chunk budget, if any."""
    acct = _ACTIVE_BUDGET.get()
    if acct is not None:
        acct.count(name, n)


@contextlib.contextmanager
def device_trace(trace_dir=None):
    """Wrap a block in a ``torch.profiler`` device trace written under
    ``trace_dir`` (:func:`~..obs.trace.trace_session`'s device-only
    form); a no-op when ``trace_dir`` is not set."""
    if not trace_dir:
        yield
        return
    with _trace.trace_session(device_trace_dir=trace_dir):
        yield
