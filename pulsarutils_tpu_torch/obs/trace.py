"""Span tracing: the one wall-clock timing primitive of the port.

The port of the JAX package's module.  A **span** is a named interval
measured with ``time.perf_counter``: two clock reads, nothing else when
no tracer is active.  Spans serve two consumers at once:

* the :class:`~pulsarutils_tpu_torch.utils.logging_utils.BudgetAccountant`
  reads each span's measured duration for its per-chunk bucket ledger;
* an active :class:`Tracer` records every completed span as a Chrome
  trace event (``{"traceEvents": [...]}`` JSON, loadable in Perfetto or
  ``chrome://tracing``), with one track per chunk (:func:`push_track`)
  and one per worker thread, in the JAX package's schema and names.

Work that completes later than the call that started it, possibly on
another thread (a persist task submitted by the loop and finished by the
persist worker), gets an **async span** (:func:`begin_span` ->
``handle.end()``).  A **trace context** (a ``trace_id`` and the parent
span id, :func:`trace_context`) is stamped onto every span recorded
while it is bound; an in-process fleet worker records onto a tracer of
its own (:func:`push_tracer`), which :mod:`.collector` merges with the
coordinator's on one timeline.

:func:`trace_session` drives ``torch.profiler`` beside the span tracer,
so one flag writes the span JSON and the device trace (the CUDA kernels
and copies on the card's timeline, beside the host's ops).  While the
device trace runs, every synchronous span is also a
``torch.profiler.record_function`` range, so the chunk and its stage
buckets appear in the device trace's CPU rows above the kernels they
launched.  Span code makes no CUDA call: the reader and persist threads
may record spans too.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import logging
import os
import threading
import time
import uuid

logger = logging.getLogger("pulsarutils_tpu_torch")

#: the process-wide active tracer (None = tracing off); a bare global so
#: that hot paths read it cheaply
_TRACER = None

#: this context's tracer, overriding the process-wide one: an in-process
#: fleet worker pushes its own (:func:`push_tracer`) so the spans recorded
#: on its thread, the driver's included, are drained under its identity.
#: Threads the worker starts do not inherit it; their async spans carry
#: the tracer captured at ``begin``.
_TRACER_VAR = contextvars.ContextVar("putpu_tracer", default=None)

#: ``torch.profiler.record_function`` while a device trace runs, else
#: None: synchronous spans then also annotate the profiler's timeline
_RECORD = None

#: the bound distributed-trace context: ``{"trace_id", "parent_span_id"}``
_TRACE_CTX = contextvars.ContextVar("putpu_trace_ctx", default=None)

#: logical track for spans in this context (set per chunk by the budget
#: accountant, so each chunk renders as its own Perfetto track)
_TRACK = contextvars.ContextVar("putpu_trace_track", default=None)


def new_trace_id():
    """A fresh 16-hex-character trace id."""
    return uuid.uuid4().hex[:16]


@contextlib.contextmanager
def trace_context(trace_id, parent_span_id=None):
    """Bind a trace context: every span recorded in it carries
    ``trace_id`` (and ``parent_span_id`` when given) in its args.
    Nestable: the inner binding wins."""
    ctx = {"trace_id": str(trace_id)}
    if parent_span_id is not None:
        ctx["parent_span_id"] = str(parent_span_id)
    token = _TRACE_CTX.set(ctx)
    try:
        yield ctx
    finally:
        _TRACE_CTX.reset(token)


def current_trace_context():
    """The bound trace context dict, or ``None``."""
    return _TRACE_CTX.get()


def push_tracer(tracer):
    """Install ``tracer`` as this context's tracer, over the process-wide
    one of :func:`start_tracing`; pair with :func:`pop_tracer`.  N
    in-process fleet workers each trace under their own identity."""
    return _TRACER_VAR.set(tracer)


def pop_tracer(token):
    _TRACER_VAR.reset(token)


class Span:
    """One timed interval; ``dur`` is set by :func:`close_span`."""

    __slots__ = ("name", "attrs", "t0", "t1", "dur", "_range")

    def __init__(self, name, attrs=None):
        self.name = name
        self.attrs = attrs
        self.t1 = self.dur = None
        self._range = None
        record = _RECORD
        if record is not None:
            self._range = record(name)
            self._range.__enter__()
        self.t0 = time.perf_counter()


def open_span(name, attrs=None):
    """Start a span now.  Pair with :func:`close_span` in a finally."""
    return Span(name, attrs)


def close_span(s, track=None):
    """End ``s`` and record it on the active tracer, if any.  Returns
    ``s`` with ``dur`` set: the budget accountant reads it there, so an
    interval is measured once."""
    s.t1 = time.perf_counter()
    s.dur = s.t1 - s.t0
    if s._range is not None:
        s._range.__exit__(None, None, None)
        s._range = None
    tr = _TRACER_VAR.get() or _TRACER
    if tr is not None:
        tr.complete(s, track)
    return s


@contextlib.contextmanager
def span(name, track=None, **attrs):
    """``with span("search", chunk=3): ...``; yields the :class:`Span`
    (its ``dur`` set on exit).  ``track`` overrides the context's track
    for this one event."""
    s = open_span(name, attrs or None)
    try:
        yield s
    finally:
        close_span(s, track=track)


class _NullAsync:
    """What :func:`begin_span` returns when tracing is off."""

    __slots__ = ()

    def end(self, **attrs):
        pass


_NULL_ASYNC = _NullAsync()


class AsyncSpan:
    """A span ended explicitly, possibly later and on another thread;
    emitted as a Chrome async ``b``/``e`` pair so it need not nest."""

    __slots__ = ("name", "attrs", "track", "t0", "_tracer", "_id", "_done")

    def __init__(self, name, attrs, track, tracer):
        self.name = name
        self.attrs = attrs
        self.track = track
        self._tracer = tracer
        self._id = tracer.next_id()
        self._done = False
        self.t0 = time.perf_counter()
        tracer.async_begin(self)

    def end(self, **attrs):
        """Complete the span (idempotent; safe after the tracer stopped)."""
        if self._done:
            return
        self._done = True
        self._tracer.async_end(self, time.perf_counter(), attrs or None)


def begin_span(name, track=None, **attrs):
    """Open an async span on the active tracer; a no-op handle when
    tracing is off (callers ``end()`` it blindly)."""
    tr = _TRACER_VAR.get() or _TRACER
    if tr is None:
        return _NULL_ASYNC
    return AsyncSpan(name, attrs or None, track or _TRACK.get(), tr)


def push_track(name):
    """Route spans in this context onto the named track until
    :func:`pop_track`."""
    return _TRACK.set(name)


def pop_track(token):
    _TRACK.reset(token)


@contextlib.contextmanager
def set_track(name):
    """Route spans in this context onto the named track (:func:`push_track`
    and :func:`pop_track` around the block)."""
    token = push_track(name)
    try:
        yield
    finally:
        pop_track(token)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class Tracer:
    """Collects completed spans; exports Chrome trace-event JSON."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events = []
        self._tracks = {}       # track name -> tid (1-based, stable order)
        self._seq = itertools.count(1)
        self._closed = False
        # both clocks anchored back to back: ``epoch`` is the events'
        # timescale, ``epoch_unix`` the same instant on the wall clock
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()

    def next_id(self):
        return next(self._seq)

    def _tid(self, track):
        if track is None:
            t = threading.current_thread()
            track = ("main" if t is threading.main_thread()
                     else t.name or f"thread-{t.ident}")
        with self._lock:
            tid = self._tracks.get(track)
            if tid is None:
                tid = len(self._tracks) + 1
                self._tracks[track] = tid
        return tid

    def _append(self, ev):
        with self._lock:
            if not self._closed:
                self._events.append(ev)

    def _ts(self, t):
        return round((t - self.epoch) * 1e6, 3)  # perf_counter s -> us

    @staticmethod
    def _stamp_ctx(ev):
        ctx = _TRACE_CTX.get()
        if ctx is not None:
            ev["args"] = {**ev.get("args", {}), **ctx}
        return ev

    def complete(self, s, track=None):
        ev = {"name": s.name, "ph": "X", "pid": 1,
              "tid": self._tid(track if track is not None
                               else _TRACK.get()),
              "ts": self._ts(s.t0), "dur": round(s.dur * 1e6, 3)}
        if s.attrs:
            ev["args"] = {k: _jsonable(v) for k, v in s.attrs.items()}
        self._append(self._stamp_ctx(ev))

    def async_begin(self, a):
        ev = {"name": a.name, "ph": "b", "cat": "async", "id": a._id,
              "pid": 1, "tid": self._tid(a.track), "ts": self._ts(a.t0)}
        if a.attrs:
            ev["args"] = {k: _jsonable(v) for k, v in a.attrs.items()}
        self._append(self._stamp_ctx(ev))

    def async_end(self, a, t1, attrs=None):
        ev = {"name": a.name, "ph": "e", "cat": "async", "id": a._id,
              "pid": 1, "tid": self._tid(a.track), "ts": self._ts(t1)}
        if attrs:
            ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
        self._append(ev)

    def close(self):
        with self._lock:
            self._closed = True

    def events_since(self, mark=0):
        """``(events, new_mark)``: the span events recorded from index
        ``mark`` on, and the cursor for the next call.  A fleet worker's
        ``complete`` ships only the events since its previous one; the
        whole list stays for an end-of-run :meth:`export`."""
        with self._lock:
            return list(self._events[mark:]), len(self._events)

    def tracks(self):
        """``{track name: tid}`` (sent beside drained events so the
        collector can name the worker's rows)."""
        with self._lock:
            return dict(self._tracks)

    def to_chrome(self):
        """The Chrome trace-event dict: metadata and recorded events, and
        the ``putpu`` envelope with the wall-clock anchor."""
        with self._lock:
            events = list(self._events)
            tracks = dict(self._tracks)
        meta = [{"name": "process_name", "ph": "M", "pid": 1,
                 "args": {"name": "pulsarutils_tpu_torch"}}]
        for track, tid in tracks.items():
            meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": tid, "args": {"name": track}})
            meta.append({"name": "thread_sort_index", "ph": "M", "pid": 1,
                         "tid": tid, "args": {"sort_index": tid}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "putpu": {"epoch_unix": self.epoch_unix}}

    def export(self, path, extra_meta=None):
        """Write the trace JSON; returns the number of span events.
        ``extra_meta`` merges into the ``putpu`` envelope (a fleet worker
        records its measured ``clock_offset_s`` there, for
        :func:`~.collector.merge_trace_files`)."""
        doc = self.to_chrome()
        if extra_meta:
            doc["putpu"].update(extra_meta)
        with open(path, "w") as f:
            json.dump(doc, f)
        n = sum(ev.get("ph") in ("X", "b") for ev in doc["traceEvents"])
        logger.info("trace: %d spans on %d tracks -> %s",
                    n, len(self._tracks), path)
        return n


def start_tracing():
    """Install a fresh process-wide tracer and return it."""
    global _TRACER
    tracer = Tracer()
    _TRACER = tracer
    return tracer


def stop_tracing():
    """Deactivate and return the current tracer (``None`` if inactive);
    late ``AsyncSpan.end()`` calls against it are dropped."""
    global _TRACER
    tracer = _TRACER
    _TRACER = None
    if tracer is not None:
        tracer.close()
    return tracer


def active_tracer():
    """This context's tracer: the :func:`push_tracer` override when one
    is bound, else the process-wide tracer."""
    return _TRACER_VAR.get() or _TRACER


def is_tracing():
    return (_TRACER_VAR.get() or _TRACER) is not None


#: the device trace's file name inside its directory
DEVICE_TRACE_FILE = "device_trace.json"


def _start_profiler():
    """A running ``torch.profiler`` session over the CPU and, when a card
    is present, CUDA activities."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof, torch.profiler.record_function


@contextlib.contextmanager
def trace_session(path=None, device_trace_dir=None):
    """Wrap a block in the span tracer (exported to ``path`` as Chrome
    JSON) and, when ``device_trace_dir`` is set, a ``torch.profiler``
    device trace written to ``<device_trace_dir>/device_trace.json``
    (Chrome JSON: the CUDA kernels and copies on the card's timeline,
    the host's ops and the spans as ``record_function`` ranges).  Either
    side may be used alone.  Yields the :class:`Tracer` (or ``None``).
    A profiler failure is a warning: observability never takes a run
    down."""
    global _RECORD
    tracer = start_tracing() if path else None
    prof = None
    if device_trace_dir:
        try:
            prof, _RECORD = _start_profiler()
        except Exception as exc:  # noqa: BLE001 — never fatal
            logger.warning("torch.profiler trace unavailable (%r); span "
                           "trace unaffected", exc)
    try:
        yield tracer
    finally:
        if prof is not None:
            _RECORD = None
            try:
                prof.__exit__(None, None, None)
                os.makedirs(str(device_trace_dir), exist_ok=True)
                out = os.path.join(str(device_trace_dir), DEVICE_TRACE_FILE)
                prof.export_chrome_trace(out)
                logger.info("device trace -> %s", out)
            except Exception as exc:  # noqa: BLE001 — never fatal
                logger.warning("torch.profiler trace export failed: %r",
                               exc)
        if tracer is not None:
            stop_tracing()
            tracer.export(path)
