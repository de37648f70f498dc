"""The fleet wire protocol: JSON messages over plain HTTP.

The port of the JAX package's protocol, message for message, so a port
worker and a JAX coordinator (or the reverse) speak one wire.  Four POST
messages drive the fleet (served by the coordinator's
:mod:`~..obs.server` surface under ``/fleet/``):

========== ============================================================
message    body
========== ============================================================
register   ``{"healthz_url": str|null, "worker": str|null,
           "mem_budget_bytes": int|absent}`` ->
           ``{"worker": id, "lease_ttl_s", "poll_s",
           "protocol_version", "server_time"}``; the memory budget lets
           the coordinator size leases to the worker's card
lease      ``{"worker": id, "max_units": n, "health": {verdict
           doc}|absent}`` -> ``{"leases": [{"lease", "unit", "fname",
           "chunks", "config", "output_dir", "expires_in_s", "epoch",
           "trace"}], "denied": str|null, "survey_done": bool,
           "poll_s": float, "server_time"}``; ``epoch`` is the unit's
           monotonic fencing token: it moves on every requeue, steal,
           reshard and recovery, the worker passes it as the artifact
           fence and echoes it back, so a late report of a stolen
           lease is detectably stale
complete   ``{"worker", "lease", "unit", "error": str|null,
           "epoch": int|absent, "unit_wall_s": float|absent,
           "drained": bool, "metrics": [registry snapshot],
           "health": {verdict doc}, "trace": {...}|absent}`` ->
           ``{"ok", "unit_done", "requeued": [chunks],
           "survey_done"}``; a stale ``epoch`` is answered
           ``{"ok": true, "stale": true, ...}``, counted, never fatal.
           ``unit_wall_s`` is the worker's busy wall for the unit: the
           coordinator derives the lease wait from it and folds it into
           the throughput model behind ``/fleet/capacity``
release    ``{"worker", "leases": [ids], "epochs": {id: epoch}|absent,
           "reason": str}`` -> ``{"ok", "requeued": n}``: a draining
           worker returns unstarted leases and gets no more, except
           for ``reason="too_large"`` (the unit's preflight estimate
           exceeds the worker's memory budget): the coordinator then
           reshards the unit smaller and the worker stays in service
========== ============================================================

A rejection is an HTTP 400 whose JSON body carries the message and,
where a decision hangs on it, a ``code`` (:class:`ProtocolError`:
``unknown_worker`` makes a worker re-register after a coordinator
restart).

Rules:

* **the ledger is the completion record**: nothing in these messages is
  trusted for completion; the coordinator re-reads each file's resume
  ledger at every grant, completion and requeue (:mod:`.coordinator`);
* **the config rides the lease**: a lease carries the exact
  ``search_by_chunks`` keyword subset (:data:`SEARCH_KEYS`) the
  coordinator planned the file with, so workers need no configuration
  of their own and cannot drift onto another ledger fingerprint.  The
  device is the worker's own (``FleetWorker(device=)``), never a lease
  key, and the port's driver takes no ``backend``: :data:`SEARCH_KEYS`
  is the JAX package's less ``"backend"``;
* the protocol assumes a **shared filesystem** for ``output_dir``
  (ledgers and candidates); the HTTP link carries control traffic only.

``register`` returns :data:`PROTOCOL_VERSION` and the worker refuses a
mismatch.  Tracing fields are optional both ways (an untraced peer keeps
working): ``server_time`` in the ``register`` and ``lease`` replies (the
worker's clock offset by the midpoint rule,
:func:`~..obs.collector.clock_offset`), ``trace`` on each lease
(:data:`TRACE_KEYS`, validated by :func:`clean_trace_context`) and on
``complete`` (the worker's drained spans, for the coordinator's
:class:`~..obs.collector.TraceCollector`).
"""

from __future__ import annotations

import http.client
import json
import random
import time
import urllib.error
import urllib.request

__all__ = ["PROTOCOL_VERSION", "SEARCH_KEYS", "TRACE_KEYS",
           "TRANSIENT_WIRE_ERRORS", "ProtocolError",
           "clean_search_config", "clean_trace_context", "get_json",
           "post_json", "post_json_retry", "require"]

PROTOCOL_VERSION = 1


class ProtocolError(ValueError):
    """A protocol-level rejection carrying a machine-readable ``code``.

    Handlers raise ``ProtocolError(msg, code="unknown_worker")``, the
    HTTP layer sends the code beside the message (``{"error": ...,
    "code": ...}``) and :func:`post_json` re-attaches it on the client
    side, so callers branch on ``exc.code``, not on the message text.
    """

    def __init__(self, message, code=None):
        super().__init__(message)
        self.code = code

#: the trace-context fields a lease may carry: the
#: SEARCH_KEYS rule applied to tracing: the allowed set is written
#: down, and an unknown key fails at the seam.  Absent entirely =
#: untraced lease (old-coordinator back-compat).
TRACE_KEYS = ("trace_id", "parent_span_id")

#: transport failures worth one more try: a flaky connect, a reset
#: socket, a timed-out read.  ``urllib.error.URLError`` wraps most
#: transport errors (and is an ``OSError``); ``ConnectionError`` covers
#: the raw ``ConnectionResetError``/``ConnectionRefusedError`` the
#: http.client layer can leak mid-send; ``http.client.HTTPException``
#: covers a torn response.  An HTTP *status* error is a ``ValueError``
#: from :func:`post_json` and is never retried — the coordinator said
#: no, and repeating the question would just repeat the answer.
TRANSIENT_WIRE_ERRORS = (urllib.error.URLError, ConnectionError,
                         TimeoutError, http.client.HTTPException)

#: the ``search_by_chunks`` keyword arguments a lease may carry.  The
#: science-affecting subset feeds the ledger fingerprint via
#: ``plan_survey`` — the coordinator and every worker MUST agree on
#: these, which is why they travel in the lease rather than in worker
#: configuration.  Session-shaping knobs (``output_dir``, ``resume``,
#: ``chunks``, ``make_plots``, ``progress``, callbacks) are owned by
#: the coordinator/worker themselves and deliberately excluded, and so is
#: the JAX package's ``"backend"``: the port's driver has none, and the
#: device a unit runs on is the worker's (a CPU worker and a card worker
#: of one fleet plan one fingerprint).
SEARCH_KEYS = (
    "dmmin", "dmmax", "chunk_length", "new_sample_time", "tmin",
    "snr_threshold", "kernel", "exact_floor", "fft_zap",
    "cut_outliers", "zero_dm", "period_search", "period_sigma_threshold",
    "quarantine_policy", "overlap_persist", "dispatch_timeout",
    "dispatch_retries", "dispatch_backoff", "persist_retries",
    "persist_backoff",
    # the periodicity workload rides the lease too: the
    # coordinator plans its fingerprint with the matching
    # fingerprint_extra and the worker routes the unit to
    # periodicity_search — the lease stays the single source of truth
    # for what a unit runs
    "workload", "accel_max", "n_accel", "jerk_max", "n_jerk",
    "accel_backend",
)


def clean_search_config(config):
    """Validate a lease search config; returns a plain JSON-safe dict.

    Raises ``ValueError`` naming any key outside :data:`SEARCH_KEYS` —
    a typoed knob must fail at submission, not silently fork the fleet
    onto a different ledger fingerprint than the coordinator planned.
    """
    if not isinstance(config, dict):
        raise ValueError("search config must be a JSON object")
    unknown = sorted(set(config) - set(SEARCH_KEYS))
    if unknown:
        raise ValueError(
            f"search config keys {unknown} are not leaseable "
            f"(allowed: {sorted(SEARCH_KEYS)})")
    out = {k: config[k] for k in SEARCH_KEYS if k in config}
    # round-trip through JSON now: a non-serialisable value (a Mesh, a
    # callable) must fail at add_survey time, not mid-lease on the wire
    return json.loads(json.dumps(out))


def clean_trace_context(ctx):
    """Validate a lease's ``trace`` field; returns a plain dict (or
    ``None`` for an absent/null context — the untraced back-compat
    path).  Raises ``ValueError`` on unknown keys or non-string values:
    a malformed context must fail at the seam, not produce a trace
    whose ids silently mean something else."""
    if ctx is None:
        return None
    if not isinstance(ctx, dict):
        raise ValueError("trace context must be a JSON object or null")
    unknown = sorted(set(ctx) - set(TRACE_KEYS))
    if unknown:
        raise ValueError(f"trace context keys {unknown} are not in "
                         f"{sorted(TRACE_KEYS)}")
    if not isinstance(ctx.get("trace_id"), str) or not ctx["trace_id"]:
        raise ValueError("trace context needs a non-empty string "
                         "trace_id")
    parent = ctx.get("parent_span_id")
    if parent is not None and not isinstance(parent, str):
        raise ValueError("parent_span_id must be a string or absent")
    return {k: ctx[k] for k in TRACE_KEYS if ctx.get(k) is not None}


def require(doc, key, types, what="message"):
    """Fetch ``doc[key]`` asserting its type; ``ValueError`` otherwise
    (the HTTP layer maps that to a 400)."""
    if not isinstance(doc, dict):
        raise ValueError(f"{what} must be a JSON object")
    if key not in doc:
        raise ValueError(f"{what} missing key {key!r}")
    if not isinstance(doc[key], types):
        raise ValueError(
            f"{what} key {key!r} must be "
            f"{getattr(types, '__name__', types)}, got "
            f"{type(doc[key]).__name__}")
    return doc[key]


def post_json(url, doc, timeout=10.0):
    """POST ``doc`` as JSON; returns the decoded response body.

    Transport failures raise ``OSError`` (``urllib.error.URLError`` is
    one); an HTTP error status raises ``ValueError`` carrying the
    server's body — the coordinator puts the protocol violation text
    there, so the worker's log names the actual problem.
    """
    req = urllib.request.Request(
        url, method="POST", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode() or "{}")
    except urllib.error.HTTPError as exc:
        body = exc.read().decode(errors="replace")
        # surface the server's structured error code when the body
        # carries one, so callers branch on exc.code instead of
        # grepping the message text
        code = None
        try:
            parsed = json.loads(body or "{}")
            if isinstance(parsed, dict):
                code = parsed.get("code")
        except ValueError:
            pass
        raise ProtocolError(
            f"{url} -> HTTP {exc.code}: {body.strip()}",
            code=code) from exc


def post_json_retry(url, doc, timeout=10.0, retries=3, backoff_s=0.2,
                    jitter_s=0.1, timing=None):
    """:func:`post_json` with bounded retry on transient transport
    failures, so one flaky connect does not fail a register, lease,
    complete or release.

    Exponential backoff with uniform jitter — a fleet of workers
    retrying a briefly-unreachable coordinator must not reconverge in
    lockstep.  Each retry counts ``putpu_fleet_wire_retries_total``;
    the final failure propagates unchanged.  HTTP status errors
    (``ValueError``) are never retried — they are protocol answers,
    not transport weather.

    ``timing`` (a dict) receives ``t0``/``t1`` wall-clock
    stamps bracketing the SUCCESSFUL attempt only — the clock-offset
    midpoint rule needs one request–response exchange, and a window
    inflated by failed attempts + backoff would corrupt the offset by
    half the retry time.

    Partition chaos: every attempt first consults the ``"wire"`` fault
    site (:func:`~..faults.inject.wire_action`) — ``drop`` raises a synthetic transport error (the
    message never reaches the coordinator, consuming a retry exactly
    like a real partition), ``delay`` sleeps before sending, and
    ``duplicate`` sends the message twice (a retransmit where both
    copies land — the coordinator's idempotency contract under test).
    Byte-inert with no plan armed, like every other hook.
    """
    from ..faults import inject as fault_inject
    from ..obs import metrics as _metrics

    msg = url.rstrip("/").rsplit("/", 1)[-1]
    last = None
    for attempt in range(max(int(retries), 0) + 1):
        try:
            act = fault_inject.wire_action("wire", msg=msg)
            if act is not None:
                kind, seconds = act
                if kind == "drop":
                    raise urllib.error.URLError(
                        f"FAULTPLAN: injected wire drop ({msg})")
                if kind == "delay":
                    time.sleep(seconds)
            t0 = time.time()
            out = post_json(url, doc, timeout=timeout)
            t1 = time.time()
            if act is not None and act[0] == "duplicate":
                # the retransmit's reply is what the client keeps, but
                # the timing window must bracket ONE exchange — the
                # clock-offset midpoint rule's contract above
                out = post_json(url, doc, timeout=timeout)
            if timing is not None:
                timing["t0"] = t0
                timing["t1"] = t1
            return out
        except ValueError:
            raise  # HTTP status: the server answered; do not re-ask
        except TRANSIENT_WIRE_ERRORS as exc:
            last = exc
            if attempt >= retries:
                break
            _metrics.counter("putpu_fleet_wire_retries_total").inc()
            time.sleep(backoff_s * (2 ** attempt)
                       + random.uniform(0.0, jitter_s))
    raise last


def get_json(url, timeout=5.0):
    """GET a JSON document (the coordinator's worker-health probe).

    Returns ``(status, doc)`` — a ``/healthz`` 503 is a *successful*
    probe of a CRITICAL worker, so HTTP error statuses with a JSON body
    are decoded, not raised.  Transport failures raise ``OSError``.
    """
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode() or "{}")
    except urllib.error.HTTPError as exc:
        body = exc.read().decode(errors="replace")
        try:
            return exc.code, json.loads(body or "{}")
        except ValueError:
            return exc.code, {"error": body.strip()}
