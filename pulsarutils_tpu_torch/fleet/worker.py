"""The fleet worker agent: lease, search, report, drain.

The port of the JAX package's worker.  :class:`FleetWorker` is a thin
shell around the hardened driver: each leased unit runs through
:func:`~..pipeline.search_pipeline.search_by_chunks` with ``chunks=``
restricted to the lease, ``resume=True`` and ``fence=`` the lease's
epoch (a periodicity unit through
:func:`~..periodicity.driver.periodicity_search`), on the worker's own
``device`` (``"cuda"`` by default, raising without a card; ``"cpu"`` on
request).  The device is never a lease key, so a CPU worker and a card
worker of one fleet plan one fingerprint.  Around that it adds:

* **register -> lease -> search -> complete** against a coordinator URL
  (:mod:`.protocol`); each completion carries the worker's metrics
  registry snapshot and health verdict;
* **its own live surface** (:mod:`..obs.server`), whose ``/healthz`` the
  coordinator probes for lease gating and work-stealing;
* **admission**: a lease whose smallest dispatch cannot fit the card's
  budget (``PUTPU_MEM_LIMIT``, else the allocator's limit) goes back with
  ``reason="too_large"`` and the coordinator reshards it;
* **graceful drain** (SIGTERM/SIGINT via
  :meth:`~FleetWorker.install_signal_handlers`, or
  :meth:`~FleetWorker.drain`): the in-flight chunk finishes, its persist
  and ledger write drain, unstarted leases go back via ``release``.

A unit's failure is contained: its error string goes to the coordinator,
which requeues the unit up to ``max_attempts``; nothing is retried on
the host.  A SIGKILLed worker is the chaos case: its lease expires, the
coordinator requeues what the ledger does not show done, and the
re-search writes the same bytes.
"""

from __future__ import annotations

import contextlib
import random
import signal
import threading
import time

from ..faults import inject as fault_inject
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..obs.capacity import UtilizationAccountant
from ..obs.collector import clock_offset
from ..obs.health import HealthEngine
from ..obs.server import start_obs_server
from ..utils.device import resolve_device
from ..utils.logging_utils import logger
from . import protocol

__all__ = ["FleetWorker", "needs_reregister"]


def needs_reregister(exc):
    """True when a lease failure means "the coordinator no longer knows
    this worker" (its restart lost the in-memory worker table).

    The contract is the structured wire code ``unknown_worker``
    (:class:`~.protocol.ProtocolError`); the
    literal-text match survives ONLY as the fallback for old
    coordinators whose 400 bodies carry no ``code`` field — an
    exception carrying any *other* code is a different protocol answer
    and must not trigger re-registration however its message reads.
    """
    code = getattr(exc, "code", None)
    if code is not None:
        return code == "unknown_worker"
    return "unknown worker" in str(exc)


class FleetWorker:
    """One worker process/thread in a coordinator's fleet.

    ``coordinator_url`` is the base of the coordinator's obs surface
    (``http://host:port``); ``http_port`` binds the worker's OWN live
    surface (``0`` = ephemeral — the coordinator learns the bound port
    from the registered ``healthz_url``; ``None`` disables the surface
    and with it health-probed stealing for this worker).  ``max_units``
    is the lease batch size; ``health`` accepts a caller-owned engine
    (tests force verdicts through it).  ``search_overrides`` merge over
    the lease's search config — reserved for host-local, non-science
    knobs (e.g. ``dispatch_timeout``); science keys arrive via the
    lease and overriding them would fork the ledger fingerprint, so
    don't.  ``device`` is where units run: ``"cuda"`` (the default; raises
    here without a card) or ``"cpu"``.  Threads sharing one card share
    the tuner's memo, the launch counters and the registry: on the card,
    run one worker a process.

    Observability knobs (both default-off and byte-inert):
    ``trace=True`` arms this worker's own span tracer — unit spans
    bind each lease's ``trace_id`` and drain to the coordinator's
    trace collector in every ``complete``; ``history_interval_s`` arms
    the metric time-series sampler behind ``/metrics/history``, which
    the coordinator's sweep scrapes for the fleet report's per-worker
    trends.

    Candidate lifecycle knobs (also worker-local — they ride
    ``search_overrides``' host-local lane, never the lease config, so
    the ledger fingerprint is untouched): ``lineage=True`` stamps every
    hit this worker persists with a lineage doc (the driver's
    ``lineage=`` knob per unit); ``push`` is an
    :class:`~pulsarutils_tpu.obs.push.AlertBroker` or a list of
    subscriber specs — one worker-lifetime broker fans detections out
    to webhooks, its delivery counters riding each ``complete``'s
    metrics snapshot to the coordinator's ``/fleet/metrics``.
    """

    def __init__(self, coordinator_url, *, worker_id=None, http_port=0,
                 http_host="127.0.0.1", max_units=1, poll_s=None,
                 health=None, search_overrides=None, trace=False,
                 history_interval_s=None, lineage=False, push=None,
                 push_dead_letter_path=None, device="cuda"):
        #: where this worker's units run; resolved now, so a worker asked
        #: for the card on a host without one fails before registering
        self.device = resolve_device(device)
        self.coordinator_url = coordinator_url.rstrip("/")
        self.requested_id = worker_id
        self.worker_id = None           # assigned at register
        self.http_port = http_port
        self.http_host = http_host
        self.max_units = int(max_units)
        self.poll_s = poll_s
        self.engine = health if health is not None else HealthEngine()
        self.search_overrides = dict(search_overrides or {})
        self.units_done = 0
        self.drained = False
        self._drain = threading.Event()
        self._server = None
        self._lease_ttl_s = None
        #: capacity observability: busy/idle wall accounting
        #: behind the ``putpu_worker_busy_fraction`` /
        #: ``putpu_worker_duty_cycle`` gauges each ``complete`` carries
        self.util = UtilizationAccountant()
        #: jittered exponential idle-poll backoff: consecutive empty
        #: polls double the wait up to this cap, so N idle workers stop
        #: hammering the coordinator in lockstep; any granted lease
        #: resets the streak to the plain ``poll_s`` cadence
        self.idle_backoff_cap_s = 2.0
        self._idle_streak = 0
        self._floor_cache = {}   # fname -> minimum-footprint estimate
        #: distributed tracing: ``trace=True`` gives this
        #: worker its OWN tracer (a contextvar override, so N
        #: in-process workers trace under their own identities); unit
        #: spans bind the lease's trace_id and drain to the
        #: coordinator in every ``complete`` message
        self.trace = bool(trace)
        self.tracer = None
        self._trace_mark = 0
        self._trace_seq = 0     # monotonic per-completion payload id
        #: measured wall-clock offset vs the coordinator (midpoint
        #: rule, refreshed at register); 0.0 until measured
        self.clock_offset_s = 0.0
        #: metric time-series: a sampling interval arms the
        #: ring-buffer sampler and the /metrics/history endpoint the
        #: coordinator's sweep scrapes
        self.history_interval_s = history_interval_s
        self.sampler = None
        #: candidate lifecycle: per-unit lineage docs and a
        #: worker-lifetime alert broker.  A passed AlertBroker stays
        #: caller-owned; a spec list builds one owned here (closed —
        #: bounded — in run()'s finally).
        self.lineage = bool(lineage)
        self.push = None
        self._push_owned = False
        if push is not None:
            from ..obs.push import AlertBroker

            if isinstance(push, AlertBroker):
                self.push = push
            else:
                self.push = AlertBroker(
                    push, health=self.engine,
                    dead_letter_path=push_dead_letter_path)
                self._push_owned = True

    # -- drain ----------------------------------------------------------------

    def drain(self):
        """Request a graceful drain: the in-flight chunk finishes, the
        ledger flushes, unstarted leases return to the coordinator."""
        self._drain.set()

    def install_signal_handlers(self):
        """SIGTERM/SIGINT -> :meth:`drain` (main thread only — the CLI
        entry calls this; in-process test workers call ``drain()``)."""
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda _sig, _frm: self.drain())

    # -- protocol client ------------------------------------------------------

    def _post(self, path, doc, timeout=30.0, timing=None):
        # bounded retry + backoff/jitter on transient transport
        # failures: one flaky connect no longer
        # fails the register/lease/complete/release call outright.
        # ``timing`` brackets the successful attempt only — the
        # clock-offset midpoint rule must never see retry backoff.
        return protocol.post_json_retry(self.coordinator_url + path, doc,
                                        timeout=timeout, timing=timing)

    def _update_clock_offset(self, timing, doc):
        """Refresh the measured coordinator clock offset from one timed
        exchange (register or lease — the offset tracks drift over a
        long-lived worker's life, per the midpoint rule).  No
        ``server_time`` (old coordinator) or no timing = keep the last
        estimate."""
        server_time = doc.get("server_time")
        if server_time is None or "t0" not in timing:
            return
        self.clock_offset_s = clock_offset(timing["t0"], timing["t1"],
                                           server_time)
        if self.worker_id is not None:
            _metrics.gauge("putpu_trace_clock_offset_seconds",
                           worker=self.worker_id).set(
                round(self.clock_offset_s, 6))

    def _register(self, retries=40, backoff_s=0.25):
        healthz_url = None
        if self.http_port is not None:
            if self._server is None:   # re-registration keeps the port
                if self.sampler is None \
                        and self.history_interval_s is not None:
                    from ..obs.timeseries import TimeSeriesSampler

                    self.sampler = TimeSeriesSampler(
                        interval_s=self.history_interval_s).start()
                self._server = start_obs_server(
                    self.http_port, health=self.engine,
                    progress_fn=self._progress_snapshot,
                    host=self.http_host, timeseries=self.sampler,
                    push=self.push)
            healthz_url = (f"http://{self.http_host}:"
                           f"{self._server.port}/healthz")
        from ..resilience.memory_budget import device_budget_bytes

        last = None
        timing = {}
        for attempt in range(retries):
            try:
                doc = self._post("/fleet/register",
                                 {"healthz_url": healthz_url,
                                  "worker": self.requested_id,
                                  # the coordinator sizes
                                  # leases to this budget (absent =
                                  # allocator reports no limit)
                                  "mem_budget_bytes":
                                      device_budget_bytes(self.device)},
                                 timing=timing)
                break
            except OSError as exc:     # coordinator not up yet
                last = exc
                time.sleep(backoff_s)
        else:
            raise OSError(
                f"coordinator {self.coordinator_url} unreachable after "
                f"{retries} attempts") from last
        if doc.get("protocol_version") != protocol.PROTOCOL_VERSION:
            raise ValueError(
                f"coordinator speaks fleet protocol "
                f"{doc.get('protocol_version')!r}, this worker speaks "
                f"{protocol.PROTOCOL_VERSION} — upgrade one of them")
        self.worker_id = doc["worker"]
        self._lease_ttl_s = float(doc.get("lease_ttl_s") or 30.0)
        if self.poll_s is None:
            self.poll_s = float(doc.get("poll_s") or 0.25)
        # clock sync, after worker_id is known so the gauge
        # gets its label: midpoint rule over the successful exchange
        # only (timing excludes retry backoff) — the offset the trace
        # collector applies, recorded as a span attribute so the
        # correction is auditable.  Absent on an old coordinator:
        # spans merge uncorrected.  Refreshed on every lease response
        # too, so a long-lived worker's drift never goes stale.
        self._update_clock_offset(timing, doc)
        logger.info("fleet worker %s registered with %s (healthz: %s, "
                    "clock offset %+.4fs)",
                    self.worker_id, self.coordinator_url,
                    healthz_url or "disabled", self.clock_offset_s)

    def _progress_snapshot(self):
        return {"worker": self.worker_id, "units_done": self.units_done,
                "draining": self._drain.is_set()}

    # -- unit execution -------------------------------------------------------

    def _unit_fits(self, lease):
        """Preflight one lease against this worker's memory budget:
        ``False`` when even the degradation ladder's smallest device
        dispatch — the resident chunk plus one trial block's working
        set — cannot fit, in which case the unit goes back with
        ``reason="too_large"`` and the coordinator re-shards it instead
        of this worker OOM-thrashing through it.  Budget unknown (no
        allocator limit, no ``PUTPU_MEM_LIMIT``: a CPU worker) admits
        everything.  The per-file floor estimate is cached — one header
        read per file, not per lease."""
        from ..resilience.memory_budget import (SAFETY_FRACTION,
                                                device_budget_bytes,
                                                estimate_direct)

        budget = device_budget_bytes(self.device)
        if budget is None:
            return True
        fname = lease["fname"]
        floor = self._floor_cache.get(fname)
        if floor is None:
            try:
                from ..io.sigproc import read_header
                from ..parallel.stream import plan_chunks

                header, _ = read_header(fname)
                config = lease.get("config") or {}
                plan = plan_chunks(
                    header["nsamples"], header["tsamp"],
                    config.get("dmmin", 200), config.get("dmmax", 800),
                    header["fbottom"], header["ftop"], header["foff"],
                    chunk_length=config.get("chunk_length"),
                    new_sample_time=config.get("new_sample_time"))
                t_eff = max(plan.step // plan.resample, 2)
                est = estimate_direct(header["nchans"], t_eff,
                                      max(t_eff // 2, 1), dm_passes=1)
                # the ladder floor: the chunk must be resident plus one
                # trial block's workspace — no split reduces it further
                floor = est["operand"] + est["workspace"] \
                    + est["scoring"]
            except (OSError, ValueError, KeyError) as exc:
                # an unreadable file is the UNIT's problem, not the
                # admission gate's: admit it and let _run_unit report
                # the real error to the coordinator
                logger.warning("fleet worker %s: preflight of %s "
                               "failed (%r); admitting the unit",
                               self.worker_id, fname, exc)
                floor = 0
            self._floor_cache[fname] = floor
        return floor <= SAFETY_FRACTION * budget

    def _run_unit(self, lease):
        """Run one leased unit through the hardened driver; returns the
        ``error`` string for the completion message (``None`` = clean).

        torch and CUDA runtime failures share no base class and one
        poisoned unit must not kill the worker (the coordinator requeues
        it, bounded by ``max_attempts``) — hence the broad handler, a
        reviewed containment seam; nothing is retried on the host.
        Deterministic configuration errors still surface to the
        coordinator as the unit's error string, where ``max_attempts``
        stops the retry loop a crashing config would otherwise spin.
        """
        config = dict(lease["config"])
        config.update(self.search_overrides)
        workload = config.pop("workload", "single_pulse")
        # bind the lease's distributed-trace context: every
        # span the driver records on this thread — chunk, dispatch,
        # persist — carries the unit's trace_id, so the coordinator's
        # lease span and this worker's work share one causal timeline.
        # A malformed/forward-incompatible context must degrade to an
        # UNTRACED unit, never crash the worker mid-lease — tracing is
        # observability, and the protocol promises absent-field
        # back-compat in both directions.
        try:
            tctx = protocol.clean_trace_context(lease.get("trace"))
        except ValueError as exc:
            logger.warning(
                "fleet worker %s: lease %s trace context rejected "
                "(%r) — running the unit untraced (coordinator newer "
                "than this worker?)", self.worker_id, lease["lease"],
                exc)
            tctx = None
        ctx = (_trace.trace_context(tctx["trace_id"],
                                    tctx.get("parent_span_id"))
               if tctx else contextlib.nullcontext())
        with ctx, _trace.span("unit", unit=lease["unit"],
                              lease=lease["lease"],
                              worker=self.worker_id,
                              chunks=len(lease["chunks"])):
            return self._run_unit_inner(lease, config, workload)

    def _run_unit_inner(self, lease, config, workload):
        from ..pipeline.search_pipeline import search_by_chunks

        # deterministic wedge/crash seam for the chaos drill: an armed
        # FaultPlan (PUTPU_FAULT_PLAN survives the subprocess boundary)
        # can hang or fail this worker at unit granularity
        fault_inject.fire("fleet", chunk=lease["chunks"][0])
        try:
            if workload == "periodicity":
                # a periodicity lease is the whole observation (the
                # coordinator shards it as one unit): route it through
                # the full-observation driver, which runs the SAME
                # search_by_chunks transport under the SAME
                # fingerprint_extra the coordinator planned with — the
                # ledger stays the shared completion record
                from ..periodicity.driver import periodicity_search

                kwargs = dict(config)
                accel_max = kwargs.pop("accel_max", 0.0)
                n_accel = kwargs.pop("n_accel", None)
                jerk_max = kwargs.pop("jerk_max", 0.0)
                n_jerk = kwargs.pop("n_jerk", None)
                accel_backend = kwargs.pop("accel_backend", "auto")
                sigma = kwargs.pop("period_sigma_threshold", None)
                kwargs.pop("period_search", None)
                periodicity_search(
                    lease["fname"], accel_max=accel_max,
                    n_accel=n_accel, jerk_max=jerk_max, n_jerk=n_jerk,
                    accel_backend=accel_backend,
                    **({"sigma_threshold": sigma}
                       if sigma is not None else {}),
                    output_dir=lease["output_dir"], resume=True,
                    progress=False, health=self.engine,
                    cancel_cb=self._drain.is_set, device=self.device,
                    # the lease's fencing token covers the periodicity
                    # candidates artifact too — a zombie finishing a
                    # long trial sweep post-steal must not clobber the
                    # new owner's npz
                    fence=lease.get("epoch"), **kwargs)
                return None
            search_by_chunks(
                lease["fname"], chunks=lease["chunks"],
                output_dir=lease["output_dir"], resume=True,
                make_plots=False, progress=False, health=self.engine,
                cancel_cb=self._drain.is_set, device=self.device,
                # the lease's fencing token: artifact writes
                # stamped with a higher epoch — the new owner's, after
                # this lease is stolen — are refused, so a partitioned
                # zombie can never clobber live output.  Absent on an
                # old coordinator: unfenced, the pre-epoch behaviour.
                fence=lease.get("epoch"),
                # candidate lifecycle: worker-local knobs —
                # lineage docs per persisted hit, detections fanned out
                # through the worker-lifetime broker (the driver never
                # closes a passed broker)
                **({"lineage": True} if self.lineage else {}),
                **({"push": self.push} if self.push is not None else {}),
                **config)
            return None
        except Exception as exc:  # noqa: BLE001 — the unit's error string
            logger.error("fleet worker %s: unit %s failed (%r)",
                         self.worker_id, lease["unit"], exc)
            return repr(exc)

    @staticmethod
    def _chunk_wall_sum():
        """Summed ``putpu_chunk_wall_seconds`` so far (the budget
        layer's dispatch→ready chunk spans) — read via snapshot so this
        never *creates* the histogram with the wrong edges."""
        return sum(m.get("sum", 0.0)
                   for m in _metrics.REGISTRY.snapshot()
                   if m.get("name") == "putpu_chunk_wall_seconds")

    def _idle_wait(self):
        """One idle/backoff wait; returns True when a drain landed
        during it.  The wait doubles per consecutive idle poll (capped,
        jittered by up to one ``poll_s`` so idle workers desynchronize)
        and the elapsed time lands on the utilization ledger's idle
        side."""
        base = self.poll_s or 0.25
        wait = min(base * (2 ** self._idle_streak),
                   max(base, self.idle_backoff_cap_s))
        wait += random.uniform(0.0, base)
        self._idle_streak = min(self._idle_streak + 1, 8)
        t0 = time.monotonic()
        drained = self._drain.wait(wait)
        self.util.note_idle(time.monotonic() - t0)
        return drained

    def _complete(self, lease, error, unit_wall_s=None):
        # utilization gauges ride the snapshot below: refresh them
        # first so the coordinator's saturation detector always sees
        # the post-unit fractions
        frac = self.util.busy_fraction()
        if frac is not None:
            _metrics.gauge("putpu_worker_busy_fraction",
                           worker=self.worker_id).set(round(frac, 4))
        duty = self.util.duty_cycle()
        if duty is not None:
            _metrics.gauge("putpu_worker_duty_cycle",
                           worker=self.worker_id).set(round(duty, 4))
        doc = {
            "worker": self.worker_id, "lease": lease["lease"],
            "unit": lease["unit"], "error": error,
            # the unit's measured wall: the coordinator
            # derives grant→work lease wait and the per-worker EWMA
            # throughput from it; absent on an old worker = skipped
            **({"unit_wall_s": round(unit_wall_s, 4)}
               if unit_wall_s is not None else {}),
            # echo the fencing token: a stale-epoch completion (this
            # lease was stolen while we computed) is rejected
            # idempotently on the coordinator — counted, never fatal
            **({"epoch": lease["epoch"]} if "epoch" in lease else {}),
            # a drain-truncated unit says so: the coordinator requeues
            # the remainder WITHOUT burning the unit's max_attempts
            # budget (cooperative preemption is not a poison chunk)
            "drained": self._drain.is_set(),
            "metrics": _metrics.REGISTRY.snapshot(),
            "health": {"status": self.engine.verdict,
                       "reasons": self.engine.reasons()}}
        new_mark = None
        if self.tracer is not None:
            # incremental span drain: only events since the
            # previous completion ride this message; the full list
            # stays local for an end-of-run export (--trace-out).
            # ``seq`` makes the payload idempotent on the coordinator:
            # a wire-level resend of this same message (lost response,
            # post_json_retry) must not double every span in the
            # merged trace.
            events, new_mark = self.tracer.events_since(self._trace_mark)
            doc["trace"] = {"events": events,
                            "tracks": self.tracer.tracks(),
                            "epoch_unix": self.tracer.epoch_unix,
                            "clock_offset_s": self.clock_offset_s,
                            "seq": self._trace_seq + 1}
        resp = self._post("/fleet/complete", doc)
        if new_mark is not None:
            # commit the drain cursor only AFTER the post landed: a
            # completion that failed past its retries must leave the
            # events in place for the NEXT message, or the merged
            # trace permanently loses this unit's worker spans
            self._trace_mark = new_mark
            self._trace_seq += 1
        return resp

    def _release(self, leases, reason):
        if not leases:
            return
        try:
            self._post("/fleet/release", {
                "worker": self.worker_id,
                "leases": [le["lease"] for le in leases],
                "epochs": {le["lease"]: le["epoch"] for le in leases
                           if "epoch" in le},
                "reason": reason})
        except (OSError, ValueError) as exc:
            # the coordinator is gone or rejecting: its lease TTL will
            # requeue these anyway — drain must not hang on it
            logger.warning("fleet worker %s: release failed (%r); the "
                           "lease TTL covers it", self.worker_id, exc)

    # -- the main loop --------------------------------------------------------

    def run(self, max_idle_s=None):
        """Register, then lease/search/complete until the survey is
        done or a drain lands.  ``max_idle_s`` bounds how long the
        worker polls an idle (but unfinished) queue before exiting —
        ``None`` polls forever (the deployment shape: workers outlive
        surveys).  Returns the number of units this worker completed.
        """
        tracer_token = None
        if self.trace and self.tracer is None:
            # the worker's OWN tracer, installed as a contextvar
            # override on this thread: driver spans recorded while a
            # unit runs land here — not on any process-wide tracer —
            # so N in-process workers each drain their own identity
            self.tracer = _trace.Tracer()
            tracer_token = _trace.push_tracer(self.tracer)
        self._register()
        idle_since = None
        try:
            while not self._drain.is_set():
                try:
                    # the health self-report rides every lease request:
                    # a denied worker whose transient conditions decayed
                    # must be able to TELL the coordinator so (probes
                    # only exist where a healthz_url was registered)
                    timing = {}
                    resp = self._post("/fleet/lease",
                                      {"worker": self.worker_id,
                                       "max_units": self.max_units,
                                       "health": {
                                           "status": self.engine.verdict,
                                           "reasons":
                                               self.engine.reasons()}},
                                      timing=timing)
                    # every lease poll refreshes the clock offset: a
                    # worker that outlives surveys must track drift,
                    # not trust its registration-time estimate forever
                    self._update_clock_offset(timing, resp)
                except (OSError, ValueError) as exc:
                    # the coordinator restarted and lost its worker
                    # table: re-register (same live surface/port)
                    # instead of spinning as a zombie forever
                    if needs_reregister(exc):
                        logger.warning(
                            "fleet worker %s: coordinator no longer "
                            "knows us (%r) — re-registering",
                            self.worker_id, exc)
                        self._register()
                        continue
                    logger.warning(
                        "fleet worker %s: lease request failed (%r); "
                        "retrying", self.worker_id, exc)
                    # an unreachable coordinator counts as idle time:
                    # run(max_idle_s=...) must still bound the wait
                    if idle_since is None:
                        idle_since = time.monotonic()
                    elif max_idle_s is not None \
                            and time.monotonic() - idle_since > max_idle_s:
                        logger.info(
                            "fleet worker %s: coordinator unreachable "
                            "past %.1fs, exiting", self.worker_id,
                            max_idle_s)
                        break
                    if self._idle_wait():
                        break
                    continue
                leases = resp.get("leases") or []
                if not leases:
                    if resp.get("survey_done"):
                        logger.info("fleet worker %s: survey complete",
                                    self.worker_id)
                        break
                    # the utilization denominator: every
                    # empty poll is counted, and the backoff below
                    # keeps N of them from arriving in lockstep
                    _metrics.counter(
                        "putpu_fleet_idle_polls_total").inc()
                    if resp.get("denied"):
                        logger.info(
                            "fleet worker %s: leases denied (%s) — "
                            "standing by", self.worker_id,
                            resp["denied"])
                        # idle tick: a *data*-driven transient condition
                        # (a pulse chunk's candidate spike) raised while
                        # searching must be able to decay while denied,
                        # or denial would be permanent — a neutral
                        # update ages non-sticky conditions exactly as
                        # clean chunks would (sticky ones, e.g. the
                        # numpy fallback, rightly never recover)
                        self.engine.update("fleet-idle")
                    if idle_since is None:
                        idle_since = time.monotonic()
                    elif max_idle_s is not None \
                            and time.monotonic() - idle_since \
                            > max_idle_s:
                        logger.info("fleet worker %s: idle past %.1fs, "
                                    "exiting", self.worker_id, max_idle_s)
                        break
                    if self._idle_wait():
                        break
                    continue
                idle_since = None
                self._idle_streak = 0
                for i, lease in enumerate(leases):
                    if self._drain.is_set():
                        # unstarted leases go straight back; the
                        # coordinator re-leases them to live workers
                        self._release(leases[i:], "drain")
                        break
                    if not self._unit_fits(lease):
                        # admission preflight: this unit's
                        # floor footprint exceeds our memory budget —
                        # return it as too_large so the coordinator
                        # re-shards it smaller instead of requeueing
                        # it verbatim onto the next victim
                        logger.warning(
                            "fleet worker %s: unit %s too large for "
                            "this worker's memory budget — releasing "
                            "for re-shard", self.worker_id,
                            lease["unit"])
                        self._release([lease], "too_large")
                        continue
                    t_unit0 = time.monotonic()
                    dev0 = self._chunk_wall_sum()
                    error = self._run_unit(lease)
                    unit_wall = time.monotonic() - t_unit0
                    self.util.note_busy(unit_wall)
                    self.util.note_device(self._chunk_wall_sum() - dev0)
                    try:
                        self._complete(lease, error,
                                       unit_wall_s=unit_wall)
                    except (OSError, ValueError) as exc:
                        logger.warning(
                            "fleet worker %s: completion report for %s "
                            "failed (%r) — the ledger already records "
                            "the work; the lease TTL resolves it",
                            self.worker_id, lease["unit"], exc)
                    if error is None:
                        self.units_done += 1
        finally:
            if self._drain.is_set():
                # the driver already flushed persists + ledger for the
                # in-flight chunk (its normal exit path); this counts
                # the drain and says so
                self.drained = True
                _metrics.counter("putpu_fleet_drains_total").inc()
                logger.info(
                    "fleet worker %s: drained (%d unit(s) completed; "
                    "in-flight chunk finished, ledger flushed, "
                    "unstarted leases returned)",
                    self.worker_id or "<unregistered>", self.units_done)
            if tracer_token is not None:
                _trace.pop_tracer(tracer_token)
            if self.push is not None and self._push_owned:
                # bounded: a wedged webhook must not stall worker exit
                # (undelivered alerts are journaled to the dead-letter
                # file inside close())
                import json as _json

                logger.info("fleet worker %s: PUSH_JSON %s",
                            self.worker_id or "<unregistered>",
                            _json.dumps(self.push.close()))
            if self.sampler is not None:
                self.sampler.stop()
            if self._server is not None:
                self._server.close()
        return self.units_done
