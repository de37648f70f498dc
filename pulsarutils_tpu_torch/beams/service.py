"""The job service behind ``/jobs``: :class:`SurveyService`.

The port of the JAX package's multi-tenant work queue, on host threads
around the port's drivers:

* :meth:`SurveyService.submit` validates a job spec (a filterbank path,
  a DM range and knobs; :func:`validate_spec`, the JAX package's rules
  and error strings), gives it an id and queues it; ``POST /jobs``
  lands here (:mod:`..obs.server`);
* one worker thread drains the queue in arrival order and **co-batches
  same-geometry single-pulse jobs**: files whose headers share a chunk
  geometry become the beams of one
  :func:`~.multibeam.multibeam_search` call on ``device`` (one dispatch
  a chunk epoch serves every tenant), with the coincidence sift across
  the group; a ``workload="periodicity"`` job runs alone through
  :func:`~..periodicity.driver.periodicity_search`;
* each job's resume ledger is its completion record: the store's
  fingerprint depends on the job's own (file, physics) configuration
  only, so a cancelled job submitted again resumes from exactly the
  chunks it finished, whatever else shared its batch (and two jobs on
  one file and physics share one ledger, merged on every write);
* per job: ``putpu_job_chunks_done_total`` and ``putpu_job_hits_total``
  labelled by job id, its own :class:`~..obs.health.HealthEngine`, and
  its terminal state counted in ``putpu_jobs_finished_total``.

Lifecycle: ``queued -> running -> done | failed | cancelled``; a cancel
is checked between chunks, and a job cancelled while queued never
starts.  A job that raises is ``failed`` with ``repr(exc)`` in its
document, so one bad job does not stop the worker; nothing runs it again
on the host or with another kernel.  The service runs on the card unless
the caller asks for ``device="cpu"``, and raises without a card.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

from ..io.candidates import CandidateStore
from ..io.sigproc import read_header
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..obs.health import HealthEngine
from ..utils.device import resolve_device
from ..utils.logging_utils import logger

__all__ = ["SurveyService", "JobSpec", "validate_spec", "QUEUED",
           "RUNNING", "DONE", "FAILED", "CANCELLED"]

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"

#: spec keys forwarded verbatim to :func:`~.multibeam.multibeam_search`
_FORWARD_KEYS = ("snr_threshold", "max_chunks", "chunk_length",
                 "new_sample_time", "canary_rate", "veto_frac",
                 "max_real_beams")

#: keys a ``workload="periodicity"`` job may carry on top of the shared
#: ones; ``period_sigma_threshold`` maps onto the driver's
#: ``sigma_threshold``
_PERIOD_KEYS = ("accel_max", "n_accel", "jerk_max", "n_jerk",
                "accel_backend", "period_sigma_threshold")

#: keys only the batched multibeam runner understands — rejected
#: explicitly on periodicity jobs (silently dropping a requested knob
#: would misrepresent what ran)
_MULTIBEAM_ONLY = ("canary_rate", "veto_frac", "max_real_beams",
                   "max_chunks")

WORKLOADS = ("single_pulse", "periodicity")


def JobSpec(fname, dmmin, dmmax, workload=None, **knobs):
    """Normalise a job spec dict (the POST /jobs body shape)."""
    spec = {"fname": str(fname), "dmmin": float(dmmin),
            "dmmax": float(dmmax)}
    if workload is not None and str(workload) != "single_pulse":
        # the default workload is normalised AWAY: an explicit
        # "single_pulse" must produce the same spec (and the same
        # co-batching geometry tag) as omitting the key
        spec["workload"] = str(workload)
    for key in (*_FORWARD_KEYS, *_PERIOD_KEYS):
        if key in knobs and knobs[key] is not None:
            spec[key] = knobs[key]
    return spec


def validate_spec(spec):
    """Validate + normalise a ``POST /jobs``-shaped job spec; raises
    ``ValueError`` on a bad one (the HTTP layer maps that to a 400).

    ONE set of submission rules, the JAX package's, shared with the
    fleet coordinator's job handoff
    (:meth:`~..fleet.coordinator.FleetCoordinator.add_job`): a spec
    either deployment accepts is valid in the other.

    ``workload`` selects the job type: ``"single_pulse"`` (default — the
    batched multibeam run) or ``"periodicity"`` (the full-observation
    acceleration search,
    :func:`~..periodicity.driver.periodicity_search`).
    Periodicity jobs may carry :data:`_PERIOD_KEYS`; multibeam-only
    knobs on them — and periodicity-only knobs on single-pulse jobs —
    are rejected, not dropped.
    """
    if not isinstance(spec, dict):
        raise ValueError("job spec must be a JSON object")
    missing = {"fname", "dmmin", "dmmax"} - set(spec)
    if missing:
        raise ValueError(f"job spec missing keys: {sorted(missing)}")
    workload = spec.get("workload", "single_pulse")
    if workload not in WORKLOADS:
        raise ValueError(f"workload={workload!r}: expected one of "
                         f"{WORKLOADS}")
    if workload == "periodicity":
        bad = sorted(set(spec) & set(_MULTIBEAM_ONLY))
        if bad:
            raise ValueError(
                f"job spec keys {bad} are multibeam-only knobs a "
                "periodicity job does not run")
        if float(spec.get("accel_max", 0.0)) < 0:
            raise ValueError("accel_max must be >= 0")
        if float(spec.get("jerk_max", 0.0)) < 0:
            raise ValueError("jerk_max must be >= 0")
        backend_choice = spec.get("accel_backend", "auto")
        if backend_choice not in ("auto", "time_stretch", "fdas"):
            raise ValueError(
                f"accel_backend={backend_choice!r}: expected 'auto', "
                "'time_stretch' or 'fdas'")
    else:
        bad = sorted(set(spec) & set(_PERIOD_KEYS))
        if bad:
            raise ValueError(
                f"job spec keys {bad} require workload='periodicity'")
    spec = JobSpec(**{k: spec[k] for k in
                      ({"fname", "dmmin", "dmmax", "workload"}
                       | set(_FORWARD_KEYS) | set(_PERIOD_KEYS))
                      & set(spec)})
    if not os.path.exists(spec["fname"]):
        raise ValueError(f"no such file: {spec['fname']}")
    if not spec["dmmin"] < spec["dmmax"]:
        raise ValueError(
            f"dmmin {spec['dmmin']} must be < dmmax {spec['dmmax']}")
    return spec


class _Job:
    """One submitted job (all mutable state guarded by the service
    lock; the cancel event is the one cross-thread signal the driver's
    cancel hook reads lock-free)."""

    def __init__(self, job_id, spec, output_dir, geom_tag=None):
        self.id = job_id
        self.spec = spec
        self.output_dir = output_dir
        #: batchability key, computed ONCE at submit (the header read
        #: must not repeat under the service lock on every batch pop)
        self.geom_tag = geom_tag
        #: distributed-trace identity: every span the job's run records
        #: carries this id, so one ``/jobs`` submission is one causal
        #: timeline in the trace
        self.trace_id = _trace.new_trace_id()
        self.span = None       # async "job" span, open while running
        self.state = QUEUED
        self.error = None
        self.submitted_at = time.time()
        self.started_at = None
        self.finished_at = None
        self.chunks_done = 0
        self.chunks_total = None
        self.hits = 0
        self.coincidence = None
        self.period = None      # periodicity-job summary
        self.batch_group = None  # job ids co-batched with this one
        self.cancel_event = threading.Event()
        self.health = HealthEngine()

    def doc(self):
        """The JSON document GET /jobs/<id> serves."""
        return {
            "id": self.id, "state": self.state, "spec": dict(self.spec),
            "trace_id": self.trace_id,
            "output_dir": self.output_dir, "error": self.error,
            "submitted_at": round(self.submitted_at, 3),
            "started_at": (round(self.started_at, 3)
                           if self.started_at else None),
            "finished_at": (round(self.finished_at, 3)
                            if self.finished_at else None),
            "chunks_done": self.chunks_done,
            "chunks_total": self.chunks_total,
            "hits": self.hits,
            "coincidence": self.coincidence,
            "period": self.period,
            "batch_group": self.batch_group,
            "health": {"status": self.health.verdict,
                       "reasons": self.health.reasons()},
        }


def _geometry_tag(fname):
    """Batchability key of a filterbank: the header fields the shared
    chunk plan derives from.  Jobs sharing a tag (and a DM range /
    threshold) become beams of one batched run."""
    header, _ = read_header(fname)
    return (int(header["nchans"]), float(header["tsamp"]),
            float(header["fch1"]), float(header["foff"]),
            int(header.get("nifs", 1)), int(header.get("nbits", 32)))


class SurveyService:
    """Thread-safe job queue + one batching worker.

    ``output_dir`` roots every job's candidate store/ledger
    (per-job subdirectory ``job output_dir/<job_id>`` would break
    resume across resubmissions, so stores are rooted per *file* under
    ``output_dir`` — the ledger fingerprint already isolates configs);
    ``batch_window_s`` is how long the worker waits after the first
    queued job for same-geometry company before dispatching (0 =
    dispatch immediately, every job its own batch).  ``device`` is where
    every job runs (``"cuda"`` by default, raising without a card;
    ``"cpu"`` on request).

    ``max_done_jobs`` bounds the in-memory job table of a long-lived
    deployment: once more than that many jobs sit in a TERMINAL state,
    the oldest are evicted (their documents 404 afterwards; the durable
    record is the per-file ledger + candidate store, which eviction
    never touches).  NOTE the per-job metric series
    (``putpu_job_chunks_done_total{job=...}``) are append-only in the
    process registry — a deployment scraping them should rely on
    Prometheus retention, and a very-long-lived process should restart
    on the fleet's normal cadence.
    """

    def __init__(self, output_dir, *, batch_window_s=0.05, resume=True,
                 max_done_jobs=1000, device="cuda"):
        # no card: raise before the worker starts
        self.device = str(resolve_device(device))
        self.output_dir = str(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        self.batch_window_s = float(batch_window_s)
        self.resume = bool(resume)
        self.max_done_jobs = int(max_done_jobs)
        self._lock = threading.Lock()
        self._jobs = {}
        self._queue = []
        self._ids = itertools.count(1)
        self._wake = threading.Event()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="survey-jobs")
        self._worker.start()

    # -- the public API (HTTP handlers call these) ---------------------------

    def submit(self, spec):
        """Queue a job; returns its id.  Raises ``ValueError`` on a bad
        spec (missing/unreadable file, inverted DM range) — the HTTP
        layer maps that to a 400.  Validation rules live in
        :func:`validate_spec`, shared with the fleet coordinator's job
        handoff."""
        spec = validate_spec(spec)
        # header must parse at submit time — and the batchability tag it
        # yields is cached on the job so batch pops never touch disk
        geom_tag = (_geometry_tag(spec["fname"]),
                    tuple(sorted((k, v) for k, v in spec.items()
                                 if k != "fname")))
        with self._lock:
            if self._closed:
                raise ValueError("service is shut down")
            job_id = f"job-{next(self._ids)}"
            self._jobs[job_id] = _Job(job_id, spec, self.output_dir,
                                      geom_tag=geom_tag)
            self._queue.append(job_id)
            self._evict_done_locked()
        _metrics.counter("putpu_jobs_submitted_total").inc()
        logger.info("job %s submitted: %s DM %g-%g", job_id,
                    os.path.basename(spec["fname"]), spec["dmmin"],
                    spec["dmmax"])
        self._wake.set()
        return job_id

    def get(self, job_id):
        """The job document, or ``None`` for an unknown id."""
        with self._lock:
            job = self._jobs.get(job_id)
            return job.doc() if job is not None else None

    def jobs(self):
        """All job documents, newest first."""
        with self._lock:
            return [j.doc() for j in
                    sorted(self._jobs.values(),
                           key=lambda j: j.submitted_at, reverse=True)]

    def cancel(self, job_id):
        """Request cancellation; returns the job document or ``None``.

        A queued job flips to ``cancelled`` immediately; a running job
        flips once the driver's per-chunk cancel hook observes the
        event (its completed chunks stay in the ledger — resubmission
        resumes exactly).
        """
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            job.cancel_event.set()
            if job.state == QUEUED:
                self._queue.remove(job_id)
                self._finish_locked(job, CANCELLED)
            return job.doc()

    def close(self, timeout=10.0):
        """Stop the worker (running batches finish their current chunk
        loop via the cancel hooks)."""
        with self._lock:
            self._closed = True
            for job_id in self._queue:
                self._finish_locked(self._jobs[job_id], CANCELLED)
            del self._queue[:]
            for job in self._jobs.values():
                job.cancel_event.set()
        self._wake.set()
        self._worker.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker --------------------------------------------------------------

    def _evict_done_locked(self):
        """Drop the oldest TERMINAL jobs beyond ``max_done_jobs`` (the
        per-file ledger/candidates on disk are the durable record)."""
        done = [j for j in self._jobs.values()
                if j.state in (DONE, FAILED, CANCELLED)]
        if len(done) <= self.max_done_jobs:
            return
        done.sort(key=lambda j: j.finished_at or 0.0)
        for job in done[:len(done) - self.max_done_jobs]:
            del self._jobs[job.id]

    def _finish_locked(self, job, state, error=None):
        job.state = state
        job.error = error
        job.finished_at = time.time()
        if job.span is not None:
            job.span.end(outcome=state)
            job.span = None
        _metrics.counter("putpu_jobs_finished_total", status=state).inc()

    def _admission_cap(self, job):
        """Beam count the device memory budget admits for one co-batch
        of this job's geometry (``None`` = no budget known, no cap).

        Pure host math off the header fields cached in the geometry
        tag (no disk under the lock): the chunk plan the batched run
        will use is re-derived from the same physics
        (:func:`~..parallel.stream.plan_chunks`) with its trial grid
        (:func:`~..ops.plan.dedispersion_plan`) and the batcher's
        blocking (32-trial blocks, :func:`~..ops.search.auto_chan_block`
        channels), and the footprint estimator's
        :func:`~..resilience.memory_budget.max_beam_batch` caps the
        batch so co-tenants are never batched into an OOM.  The JAX
        package estimates half the chunk's samples as trials over all
        channels, more than an 80 GB card holds at 2^18-sample chunks
        (its cap would always be one beam); the port counts what the
        batcher dispatches, the bound its own preflight splits against.
        """
        from ..ops.plan import dedispersion_plan
        from ..ops.search import auto_chan_block
        from ..resilience.memory_budget import (device_budget_bytes,
                                                max_beam_batch)

        budget = device_budget_bytes(self.device)
        if budget is None:
            return None
        (nchans, tsamp, fch1, foff, _nifs, nbits), _ = job.geom_tag
        spec = job.spec
        edge = fch1 + foff * (nchans - 1)
        fbottom = min(fch1, edge) - abs(foff) / 2
        ftop = max(fch1, edge) + abs(foff) / 2
        from ..parallel.stream import plan_chunks

        plan = plan_chunks(0, tsamp, spec["dmmin"], spec["dmmax"],
                           fbottom, ftop, foff,
                           chunk_length=spec.get("chunk_length"),
                           new_sample_time=spec.get("new_sample_time"))
        t_eff = max(plan.step // plan.resample, 2)
        ndm = len(dedispersion_plan(nchans, spec["dmmin"], spec["dmmax"],
                                    fbottom, ftop - fbottom,
                                    plan.sample_time))
        dm_block = max(1, min(ndm, 32))
        return max_beam_batch(
            nchans, t_eff, max(ndm, 1), dm_block=dm_block,
            chan_block=auto_chan_block(nchans, t_eff, dm_block),
            packed_nbits=nbits if nbits in (1, 2, 4) else 0,
            budget=budget)

    def _pop_batch(self):
        """Pop the head job plus every queued job batchable with it:
        same geometry tag, same DM range and forwarded knobs (the chunk
        plan, trial grid and threshold must be shared for their chunks
        to stack).  Admission control: the co-batch is
        capped at what the memory budget admits — excess jobs stay
        queued (still accepted, batched at the capped size on a later
        pop) instead of being co-batched into an OOM."""
        with self._lock:
            if not self._queue:
                return []
            tag = None
            batch = []
            for job_id in list(self._queue):
                job = self._jobs[job_id]
                jtag = job.geom_tag  # cached at submit: no disk under lock
                if tag is None:
                    tag = jtag
                    if job.spec.get("workload") == "periodicity":
                        # a periodicity job accumulates ONE file's full
                        # observation — it runs alone (the geometry tag
                        # already keeps single-pulse tenants out of its
                        # batch; this keeps other periodicity jobs out
                        # too)
                        batch.append(job_id)
                        break
                if jtag != tag:
                    continue
                # one job per FILE per batch: two jobs over the same
                # file share a ledger fingerprint, and batching them
                # together would double-search the same chunks
                if any(self._jobs[b].spec["fname"] == job.spec["fname"]
                       for b in batch):
                    continue
                batch.append(job_id)
            cap = self._admission_cap(self._jobs[batch[0]]) if batch \
                else None
            if cap is not None and len(batch) > max(cap, 1):
                _metrics.counter(
                    "putpu_oom_admission_capped_total").inc()
                logger.info(
                    "admission control: %d-tenant co-batch capped at "
                    "%d beam(s) by the memory budget; the rest stay "
                    "queued", len(batch), max(cap, 1))
                batch = batch[:max(cap, 1)]
            for job_id in batch:
                self._queue.remove(job_id)
                job = self._jobs[job_id]
                job.state = RUNNING
                job.started_at = time.time()
                job.batch_group = list(batch)
                # one async "job" span per tenant under its OWN
                # trace_id (co-batched tenants share the batch's driver
                # spans — recorded under the lead job's context — but
                # each job's lifetime is its own span).  Ends in
                # _finish_locked; a free no-op handle when tracing is
                # off.
                with _trace.trace_context(job.trace_id):
                    # putpu-lint: disable=span-leak — ends at the job's terminal transition (_finish_locked)
                    job.span = _trace.begin_span(
                        "job", track="service", job=job.id,
                        fname=os.path.basename(job.spec["fname"]))
            return batch

    def _run(self):
        while True:
            self._wake.wait()
            with self._lock:
                # clear UNDER the lock, before reading the queue: a
                # submit() landing after this point re-sets the event,
                # so a wake is never lost between check and clear
                self._wake.clear()
                if self._closed and not self._queue:
                    return
                idle = not self._queue
            if idle:
                continue
            if self.batch_window_s:
                # let same-geometry company arrive before dispatching
                time.sleep(self.batch_window_s)
            batch = self._pop_batch()
            if batch:
                self._run_batch(batch)
            with self._lock:
                # jobs that were not batchable with this group (other
                # geometry) are still queued: re-arm the wake so the
                # next loop iteration picks them up without a new submit
                if self._queue:
                    self._wake.set()

    def _run_periodicity(self, job):
        """One periodicity job through the full-observation driver on
        the service's device.  Broad containment as in ``_run_batch``:
        one failed job must not kill the service worker (device errors
        share no base class); the job is ``failed``, never rerun."""
        from ..periodicity.driver import periodicity_search

        spec = job.spec

        def chunk_cb(_istart):
            with self._lock:
                job.chunks_done += 1
            _metrics.counter("putpu_job_chunks_done_total",
                             job=job.id).inc()

        kwargs = {k: spec[k] for k in ("accel_max", "n_accel",
                                       "jerk_max", "n_jerk",
                                       "accel_backend",
                                       "snr_threshold", "chunk_length",
                                       "new_sample_time") if k in spec}
        if "period_sigma_threshold" in spec:
            kwargs["sigma_threshold"] = spec["period_sigma_threshold"]
        try:
            with _trace.trace_context(job.trace_id):
                res = periodicity_search(
                    spec["fname"], spec["dmmin"], spec["dmmax"],
                    output_dir=self.output_dir, resume=self.resume,
                    cancel_cb=job.cancel_event.is_set, chunk_cb=chunk_cb,
                    health=job.health, progress=False, device=self.device,
                    **kwargs)
        except Exception as exc:  # one bad job must not kill the service worker
            logger.error("periodicity job %s failed: %r", job.id, exc)
            with self._lock:
                self._finish_locked(job, FAILED, error=repr(exc))
            return
        cands = res["candidates"] or []
        with self._lock:
            job.hits = len(cands)
            job.chunks_total = (len(res["store"].done_chunks)
                                if self.resume else job.chunks_done)
            job.period = {
                "complete": res["complete"],
                "candidates_path": res["candidates_path"],
                "kept": len(cands),
                "sift": res["sift"],
                "top": [{k: c.get(k) for k in
                         ("dm", "accel", "freq", "sigma", "nharm")}
                        for c in cands[:5]],
            }
            _metrics.counter("putpu_job_hits_total",
                             job=job.id).inc(job.hits)
            if res["complete"]:
                state, error = DONE, None
            elif job.cancel_event.is_set():
                state, error = CANCELLED, None
            else:
                # incomplete WITHOUT a cancel (chunks quarantined away
                # mid-re-search, snapshot unrecoverable): a terminal
                # "done" here would tell the client its candidates
                # exist when no artifact was written — surface it
                state, error = FAILED, ("periodicity job ended "
                                        "incomplete; resubmit to resume")
            self._finish_locked(job, state, error=error)
        logger.info("periodicity job %s finished: %s (%d candidates)",
                    job.id, job.state, len(cands))

    def _run_batch(self, batch):
        from .multibeam import multibeam_search

        with self._lock:
            jobs = [self._jobs[j] for j in batch]
        spec = jobs[0].spec
        if spec.get("workload") == "periodicity":
            self._run_periodicity(jobs[0])
            return
        logger.info("job batch %s: %d tenant(s) in one batched run",
                    batch, len(jobs))

        def cancel_cb(i):
            return jobs[i].cancel_event.is_set()

        def progress_cb(i, istart, wall_s, ncand):
            job = jobs[i]
            with self._lock:
                job.chunks_done += 1
            _metrics.counter("putpu_job_chunks_done_total",
                             job=job.id).inc()
            job.health.update(istart, wall_s=wall_s, candidates=ncand)

        def store_factory(i, fname, fingerprint):
            return CandidateStore(self.output_dir, fingerprint)

        kwargs = {k: spec[k] for k in _FORWARD_KEYS if k in spec}
        try:
            # the batched run's driver spans record under the LEAD
            # job's trace context (one device program serves N
            # tenants: its spans cannot belong to all of them; the
            # per-job "job" spans carry each tenant's own id)
            with _trace.trace_context(jobs[0].trace_id):
                result = multibeam_search(
                    [j.spec["fname"] for j in jobs], spec["dmmin"],
                    spec["dmmax"], resume=self.resume,
                    output_dir=self.output_dir, cancel_cb=cancel_cb,
                    progress_cb=progress_cb, store_factory=store_factory,
                    device=self.device, **kwargs)
        except Exception as exc:  # one bad batch must not kill the service worker
            logger.error("job batch %s failed: %r", batch, exc)
            with self._lock:
                for job in jobs:
                    self._finish_locked(job, FAILED, error=repr(exc))
            return
        coinc = result["coincidence"]
        with self._lock:
            for job, beam in zip(jobs, result["beams"]):
                job.hits = len(beam["hits"])
                # with resume, the ledger (this session's chunks + any
                # prior session's) is the completion record
                job.chunks_total = (len(beam["store"].done_chunks)
                                    if self.resume
                                    else beam["chunks_done"])
                if coinc is not None:
                    job.coincidence = {
                        "stats": coinc["stats"],
                        "groups": [
                            {k: g[k] for k in ("verdict", "beams",
                                               "n_beams", "n_members",
                                               "time", "dm", "snr")}
                            for g in coinc["groups"]
                            if beam["beam"] in g["beams"]]}
                _metrics.counter("putpu_job_hits_total",
                                 job=job.id).inc(job.hits)
                self._finish_locked(
                    job, CANCELLED if beam["cancelled"] else DONE)
        logger.info("job batch %s finished: %s", batch,
                    {j.id: j.state for j in jobs})
