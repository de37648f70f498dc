"""The fleet coordinator: lease-based work-stealing over the ledger.

The port of the JAX package's coordinator.  It is a host process: it
plans, journals and serves the protocol, and makes no CUDA call (its
footprint estimates are keyed on the host, ``device="cpu"``).
:class:`FleetCoordinator` shards a survey, many files x chunk ranges,
into leased work units and hands them to workers over the JSON wire
protocol (:mod:`.protocol`):

* **sharding** uses :func:`~..pipeline.search_pipeline.plan_survey`, the
  function ``search_by_chunks`` plans from, with the driver's own
  defaults, so the coordinator's chunk grid and ledger fingerprint are
  the worker's by construction;
* **the ledger is the completion record**: every grant, completion and
  requeue re-reads the file's resume ledger
  (:class:`~..io.candidates.CandidateStore` format) from the shared
  filesystem; lease expiry, worker death and duplicate completions all
  resolve through its idempotent chunk-keyed entries;
* **work-stealing is health-probed**: the sweep polls each worker's
  ``/healthz``; DEGRADED workers get no leases (they finish what they
  hold), CRITICAL and dead workers (``dead_after`` failed probes) have
  their leases revoked and requeued, expired leases requeue what the
  ledger still shows missing;
* **the write-ahead journal** (:mod:`.journal`) lets :meth:`recover`
  rebuild the control plane after a SIGKILL, and every unit's **epoch**
  (bumped on each requeue, steal, reshard and recovery) fences a
  partitioned worker's late reports and writes.

The HTTP surface is :mod:`..obs.server`'s
(``start_obs_server(..., fleet=coordinator)``): ``GET /fleet/workers``,
``/fleet/leases``, ``/fleet/progress``, ``/fleet/capacity`` (saturation
and scaling advice), ``/fleet/history`` and the fleet-aggregated
``/fleet/metrics``, and the four POST messages of the protocol.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..obs.capacity import CapacityModel, SaturationDetector
from ..utils.logging_utils import logger
from . import protocol

__all__ = ["FleetCoordinator"]

#: series the fleet report plots per worker over time:
#: throughput, device headroom and science recall — trends, not finals
_HISTORY_SERIES = ("putpu_chunks_per_s", "putpu_device_headroom_bytes",
                   "putpu_canary_recall")

#: a unit's terminal states
_TERMINAL = ("done", "failed")


class _Unit:
    """One leasable work unit: a chunk range of one file.  ``chunks``
    only ever shrinks (grant-time ledger check drops finished ones).
    ``trace_id`` is the unit's distributed-trace identity:
    every lease of this unit — across steals and requeues — carries the
    same id, so the merged trace shows ONE causal timeline per unit.
    ``epoch`` is the unit's monotonic **fencing token**: it
    bumps on every requeue/steal/reshard (and on coordinator recovery
    of an in-flight unit), rides every grant, and makes a partitioned
    zombie's late completes/releases/artifact-writes detectably stale —
    the classic lease-fencing rule."""

    __slots__ = ("id", "fname", "chunks", "attempts", "state",
                 "trace_id", "epoch")

    def __init__(self, unit_id, fname, chunks):
        self.id = unit_id
        self.fname = fname
        self.chunks = tuple(int(c) for c in chunks)
        self.attempts = 0
        self.state = "pending"      # pending | leased | done | failed
        self.trace_id = _trace.new_trace_id()
        self.epoch = 1

    def doc(self):
        return {"unit": self.id, "fname": self.fname,
                "chunks": list(self.chunks), "state": self.state,
                "attempts": self.attempts, "epoch": self.epoch,
                "trace_id": self.trace_id}


class _Lease:
    __slots__ = ("id", "unit_id", "worker_id", "expires_at", "granted_at",
                 "span")

    def __init__(self, lease_id, unit_id, worker_id, expires_at):
        self.id = lease_id
        self.unit_id = unit_id
        self.worker_id = worker_id
        self.expires_at = expires_at      # monotonic deadline
        self.granted_at = time.time()
        #: the coordinator-side AsyncSpan bracketing grant -> resolution
        #: (a no-op handle when coordinator tracing is off)
        self.span = None


class _WorkerRec:
    __slots__ = ("id", "healthz_url", "verdict", "probe_failures",
                 "alive", "draining", "last_seen", "units_completed",
                 "metrics", "registered_at", "mem_budget", "history")

    def __init__(self, worker_id, healthz_url, mem_budget=None):
        self.id = worker_id
        self.healthz_url = healthz_url
        self.verdict = "OK"
        self.probe_failures = 0
        self.alive = True
        self.draining = False
        self.last_seen = time.time()
        self.units_completed = 0
        self.metrics = None       # last reported registry snapshot
        self.registered_at = time.time()
        #: worker-reported device memory budget in bytes:
        #: None = unreported, leases are sized by chunks_per_unit alone
        self.mem_budget = mem_budget
        #: last scraped /metrics/history document; None =
        #: never scraped / worker serves no sampler
        self.history = None

    def doc(self, held):
        return {"worker": self.id, "healthz_url": self.healthz_url,
                "verdict": self.verdict, "alive": self.alive,
                "draining": self.draining,
                "probe_failures": self.probe_failures,
                "last_seen": round(self.last_seen, 3),
                "units_completed": self.units_completed,
                "mem_budget_bytes": self.mem_budget,
                "leases_held": held}


class FleetCoordinator:
    """Shard surveys into leased units; steal work from sick workers.

    ``output_dir`` must be a filesystem every worker shares — it holds
    the per-file ledgers (the completion record) and candidates.
    ``lease_ttl_s`` bounds how long a silent worker keeps a unit;
    ``chunks_per_unit`` sizes units (1 = finest stealing granularity,
    larger amortises per-unit driver startup); ``dead_after`` is the
    consecutive-probe-failure count that declares a worker dead;
    ``file_affinity=True`` (default) grants units of one file to one
    worker at a time, so concurrent ledger writers only exist in the
    work-stealing edge (see ``CandidateStore.mark_done``'s merge rule);
    ``max_attempts`` bounds requeues per unit before it is marked
    failed (a chunk that kills every worker must not starve the fleet).

    ``auto_sweep=True`` runs lease expiry + health probes on a daemon
    thread every ``probe_interval_s``; tests pass ``False`` and drive
    :meth:`sweep` deterministically.

    ``capacity=True`` (default-off and byte-inert) arms the
    capacity observability layer: the sweep classifies fleet
    saturation (:class:`~pulsarutils_tpu.obs.capacity.
    SaturationDetector`), samples queue-depth/utilization gauges, and
    turns the always-on EWMA throughput model into a
    :class:`~pulsarutils_tpu.obs.capacity.ScalingAdvice` served at
    ``GET /fleet/capacity`` and rolled into :meth:`summary`.
    ``health`` accepts the coordinator-side
    :class:`~pulsarutils_tpu.obs.health.HealthEngine` the
    ``fleet_saturated`` condition is raised on (the same engine the
    SLO engine feeds).
    """

    def __init__(self, output_dir, *, lease_ttl_s=30.0, chunks_per_unit=1,
                 probe_interval_s=1.0, probe_timeout_s=2.0, dead_after=3,
                 poll_s=0.25, resume=True, file_affinity=True,
                 max_attempts=5, auto_sweep=True, collector=None,
                 scrape_history=True, journal=True, capacity=False,
                 health=None):
        from .journal import FleetJournal

        self.output_dir = str(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        #: the write-ahead journal: every survey addition,
        #: unit plan, grant, requeue/epoch bump, failure and duplicate
        #: lands in ``fleet_journal.jsonl`` beside the ledgers BEFORE
        #: the reply leaves, so :meth:`recover` can rebuild this
        #: object's control-plane state after a SIGKILL.  ``journal=
        #: False`` disables it (byte-inert: the file is never created).
        self.journal = (FleetJournal.in_dir(self.output_dir)
                        if journal else FleetJournal(None))
        #: a :class:`~pulsarutils_tpu.obs.collector.TraceCollector` (or
        #: None): wired, every completion's drained worker spans are
        #: stitched into the fleet trace
        self.collector = collector
        #: scrape each probed worker's /metrics/history on the sweep so
        #: the fleet report shows per-worker trends (workers without a
        #: sampler 404 harmlessly)
        self.scrape_history = bool(scrape_history)
        self.lease_ttl_s = float(lease_ttl_s)
        self.chunks_per_unit = max(int(chunks_per_unit), 1)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.dead_after = int(dead_after)
        self.poll_s = float(poll_s)
        self.resume = bool(resume)
        self.file_affinity = bool(file_affinity)
        self.max_attempts = int(max_attempts)
        self._lock = threading.Lock()
        self._units = {}          # unit_id -> _Unit
        self._pending = []        # unit ids, FIFO (requeues jump the line)
        self._leases = {}         # lease_id -> _Lease
        self._workers = {}        # worker_id -> _WorkerRec
        self._files = {}          # fname -> {"fingerprint", "config", ...}
        self._seq = {"unit": 0, "lease": 0, "worker": 0}
        self._trace_seqs = {}     # worker id -> last ingested trace seq
        self._stats = {"granted": 0, "expired": 0, "revoked": 0,
                       "denied": 0, "requeued": 0, "completed": 0,
                       "failed": 0, "duplicates": 0, "stale_epochs": 0}
        #: capacity observability.  The EWMA throughput
        #: model is ALWAYS maintained (it feeds /fleet/progress ETAs
        #: and costs one fold per completion); the detector, gauges,
        #: scaling advice and ``fleet_saturated`` condition only run
        #: when ``capacity=True`` — and none of it touches science
        #: bytes either way.
        self.capacity_enabled = bool(capacity)
        self.health = health
        self.capacity_model = CapacityModel()
        self.saturation = SaturationDetector() if capacity else None
        self._advice = None
        self._saturated_raised = False
        self._closed = False
        self._sweeper = None
        if auto_sweep:
            self._sweeper = threading.Thread(
                target=self._sweep_loop, name="fleet-sweep", daemon=True)
            self._sweeper.start()

    # -- survey intake -------------------------------------------------------

    def add_survey(self, fnames, **config):
        """Shard ``fnames`` into work units under one search config.

        ``config`` is the :data:`~.protocol.SEARCH_KEYS` subset of
        ``search_by_chunks`` keywords; it is planned *here* (via
        ``plan_survey``) and shipped verbatim in every lease, so worker
        sessions land on exactly the planned ledger fingerprint.  With
        ``resume=True`` (the default) chunks the ledgers already mark
        done are never sharded at all.  Returns the new unit ids.
        """
        import inspect

        from ..pipeline.search_pipeline import plan_survey, search_by_chunks

        config = protocol.clean_search_config(config)
        # the periodicity workload: plan under the SAME
        # fingerprint_extra the worker's periodicity_search will use,
        # and shard each file as ONE unit — accumulation needs the
        # whole observation on one worker, and a chunk-subset lease
        # would hand different workers halves of one plane
        workload = config.get("workload", "single_pulse")
        from ..beams.service import WORKLOADS

        if workload not in WORKLOADS:
            # the service validates this in validate_spec; the fleet's
            # own front door must too, or a typoed workload silently
            # runs a single-pulse survey with no periodicity artifact
            # and no error anywhere
            raise ValueError(f"workload={workload!r}: expected one of "
                             f"{WORKLOADS}")
        period_extra = None
        if workload == "periodicity":
            period_extra = {"workload": "periodicity",
                            "accel_max": float(config.get("accel_max",
                                                          0.0))}
            if config.get("jerk_max"):
                # conditional, mirroring the driver: a jerk-less lease
                # must plan the exact pre-jerk fingerprint
                period_extra["jerk_max"] = float(config["jerk_max"])
            backend_choice = config.get("accel_backend", "auto")
            if backend_choice not in ("auto", "time_stretch", "fdas"):
                raise ValueError(
                    f"accel_backend={backend_choice!r}: expected "
                    "'auto', 'time_stretch' or 'fdas'")
        else:
            # periodicity-only keys on a single-pulse config would ride
            # the lease into search_by_chunks (which has no such
            # parameters) and fail every unit — reject at intake, the
            # validate_spec rule applied to the fleet's own front door
            bad = sorted(set(config) & {"accel_max", "n_accel",
                                        "jerk_max", "n_jerk",
                                        "accel_backend"})
            if bad:
                raise ValueError(
                    f"search config keys {bad} require "
                    "workload='periodicity'")
        # plan with the WORKER's effective defaults: keys the lease
        # omits resolve from search_by_chunks' own signature, never
        # from plan_survey's — so a future default edit in the driver
        # cannot silently fork coordinator and worker onto different
        # fingerprints (they'd disagree on every completion)
        plan_params = set(inspect.signature(plan_survey).parameters) \
            - {"fname", "fingerprint_extra"}  # coordinator-owned
        driver_defaults = {
            k: p.default for k, p in
            inspect.signature(search_by_chunks).parameters.items()
            if k in plan_params and p.default is not inspect.Parameter.empty}
        plan_config = dict(
            driver_defaults,
            **{k: v for k, v in config.items() if k in plan_params})
        if workload == "periodicity":
            # the periodicity driver's transport always plans with the
            # driver defaults for the per-chunk rescue-seam knobs (the
            # full-observation stage replaces that seam, and
            # periodicity_search rejects the knobs outright) — the
            # coordinator must fingerprint identically or every unit
            # completion would read the wrong ledger
            plan_config["period_search"] = driver_defaults.get(
                "period_search", False)
            plan_config["period_sigma_threshold"] = driver_defaults.get(
                "period_sigma_threshold", 8.0)
        from ..resilience.memory_budget import estimate_chunk_bytes

        planned = []
        for fname in fnames:
            fname = os.path.abspath(str(fname))
            sp = plan_survey(fname, fingerprint_extra=period_extra,
                             **plan_config)
            done = self._read_ledger_done(sp["fingerprint"]) \
                if self.resume else set()
            starts = [s for s in sp["chunk_starts"] if s not in done]
            artifact = None
            if workload == "periodicity":
                artifact = os.path.join(
                    self.output_dir,
                    f"period_cands_{sp['root']}_{sp['fingerprint']}.npz")
                if not starts and not os.path.exists(artifact):
                    # fully-accumulated ledger but no candidates: the
                    # trial-search stage still owes its artifact —
                    # shard the (ledger-complete) unit anyway so a
                    # worker re-runs the sweep from the snapshot
                    starts = list(sp["chunk_starts"])
            # per-chunk footprint estimate: the number the
            # coordinator sizes leases against for budget-reporting
            # workers.  The trial count is the plan's one-trial-per-
            # delay-sample rule (~half the post-resample chunk).
            t_eff = max(sp["plan"].step // sp["plan"].resample, 2)
            # keyed on the host: the coordinator makes no CUDA call (on
            # a machine with a card, device=None would pick the card)
            chunk_est = estimate_chunk_bytes(
                sp["reader"].header["nchans"], t_eff,
                max(t_eff // 2, 1), device="cpu")
            planned.append((fname, sp, starts, chunk_est, artifact))
        ids = []
        with self._lock:
            for fname, sp, starts, chunk_est, artifact in planned:
                if fname in self._files \
                        and self._files[fname]["fingerprint"] \
                        != sp["fingerprint"]:
                    raise ValueError(
                        f"{fname} is already sharded under a different "
                        "search config — one fleet run, one fingerprint "
                        "per file")
                already = fname in self._files
                self._files[fname] = {
                    "fingerprint": sp["fingerprint"], "config": config,
                    "root": sp["root"], "workload": workload,
                    "artifact": artifact,
                    "chunks_total": len(sp["chunk_starts"]),
                    "chunk_starts": list(sp["chunk_starts"]),
                    "chunk_est_bytes": int(chunk_est)}
                if not already:
                    # WAL first: the file definition must be
                    # durable before any unit of it can be granted
                    self.journal.append("file", fname=fname,
                                        **self._files[fname])
                per_unit = (max(len(starts), 1)
                            if workload == "periodicity"
                            else self.chunks_per_unit)
                for i in range(0, len(starts), per_unit):
                    self._seq["unit"] += 1
                    unit = _Unit(f"u{self._seq['unit']}", fname,
                                 starts[i:i + per_unit])
                    self._units[unit.id] = unit
                    self._pending.append(unit.id)
                    ids.append(unit.id)
                    self.journal.append("unit", unit=unit.id,
                                        fname=fname,
                                        chunks=list(unit.chunks),
                                        trace_id=unit.trace_id)
                logger.info(
                    "fleet: sharded %s into %d unit(s) (%d of %d chunks "
                    "pending, fingerprint %s)", os.path.basename(fname),
                    -(-len(starts) // per_unit), len(starts),
                    len(sp["chunk_starts"]), sp["fingerprint"])
            self._update_gauges_locked()
        return ids

    def add_job(self, spec):
        """The job-handoff seam from the multi-tenant service: shard one
        ``POST /jobs``-shaped spec (validated by
        :func:`~pulsarutils_tpu.beams.service.validate_spec` — the same
        rules the in-process :class:`~pulsarutils_tpu.beams.service.
        SurveyService` applies) into fleet units.  Multibeam-only knobs
        (``canary_rate``, ``veto_frac``, ``max_real_beams``,
        ``max_chunks``) are rejected explicitly: the fleet shards plain
        per-file surveys, and silently dropping a requested knob would
        misrepresent what ran.
        """
        from ..beams.service import validate_spec

        spec = validate_spec(spec)
        unsupported = sorted(
            set(spec) & {"canary_rate", "veto_frac", "max_real_beams",
                         "max_chunks"})
        if unsupported:
            raise ValueError(
                f"job spec keys {unsupported} are multibeam-service "
                "knobs the fleet does not run — submit to the service, "
                "or drop them")
        config = {k: v for k, v in spec.items() if k != "fname"}
        return self.add_survey([spec["fname"]], **config)

    # -- crash recovery -------------------------------------------

    @classmethod
    def recover(cls, output_dir, **kwargs):
        """Restart a crashed coordinator from its write-ahead journal.

        Rebuilds the control-plane state a SIGKILL destroyed — file
        definitions, unit plans, attempt counts, fencing epochs,
        failures, duplicate/stale counters — by replaying
        ``fleet_journal.jsonl``, then re-derives every unit's
        *outstanding* chunks from the per-file ledgers (the ledger
        stays the only completion record; the journal is never trusted
        for done-ness).  Units that were leased at the crash are
        requeued with a **bumped epoch**, so a zombie worker still
        computing on a pre-crash grant is fenced exactly as if its
        lease had been stolen.  Workers re-register through the
        existing ``unknown_worker`` path and the survey finishes
        byte-identical to an uninterrupted run.

        A missing journal recovers nothing (re-add surveys: the ledger
        makes that exact); a torn tail is truncated to a ``.corrupt``
        backup; a version-mismatched journal is valid-but-rejected
        (moved to ``.stale``).
        """
        coordinator = cls(output_dir, **kwargs)
        coordinator._recover_from_journal()
        return coordinator

    def _recover_from_journal(self):
        records = self.journal.replay()
        done_cache = {}
        requeued = 0
        with self._lock:
            for rec in records:
                kind = rec.get("kind")
                if kind == "file":
                    fname = rec.get("fname")
                    if not fname:
                        continue
                    self._files[fname] = {
                        k: rec.get(k) for k in (
                            "fingerprint", "config", "root", "workload",
                            "artifact", "chunks_total", "chunk_starts",
                            "chunk_est_bytes")}
                elif kind == "unit":
                    uid = rec.get("unit")
                    if not uid or rec.get("fname") not in self._files:
                        continue
                    unit = _Unit(uid, rec["fname"],
                                 rec.get("chunks") or ())
                    unit.attempts = int(rec.get("attempts", 0))
                    unit.epoch = int(rec.get("epoch", 1))
                    if rec.get("trace_id"):
                        unit.trace_id = str(rec["trace_id"])
                    self._units[uid] = unit
                    self._pending.append(uid)
                    self._bump_seq_locked("unit", uid, "u")
                elif kind == "grant":
                    unit = self._units.get(rec.get("unit"))
                    if unit is not None:
                        unit.state = "leased"
                        unit.epoch = max(unit.epoch,
                                         int(rec.get("epoch", 1)))
                        if unit.id in self._pending:
                            self._pending.remove(unit.id)
                    self._bump_seq_locked("lease", rec.get("lease"), "L")
                elif kind == "requeue":
                    unit = self._units.get(rec.get("unit"))
                    if unit is None:
                        continue
                    unit.attempts = int(rec.get("attempts",
                                                unit.attempts))
                    unit.epoch = max(unit.epoch,
                                     int(rec.get("epoch", unit.epoch)))
                    unit.state = "pending"
                    if unit.id not in self._pending:
                        self._pending.insert(0, unit.id)
                elif kind == "failed":
                    unit = self._units.get(rec.get("unit"))
                    if unit is None:
                        continue
                    unit.state = "failed"
                    unit.attempts = int(rec.get("attempts",
                                                unit.attempts))
                    if unit.id in self._pending:
                        self._pending.remove(unit.id)
                    self._stats["failed"] += 1
                elif kind == "duplicate":
                    self._stats["duplicates"] += 1
                elif kind == "stale":
                    self._stats["stale_epochs"] += 1
            # resolve every replayed unit against the LEDGERS: journal
            # state is control-plane intent, the per-file ledger is the
            # completion record — chunks another session finished are
            # dropped here, exactly as at grant time
            for unit in list(self._units.values()):
                if unit.state == "failed":
                    continue
                remaining = self._ledger_remaining(unit, done_cache)
                if not remaining:
                    if unit.id in self._pending:
                        self._pending.remove(unit.id)
                    self._finish_unit_locked(unit)
                    continue
                unit.chunks = remaining
                if unit.state == "leased":
                    # in flight when the coordinator died: the lease
                    # died with it — steal it now.  The epoch bump is
                    # what fences a zombie still computing on the
                    # pre-crash grant; no attempt burns (the crash was
                    # the coordinator's fault, not the chunk's).
                    unit.epoch += 1
                    unit.state = "pending"
                    if unit.id not in self._pending:
                        self._pending.insert(0, unit.id)
                    self._stats["requeued"] += 1
                    _metrics.counter(
                        "putpu_fleet_units_requeued_total").inc()
                    self.journal.append(
                        "requeue", unit=unit.id, attempts=unit.attempts,
                        epoch=unit.epoch, why="coordinator recovery")
                    requeued += 1
            self._update_gauges_locked()
            if records:
                self.journal.append("recovered", files=len(self._files),
                                    units=len(self._units),
                                    pending=len(self._pending),
                                    requeued=requeued)
                _metrics.counter("putpu_fleet_recoveries_total").inc()
        logger.info(
            "fleet: recovered from journal — %d record(s) replayed, %d "
            "file(s), %d unit(s) (%d pending, %d re-stolen from dead "
            "leases)", len(records), len(self._files), len(self._units),
            len(self._pending), requeued)
        return len(records)

    def _bump_seq_locked(self, key, ident, prefix):
        """Keep ``_seq[key]`` above every journaled id so recovered
        coordinators never re-mint a pre-crash unit/lease id."""
        if not isinstance(ident, str) or not ident.startswith(prefix):
            return
        digits = ident[len(prefix):]
        if digits.isdigit():
            self._seq[key] = max(self._seq[key], int(digits))

    # -- the ledger: the only completion record ------------------------------

    def _read_ledger_done(self, fingerprint):
        """The ``done`` chunk set of one ledger, straight off disk.

        A plain read, not a :class:`CandidateStore` (constructing one
        backs torn files up as ``.corrupt`` — a *recovery* side effect
        the coordinator's read-only resolution must not trigger; the
        audit reads non-destructively for the same reason).  Unreadable
        or torn state resolves to "nothing done": the worst case is an
        idempotent re-search, never a lost chunk.
        """
        path = os.path.join(self.output_dir,
                            f"progress_{fingerprint}.json")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return set()
        done = doc.get("done") if isinstance(doc, dict) else None
        if not isinstance(done, list):
            return set()
        return {int(c) for c in done if isinstance(c, int)}

    def _ledger_remaining(self, unit, done_cache):
        rec = self._files[unit.fname]
        fingerprint = rec["fingerprint"]
        if fingerprint not in done_cache:
            done_cache[fingerprint] = self._read_ledger_done(fingerprint)
        done = done_cache[fingerprint]
        remaining = tuple(c for c in unit.chunks if c not in done)
        if not remaining and rec.get("artifact") \
                and not os.path.exists(rec["artifact"]):
            # periodicity: the chunk ledger records only the
            # accumulation transport — the persisted candidates npz is
            # the completion record of the trial-search/sift/fold
            # stages.  A worker that accumulated everything and died
            # before the sweep must NOT resolve the unit as done, or
            # the job finishes with no candidates; re-leasing it costs
            # nothing (the driver skips ledger-done chunks and runs
            # the sweep from the snapshot).
            return tuple(unit.chunks)
        return remaining

    # -- protocol handlers (the obs server routes /fleet/ POSTs here) --------

    def register(self, doc):
        """``register`` message: admit a worker, hand it the fleet
        parameters.  ``healthz_url`` is optional — a worker without one
        is never probed and lives/dies by lease TTL alone."""
        healthz = doc.get("healthz_url") if isinstance(doc, dict) else None
        if healthz is not None and not isinstance(healthz, str):
            raise ValueError("healthz_url must be a string or null")
        requested = doc.get("worker") if isinstance(doc, dict) else None
        mem_budget = doc.get("mem_budget_bytes") \
            if isinstance(doc, dict) else None
        if mem_budget is not None:
            if not isinstance(mem_budget, (int, float)) or mem_budget <= 0:
                raise ValueError("mem_budget_bytes must be a positive "
                                 "number or absent")
            mem_budget = int(mem_budget)
        with self._lock:
            if self._closed:
                raise ValueError("coordinator is shut down")
            if requested is not None:
                worker_id = str(requested)
                if worker_id in self._workers:
                    raise ValueError(
                        f"worker id {worker_id!r} is already registered")
            else:
                self._seq["worker"] += 1
                worker_id = f"w{self._seq['worker']}"
            self._workers[worker_id] = _WorkerRec(worker_id, healthz,
                                                  mem_budget=mem_budget)
            self._update_gauges_locked()
        logger.info("fleet: worker %s registered (healthz: %s, "
                    "mem budget: %s)", worker_id,
                    healthz or "none — TTL liveness only",
                    f"{mem_budget} B" if mem_budget else "unreported")
        return {"worker": worker_id, "lease_ttl_s": self.lease_ttl_s,
                "poll_s": self.poll_s,
                "protocol_version": protocol.PROTOCOL_VERSION,
                # the clock-sync anchor: the worker computes
                # its offset by the midpoint rule; old workers ignore it
                "server_time": time.time()}

    def lease(self, doc):
        """``lease`` message: grant up to ``max_units`` pending units.

        Health gate: a DEGRADED/CRITICAL worker is denied (it keeps
        draining what it holds; CRITICAL additionally gets its leases
        revoked by the sweep).  Every granted unit is ledger-checked
        first — chunks another session finished are dropped before they
        are leased, so a requeued duplicate can never double-search.
        """
        worker_id = str(protocol.require(doc, "worker", str, "lease"))
        max_units = int(doc.get("max_units", 1))
        done_cache = {}
        with self._lock:
            worker = self._workers.get(worker_id)
            if worker is None:
                # structured code: the worker's
                # re-registration trigger branches on this, not on the
                # message text
                raise protocol.ProtocolError(
                    f"unknown worker {worker_id!r} — register first",
                    code="unknown_worker")
            worker.last_seen = time.time()
            # a lease request IS liveness: a worker the prober declared
            # dead but which is demonstrably talking gets revived (its
            # old leases were already requeued; it simply starts fresh)
            worker.alive = True
            worker.probe_failures = 0
            # ...and carries a health self-report, so a denied worker
            # whose transient conditions decayed can recover without
            # waiting for a probe (unprobed workers have no other path
            # back); the independent /healthz probe still overrides on
            # its own cadence — a wedged worker cannot self-report
            self._note_report_locked(worker, doc)
            if worker.draining or self._closed:
                return {"leases": [], "denied": "draining",
                        "survey_done": self._survey_done_locked(),
                        "poll_s": self.poll_s,
                        "server_time": time.time()}
            if worker.verdict in ("DEGRADED", "CRITICAL"):
                self._stats["denied"] += 1
                _metrics.counter("putpu_fleet_leases_denied_total").inc()
                logger.info("fleet: lease denied to %s (verdict %s)",
                            worker_id, worker.verdict)
                return {"leases": [], "denied": worker.verdict,
                        "survey_done": self._survey_done_locked(),
                        "poll_s": self.poll_s,
                        "server_time": time.time()}
            granted = self._grant_locked(worker, max_units, done_cache)
            self._update_gauges_locked()
            return {"leases": granted, "denied": None,
                    "survey_done": self._survey_done_locked(),
                    "poll_s": self.poll_s,
                    "server_time": time.time()}

    def _note_report_locked(self, worker, doc):
        """Fold a message's optional self-reported ``metrics`` snapshot
        and ``health`` verdict into the worker record."""
        if isinstance(doc.get("metrics"), list):
            worker.metrics = doc["metrics"]
        health = doc.get("health")
        if isinstance(health, dict) and "status" in health:
            worker.verdict = str(health["status"])

    def _lease_limit_locked(self, worker, unit):
        """Chunks-per-lease cap for a budget-reporting worker: sized so
        one lease's estimated footprint sum fits the
        worker's reported device budget — a memory-constrained worker
        searches slower (its ladder splits every dispatch), so it must
        hold less work behind one lease TTL or expiry-stealing churns.
        ``None`` = no budget reported / no estimate, size by
        ``chunks_per_unit`` alone (as with no budget reported)."""
        if worker.mem_budget is None:
            return None
        if self._files[unit.fname].get("workload") == "periodicity":
            # a periodicity unit is the whole observation by design:
            # the worker searches its chunks sequentially (one chunk
            # resident at a time), so the per-chunk floor — not the
            # unit size — is what must fit, and splitting the unit
            # would split the accumulation plane across workers
            return None
        per = self._files[unit.fname].get("chunk_est_bytes")
        if not per:
            return None
        return max(int(worker.mem_budget // per), 1)

    def _reshard_unit_locked(self, unit, keep_n, why):
        """Split ``unit`` at ``keep_n`` chunks: the tail becomes a NEW
        pending unit (front of the queue — re-sharded work is the
        oldest work).  The caller still owns the head."""
        tail = unit.chunks[keep_n:]
        unit.chunks = unit.chunks[:keep_n]
        self._seq["unit"] += 1
        new = _Unit(f"u{self._seq['unit']}", unit.fname, tail)
        # the tail INHERITS the attempt count: a re-shard must not mint
        # a fresh max_attempts budget, or a unit no worker can fit
        # would ping-pong through O(chunks x attempts) descendants
        # instead of failing bounded
        new.attempts = unit.attempts
        # the tail also inherits the epoch: its chunks were (or may
        # have been) granted under the parent's token, so a zombie
        # holding the parent lease must stay fenceable against the
        # tail's next grant too
        new.epoch = unit.epoch
        self._units[new.id] = new
        self._pending.insert(0, new.id)
        self.journal.append("unit", unit=new.id, fname=new.fname,
                            chunks=list(new.chunks),
                            attempts=new.attempts, epoch=new.epoch,
                            trace_id=new.trace_id)
        _metrics.counter("putpu_fleet_units_resharded_total").inc()
        logger.info("fleet: unit %s re-sharded -> %s (%d chunks) + %s "
                    "(%d chunks): %s", unit.id, unit.id,
                    len(unit.chunks), new.id, len(tail), why)
        return new

    def _grant_locked(self, worker, max_units, done_cache):
        granted = []
        busy = {}
        if self.file_affinity:
            for lease in self._leases.values():
                busy[self._units[lease.unit_id].fname] = lease.worker_id
        for unit_id in list(self._pending):
            if len(granted) >= max_units:
                break
            unit = self._units[unit_id]
            if busy.get(unit.fname, worker.id) != worker.id:
                continue   # another worker holds this file's ledger pen
            remaining = self._ledger_remaining(unit, done_cache)
            if not remaining:
                # finished out-of-band (a duplicate's late write, a
                # resumed local run): the ledger says done, so it is
                self._pending.remove(unit_id)
                self._finish_unit_locked(unit)
                continue
            unit.chunks = remaining
            limit = self._lease_limit_locked(worker, unit)
            if limit is not None and len(unit.chunks) > limit:
                # size the lease to the worker's reported memory
                # budget: grant the head, the tail re-queues as its
                # own unit for any worker
                self._reshard_unit_locked(
                    unit, limit,
                    f"sized to {worker.id}'s memory budget")
            unit.state = "leased"
            self._pending.remove(unit_id)
            self._seq["lease"] += 1
            lease = _Lease(f"L{self._seq['lease']}", unit_id, worker.id,
                           time.monotonic() + self.lease_ttl_s)
            # the coordinator side of the unit's causal timeline: an
            # async span bracketing grant -> resolution, recorded under
            # the unit's trace_id (a free no-op handle when coordinator
            # tracing is off).  Ends in _end_lease_span_locked — a
            # reviewed cross-method seam.
            with _trace.trace_context(unit.trace_id):
                # putpu-lint: disable=span-leak — ends at lease resolution, tracked on the _Lease
                lease.span = _trace.begin_span(
                    "lease", track=f"worker {worker.id}",
                    lease=lease.id, unit=unit.id, worker=worker.id,
                    fname=os.path.basename(unit.fname),
                    chunks=len(unit.chunks))
            self._leases[lease.id] = lease
            busy.setdefault(unit.fname, worker.id)
            self._stats["granted"] += 1
            _metrics.counter("putpu_fleet_leases_granted_total").inc()
            # journal the grant: a restarted coordinator
            # must know this unit was in flight (requeue + epoch bump)
            # and must never re-mint this lease id
            self.journal.append("grant", lease=lease.id, unit=unit.id,
                                worker=worker.id, epoch=unit.epoch)
            rec = self._files[unit.fname]
            granted.append({
                "lease": lease.id, "unit": unit.id, "fname": unit.fname,
                "chunks": list(unit.chunks), "config": rec["config"],
                "output_dir": self.output_dir,
                "expires_in_s": self.lease_ttl_s,
                # the fencing token: the worker passes it as
                # the CandidateStore fence and echoes it in complete/
                # release, so stale post-steal writes are rejectable
                "epoch": unit.epoch,
                # distributed-trace stamp: the worker binds
                # this so its chunk/dispatch/persist spans share the
                # unit's trace_id; old workers simply ignore the key
                "trace": {"trace_id": unit.trace_id,
                          **({"parent_span_id": str(lease.span._id)}
                             if isinstance(lease.span, _trace.AsyncSpan)
                             else {})}})
        return granted

    def _end_lease_span_locked(self, lease, outcome):
        """Close a lease's coordinator-side span with its outcome (safe
        on the no-op handle; idempotent like AsyncSpan.end)."""
        if lease.span is not None:
            lease.span.end(outcome=outcome)

    def complete(self, doc):
        """``complete`` message: resolve a finished (or failed) unit.

        The report is advisory; the ledger decides.  Chunks the ledger
        still shows missing are requeued (``requeued`` in the reply
        names them); a completion for an already-resolved lease — the
        expired-and-stolen straggler — is counted as a duplicate and
        resolved the same way.  The worker's registry snapshot and
        health verdict ride along for ``/fleet/metrics`` and
        ``/fleet/workers``.
        """
        worker_id = str(protocol.require(doc, "worker", str, "complete"))
        lease_id = str(protocol.require(doc, "lease", str, "complete"))
        unit_id = str(protocol.require(doc, "unit", str, "complete"))
        error = doc.get("error")
        # stitch the worker's drained spans into the fleet trace; an
        # absent "trace" key is the old-worker back-compat path.  The
        # payload's ``seq`` makes this idempotent: a wire-level resend
        # of the same complete message (lost response -> retry) must
        # not render every span twice in the merged trace — the ledger
        # path is idempotent against exactly that retry, so the trace
        # path must be too.  The ingest itself runs OUTSIDE the
        # coordinator lock (the collector has its own).
        trace_doc = doc.get("trace") if self.collector is not None \
            else None
        if isinstance(trace_doc, dict):
            fresh = True
            with self._lock:
                if worker_id not in self._workers:
                    fresh = False
                seq = trace_doc.get("seq")
                if fresh and isinstance(seq, (int, float)):
                    last = self._trace_seqs.get(worker_id)
                    fresh = last is None or seq > last
                    if fresh:
                        self._trace_seqs[worker_id] = seq
            if fresh:
                self.collector.ingest(f"worker {worker_id}", trace_doc)
        done_cache = {}
        with self._lock:
            worker = self._workers.get(worker_id)
            if worker is not None:
                worker.last_seen = time.time()
                self._note_report_locked(worker, doc)
            unit = self._units.get(unit_id)
            if unit is None:
                raise ValueError(f"unknown unit {unit_id!r}")
            epoch = doc.get("epoch")
            if isinstance(epoch, (int, float)) and int(epoch) < unit.epoch:
                # stale fencing token: this report belongs
                # to a grant that was since stolen/requeued (possibly
                # across a coordinator restart — the journal preserves
                # epochs).  Rejected IDEMPOTENTLY: counted, journaled,
                # never fatal, and crucially it must NOT resolve or
                # requeue anything — the current epoch's holder owns
                # the unit, and the ledger remains the only completion
                # record either way.
                self._stats["stale_epochs"] += 1
                _metrics.counter(
                    "putpu_fleet_stale_epoch_rejected_total").inc()
                self.journal.append("stale", unit=unit_id,
                                    worker=worker_id,
                                    epoch=int(epoch),
                                    current=unit.epoch)
                logger.info(
                    "fleet: stale-epoch completion of %s by %s rejected "
                    "(epoch %d < current %d)", unit_id, worker_id,
                    int(epoch), unit.epoch)
                # the LEDGER may still resolve the unit (it is truth no
                # matter who prompted the read): a zombie that finished
                # the survey's last unit must not leave it pending
                # forever just because its report was stale
                if unit.state not in _TERMINAL \
                        and unit.id not in {le.unit_id for le in
                                            self._leases.values()} \
                        and not self._ledger_remaining(unit, done_cache):
                    if unit.id in self._pending:
                        self._pending.remove(unit.id)
                    self._finish_unit_locked(unit)
                    self._update_gauges_locked()
                return {"ok": True, "stale": True,
                        "unit_done": unit.state == "done",
                        "requeued": [],
                        "survey_done": self._survey_done_locked()}
            lease = self._leases.get(lease_id)
            if lease is not None and lease.unit_id == unit_id:
                del self._leases[lease_id]
                self._end_lease_span_locked(
                    lease, "completed" if error is None else "error")
                # capacity signals: the worker-reported unit
                # wall splits grant→resolution into queue wait (the
                # lease sat granted before work started — the
                # queue-wait p95 SLO's indicator) and throughput (the
                # EWMA chunks/s behind every ETA and ScalingAdvice).
                # Absent on an old worker: skipped, never guessed.
                wall = doc.get("unit_wall_s")
                if isinstance(wall, (int, float)) and wall >= 0:
                    wait = max(0.0,
                               time.time() - lease.granted_at - wall)
                    _metrics.histogram(
                        "putpu_lease_wait_seconds").observe(wait)
                    if error is None:
                        self.capacity_model.note_unit(
                            worker_id, len(unit.chunks), float(wall))
            else:
                # the lease was already expired/revoked and possibly
                # re-granted: the straggler finished anyway.  Its ledger
                # writes are idempotent; all we do is count it.
                self._stats["duplicates"] += 1
                _metrics.counter(
                    "putpu_fleet_duplicate_completions_total").inc()
                self.journal.append("duplicate", unit=unit_id,
                                    worker=worker_id, lease=lease_id)
                logger.info(
                    "fleet: duplicate completion of %s by %s (lease %s "
                    "already resolved)", unit_id, worker_id, lease_id)
            if error is not None:
                requeued = self._requeue_locked(unit, done_cache,
                                                why=f"error: {error}")
                self._update_gauges_locked()
                return {"ok": True, "unit_done": unit.state == "done",
                        "requeued": list(requeued),
                        "survey_done": self._survey_done_locked()}
            remaining = self._ledger_remaining(unit, done_cache)
            if remaining:
                # claimed complete, ledger disagrees: a drain-truncated
                # unit (the worker says so — cooperative, no attempt
                # burned) or a lost write / lying worker (counted);
                # either way requeue exactly the missing chunks
                drained = bool(doc.get("drained"))
                requeued = self._requeue_locked(
                    unit, done_cache,
                    why=("drain-truncated unit" if drained
                         else "completion not backed by the ledger"),
                    count_attempt=not drained)
            else:
                requeued = ()
                if unit.state != "done":
                    if unit.id in self._pending:  # requeued duplicate
                        self._pending.remove(unit.id)
                    self._finish_unit_locked(unit)
                if worker is not None:
                    worker.units_completed += 1
            self._update_gauges_locked()
            return {"ok": True, "unit_done": unit.state == "done",
                    "requeued": list(requeued),
                    "survey_done": self._survey_done_locked()}

    def release(self, doc):
        """``release`` message: a draining worker returns leases it has
        not started (its in-flight unit finishes normally and arrives
        as a ``complete``).  The worker is marked draining — no further
        grants — and every returned unit is ledger-checked back into
        the queue.

        ``reason="too_large"`` is different: the worker's
        preflight found the unit's footprint above its memory budget.
        The worker is NOT marked draining (it wants other work), and
        each returned unit is **re-sharded smaller** — split in half —
        before requeueing, instead of landing verbatim on the next
        victim; the attempt counter still burns so a unit no worker
        can fit fails after ``max_attempts`` rather than ping-ponging
        forever."""
        worker_id = str(protocol.require(doc, "worker", str, "release"))
        lease_ids = protocol.require(doc, "leases", list, "release")
        reason = str(doc.get("reason", "drain"))
        # optional per-lease fencing tokens: a release of a
        # lease that no longer exists — the zombie side of a steal — is
        # rejected idempotently and counted, exactly like a stale
        # complete.  Absent (old workers), unknown leases stay silent.
        epochs = doc.get("epochs") if isinstance(doc.get("epochs"),
                                                 dict) else None
        too_large = reason == "too_large"
        done_cache = {}
        requeued = 0
        with self._lock:
            worker = self._workers.get(worker_id)
            if worker is not None:
                worker.last_seen = time.time()
                if not too_large:
                    worker.draining = True
            for lease_id in lease_ids:
                lease = self._leases.pop(str(lease_id), None)
                if lease is not None and lease.worker_id != worker_id:
                    # not this worker's lease to return — put it back
                    self._leases[lease.id] = lease
                    continue
                if lease is None:
                    if epochs is not None and str(lease_id) in epochs:
                        self._stats["stale_epochs"] += 1
                        _metrics.counter(
                            "putpu_fleet_stale_epoch_rejected_total"
                        ).inc()
                        self.journal.append(
                            "stale", worker=worker_id,
                            lease=str(lease_id),
                            epoch=epochs[str(lease_id)])
                    continue
                self._end_lease_span_locked(lease, f"released:{reason}")
                unit = self._units[lease.unit_id]
                if too_large and len(unit.chunks) > 1 \
                        and self._files[unit.fname].get("workload") \
                        != "periodicity":
                    # periodicity units are never split (one plane, one
                    # worker): the requeue below still burns an attempt,
                    # so an unfittable observation fails bounded
                    self._reshard_unit_locked(
                        unit, (len(unit.chunks) + 1) // 2,
                        f"too_large from {worker_id}")
                requeued += bool(self._requeue_locked(
                    unit, done_cache, why=f"released ({reason})",
                    count_attempt=too_large))
            self._update_gauges_locked()
        logger.info("fleet: %s released %d lease(s) (%s)", worker_id,
                    len(lease_ids), reason)
        return {"ok": True, "requeued": requeued}

    # -- requeue / unit lifecycle (call with the lock held) ------------------

    def _finish_unit_locked(self, unit):
        unit.state = "done"
        self._stats["completed"] += 1
        _metrics.counter("putpu_fleet_units_completed_total").inc()

    def _requeue_locked(self, unit, done_cache, why="",
                        count_attempt=True):
        """Put a unit's ledger-missing chunks back in the queue (at the
        front: stolen work is the oldest work).  Returns the requeued
        chunk tuple (empty = the ledger says everything is done).

        ``count_attempt=False`` for *cooperative* returns — a drain's
        released or truncated units: the ``max_attempts`` bound exists
        to stop a poison chunk that keeps killing workers (errors,
        expiries, revokes), and routine preemption churn must never
        burn it down into silent coverage holes.
        """
        remaining = self._ledger_remaining(unit, done_cache)
        if not remaining:
            if unit.id in self._pending:
                self._pending.remove(unit.id)
            if unit.state not in _TERMINAL:
                self._finish_unit_locked(unit)
            return ()
        unit.chunks = remaining
        if count_attempt:
            unit.attempts += 1
        # every requeue — steal, expiry, error, release — bumps the
        # fencing epoch: whoever held the old grant is now
        # provably stale, and the journal record makes the bump survive
        # a coordinator crash (a recovered coordinator must never hand
        # out an epoch a zombie still holds)
        unit.epoch += 1
        if unit.attempts >= self.max_attempts:
            unit.state = "failed"
            if unit.id in self._pending:
                self._pending.remove(unit.id)
            self._stats["failed"] += 1
            _metrics.counter("putpu_fleet_units_failed_total").inc()
            self.journal.append("failed", unit=unit.id,
                                attempts=unit.attempts, why=str(why))
            logger.error(
                "fleet: unit %s (%s chunks %s) FAILED after %d attempts "
                "(%s) — chunks stay unsearched, see /fleet/progress",
                unit.id, os.path.basename(unit.fname), list(remaining),
                unit.attempts, why)
            return ()
        unit.state = "pending"
        if unit.id not in self._pending:
            self._pending.insert(0, unit.id)
        self._stats["requeued"] += 1
        _metrics.counter("putpu_fleet_units_requeued_total").inc()
        self.journal.append("requeue", unit=unit.id,
                            attempts=unit.attempts, epoch=unit.epoch,
                            why=str(why))
        logger.warning("fleet: requeued unit %s chunks %s (%s, attempt "
                       "%d/%d, epoch %d)", unit.id, list(remaining), why,
                       unit.attempts, self.max_attempts, unit.epoch)
        return remaining

    def _survey_done_locked(self):
        return bool(self._units) and not self._pending \
            and not self._leases \
            and all(u.state in _TERMINAL for u in self._units.values())

    def _update_gauges_locked(self):
        _metrics.gauge("putpu_fleet_units_pending").set(
            len(self._pending))
        _metrics.gauge("putpu_fleet_workers").set(
            sum(1 for w in self._workers.values() if w.alive))

    # -- the sweep: lease expiry + health-probed stealing --------------------

    def sweep(self, now=None):
        """One expiry + probe pass (the auto-sweep thread calls this
        every ``probe_interval_s``; tests call it directly).  ``now``
        overrides the monotonic clock for deterministic expiry tests.
        Returns a summary dict of what the pass did."""
        now = time.monotonic() if now is None else now
        done_cache = {}
        expired = []
        with self._lock:
            for lease_id, lease in list(self._leases.items()):
                if lease.expires_at <= now:
                    del self._leases[lease_id]
                    self._end_lease_span_locked(lease, "expired")
                    unit = self._units[lease.unit_id]
                    self._stats["expired"] += 1
                    _metrics.counter(
                        "putpu_fleet_leases_expired_total").inc()
                    self._requeue_locked(
                        unit, done_cache,
                        why=f"lease {lease_id} on {lease.worker_id} "
                        "expired")
                    expired.append(lease_id)
            probe_targets = [(w.id, w.healthz_url)
                             for w in self._workers.values()
                             if w.alive and w.healthz_url]
        probes = {}
        histories = {}
        for worker_id, url in probe_targets:   # IO outside the lock
            probes[worker_id] = self._probe_one(url)
            if self.scrape_history and probes[worker_id] is not None:
                # same sweep, same live surface: the worker's metric
                # time-series rides back beside its verdict, so the
                # fleet report gets per-worker trends.
                # Workers without a sampler 404 -> None, harmless.
                histories[worker_id] = self._scrape_history_one(url)
        revoked = []
        with self._lock:
            for worker_id, verdict in probes.items():
                worker = self._workers.get(worker_id)
                if worker is None or not worker.alive:
                    continue
                if histories.get(worker_id) is not None:
                    worker.history = histories[worker_id]
                if verdict is None:
                    worker.probe_failures += 1
                    if worker.probe_failures >= self.dead_after:
                        worker.alive = False
                        logger.warning(
                            "fleet: worker %s declared DEAD after %d "
                            "failed probes — revoking its leases",
                            worker_id, worker.probe_failures)
                        revoked += self._revoke_worker_locked(
                            worker_id, done_cache, "worker dead")
                else:
                    worker.probe_failures = 0
                    worker.verdict = verdict
                    if verdict == "CRITICAL":
                        revoked += self._revoke_worker_locked(
                            worker_id, done_cache, "verdict CRITICAL")
            self._update_gauges_locked()
            if self.capacity_enabled:
                self._capacity_sweep_locked()
        return {"expired": expired, "revoked": revoked,
                "probed": {w: v for w, v in probes.items()}}

    # -- capacity observability -----------------------------------

    def _fleet_utilization_locked(self):
        """Mean ``putpu_worker_busy_fraction`` over alive workers that
        have reported one (``None`` without evidence — no verdict)."""
        fracs = []
        for w in self._workers.values():
            if not w.alive or not w.metrics:
                continue
            for rec in w.metrics:
                if rec.get("name") == "putpu_worker_busy_fraction" \
                        and (rec.get("labels") or {}).get("worker") \
                        == w.id and rec.get("value") is not None:
                    fracs.append(float(rec["value"]))
        if not fracs:
            return None
        return sum(fracs) / len(fracs)

    def _backlog_chunks_locked(self):
        """Chunks not yet resolved: the backlog the drain ETA prices."""
        return sum(len(u.chunks) for u in self._units.values()
                   if u.state not in _TERMINAL)

    def _capacity_sweep_locked(self):
        """One armed sweep's capacity pass: classify saturation, sample
        the gauges the time-series ring picks up, refresh the scaling
        advice, and raise/resolve the ``fleet_saturated`` condition."""
        depth = len(self._pending)
        util = self._fleet_utilization_locked()
        n_alive = sum(1 for w in self._workers.values() if w.alive)
        draining = self._survey_done_locked() or (
            bool(self._workers)
            and all(w.draining for w in self._workers.values()))
        state = self.saturation.observe(depth, util, draining=draining)
        backlog = self._backlog_chunks_locked()
        advice = self.capacity_model.advise(backlog, n_alive, state)
        self._advice = advice
        _metrics.gauge("putpu_capacity_queue_depth").set(depth)
        if util is not None:
            _metrics.gauge("putpu_capacity_utilization").set(
                round(util, 4))
        _metrics.gauge("putpu_capacity_desired_workers").set(
            advice.desired_workers)
        eta = self.capacity_model.eta_s(backlog, n_alive)
        if eta is not None:
            _metrics.gauge("putpu_capacity_backlog_eta_seconds").set(
                round(eta, 3))
        if self.health is not None:
            if state == "worker-bound":
                from ..obs.health import DEGRADED

                self.health.note_alert(
                    "fleet_saturated", DEGRADED,
                    f"fleet worker-bound: queue depth {depth} growing "
                    f"with utilization "
                    f"{'unknown' if util is None else f'{util:.2f}'} — "
                    f"advice: scale to {advice.desired_workers} "
                    "worker(s)")
                self._saturated_raised = True
            elif self._saturated_raised:
                self.health.resolve_alert("fleet_saturated")
                self._saturated_raised = False

    def capacity_doc(self):
        """The ``GET /fleet/capacity`` document — the autoscaler's
        input record.  Capacity-off serves an explicit refusal, not a
        guessed advice."""
        if not self.capacity_enabled:
            return {"enabled": False,
                    "reason": "capacity observability off "
                              "(FleetCoordinator(capacity=True) or "
                              "PUfleet coordinator --capacity arms it)"}
        with self._lock:
            n_alive = sum(1 for w in self._workers.values() if w.alive)
            backlog = self._backlog_chunks_locked()
            advice = self._advice
            doc = {
                "enabled": True,
                "state": self.saturation.state,
                "saturation": self.saturation.doc(),
                "queue_depth": len(self._pending),
                "backlog_chunks": backlog,
                "workers_alive": n_alive,
                "utilization": (None if (u := self
                                         ._fleet_utilization_locked())
                                is None else round(u, 4)),
                "throughput": self.capacity_model.doc(),
                "eta_s": (None if (e := self.capacity_model.eta_s(
                    backlog, n_alive)) is None else round(e, 3)),
                "advice": advice.doc() if advice is not None else None,
            }
        return doc

    def _probe_one(self, url):
        """One ``/healthz`` probe; the verdict string, or ``None`` when
        the worker is unreachable (transport error, junk response)."""
        try:
            _status, doc = protocol.get_json(
                url, timeout=self.probe_timeout_s)
            verdict = doc.get("status")
            return str(verdict) if verdict is not None else None
        except (OSError, ValueError, http.client.HTTPException):
            return None

    def _scrape_history_one(self, healthz_url):
        """One ``/metrics/history`` scrape off the worker's live
        surface; ``None`` when the worker serves no sampler (404) or
        the transport failed — history is a trend view, never worth a
        failed sweep."""
        base = healthz_url[: -len("/healthz")] \
            if healthz_url.endswith("/healthz") else healthz_url
        try:
            status, doc = protocol.get_json(
                base + "/metrics/history?last=64",
                timeout=self.probe_timeout_s)
        except (OSError, ValueError, http.client.HTTPException):
            return None
        if status != 200 or not isinstance(doc.get("samples"), list):
            return None
        return doc

    def _revoke_worker_locked(self, worker_id, done_cache, why):
        revoked = []
        for lease_id, lease in list(self._leases.items()):
            if lease.worker_id != worker_id:
                continue
            del self._leases[lease_id]
            self._end_lease_span_locked(lease, f"revoked:{why}")
            self._stats["revoked"] += 1
            _metrics.counter("putpu_fleet_leases_revoked_total").inc()
            self._requeue_locked(self._units[lease.unit_id], done_cache,
                                 why=f"revoked from {worker_id}: {why}")
            revoked.append(lease_id)
        return revoked

    def _sweep_loop(self):
        while True:
            with self._lock:
                if self._closed:
                    return
            try:
                self.sweep()
            except (OSError, ValueError, KeyError) as exc:
                # a sweep pass must not kill the thread that does the
                # stealing; anything outside these is a bug and should
                logger.warning("fleet: sweep pass failed (%r)", exc)
            time.sleep(self.probe_interval_s)

    # -- the read surface (GET /fleet/...) -----------------------------------

    def workers_doc(self):
        with self._lock:
            held = {}
            for lease in self._leases.values():
                held[lease.worker_id] = held.get(lease.worker_id, 0) + 1
            return {"workers": [w.doc(held.get(w.id, 0))
                                for w in sorted(self._workers.values(),
                                                key=lambda w: w.id)]}

    def leases_doc(self):
        now = time.monotonic()
        with self._lock:
            return {"leases": [
                {"lease": lease.id, "worker": lease.worker_id,
                 "unit": lease.unit_id,
                 "fname": self._units[lease.unit_id].fname,
                 "chunks": list(self._units[lease.unit_id].chunks),
                 "expires_in_s": round(lease.expires_at - now, 3),
                 "granted_at": round(lease.granted_at, 3)}
                for lease in sorted(self._leases.values(),
                                    key=lambda le: le.id)]}

    def progress_doc(self):
        """The ``/fleet/progress`` document: per-file ledger-derived
        chunk completion plus unit/worker/stat rollups."""
        with self._lock:
            files = []
            for fname, rec in sorted(self._files.items()):
                done = self._read_ledger_done(rec["fingerprint"])
                planned = set(rec["chunk_starts"])
                files.append({
                    "fname": fname, "fingerprint": rec["fingerprint"],
                    "chunks_total": rec["chunks_total"],
                    "chunks_done": len(done & planned)})
            states = {}
            for unit in self._units.values():
                states[unit.state] = states.get(unit.state, 0) + 1
            total = sum(f["chunks_total"] for f in files)
            done = sum(f["chunks_done"] for f in files)
            # ETA from the EWMA throughput model:
            # tracks the CURRENT fleet rate instead of extrapolating
            # done/elapsed, which misleads mid-survey when chunk walls
            # drift.  None until any unit wall has been reported.
            n_alive = sum(1 for w in self._workers.values() if w.alive)
            eta = self.capacity_model.eta_s(max(total - done, 0),
                                            n_alive)
            return {
                "files": files,
                "chunks_total": total,
                "chunks_done": done,
                "eta_s": None if eta is None else round(eta, 1),
                "units": states,
                "workers": {"registered": len(self._workers),
                            "alive": sum(1 for w in
                                         self._workers.values()
                                         if w.alive)},
                "stats": dict(self._stats),
                "survey_done": self._survey_done_locked()}

    def fleet_metrics_text(self):
        """The fleet-aggregated ``/fleet/metrics`` Prometheus page:
        every worker's last reported registry snapshot, re-exposed with
        a ``worker`` label.  Counter/gauge samples only — histogram
        series are per-worker detail a fleet operator scrapes from the
        worker's own ``/metrics``."""
        from ..obs.metrics import _fmt_labels

        with self._lock:
            snapshots = [(w.id, w.metrics)
                         for w in sorted(self._workers.values(),
                                         key=lambda w: w.id)
                         if w.metrics]
        typed = {}
        samples = []
        for worker_id, snap in snapshots:
            for rec in snap:
                if rec.get("type") not in ("counter", "gauge") \
                        or "value" not in rec:
                    continue
                name = rec["name"]
                typed.setdefault(name, rec["type"])
                labels = dict(rec.get("labels") or {})
                labels["worker"] = worker_id
                samples.append(
                    (name, _fmt_labels(sorted(labels.items())),
                     rec["value"]))
        lines = []
        seen = set()
        for name, label_str, value in sorted(samples):
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} {typed[name]}")
            lines.append(f"{name}{label_str} {value}")
        return "\n".join(lines) + "\n"

    def fleet_history_doc(self):
        """``GET /fleet/history``: every worker's last scraped
        ``/metrics/history`` ring, keyed by worker id."""
        with self._lock:
            return {"workers": {w.id: w.history
                                for w in sorted(self._workers.values(),
                                                key=lambda w: w.id)
                                if w.history is not None}}

    @staticmethod
    def _compact_history(history):
        """``{series: [[t, value], ...]}`` for the report's trend
        plots, pulled from one worker's scraped history doc."""
        out = {}
        for point in history.get("samples", ()):
            for name in _HISTORY_SERIES:
                rec = (point.get("series") or {}).get(name)
                if rec is None or rec.get("value") is None:
                    continue
                out.setdefault(name, []).append(
                    [point["t"], rec["value"]])
        return out

    def summary(self):
        """Condensed end-of-run record (the survey report's fleet
        section and the CLI's final log line)."""
        doc = self.progress_doc()
        with self._lock:
            workers = [w.doc(0) for w in sorted(self._workers.values(),
                                                key=lambda w: w.id)]
            history = {w.id: self._compact_history(w.history)
                       for w in self._workers.values()
                       if w.history is not None}
            # alert-delivery rollup: the putpu_push_* family
            # rides each completion's metrics snapshot — sum it across
            # workers so the fleet record answers "did every detection
            # reach its webhooks" without scraping N workers.  Absent
            # when no worker pushed anything (byte-inert off).
            push = {}
            for w in self._workers.values():
                for rec in (w.metrics or ()):
                    name = rec.get("name", "")
                    if name.startswith("putpu_push_") \
                            and rec.get("type") == "counter" \
                            and rec.get("value"):
                        push[name] = push.get(name, 0) + rec["value"]
        out = {"chunks_total": doc["chunks_total"],
               "chunks_done": doc["chunks_done"],
               "units": doc["units"], "stats": doc["stats"],
               "survey_done": doc["survey_done"],
               "workers": [{k: w[k] for k in
                            ("worker", "verdict", "alive",
                             "units_completed")} for w in workers]}
        if any(history.values()):
            # per-worker metric trends: the report plots
            # chunks/s, headroom and recall over time, not just finals
            out["history"] = {k: v for k, v in sorted(history.items())
                              if v}
        if push:
            out["push"] = {k: push[k] for k in sorted(push)}
        if self.capacity_enabled:
            # capacity & scaling rollup: the report's
            # "Capacity & scaling" section and the coordinator
            # summary's autoscaler-facing record.  Absent when the
            # layer is off — the report states the absence.
            out["capacity"] = self.capacity_doc()
        return out

    @property
    def survey_done(self):
        with self._lock:
            return self._survey_done_locked()

    def close(self):
        with self._lock:
            self._closed = True
        if self._sweeper is not None:
            self._sweeper.join(timeout=self.probe_interval_s + 5.0)
        self.journal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
