"""Single-source manifest of every ``putpu_*`` metric name.

A copy of the JAX package's manifest: the port emits the same series
under the same names, so a dashboard or a gate written for one package
reads the other.  Every metric name the port emits is declared here
with its one-line meaning; the registry (:mod:`.metrics`) serves that
meaning as the Prometheus HELP text of an instrument created without
one, and :func:`warn_unknown` logs once per undeclared ``putpu_*`` name
instead of silently minting a new series.  The tables are held equal to
the JAX package's by the tests.  Stdlib only.
"""

from __future__ import annotations

__all__ = ["METRIC_NAMES", "BUDGET_COUNTERS", "PORT_METRIC_NAMES",
           "budget_counter_metric", "is_known", "meaning", "warn_unknown"]

#: every statically-named metric: name -> one-line meaning.  Sorted.
METRIC_NAMES = {
    "putpu_audit_issues_total":
        "end-of-run integrity audit inconsistencies",
    "putpu_autotune_cache_hits_total":
        "kernel=auto resolutions served by a remembered decision (this "
        "process, tuned or static-fallback) or a tuned disk entry",
    "putpu_autotune_cache_misses_total":
        "kernel=auto resolutions with no remembered decision and no "
        "tuned disk entry for the geometry key",
    "putpu_autotune_equiv_rejected_total":
        "tuning candidates rejected by the exact-hit-match harness",
    "putpu_autotune_keys":
        "geometry keys resolved by the kernel autotuner this process",
    "putpu_autotune_measurements_total":
        "tuning candidates micro-benchmarked (labelled by kernel)",
    "putpu_autotune_speedup":
        "last tuned key's measured static-choice/winner wall ratio",
    "putpu_autotune_static_fallbacks_total":
        "kernel=auto resolutions that fell back to the static heuristic",
    "putpu_beam_chunks_total":
        "beam-chunks completed by the multi-beam driver (labelled by "
        "beam)",
    "putpu_beam_hits_total":
        "beam-chunks whose best S/N cleared the threshold (labelled by "
        "beam)",
    "putpu_bytes_readback_total":
        "bytes copied device -> host",
    "putpu_bytes_uploaded_total":
        "bytes copied host -> device",
    "putpu_canary_contaminated_tables_total":
        "real hits persisted with canary-lit trial rows in their table",
    "putpu_canary_discarded_total":
        "pending canary injections dropped (chunk never searched)",
    "putpu_canary_dm_error":
        "histogram of |DM error| for recovered canaries",
    "putpu_canary_injected_total":
        "canary pulses observed by the search",
    "putpu_canary_missed_total":
        "canary pulses the search failed to recover",
    "putpu_canary_packed_injections_total":
        "canary pulses quantized and re-packed into packed low-bit "
        "chunks",
    "putpu_canary_period_skips_total":
        "folded period-search stages skipped on injected chunks",
    "putpu_canary_promoted_hits_total":
        "genuine weaker pulses promoted when a canary topped the chunk",
    "putpu_canary_recall":
        "cumulative canary recall (recovered / injected)",
    "putpu_canary_recovered_total":
        "canary pulses recovered above the hit threshold",
    "putpu_canary_snr_ratio":
        "histogram of measured/target canary S/N",
    "putpu_canary_tagged_hits_total":
        "chunk best rows tagged as the canary and excluded",
    "putpu_canary_window_recall":
        "recall over the rolling canary window",
    "putpu_candidate_latency_seconds":
        "histogram of end-to-end candidate latency, sample read to "
        "persist complete (the candidate-latency p95 SLO's source)",
    "putpu_candidate_stage_seconds":
        "histogram of per-stage candidate latency (labelled by stage: "
        "read/dispatch/device/sift/persist/alert)",
    "putpu_capacity_backlog_eta_seconds":
        "estimated seconds to drain the unresolved chunk backlog at "
        "the EWMA fleet throughput",
    "putpu_capacity_desired_workers":
        "worker count the scaling-advice engine currently recommends",
    "putpu_capacity_queue_depth":
        "pending work units sampled by the capacity-armed sweep",
    "putpu_capacity_utilization":
        "mean busy fraction over alive workers (the saturation "
        "detector's utilization input)",
    "putpu_certified_chunks_total":
        "chunks whose hybrid noise certificate held",
    "putpu_chunks_per_s":
        "end-of-run survey throughput",
    "putpu_coincidence_groups_total":
        "cross-beam coincidence groups formed",
    "putpu_coincidence_verdicts_total":
        "coincidence group verdicts (labelled rfi/confirmed/ambiguous)",
    "putpu_coincidence_vetoed_candidates_total":
        "per-beam candidates absorbed by anti-coincidence RFI vetoes",
    "putpu_chunk_wall_seconds":
        "histogram of per-chunk wall seconds (the chunk-wall p95 SLO's "
        "source; BUDGET_JSON quotes exact percentiles from the ledger)",
    "putpu_chunks_quarantined_total":
        "chunks quarantined by the integrity gate",
    "putpu_chunks_sanitized_total":
        "chunks NaN-imputed by the sanitize policy",
    "putpu_chunks_total":
        "chunk budgets closed",
    "putpu_device_bytes_in_use":
        "device memory currently allocated",
    "putpu_device_bytes_limit":
        "device memory limit reported by the allocator",
    "putpu_device_bytes_peak":
        "process-lifetime device-memory high-water mark",
    "putpu_device_headroom_bytes":
        "device memory limit minus in-use",
    "putpu_dispatch_retries_total":
        "chunk searches re-attempted after failure/timeout",
    "putpu_faults_injected_total":
        "fault-plan firings (labelled by site)",
    "putpu_fdas_bank_entries_total":
        "distinct (z, w) response templates built for fdas correlation "
        "banks",
    "putpu_fdas_trials_total":
        "(DM, accel, jerk) trials scored by the fdas correlation "
        "backend",
    "putpu_fleet_drains_total":
        "graceful worker drains (in-flight chunk finished, ledger "
        "flushed, unstarted leases returned)",
    "putpu_fleet_duplicate_completions_total":
        "unit completions whose lease was already expired/revoked "
        "(the straggler side of a steal; resolved by the ledger)",
    "putpu_fleet_fenced_writes_total":
        "candidate artifact writes refused by the lease-epoch fence "
        "(a stolen lease's zombie tried to clobber the new owner's "
        "output)",
    "putpu_fleet_idle_polls_total":
        "lease polls that returned no work (the utilization "
        "denominator; each one backs the poll interval off, jittered)",
    "putpu_fleet_journal_records_total":
        "records appended to the coordinator write-ahead journal",
    "putpu_fleet_journal_replayed_total":
        "journal records replayed by FleetCoordinator.recover()",
    "putpu_fleet_leases_denied_total":
        "lease requests denied to DEGRADED/CRITICAL workers",
    "putpu_fleet_leases_expired_total":
        "leases past their TTL, revoked and ledger-requeued",
    "putpu_fleet_leases_granted_total":
        "work-unit leases granted to workers",
    "putpu_fleet_leases_revoked_total":
        "leases revoked from CRITICAL/dead workers (work-stealing)",
    "putpu_fleet_recoveries_total":
        "coordinator crash recoveries completed (journal replayed, "
        "outstanding units re-derived from the ledgers)",
    "putpu_fleet_stale_epoch_rejected_total":
        "completes/releases carrying an out-of-date lease epoch, "
        "rejected idempotently (the fenced side of a steal or a "
        "coordinator restart)",
    "putpu_fleet_units_completed_total":
        "work units the per-file ledger confirms fully done",
    "putpu_fleet_units_failed_total":
        "work units abandoned after max_attempts requeues",
    "putpu_fleet_units_pending":
        "work units currently waiting in the coordinator queue",
    "putpu_fleet_units_requeued_total":
        "work units put back in the queue (expiry, revoke, release, "
        "error, or a completion the ledger did not back)",
    "putpu_fleet_units_resharded_total":
        "work units split smaller (a too_large release, or a lease "
        "sized to a worker's reported memory budget)",
    "putpu_fleet_wire_retries_total":
        "fleet wire calls re-attempted after a transient transport "
        "failure (flaky connect, reset socket)",
    "putpu_fleet_workers":
        "workers currently registered and alive",
    "putpu_health_incidents_total":
        "health conditions raised (labelled by kind)",
    "putpu_health_status":
        "current verdict as rank (0 OK / 1 DEGRADED / 2 CRITICAL)",
    "putpu_hits_total":
        "chunks whose best S/N cleared the threshold",
    "putpu_ingest_bytes_total":
        "payload bytes accepted from the live feed (wire bandwidth — "
        "bytes, not floats, on the packed path)",
    "putpu_ingest_chunks_quarantined_total":
        "assembled chunks quarantined as feed_gap (missing fraction "
        "above the integrity policy's zero rail)",
    "putpu_ingest_chunks_shed_total":
        "assembled chunks dropped oldest-first because search fell "
        "behind the feed (journaled shed_overrun)",
    "putpu_ingest_chunks_total":
        "fixed-geometry chunks cut by the ingest assembler",
    "putpu_ingest_gap_samples_total":
        "samples zero-filled because their packets never arrived",
    "putpu_ingest_packets_duplicate_total":
        "packets whose samples were already present (duplicates and "
        "fully-late arrivals)",
    "putpu_ingest_packets_invalid_total":
        "packets rejected before assembly (bad header, CRC, geometry "
        "mismatch)",
    "putpu_ingest_packets_reordered_total":
        "packets that arrived behind the stream watermark (reordered "
        "within the assembly window)",
    "putpu_ingest_packets_total":
        "wire packets received by the ingest assembler",
    "putpu_ingest_reconnects_total":
        "feed connections re-accepted after a disconnect",
    "putpu_ingest_shed_samples_total":
        "samples in shed chunks (every one journaled shed_overrun)",
    "putpu_job_chunks_done_total":
        "chunks completed per service job (labelled by job id)",
    "putpu_job_hits_total":
        "candidates found per service job (labelled by job id)",
    "putpu_jobs_finished_total":
        "service jobs reaching a terminal state (labelled by status)",
    "putpu_jobs_submitted_total":
        "jobs accepted by the survey service",
    "putpu_lease_wait_seconds":
        "histogram of grant-to-work lease wait seconds (grant to "
        "resolution minus the worker-reported unit wall; the "
        "queue-wait p95 SLO's source)",
    "putpu_lineage_docs_total":
        "per-candidate lineage documents persisted beside the npz",
    "putpu_metric_history_samples_total":
        "time-series ring-buffer samples taken over the registry",
    "putpu_lowbit_bytes_saved_total":
        "link bytes the packed low-bit upload saved vs float32",
    "putpu_lowbit_packed_chunks_total":
        "chunks searched from raw packed bytes (device unpack)",
    "putpu_multibeam_batches_total":
        "batched multi-beam dispatches (one device program serving N "
        "beam-chunks)",
    "putpu_oom_admission_capped_total":
        "service co-batches truncated by memory admission control",
    "putpu_oom_events_total":
        "RESOURCE_EXHAUSTED failures caught by the degradation ladder "
        "(labelled by surface)",
    "putpu_oom_floor_total":
        "chunks quarantined as oom_floor (even the numpy reliability "
        "floor ran out of memory)",
    "putpu_oom_headroom_at_failure_bytes":
        "device headroom observed at the last caught OOM (the "
        "estimator's calibration signal)",
    "putpu_oom_ladder_steps_total":
        "degradation-ladder descents (labelled by step)",
    "putpu_oom_splits_total":
        "dispatch-splitting decisions under memory pressure (labelled "
        "by stage: preflight = split planned before compiling, ladder "
        "= split after a caught OOM)",
    "putpu_period_canary_recall":
        "periodic-canary recall of the last trial search (1 = the "
        "injected synthetic pulsar was recovered)",
    "putpu_period_candidates_total":
        "raw above-threshold periodicity candidates from the (DM, "
        "accel) trial search",
    "putpu_period_chunks_accumulated_total":
        "chunk planes folded into the full-observation DM-time "
        "accumulator",
    "putpu_period_folds_total":
        "sift-surviving periodicity candidates phase-folded into "
        "profiles",
    "putpu_period_grid_capped_total":
        "trial grids coarsened by the max_trials cap (labelled by "
        "axis: accel/jerk)",
    "putpu_period_jobs_total":
        "periodicity jobs completed end to end (accumulate -> trial "
        "search -> sift -> fold -> persist)",
    "putpu_period_sift_rejected_total":
        "periodicity-sift rejections (labelled zap/dm_duplicate/"
        "harmonic)",
    "putpu_period_snapshot_writes_total":
        "accumulator resume snapshots persisted beside the chunk "
        "ledger",
    "putpu_period_trials_total":
        "(DM, accel[, jerk]) periodicity trials searched",
    "putpu_persist_dead_letter_total":
        "candidate persists abandoned to the dead-letter manifest",
    "putpu_plan_cache_hits_total":
        "geometry-keyed plan/program cache hits (labelled by cache)",
    "putpu_plan_cache_misses_total":
        "geometry-keyed plan/program cache misses (labelled by cache)",
    "putpu_precision_compensated_engagements_total":
        "dispatches that engaged a compensated/split accumulation "
        "strategy (labelled by policy)",
    "putpu_precision_overflow_averted_total":
        "exactness-domain checks that pushed an integer sweep back to "
        "float32 (code peak at or above 2^24)",
    "putpu_precision_policy_resolutions_total":
        "precision-policy resolutions at dispatch surfaces (labelled "
        "by policy)",
    "putpu_persist_retries_total":
        "candidate persists re-attempted after OSError",
    "putpu_push_dead_letter_total":
        "alert deliveries abandoned after retries and journaled to the "
        "push dead-letter file (labelled by subscriber)",
    "putpu_push_delivered_total":
        "candidate alerts delivered to a subscriber webhook (labelled "
        "by subscriber)",
    "putpu_push_delivery_seconds":
        "histogram of successful alert-delivery wall seconds",
    "putpu_push_dropped_total":
        "queued alerts evicted drop-oldest when the bounded push queue "
        "overflowed (a slow or dead subscriber, never backpressure)",
    "putpu_push_filtered_total":
        "alert/subscriber pairs skipped by min-S/N / DM filters",
    "putpu_push_subscribers":
        "webhook subscribers currently registered on the broker",
    "putpu_quarantine_records_total":
        "records appended to the quarantine manifest",
    "putpu_read_retries_total":
        "chunk reads re-attempted after OSError",
    "putpu_resume_pairs_skipped_total":
        "unreadable ledger/candidate pairs skipped at resume",
    "putpu_retraces_total":
        "XLA compiles observed after a stream's first chunk",
    "putpu_roofline_frac_of_ideal":
        "last-dispatch achieved fraction of the roofline bound",
    "putpu_roofline_gbytes_per_s":
        "last-dispatch achieved memory bandwidth",
    "putpu_roofline_gflops":
        "last-dispatch achieved GFLOP/s",
    "putpu_sift_candidates_in_total":
        "candidates entering the sift",
    "putpu_sift_candidates_kept_total":
        "candidates surviving the sift",
    "putpu_sift_dm":
        "histogram of kept-candidate DM",
    "putpu_sift_rejected_total":
        "sift rejections (labelled by reason)",
    "putpu_sift_snr":
        "histogram of kept-candidate S/N",
    "putpu_slo_alerts_total":
        "burn-rate alerts newly fired (labelled by slo and severity)",
    "putpu_slo_budget_remaining":
        "fraction of the SLO error budget left over the budget window "
        "(labelled by slo)",
    "putpu_slo_evaluations_total":
        "SLO engine evaluation passes over the metric time-series",
    "putpu_stream_chunks_failed_total":
        "stream chunks dropped under skip_failed containment",
    "putpu_stream_chunks_total":
        "chunks completed by stream_search",
    "putpu_stream_hits_total":
        "stream chunks whose best S/N cleared the threshold",
    "putpu_trace_clock_offset_seconds":
        "worker wall clock offset vs the coordinator, midpoint rule "
        "over the register/lease exchange (labelled by worker)",
    "putpu_trace_spans_collected_total":
        "worker span events stitched into the fleet trace collector",
    "putpu_worker_busy_fraction":
        "worker search wall over search + lease-poll wall (labelled "
        "by worker; rides each complete's metrics snapshot)",
    "putpu_worker_duty_cycle":
        "device-span seconds over the worker's busy wall (labelled by "
        "worker; dispatch-to-ready duty vs per-unit overhead)",
}

#: per-chunk budget counters mirrored dynamically by
#: ``BudgetAccountant.count(name)`` as ``putpu_<name>_total`` — the one
#: sanctioned dynamic-name seam (waived at its call site).  Adding a new
#: ``count()`` name means adding it here, or the runtime warns and the
#: doc/baseline coverage check cannot vouch for it.
BUDGET_COUNTERS = frozenset({
    "b1_launches",
    "b4_launches",
    "beam_direct",
    "dispatches",
    "host_sweeps",
    "offset_tables",
    "prefetch_uploads",
    "readbacks",
    "rescore_calls",
    "rescore_rows",
})


#: the port's own series, declared beside the JAX package's tables (which
#: stay equal to the JAX package's, but for the port's launch and
#: beam-sweep counters in BUDGET_COUNTERS): name -> one-line meaning
PORT_METRIC_NAMES = {
    "putpu_b1_launches_total":
        "B1 dedispersion kernel launches (csrc/dedisperse.cu) that "
        "reached the card, the port's budget counter b1_launches",
    "putpu_b4_launches_total":
        "B4 scorer kernel launches (csrc/score.cu) that reached the "
        "card, the port's budget counter b4_launches",
    "putpu_beam_direct_total":
        "beam sweeps of a beam batch run as the direct sweep (B1 and B4 "
        "a superblock), the port's budget counter beam_direct",
    "putpu_beam_sweeps_total":
        "beam sweeps of a beam batch's per-beam body (labelled by path: "
        "direct, B1 and B4 a superblock; torch, the gather or roll in "
        "torch with B4 a trial block)",
    "putpu_fallbacks_total":
        "chunks a device='cpu' run moved to its host path after the "
        "device attempts failed (labelled by stage)",
}


def meaning(name):
    """The one-line meaning of a declared name ("" if undeclared)."""
    return METRIC_NAMES.get(name) or PORT_METRIC_NAMES.get(name, "")


def budget_counter_metric(name):
    """The registry metric name a budget counter is mirrored under."""
    return f"putpu_{name}_total"


def is_known(name):
    """True when ``name`` is a declared metric (static or dynamic)."""
    if name in METRIC_NAMES or name in PORT_METRIC_NAMES:
        return True
    return (name.startswith("putpu_") and name.endswith("_total")
            and name[len("putpu_"):-len("_total")] in BUDGET_COUNTERS)


_warned = set()


def warn_unknown(name):
    """Log (once per name) when an emitted ``putpu_*`` name is missing
    from the manifest — the runtime mirror of the static check, for code
    paths the linter cannot see (plugins, interactive sessions)."""
    if not name.startswith("putpu_") or is_known(name) or name in _warned:
        return
    _warned.add(name)
    import logging

    logging.getLogger("pulsarutils_tpu_torch").warning(
        "metric %r is not declared in pulsarutils_tpu_torch.obs.names — add "
        "it to METRIC_NAMES (the putpu-lint metric-name checker enforces "
        "this statically)", name)
