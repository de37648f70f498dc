"""The full-observation periodicity job: accumulate -> acceleration
search -> sift -> fold -> persist.

The port of the JAX package's ``periodicity/driver.py`` (the job behind
``PUperiod``).  :func:`~..pipeline.search_pipeline.search_by_chunks`
streams, cleans and dedisperses every chunk as a single-pulse survey
would (single-pulse candidates are persisted as a bonus) and its
``plane_consumer`` seam hands each chunk's plane to the
:class:`~.accumulate.DMTimeAccumulator`.

Resume: the chunk ledger records completion under a periodicity
fingerprint (``fingerprint_extra``), and the accumulator snapshots its
partial plane beside it.  A chunk the ledger marks done but the snapshot
lost is re-searched after the streaming pass, so accumulation never
holes silently.  A failure of the device trial search raises (the
``period`` fault site is there): there is no host fallback.

The service hooks of the JAX driver: ``health`` (fed by the chunk loop
and the periodic canary), ``http_port`` (the live surface of the
accumulation), ``report_out`` (the report's Periodicity section),
``cancel_cb`` (a cancelled job reports ``complete: False`` and resumes
from its ledger) and ``fence`` (a fleet lease's epoch); the job service
(:mod:`..beams.service`) and the fleet worker (:mod:`..fleet.worker`)
drive them.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np

from ..faults import inject as fault_inject
from ..obs import metrics as _metrics
from ..utils.device import resolve_device
from .accel import accel_grid, accel_search, jerk_grid
from .accumulate import DMTimeAccumulator
from .candidates import (ZapList, candidate_list, fold_candidates,
                         harmonic_ratio, save_candidates, sift_candidates)
from .fdas import fdas_search

logger = logging.getLogger("pulsarutils_tpu_torch")

__all__ = ["periodicity_search"]

#: keywords forwarded to ``plan_survey`` (the rest of ``search_kwargs``
#: shapes the session, not the plan or the fingerprint)
_PLAN_KEYS = ("chunk_length", "new_sample_time", "tmin", "surelybad",
              "fft_zap", "cut_outliers", "zero_dm", "exact_floor")

#: periodic-canary shape: a Gaussian pulse train of this duty cycle at
#: this fraction of the spectral band, on this DM-row fraction
_CANARY_DUTY = 0.08
_CANARY_BIN_FRAC = 0.12
_CANARY_ROW_FRAC = 1 / 3


def _inject_canary(plane, tsamp):
    """Inject the synthetic pulsar into a copy of the plane: ``(copy,
    row, freq)``, 10 row-noise standard deviations at the train's peak."""
    ndm, nout = plane.shape
    row = max(int(ndm * _CANARY_ROW_FRAC), 0)
    bin_c = max(int(round(_CANARY_BIN_FRAC * (nout // 2))), 4)
    freq = bin_c / (nout * tsamp)
    out = np.array(plane, copy=True)
    std = float(np.std(out[row])) or 1.0
    phase = (np.arange(nout) * tsamp * freq) % 1.0
    dist = np.minimum(phase, 1.0 - phase)
    out[row] += (10.0 * std
                 * np.exp(-0.5 * (dist / _CANARY_DUTY) ** 2)
                 ).astype(out.dtype)
    return out, row, freq


def _canary_is_recovered(cand, freq, freq_tol):
    """True when a canary-row candidate is the injection (or an integer
    harmonic of it)."""
    return (abs(cand["freq"] - freq) <= freq_tol
            or harmonic_ratio(freq, cand["freq"]) > 0)


def _resolve_accel_backend(ndm, nout, tsamp, accels, jerks, max_harmonics,
                           fmin, fmax, dev, mesh=None):
    """``accel_backend="auto"``: the measured backend of
    :func:`~..tuning.autotune.resolve_accel_backend` at the plane's
    geometry (``time_stretch`` below the tuning floor).  On the CPU a
    failure of the resolution degrades to ``time_stretch``, as in the JAX
    package; on the card it propagates — it is a kernel of the static
    path failing, and a fallback would hide it."""
    from ..tuning.autotune import resolve_accel_backend

    try:
        return resolve_accel_backend(ndm, nout, tsamp, accels, jerks=jerks,
                                     max_harmonics=max_harmonics, fmin=fmin,
                                     fmax=fmax, device=dev, mesh=mesh)
    except Exception as exc:
        if dev.type == "cuda":
            raise
        logger.warning("accel backend resolution failed (%r); using "
                       "time_stretch", exc)
        return "time_stretch"


def _linear_grid(value_max, n):
    """``n`` odd trials over ``[-value_max, value_max]``, always with 0
    (``n <= 1`` or ``value_max <= 0``: the zero trial alone)."""
    n = int(n)
    if value_max <= 0 or n <= 1:
        return np.zeros(1)
    return np.linspace(-value_max, value_max, max(n, 3) | 1)


def periodicity_search(fname, dmmin=200, dmmax=800, *, accel_max=0.0,
                       n_accel=None, jerk_max=0.0, n_jerk=None,
                       accel_backend="auto", sigma_threshold=8.0, topk=64,
                       max_harmonics=16, fmin=None, fmax=None, nbin=32,
                       zap=None, zap_path=None, rebin="auto",
                       budget_bytes=None, snapshot_every=1, kernel="auto",
                       snr_threshold=6.0, output_dir=None, resume=True,
                       canary=False, chunk_cb=None, device="cuda",
                       progress=True, health=None, http_port=None,
                       report_out=None, fence=None, cancel_cb=None,
                       mesh=None,
                       **search_kwargs):
    """Search one filterbank for (accelerated) pulsars at survey scale.

    1. **accumulate**: stream the file through ``search_by_chunks``
       (``search_kwargs`` pass through; ``kernel`` picks its sweep) and
       fold every chunk's plane into the rebinned full-observation
       DM–time plane;
    2. **trial search**: the (DM, accel[, jerk]) sweep over
       ``accel_grid(accel_max)`` x ``jerk_grid(jerk_max)``
       (``n_accel``/``n_jerk`` give odd linear grids instead) on
       ``device``.  ``accel_backend`` ``"time_stretch"``
       (:func:`~.accel.accel_search`) or ``"fdas"``
       (:func:`~.fdas.fdas_search`, one rfft per DM row and the
       z/w-response correlation); ``"auto"`` the faster of the two at
       the plane's geometry, measured once and cached
       (:func:`~..tuning.autotune.resolve_accel_backend`;
       ``"time_stretch"`` below the tuning floor);
    3. **candidates**: threshold at ``sigma_threshold``, zap / DM
       grouping / harmonic sift, fold the survivors;
    4. **persist**: ``period_cands_<root>_<fingerprint>.npz`` beside the
       chunk ledger.

    ``canary=True`` injects a synthetic pulsar into a copy of the plane
    at DM row ``ndm // 3`` and reports its recovery; candidates within
    two trials of that row are excluded from the science list.
    ``progress`` passes to the chunk loop (a log line every 50 chunks).
    ``mesh`` (a :class:`~..parallel.mesh.Mesh` of ``device``'s kind)
    runs the single-pulse leg on the mesh route of ``search_by_chunks``
    (its fingerprint holds the mesh shape) and the trial sweep with the
    DM rows on its ``dm`` axis and the trials on its ``chan`` axis, as in
    the JAX package.

    Service hooks, as in the JAX package: ``health`` (a
    :class:`~..obs.health.HealthEngine`) gets the chunk loop's updates
    and the canary's recall; ``http_port`` serves the live surface while
    the chunks accumulate; ``report_out`` writes the survey report with
    its Periodicity section; ``cancel_cb`` (zero-arg callable) is checked
    before each chunk, and a cancelled run returns ``complete: False``
    (the chunks done stay in the ledger and the snapshot, so a rerun
    resumes).  ``fence``, a fleet lease's epoch, fences the chunk loop's
    candidate writes and the candidates npz
    (:meth:`~..io.candidates.CandidateStore.fenced_write`): a session
    whose lease was stolen does not overwrite the new owner's file.

    The trial sweep is the ``period`` fault site
    (:mod:`..faults.inject`).  On the card a failure there propagates:
    the job fails (a fleet unit is requeued) and nothing is retried on
    the host, where the JAX package falls back to NumPy.

    Returns a dict: ``complete``, ``candidates``, ``sift``, ``table``
    (the raw top-k), ``accumulator``, ``accels``, ``jerks``,
    ``accel_backend``, ``fingerprint``, ``candidates_path``,
    ``snapshot_path``, ``canary``, ``seconds`` (``trials``, ``fold``)
    and the single-pulse leg's ``hits`` and ``store``.
    """
    from ..ops.plan import dedispersion_plan
    from ..pipeline.search_pipeline import plan_survey, search_by_chunks

    for k in ("period_search", "period_sigma_threshold", "make_plots",
              "plane_consumer", "fingerprint_extra"):
        if k in search_kwargs:
            raise ValueError(
                f"{k} is owned by the periodicity driver (use "
                "sigma_threshold for the candidate floor)")
    if accel_backend not in ("auto", "time_stretch", "fdas"):
        raise ValueError(f"accel_backend must be 'auto', 'time_stretch' "
                         f"or 'fdas', got {accel_backend!r}")
    dev = resolve_device(device)
    output_dir = output_dir or os.path.dirname(os.path.abspath(str(fname)))
    extra = {"workload": "periodicity", "accel_max": float(accel_max)}
    if jerk_max:
        extra["jerk_max"] = float(jerk_max)
    plan_kw = {k: search_kwargs[k] for k in _PLAN_KEYS
               if k in search_kwargs}
    sp = plan_survey(fname, dmmin=dmmin, dmmax=dmmax, kernel=kernel,
                     snr_threshold=snr_threshold, fingerprint_extra=extra,
                     mesh=mesh, **plan_kw)
    header = sp["reader"].header
    trial_dms = dedispersion_plan(header["nchans"], dmmin, dmmax,
                                  header["fbottom"], header["bandwidth"],
                                  sp["plan"].sample_time)
    acc = DMTimeAccumulator(sp["plan"], sp["nsamples"], sp["chunk_starts"],
                            len(trial_dms), rebin=rebin,
                            budget_bytes=budget_bytes, trial_dms=trial_dms,
                            device=dev)
    snap_path = os.path.join(output_dir,
                             f"period_accum_{sp['fingerprint']}.npz")
    if resume:
        acc.restore(snap_path)
    logger.info(
        "periodicity job: %d DM trials x %d chunks -> %d x %d plane "
        "(rebin %d, tsamp %.4gs, T_obs %.1fs)", len(trial_dms),
        len(sp["chunk_starts"]), acc.ndm, acc.nout, acc.rebin, acc.tsamp,
        acc.nout * acc.tsamp)

    state = {"since_snap": 0}

    def consumer(istart, plane, table):
        if acc.consume(istart, plane, table):
            state["since_snap"] += 1
            if snapshot_every and state["since_snap"] >= snapshot_every:
                acc.save(snap_path)
                state["since_snap"] = 0
        if chunk_cb is not None:
            chunk_cb(istart)

    common = dict(dmmin=dmmin, dmmax=dmmax, kernel=kernel,
                  snr_threshold=snr_threshold, output_dir=output_dir,
                  make_plots=False, fingerprint_extra=extra,
                  plane_consumer=consumer, progress=progress,
                  device=dev, mesh=mesh, **search_kwargs)
    hits, store = search_by_chunks(fname, resume=resume, health=health,
                                   http_port=http_port,
                                   cancel_cb=cancel_cb, fence=fence,
                                   **common)
    if state["since_snap"] or not os.path.exists(snap_path):
        acc.save(snap_path)
        state["since_snap"] = 0

    # quarantined chunks never reach the accumulator: the plane carries
    # them as zeros instead of re-searching them forever
    quarantined = {int(c) for c in store.quarantined_chunks}
    missing = set(acc.chunk_starts) - acc.seen - quarantined
    cancelled = cancel_cb is not None and cancel_cb()
    if missing and not cancelled:
        # ledger-done chunks whose planes never reached the snapshot:
        # re-search exactly those, ledger-less
        logger.warning(
            "periodicity accumulation is missing %d ledger-done "
            "chunk(s); re-searching them for their planes", len(missing))
        search_by_chunks(fname, resume=False, chunks=sorted(missing),
                         **common)
        acc.save(snap_path)
        missing = set(acc.chunk_starts) - acc.seen - quarantined
    if missing:
        logger.info("periodicity job incomplete: %d chunk(s) not yet "
                    "accumulated — resume to continue", len(missing))
        return {"complete": False, "candidates": None, "sift": None,
                "table": None, "accumulator": acc, "accels": None,
                "fingerprint": sp["fingerprint"], "candidates_path": None,
                "snapshot_path": snap_path, "canary": None, "hits": hits,
                "store": store}
    if quarantined:
        logger.warning(
            "periodicity plane carries %d quarantined chunk(s) as zeros — "
            "bounded sensitivity loss, see the quarantine manifest",
            len(quarantined))

    # -- the (DM, accel) trial sweep -----------------------------------------
    tsamp_out = acc.tsamp
    nout = acc.nout
    accels = (accel_grid(accel_max, tsamp_out, nout) if n_accel is None
              else _linear_grid(accel_max, n_accel))
    jerks = (jerk_grid(jerk_max, tsamp_out, nout) if n_jerk is None
             else _linear_grid(jerk_max, n_jerk))
    # the single zero trial is "no jerk axis"
    jerks_axis = jerks if len(jerks) > 1 else None
    fmin_eff = fmin if fmin is not None else 4.0 / (nout * tsamp_out)
    freq_tol = 1.5 / (nout * tsamp_out)
    chosen_backend = accel_backend
    if chosen_backend == "auto":
        chosen_backend = _resolve_accel_backend(
            acc.ndm, nout, tsamp_out, accels, jerks_axis, max_harmonics,
            fmin_eff, fmax, dev, mesh=mesh)

    canary_info = None
    plane_search = acc.plane
    if canary:
        plane_search, c_row, c_freq = _inject_canary(acc.plane, tsamp_out)
        canary_info = {"dm_index": c_row, "freq": c_freq,
                       "recovered": False}

    search_fn = fdas_search if chosen_backend == "fdas" else accel_search
    t0 = time.perf_counter()
    fault_inject.fire("period")
    table = search_fn(plane_search, tsamp_out, accels, jerks=jerks_axis,
                      max_harmonics=max_harmonics, fmin=fmin_eff,
                      fmax=fmax, topk=topk, device=dev, mesh=mesh)
    trial_s = time.perf_counter() - t0
    _metrics.counter("putpu_period_trials_total").inc(
        int(acc.ndm * len(accels) * len(jerks)))
    logger.info("periodicity trial sweep: %d DM x %d accel%s trials in "
                "%.2fs [%s]", acc.ndm, len(accels),
                f" x {len(jerks)} jerk" if len(jerks) > 1 else "", trial_s,
                chosen_backend)

    raw = candidate_list(table, acc.trial_dms, sigma_threshold)
    _metrics.counter("putpu_period_candidates_total").inc(len(raw))
    if canary_info is not None:
        on_row = [c for c in raw
                  if abs(c["dm_index"] - canary_info["dm_index"]) <= 2]
        matched = [c for c in on_row
                   if _canary_is_recovered(c, canary_info["freq"],
                                           freq_tol)]
        canary_info["recovered"] = bool(matched)
        canary_info["best_sigma"] = max(
            (c["sigma"] for c in matched), default=0.0)
        recall = 1.0 if matched else 0.0
        _metrics.gauge("putpu_period_canary_recall").set(recall)
        if health is not None:
            health.update("periodicity", canary={"injected": 1,
                                                 "window_recall": recall})
        if not matched:
            logger.error(
                "PERIODIC CANARY MISSED: injected pulsar at DM row %d, "
                "f=%.4f Hz not recovered by the trial search",
                canary_info["dm_index"], canary_info["freq"])
        # the whole neighbourhood is excluded
        raw = [c for c in raw if c not in on_row]

    zap_obj = zap if isinstance(zap, ZapList) else (
        ZapList.load(zap_path) if zap_path else zap)
    kept, sift_stats = sift_candidates(raw, zap=zap_obj, freq_tol=freq_tol)
    t0 = time.perf_counter()
    fold_candidates(acc, kept, nbin=nbin, device=dev)
    fold_s = time.perf_counter() - t0

    meta = {"fname": os.path.abspath(str(fname)),
            "fingerprint": sp["fingerprint"],
            "dmmin": float(dmmin), "dmmax": float(dmmax),
            "accel_max": float(accel_max), "n_accel": len(accels),
            "jerk_max": float(jerk_max), "n_jerk": len(jerks),
            "accel_backend": chosen_backend,
            "rebin": acc.rebin, "tsamp": acc.tsamp, "nout": acc.nout,
            "sigma_threshold": float(sigma_threshold),
            "max_harmonics": int(max_harmonics),
            "sift": sift_stats,
            "quarantined_chunks": sorted(quarantined),
            "canary": canary_info}
    cands_path = os.path.join(
        output_dir, f"period_cands_{sp['root']}_{sp['fingerprint']}.npz")
    if not store.fenced_write(
            cands_path, lambda: save_candidates(cands_path, kept, meta=meta)):
        logger.warning(
            "periodicity candidates write fenced off: %s is stamped "
            "with a higher lease epoch (this session's lease was stolen; "
            "the new owner's file stands)", cands_path)
    _metrics.counter("putpu_period_jobs_total").inc()

    summary = {
        "n_dm": acc.ndm, "n_accel": len(accels), "n_jerk": len(jerks),
        "accel_backend": chosen_backend, "nout": acc.nout,
        "rebin": acc.rebin, "tsamp": acc.tsamp,
        "t_obs_s": round(acc.nout * acc.tsamp, 3),
        "raw_candidates": sift_stats["in"], "kept": sift_stats["kept"],
        "rejected": sift_stats["rejected"], "canary": canary_info,
        "top": [{k: c[k] for k in ("dm", "accel", "jerk", "freq",
                                   "sigma", "nharm")}
                for c in kept[:5]],
    }
    logger.info("PERIOD_JSON %s", json.dumps(summary, default=float))
    if kept:
        best = kept[0]
        logger.info(
            "periodicity: best candidate f=%.6f Hz (P=%.6f s) DM=%.2f "
            "accel=%.2f m/s^2 sigma=%.1f nharm=%d", best["freq"],
            1.0 / best["freq"], best["dm"], best["accel"], best["sigma"],
            best["nharm"])
    else:
        logger.info("periodicity: no candidates above sigma %.1f",
                    float(sigma_threshold))

    if report_out:
        from ..obs import report as obs_report

        try:  # observability must never take down the job
            obs_report.write_report(
                str(report_out),
                meta={"root": sp["root"], "workload": "periodicity",
                      "fname": os.path.abspath(str(fname)),
                      "fingerprint": sp["fingerprint"]},
                periodicity=dict(summary, candidates=[
                    {k: c.get(k) for k in ("dm", "accel", "jerk", "freq",
                                           "freq_refined", "sigma",
                                           "nharm", "h", "m")}
                    for c in kept]),
                health=health.snapshot() if health is not None else None,
                metrics=_metrics.REGISTRY.snapshot())
        except Exception as exc:  # noqa: BLE001 — never fatal
            logger.warning("periodicity report failed (%r); job result "
                           "is unaffected", exc)

    return {"complete": True, "candidates": kept, "sift": sift_stats,
            "table": table, "accumulator": acc, "accels": accels,
            "jerks": jerks, "accel_backend": chosen_backend,
            "fingerprint": sp["fingerprint"],
            "candidates_path": cands_path, "snapshot_path": snap_path,
            "canary": canary_info,
            "seconds": {"trials": trial_s, "fold": fold_s},
            "hits": hits, "store": store}
