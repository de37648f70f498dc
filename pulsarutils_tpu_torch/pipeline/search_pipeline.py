"""The streaming search driver: file -> clean -> sweep -> candidates.

The port of the JAX package's ``search_by_chunks`` with the exact direct
sweep (the default) or the FDMT/hybrid/Fourier kernels, itself the
counterpart of the reference's ``pulsarutils/clean.py:276-351``:

* bad channels are flagged once from the file's bandpass statistics;
* a single-IF 1, 2 or 4-bit file crosses to the card as its packed
  bytes and is unpacked there; its chunks are gated in the code domain
  and take the canary's bump on the reader thread (a multi-IF low-bit
  file is decoded on the host);
* the file is cut into 50%-overlap chunks sized by the search physics
  (:func:`..parallel.stream.plan_chunks`); a reader thread reads chunk
  ``k + 1`` into a page-locked buffer while the card searches chunk ``k``
  (:mod:`..utils.staging`), its upload starts on a side stream before
  chunk ``k``'s search, and each chunk is gated (:mod:`..faults.policy`),
  cleaned, searched and scored on the card; only the scores and hit
  products come back;
* a chunk whose best S/N exceeds ``snr_threshold`` is persisted through
  :class:`..io.candidates.CandidateStore` and every searched chunk is
  marked in the resume ledger, by a FIFO persist worker that overlaps the
  next chunk's search (save before mark inside one task, so the ledger
  and candidates are those of the serial loop);
* failures are contained as in the JAX package: read retries, the
  integrity gate and quarantine, persist retries and the dead letter, a
  dispatch deadline and retries, and the OOM ladder
  (:mod:`..resilience.ladder`); a run on the card never falls back to
  the host (only a ``device="cpu"`` run takes the JAX package's loud
  fallback to its plain path);
* with ``period_search`` each chunk's dedispersed plane also gets the
  folded period search (:func:`..ops.periodicity.period_search_plane`),
  and ``plane_consumer`` hands each plane downstream (the periodicity
  driver's accumulation seam);
* the loop accounts for itself as the JAX package's does: every chunk's
  wall in named buckets (:class:`..utils.logging_utils.BudgetAccountant`,
  the ``BUDGET_JSON`` line), spans for a trace, diagnostic figures
  (:mod:`.diagnostics`), the canary, health and the live HTTP surface,
  lineage and push, and the survey report (:mod:`..obs`).

Everything downstream of the reader sees an *ascending* band.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..faults import inject as fault_inject
from ..faults import reasons as fault_reasons
from ..faults.audit import audit_run
from ..faults.policy import (DispatchPolicy, QuarantineManifest,
                             call_with_deadline, gate_chunk,
                             gate_chunk_lowbit, gate_chunk_packed,
                             gate_frames, gate_tensor,
                             resolve_integrity_policy)
from ..io.candidates import CandidateStore, config_fingerprint
from ..io.sigproc import FilterbankReader
from ..obs import memory as obs_memory
from ..obs import metrics as obs_metrics
from ..obs import roofline
from ..obs.canary import CanaryController, inject_tensor, science_hit
from ..obs.capacity import EwmaThroughput
from ..obs.health import HealthEngine
from ..obs.lineage import LineageRecorder
from ..obs.push import AlertBroker
from ..obs.server import start_obs_server
from ..obs.trace import begin_span, is_tracing
from ..obs.trace import span as trace_span
from ..ops.certify import (certifiable_snr_floor, matched_snr_floor,
                           retention_bound)
from ..ops.clean_ops import fft_zap_time, renormalize_data, zero_dm_filter
from ..ops.periodicity import period_search_plane
from ..ops.plan import dedispersion_plan
from ..ops.rebin import quick_resample
from ..ops.search import dedispersion_search, ladder_blocks
from ..parallel.stream import iter_chunk_starts, plan_chunks
from ..resilience import ladder as _ladder
from ..utils.device import resolve_device, to_numpy
from ..utils.logging_utils import BudgetAccountant, measure_device_rtt
from ..utils.nvcc import KernelBuildError
from ..utils.staging import FrameStaging
from .pulse_info import PulseInfo
from .spectral_stats import get_bad_chans

logger = logging.getLogger("pulsarutils_tpu_torch")

#: chunks between two ``progress`` log lines (the JAX package's)
PROGRESS_EVERY = 50


def plan_survey(fname, chunk_length=None, new_sample_time=None, tmin=0,
                dmmin=200, dmmax=800, surelybad=(), *, kernel="auto",
                snr_threshold=6.0, fft_zap=False, cut_outliers=False,
                zero_dm=False, exact_floor="auto", period_search=False,
                period_sigma_threshold=8.0, fingerprint_extra=None,
                quarantine_policy="sanitize", mesh=None):
    """Resolve a survey's geometry, threshold and resume fingerprint
    without searching anything.

    ``snr_threshold`` is a number or one of two floors adapted to the
    chunk geometry (:mod:`..ops.certify`): ``"auto"``, the matched floor
    (noise ceiling + 1, never below the reference's 6), and
    ``"certifiable"``, the lowest floor whose hybrid noise certificate
    fires on signal-free chunks; both resolve to a number rounded to two
    decimals.  ``exact_floor`` decides whether the threshold also goes to
    ``kernel="hybrid"`` as its ``snr_floor``: ``"auto"`` only when it sits
    at or above the certifiable floor, ``True`` always, ``False`` never.

    Returns a dict: ``reader`` (the open reader), ``plan`` (the
    :class:`~..parallel.stream.ChunkPlan`), ``chunk_starts``,
    ``snr_threshold`` (resolved), ``search_snr_floor`` (the hybrid's
    floor or None), ``fingerprint``, ``root`` (the candidate filename
    stem), ``nsamples`` and ``sample_time``.  The fingerprint hashes the
    fields the JAX package hashes, with ``backend="torch"``: the two
    packages never share a ledger.  A ``quarantine_policy`` other than
    the default ``"sanitize"`` enters it (its ledger is not
    interchangeable with the default's on data the gate flags), and so
    does a ``mesh``'s shape, as in the JAX package.
    ``fingerprint_extra`` (a flat JSON-safe dict) is merged into it last,
    so another workload over the same file (the periodicity driver) keeps
    a ledger of its own; None leaves the fingerprint as it was.
    """
    if exact_floor is not True and exact_floor is not False \
            and exact_floor != "auto":
        raise ValueError(f"exact_floor={exact_floor!r}: expected True, "
                         "False or 'auto'")
    root = os.path.splitext(os.path.basename(str(fname)))[0]
    reader = FilterbankReader(fname)
    header = reader.header
    nsamples = header["nsamples"]
    plan = plan_chunks(nsamples, header["tsamp"], dmmin, dmmax,
                       header["fbottom"], header["ftop"], header["foff"],
                       chunk_length=chunk_length,
                       new_sample_time=new_sample_time)
    eff_tsamp = plan.sample_time
    t_eff = max(plan.step // plan.resample, 2)

    def plan_dms():
        return dedispersion_plan(header["nchans"], dmmin, dmmax,
                                 header["fbottom"], header["bandwidth"],
                                 eff_tsamp)

    def chunk_cert_floor():
        trial_dms = plan_dms()
        rho = retention_bound(header["nchans"], trial_dms, header["fbottom"],
                              header["bandwidth"], eff_tsamp, t_eff,
                              cert=True)
        return certifiable_snr_floor(t_eff, len(trial_dms), rho)

    if isinstance(snr_threshold, str):
        if snr_threshold == "auto":
            # never more permissive than the reference's snr > 6
            snr_threshold = max(matched_snr_floor(t_eff, len(plan_dms())),
                                6.0)
        elif snr_threshold == "certifiable":
            snr_threshold = chunk_cert_floor()
        else:
            raise ValueError(
                f"snr_threshold={snr_threshold!r}: expected a number, "
                "'auto' or 'certifiable'")
        snr_threshold = round(float(snr_threshold), 2)
        logger.info("snr_threshold resolved to %.2f for %d-sample chunks",
                    snr_threshold, t_eff)

    # below the certifiable floor the hybrid runs floorless (exact best
    # row only): a sub-certifiable floor would rescan toward a full exact
    # sweep on every chunk
    search_snr_floor = None
    if kernel == "hybrid" and exact_floor is not False:
        cert_floor = None if exact_floor is True else chunk_cert_floor()
        if exact_floor is True \
                or snr_threshold >= round(cert_floor, 2) - 1e-9:
            search_snr_floor = snr_threshold
        else:
            logger.info(
                "snr_threshold %.2f sits below the certifiable floor %.2f "
                "for this chunk geometry: hybrid runs without snr_floor "
                "(exact best row only)", snr_threshold, cert_floor)

    fingerprint = config_fingerprint(
        fname=os.path.abspath(str(fname)), dmmin=dmmin, dmmax=dmmax,
        step=plan.step, resample=plan.resample, backend="torch",
        kernel=kernel, snr_threshold=snr_threshold, fft_zap=fft_zap,
        cut_outliers=cut_outliers,
        **({"zero_dm": True} if zero_dm else {}),
        **({"mesh": list(mesh.shape.values())} if mesh is not None else {}),
        **({"quarantine_policy": str(quarantine_policy)}
           if quarantine_policy != "sanitize" else {}),
        surelybad=sorted(int(c) for c in surelybad),
        period_search=bool(period_search),
        period_sigma_threshold=float(period_sigma_threshold),
        **(fingerprint_extra or {}))
    return {
        "reader": reader, "plan": plan, "root": root,
        "nsamples": nsamples, "sample_time": header["tsamp"],
        "snr_threshold": snr_threshold,
        "search_snr_floor": search_snr_floor, "fingerprint": fingerprint,
        "chunk_starts": list(iter_chunk_starts(
            nsamples, plan, tmin=tmin, sample_time=header["tsamp"])),
    }


def clean_chunk(block, mask, *, cut_outliers=False, zero_dm=False,
                fft_zap=False, resample=1):
    """The conditioning of one ``(nchan, n)`` chunk, on its device."""
    with roofline.measure(block.device, "device_clean",
                          lambda: roofline.clean_work(*block.shape)):
        cleaned = renormalize_data(block, badchans_mask=mask,
                                   cut_outliers=cut_outliers)
        if zero_dm:
            cleaned = zero_dm_filter(cleaned, badchans_mask=mask)
        if fft_zap:
            cleaned, _ = fft_zap_time(cleaned)
        if resample > 1:
            cleaned = quick_resample(cleaned, resample)
    return cleaned


class _Stages:
    """The loop's stage clock, kept by the budget accountant ``timer``:
    :meth:`run` (and :meth:`bucket`) charge a call to a bucket and one
    span.  With ``sync`` (a caller asked for the seconds: ``stage_seconds``,
    ``budget`` or a trace) each stage also synchronises the current stream
    at its end, so that device work queued on the main stream is charged
    to the stage that queued it (side-stream uploads are not: they overlap
    by design); without it the buckets are host-side, as the JAX package's
    are.  :meth:`add` records seconds off the critical path (the reader
    thread, the persist worker)."""

    def __init__(self, device, timer, sync):
        self.device = device
        self.timer = timer
        self.sync = sync and device.type == "cuda"

    def add(self, name, seconds):
        self.timer.add_async(name, seconds)

    @contextlib.contextmanager
    def bucket(self, name):
        with self.timer.bucket(name):
            yield
            if self.sync:
                torch.cuda.current_stream(self.device).synchronize()

    def run(self, name, fn, *args, **kwargs):
        with self.bucket(name):
            return fn(*args, **kwargs)


def _search_with_fallback(array, dmmin, dmmax, start_freq, bandwidth,
                          eff_tsamp, *, device, kernel, capture_plane, state,
                          ndm, snr_floor=None, chunk=None, policy=None,
                          mesh=None):
    """One chunk's search with failure containment (the JAX package's
    policy, without its fallback from the card):

    - configuration errors (``ValueError``/``TypeError``) and kernel
      build, load or launch errors
      (:class:`~..utils.nvcc.KernelBuildError`) propagate at once: they
      would fail identically on every chunk;
    - another failure is retried (``policy.retries`` times, exponential
      ``policy.backoff_s`` between attempts).  With ``policy.timeout_s``
      every attempt runs on a watchdog thread
      (:func:`~..faults.policy.call_with_deadline`), so a wedged dispatch
      is bounded by ``timeout_s * (retries + 1)``.  On the card the last
      failure then propagates: nothing is searched elsewhere in its
      place.  On ``device="cpu"`` the chunk falls back to the host path
      (``kernel="auto"``), as the JAX package falls back to NumPy: loud
      (an error log, ``putpu_fallbacks_total``, ``state["fallback"]``,
      which the driver reports in its summary) and sticky
      (``state["host"]``: every later chunk runs there, one trial grid);
    - an out-of-memory error is not retried as a transient fault: while
      the direct sweep (``kernel="auto"``/``"pallas"``, ``ndm`` trials)
      has a smaller dispatch left, the OOM ladder (:mod:`..resilience.
      ladder`, counted under ``putpu_oom_*``) descends and the chunk is
      re-dispatched; the sweep descends itself on an OOM inside it, so
      this re-dispatch only follows one raised before the sweep.  The
      hybrid descends the ``unfuse`` rung once (its fused seed program
      gives way to the two-stage path) and is re-dispatched.  With
      nothing smaller left, the next rung is the host path on the CPU;
      an out-of-memory error there, or at the card's floor, raises
      :class:`~..resilience.ladder.OOMFloorError`, which the driver
      quarantines as ``oom_floor``.

    ``mesh`` routes the chunk through the sharded searches (the
    ``"mesh"`` fault site fires first): ``kernel="hybrid"`` ->
    :func:`~..parallel.sharded_fdmt.sharded_hybrid_search`, ``"fdmt"``
    -> :func:`~..parallel.sharded_fdmt.sharded_fdmt_search`, anything
    else the sharded direct sweep (``"pallas"`` and ``"gather"`` as
    named, ``"auto"`` otherwise), whose captured plane stays on the
    devices as a :class:`~..parallel.sharded_plane.ShardedPlane`.  The
    mesh has no smaller dispatch: an out-of-memory error unfuses the
    hybrid once, else it is the floor (the host path on a CPU mesh,
    ``oom_floor`` on the card); as everywhere, a card run never falls
    back to the CPU.
    """
    policy = policy if policy is not None else DispatchPolicy()
    where0 = "host" if state.get("host") else "device"
    kern0 = "auto" if where0 == "host" else kernel
    attempts = [(where0, kern0, False)] * (1 + max(int(policy.retries), 0))
    if where0 != "host" and device.type == "cpu":
        attempts.append(("host", "auto", False))
    nblocks = ladder_blocks(ndm)
    last = None

    def run_one(where, k):
        # the host path is the floor this ladder exists to reach: only
        # kind="oom" specs target its seam
        if where == "device":
            fault_inject.fire("dispatch", chunk=chunk, device=str(device))
        else:
            fault_inject.fire("host", chunk=chunk)
        if mesh is not None and where == "device":
            return _search_mesh(array, dmmin, dmmax, start_freq, bandwidth,
                                eff_tsamp, mesh=mesh, kernel=k,
                                capture_plane=capture_plane,
                                snr_floor=snr_floor, chunk=chunk)
        return dedispersion_search(
            array, dmmin, dmmax, start_freq, bandwidth, eff_tsamp, kernel=k,
            capture_plane=capture_plane,
            snr_floor=snr_floor if k == "hybrid" else None, device=device)

    i = 0
    while i < len(attempts):
        where, k, oom_retry = attempts[i]
        try:
            # no watchdog on the host floor: a deadline there would be one
            # more way for the last resort to fail
            timeout = policy.timeout_s if where == "device" else None
            retry = bool(i and (where, k) == (where0, kern0)
                         and not oom_retry)
            if retry:
                obs_metrics.counter("putpu_dispatch_retries_total").inc()
                if policy.backoff_s:
                    time.sleep(policy.backoff_s * (2 ** (i - 1)))
            # a same-device retry is counted and traced as one; the host
            # fallback and an OOM ladder re-dispatch are neither
            with (trace_span("dispatch_retry", chunk=chunk, attempt=i,
                             device=where) if retry
                  else contextlib.nullcontext()):
                result = call_with_deadline(lambda: run_one(where, k),
                                            timeout)
            if (where, k) != (where0, kern0):
                logger.error(
                    "chunk %s: the search failed on kernel=%s (%r); this "
                    "chunk and the rest of the run are searched on the "
                    "host path (kernel=auto)", chunk, kernel, last)
                obs_metrics.counter("putpu_fallbacks_total",
                                    stage="search").inc()
                state["host"] = True
                state["fallback"] = {"stage": "search", "device": "cpu",
                                     "kernel": "auto", "chunk": chunk,
                                     "from_device": str(device),
                                     "from_kernel": kernel}
            return result
        except (ValueError, TypeError, KernelBuildError):
            raise
        except _ladder.OOMFloorError:
            raise
        except Exception as exc:  # device errors share no base class
            last = exc
            if _ladder.is_resource_exhausted(exc):
                _ladder.oom_event("chunk_search")
                step = None
                if where == "device" and k in ("auto", "pallas") \
                        and mesh is None \
                        and not _ladder.direct_maxed("pallas", nblocks):
                    step = "split_dm"
                elif where == "device" and k == "hybrid" \
                        and not _ladder.unfuse_engaged():
                    step = "unfuse"   # the two-stage path from now on
                if step is not None:
                    _ladder.descend(step)
                    attempts.insert(i + 1, (where, k, True))
                    logger.warning(
                        "chunk %s search ran out of memory on %s "
                        "kernel=%s (%r); ladder step %s, re-dispatching "
                        "smaller", chunk, device, k, exc, step)
                    i += 1
                    continue
                if attempts[-1][0] == where:
                    raise _ladder.OOMFloorError(
                        f"chunk {chunk}: out of memory with no smaller "
                        f"dispatch left on {device} kernel={k} ({exc!r}); "
                        "quarantining the chunk as oom_floor") from exc
                # nothing smaller on this rung: straight to the host path
                i = len(attempts) - 1
                continue
            if i + 1 < len(attempts):
                nxt = attempts[i + 1]
                logger.warning("chunk %s search failed on the %s (%r); "
                               "retrying on the %s with kernel=%s", chunk,
                               where, exc, nxt[0], nxt[1])
            i += 1
    raise last


def _search_mesh(array, dmmin, dmmax, start_freq, bandwidth, eff_tsamp, *,
                 mesh, kernel, capture_plane, snr_floor, chunk):
    """One chunk's search on ``mesh`` (:func:`_search_with_fallback`'s
    mesh route, after the ``"mesh"`` fault site)."""
    from ..parallel.sharded import MESH_KERNELS, sharded_dedispersion_search
    from ..parallel.sharded_fdmt import (sharded_fdmt_search,
                                         sharded_hybrid_search)

    fault_inject.fire("mesh", chunk=chunk)
    if kernel == "hybrid":
        return sharded_hybrid_search(
            array, dmmin, dmmax, start_freq, bandwidth, eff_tsamp, mesh=mesh,
            snr_floor=snr_floor, capture_plane=capture_plane)
    if kernel == "fdmt":
        return sharded_fdmt_search(
            array, dmmin, dmmax, start_freq, bandwidth, eff_tsamp, mesh=mesh,
            capture_plane=capture_plane)
    return sharded_dedispersion_search(
        array, dmmin, dmmax, start_freq, bandwidth, eff_tsamp, mesh=mesh,
        capture_plane=capture_plane, plane_handle=True,
        kernel=kernel if kernel in MESH_KERNELS else "auto")


class _ReadFailure:
    """The reader thread's sentinel: the chunk's read failed after its
    retries.  The loop quarantines that chunk (``read_error``) instead of
    the run dying on one bad disk region."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class _HostChunk:
    """A chunk read by the reader thread: its raw frames in staging
    ``slot`` (``nread`` samples) and the ``canary`` bump to add once they
    are on the device, or, for a chunk a ``corrupt`` fault matched, the
    corrupted (and injected) host float ``block`` (ascending) and its
    ``gate`` verdict."""

    __slots__ = ("slot", "nread", "block", "gate", "canary")

    def __init__(self, slot=None, nread=0, block=None, gate=None,
                 canary=None):
        self.slot = slot
        self.nread = nread
        self.block = block
        self.gate = gate
        self.canary = canary


def search_by_chunks(fname, chunk_length=None, new_sample_time=None, tmin=0,
                     dmmin=200, dmmax=800, surelybad=(), *, kernel="auto",
                     snr_threshold=6.0, output_dir=None, make_plots="hits",
                     resume=True, fft_zap=False, cut_outliers=False,
                     zero_dm=False, max_chunks=None, period_search=False,
                     period_sigma_threshold=8.0, show_plots=False,
                     exact_floor="auto", overlap_persist=True, budget=None,
                     dispatch_timeout=None, dispatch_retries=1,
                     dispatch_backoff=0.0, quarantine_policy="sanitize",
                     persist_retries=2, persist_backoff=0.05,
                     http_port=None, http_host="127.0.0.1", canary=None,
                     health=None, report_out=None, chunks=None,
                     cancel_cb=None, plane_consumer=None,
                     fingerprint_extra=None, fence=None, lineage=None,
                     push=None, device="cuda", stage_seconds=None, summary=None,
                     progress=True, mesh=None):
    """Search a filterbank file for dispersed single pulses.

    Parameters follow the JAX package's driver (``snr_threshold`` and
    ``exact_floor`` as :func:`plan_survey` resolves them); ``device`` is
    where the chunks are cleaned and searched (``"cuda"`` by default,
    raising without a card; ``"cpu"`` on request).  ``max_chunks`` stops
    after that many chunks (the rest stay un-marked for a resumed run);
    ``chunks``, a list of chunk starts, searches only those (starts not
    in the plan are ignored).  ``cancel_cb``, a zero-arg callable, is
    checked before each chunk: once it returns True nothing further
    starts (the chunk in flight and its persist drain complete, the rest
    stay un-marked for a resumed session), as in the JAX package; the job
    service's cancel reaches the loop here.

    ``make_plots``: ``"hits"`` (the default) renders the diagnostic
    figure (:mod:`.diagnostics`) of every hit to
    ``<output_dir>/<root>_<istart>-<iend>.jpg``, ``"all"`` of every
    searched chunk, ``False`` none; the figure is written before the
    chunk's persist task is submitted, so the ledger never marks a chunk
    whose figure is missing.  Without matplotlib (an optional extra) the
    JAX package's warning is logged and plots are off.  ``show_plots``
    also opens each figure in an interactive window.  Plots capture the
    chunk's plane, as ``period_search`` and ``plane_consumer`` do; a
    hit's retained and persisted waterfall is the pulse cutout either
    way.

    ``period_search=True`` adds the folded period search of every
    chunk's plane (:func:`..ops.periodicity.period_search_plane`); a
    chunk whose refined significance exceeds ``period_sigma_threshold``
    is a hit even below ``snr_threshold`` and carries the ``period_*``
    fields and ``fold_profile``.  ``plane_consumer``, a ``fn(istart,
    plane, table)`` callable, receives every searched chunk's plane
    before the chunk is marked done (a crash in between re-delivers the
    chunk on resume; consumers de-duplicate by ``istart``).
    ``fingerprint_extra`` goes to :func:`plan_survey`.  ``fence``, a fleet
    lease's epoch, goes to the :class:`~..io.candidates.CandidateStore`:
    a candidate write is refused where a session of a higher epoch (the
    lease's new owner) already wrote; ``None`` touches no fence file.

    The loop's knobs, with the JAX package's names and defaults; on
    clean input the defaults give the serial loop's hits, candidates and
    ledger bytes:

    * ``overlap_persist`` moves each chunk's candidate persist and ledger
      write onto a FIFO worker that overlaps the next chunk's search (at
      most two tasks in flight); ``False`` persists inline;
    * ``dispatch_timeout`` (seconds, default off) bounds each search
      attempt on a watchdog thread; ``dispatch_retries`` and
      ``dispatch_backoff`` shape the retries, after which the error
      propagates on the card, and a ``device="cpu"`` run falls back,
      loudly, to the host path (:func:`_search_with_fallback`; a kernel
      build, load or launch error is never retried).  An abandoned
      attempt keeps running on the card until it ends
      (:func:`~..faults.policy.join_abandoned`);
    * ``quarantine_policy`` (``"sanitize"``, ``"strict"`` or ``"off"``)
      arms the integrity gate (:mod:`..faults.policy`), on the card
      after the upload (on the reader thread for a chunk a ``corrupt``
      fault matched): chunks whose non-finite, dead-channel, zero or
      saturation fractions breach the policy are quarantined —
      recorded in ``quarantine_<fingerprint>.jsonl`` and marked done
      with the reason — and sub-threshold non-finite values are
      imputed under ``"sanitize"``.  Unreadable (after three reads with
      backoff) and short chunks are quarantined the same way;
    * ``persist_retries`` / ``persist_backoff``: a failed candidate write
      (``OSError``) is retried with exponential backoff, then
      dead-lettered (manifest and ledger) and the run continues.

    Accounting and observability, as in the JAX package: the accountant
    always runs; the rest is off unless asked for, and off leaves the
    output directory unchanged:

    * ``budget``, a caller-owned
      :class:`~..utils.logging_utils.BudgetAccountant` (one is made
      otherwise): every chunk's wall in named buckets with the residual
      ``unattributed``, the footer and one ``BUDGET_JSON`` log line; a
      CUDA run prices its trips with :func:`~..utils.logging_utils.
      measure_device_rtt`;
    * ``http_port`` serves ``/metrics``, ``/healthz`` (HTTP 503 on
      CRITICAL), ``/progress`` (also ``/status``) while the loop runs
      (:mod:`..obs.server`; ``0`` binds an ephemeral port, ``http_host``
      the address); ``health``, a caller-owned
      :class:`~..obs.health.HealthEngine` (made when ``http_port`` is set
      and none is given), gets one update a chunk;
    * ``canary``, a :class:`~..obs.canary.CanaryController` or a rate:
      a known dispersed pulse injected into that share of the chunks and
      matched against the tables (recall, S/N ratio, DM error); canary
      rows are masked out of the science table, a genuine weaker pulse
      under a canary is promoted, and the candidates and ledger are
      those of the canary-off run;
    * ``lineage=True`` (or a :class:`~..obs.lineage.LineageRecorder`)
      writes ``<candidate>.lineage.json`` beside each candidate pair;
      ``push``, an :class:`~..obs.push.AlertBroker` or a list of
      subscriber specs, posts each hit to webhooks from a bounded queue;
    * ``report_out`` writes the survey report (``.md``, ``.html``,
      ``.json``, :mod:`..obs.report`); a failed report is logged, never
      fatal.

    Every resumable run ends with :func:`~..faults.audit.audit_run`
    (logged, never fatal).  ``progress`` logs a line every
    :data:`PROGRESS_EVERY` chunks searched, as the JAX package does.

    A 1, 2 or 4-bit file: one IF is staged as its packed bytes (the
    page-locked buffers hold ``(step, bytes_per_frame)`` uint8), the
    canary's bump quantised into them and the chunk gated in the code
    domain on the reader thread (:func:`~..faults.policy.
    gate_chunk_packed`), the unpack on the card charged to ``clean``;
    ``putpu_lowbit_packed_chunks_total`` and
    ``putpu_lowbit_bytes_saved_total`` count as in the JAX package.  A
    failed unpack raises: nothing decodes the chunk on the host instead.
    Several IFs are decoded on the host and gated by
    :func:`~..faults.policy.gate_chunk_lowbit`.

    ``stage_seconds``, a dict, receives the accountant's seconds of each
    stage on the main thread (``badchans``; ``read``, the wait for the
    reader; ``upload_wait``; ``gate``; ``clean``; ``search``;
    ``plane_consume``; ``period``; ``hit_products``; ``plot``;
    ``persist`` when inline; ``persist_backpressure``;
    ``persist_drain``) and off it (``read_decode`` on the reader thread;
    ``persist`` on the worker when overlapped).  ``summary``, a dict,
    receives ``snr_threshold`` (resolved), ``snr_floor`` (the hybrid's,
    or None), ``searched``, ``certified`` (the chunks the hybrid's noise
    certificate cleared), ``quarantined`` (chunks this session marked
    done with a reason), ``fallback`` (None, or, on ``device="cpu"``,
    where the run fell back to and at which chunk) and ``oom_descents``.

    ``mesh`` (a :class:`~..parallel.mesh.Mesh` on ``device``'s kind of
    device) searches every chunk with the sharded searches
    (:func:`_search_with_fallback`); one process drives the mesh, so the
    reader thread, the persist worker and the ledger are the
    single-device loop's.  The mesh's shape enters the fingerprint and
    the ``BUDGET_JSON`` record.  A captured plane stays on the devices,
    dm-sharded: the period search and the figure read shard-local
    products of it (:mod:`..parallel.sharded_plane`).  A mesh without
    the axes its kernel needs raises before any file is read (``"dm"``
    for ``kernel="fdmt"``, ``"dm"`` and ``"chan"`` otherwise).

    Returns ``(hits, store)``: ``hits`` is a list of ``(istart, iend,
    PulseInfo, ResultTable)`` — with ``resume``, including hits persisted
    by earlier sessions of the same configuration.
    """
    if mesh is not None:
        # fail fast: a missing axis would otherwise surface inside the
        # first chunk's search, where it reads as a device fault
        needed = {"dm"} if kernel == "fdmt" else {"dm", "chan"}
        if not needed <= set(mesh.shape):
            raise ValueError(
                f"mesh axes {tuple(mesh.shape)} must include "
                f"{sorted(needed)} for kernel={kernel!r} (build one with "
                "make_mesh((d, c), ('dm', 'chan')))")
        if torch.device(mesh.home).type != torch.device(device).type:
            raise ValueError(f"mesh devices {mesh!r} are not of "
                             f"device={str(device)!r}")
    integrity = resolve_integrity_policy(quarantine_policy)
    dispatch_policy = DispatchPolicy(timeout_s=dispatch_timeout,
                                     retries=dispatch_retries,
                                     backoff_s=dispatch_backoff)
    # a bare number is the canary's rate; rate 0 is "off"
    if canary is not None and not isinstance(canary, CanaryController):
        canary = CanaryController(rate=float(canary))
    if canary is not None and canary.rate <= 0.0:
        canary = None
    dev = resolve_device(device)
    output_dir = output_dir or os.path.dirname(os.path.abspath(str(fname)))
    if make_plots:
        try:
            import matplotlib  # noqa: F401 — the optional plot extra
        except ImportError:
            logger.warning("matplotlib not installed: diagnostic plots "
                           "disabled (install the [plot] extra)")
            make_plots = False
    timer = budget if budget is not None else BudgetAccountant()
    timer.begin_stream()
    timer.mesh_shape = (list(mesh.shape.values()) if mesh is not None
                        else None)
    stages = _Stages(dev, timer, sync=(stage_seconds is not None
                                       or budget is not None
                                       or is_tracing()))
    base_seconds = timer.stage_seconds()
    _ladder.reset()
    # the pre-scan reads the file through the loop's read seam before the
    # loop exists: an armed read fault is for the search chunks
    with fault_inject.suppressed():
        mask_fileorder = stages.run("badchans", get_bad_chans, fname,
                                    surelybad=surelybad)
    sp = plan_survey(fname, chunk_length=chunk_length,
                     new_sample_time=new_sample_time, tmin=tmin,
                     dmmin=dmmin, dmmax=dmmax, surelybad=surelybad,
                     kernel=kernel, snr_threshold=snr_threshold,
                     fft_zap=fft_zap, cut_outliers=cut_outliers,
                     zero_dm=zero_dm, exact_floor=exact_floor,
                     period_search=period_search,
                     period_sigma_threshold=period_sigma_threshold,
                     fingerprint_extra=fingerprint_extra,
                     quarantine_policy=quarantine_policy, mesh=mesh)
    reader = sp["reader"]
    snr_threshold = sp["snr_threshold"]
    root = sp["root"]
    header = reader.header
    nsamples = sp["nsamples"]
    sample_time = sp["sample_time"]
    start_freq = header["fbottom"]
    bandwidth = header["bandwidth"]
    plan = sp["plan"]
    eff_tsamp = plan.sample_time
    mask = mask_fileorder[::-1] if reader.band_descending else mask_fileorder
    mask = torch.as_tensor(mask.copy()).to(dev)
    ndm = len(dedispersion_plan(header["nchans"], dmmin, dmmax, start_freq,
                                bandwidth, eff_tsamp))
    fingerprint = sp["fingerprint"] if resume else None
    store = CandidateStore(output_dir, fingerprint, fence=fence)
    manifest = QuarantineManifest(output_dir, fingerprint)
    capture = (bool(make_plots) or bool(period_search)
               or plane_consumer is not None)
    clean_kw = dict(cut_outliers=cut_outliers, zero_dm=zero_dm,
                    fft_zap=fft_zap, resample=plan.resample)

    if lineage is True:
        lineage = LineageRecorder(fingerprint=sp["fingerprint"],
                                  source="search_by_chunks")
    elif not lineage:
        lineage = None          # False/0/"" are "off" (the CLI's flag)
    push_owned = False
    if not push:
        push = None
    elif not isinstance(push, AlertBroker):
        push = AlertBroker(
            push, health=health,
            dead_letter_path=os.path.join(
                output_dir, f"push_dead_letter_{sp['fingerprint']}.jsonl"))
        push_owned = True
    if canary is not None:
        canary.bind(nchan=header["nchans"], start_freq=start_freq,
                    bandwidth=bandwidth, tsamp=sample_time, dmmin=dmmin,
                    dmmax=dmmax, resample=plan.resample)
    if dev.type == "cuda" and timer.rtt_s is None:
        timer.rtt_s = measure_device_rtt(device=dev)
        logger.info("device round-trip floor: %.6fs per launch and "
                    "synchronize", timer.rtt_s)

    todo = [s for s in sp["chunk_starts"]
            if not (resume and store.is_done(s))]
    if chunks is not None:
        wanted = {int(c) for c in chunks}
        todo = [s for s in todo if s in wanted]
    if max_chunks is not None:
        todo = todo[:max_chunks]

    hits = []
    nproc = 0
    ncertified = 0
    quarantined = []
    state = {}  # the sticky fallback of a CPU run: "host", "fallback"
    staging = (FrameStaging((plan.step, reader.frame_width),
                            reader.frame_dtype, dev) if todo else None)

    # -- the live surface: health engine, ETA, HTTP endpoints -------------
    if http_port is not None and health is None:
        health = HealthEngine()
    t_run0 = time.time()
    eta_model = EwmaThroughput()

    def progress_snapshot():
        """The ``/progress`` document (read from the scrape thread)."""
        done, total = nproc, len(todo)
        elapsed = time.time() - t_run0
        eta = eta_model.eta_s(max(total - done, 0))
        if eta is None and done and elapsed > 0:
            eta = (total - done) * elapsed / done
        doc = {"fname": os.path.basename(str(fname)),
               "chunks_done": done, "chunks_total": total,
               "elapsed_s": round(elapsed, 1),
               "eta_s": None if eta is None else round(eta, 1),
               "hits": len(hits), "certified": ncertified,
               "quarantined": len(store.quarantined_chunks)}
        if canary is not None:
            doc["canary"] = canary.summary()
        return doc

    # health reads per-chunk deltas of the process-wide counters
    health_counters = (("dead", "putpu_persist_dead_letter_total"),
                       ("retry", "putpu_dispatch_retries_total"),
                       ("retrace", "putpu_retraces_total"))

    def oom_events_total():
        return sum(m.get("value", 0)
                   for m in obs_metrics.REGISTRY.snapshot()
                   if m.get("name") == "putpu_oom_events_total")

    health_base = {}
    if health is not None:
        for key, name in health_counters:
            health_base[key] = obs_metrics.counter(name).value
        health_base["oom"] = oom_events_total()

    def health_update(istart_, wall_s, candidates=None,
                      is_quarantined=False, headroom_frac=None,
                      oom_floor=False):
        # every completion lands here; the tail flush (wall_s None)
        # completed nothing
        if wall_s is not None:
            eta_model.note(1, wall_s)
        if health is None:
            return
        deltas = {}
        for key, name in health_counters:
            v = obs_metrics.counter(name).value
            deltas[key] = v - health_base[key]
            health_base[key] = v
        oom_now = oom_events_total()
        oom_delta, health_base["oom"] = oom_now - health_base["oom"], oom_now
        health.update(
            istart_, wall_s=wall_s, candidates=candidates,
            quarantined=is_quarantined, dead_letter=deltas["dead"] > 0,
            dispatch_retries=deltas["retry"], retraces=deltas["retrace"],
            headroom_frac=headroom_frac, oom_events=oom_delta,
            oom_floor=oom_floor, fallback=state.get("fallback") is not None,
            canary=canary.summary() if canary is not None else None)

    def chunk_size(s):
        return min(plan.step, nsamples - s)

    # one IF of 8-bit samples: the gate reads the frames as stored (a
    # quarter of the float block's bytes) before they are converted; a
    # chunk the canary lights is gated as a float block after the bump,
    # as the JAX package gates its injected block
    gate_bytes = (integrity is not None and reader.nifs == 1
                  and reader.frame_dtype.itemsize == 1 and not reader.packed)
    # one IF of 1/2/4-bit samples: the packed bytes cross to the device
    # (nbits / 32 of the float block's) and are unpacked there; the packed
    # canary and the code-domain gate run on the reader thread.  Several
    # IFs of them are decoded on the host and gated in the code domain.
    packed_bits = reader.nbits if reader.packed and reader.nifs == 1 else 0
    host_decoded = reader.packed and reader.nifs > 1

    def read_at(s, view, slot):
        """Read one chunk on the reader thread: its frames into ``view``
        (and the canary's bump, built from them), or, when a ``corrupt``
        fault matches it, the host float block the JAX package's reader
        reads, corrupted, injected and gated here.  An ``OSError`` is
        retried twice with backoff (counted); a third returns a
        :class:`_ReadFailure`.  A bad sector under the memory map raises
        SIGBUS, which nothing here can catch.  No CUDA call.

        A packed chunk (one IF of 1/2/4-bit samples) is read as its packed
        bytes, the canary's bump is quantised into them in ``view``
        (:meth:`~..obs.canary.CanaryController.maybe_inject_packed`) and
        the chunk gated in the code domain (:func:`~..faults.policy.
        gate_chunk_packed`), in that order; no corrupt fault applies to
        it, as in the JAX package.  A multi-IF low-bit chunk is decoded on
        the host and gated by :func:`~..faults.policy.gate_chunk_lowbit`.
        """
        t0 = time.perf_counter()
        if lineage is not None:
            lineage.mark(s, "read")
        try:
            for attempt in range(3):
                try:
                    if host_decoded or (
                            not packed_bits
                            and fault_inject.wants_corrupt("corrupt", s)):
                        block = reader.read_block(s, chunk_size(s),
                                                  band_ascending=True)
                        break
                    got = _HostChunk(slot=slot, nread=reader.
                                     read_frames_into(s, chunk_size(s),
                                                      view))
                    if packed_bits:
                        read_packed(s, view[:got.nread], got)
                    elif canary is not None and got.nread:
                        stride = max(1, got.nread // 65536)
                        got.canary = canary.injection(
                            s, got.nread,
                            reader.host_samples(view[:got.nread:stride]))
                    return got
                except OSError as exc:
                    if attempt == 2:
                        logger.error("chunk %d read failed after %d "
                                     "attempts (%r)", s, attempt + 1, exc)
                        return _ReadFailure(exc)
                    obs_metrics.counter("putpu_read_retries_total").inc()
                    logger.warning("chunk %d read error (%r); retrying", s,
                                   exc)
                    time.sleep(0.1 * (2 ** attempt))
            block = fault_inject.corrupt("corrupt", block, chunk=s)
            if canary is not None:
                # after the fault: the canary rides the values the search
                # will see
                block = canary.maybe_inject(block, s)
            gate = None
            if integrity is not None and reader.packed:
                block, gate = gate_chunk_lowbit(np.asarray(block),
                                                reader.nbits, integrity)
            elif integrity is not None:
                block, gate = gate_chunk(np.asarray(block), integrity)
            return _HostChunk(nread=block.shape[1], block=block, gate=gate)
        finally:
            stages.add("read_decode", time.perf_counter() - t0)

    def read_packed(s, frames, got):
        """The reader thread's work on packed ``frames`` (the staging
        view's rows): the canary's bump, re-packed in place, then the
        code-domain gate (``got.gate``)."""
        if not got.nread:
            return
        if canary is not None:
            bumped = canary.maybe_inject_packed(
                frames, s, nbits=packed_bits, nchan=header["nchans"],
                band_descending=reader.band_descending)
            if bumped is not frames:
                frames[...] = bumped
        if integrity is not None:
            _, got.gate = gate_chunk_packed(frames, packed_bits,
                                            header["nchans"], integrity)

    def submit_read(index):
        if index >= len(todo):
            return None
        slot = index % 2
        view = staging.acquire(slot)
        return reader_pool.submit(read_at, todo[index], view, slot)

    def upload(got):
        obs_metrics.counter("putpu_bytes_uploaded_total").inc(
            int(got.nread * staging.views[got.slot][0].nbytes))
        return staging.upload(got.slot, got.nread)

    def prefetch_upload(index, future):
        """Start chunk ``todo[index]``'s upload on the side stream (main
        thread) if its read is done and the run is on the card; otherwise
        the main path uploads it when its turn comes."""
        if future is None or not future.done() or dev.type != "cuda":
            return None
        got = future.result()
        if not isinstance(got, _HostChunk) or got.block is not None \
                or got.nread < chunk_size(todo[index]) \
                or (got.gate is not None and got.gate["verdict"] != "clean"):
            return None
        timer.count("prefetch_uploads")
        return todo[index], upload(got)

    def condition(got, prefetched, istart):
        """``(array, gate_info)``: the chunk gated and cleaned on its
        device, in ascending band order; ``array`` is None when the gate
        quarantines it.  The frames' upload (prefetched or started now)
        is waited for under ``upload_wait``, their conversion to float
        and the canary's bump are charged to ``clean``, as is a packed
        chunk's unpack.  A chunk a corrupt fault matched (or a multi-IF
        low-bit chunk) arrives as a host float block gated on the reader
        thread, a packed chunk gated there.  A chunk the reader thread's
        gate quarantined is not uploaded."""
        gate_info = got.gate
        if gate_info is not None and gate_info["verdict"] == "quarantine":
            return None, gate_info
        if got.block is not None:
            host = np.ascontiguousarray(got.block, dtype=np.float32)
            obs_metrics.counter("putpu_bytes_uploaded_total").inc(
                int(host.nbytes))
            block = stages.run("upload_wait",
                               lambda: torch.from_numpy(host).to(dev))
        else:
            pending = (prefetched[1] if prefetched is not None
                       and prefetched[0] == istart else upload(got))
            if packed_bits:
                # the JAX package's counts of the packed path: the bytes
                # saved are those of the float32 block less the packed
                obs_metrics.counter("putpu_lowbit_packed_chunks_total").inc()
                obs_metrics.counter("putpu_lowbit_bytes_saved_total").inc(
                    int(header["nchans"] * got.nread * 4
                        - got.nread * reader.bytes_per_frame))
            frames = stages.run("upload_wait", staging.wait, pending)
            by_bytes = gate_bytes and got.canary is None
            if by_bytes:
                gate_info = stages.run("gate", gate_frames, frames,
                                       integrity)
                if gate_info["verdict"] == "quarantine":
                    return None, gate_info
            block = stages.run("clean", reader.block_from_frames, frames)
            del frames
            if got.canary is not None:
                block = stages.run("clean", inject_tensor, block, got.canary)
            if integrity is not None and not by_bytes and not packed_bits:
                block, gate_info = stages.run("gate", gate_tensor, block,
                                              integrity)
        if gate_info is not None and gate_info["verdict"] == "quarantine":
            return None, gate_info
        timer.count("dispatches")
        return (stages.run("clean", clean_chunk, block, mask, **clean_kw),
                gate_info)

    def _persist_and_mark(payload, istart_, iend_, reason=None):
        """Save a hit (``payload`` not None), then mark the chunk done; a
        crash between the two re-searches the chunk.  A failed save
        (``OSError``) is retried ``persist_retries`` times with backoff,
        then dead-lettered (manifest and ledger) and the run continues;
        anything else propagates."""
        if payload is not None:
            for attempt in range(max(int(persist_retries), 0) + 1):
                try:
                    store.save_candidate(root, istart_, iend_, *payload)
                    break
                except OSError as exc:
                    if attempt < persist_retries:
                        obs_metrics.counter(
                            "putpu_persist_retries_total").inc()
                        logger.warning(
                            "persist of chunk %d-%d failed (%r); retry "
                            "%d/%d", istart_, iend_, exc, attempt + 1,
                            persist_retries)
                        time.sleep(persist_backoff * (2 ** attempt))
                    else:
                        obs_metrics.counter(
                            "putpu_persist_dead_letter_total").inc()
                        logger.error(
                            "persist of chunk %d-%d failed %d times (%r): "
                            "dead-letter recorded, run continues", istart_,
                            iend_, attempt + 1, exc)
                        manifest.record(istart_, iend_,
                                        fault_reasons.PERSIST_DEAD_LETTER,
                                        {"error": repr(exc)})
                        reason = fault_reasons.PERSIST_DEAD_LETTER
        store.mark_done(istart_, reason=reason)
        if reason is not None:
            quarantined.append(istart_)
        return reason

    def lineage_finish(cl, istart_, iend_, payload, reason_out):
        """Stamp persist-complete on a hit's lineage and write its doc
        beside the npz pair; a dead-lettered persist has no pair to sit
        beside, but its candidate span still ends."""
        if cl is None:
            return
        if payload is not None and reason_out is None:
            try:
                lineage.persisted(
                    cl, writer=lambda doc, a=istart_, b=iend_:
                    store.save_lineage(root, a, b, doc))
            except OSError as exc:
                logger.warning("lineage doc for chunk %d-%d failed (%r); "
                               "candidate unaffected", istart_, iend_, exc)
                cl.span.end()
        else:
            cl.span.end()

    def _persist_async(payload, istart_, iend_, pspan=None, reason=None,
                       cl=None):
        t0 = time.perf_counter()
        try:
            out = _persist_and_mark(payload, istart_, iend_, reason=reason)
            lineage_finish(cl, istart_, iend_, payload, out)
        finally:
            stages.add("persist", time.perf_counter() - t0)
            if pspan is not None:
                pspan.end()

    persist_pool = (ThreadPoolExecutor(max_workers=1) if overlap_persist
                    else None)
    persist_futures = []

    def persist(payload, istart_, iend_, reason=None, cl=None):
        if persist_pool is None:
            with stages.bucket("persist"):
                out = _persist_and_mark(payload, istart_, iend_,
                                        reason=reason)
                lineage_finish(cl, istart_, iend_, payload, out)
            return
        # the searched chunk's persist, ended on the worker: the trace
        # shows the overlap the serial budget leaves out
        # putpu-lint: disable=span-leak — ends in the persist worker (cross-thread; the drain barrier guarantees completion)
        pspan = (begin_span("persist", track="persist-worker",
                            chunk=istart_) if reason is None else None)
        persist_futures.append(persist_pool.submit(
            _persist_async, payload, istart_, iend_, pspan, reason, cl))
        # backpressure: each queued payload holds its cutout and table on
        # the host; two in flight keep the overlap and bound the memory
        while len(persist_futures) > 2:
            stages.run("persist_backpressure", persist_futures.pop(0).result)

    def drain_persist(block=False):
        # a persist failure the retry policy does not absorb (a bug, not a
        # disk hiccup) fails the run at the next drain
        while persist_futures and (block or persist_futures[0].done()):
            persist_futures.pop(0).result()

    def quarantine(istart_, iend_, reason, stats, t_chunk, oom_floor=False):
        obs_metrics.counter("putpu_chunks_quarantined_total").inc()
        logger.error("chunk %d-%d QUARANTINED (%s): %s -> %s", istart_,
                     iend_, reason, stats, manifest.path)
        manifest.record(istart_, iend_, reason, stats)
        persist(None, istart_, iend_, reason=reason)
        if canary is not None:
            # the chunk never reached the search: its injection is no miss
            canary.discard(istart_)
        if lineage is not None:
            lineage.discard(istart_)
        health_update(istart_, time.perf_counter() - t_chunk,
                      is_quarantined=True, oom_floor=oom_floor)

    obs_server = None
    if http_port is not None:
        obs_server = start_obs_server(http_port, health=health,
                                      progress_fn=progress_snapshot,
                                      host=http_host, push=push)
    reader_pool = ThreadPoolExecutor(max_workers=1)
    prefetched = None  # (istart, Upload) of a chunk uploaded ahead
    try:
        next_read = submit_read(0)
        for ichunk, istart in enumerate(todo):
          if cancel_cb is not None and cancel_cb():
              # graceful drain: finished chunks are persisted and marked,
              # the rest stay un-marked for the next session
              logger.info("search cancelled before chunk %d: %d of %d "
                          "chunks left for a resumed session", istart,
                          len(todo) - ichunk, len(todo))
              break
          with timer.chunk(istart):
            t_chunk = time.perf_counter()
            iend = istart + chunk_size(istart)
            t0 = istart * sample_time
            got = stages.run("read", next_read.result)
            next_read = submit_read(ichunk + 1)

            reason = stats = None
            if isinstance(got, _ReadFailure):
                reason = fault_reasons.READ_ERROR
                stats = {"error": repr(got.exc)}
            elif got.nread < chunk_size(istart):
                reason = fault_reasons.SHORT_READ
                stats = {"expected": int(chunk_size(istart)),
                         "got": int(got.nread)}
            if reason is not None:
                nproc += 1
                quarantine(istart, iend, reason, stats, t_chunk)
                prefetched = None
                drain_persist()
                continue

            array, gate_info = condition(got, prefetched, istart)
            prefetched = None
            if gate_info is not None:
                if gate_info["verdict"] == "quarantine":
                    nproc += 1
                    quarantine(istart, iend, fault_reasons.INTEGRITY_PREFIX
                               + ",".join(gate_info["reasons"]),
                               gate_info["stats"], t_chunk)
                    drain_persist()
                    continue
                if gate_info["verdict"] == "sanitized":
                    obs_metrics.counter("putpu_chunks_sanitized_total").inc()
                    logger.warning("chunk %d-%d sanitized (non-finite "
                                   "values imputed): %s", istart, iend,
                                   gate_info["stats"])
            # start chunk k+1's upload before chunk k's search
            prefetched = prefetch_upload(ichunk + 1, next_read)
            if lineage is not None:
                lineage.mark(istart, "dispatch")
            try:
                result = stages.run(
                    "search", _search_with_fallback, array, dmmin, dmmax,
                    start_freq, bandwidth, eff_tsamp, device=dev,
                    kernel=kernel, capture_plane=capture, state=state,
                    ndm=ndm, snr_floor=sp["search_snr_floor"], chunk=istart,
                    policy=dispatch_policy, mesh=mesh)
            except _ladder.OOMFloorError as exc:
                obs_metrics.counter("putpu_oom_floor_total").inc()
                nproc += 1
                quarantine(istart, iend, fault_reasons.OOM_FLOOR,
                           {"error": repr(exc)}, t_chunk, oom_floor=True)
                drain_persist()
                continue
            table, plane = result if capture else (result, None)
            if lineage is not None:
                lineage.mark(istart, "ready")
            if plane_consumer is not None:
                stages.run("plane_consume", plane_consumer, istart, plane,
                           table)

            canary_obs = (canary.observe(istart, table, snr_threshold)
                          if canary is not None else None)
            ncand_above = None
            if health is not None:
                # the candidate rate (rows above the threshold), less the
                # rows a canary lit
                ncand_above = int(np.count_nonzero(
                    np.asarray(table["snr"], dtype=np.float64)
                    > float(snr_threshold)))
                if canary_obs is not None:
                    ncand_above = max(
                        ncand_above - canary_obs["n_above_near"], 0)

            # what persist, sift and lineage see, and the plane row of the
            # dedispersed profile: they move only when a canary tops the
            # chunk and a genuine weaker pulse is promoted in its place
            is_hit, sci_table, best, best_plane_idx = science_hit(
                canary, canary_obs, istart, table, snr_threshold,
                f"chunk {istart}-{iend}")
            if table.meta.get("certified"):
                # the noise certificate: no detection above the floor, no
                # exact rescore paid (is_hit is False by construction)
                ncertified += 1
                obs_metrics.counter("putpu_certified_chunks_total").inc()
            info = PulseInfo(
                allprofs=array, start_freq=start_freq, bandwidth=bandwidth,
                nbin=array.shape[1], nchan=array.shape[0],
                date=header.get("tstart"), t0=t0, istart=istart,
                pulse_freq=1.0 / (array.shape[1] * eff_tsamp),
                ibeam=reader.ibeam, nbeams=reader.nbeams)
            if period_search and canary_obs is not None:
                # an injected chunk's plane carries the canary's track: it
                # skips the period stage
                obs_metrics.counter("putpu_canary_period_skips_total").inc()
            elif period_search:
                pres = stages.run("period", period_search_plane, plane,
                                  eff_tsamp,
                                  fmin=4.0 / (plane.shape[1] * eff_tsamp),
                                  refine_top=1)
                if pres["best_sigma"] > period_sigma_threshold:
                    info.period_freq = float(pres["best_freq"])
                    info.period_dm = float(table["DM"][pres["best_dm_index"]])
                    info.period_sigma = float(pres["best_sigma"])
                    info.period_H = float(pres["best_h"])
                    info.period_M = int(pres["best_m"])
                    if pres["best_profile"] is not None:
                        info.fold_profile = np.asarray(pres["best_profile"])
                    is_hit = True
                    logger.info("PERIODIC chunk %d-%d: f=%.4f Hz DM=%.2f "
                                "sigma=%.1f", istart, iend, info.period_freq,
                                info.period_dm, info.period_sigma)
            payload = cl = None
            if is_hit:
                info.dm = float(best["DM"])
                info.snr = float(best["snr"])
                info.width = float(best["rebin"]) * eff_tsamp
                with stages.bucket("hit_products"):
                    info.disp_profile = to_numpy(array.mean(0))
                    if plane is not None:
                        info.dedisp_profile = to_numpy(plane[
                            best_plane_idx if best_plane_idx is not None
                            else table.argbest()])
                    # the cutout is sliced on the device: the chunk stays
                    # there, and the persist payload holds host arrays
                    info = store.trim_waterfall(info, sci_table)
                    info.allprofs = to_numpy(info.allprofs)
                    timer.count("readbacks", 2 + (plane is not None))
                    obs_metrics.counter("putpu_bytes_readback_total").inc(
                        int(info.allprofs.nbytes))
                    # the profiles' Z^2 and H statistics, on the host
                    info.compute_stats()
                hits.append((istart, iend, info, sci_table))
                obs_metrics.counter("putpu_hits_total").inc()
                payload = (info, sci_table)
                logger.info("HIT chunk %d-%d: DM=%.2f snr=%.2f width=%gs",
                            istart, iend, info.dm, info.snr, info.width)
                if lineage is not None:
                    cl = lineage.candidate(
                        istart, iend, name=f"{root}_{istart}-{iend}",
                        dm=info.dm, snr=info.snr, width=info.width)
                if push is not None:
                    push.publish(
                        {"schema_version": 1, "kind": "candidate",
                         "fname": os.path.basename(str(fname)),
                         "root": root, "chunk": int(istart),
                         "iend": int(iend), "t_start_s": float(t0),
                         "dm": info.dm, "snr": info.snr,
                         "width_s": info.width,
                         "fingerprint": sp["fingerprint"]},
                        on_delivered=(
                            None if cl is None else
                            lambda sub, _lat, _cl=cl:
                            lineage.delivered(_cl, sub)))
            if make_plots == "all" or (make_plots == "hits" and is_hit):
                from .diagnostics import plot_diagnostics

                # the full table backs the figure (its plane panel is
                # labelled by the table's trials row for row), so a
                # promoted chunk's figure shows the canary's track
                stages.run("plot", plot_diagnostics, info, table, plane,
                           outname=os.path.join(
                               output_dir, f"{root}_{istart}-{iend}.jpg"),
                           t0=t0, show=show_plots, waterfall=array)
            # a non-hit's info still holds the cleaned chunk on the card
            del array, plane, info
            # submitted after the figure: the ledger never marks a chunk
            # whose figure is missing
            persist(payload, istart, iend, cl=cl)
            # second prefetch window: the read has had the whole search to
            # finish
            if prefetched is None:
                prefetched = prefetch_upload(ichunk + 1, next_read)
            headroom_frac = None
            if dev.type == "cuda":
                snap = obs_memory.record_watermark(dev)
                headroom_frac = ((snap["bytes_limit"] - snap["bytes_in_use"])
                                 / snap["bytes_limit"])
            nproc += 1
            health_update(istart, time.perf_counter() - t_chunk,
                          candidates=ncand_above,
                          headroom_frac=headroom_frac)
            if lineage is not None:
                lineage.discard(istart)
            if roofline.enabled():
                roofline.flush()
            if progress and nproc % PROGRESS_EVERY == 0:
                logger.info("processed %d chunks (through sample %d/%d)",
                            nproc, iend, nsamples)
          drain_persist()
    except BaseException:
        reader_pool.shutdown(wait=False, cancel_futures=True)
        if persist_pool is not None:
            persist_pool.shutdown(wait=False, cancel_futures=True)
        if push is not None and push_owned:
            push.close(timeout_s=1.0)
        if obs_server is not None:
            obs_server.close()
        if stage_seconds is not None:
            stage_seconds.update(_since(timer.stage_seconds(), base_seconds))
        raise
    reader_pool.shutdown(wait=True)
    if persist_pool is not None:
        # the persist queue's tail: the only persist time left on the
        # critical path
        def finish():
            persist_pool.shutdown(wait=True)
            drain_persist(block=True)

        stages.run("persist_drain", finish)
    if push is not None and push_owned:
        # bounded: a wedged subscriber journals to the dead letter
        logger.info("PUSH_JSON %s", json.dumps(push.close()))
    if health is not None and nproc:
        # a dead letter from the final drain reaches the engine here
        health_update("drain", None)
    timer.report()
    timer.footer()
    logger.info("BUDGET_JSON %s", json.dumps(timer.to_json()))
    if canary is not None:
        logger.info("CANARY_JSON %s", json.dumps(canary.to_json()))
    if health is not None:
        logger.info("health verdict at end of run: %s%s", health.verdict,
                    " (" + ", ".join(health.reasons()) + ")"
                    if health.reasons() else "")

    if resume:
        # the complete result of the configuration: hits persisted by
        # earlier (interrupted) sessions are restored from the store; a
        # pair that does not load (a torn or bit-rotted file) is skipped
        # and counted
        seen = {(h[0], h[1]) for h in hits}
        for cand_root, lo, hi in store.candidates():
            if cand_root != root or (lo, hi) in seen \
                    or not store.is_done(lo):
                continue
            try:
                info, table = store.load_candidate(root, lo, hi)
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile, zlib.error) as exc:
                obs_metrics.counter(
                    "putpu_resume_pairs_skipped_total").inc()
                logger.warning("could not restore candidate %s_%d-%d: %r",
                               root, lo, hi, exc)
                continue
            hits.append((lo, hi, info, table))
        hits.sort(key=lambda h: h[0])
        # ledger vs candidate files vs manifest: logged, never fatal
        try:
            report = audit_run(output_dir, fingerprint, root=root)
        except Exception as exc:  # noqa: BLE001 — never fatal
            logger.warning("integrity audit failed (%r); the run's result "
                           "is unaffected", exc)
        else:
            if report["issues"]:
                logger.warning("integrity audit: %d inconsistencies: %s",
                               len(report["issues"]), report["issues"])
            else:
                logger.info("integrity audit: ok %s", report["checked"])
    logger.info("done: %d chunks searched, %d hits, %d noise-certified, "
                "%d quarantined", len(todo), len(hits), ncertified,
                len(quarantined))
    if report_out:
        from ..obs import report as obs_report

        try:  # never fatal: observability must not take down a run
            md_path, html_path = obs_report.write_report(
                str(report_out),
                meta={"root": root, "fname": os.path.abspath(str(fname)),
                      "fingerprint": sp["fingerprint"],
                      "chunks_processed": nproc, "hits": len(hits),
                      "certified": ncertified, "backend": "torch",
                      "device": str(dev), "kernel": kernel,
                      "snr_threshold": snr_threshold,
                      **({"mesh": timer.mesh_shape} if mesh is not None
                         else {})},
                budget=timer.to_json(max_per_chunk=0),
                roofline=roofline.table(),
                health=health.snapshot() if health is not None else None,
                canary=canary.to_json() if canary is not None else None,
                quarantine=manifest.records(),
                metrics=obs_metrics.REGISTRY.snapshot(),
                lineage=(lineage.summary()
                         if lineage is not None else None),
                push=push.stats() if push is not None else None)
        except Exception as exc:  # noqa: BLE001 — never fatal
            logger.warning("survey report failed (%r); run result is "
                           "unaffected", exc)
        else:
            logger.info("survey report -> %s + %s", md_path, html_path)
    if obs_server is not None:
        obs_server.close()
    if stage_seconds is not None:
        stage_seconds.update(_since(timer.stage_seconds(), base_seconds))
    if summary is not None:
        summary.update(snr_threshold=snr_threshold,
                       snr_floor=sp["search_snr_floor"], searched=len(todo),
                       certified=ncertified, quarantined=len(quarantined),
                       fallback=state.get("fallback"),
                       oom_descents=_ladder.level())
    return hits, store


def _since(now, base):
    """The stage seconds of ``now`` less those already in ``base`` (a
    caller-owned accountant may hold an earlier run's)."""
    return {k: v - base.get(k, 0.0) for k, v in now.items()
            if v - base.get(k, 0.0) > 0.0 or k not in base}
