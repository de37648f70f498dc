"""The streaming search driver: file -> clean -> sweep -> candidates.

The port of the JAX package's ``search_by_chunks`` with the exact direct
sweep (the default) or the FDMT/hybrid kernels, itself the counterpart of
the reference's ``pulsarutils/clean.py:276-351``:

* bad channels are flagged once from the file's bandpass statistics;
* the file is cut into 50%-overlap chunks sized by the search physics
  (:func:`..parallel.stream.plan_chunks`); every chunk is read, moved to
  the device in its stored dtype, cleaned there, searched there, and
  scored; only the scores and hit products come back;
* a chunk whose best S/N exceeds ``snr_threshold`` is persisted through
  :class:`..io.candidates.CandidateStore`, and every searched chunk is
  marked in the resume ledger, so a restarted run searches only what is
  missing;
* with ``period_search`` each chunk's dedispersed plane also gets the
  folded period search (:func:`..ops.periodicity.period_search_plane`),
  and ``plane_consumer`` hands each plane downstream (the periodicity
  driver's accumulation seam).

Everything downstream of the reader sees an *ascending* band.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..io.candidates import CandidateStore, config_fingerprint
from ..io.sigproc import FilterbankReader
from ..ops.certify import (certifiable_snr_floor, matched_snr_floor,
                           retention_bound)
from ..ops.clean_ops import fft_zap_time, renormalize_data, zero_dm_filter
from ..ops.periodicity import period_search_plane
from ..ops.plan import dedispersion_plan
from ..ops.rebin import quick_resample
from ..ops.search import dedispersion_search
from ..parallel.stream import iter_chunk_starts, plan_chunks
from ..utils.device import resolve_device, to_numpy
from .pulse_info import PulseInfo
from .spectral_stats import get_bad_chans

logger = logging.getLogger("pulsarutils_tpu_torch")


def plan_survey(fname, chunk_length=None, new_sample_time=None, tmin=0,
                dmmin=200, dmmax=800, surelybad=(), *, kernel="auto",
                snr_threshold=6.0, fft_zap=False, cut_outliers=False,
                zero_dm=False, exact_floor="auto", period_search=False,
                period_sigma_threshold=8.0, fingerprint_extra=None):
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
    packages never share a ledger.  ``fingerprint_extra`` (a flat
    JSON-safe dict) is merged into it last, so another workload over the
    same file (the periodicity driver) keeps a ledger of its own; None
    leaves the fingerprint as it was.
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
    """Wall seconds per stage, synchronising the device at each stage's
    end so that queued device work is charged to the stage that queued
    it."""

    def __init__(self, device, into):
        self.device = device
        self.seconds = into

    def run(self, name, fn, *args, **kwargs):
        if self.seconds is None:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[name] = (self.seconds.get(name, 0.0)
                              + time.perf_counter() - t0)
        return out


def _persist(store, root, istart, iend, info, table):
    """Save a hit (``info`` not None), then mark the chunk done: a crash
    between the two re-searches the chunk, never loses its candidate."""
    if info is not None:
        store.save_candidate(root, istart, iend, info, table)
    store.mark_done(istart)


def search_by_chunks(fname, chunk_length=None, new_sample_time=None, tmin=0,
                     dmmin=200, dmmax=800, surelybad=(), *, kernel="auto",
                     snr_threshold=6.0, output_dir=None, resume=True,
                     fft_zap=False, cut_outliers=False, zero_dm=False,
                     max_chunks=None, exact_floor="auto",
                     period_search=False, period_sigma_threshold=8.0,
                     plane_consumer=None, fingerprint_extra=None,
                     chunks=None, device="cuda", stage_seconds=None,
                     summary=None):
    """Search a filterbank file for dispersed single pulses.

    Parameters follow the JAX package's driver (``snr_threshold`` and
    ``exact_floor`` as :func:`plan_survey` resolves them); ``device`` is
    where the chunks are cleaned and searched (``"cuda"`` by default,
    raising without a card; ``"cpu"`` on request).  ``max_chunks`` stops
    after that many chunks (the rest stay un-marked for a resumed run);
    ``chunks``, a list of chunk starts, searches only those (starts not
    in the plan are ignored).

    ``period_search=True`` adds the folded period search of every
    chunk's plane (:func:`..ops.periodicity.period_search_plane`); a
    chunk whose refined significance exceeds ``period_sigma_threshold``
    is a hit even below ``snr_threshold`` and carries the ``period_*``
    fields and ``fold_profile``.  ``plane_consumer``, a ``fn(istart,
    plane, table)`` callable, receives every searched chunk's plane
    before the chunk is marked done (a crash in between re-delivers the
    chunk on resume; consumers de-duplicate by ``istart``).
    ``fingerprint_extra`` goes to :func:`plan_survey`.

    ``stage_seconds``, a dict, receives the wall seconds of each stage
    (``badchans``, ``read``, ``clean``, ``search``, ``plane_consume``,
    ``period``, ``persist``); ``summary``, a dict, receives
    ``snr_threshold`` (resolved), ``snr_floor`` (the hybrid's, or None),
    ``searched`` and ``certified`` (the chunks the hybrid's noise
    certificate cleared).

    Returns ``(hits, store)``: ``hits`` is a list of ``(istart, iend,
    PulseInfo, ResultTable)`` — with ``resume``, including hits persisted
    by earlier sessions of the same configuration.
    """
    dev = resolve_device(device)
    stages = _Stages(dev, stage_seconds)
    output_dir = output_dir or os.path.dirname(os.path.abspath(str(fname)))
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
                     fingerprint_extra=fingerprint_extra)
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
    mask_dev = torch.as_tensor(mask.copy(), device=dev)
    store = CandidateStore(output_dir, sp["fingerprint"] if resume else None)
    capture = bool(period_search) or plane_consumer is not None

    todo = [s for s in sp["chunk_starts"]
            if not (resume and store.is_done(s))]
    if chunks is not None:
        wanted = {int(c) for c in chunks}
        todo = [s for s in todo if s in wanted]
    if max_chunks is not None:
        todo = todo[:max_chunks]

    hits = []
    ncertified = 0
    for istart in todo:
        iend = istart + min(plan.step, nsamples - istart)
        block = stages.run("read", reader.read_block_tensor, istart,
                           iend - istart, dev)
        array = stages.run("clean", clean_chunk, block, mask_dev,
                           cut_outliers=cut_outliers, zero_dm=zero_dm,
                           fft_zap=fft_zap, resample=plan.resample)
        del block
        result = stages.run("search", dedispersion_search, array, dmmin,
                            dmmax, start_freq, bandwidth, eff_tsamp,
                            kernel=kernel, snr_floor=sp["search_snr_floor"],
                            capture_plane=capture, device=dev)
        table, plane = result if capture else (result, None)
        if plane_consumer is not None:
            stages.run("plane_consume", plane_consumer, istart, plane,
                       table)
        if table.meta.get("certified"):
            # the noise certificate: no detection above the floor, no
            # exact rescore paid (is_hit is False by construction)
            ncertified += 1
        best = table.best_row()
        is_hit = bool(best["snr"] > snr_threshold)
        info = PulseInfo(
            allprofs=array, start_freq=start_freq, bandwidth=bandwidth,
            nbin=array.shape[1], nchan=array.shape[0],
            date=header.get("tstart"), t0=istart * sample_time,
            istart=istart, pulse_freq=1.0 / (array.shape[1] * eff_tsamp),
            ibeam=reader.ibeam, nbeams=reader.nbeams)
        if period_search:
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
        if is_hit:
            info.dm = float(best["DM"])
            info.snr = float(best["snr"])
            info.width = float(best["rebin"]) * eff_tsamp
            info.disp_profile = to_numpy(array.mean(0))
            if plane is not None:
                info.dedisp_profile = to_numpy(plane[table.argbest()])
            # the cutout is sliced on the device: the chunk stays there
            info = store.trim_waterfall(info, table)
            info.allprofs = to_numpy(info.allprofs)
            info.compute_stats()
            hits.append((istart, iend, info, table))
            logger.info("HIT chunk %d-%d: DM=%.2f snr=%.2f width=%gs",
                        istart, iend, info.dm, info.snr, info.width)
        else:
            info = None
        del array, plane
        stages.run("persist", _persist, store, root, istart, iend, info,
                   table)

    if resume:
        # the complete result of the configuration: hits persisted by
        # earlier (interrupted) sessions are restored from the store
        seen = {(h[0], h[1]) for h in hits}
        for cand_root, lo, hi in store.candidates():
            if cand_root == root and (lo, hi) not in seen \
                    and store.is_done(lo):
                hits.append((lo, hi, *store.load_candidate(root, lo, hi)))
        hits.sort(key=lambda h: h[0])
    logger.info("done: %d chunks searched, %d hits, %d noise-certified",
                len(todo), len(hits), ncertified)
    if summary is not None:
        summary.update(snr_threshold=snr_threshold,
                       snr_floor=sp["search_snr_floor"], searched=len(todo),
                       certified=ncertified)
    return hits, store
