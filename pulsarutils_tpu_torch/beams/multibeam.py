"""The N-filterbank multi-beam survey driver.

``multibeam_search`` opens N same-geometry filterbanks (the beams of one
receiver), plans one chunk grid from the shared physics and walks it,
every beam's chunk of an epoch searched in one batched dispatch
(:class:`~.batcher.BeamBatcher`).  Per beam it keeps the single-beam
driver's contracts:

* **exact resume**: one :class:`~..io.candidates.CandidateStore` ledger
  per beam, fingerprinted by the beam's own (file, physics) config and
  not by the batch, so a chunk searched in a batch of 8, of 3 or alone
  marks done the same way;
* **bit-identity**: each beam's tables, and so its ledger and candidate
  files, are byte for byte the same with ``batched=True`` and with the
  sequential arm (``batched=False``: beam by beam through the same
  per-beam body);
* **per-beam canary**: ``canary_rate`` gives each beam a
  :class:`~..obs.canary.CanaryController` labelled with the beam, each
  injecting its own deterministic chunk subset.

After the chunk loop the beams' hits go through the cross-beam
coincidence sift (:mod:`.coincidence`).
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import threading
import time

import numpy as np

from ..io.candidates import CandidateStore, config_fingerprint
from ..io.sigproc import FilterbankReader
from ..obs import metrics as obs_metrics
from ..obs.canary import CanaryController, science_hit
from ..ops.plan import dedispersion_plan
from ..parallel.stream import iter_chunk_starts, plan_chunks
from ..pipeline.pulse_info import PulseInfo
from ..pipeline.sift import hit_fields
from ..utils.logging_utils import BudgetAccountant
from .batcher import BeamBatcher, BeamGeometryError
from .coincidence import coincidence_sift

logger = logging.getLogger("pulsarutils_tpu_torch")

__all__ = ["multibeam_search", "open_beams"]

#: header keys every co-batched beam must agree on (the chunk plan and
#: the shared offset table are derived from exactly these)
_GEOMETRY_KEYS = ("nchans", "tsamp", "fbottom", "ftop", "bandwidth", "foff")


def open_beams(fnames):
    """Open N filterbanks as the beams of one batch; returns ``(readers,
    labels)``.

    The channel count, sample time and band must agree across the files:
    a mismatched beam raises :class:`~.batcher.BeamGeometryError` naming
    the key.  Labels are the sigproc ``ibeam`` headers where every file
    has one and they are unique, else the positions."""
    readers = [FilterbankReader(f) for f in fnames]
    ref = readers[0].header
    for r in readers[1:]:
        for key in _GEOMETRY_KEYS:
            if not np.isclose(float(r.header.get(key, 0.0)),
                              float(ref.get(key, 0.0)), rtol=1e-9):
                raise BeamGeometryError(
                    f"{r.path}: header {key}={r.header.get(key)!r} does "
                    f"not match {readers[0].path}'s {ref.get(key)!r} — "
                    "beams batch only at one shared geometry")
    ibeams = [r.ibeam for r in readers]
    if all(b is not None for b in ibeams) \
            and len(set(ibeams)) == len(ibeams):
        labels = [int(b) for b in ibeams]
    else:
        labels = list(range(len(readers)))
    return readers, labels


# -- the host conditioning ---------------------------------------------------

#: row spans of the host conditioning run on this many threads
_CLEAN_THREADS = max(1, min(8, os.cpu_count() or 1))
_pool = None
_pool_lock = threading.Lock()


def _clean_pool():
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = concurrent.futures.ThreadPoolExecutor(
                _CLEAN_THREADS, thread_name_prefix="putpu-beam-clean")
        return _pool


def _spans(n, parts):
    step = -(-n // parts)
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def _parallel(fn, n):
    """``fn(lo, hi)`` over ``_CLEAN_THREADS`` spans of ``range(n)`` (NumPy
    releases the GIL in its loops); re-raises the first error."""
    spans = _spans(n, _CLEAN_THREADS)
    if len(spans) == 1:
        fn(*spans[0])
        return
    for fut in [_clean_pool().submit(fn, lo, hi) for lo, hi in spans]:
        fut.result()


def _gaussian_filter_host(x, sigma, truncate=4.0):
    """``scipy.ndimage.gaussian_filter1d`` (mode 'reflect') in float64, as
    the JAX package's NumPy path computes it: the symmetric extension
    repeated until it is long enough, then ``np.convolve`` 'valid'."""
    radius = int(truncate * float(sigma) + 0.5)
    if radius == 0:
        return x
    kx = np.arange(-radius, radius + 1)
    kernel = np.exp(-0.5 * (kx / float(sigma)) ** 2)
    kernel = kernel / kernel.sum()
    padded = x
    left = right = radius
    while left > 0 or right > 0:
        n = padded.shape[0]
        take_l, take_r = min(left, n), min(right, n)
        padded = np.concatenate([padded[:take_l][::-1], padded,
                                 padded[n - take_r:][::-1]])
        left, right = left - take_l, right - take_r
    return np.convolve(padded, kernel, mode="valid")


def _clean_block(block, resample, baseline_window=101):
    """The per-beam host conditioning, in float64: the JAX package's
    NumPy ``renormalize_data`` (no bad channels, no outlier cut) and
    ``quick_resample``, then float32.  The same NumPy operations on the
    same values, so the same floats, split over threads so that each
    reduction keeps its own order: each sample's sum over the channels
    (one ``sum(axis=0)`` a tile of samples, as the stored values are
    converted), each row's mean (pairwise, row by row).  ``block`` is
    the ``(nchan, T)`` block in any real dtype and layout (a read block,
    or the transposed view of a file's frames).  The batched and
    sequential arms condition each beam alike, so the bit-identity
    contract covers the whole pipeline."""
    block = np.asarray(block)
    nchan, nsamples = block.shape
    array = np.empty((nchan, nsamples), dtype=np.float64)
    lc = np.empty(nsamples, dtype=np.float64)

    def convert(lo, hi, tile=512):
        # a tile of samples at a time: converted, then summed over the
        # channels while it is in cache
        for c0 in range(lo, hi, tile):
            c1 = min(c0 + tile, hi)
            array[:, c0:c1] = block[:, c0:c1]
            lc[c0:c1] = array[:, c0:c1].sum(axis=0)

    _parallel(convert, nsamples)
    lc = lc / max(nchan, 1)  # the good-channel mean light curve
    window = min(int(baseline_window), nsamples // 100 * 2 + 1)
    lc_smooth = _gaussian_filter_host(lc, window)
    lc_smooth = np.where(lc_smooth == 0, 1.0, lc_smooth)
    factor = np.median(lc_smooth) / lc_smooth
    spec = np.empty(nchan, dtype=np.float64)

    def scale(lo, hi):
        for r in range(lo, hi):
            np.multiply(array[r], factor, out=array[r])
            spec[r] = array[r].mean()

    _parallel(scale, nchan)
    denom = np.where(spec == 0, 1.0, spec)
    nout = nsamples // resample if resample > 1 else nsamples
    out = np.empty((nchan, nout), dtype=np.float32)

    def finish(lo, hi):
        for r in range(lo, hi):
            row = array[r]
            np.subtract(row, spec[r], out=row)
            np.divide(row, denom[r], out=row)
            if resample > 1:
                row = row[:nout * resample].reshape(nout, resample).sum(
                    axis=1)
            out[r] = row

    _parallel(finish, nchan)
    return out


def _read_stored(reader, istart, nsamps):
    """A beam's ascending ``(nchan, n)`` block of stored values: the
    transposed view of its frames for a single-IF 8- or 32-bit file (no
    float copy: :func:`_clean_block` converts them as it goes), else
    ``read_block``'s float64 block.  Either fires the ``read`` seam; the
    values are ``read_block``'s."""
    if reader.nifs != 1 or reader.nbits not in (8, 32):
        return reader.read_block(istart, nsamps, band_ascending=True)
    frames = np.empty((int(nsamps), reader.frame_width),
                      dtype=reader.frame_dtype)
    n = reader.read_frames_into(istart, nsamps, frames)
    block = frames[:n].T
    return block[::-1] if reader.band_descending else block


def multibeam_search(fnames, dmmin=200, dmmax=800, *, snr_threshold=6.0,
                     output_dir=None, resume=True, max_chunks=None,
                     chunk_length=None, new_sample_time=None,
                     batched=True, kernel=None, canary_rate=0.0,
                     canary_seed=0, coincidence=True, veto_frac=0.7,
                     max_real_beams=2, adjacency=None, budget=None,
                     progress_cb=None, cancel_cb=None, keep_tables=False,
                     store_factory=None, packed="auto", device="cuda"):
    """Search N same-geometry filterbanks as one batched survey on
    ``device`` (the card unless the caller asks for the CPU).

    Returns::

        {"beams": [{"fname", "beam", "root", "hits": [(istart, iend,
                    info, table), ...], "store", "cancelled",
                    "chunks_done", "canary", "tables" (keep_tables)}],
         "coincidence": {"groups": [...], "stats": {...}} or None,
         "plan": ChunkPlan, "snr_threshold": float}

    ``batched=False`` is the sequential arm: the same per-beam pipeline,
    beam by beam.  ``progress_cb(beam_index, istart, wall_s, ncand)`` and
    ``cancel_cb(beam_index) -> bool`` are the job hooks: a cancelled beam
    leaves the batch (its remaining chunks stay unmarked, so the same
    spec resumes from its ledger) while the others go on.
    ``store_factory(i, fname, fingerprint)`` builds a beam's store.

    ``budget``, a caller-owned
    :class:`~..utils.logging_utils.BudgetAccountant` (one is made
    otherwise), takes one chunk an epoch: buckets ``read``, ``clean``
    (the host conditioning), ``search`` (``search/dispatch`` with a
    ``search/dispatch/upload`` a host beam, ``search/readback``),
    ``hit_products`` a hit beam, ``persist`` (``persist/candidate`` a
    hit beam, ``persist/ledger`` every beam).  With a ``budget`` a CUDA
    run also times each bucket on the stream with CUDA events
    (``device_s`` on each epoch's record).

    ``packed`` selects the low-bit data path:

    * ``"auto"``: ``"device"`` when every file is a packed 1/2/4-bit
      single-IF filterbank of one width, else ``"off"``;
    * ``"device"`` (or True): each beam's raw packed bytes are read, the
      canary quantised into them, stacked, uploaded and unpacked per
      beam on the device, conditioned there (renormalise, resample);
    * ``"host"``: the same device conditioning fed host-unpacked float
      codes (the same floats at float32 upload cost): the A/B arm,
      byte-identical to ``"device"``;
    * ``"off"`` (or False, None): the host float64 clean
      (:func:`_clean_block`), the only mode for 8/16/32-bit files.
    """
    if not fnames:
        raise ValueError("multibeam_search needs at least one filterbank")
    from ..resilience import ladder as _resilience_ladder

    # each survey session starts undegraded
    _resilience_ladder.reset()
    readers, labels = open_beams(fnames)
    nbeams = len(readers)
    header = readers[0].header
    nchan = header["nchans"]
    sample_time = header["tsamp"]
    start_freq = header["fbottom"]
    stop_freq = header["ftop"]
    bandwidth = header["bandwidth"]
    foff = header["foff"]
    nsamples = min(r.nsamples for r in readers)
    if any(r.nsamples != nsamples for r in readers):
        logger.warning(
            "beam files differ in length (%s samples): batching the "
            "common %d-sample prefix",
            sorted({r.nsamples for r in readers}), nsamples)

    lowbit_ok = (all(r.nbits in (1, 2, 4) and r.nifs == 1 for r in readers)
                 and len({r.nbits for r in readers}) == 1)
    if packed == "auto":
        mode = "device" if lowbit_ok else "off"
    elif packed is True or packed == "device":
        mode = "device"
    elif packed == "host":
        mode = "host"
    elif packed is False or packed is None or packed == "off":
        mode = "off"
    else:
        raise ValueError(f"packed={packed!r}: expected 'auto', 'device', "
                         "'host' or 'off'")
    if mode in ("device", "host") and not lowbit_ok:
        raise ValueError(
            "packed mode needs every beam file packed at one shared "
            "1/2/4-bit single-IF format; pass packed='off' for mixed "
            "or full-rate files")
    nbits = readers[0].nbits if lowbit_ok else 0
    descending = readers[0].band_descending

    plan = plan_chunks(nsamples, sample_time, dmmin, dmmax, start_freq,
                       stop_freq, foff, chunk_length=chunk_length,
                       new_sample_time=new_sample_time)
    eff_tsamp = plan.sample_time
    trial_dms = dedispersion_plan(nchan, dmmin, dmmax, start_freq,
                                  bandwidth, eff_tsamp)
    nsamp_eff = plan.step // plan.resample
    batcher = BeamBatcher(
        nchan, nsamp_eff, trial_dms, start_freq, bandwidth, eff_tsamp,
        kernel=kernel, batch_hint=nbeams,
        packed=(nbits, descending) if mode == "device" else None,
        prep=(True, plan.resample) if mode != "off" else None,
        device=device)
    logger.info("multibeam: %d beams, chunk plan step=%d hop=%d "
                "resample=%d, %d trials, kernel=%s, %s dispatch, "
                "data path=%s, device %s",
                nbeams, plan.step, plan.hop, plan.resample, len(trial_dms),
                batcher.kernel, "batched" if batched else "sequential",
                mode if mode != "off" else "host-clean", batcher.device)

    timer = budget if budget is not None else BudgetAccountant()
    timer.begin_stream()
    if budget is not None:
        # the stages' device intervals, from events on the stream
        timer.enable_device_timing(batcher.device)

    beams = []
    for i, (reader, label) in enumerate(zip(readers, labels)):
        fname = reader.path
        root = os.path.splitext(os.path.basename(str(fname)))[0]
        out_i = output_dir or os.path.dirname(os.path.abspath(str(fname)))
        # the beam's own science config, no batch width or co-beams: the
        # ledgers serve batched, sequential and differently-batched runs
        fingerprint = config_fingerprint(
            fname=os.path.abspath(str(fname)), dmmin=dmmin, dmmax=dmmax,
            step=plan.step, resample=plan.resample, backend="torch",
            kernel="multibeam", snr_threshold=snr_threshold)
        if store_factory is not None:
            store = store_factory(i, fname, fingerprint if resume else None)
        else:
            store = CandidateStore(out_i, fingerprint if resume else None)
        controller = None
        if canary_rate and float(canary_rate) > 0.0:
            controller = CanaryController(rate=float(canary_rate),
                                          seed=canary_seed, beam=label)
            controller.bind(nchan=nchan, start_freq=start_freq,
                            bandwidth=bandwidth, tsamp=sample_time,
                            dmmin=dmmin, dmmax=dmmax,
                            resample=plan.resample)
        beams.append({"fname": str(fname), "beam": label, "root": root,
                      # provenance: the header's observation-level nbeams
                      # where present; the batch width is the
                      # coincidence denominator instead
                      "nbeams": (reader.nbeams if reader.nbeams is not None
                                 else nbeams),
                      "reader": reader, "store": store, "hits": [],
                      "canary": controller, "cancelled": False,
                      "chunks_done": 0,
                      "tables": [] if keep_tables else None})

    todo = list(iter_chunk_starts(nsamples, plan))
    if max_chunks is not None:
        todo = todo[:max_chunks]
    date = header.get("tstart", None)

    for istart in todo:
        chunk_size = min(plan.step, nsamples - istart)
        iend = istart + chunk_size
        t0 = istart * sample_time
        pending = []
        for i, b in enumerate(beams):
            if b["cancelled"]:
                continue
            if cancel_cb is not None and cancel_cb(i):
                b["cancelled"] = True
                logger.info("beam %s cancelled at chunk %d", b["beam"],
                            istart)
                continue
            if resume and b["store"].is_done(istart):
                continue
            pending.append(i)
        if not pending:
            continue

        # one budget chunk per epoch: its dispatch and readback counts
        # are the batch's (or the beams')
        with timer.chunk(istart):
            blocks = {}
            with timer.bucket("read"):
                for i in pending:
                    b = beams[i]
                    if mode != "off":
                        # the packed path: raw bytes, the canary
                        # quantised into the codes; "host" decodes here
                        raw = b["reader"].read_block_packed(istart,
                                                            chunk_size)
                        if b["canary"] is not None:
                            raw = b["canary"].maybe_inject_packed(
                                raw, istart, nbits=nbits, nchan=nchan,
                                band_descending=descending)
                        if mode == "host":
                            from ..io.lowbit import PackedFrames

                            blocks[i] = PackedFrames(
                                raw, nbits, nchan,
                                band_descending=descending).to_host()
                        else:
                            blocks[i] = raw
                        continue
                    if b["canary"] is not None \
                            and b["canary"].selects(istart):
                        # the canary is added to the float64 block
                        blocks[i] = b["canary"].maybe_inject(
                            b["reader"].read_block(istart, chunk_size,
                                                   band_ascending=True),
                            istart)
                    else:
                        blocks[i] = _read_stored(b["reader"], istart,
                                                 chunk_size)
            if mode == "off":
                # the packed modes condition on the device (the batcher's
                # prep); this one on the host
                with timer.bucket("clean"):
                    for i in pending:
                        blocks[i] = _clean_block(blocks[i], plan.resample)

            t_chunk = time.perf_counter()
            with timer.bucket("search"):
                if batched:
                    tables = batcher.search([blocks[i] for i in pending])
                    obs_metrics.counter("putpu_multibeam_batches_total").inc()
                else:
                    tables = [batcher.search_single(blocks[i])
                              for i in pending]
            wall = time.perf_counter() - t_chunk

            for i, table in zip(pending, tables):
                b = beams[i]
                table.meta["ibeam"] = b["beam"]
                table.meta["nbeams"] = b["nbeams"]
                if keep_tables:
                    b["tables"].append((istart, table))
                canary_obs = (b["canary"].observe(istart, table,
                                                  snr_threshold)
                              if b["canary"] is not None else None)
                ncand = int(np.count_nonzero(
                    np.asarray(table["snr"], dtype=np.float64)
                    > float(snr_threshold)))
                if canary_obs is not None:
                    ncand = max(ncand - canary_obs["n_above_near"], 0)
                is_hit, sci_table, best, _ = science_hit(
                    b["canary"], canary_obs, istart, table, snr_threshold,
                    f"beam {b['beam']} chunk {istart}")

                payload = None
                if is_hit:
                    with timer.bucket("hit_products"):
                        if mode == "device":
                            # the hit's waterfall: the host decode and host
                            # clean of the bytes the device searched, alike
                            # in both packed arms
                            from ..io.lowbit import PackedFrames

                            array = _clean_block(PackedFrames(
                                blocks[i], nbits, nchan,
                                band_descending=descending).to_host(),
                                plan.resample)
                        elif mode == "host":
                            array = _clean_block(blocks[i], plan.resample)
                        else:
                            array = blocks[i]
                        info = PulseInfo(
                            allprofs=array, start_freq=start_freq,
                            bandwidth=bandwidth, nbin=array.shape[1],
                            nchan=array.shape[0], date=date, t0=t0,
                            istart=istart,
                            pulse_freq=1.0 / (array.shape[1] * eff_tsamp),
                            ibeam=b["beam"], nbeams=b["nbeams"],
                            dm=float(best["DM"]), snr=float(best["snr"]),
                            width=float(best["rebin"]) * eff_tsamp)
                        info.disp_profile = np.asarray(array.mean(0))
                        info.compute_stats()
                        payload = (info, sci_table)
                        obs_metrics.counter("putpu_beam_hits_total",
                                            beam=str(b["beam"])).inc()
                        logger.info("HIT beam %s chunk %d-%d: DM=%.2f "
                                    "snr=%.2f", b["beam"], istart, iend,
                                    info.dm, info.snr)
                with timer.bucket("persist"):
                    if payload is not None:
                        with timer.bucket("persist/candidate"):
                            b["store"].save_candidate(b["root"], istart,
                                                      iend, *payload)
                        b["hits"].append((istart, iend) + payload)
                    with timer.bucket("persist/ledger"):
                        b["store"].mark_done(istart)
                b["chunks_done"] += 1
                obs_metrics.counter("putpu_beam_chunks_total",
                                    beam=str(b["beam"])).inc()
                if progress_cb is not None:
                    progress_cb(i, istart, wall / len(pending), ncand)

    # a resumed session reports each beam's whole result: the candidates
    # an interrupted run persisted are restored
    for b in beams:
        if not resume:
            continue
        seen = {(h[0], h[1]) for h in b["hits"]}
        for cand_root, lo, hi in b["store"].candidates():
            if (cand_root != b["root"] or (lo, hi) in seen
                    or not b["store"].is_done(lo)):
                continue
            try:
                info, table = b["store"].load_candidate(b["root"], lo, hi)
            except (OSError, ValueError, KeyError) as exc:
                obs_metrics.counter(
                    "putpu_resume_pairs_skipped_total").inc()
                logger.warning("beam %s: could not restore candidate "
                               "%s_%d-%d: %r", b["beam"], b["root"], lo,
                               hi, exc)
                continue
            b["hits"].append((lo, hi, info, table))
        b["hits"].sort(key=lambda h: h[0])

    coinc = None
    if coincidence:
        cands = []
        for b in beams:
            for h in b["hits"]:
                c = hit_fields(*h)
                c["beam"] = b["beam"]
                cands.append(c)
        stats = {}
        groups = coincidence_sift(
            cands, nbeams=nbeams, veto_frac=veto_frac,
            max_real_beams=max_real_beams, adjacency=adjacency,
            stats=stats) if cands else []
        if not cands:
            stats = {"in": 0, "nbeams": nbeams, "groups": 0,
                     "verdicts": {}, "vetoed_members": 0}
        coinc = {"groups": groups, "stats": stats}

    timer.resolve_device_times()
    timer.report()
    timer.footer()
    logger.info("BUDGET_JSON %s", json.dumps(timer.to_json()))
    for b in beams:
        if b["canary"] is not None:
            logger.info("CANARY_JSON %s", json.dumps(b["canary"].to_json()))
    logger.info("multibeam done: %d beams, %s chunks/beam, hits per "
                "beam %s", nbeams, len(todo),
                {b["beam"]: len(b["hits"]) for b in beams})
    result_beams = []
    for b in beams:
        result_beams.append({
            "fname": b["fname"], "beam": b["beam"], "root": b["root"],
            "hits": b["hits"], "store": b["store"],
            "cancelled": b["cancelled"], "chunks_done": b["chunks_done"],
            "canary": (b["canary"].to_json() if b["canary"] is not None
                       else None),
            **({"tables": b["tables"]} if keep_tables else {})})
    return {"beams": result_beams, "coincidence": coinc, "plan": plan,
            "snr_threshold": float(snr_threshold)}
