"""Canary pulse injection: detection efficiency as a live metric.

The port of the JAX package's module.  A :class:`CanaryController`
injects a known-``(DM, width, S/N)`` dispersed pulse into a configurable
fraction of chunks, after any armed fault corruption and before the
integrity gate, so a canary rides exactly the values the search will
see; it then matches the emitted table against the expectation into a
rolling **recall**, **S/N recovery ratio** and **DM error**.

Where the bump is added.  The JAX package injects into the host float
block on its reader thread.  The port's frames become float on the card
(:meth:`..io.sigproc.FilterbankReader.block_from_frames`), so the bump is
built on the reader thread from the same seeded numpy code
(:meth:`CanaryController.injection`: the same rows, columns and float64
amplitudes, the noise scale from the same strided subsample of the raw
frames) and added on the main thread, on the card, after the frames'
conversion: ``float32(float64(x) + amp)``, the add the JAX package's
float64 block makes before its float32 upload, so an injected chunk
equals the JAX package's bit for bit (:func:`inject_tensor`).  A chunk
a ``corrupt`` fault matched arrives as a host float block and is injected
there (:meth:`CanaryController.maybe_inject`), as in the JAX package.

Containment rules (the ledger and candidate contract), as in the JAX
package:

* disabled (``canary=None``) the hooks are not on the data path at all;
* chunk selection is deterministic per ``(seed, chunk_start)``, so a
  resumed run injects into the chunks the interrupted run would have;
* a canary is counted when observed: a chunk that never reaches the
  search (quarantined, unreadable) has its pending injection
  :meth:`discarded <CanaryController.discard>`;
* a chunk whose best row matches the injected track (DM and
  dedispersed arrival time) is **tagged**: the driver masks the canary's
  rows out of the science view and promotes the strongest remaining row
  when it still clears the threshold.  Canaries never become candidates,
  ledger payloads or sift input.  A chunk where a real pulse outranks
  its canary persists normally, its table still holding the canary-lit
  rows (counted as ``putpu_canary_contaminated_tables_total``).

A packed 1/2/4-bit chunk crosses to the card as its packed bytes, so
its bump is quantised onto the code grid and re-packed on the reader
thread, in the staging buffer before the upload
(:meth:`CanaryController.maybe_inject_packed`, the JAX package's method):
whatever unpacks those bytes sees the same codes.
"""

from __future__ import annotations

import threading

import numpy as np

from ..utils.logging_utils import logger
from . import metrics as _metrics

__all__ = ["CanaryController", "inject_tensor", "science_hit"]

#: S/N-recovery-ratio histogram edges (measured / target)
_RATIO_EDGES = (0.25, 0.5, 0.75, 0.9, 1.1, 1.5, 2.0)
#: |DM error| histogram edges (pc cm^-3)
_DM_ERR_EDGES = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0)


class CanaryController:
    """Inject and match synthetic dispersed pulses.

    ``rate`` is the fraction of chunks injected (deterministic per
    chunk); ``dm=None`` resolves to the middle of the search range at
    :meth:`bind` time; ``snr`` is the matched-filter target S/N the
    amplitude is sized for; ``width_s=None`` resolves to two
    post-resample samples.  ``dm_tol=None`` derives the match radius
    from the emitted table's trial spacing.

    The driver owns the lifecycle: ``bind`` once the chunk geometry is
    known, ``maybe_inject`` per chunk on the reader thread, ``observe``
    per searched chunk, ``discard`` per quarantined chunk,
    ``summary``/``to_json`` at the end (and live, for ``/progress``).
    """

    def __init__(self, rate, dm=None, snr=12.0, width_s=None, seed=0,
                 dm_tol=None, window=20, beam=None):
        if not 0.0 <= float(rate) <= 1.0:
            raise ValueError(f"canary rate {rate!r} must be in [0, 1]")
        self.rate = float(rate)
        self.dm = None if dm is None else float(dm)
        self.snr = float(snr)
        self.width_s = None if width_s is None else float(width_s)
        self.seed = int(seed)
        self.dm_tol = None if dm_tol is None else float(dm_tol)
        self.window = int(window)
        # beam label: a labelled controller injects into its own
        # deterministic per-(seed, beam, chunk) subset, and every recall
        # gauge/counter carries beam=<label>; beam=None keeps the
        # unlabelled chunk selection and metric series
        self.beam = beam
        if beam is None:
            self._beam_key = None
        else:
            import zlib

            self._beam_key = (int(beam) if str(beam).lstrip("-").isdigit()
                              else zlib.crc32(str(beam).encode()))
        self._labels = {} if beam is None else {"beam": str(beam)}
        self._lock = threading.Lock()
        self._bound = False
        self._shifts = None
        self._resample = 1
        self._width = None          # raw samples
        self._pending = {}          # chunk -> expectation record
        self.injected = 0
        self.recovered = 0
        self.discarded = 0
        self._outcomes = []         # rolling 0/1 window (last `window`)
        # running aggregates, not lists: summary() runs on the hot
        # per-chunk path (health update + /progress scrapes) and must
        # stay O(1) over a multi-hour survey.  Distributions live in
        # the putpu_canary_snr_ratio / _dm_error histograms.
        self._ratio_n = 0
        self._ratio_sum = 0.0
        self._dmerr_n = 0
        self._dmerr_sum = 0.0
        self._dmerr_sumsq = 0.0
        self.curve = []             # (chunk, injected, cumulative recall)

    # -- geometry ------------------------------------------------------------

    def bind(self, *, nchan, start_freq, bandwidth, tsamp, dmmin=None,
             dmmax=None, resample=1):
        """Resolve the injected track for this survey's chunk geometry.

        Idempotent; the drivers call it once the reader header and chunk
        plan exist.  ``tsamp`` is the RAW (pre-resample) sample time —
        injection happens on raw blocks.
        """
        from ..ops.plan import dedispersion_shifts

        # under the lock end to end: a binder on another thread must not
        # see half-written track state
        with self._lock:
            if self._bound:
                return self
            if self.dm is None:
                if dmmin is None or dmmax is None:
                    raise ValueError("canary dm unset and no search DM "
                                     "range to derive it from")
                self.dm = round(0.5 * (float(dmmin) + float(dmmax)), 3)
            self._resample = max(int(resample), 1)
            if self.width_s is None:
                self._width = max(2 * int(resample), 2)
            else:
                self._width = max(int(round(self.width_s / tsamp)), 1)
            shifts = dedispersion_shifts(nchan, self.dm, start_freq,
                                         bandwidth, tsamp)
            # same rounding + roll-forward convention as models.simulate.
            # disperse_array — the search's dedisperse undoes exactly this
            self._shifts = np.rint(np.asarray(shifts)).astype(np.int64)
            self._bound = True
        logger.info("canary armed: rate=%.3g DM=%.2f target S/N=%.1f "
                    "width=%d raw samples", self.rate, self.dm, self.snr,
                    self._width)
        return self

    # -- injection (reader thread) -------------------------------------------

    def _rng_key(self, chunk, *extra):
        """Seed tuple: ``(seed, chunk, ...)`` unlabelled, ``(seed,
        beam_key, chunk, ...)`` per beam — deterministic across resume
        either way."""
        if self._beam_key is None:
            return (self.seed, int(chunk)) + extra
        return (self.seed, self._beam_key, int(chunk)) + extra

    def selects(self, chunk):
        """Deterministic per-chunk coin flip (stable across resume;
        per-beam subset when the controller carries a beam label)."""
        if self.rate <= 0.0:
            return False
        if self.rate >= 1.0:
            return True
        rng = np.random.default_rng(self._rng_key(chunk))
        return bool(rng.random() < self.rate)

    def injection(self, chunk, nsamp, sample):
        """The canary bump of ``chunk`` (``nsamp`` samples) when it is
        selected, else ``None``: ``(rows, cols, amps)``, the flat channel
        and sample indices of the injected track and the float64 amounts
        to add there.  ``sample`` is the ``(k, nchan)`` strided subsample
        of the chunk the noise scale is read from (every ``max(1, nsamp //
        65536)``-th sample, channels ascending; the reader thread never
        pays a full extra pass).  Each channel's float64 moments are
        accumulated sample by sample, in the order the JAX package's
        ``(nchan, k)`` view gives, so the scale is its bit for bit.
        Registers the pending expectation."""
        if not self._bound or not self.selects(chunk):
            return None
        nchan = sample.shape[1]
        rng = np.random.default_rng(self._rng_key(chunk, 1))
        t0 = int(rng.integers(0, nsamp))
        std = np.asarray(sample).std(axis=0, dtype=np.float64)
        std = np.where(std > 0, std, std[std > 0].mean() if
                       np.any(std > 0) else 1.0)
        # matched-filter sizing: amp_c = snr * std_c / sqrt(nchan * w)
        # (post-clean the per-channel scale divides out, the dedispersed
        # boxcar sums nchan*w samples of unit-ish noise)
        amp = self.snr * std / np.sqrt(nchan * self._width)
        cols = (t0 + self._shifts[:, None]
                + np.arange(self._width)[None, :]) % nsamp
        rows = np.repeat(np.arange(nchan), self._width)
        with self._lock:
            self._pending[int(chunk)] = {
                "chunk": int(chunk), "t0": t0, "nsamp": int(nsamp),
                "dm": self.dm, "snr": self.snr, "width": self._width}
        return rows, cols.ravel(), np.repeat(amp, self._width)

    def maybe_inject(self, block, chunk):
        """Inject the canary track into a copy of the host float ``block``
        ``(nchan, nsamp)`` when this chunk is selected; returns ``block``
        itself otherwise (the JAX package's reader-thread injection of
        its float64 blocks)."""
        if not self._bound or not self.selects(chunk):
            return block
        block = np.asarray(block)
        nsamp = block.shape[1]
        stride = max(1, nsamp // 65536)
        rows, cols, amps = self.injection(chunk, nsamp,
                                          block[:, ::stride].T)
        out = block.copy()
        out[rows, cols] += amps
        return out

    def maybe_inject_packed(self, frames, chunk, *, nbits, nchan,
                            band_descending=False):
        """Inject the canary track into PACKED low-bit frames ``(nsamps,
        bytes_per_frame)`` uint8 when this chunk is selected: a modified
        copy, else ``frames`` itself.

        The matched-filter amplitude is quantised into the codes: each lit
        ``(channel, sample)`` becomes ``clip(rint(code + amp_c), 0, 2^nbits
        - 1)``, and only its bits of the byte are rewritten.  Chunk
        selection, ``t0`` and the pending expectation are those of
        :meth:`maybe_inject` (the same rng keys); the noise scale is read
        from a strided decode of at most 4096 frames
        (:func:`~..io.lowbit.sample_codes`).  Counted as
        ``putpu_canary_packed_injections_total``."""
        if not self._bound or not self.selects(chunk):
            return frames
        from ..io.lowbit import sample_codes

        mask = (1 << nbits) - 1
        frames = np.asarray(frames)
        nsamp = frames.shape[0]
        rng = np.random.default_rng(self._rng_key(chunk, 1))
        t0 = int(rng.integers(0, nsamp))
        sub = sample_codes(frames, nbits, nchan)  # (nchan, k), file order
        if band_descending:
            sub = sub[::-1]  # ascending, like the shifts
        std = sub.astype(np.float64).std(axis=1)
        std = np.where(std > 0, std, std[std > 0].mean()
                       if np.any(std > 0) else 1.0)
        amp = self.snr * std / np.sqrt(nchan * self._width)
        cols = (t0 + self._shifts[:, None]
                + np.arange(self._width)[None, :]) % nsamp
        out = frames.copy()
        for c in range(nchan):
            fc = (nchan - 1 - c) if band_descending else c
            bi = (fc * nbits) // 8
            sh = (fc * nbits) % 8
            # channels share bytes below 8 bits: one channel at a time
            # keeps each read-modify-write whole
            b = out[cols[c], bi]
            code = (b >> sh) & mask
            bumped = np.clip(np.rint(code.astype(np.float64) + amp[c]),
                             0, mask).astype(np.uint8)
            out[cols[c], bi] = ((b & np.uint8(0xFF ^ (mask << sh)))
                                | (bumped << np.uint8(sh)))
        with self._lock:
            self._pending[int(chunk)] = {
                "chunk": int(chunk), "t0": t0, "nsamp": int(nsamp),
                "dm": self.dm, "snr": self.snr, "width": self._width}
        _metrics.counter("putpu_canary_packed_injections_total",
                         **self._labels).inc()
        return out

    # -- matching (main thread, after the search) ----------------------------

    def _tolerance(self, trial_dms):
        if self.dm_tol is not None:
            return self.dm_tol
        spacing = (float(np.median(np.abs(np.diff(trial_dms))))
                   if len(trial_dms) > 1 else 1.0)
        return max(3.0 * spacing, 0.015 * self.dm, 0.5)

    def _time_matches(self, exp, peak_resampled):
        """Is a row's dedispersed peak temporally consistent with the
        injection?  ``peak`` is the post-resample sample index of the
        row's best window; the injected boxcar dedisperses back to
        ``t0`` (raw samples), compared circularly (the roll convention
        wraps tracks mod nsamp).  The slop covers the boxcar width, the
        search's rebin granularity (windows up to 8 bins, peak recorded
        at the window start) and shift rounding."""
        peak_raw = float(peak_resampled) * self._resample
        nsamp = exp["nsamp"]
        d = abs(peak_raw - exp["t0"]) % nsamp
        d = min(d, nsamp - d)
        slop = max(4 * self._width, 16 * self._resample, 64)
        return d <= slop

    def observe(self, chunk, table, snr_threshold):
        """Match the emitted ``table`` against this chunk's pending
        injection.  Returns ``None`` when the chunk held no canary, else
        ``{"recovered", "snr", "ratio", "dm_error", "best_is_canary",
        "n_above_near", "canary_rows", "science_idx", "science_snr"}``
        (``canary_rows`` is the boolean mask of rows the injection lit
        — the identity track plus its DM sidelobes;
        ``science_idx``/``science_snr`` locate the strongest row OUTSIDE
        it, ``None`` when every row matches — the drivers promote that
        row when the canary outranks a genuine weaker pulse).

        Matching is on BOTH axes where the table allows it: trial DM
        within the tolerance AND the row's dedispersed peak temporally
        consistent with the injected ``t0`` — a real pulse that merely
        shares the canary's DM must neither score the canary as
        recovered nor be misclassified (and dropped) as the canary.
        Tables without a ``peak`` column fall back to DM-only matching.
        """
        with self._lock:
            exp = self._pending.pop(int(chunk), None)
        if exp is None:
            return None
        dms = np.asarray(table["DM"], dtype=np.float64)
        snrs = np.asarray(table["snr"], dtype=np.float64)
        tol = self._tolerance(dms)
        near = np.abs(dms - exp["dm"]) <= tol
        have_peaks = "peak" in table.colnames
        if have_peaks:
            peaks = np.asarray(table["peak"], dtype=np.float64)
            timely = np.array([self._time_matches(exp, p)
                               for p in peaks])
            near = near & timely
            # rows the injection LIT at ANY trial DM: mis-dedispersing
            # the canary at DM error d spreads its peak over the
            # residual per-channel delay, which is linear in d — so a
            # sidelobe row's peak must land between t0 and
            # t0 + d * (max shift per unit DM).  Amplitude-independent:
            # a very bright canary's far sidelobes are caught where any
            # fixed DM window would leak them (and a real pulse at a
            # different time is never swallowed)
            g = self._shifts / self.dm if self.dm else self._shifts * 0.0
            res = (exp["dm"] - dms)[:, None] * \
                np.array([float(g.min()), float(g.max())])[None, :]
            slop = max(4 * self._width, 16 * self._resample, 64)
            off = (peaks * self._resample - exp["t0"]
                   + 0.5 * exp["nsamp"]) % exp["nsamp"] \
                - 0.5 * exp["nsamp"]
            lit = ((off >= res.min(axis=1) - slop)
                   & (off <= res.max(axis=1) + slop)) | near
        else:
            # no peak column: fall back to a DM window (3x the match
            # radius covers typical-brightness sidelobes)
            lit = np.abs(dms - exp["dm"]) <= 3.0 * tol
        # the driver subtracts lit rows from the candidate-rate signal
        # so canaries don't inflate the RFI-storm detector's baseline
        n_above_near = int(np.count_nonzero(
            lit & (snrs > float(snr_threshold))))
        best_snr = float(snrs[near].max()) if np.any(near) else 0.0
        best_dm = (float(dms[near][int(np.argmax(snrs[near]))])
                   if np.any(near) else float("nan"))
        recovered = best_snr > float(snr_threshold)
        best_row = table.best_row()
        best_is_canary = bool(abs(float(best_row["DM"]) - exp["dm"])
                              <= tol)
        if best_is_canary and have_peaks and "peak" in best_row:
            best_is_canary = self._time_matches(exp, best_row["peak"])
        # the science view: the best row among rows the injection did
        # NOT light — when the canary outranks a genuine weaker pulse
        # in the same chunk, the driver promotes this row instead of
        # dropping the whole chunk's detection
        science_idx = science_snr = None
        if np.any(~lit):
            others = np.where(lit, -np.inf, snrs)
            science_idx = int(np.argmax(others))
            science_snr = float(others[science_idx])
        ratio = best_snr / exp["snr"] if exp["snr"] else 0.0
        dm_error = (best_dm - exp["dm"]) if recovered else float("nan")
        with self._lock:
            self.injected += 1
            self.recovered += int(recovered)
            self._outcomes.append(int(recovered))
            if len(self._outcomes) > self.window:
                self._outcomes.pop(0)
            if recovered:
                self._ratio_n += 1
                self._ratio_sum += ratio
                if np.isfinite(dm_error):
                    self._dmerr_n += 1
                    self._dmerr_sum += dm_error
                    self._dmerr_sumsq += dm_error * dm_error
            recall = self.recovered / self.injected
            self.curve.append((int(chunk), self.injected,
                               round(recall, 4)))
        _metrics.counter("putpu_canary_injected_total",
                         **self._labels).inc()
        if recovered:
            _metrics.counter("putpu_canary_recovered_total",
                             **self._labels).inc()
            _metrics.histogram("putpu_canary_snr_ratio",
                               edges=_RATIO_EDGES,
                               **self._labels).observe(ratio)
            _metrics.histogram("putpu_canary_dm_error",
                               edges=_DM_ERR_EDGES,
                               **self._labels).observe(abs(dm_error))
        else:
            _metrics.counter("putpu_canary_missed_total",
                             **self._labels).inc()
            logger.warning("canary MISSED in %schunk %s: best S/N %.2f "
                           "within ±%.2f of DM %.2f (threshold %.2f)",
                           f"beam {self.beam} " if self.beam is not None
                           else "", chunk, best_snr, tol, exp["dm"],
                           float(snr_threshold))
        _metrics.gauge("putpu_canary_recall",
                       **self._labels).set(round(recall, 4))
        _metrics.gauge("putpu_canary_window_recall", **self._labels).set(
            round(sum(self._outcomes) / len(self._outcomes), 4))
        return {"recovered": recovered, "snr": best_snr, "ratio": ratio,
                "dm_error": dm_error, "best_is_canary": best_is_canary,
                "n_above_near": n_above_near, "canary_rows": lit,
                "science_idx": science_idx, "science_snr": science_snr}

    def tag_hit(self, chunk):
        """The driver excluded a chunk's best row because it was this
        chunk's canary — counted, logged, never persisted (any genuine
        weaker pulse in the chunk is promoted separately)."""
        _metrics.counter("putpu_canary_tagged_hits_total",
                         **self._labels).inc()
        logger.info("canary hit in chunk %s tagged and excluded from "
                    "the candidate files/ledger", chunk)

    def discard(self, chunk):
        """Drop a pending injection whose chunk never reached the search
        (quarantined / unreadable) — it must not count as a miss."""
        with self._lock:
            if self._pending.pop(int(chunk), None) is not None:
                self.discarded += 1
                _metrics.counter("putpu_canary_discarded_total",
                                 **self._labels).inc()

    # -- summaries -----------------------------------------------------------

    def summary(self):
        """Live JSON-ready summary (``/progress``, the health engine,
        the survey report)."""
        with self._lock:
            injected = self.injected
            recovered = self.recovered
            outcomes = list(self._outcomes)
            out = {
                **({"beam": self.beam} if self.beam is not None else {}),
                "rate": self.rate, "dm": self.dm, "target_snr": self.snr,
                "width_samples": self._width, "injected": injected,
                "recovered": recovered, "discarded": self.discarded,
                "recall": (round(recovered / injected, 4)
                           if injected else None),
                "window": self.window,
                "window_recall": (round(sum(outcomes) / len(outcomes), 4)
                                  if outcomes else None),
                "snr_ratio_mean": (round(self._ratio_sum / self._ratio_n,
                                         4) if self._ratio_n else None),
                "dm_error_mean": (round(self._dmerr_sum / self._dmerr_n,
                                        4) if self._dmerr_n else None),
                "dm_error_rms": (round(float(np.sqrt(
                    self._dmerr_sumsq / self._dmerr_n)), 4)
                    if self._dmerr_n else None),
            }
        return out

    def to_json(self):
        """Summary plus the full recall curve (the report artifact)."""
        out = self.summary()
        with self._lock:
            out["curve"] = [list(p) for p in self.curve]
        return out


def inject_tensor(block, bump):
    """Add an :meth:`CanaryController.injection` bump to the float32
    ``block`` tensor in place, on its device: each lit sample becomes
    ``float32(float64(x) + amp)``, the value the JAX package's float64
    host block holds after its injection and float32 upload.  Returns
    ``block``."""
    import torch

    rows, cols, amps = (torch.from_numpy(a).to(block.device) for a in bump)
    block[rows, cols] = (block[rows, cols].to(torch.float64)
                         + amps).to(block.dtype)
    return block


def science_hit(canary, observed, istart, table, snr_threshold, where):
    """The hit decision of every driver once ``canary`` has observed
    chunk ``istart``'s ``table`` (``observed``: the result of
    :meth:`CanaryController.observe`, None without a canary or an
    injection), by the containment rules above.  Returns ``(is_hit,
    science table, best row, promoted row index or None)``:

    * a best row over the threshold that is the canary tags the chunk;
      the strongest unlit row is promoted if it still clears the
      threshold (its table without the canary-lit rows, counted as
      ``putpu_canary_promoted_hits_total``), else the chunk is no hit;
    * a real best row beside a recovered canary is a hit whose table
      holds the canary-lit rows (``putpu_canary_contaminated_tables_total``).

    ``where`` names the chunk in the log lines."""
    best = table.best_row()
    is_hit = bool(best["snr"] > snr_threshold)
    if not is_hit or observed is None:
        return is_hit, table, best, None
    if observed["best_is_canary"]:
        canary.tag_hit(istart)
        idx = observed["science_idx"]
        if idx is None or not observed["science_snr"] > float(snr_threshold):
            return False, table, best, None
        keep = ~observed["canary_rows"]
        sci_table = type(table)({name: table[name][keep]
                                 for name in table.colnames},
                                meta=table.meta)
        best = {name: table[name][idx] for name in table.colnames}
        _metrics.counter("putpu_canary_promoted_hits_total").inc()
        logger.info(
            "%s: canary outranked a genuine pulse — promoted the science "
            "best row (DM=%.2f snr=%.2f), canary rows dropped from its "
            "table", where, float(best["DM"]), float(best["snr"]))
        return True, sci_table, best, int(idx)
    if observed["recovered"]:
        _metrics.counter("putpu_canary_contaminated_tables_total").inc()
        logger.info(
            "%s: real hit alongside a recovered canary — trial rows near "
            "DM %.1f in its table include synthetic signal", where,
            canary.dm)
    return True, table, best, None
