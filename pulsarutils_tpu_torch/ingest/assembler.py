"""The live feed's ring-buffer assembler: wire packets -> search chunks.

:class:`ChunkAssembler` turns the packets of :mod:`..io.packets` into the
fixed-geometry ``(istart, chunk)`` pairs
:func:`~..parallel.stream.stream_search` consumes, and survives what a
feed does that a file never does:

* **reordering** within a bounded window: a chunk is cut only once the
  stream's watermark is ``reorder_window`` samples past its end, so a
  straggler still lands in place;
* **gaps**: missing samples are zero-filled and counted per chunk through
  the integrity policy (:func:`~..faults.policy.
  resolve_integrity_policy`): a loss under the threshold is delivered
  (*sanitized*), a larger one quarantines the chunk as ``feed_gap``;
* **overrun**: when the search falls behind, the ready queue drops its
  **oldest** chunk whole, journaled as ``shed_overrun``
  (:class:`~..resilience.shedding.ShedPolicy`); ``push()`` never waits
  on the consumer, so a wedged search cannot block the socket reader;
* **duplicates, corruption, late arrivals**: counted, never written
  twice; a CRC-rejected packet's samples never arrive and become a gap.

One condition variable guards ring, queue and ledger; ``push()`` (the
reader thread) and :meth:`ChunkAssembler.chunks` (the search thread) are
its two sides, and every wait is bounded.  A chunk leaves as a host array
COPIED out of the ring (the ring's rows are reused at once, and
``stream_search`` uploads one chunk ahead), or as a
:class:`~..io.lowbit.PackedFrames` of a packed feed, unpacked on the card
by the search.  No CUDA call is made here.

:class:`IngestLedger` holds the proof obligation: every observed sample
ends delivered, shed or quarantined, so ``unaccounted() == 0`` after a
drained run.  The ``putpu_ingest_*`` counters are declared in
:mod:`..obs.names`.
"""

from __future__ import annotations

import collections
import logging
import threading

import numpy as np

from ..faults import reasons as _reasons
from ..faults.policy import resolve_integrity_policy
from ..io.lowbit import PackedFrames
from ..io.packets import frame_nbytes
from ..obs import metrics as _metrics
from ..resilience.shedding import resolve_shed_policy

__all__ = ["IngestLedger", "ChunkAssembler"]

logger = logging.getLogger("pulsarutils_tpu_torch.ingest")


def _ascending_block(rows, descending, tile=256):
    """A new C-contiguous ``(nchan, n)`` block of ``(n, nchan)`` frame
    rows, channels flipped for a descending wire.  The transposing copy
    runs ``tile`` rows at a time: three times faster than one whole-array
    copy of a 1 GB chunk, which the reader thread makes under the lock."""
    n, nchan = rows.shape
    out = np.empty((nchan, n), dtype=rows.dtype)
    src = rows[:, ::-1] if descending else rows
    for i in range(0, n, tile):
        out[:, i:i + tile] = src[i:i + tile].T
    return out


class IngestLedger:
    """Exact sample accounting for one feed session.

    Two orthogonal axes, both in samples over cut chunk spans:

    * arrival: ``arrived + gap_filled == observed``
    * disposition: ``delivered + shed + quarantined + queued ==
      observed`` (``queued`` drains to ``delivered``/``shed`` by the
      end of the run)

    ``journal`` mirrors every loss-bearing manifest record
    (``feed_gap`` / ``shed_overrun``) so a test can audit the manifest
    against the ledger without re-reading the jsonl.
    """

    def __init__(self):
        self.observed = 0
        self.arrived = 0
        self.gap_filled = 0
        self.delivered = 0
        self.shed = 0
        self.quarantined = 0
        self.journal = []

    def unaccounted(self, queued_samples=0):
        """Samples not yet classified on the disposition axis; 0 after
        a drained run."""
        return self.observed - self.delivered - self.shed \
            - self.quarantined - int(queued_samples)

    def to_json(self):
        return {"observed": self.observed, "arrived": self.arrived,
                "gap_filled": self.gap_filled,
                "delivered": self.delivered, "shed": self.shed,
                "quarantined": self.quarantined,
                "unaccounted": self.unaccounted(),
                "journal_records": len(self.journal)}


class ChunkAssembler:
    """Assemble wire packets into fixed-geometry search chunks.

    Parameters
    ----------
    nchan, step:
        chunk geometry: every delivered chunk is ``(nchan, step)``
        float32 (``nbits`` 0) or a :class:`~..io.lowbit.PackedFrames`
        of ``step`` frames (``nbits`` 1/2/4) — non-overlapping starts
        ``0, step, 2*step, ...`` plus ``start_sample``.
    nbits, band_descending:
        payload depth and *wire* channel order; packets must match
        exactly (mismatches count as invalid, their samples become
        gaps).  Delivered chunks are always search-ready **ascending**
        order: float frames from a descending wire are flipped at cut
        time, packed frames carry the flag into the device unpack —
        either way the consumer never needs to know the wire's
        convention.
    reorder_window:
        straggler tolerance in samples: chunk ``[s, s+step)`` is cut
        when the watermark reaches ``s + step + reorder_window``.
    policy:
        integrity-policy spelling (:func:`~..faults.policy.
        resolve_integrity_policy`): under ``"sanitize"`` a lossy chunk
        with missing fraction <= ``max_zero_frac`` is delivered
        zero-filled, above it quarantines as ``feed_gap``; under
        ``"strict"`` any missing sample quarantines; ``"off"``
        delivers everything.
    shed:
        admission-control spelling (:func:`~..resilience.shedding.
        resolve_shed_policy`): ready-queue bound; overflow drops the
        oldest queued chunk, journaled ``shed_overrun``.
    manifest:
        optional :class:`~..faults.policy.QuarantineManifest` that
        receives ``feed_gap`` / ``shed_overrun`` records.
    health:
        optional :class:`~..obs.health.HealthEngine`; each cut chunk
        feeds the ingest conditions (gap fraction, overrun,
        disconnects).
    lineage:
        optional :class:`~..obs.lineage.LineageRecorder`; the chunk's
        ``read`` stage is stamped at *first packet arrival*, so
        candidate latency is measured from the antenna (the recorder's
        first-stamp-wins idempotency makes ``stream_search``'s own
        later mark a no-op).
    """

    def __init__(self, *, nchan, step, nbits=0, band_descending=False,
                 reorder_window=1024, policy="sanitize", shed=8,
                 manifest=None, health=None, lineage=None,
                 start_sample=0, wait_poll_s=0.2):
        self.nchan = int(nchan)
        self.step = int(step)
        self.nbits = int(nbits)
        self.band_descending = bool(band_descending)
        self.reorder_window = int(reorder_window)
        self.policy = resolve_integrity_policy(policy)
        self.shed = resolve_shed_policy(shed)
        self.manifest = manifest
        self.health = health
        self.lineage = lineage
        self.wait_poll_s = float(wait_poll_s)

        self._width = (self.nchan if self.nbits == 0
                       else frame_nbytes(self.nchan, self.nbits))
        self._dtype = np.float32 if self.nbits == 0 else np.uint8
        cap = self.step + self.reorder_window
        # round capacity up to whole chunks so a chunk's rows are a
        # contiguous-modulo block and a cut never straddles stale rows
        self._cap = ((cap + self.step - 1) // self.step) * self.step
        self._buf = np.zeros((self._cap, self._width), dtype=self._dtype)
        self._present = np.zeros(self._cap, dtype=bool)

        self._cond = threading.Condition(threading.Lock())
        self._queue = collections.deque()   # (istart, block, owned)
        self.ledger = IngestLedger()
        self._next_start = int(start_sample)
        self._watermark = int(start_sample)
        self._closed = False
        self._pending_disconnects = 0
        self._pending_sheds = 0
        self._chunk_nbytes = self.step * self._width \
            * np.dtype(self._dtype).itemsize

        self.packets = 0
        self.invalid = 0
        self.duplicates = 0
        self.reordered = 0
        self.reconnects = 0

    # -- reader side (the socket thread; never blocks on the consumer) -------

    def note_invalid(self, n=1):
        """Count packets the source could not decode (bad header, CRC
        reject) — their samples surface later as gaps."""
        with self._cond:
            self.invalid += int(n)
        _metrics.counter("putpu_ingest_packets_invalid_total").inc(int(n))

    def note_disconnect(self):
        """Count a source disconnect + successful reconnect; folded
        into the next cut chunk's health update."""
        with self._cond:
            self.reconnects += 1
            self._pending_disconnects += 1
        _metrics.counter("putpu_ingest_reconnects_total").inc()

    def push(self, packet):
        """Fold one decoded :class:`~..io.packets.Packet` into the
        ring.  Returns the number of newly-placed samples.  Bounded
        work under the lock; never waits for the consumer."""
        with self._cond:
            self.packets += 1
            _metrics.counter("putpu_ingest_packets_total").inc()
            _metrics.counter("putpu_ingest_bytes_total").inc(
                len(packet.payload))
            if (packet.nbits != self.nbits
                    or packet.nchan != self.nchan
                    or packet.chan0 != 0
                    or packet.band_descending != self.band_descending):
                self.invalid += 1
                _metrics.counter(
                    "putpu_ingest_packets_invalid_total").inc()
                return 0
            s0 = int(packet.sample0)
            end = s0 + int(packet.nsamps)
            if s0 < self._watermark:
                # straggler: behind the stream's leading edge (late,
                # reordered or duplicated — disambiguated below)
                self.reordered += 1
                _metrics.counter(
                    "putpu_ingest_packets_reordered_total").inc()
            # a far-future packet must not lap the ring: force-cut
            # (zero-filling what never arrived) until it fits
            while end > self._next_start + self._cap:
                self._cut_locked()
            lo = max(s0, self._next_start)
            placed = 0
            if lo < end:
                idx = (np.arange(lo, end) % self._cap)
                fresh = ~self._present[idx]
                if fresh.any():
                    rows = packet.frames()[lo - s0:]
                    self._buf[idx[fresh]] = rows[fresh]
                    self._present[idx[fresh]] = True
                    placed = int(fresh.sum())
            if placed == 0:
                self.duplicates += 1
                _metrics.counter(
                    "putpu_ingest_packets_duplicate_total").inc()
            if self.lineage is not None and placed:
                # stamp the covered chunks' "read" stage at the antenna:
                # first packet wins (LineageRecorder.mark is idempotent)
                first = (max(s0, self._next_start) // self.step) \
                    * self.step
                for cs in range(first, end, self.step):
                    if cs >= self._next_start:
                        self.lineage.mark(cs, "read")
            self._watermark = max(self._watermark, end)
            while self._watermark >= self._next_start + self.step \
                    + self.reorder_window:
                self._cut_locked()
            self._cond.notify_all()
            return placed

    def close(self, *, flush=True):
        """End of feed: optionally cut the final (possibly partial)
        chunk, then wake the consumer for its drain-and-stop."""
        with self._cond:
            if flush:
                while self._watermark >= self._next_start + self.step:
                    self._cut_locked()
                if self._watermark > self._next_start:
                    self._cut_locked(
                        length=self._watermark - self._next_start)
            self._closed = True
            self._cond.notify_all()

    # -- cut + admission (both under self._cond) -----------------------------

    def _cut_locked(self, length=None):
        s = self._next_start
        n = self.step if length is None else int(length)
        lo = s % self._cap
        # the capacity is whole chunks, so a chunk's rows are one block of
        # the ring (a slice, a view) unless the stream began mid-chunk: a
        # 1 GB chunk cut through an index array held the lock for seconds
        at = (slice(lo, lo + n) if lo + n <= self._cap
              else np.arange(s, s + n) % self._cap)
        present = self._present[at].copy()
        arrived = int(present.sum())
        missing = n - arrived
        gap_frac = missing / float(n)
        # zero-fill the gaps; the chunk is copied out before the rows are
        # recycled below
        rows = self._buf[at]
        if missing:
            rows[~present] = 0
        self._next_start = s + n
        self._watermark = max(self._watermark, self._next_start)

        led = self.ledger
        led.observed += n
        led.arrived += arrived
        led.gap_filled += missing
        _metrics.counter("putpu_ingest_chunks_total").inc()
        if missing:
            _metrics.counter("putpu_ingest_gap_samples_total").inc(
                missing)

        verdict = "clean"
        if missing and self.policy is not None:
            if not self.policy.sanitize \
                    or gap_frac > self.policy.max_zero_frac:
                verdict = "quarantine"
            else:
                verdict = "sanitized"
        if verdict == "quarantine":
            led.quarantined += n
            rec = {"chunk": s, "end": s + n,
                   "reason": _reasons.FEED_GAP, "samples": n,
                   "missing_samples": missing,
                   "missing_frac": round(gap_frac, 6)}
            led.journal.append(rec)
            _metrics.counter(
                "putpu_ingest_chunks_quarantined_total").inc()
            if self.manifest is not None:
                self.manifest.record(
                    s, s + n, _reasons.FEED_GAP,
                    {"missing_samples": missing,
                     "missing_frac": round(gap_frac, 6)})
            if self.lineage is not None:
                self.lineage.discard(s)
            logger.error(
                "feed chunk %d-%d QUARANTINED (%s): %d/%d samples "
                "missing", s, s + n, _reasons.FEED_GAP, missing, n)
        else:
            if verdict == "sanitized":
                logger.warning(
                    "feed chunk %d-%d sanitized: %d/%d samples "
                    "zero-filled", s, s + n, missing, n)
            if self.nbits == 0:
                # delivered chunks are always *search-ready ascending*
                # channel order, whatever the wire carried — the float
                # mirror of the packed path, whose device unpack flips
                # descending frames the same way
                block = _ascending_block(rows, self.band_descending)
            else:
                block = PackedFrames(np.array(rows), self.nbits,
                                     self.nchan,
                                     band_descending=self.band_descending)
        self._present[at] = False
        self._buf[at] = 0
        if verdict != "quarantine":
            self._admit_locked(s, block, n)

        if self.health is not None:
            self.health.update(
                s, ingest_gap_frac=gap_frac,
                ingest_overrun=self._pending_sheds,
                ingest_disconnects=self._pending_disconnects)
            self._pending_sheds = 0
            self._pending_disconnects = 0

    def _admit_locked(self, s, block, owned):
        while self.shed.should_shed(len(self._queue),
                                    self._chunk_nbytes) \
                and self._queue:
            old_s, _old_block, old_owned = self._queue.popleft()
            led = self.ledger
            led.shed += old_owned
            self._pending_sheds += 1
            rec = {"chunk": old_s, "end": old_s + old_owned,
                   "reason": _reasons.SHED_OVERRUN,
                   "samples": old_owned}
            led.journal.append(rec)
            _metrics.counter("putpu_ingest_chunks_shed_total").inc()
            _metrics.counter("putpu_ingest_shed_samples_total").inc(
                old_owned)
            if self.manifest is not None:
                self.manifest.record(
                    old_s, old_s + old_owned, _reasons.SHED_OVERRUN,
                    {"samples": old_owned,
                     "queued": len(self._queue)})
            if self.lineage is not None:
                self.lineage.discard(old_s)
            logger.warning(
                "feed chunk %d-%d SHED (%s): search is %d chunks "
                "behind the feed", old_s, old_s + old_owned,
                _reasons.SHED_OVERRUN, len(self._queue) + 1)
        self._queue.append((s, block, owned))

    # -- consumer side (the search thread) -----------------------------------

    def chunks(self):
        """Lazy ``(istart, chunk)`` iterator for ``stream_search``:
        blocks (bounded poll) until a chunk is ready, ends after
        :meth:`close` once the queue drains."""
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait(self.wait_poll_s)
                if not self._queue and self._closed:
                    return
                s, block, owned = self._queue.popleft()
                self.ledger.delivered += owned
                self._cond.notify_all()
            yield s, block

    # -- read side ------------------------------------------------------------

    def queued(self):
        with self._cond:
            return len(self._queue)

    def summary(self):
        """JSON-ready session summary (the report's "Ingest" section)."""
        with self._cond:
            queued_samples = sum(o for _s, _b, o in self._queue)
            doc = {
                "packets": self.packets,
                "invalid_packets": self.invalid,
                "duplicate_packets": self.duplicates,
                "reordered_packets": self.reordered,
                "reconnects": self.reconnects,
                "queued_chunks": len(self._queue),
                "ledger": dict(self.ledger.to_json(),
                               unaccounted=self.ledger.unaccounted(
                                   queued_samples)),
            }
        return doc
