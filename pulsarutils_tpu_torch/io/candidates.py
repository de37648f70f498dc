"""Candidate store with a deterministic resume ledger.

Candidates are npz records (:class:`..pipeline.pulse_info.PulseInfo` plus
the chunk's full result table) named ``{root}_{istart}-{iend}``; a
``progress_<fingerprint>.json`` ledger records every processed chunk (hit
or not), so a restarted search skips exactly the work already done.  A
fleet worker's store carries its lease's epoch (``fence=``): its artifact
writes go through :meth:`CandidateStore.fenced_write`, which refuses to
overwrite what a session of a higher epoch wrote.  The file formats, the
fence map ``fence_<fingerprint>.json`` and its lock file included, are
the JAX package's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import logging
import os
import time

import numpy as np
import torch

from ..faults import inject as fault_inject
from ..obs import metrics as _metrics
from ..ops.plan import delta_delay
from ..ops.rebin import quick_resample
from ..pipeline.pulse_info import PulseInfo
from ..utils.device import to_numpy
from ..utils.table import ResultTable
from .atomic import atomic_write_json

logger = logging.getLogger("pulsarutils_tpu_torch")


def config_fingerprint(**kwargs):
    """Stable hash of the search configuration; a resume ledger is only
    valid for identical configuration."""
    blob = json.dumps(kwargs, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class CandidateStore:
    """``fingerprint=None`` disables the resume ledger: every chunk reports
    not-done and nothing is recorded.

    ``fence`` is a fleet lease's epoch, the fencing token: with it (and a
    fingerprint) every artifact write consults ``fence_<fingerprint>.json``
    and is refused when another session stamped that artifact with a
    higher epoch, so a partitioned worker whose lease was stolen cannot
    overwrite the new owner's output.  ``fence=None`` reads and writes no
    fence file."""

    #: persisted-waterfall element budget: above it the store keeps a
    #: window around the pulse instead of the whole chunk
    WATERFALL_BUDGET = 1 << 22

    def __init__(self, directory, fingerprint=None, fence=None):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.fingerprint = fingerprint
        self.fence = int(fence) if fence is not None else None
        self._fence_path = (
            os.path.join(self.directory, f"fence_{fingerprint}.json")
            if self.fence is not None and fingerprint is not None
            else None)
        #: artifact writes this session refused under the fence
        self.fenced_rejects = 0
        if fingerprint is None:
            self._ledger_path = None
            self._ledger = {"fingerprint": None, "done": []}
        else:
            self._ledger_path = os.path.join(
                self.directory, f"progress_{fingerprint}.json")
            self._ledger = self._load_ledger()
        #: ``(size, mtime_ns)`` of this store's last ledger write: while
        #: the file still matches it nobody else wrote, and
        #: :meth:`_merge_from_disk` skips the read
        self._last_write_stat = None

    def _load_ledger(self):
        """Load the ledger; a torn or corrupt file (a parse or shape
        failure) is backed up to ``<ledger>.corrupt`` — or logged as
        ``<unremovable>`` when it cannot be moved — and a fresh ledger
        starts (done chunks are then searched again).  An ``OSError``
        reading an intact file propagates."""
        if os.path.exists(self._ledger_path):
            try:
                with open(self._ledger_path) as f:
                    ledger = json.load(f)
                if not isinstance(ledger, dict) \
                        or not isinstance(ledger.get("done"), list):
                    raise ValueError("ledger is not a {fingerprint, done} "
                                     "record")
                return ledger
            except ValueError as exc:
                backup = self._ledger_path + ".corrupt"
                try:
                    os.replace(self._ledger_path, backup)
                except OSError:
                    backup = "<unremovable>"
                logger.warning("torn/corrupt resume ledger %s (%r): backed "
                               "up to %s, starting a fresh ledger",
                               self._ledger_path, exc, backup)
        return {"fingerprint": self.fingerprint, "done": []}

    def is_done(self, istart):
        if self.fingerprint is None:
            return False
        return istart in self._ledger["done"]

    def mark_done(self, istart, reason=None):
        """Record a chunk as processed.  ``reason`` marks it done **with a
        reason** (quarantined or persist-dead-lettered): never searched
        again on resume, the reason kept for the audit.  The ``done`` list
        stays sorted; the ``quarantined`` map (keys sorted numerically)
        appears only once a reason is recorded, so a clean run's ledger
        has no such key.

        Each write first unions the ledger on disk into this one
        (:meth:`_merge_from_disk`): two stores sharing a fingerprint (two
        service jobs over one file and physics) each keep the other's
        chunks, and the sorted union is the bytes a serial run writes."""
        if self.fingerprint is None:
            return
        quarantined = self._ledger.get("quarantined", {})
        if istart in self._ledger["done"] and (
                reason is None or quarantined.get(str(istart)) == reason):
            return
        if istart not in self._ledger["done"]:
            self._ledger["done"].append(int(istart))
        if reason is not None:
            self._ledger.setdefault("quarantined", {})[str(istart)] = \
                str(reason)
        self._merge_from_disk()
        self._ledger["done"].sort()
        if "quarantined" in self._ledger:
            q = self._ledger["quarantined"]
            # a non-numeric key (a hand-edited ledger) sorts after the
            # numeric ones instead of failing every write
            self._ledger["quarantined"] = {
                k: q[k] for k in sorted(
                    q, key=lambda k: (0, int(k), "") if
                    str(k).lstrip("-").isdigit() else (1, 0, str(k)))}
        atomic_write_json(self._ledger_path, self._ledger)
        try:
            st = os.stat(self._ledger_path)
            self._last_write_stat = (st.st_size, st.st_mtime_ns)
        except OSError:
            self._last_write_stat = None

    def _merge_from_disk(self):
        """Union the ledger on disk into the one in memory (chunks are
        only ever added, so the last writer loses nothing).

        A torn or unreadable file is not merged (memory wins; recovery
        is :meth:`_load_ledger`'s).  While the file's ``(size,
        mtime_ns)`` still match this store's last write, nobody else
        wrote and the read is skipped: a single-process run pays one
        ``stat`` a chunk."""
        try:
            if self._last_write_stat is not None:
                st = os.stat(self._ledger_path)
                if (st.st_size, st.st_mtime_ns) == self._last_write_stat:
                    return
            with open(self._ledger_path) as f:
                disk = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(disk, dict):
            return
        done = disk.get("done")
        if isinstance(done, list):
            have = set(self._ledger["done"])
            self._ledger["done"].extend(
                c for c in done if isinstance(c, int) and c not in have)
        quarantined = disk.get("quarantined")
        if isinstance(quarantined, dict):
            mine = self._ledger.setdefault("quarantined", {})
            for key, val in quarantined.items():
                mine.setdefault(key, val)

    @property
    def done_chunks(self):
        return sorted(self._ledger["done"])

    @property
    def quarantined_chunks(self):
        """``{str(istart): reason}`` for chunks marked done with a
        reason."""
        return dict(self._ledger.get("quarantined", {}))

    def _base(self, root, istart, iend):
        return os.path.join(self.directory, f"{root}_{istart}-{iend}")

    def save_candidate(self, root, istart, iend, info, table):
        fault_inject.fire("persist", chunk=istart)
        base = self._base(root, istart, iend)

        def write():
            self.trim_waterfall(info, table).save(base + ".info.npz")
            table.to_npz(base + ".table.npz")

        self.fenced_write(base, write)
        return base

    def save_lineage(self, root, istart, iend, doc):
        """Write a candidate's lineage doc beside its npz pair,
        ``{base}.lineage.json`` (atomic; indented and key-sorted as the
        JAX package writes it), under the same fence as the pair.  Only
        called when lineage is armed."""
        base = self._base(root, istart, iend)

        def write():
            atomic_write_json(base + ".lineage.json", doc, indent=2,
                              sort_keys=True, trailing_newline=True)

        self.fenced_write(base, write)
        return base + ".lineage.json"

    # -- the artifact fence --------------------------------------------------

    def fenced_write(self, path, write_fn):
        """Run ``write_fn()``, which writes the artifact at ``path``, under
        the epoch fence; returns True when it ran.

        An unfenced store just runs it.  A fenced one holds a
        cross-process lock file around check, write and stamp, so a
        zombie cannot pass the check before the new owner stamps and
        land its bytes after, and two stamps cannot lose the higher
        epoch."""
        if self._fence_path is None:
            write_fn()
            return True
        with self._fence_lock():
            if not self._fence_admits(path):
                return False
            write_fn()
            self._fence_stamp(path)
        return True

    @contextlib.contextmanager
    def _fence_lock(self, timeout_s=30.0):
        """An ``O_EXCL`` lock file beside the fence map (the primitive
        that works on the fleet's shared filesystems).  A lock held past
        ``timeout_s`` is taken as abandoned (its holder killed mid-write)
        and broken with a warning."""
        lock_path = self._fence_path + ".lock"
        deadline = time.monotonic() + timeout_s
        fd = None
        while fd is None:
            try:
                fd = os.open(lock_path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                if time.monotonic() >= deadline:
                    logger.warning(
                        "breaking abandoned fence lock %s (held past "
                        "%.0fs)", lock_path, timeout_s)
                    try:
                        os.unlink(lock_path)
                    except OSError:
                        pass
                    deadline = time.monotonic() + timeout_s
                else:
                    time.sleep(0.05)
        try:
            yield
        finally:
            os.close(fd)
            try:
                os.unlink(lock_path)
            except OSError:
                pass

    def _read_fence(self):
        """``{artifact base name: epoch}`` from disk; an unreadable or
        torn map reads as nothing stamped (the worst case is an allowed
        write of the same bytes, never a lost artifact)."""
        try:
            with open(self._fence_path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return {}
        epochs = doc.get("epochs") if isinstance(doc, dict) else None
        if not isinstance(epochs, dict):
            return {}
        return {str(k): int(v) for k, v in epochs.items()
                if isinstance(v, int)}

    def _fence_admits(self, base):
        """False when another session stamped ``base`` with a higher
        epoch: this session's lease was stolen and the new owner wrote."""
        name = os.path.basename(base)
        stamped = self._read_fence().get(name)
        if stamped is not None and stamped > self.fence:
            self.fenced_rejects += 1
            _metrics.counter("putpu_fleet_fenced_writes_total").inc()
            logger.warning(
                "fenced write rejected: %s is stamped epoch %d, this "
                "session holds epoch %d (lease stolen; the new owner's "
                "artifact stands)", name, stamped, self.fence)
            return False
        return True

    def _fence_stamp(self, base):
        """Record this session's epoch for ``base``, keeping the larger
        of the two per artifact (the caller holds the lock)."""
        name = os.path.basename(base)
        epochs = self._read_fence()
        epochs[name] = max(epochs.get(name, 0), self.fence)
        atomic_write_json(self._fence_path,
                          {"schema_version": 1,
                           "epochs": dict(sorted(epochs.items()))})

    def trim_waterfall(self, info, table):
        """Bound the persisted record: full chunk in, pulse cutout out.

        The window covers the dispersed track, ``[peak - pad, peak + span
        + pad]`` with ``span`` the band-crossing delay at the candidate's
        DM, taken circularly (the sweep's wrap continues a track past the
        chunk end at its start), then block-sum decimated if still over
        budget.  ``info`` is untouched; a trimmed copy is returned (or
        ``info`` itself when already under budget).  A device waterfall
        is sliced on the device, so only the cutout crosses to the host.
        """
        wf = info.allprofs
        if wf is None or np.prod(wf.shape) <= self.WATERFALL_BUDGET:
            return info
        nbin = wf.shape[1]
        tsamp = (1.0 / (info.pulse_freq * info.nbin)
                 if info.pulse_freq and info.nbin else None)
        best = table.best_row()
        peak = int(best["peak"]) if "peak" in table.colnames else nbin // 2
        span = 256
        if tsamp and info.start_freq and info.bandwidth and best["DM"]:
            span = int(delta_delay(float(best["DM"]), info.start_freq,
                                   info.start_freq + info.bandwidth)
                       / tsamp) + 1
        pad = max(span // 2, 256)
        lo = peak - pad
        hi = peak + span + pad
        if hi - lo >= nbin:
            lo, hi = 0, nbin
        if lo >= 0 and hi <= nbin:
            cut = to_numpy(wf[:, lo:hi])
        else:
            cols = np.arange(lo, hi) % nbin
            if isinstance(wf, torch.Tensor):
                cols = torch.from_numpy(cols).to(wf.device)
            cut = to_numpy(wf[:, cols])
            lo = lo % nbin
        decim = 1
        if cut.size > self.WATERFALL_BUDGET:
            decim = -(-cut.size // self.WATERFALL_BUDGET)
            cut = to_numpy(quick_resample(torch.from_numpy(cut), decim))
        return dataclasses.replace(info, allprofs=cut, cutout_start=lo,
                                   cutout_decim=decim)

    def load_candidate(self, root, istart, iend):
        base = self._base(root, istart, iend)
        return (PulseInfo.load(base + ".info.npz"),
                ResultTable.from_npz(base + ".table.npz"))

    def candidates(self):
        """Yield ``(root, istart, iend)`` for every stored candidate."""
        for name in sorted(os.listdir(self.directory)):
            if name.endswith(".info.npz"):
                stem = name[: -len(".info.npz")]
                root, _, span = stem.rpartition("_")
                lo, _, hi = span.partition("-")
                yield root, int(lo), int(hi)
