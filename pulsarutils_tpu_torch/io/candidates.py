"""Candidate store with a deterministic resume ledger.

Candidates are npz records (:class:`..pipeline.pulse_info.PulseInfo` plus
the chunk's full result table) named ``{root}_{istart}-{iend}``; a
``progress_<fingerprint>.json`` ledger records every processed chunk (hit
or not), so a restarted search skips exactly the work already done.  The
file formats are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os

import numpy as np
import torch

from ..faults import inject as fault_inject
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
    not-done and nothing is recorded."""

    #: persisted-waterfall element budget: above it the store keeps a
    #: window around the pulse instead of the whole chunk
    WATERFALL_BUDGET = 1 << 22

    def __init__(self, directory, fingerprint=None):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.fingerprint = fingerprint
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
        self.trim_waterfall(info, table).save(base + ".info.npz")
        table.to_npz(base + ".table.npz")
        return base

    def save_lineage(self, root, istart, iend, doc):
        """Write a candidate's lineage doc beside its npz pair,
        ``{base}.lineage.json`` (atomic; indented and key-sorted as the
        JAX package writes it).  Only called when lineage is armed."""
        path = self._base(root, istart, iend) + ".lineage.json"
        atomic_write_json(path, doc, indent=2, sort_keys=True,
                          trailing_newline=True)
        return path

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
