"""Full-observation DM–time accumulation from streamed chunk planes.

The port of the JAX package's ``periodicity/accumulate.py``.  The
chunked search drops each chunk's dedispersed plane once scored;
periodicity sensitivity grows as sqrt(T_obs), so the accumulator keeps
them: each plane is folded into ONE host-resident ``(ndm, T_obs /
rebin)`` float32 plane.

* Every chunk contributes its first ``hop`` samples (the chunks overlap
  50%, so first-hop slices tile the observation once, and they are the
  wrap-free half of the circular per-chunk dedispersion); the last
  chunk contributes its full extent.
* The time axis is rebinned by a power of two dividing the effective
  hop (:func:`choose_rebin`), so the plane fits ``SAFETY_FRACTION`` of
  the budget.
* Contributions land in disjoint column ranges: a chunk consumed twice
  (a crash between consume and the ledger mark) is de-duplicated by its
  start index, and the order of consumption changes no byte.  The
  host arithmetic is the JAX package's, so both packages build the same
  plane from the same chunk planes.

Snapshots (:meth:`DMTimeAccumulator.save` / :meth:`~.restore`) are
written atomically beside the chunk ledger, in the JAX package's npz
layout.
"""

from __future__ import annotations

import logging
import os
import zipfile

import numpy as np
import torch

from ..utils.device import to_numpy

logger = logging.getLogger("pulsarutils_tpu_torch")

__all__ = ["DEFAULT_HOST_PLANE_BYTES", "DMTimeAccumulator", "choose_rebin"]

#: plane-size cap when no device budget is known (the CPU)
DEFAULT_HOST_PLANE_BYTES = 1 << 28

#: share of the budget the plane may take
SAFETY_FRACTION = 0.8

_SNAP_VERSION = 1


def default_budget_bytes(device=None):
    """The plane budget: the card's total memory
    (``torch.cuda.mem_get_info``) for a CUDA device, else
    :data:`DEFAULT_HOST_PLANE_BYTES`."""
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(torch.device(device))[1])
    return DEFAULT_HOST_PLANE_BYTES


def choose_rebin(ndm, nsamples_eff, hop_eff, budget_bytes=None, device=None):
    """The smallest power-of-two rebin (dividing ``hop_eff``) whose
    ``(ndm, nsamples_eff / rebin)`` float32 plane fits ``SAFETY_FRACTION``
    of ``budget_bytes`` (None: :func:`default_budget_bytes` of
    ``device``).  When even the coarsest admissible factor does not fit,
    it is returned with a warning."""
    if budget_bytes is None:
        budget_bytes = default_budget_bytes(device)
    usable = SAFETY_FRACTION * float(budget_bytes)
    hop_eff = max(int(hop_eff), 1)
    rebin = 1
    while (int(ndm) * (int(nsamples_eff) // rebin + 1) * 4 > usable
           and rebin * 2 <= hop_eff and hop_eff % (rebin * 2) == 0):
        rebin *= 2
    if int(ndm) * (int(nsamples_eff) // rebin + 1) * 4 > usable:
        logger.warning(
            "periodicity plane (%d x %d at rebin %d) exceeds the %.0f MB "
            "budget even at the coarsest hop-aligned rebin; proceeding",
            ndm, int(nsamples_eff) // rebin, rebin, usable / 1e6)
    return rebin


class DMTimeAccumulator:
    """Accumulate streamed chunk planes into one observation plane.

    ``plan`` is the survey's :class:`~..parallel.stream.ChunkPlan`;
    ``nsamples`` the file's raw sample count; ``chunk_starts`` the
    planned chunk grid (the last start keeps its full extent).
    ``rebin="auto"`` sizes the plane by the budget (:func:`choose_rebin`,
    ``device`` naming the card whose memory sets it); an explicit integer
    must be a power of two dividing the effective hop.
    """

    def __init__(self, plan, nsamples, chunk_starts, ndm, *, rebin="auto",
                 budget_bytes=None, trial_dms=None, device=None):
        if plan.hop % plan.resample:
            raise ValueError(
                f"hop {plan.hop} not divisible by resample {plan.resample}"
                " — the chunk grid cannot tile the effective time axis")
        self.plan = plan
        self.nsamples = int(nsamples)
        self.chunk_starts = [int(s) for s in chunk_starts]
        self.ndm = int(ndm)
        self.hop_eff = plan.hop // plan.resample
        self.tsamp_chunk = float(plan.sample_time)
        last = max(self.chunk_starts) if self.chunk_starts else 0
        self.nsamples_eff = (last // plan.resample
                             + min(plan.step, self.nsamples - last)
                             // plan.resample)
        if rebin == "auto":
            rebin = choose_rebin(self.ndm, self.nsamples_eff, self.hop_eff,
                                 budget_bytes=budget_bytes, device=device)
        rebin = int(rebin)
        if rebin < 1 or self.hop_eff % rebin:
            raise ValueError(f"rebin {rebin} must divide the effective "
                             f"hop {self.hop_eff}")
        self.rebin = rebin
        self.tsamp = self.tsamp_chunk * rebin
        self.nout = self.nsamples_eff // rebin
        self.plane = np.zeros((self.ndm, self.nout), dtype=np.float32)
        self.trial_dms = (None if trial_dms is None
                          else np.asarray(trial_dms, dtype=np.float64))
        self.seen = set()

    @property
    def complete(self):
        """True once every planned chunk has been folded in."""
        return self.seen >= set(self.chunk_starts)

    @property
    def coverage(self):
        """Fraction of planned chunks folded in so far."""
        if not self.chunk_starts:
            return 1.0
        return len(self.seen & set(self.chunk_starts)) \
            / len(self.chunk_starts)

    def consume(self, istart, plane, table=None):
        """Fold one chunk's dedispersed plane (a tensor on any device, an
        array, or a mesh run's :class:`~..parallel.sharded_plane.
        ShardedPlane`, read back whole) into the observation plane; returns False for a chunk
        start already consumed.  ``table`` pins the DM grid on the first
        call and is checked on every later one."""
        istart = int(istart)
        if istart in self.seen:
            return False
        if istart % self.plan.resample:
            raise ValueError(f"chunk start {istart} not aligned to the "
                             f"resample factor {self.plan.resample}")
        if table is not None and "DM" in getattr(table, "colnames", ()):
            dms = np.asarray(table["DM"], dtype=np.float64)
            if self.trial_dms is None:
                self.trial_dms = dms
            elif dms.shape != self.trial_dms.shape \
                    or not np.array_equal(dms, self.trial_dms):
                raise ValueError(
                    "chunk trial-DM grid drifted mid-observation — all "
                    "accumulated chunks must share one grid")
        if hasattr(plane, "to_host"):   # a mesh run's ShardedPlane handle
            plane = plane.to_host()
        plane = np.asarray(to_numpy(plane), dtype=np.float32)
        if plane.shape[0] != self.ndm:
            raise ValueError(f"chunk plane has {plane.shape[0]} DM rows, "
                             f"accumulator expects {self.ndm}")
        eff_start = istart // self.plan.resample
        is_last = istart == max(self.chunk_starts)
        length = plane.shape[1] if is_last else min(self.hop_eff,
                                                    plane.shape[1])
        out_lo = eff_start // self.rebin
        nbins = length // self.rebin   # trailing partial bin dropped
        if nbins > 0:
            nbins = min(nbins, self.nout - out_lo)
            seg = plane[:, : nbins * self.rebin]
            self.plane[:, out_lo:out_lo + nbins] += seg.reshape(
                self.ndm, nbins, self.rebin).sum(axis=2)
        self.seen.add(istart)
        return True

    def series(self, dm_index):
        """One DM trial's accumulated full-observation series."""
        return self.plane[int(dm_index)]

    def save(self, path):
        """Atomically persist the partial plane + consumed-chunk set
        (written before the chunk's ledger mark)."""
        tmp = str(path) + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, version=np.int64(_SNAP_VERSION),
                     plane=self.plane,
                     seen=np.asarray(sorted(self.seen), dtype=np.int64),
                     rebin=np.int64(self.rebin),
                     nsamples=np.int64(self.nsamples),
                     hop=np.int64(self.plan.hop),
                     step=np.int64(self.plan.step),
                     resample=np.int64(self.plan.resample),
                     trial_dms=(np.zeros(0) if self.trial_dms is None
                                else self.trial_dms))
        os.replace(tmp, path)

    def restore(self, path):
        """Load a snapshot written by :meth:`save`; True when state was
        restored.  A missing, torn or mismatched snapshot restarts
        accumulation from zero (a torn file is backed up ``.corrupt``)."""
        try:
            with np.load(path, allow_pickle=False) as snap:
                if int(snap["version"]) != _SNAP_VERSION:
                    logger.warning(
                        "periodicity snapshot %s has schema version %d "
                        "(this build writes %d); ignoring it", path,
                        int(snap["version"]), _SNAP_VERSION)
                    return False
                if (int(snap["rebin"]) != self.rebin
                        or int(snap["nsamples"]) != self.nsamples
                        or int(snap["hop"]) != self.plan.hop
                        or int(snap["step"]) != self.plan.step
                        or int(snap["resample"]) != self.plan.resample
                        or snap["plane"].shape != self.plane.shape):
                    logger.warning(
                        "periodicity snapshot %s was written for a "
                        "different geometry; ignoring it", path)
                    return False
                self.plane = np.array(snap["plane"], dtype=np.float32)
                self.seen = {int(s) for s in snap["seen"]}
                dms = snap["trial_dms"]
                if dms.size:
                    self.trial_dms = np.array(dms, dtype=np.float64)
        except FileNotFoundError:
            return False
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as exc:
            logger.warning("periodicity snapshot %s unreadable (%r); "
                           "restarting accumulation", path, exc)
            try:
                os.replace(path, str(path) + ".corrupt")
            except OSError:
                pass
            return False
        logger.info("periodicity accumulation resumed: %d/%d chunks "
                    "already folded in", len(self.seen),
                    len(self.chunk_starts))
        return True
