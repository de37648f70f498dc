"""Harmonic-aware periodicity candidate pipeline.

The port of the JAX package's ``periodicity/candidates.py``:

* a zap list (:class:`ZapList`) of known RFI periodicities ("birdies")
  drops candidates on a zapped frequency or one of its harmonics;
* DM-adjacency grouping keeps the strongest of the candidates at one
  frequency;
* the harmonic sift folds a candidate whose frequency is an integer
  multiple or sub-multiple of a stronger survivor's into it;
* :func:`fold_candidates` phase-folds the survivors on their
  accel-corrected series over a refined grid
  (:func:`~..ops.periodicity.epoch_folding_search`, on the device).

Zap files and candidate npz files are the JAX package's formats: either
package reads what the other writes.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

from ..io.atomic import atomic_write_text
from ..obs import metrics as _metrics
from ..ops.periodicity import epoch_folding_search, refine_grid
from ..utils.device import resolve_device, to_numpy
from .accel import fractional_resample

logger = logging.getLogger("pulsarutils_tpu_torch")

__all__ = ["ZapList", "candidate_list", "fold_candidates",
           "harmonic_ratio", "load_candidates", "save_candidates",
           "sift_candidates"]

_ZAP_VERSION = 1


class ZapList:
    """Persistent list of known RFI periodicities: entries ``{"freq": Hz,
    "width": Hz, "harmonics": n}``; a candidate is zapped within
    ``width * h`` of ``h * freq`` for ``h`` up to ``harmonics``."""

    def __init__(self, entries=()):
        self.entries = []
        for e in entries:
            self.add(e["freq"], e.get("width", 0.01),
                     harmonics=e.get("harmonics", 1), note=e.get("note"))

    def add(self, freq, width=0.01, harmonics=1, note=None):
        entry = {"freq": float(freq), "width": float(width),
                 "harmonics": max(int(harmonics), 1)}
        if note:
            entry["note"] = str(note)
        self.entries.append(entry)
        return entry

    def matches(self, freq):
        """The matching zap entry, or ``None``."""
        freq = float(freq)
        for e in self.entries:
            for h in range(1, e["harmonics"] + 1):
                if abs(freq - h * e["freq"]) <= e["width"] * h:
                    return e
        return None

    def __len__(self):
        return len(self.entries)

    def save(self, path):
        """Versioned JSON, written atomically."""
        atomic_write_text(path, json.dumps(
            {"version": _ZAP_VERSION, "zap": self.entries}, indent=1,
            sort_keys=True) + "\n")

    @classmethod
    def load(cls, path):
        """Load a zap file; a missing, torn or mismatched file gives an
        empty list (with a warning unless missing)."""
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            if not isinstance(doc, dict) \
                    or doc.get("version") != _ZAP_VERSION \
                    or not isinstance(doc.get("zap"), list):
                raise ValueError(f"not a v{_ZAP_VERSION} zap file")
            return cls(doc["zap"])
        except FileNotFoundError:
            return cls()
        except (OSError, ValueError, TypeError, KeyError) as exc:
            logger.warning("zap list %s unreadable (%r); proceeding "
                           "without it", path, exc)
            return cls()


def harmonic_ratio(f_strong, f_weak, max_ratio=16, tol=0.01):
    """``r >= 2`` when one frequency is ``r`` times the other within
    fractional tolerance ``tol`` of the ratio, else 0."""
    if f_strong <= 0 or f_weak <= 0:
        return 0
    ratio = max(f_strong, f_weak) / min(f_strong, f_weak)
    r = int(round(ratio))
    if 2 <= r <= int(max_ratio) and abs(ratio - r) <= tol * r:
        return r
    return 0


def candidate_list(table, trial_dms, sigma_threshold):
    """Flatten an :func:`~.accel.accel_search` table into candidate dicts
    at or above ``sigma_threshold`` (zero-frequency rows dropped), sorted
    by descending sigma, then accel and DM index."""
    cands = []
    for i in range(len(table["sigma"])):
        if table["freq"][i] <= 0 \
                or table["sigma"][i] < float(sigma_threshold):
            continue
        d = int(table["dm_index"][i])
        cands.append({
            "dm_index": d,
            "dm": (float(trial_dms[d]) if trial_dms is not None
                   else float(d)),
            "accel_index": int(table["accel_index"][i]),
            "accel": float(table["accel"][i]),
            "jerk_index": (int(table["jerk_index"][i])
                           if "jerk_index" in table else 0),
            "jerk": (float(table["jerk"][i]) if "jerk" in table else 0.0),
            "freq": float(table["freq"][i]),
            "freq_bin": int(table["freq_bin"][i]),
            "nharm": int(table["nharm"][i]),
            "power": float(table["power"][i]),
            "log_sf": float(table["log_sf"][i]),
            "sigma": float(table["sigma"][i]),
        })
    cands.sort(key=lambda c: (-c["sigma"], c["accel_index"],
                              c["dm_index"]))
    return cands


def sift_candidates(cands, *, zap=None, freq_tol=None, dm_radius=None,
                    max_ratio=16, harm_tol=0.01):
    """Zap -> DM grouping -> harmonic sift, strongest first.

    ``freq_tol`` (Hz) is the same-frequency window of the DM grouping
    (None: no grouping); ``dm_radius=None`` groups across all DM trials.
    Returns ``(kept, stats)``, ``stats["rejected"]`` counting per reason
    (each rejection ticks ``putpu_period_sift_rejected_total{reason}``;
    each rejected candidate gets ``rejected`` and, when absorbed,
    ``absorbed_by``)."""
    cands = sorted(cands, key=lambda c: (-c["sigma"], c["accel_index"],
                                         c["dm_index"]))
    stats = {"in": len(cands),
             "rejected": {"zap": 0, "dm_duplicate": 0, "harmonic": 0}}

    def reject(cand, reason, of=None):
        stats["rejected"][reason] += 1
        _metrics.counter("putpu_period_sift_rejected_total",
                         reason=reason).inc()
        cand["rejected"] = reason
        if of is not None:
            cand["absorbed_by"] = of["freq"]

    kept = []
    for cand in cands:
        if zap is not None and zap.matches(cand["freq"]) is not None:
            reject(cand, "zap")
            continue
        dup = None
        if freq_tol is not None:
            for k in kept:
                if abs(k["freq"] - cand["freq"]) <= float(freq_tol) \
                        and (dm_radius is None
                             or abs(k["dm_index"] - cand["dm_index"])
                             <= int(dm_radius)):
                    dup = k
                    break
        if dup is not None:
            reject(cand, "dm_duplicate", of=dup)
            continue
        harm = None
        for k in kept:
            if harmonic_ratio(k["freq"], cand["freq"],
                              max_ratio=max_ratio, tol=harm_tol):
                harm = k
                break
        if harm is not None:
            reject(cand, "harmonic", of=harm)
            continue
        kept.append(cand)
    stats["kept"] = len(kept)
    return kept, stats


def fold_candidates(accumulator, cands, *, nbin=32, oversample=8,
                    device="cuda"):
    """Phase-fold each candidate's accel-corrected DM series over a
    refined frequency grid on ``device``; the best trial's
    ``freq_refined``, ``h``, ``m`` and ``profile`` land on the candidate
    dict.  Mutates and returns ``cands``."""
    dev = resolve_device(device)
    tsamp = accumulator.tsamp
    for cand in cands:
        series = accumulator.series(cand["dm_index"])
        if cand["accel"] or cand.get("jerk"):
            series = fractional_resample(series, cand["accel"], tsamp,
                                         jerk=cand.get("jerk", 0.0))
        grid = refine_grid(cand["freq"], tsamp, series.shape[-1],
                           oversample=oversample)
        grid = grid[grid > 0]
        if grid.size == 0:
            continue
        h, m, profiles = epoch_folding_search(
            torch.as_tensor(np.asarray(series, dtype=np.float32)).to(dev),
            tsamp, grid, nbin=int(nbin))
        h = to_numpy(h)
        k = int(np.argmax(h))
        cand["freq_refined"] = float(grid[k])
        cand["h"] = float(h[k])
        cand["m"] = int(to_numpy(m)[k])
        cand["profile"] = to_numpy(profiles[k]).astype(np.float32)
        _metrics.counter("putpu_period_folds_total").inc()
    return cands


_COLS = ("dm_index", "dm", "accel_index", "accel", "jerk_index", "jerk",
         "freq", "freq_bin", "nharm", "power", "log_sf", "sigma",
         "freq_refined", "h", "m")


def save_candidates(path, cands, meta=None):
    """Persist folded candidates as one npz (columns, a profile block and
    a JSON meta member), atomically."""
    arrays = {}
    for col in _COLS:
        arrays[col] = np.asarray([c.get(col, 0) for c in cands])
    nbin = max((c["profile"].size for c in cands if "profile" in c),
               default=0)
    profiles = np.zeros((len(cands), nbin), dtype=np.float32)
    for i, c in enumerate(cands):
        p = c.get("profile")
        if p is not None:
            profiles[i, :p.size] = p
    arrays["profiles"] = profiles
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta or {}, sort_keys=True).encode(), dtype=np.uint8)
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def load_candidates(path):
    """Load a :func:`save_candidates` artifact -> ``(cands, meta)``."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["meta_json"]).decode() or "{}")
        n = data["sigma"].size
        cands = []
        for i in range(n):
            c = {col: data[col][i].item() for col in _COLS
                 if col in data.files}
            if data["profiles"].shape[1]:
                c["profile"] = np.array(data["profiles"][i])
            cands.append(c)
    return cands, meta
