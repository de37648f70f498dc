"""Candidate sifting: collapse duplicate detections of one physical pulse.

The driver advances by half a chunk, so a pulse is detected in up to two
chunks (plus trial-DM neighbours).  Hits whose absolute arrival time and
DM fall within a matching radius are grouped and the highest-S/N member
of each group is kept.  Host-side; candidate lists are tiny.
"""

from __future__ import annotations

import json
import logging

logger = logging.getLogger("pulsarutils_tpu_torch")


def hit_fields(istart, iend, info, table):
    """Arrival time (s), DM, S/N and width (s) of one chunk hit."""
    best = table.best_row()
    tsamp = 1.0 / (info.pulse_freq * info.nbin)
    t0 = getattr(info, "t0", None)
    t_peak = float(t0) if t0 is not None else istart * tsamp
    if "peak" in table.colnames:
        t_peak = t_peak + float(best["peak"]) * tsamp
    return {
        # the istart * tsamp fallback is best-effort (file samples times
        # the effective sample time); flag it
        "time_approx": t0 is None,
        "istart": int(istart),
        "iend": int(iend),
        "span": float(info.nbin) * tsamp,
        "time": float(t_peak),
        "dm": float(best["DM"]),
        "snr": float(best["snr"]),
        "width": float(best["rebin"]) * tsamp,
        "beam": getattr(info, "ibeam", None),
        "info": info,
        "table": table,
    }


def sift_candidates(cands, time_radius, dm_radius=None, stats=None):
    """Greedy single-linkage grouping in descending S/N order.

    A candidate joins the first kept group within the time radius and the
    group's DM radius, else seeds a new group.  ``time_radius`` is seconds
    or ``"pair-width"`` (per pair, ``max(0.5 s, 4 x the wider width)``);
    ``dm_radius=None`` uses ``0.02 * seed_dm + 1`` per group.  Kept
    candidates carry ``n_members``.  ``stats`` (a dict) receives ``in``,
    ``kept`` and the absorbed duplicates by reason under ``rejected``.
    """
    pair_width = time_radius == "pair-width"
    order = sorted(range(len(cands)), key=lambda i: -cands[i]["snr"])
    if stats is None:
        stats = {}
    stats["in"] = len(cands)
    rejected = stats.setdefault(
        "rejected", {"duplicate": 0, "width": 0, "dm_radius": 0})
    kept = []
    for i in order:
        c = cands[i]
        for k in kept:
            if pair_width:
                t_radius = max(0.5, 4.0 * max(c.get("width", 0.0),
                                              k.get("width", 0.0)))
            else:
                t_radius = time_radius
            k_radius = (0.02 * k["dm"] + 1.0 if dm_radius is None
                        else dm_radius)
            dt = abs(c["time"] - k["time"])
            ddm = abs(c["dm"] - k["dm"])
            if dt <= t_radius and ddm <= k_radius:
                k["n_members"] += 1
                reason = ("width" if pair_width and dt > 0.5
                          else "dm_radius" if ddm > 1.0 else "duplicate")
                rejected[reason] += 1
                break
        else:
            kept.append({**c, "n_members": 1})
    stats["kept"] = len(kept)
    return kept


def sift_hits(hits, time_radius=None, dm_radius=None, stats=None):
    """Sift the ``(istart, iend, PulseInfo, ResultTable)`` hits of
    :func:`~.search_pipeline.search_by_chunks`.

    With exact arrival times (the ``peak`` column) the default time radius
    is per pair, ``max(0.5 s, 4 x the wider width)``; hits with only
    approximate times use 1.5 chunk spans.  Returns candidate dicts
    (descending S/N) with keys ``time, dm, snr, width, istart, iend,
    n_members, info, table``, and logs one ``SIFT_JSON`` line.
    """
    stats = {} if stats is None else stats
    if not hits:
        return []
    cands = [hit_fields(*h) for h in hits]
    if time_radius is None:
        if any(c["time_approx"] for c in cands):
            time_radius = 1.5 * max(c["span"] for c in cands)
        else:
            time_radius = "pair-width"
    kept = sift_candidates(cands, time_radius, dm_radius, stats=stats)
    logger.info("SIFT_JSON %s", json.dumps(stats))
    return kept
