"""The plain cross-beam coincidence sift.

Candidates (one per beam chunk whose best S/N clears the threshold) are
grouped greedily in descending S/N: a candidate joins the first group
whose seed lies within ``max(0.5 s, 4 x the wider width)`` in arrival time
and ``0.02 DM + 1`` in DM, else it seeds a new group.  A group seen in at
least ``max(3, ceil(veto_frac * nbeams))`` beams is terrestrial (``rfi``);
one confined to at most ``max_real_beams`` mutually adjacent beams is
``confirmed``; anything else is ``ambiguous``.
"""

from __future__ import annotations

import math


def _connected(beams, adjacency):
    beams = set(beams)
    if len(beams) <= 1:
        return True
    start = next(iter(beams))
    seen, todo = {start}, [start]
    while todo:
        b = todo.pop()
        for nb in adjacency.get(b, ()):
            if nb in beams and nb not in seen:
                seen.add(nb)
                todo.append(nb)
    return seen == beams


def sift(cands, nbeams, adjacency, veto_frac=0.7, max_real_beams=2):
    """Groups of ``cands`` (dicts with ``beam``, ``time``, ``dm``, ``snr``,
    ``width``), each ``(verdict, sorted beams, members)``."""
    groups = []
    for c in sorted(cands, key=lambda c: -c["snr"]):
        for g in groups:
            seed = g["seed"]
            t_radius = max(0.5, 4.0 * max(c["width"], seed["width"]))
            if abs(c["time"] - seed["time"]) <= t_radius \
                    and abs(c["dm"] - seed["dm"]) <= 0.02 * seed["dm"] + 1.0:
                g["members"].append(c)
                break
        else:
            groups.append({"seed": c, "members": [c]})
    veto_min = max(3, math.ceil(veto_frac * nbeams))
    out = []
    for g in groups:
        beams = sorted({m["beam"] for m in g["members"]})
        if nbeams >= 3 and len(beams) >= veto_min:
            verdict = "rfi"
        elif len(beams) <= max_real_beams and _connected(beams, adjacency):
            verdict = "confirmed"
        else:
            verdict = "ambiguous"
        out.append((verdict, beams, len(g["members"])))
    return out
