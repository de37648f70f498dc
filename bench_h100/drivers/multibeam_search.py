"""Driver of multi-beam cells: pointings of every beam searched back to
back as one batch through
``pulsarutils_tpu_torch.beams.multibeam.multibeam_search``, with the
coincidence sift over the receiver's beam layout.

Each job is one pointing with a fresh output directory; the window's end
cancels every beam (the epoch in flight completes).  The entry keeps each
beam's tables (``keep_tables``), which the comparison reads."""

from __future__ import annotations

import collections
import glob
import json
import os
import time

import numpy as np
import torch

from ..harness.checking import RefPointing, pick
from ..reference import coincidence as ref_coinc


def _adjacency(cfg):
    return {int(k): {int(b) for b in v}
            for k, v in cfg.get("adjacency", {}).items()}


def _job(ctx, outdir, **kw):
    from pulsarutils_tpu_torch.beams.multibeam import multibeam_search

    cfg, entry = ctx.cell.config, ctx.cell.traffic["entry"]
    os.makedirs(outdir, exist_ok=True)
    return multibeam_search(
        ctx.files, cfg["dmmin"], cfg["dmmax"],
        snr_threshold=entry["snr_threshold"], output_dir=outdir,
        kernel=entry["kernel"], batched=entry.get("batched", True),
        adjacency=_adjacency(cfg), keep_tables=True, device=ctx.device,
        **kw)


def reference(ctx):
    if getattr(ctx, "ref", None) is None:
        cfg = ctx.cell.config
        ctx.ref = [RefPointing(f, cfg["dmmin"], cfg["dmmax"], ctx.device)
                   for f in ctx.files]
    return ctx.ref


def warm(ctx):
    _job(ctx, os.path.join(ctx.work_dir, "warm"), max_chunks=1)


def window(ctx, seconds, budget_factory=None):
    jobs, budgets = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        outdir = os.path.join(ctx.work_dir, f"job{len(jobs):03d}")
        budget = budget_factory() if budget_factory else None
        result = _job(ctx, outdir, budget=budget,
                      cancel_cb=lambda i: time.perf_counter() >= deadline)
        jobs.append({"outdir": outdir, "result": result})
        if budget is not None:
            budgets.append(budget)
    wall = time.perf_counter() - t0
    r = reference(ctx)[0]
    units = sum(b["chunks_done"] for j in jobs for b in j["result"]["beams"])
    searched = sum(len(b["tables"]) for j in jobs
                   for b in j["result"]["beams"])
    return {"wall_s": wall, "units": units, "searched": searched,
            "obs_s": units * r.hop * r.tsamp, "jobs": jobs,
            "budgets": budgets, "attempted": searched,
            "failed": max(searched - units, 0)}


def _ledgers(outdir):
    """``Counter`` of chunk starts over every beam's ledger."""
    out = collections.Counter()
    for path in glob.glob(os.path.join(outdir, "progress_*.json")):
        with open(path) as f:
            done = json.load(f)["done"]
        out.update(int(s) for s in done)
        out["duplicates"] += len(done) - len(set(done))
    return out


def _cands(job, thr, r):
    """Hit candidates of a job as the tables give them."""
    out = []
    for b in job["result"]["beams"]:
        for istart, table in b["tables"]:
            snr = np.asarray(table["snr"], dtype=np.float64)
            best = int(np.argmax(snr))
            if snr[best] > thr:
                out.append({
                    "beam": int(b["beam"]), "istart": int(istart),
                    "time": istart * r.tsamp
                    + float(table["peak"][best]) * r.eff_tsamp,
                    "dm": float(table["DM"][best]), "snr": float(snr[best]),
                    "width": float(table["rebin"][best]) * r.eff_tsamp})
    return out


def check(ctx, rec, seed, control=False):
    """The numbers compared: ``snr_gap``, the widest S/N gap between the
    program's tables and the reference, over every row of every beam in
    ``full_epochs`` sampled epochs and the best row of every beam in
    ``best_row_epochs`` more;
    ``hits_wrong``, beam chunks whose hit the program kept where its table
    has none above the threshold or the reverse, and sampled beam chunks
    whose reference best disagrees with the program's verdict;
    ``verdicts_wrong``, coincidence groups whose verdict, beams or
    members differ from the reference sift of the same hits;
    ``ledger_wrong``, beam chunks searched but not marked done once.
    With ``control`` the reference at the next lower precision stands in
    the program's place."""
    refs = reference(ctx)
    cfg = ctx.cell.config
    thr = float(ctx.cell.traffic["entry"]["snr_threshold"])
    epochs = sorted({(k, istart) for k, j in enumerate(rec["jobs"])
                     for b in j["result"]["beams"]
                     for istart, _ in b["tables"]})
    full = {epochs[i] for i in pick(len(epochs),
                                    int(ctx.cell.check.get("full_epochs",
                                                           1)),
                                    seed, "full")}
    # the best row of every beam in a further sample of epochs
    sampled = full | {epochs[i] for i in pick(
        len(epochs), int(ctx.cell.check.get("best_row_epochs", 8)), seed,
        "best")}
    gap, hits_wrong, verdicts_wrong, ledger_wrong = 0.0, 0, 0, 0
    for k, job in enumerate(rec["jobs"]):
        beams = job["result"]["beams"]
        for bi, b in enumerate(beams):
            r = refs[bi]
            hit_starts = {h[0] for h in b["hits"]}
            for istart, table in b["tables"]:
                snr = np.asarray(table["snr"], dtype=np.float64)
                dms = np.asarray(table["DM"], dtype=np.float64)
                if dms.shape != r.dms.shape \
                        or not np.allclose(dms, r.dms, rtol=1e-9):
                    gap = float("inf")
                    continue
                is_hit = istart in hit_starts
                if is_hit != (snr.max() > thr):
                    hits_wrong += 1
                if (k, istart) not in sampled:
                    continue
                x = r.chunk(istart)
                rows = (np.arange(len(r.dms)) if (k, istart) in full
                        else np.array([int(np.argmax(snr))]))
                ref_snr = r.rows(x, rows)["snr"]
                subject = (r.rows(x, rows, torch.bfloat16)["snr"]
                           if control else snr[rows])
                gap = max(gap, float(np.max(np.abs(subject - ref_snr))))
                ref_best = float(ref_snr.max())
                if abs(ref_best - thr) > 1e-3 and is_hit != (ref_best > thr):
                    hits_wrong += 1
                del x
        # the sift of the hits the tables give, against the program's
        want = collections.Counter(
            (v, tuple(bs), n) for v, bs, n in ref_coinc.sift(
                _cands(job, thr, refs[0]), len(beams), _adjacency(cfg)))
        coinc = job["result"]["coincidence"] or {"groups": []}
        got = collections.Counter(
            (g["verdict"], tuple(sorted(int(x) for x in g["beams"])),
             int(g["n_members"])) for g in coinc["groups"])
        verdicts_wrong += sum(((want - got) + (got - want)).values())
        marks = _ledgers(job["outdir"])
        ledger_wrong += marks.pop("duplicates", 0)
        searched = collections.Counter(
            istart for b in beams for istart, _ in b["tables"])
        ledger_wrong += sum(((marks - searched) + (searched - marks))
                            .values())
    return {"snr_gap": gap, "hits_wrong": float(hits_wrong),
            "verdicts_wrong": float(verdicts_wrong),
            "ledger_wrong": float(ledger_wrong)}
