"""Driver of single-beam cells: pointings searched back to back through
``pulsarutils_tpu_torch.pipeline.search_pipeline.search_by_chunks``.

Each job is one pointing with a fresh output directory and the entry's
defaults for persist, ledger and hit plots; the window's end cancels the
job (the chunk in flight completes, nothing after it starts).  Every
chunk's result table is kept as the loop hands it on, by a pass-through
around the loop's per-chunk search call, for the comparison."""

from __future__ import annotations

import glob
import json
import os
import re
import time

import numpy as np
import torch

from ..harness.checking import RefPointing, pick


def _entry(ctx):
    from pulsarutils_tpu_torch.pipeline import search_pipeline

    return search_pipeline


def _job(ctx, outdir, **kw):
    cfg, entry = ctx.cell.config, ctx.cell.traffic["entry"]
    os.makedirs(outdir, exist_ok=True)
    return _entry(ctx).search_by_chunks(
        ctx.files[0], dmmin=cfg["dmmin"], dmmax=cfg["dmmax"],
        kernel=entry["kernel"], snr_threshold=entry["snr_threshold"],
        output_dir=outdir, device=ctx.device, **kw)


def reference(ctx):
    if getattr(ctx, "ref", None) is None:
        cfg = ctx.cell.config
        ctx.ref = [RefPointing(ctx.files[0], cfg["dmmin"], cfg["dmmax"],
                               ctx.device)]
    return ctx.ref


def warm(ctx):
    _job(ctx, os.path.join(ctx.work_dir, "warm"), max_chunks=1)


def window(ctx, seconds, budget_factory=None):
    """Jobs back to back until ``seconds`` have passed; returns the
    record of the window."""
    sp = _entry(ctx)
    tables = []
    job_index = [0]
    inner = sp._search_with_fallback

    def tap(*args, **kwargs):
        result = inner(*args, **kwargs)
        table = result[0] if isinstance(result, tuple) else result
        tables.append((job_index[0], int(kwargs["chunk"]), table))
        return result

    jobs, budgets = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    sp._search_with_fallback = tap
    try:
        while time.perf_counter() < deadline:
            outdir = os.path.join(ctx.work_dir, f"job{job_index[0]:03d}")
            budget = budget_factory() if budget_factory else None
            summary = {}
            _job(ctx, outdir, summary=summary, budget=budget,
                 cancel_cb=lambda: time.perf_counter() >= deadline)
            jobs.append({"outdir": outdir, "summary": summary})
            if budget is not None:
                budgets.append(budget)
            job_index[0] += 1
    finally:
        sp._search_with_fallback = inner
    wall = time.perf_counter() - t0
    r = reference(ctx)[0]
    done = [_ledger(j["outdir"]) for j in jobs]
    units = sum(len(d) for d in done)
    quarantined = sum(j["summary"].get("quarantined", 0) for j in jobs)
    return {"wall_s": wall, "units": units, "searched": len(tables),
            "obs_s": units * r.hop * r.tsamp, "jobs": jobs, "done": done,
            "tables": tables, "budgets": budgets,
            "attempted": len(tables) + quarantined,
            "failed": quarantined + max(len(tables) - units, 0)}


def _ledger(outdir):
    done = []
    for path in glob.glob(os.path.join(outdir, "progress_*.json")):
        with open(path) as f:
            done.extend(int(s) for s in json.load(f)["done"])
    return done


def _candidates(outdir):
    out = set()
    for path in glob.glob(os.path.join(outdir, "*.table.npz")):
        m = re.search(r"_(\d+)-(\d+)\.table\.npz$", path)
        if m:
            out.add(int(m.group(1)))
    return out


def check(ctx, rec, seed, control=False):
    """The numbers compared: ``snr_gap``, the widest S/N gap between the
    program's table and the reference, over every trial of the plan in
    ``full_chunks`` chunks drawn from the seed and the 16 rows around the
    best row of every other chunk of the window, or the margin by which a
    compared row of the reference outshines the program's best row;
    ``hits_wrong``, chunks whose candidate was persisted where the
    reference has none above the threshold, or the reverse;
    ``ledger_wrong``, chunks searched but not marked done once, or marked
    but not searched.  With ``control`` the reference at the next lower
    precision stands in the program's place."""
    r = reference(ctx)[0]
    thr = float(ctx.cell.traffic["entry"]["snr_threshold"])
    tables = rec["tables"]
    full = set(pick(len(tables), int(ctx.cell.check.get("full_chunks", 1)),
                    seed, "full"))
    gap, hits_wrong = 0.0, 0
    for i, (job, istart, table) in enumerate(tables):
        snr = np.asarray(table["snr"], dtype=np.float64)
        dms = np.asarray(table["DM"], dtype=np.float64)
        if dms.shape != r.dms.shape or not np.allclose(dms, r.dms,
                                                       rtol=1e-9):
            gap = float("inf")   # another trial grid than the plan's
            continue
        x = r.chunk(istart)
        best = int(np.argmax(snr))
        rows = (np.arange(len(snr)) if i in full
                else np.arange(max(best - 8, 0), min(best + 8, len(snr))))
        ref_snr = r.rows(x, rows)["snr"]
        subject = (r.rows(x, rows, torch.bfloat16)["snr"] if control
                   else snr[rows])
        best_snr = subject.max() if control else snr.max()
        ref_best = float(ref_snr.max())
        gap = max(gap, float(np.max(np.abs(subject - ref_snr))),
                  # a row the reference finds brighter than the best
                  ref_best - float(best_snr))
        persisted = istart in _candidates(rec["jobs"][job]["outdir"])
        if abs(ref_best - thr) > 1e-3 and persisted != (ref_best > thr):
            hits_wrong += 1
        del x
    ledger_wrong = 0
    for k, done in enumerate(rec["done"]):
        searched = [s for j, s, _ in tables if j == k]
        ledger_wrong += len(set(searched) ^ set(done))
        ledger_wrong += len(searched) - len(set(searched))
        ledger_wrong += len(done) - len(set(done))
    return {"snr_gap": gap, "hits_wrong": float(hits_wrong),
            "ledger_wrong": float(ledger_wrong)}
