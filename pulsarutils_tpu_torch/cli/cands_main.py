"""``PUcands``: list, sift and export stored candidates (host code, as in
the JAX package).

    python -m pulsarutils_tpu_torch.cli.cands_main OUTPUT_DIR [--no-sift]
        [--min-snr S] [--csv FILE|-]

Reads a :class:`..io.candidates.CandidateStore` directory, collapses the
duplicate detections of each input file (:mod:`..pipeline.sift`) and
prints the candidates, strongest first, or writes them as CSV.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import sys

from ..io.candidates import CandidateStore
from ..pipeline.sift import hit_fields, sift_hits

logger = logging.getLogger("pulsarutils_tpu_torch")

#: the CSV's columns, in order
CSV_FIELDS = ["file", "time", "time_approx", "dm", "snr", "width", "istart",
              "iend", "n_members"]


def load_hits_by_root(directory):
    """Stored candidates grouped by input-file root: ``{root: [(istart,
    iend, info, table), ...]}`` (one store may hold several files'; sifting
    never merges across them).  An unreadable pair is skipped."""
    store = CandidateStore(directory)
    by_root = {}
    for root, lo, hi in store.candidates():
        try:
            info, table = store.load_candidate(root, lo, hi)
        except (OSError, ValueError, KeyError) as exc:
            logger.warning("skipping unreadable candidate %s_%d-%d: %s",
                           root, lo, hi, exc)
            continue
        by_root.setdefault(root, []).append((lo, hi, info, table))
    return by_root


def build_parser():
    parser = argparse.ArgumentParser(
        description="List/export candidates from a search output directory")
    parser.add_argument("directory", help="search --output-dir path")
    parser.add_argument("--no-sift", action="store_true",
                        help="list raw per-chunk detections instead of "
                             "sifted candidates")
    parser.add_argument("--min-snr", type=float, default=None,
                        help="drop candidates below this S/N")
    parser.add_argument("--csv", default=None, metavar="FILE",
                        help="also write the listing as CSV ('-' = stdout)")
    return parser


def main(args=None):
    opts = build_parser().parse_args(args)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if not os.path.isdir(opts.directory):
        logger.error("not a directory: %s", opts.directory)
        return 1
    by_root = load_hits_by_root(opts.directory)
    if not by_root:
        logger.info("no candidates in %s", opts.directory)
        return 0

    cands = []
    nstored = 0
    for root, hits in sorted(by_root.items()):
        nstored += len(hits)
        if opts.no_sift:
            group = [dict(hit_fields(*h), n_members=1) for h in hits]
        else:
            group = sift_hits(hits)
        for c in group:
            c["file"] = root
        cands.extend(group)
    cands.sort(key=lambda c: -c["snr"])
    if opts.min_snr is not None:
        cands = [c for c in cands if c["snr"] >= opts.min_snr]

    for c in cands:
        extra = ""
        info = c["info"]
        if getattr(info, "period_freq", None):
            extra = (f"  periodic f={info.period_freq:.4f} Hz "
                     f"sigma={info.period_sigma:.1f}")
        logger.info("%s: t=%.4fs DM=%.2f snr=%.2f width=%.4gs chunk=%d-%d "
                    "(%d detections)%s", c["file"], c["time"], c["dm"],
                    c["snr"], c["width"], c["istart"], c["iend"],
                    c["n_members"], extra)
    logger.info("%d candidate(s) (%d stored detections)", len(cands),
                nstored)

    if opts.csv:
        out = sys.stdout if opts.csv == "-" else open(opts.csv, "w",
                                                      newline="")
        try:
            w = csv.DictWriter(out, fieldnames=CSV_FIELDS,
                               extrasaction="ignore")
            w.writeheader()
            for c in cands:
                w.writerow(c)
        finally:
            if out is not sys.stdout:
                out.close()
        if opts.csv != "-":
            logger.info("wrote %s", opts.csv)
    return 0


if __name__ == "__main__":  # python -m pulsarutils_tpu_torch.cli.cands_main
    sys.exit(main())
