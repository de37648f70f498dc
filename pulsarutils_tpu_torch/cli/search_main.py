"""Chunked dispersed-pulse search over filterbank files, on the GPU.

    python -m pulsarutils_tpu_torch.cli.search_main FILE.fil [--dmmin ...]

The flags are the JAX package's ``PUsearchfrb`` flags that this package
implements, plus ``--device``.
"""

from __future__ import annotations

import argparse
import logging

from ..pipeline.search_pipeline import search_by_chunks
from ..pipeline.sift import sift_hits

logger = logging.getLogger("pulsarutils_tpu_torch")


def _snr_threshold(value):
    if value in ("auto", "certifiable"):
        return value
    try:
        return float(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"{value!r}: expected a number, 'auto' or 'certifiable'")


def build_parser():
    parser = argparse.ArgumentParser(
        description="Clean filterbank data and search for FRBs/single pulses")
    parser.add_argument("fnames", nargs="+",
                        help="input SIGPROC filterbank files")
    parser.add_argument("--dmmin", type=float, default=300.0)
    parser.add_argument("--dmmax", type=float, default=400.0)
    parser.add_argument("--sample-time", type=float, default=None,
                        help="resample to this sample time (s); default "
                             "auto from DM smearing")
    parser.add_argument("--chunk-length", type=float, default=None,
                        help="chunk length in seconds; default = band "
                             "crossing delay at dmmax")
    parser.add_argument("--tmin", type=float, default=0.0,
                        help="skip data before this time (s)")
    parser.add_argument("--snr-threshold", type=_snr_threshold, default=6.0,
                        help="hit criterion: a number (reference default "
                             "6), 'auto' (noise-ceiling-matched floor for "
                             "the chunk geometry) or 'certifiable' (the "
                             "lowest floor whose hybrid noise certificate "
                             "fires on signal-free chunks)")
    parser.add_argument("--surelybad", type=int, nargs="*", default=[])
    parser.add_argument("--kernel", default="auto",
                        choices=("auto", "pallas", "gather", "fdmt",
                                 "hybrid", "fourier"),
                        help="auto and pallas run the exact direct sweep; "
                             "gather its portable formulation, whose "
                             "channel sums follow PUTPU_PRECISION; fdmt "
                             "the tree transform (tree-rounded tracks); "
                             "hybrid the FDMT coarse sweep plus an exact "
                             "rescore of the hit region; fourier the "
                             "Fourier-domain dedispersion (exact "
                             "fractional-sample delays)")
    parser.add_argument("--fft-zap", action="store_true",
                        help="excise periodic RFI in the Fourier domain")
    parser.add_argument("--cut-outliers", action="store_true",
                        help="zero broadband outlier time bins")
    parser.add_argument("--zero-dm", action="store_true",
                        help="subtract the channel-averaged time series")
    parser.add_argument("--period-search", action="store_true",
                        help="also run the folded period search on every "
                             "chunk's dedispersed plane")
    parser.add_argument("--period-sigma", type=float, default=8.0,
                        help="significance threshold for periodic hits")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--no-resume", action="store_true",
                        help="reprocess chunks already in the ledger")
    parser.add_argument("--dispatch-timeout", type=float, default=None,
                        metavar="SECONDS",
                        help="deadline per device search attempt (a "
                             "watchdog thread): a wedged dispatch moves on "
                             "to the retry and the host fallback within "
                             "timeout x (retries + 1); default off.  An "
                             "abandoned attempt keeps running on the card "
                             "until it ends")
    parser.add_argument("--dispatch-retries", type=int, default=1,
                        help="device retries before the fallback to the "
                             "host path (default 1)")
    parser.add_argument("--quarantine-policy", default="sanitize",
                        choices=("sanitize", "strict", "off"),
                        help="the pre-search integrity gate: 'sanitize' "
                             "(default) imputes sub-threshold NaN/Inf and "
                             "quarantines unrecoverable chunks into "
                             "quarantine_<fingerprint>.jsonl; 'strict' "
                             "quarantines any non-finite chunk; 'off' "
                             "disables the gate")
    parser.add_argument("--max-chunks", type=int, default=None)
    parser.add_argument("--no-sift", action="store_true",
                        help="skip duplicate-candidate sifting")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(args=None):
    opts = build_parser().parse_args(args)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    total_raw = total_cands = 0
    for fname in opts.fnames:
        hits, _ = search_by_chunks(
            fname, chunk_length=opts.chunk_length,
            new_sample_time=opts.sample_time, tmin=opts.tmin,
            dmmin=opts.dmmin, dmmax=opts.dmmax, surelybad=opts.surelybad,
            kernel=opts.kernel, snr_threshold=opts.snr_threshold,
            output_dir=opts.output_dir, resume=not opts.no_resume,
            fft_zap=opts.fft_zap, cut_outliers=opts.cut_outliers,
            zero_dm=opts.zero_dm, max_chunks=opts.max_chunks,
            period_search=opts.period_search,
            period_sigma_threshold=opts.period_sigma,
            dispatch_timeout=opts.dispatch_timeout,
            dispatch_retries=opts.dispatch_retries,
            quarantine_policy=opts.quarantine_policy, device=opts.device)
        total_raw += len(hits)
        if opts.no_sift:
            total_cands += len(hits)
            continue
        sifted = sift_hits(hits)
        total_cands += len(sifted)
        logger.info("%s: %d raw detections -> %d sifted candidates",
                    fname, len(hits), len(sifted))
        for c in sifted:
            logger.info("  t=%.4fs DM=%.2f snr=%.2f width=%.4gs "
                        "(%d detections)", c["time"], c["dm"], c["snr"],
                        c["width"], c["n_members"])
    logger.info("total candidates: %d (%d raw detections)", total_cands,
                total_raw)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
