"""Chunked dispersed-pulse search over filterbank files, on the GPU.

    python -m pulsarutils_tpu_torch.cli.search_main FILE.fil [--dmmin ...]

The flags are the JAX package's ``PUsearchfrb`` flags, with its defaults
(``--backend`` apart: this package has one), plus ``--device``.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os

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
    parser.add_argument("--show-plots", action="store_true",
                        help="display each diagnostic figure interactively "
                             "as well as saving it (needs an interactive "
                             "matplotlib backend; on a headless session the "
                             "figures are only saved)")
    parser.add_argument("--plots", choices=("hits", "all", "none"),
                        default="hits",
                        help="diagnostic JPEG of every hit (default), of "
                             "every chunk, or none; needs matplotlib")
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
    parser.add_argument("--trace", default=None, metavar="OUT.json",
                        help="write a Chrome/Perfetto trace of the run's "
                             "spans to this path AND a torch.profiler "
                             "device trace to '<OUT.json>_device/' (one "
                             "flag, both traces), and enable per-kernel "
                             "roofline accounting for the run")
    parser.add_argument("--metrics-out", default=None, metavar="PATH",
                        help="write the run's metrics-registry snapshot "
                             "(counters/gauges/histograms: candidates, "
                             "trips, bytes moved, roofline, memory "
                             "watermarks) to PATH — Prometheus textfile "
                             "format for a .prom suffix, JSONL otherwise")
    parser.add_argument("--http-port", type=int, default=None,
                        metavar="PORT",
                        help="serve the live survey surface while the "
                             "search runs: /metrics (Prometheus scrape), "
                             "/healthz (OK/DEGRADED/CRITICAL verdict, "
                             "HTTP 503 on CRITICAL), /progress (chunks "
                             "done/total, ETA, canary recall).  0 binds "
                             "an ephemeral port")
    parser.add_argument("--http-host", default="127.0.0.1",
                        metavar="ADDR",
                        help="bind address for --http-port (default "
                             "127.0.0.1: on-machine only; 0.0.0.0 "
                             "exposes the surface to remote Prometheus "
                             "scrapes)")
    parser.add_argument("--canary-rate", type=float, default=0.0,
                        metavar="FRAC",
                        help="inject a synthetic dispersed canary pulse "
                             "into this fraction of chunks and measure "
                             "live recall / S/N recovery / DM error; "
                             "canary detections are tagged and excluded "
                             "from candidates, ledger and sift.  0 "
                             "(default) = off")
    parser.add_argument("--canary-dm", type=float, default=None,
                        help="canary DM (default: middle of the search "
                             "range)")
    parser.add_argument("--canary-snr", type=float, default=12.0,
                        help="canary target S/N (default 12)")
    parser.add_argument("--lineage", action="store_true",
                        help="stamp every detection with a candidate "
                             "lineage record (trace id + monotonic "
                             "stage timestamps: read, dispatch, device "
                             "ready, sift, persist, alert), persisted "
                             "as <candidate>.lineage.json beside the "
                             "npz pair.  Default off")
    parser.add_argument("--push-webhook", action="append", default=None,
                        metavar="URL",
                        help="POST every detection to this webhook URL "
                             "(repeatable: one subscriber per flag).  "
                             "Delivery runs on a bounded background "
                             "queue — a slow or dead webhook never "
                             "stalls the search; undeliverable alerts "
                             "are journaled to push_dead_letter_"
                             "<fingerprint>.jsonl in the output dir.  "
                             "More subscribers can join a live run via "
                             "POST /subscribe on --http-port")
    parser.add_argument("--push-min-snr", type=float, default=None,
                        metavar="SNR",
                        help="only push detections at or above this "
                             "S/N (applies to every --push-webhook "
                             "subscriber)")
    parser.add_argument("--report-out", default=None, metavar="PATH",
                        help="write the end-of-run survey report "
                             "(PATH.md + self-contained PATH.html: "
                             "budget buckets, roofline, canary recall "
                             "curve, health incidents, sift counters, "
                             "quarantine manifest); with several input "
                             "files each gets PATH.<root>")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(args=None):
    opts = build_parser().parse_args(args)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if opts.trace:
        from ..obs import roofline, trace

        roofline.enable()  # a traced run is an observability run
        session = trace.trace_session(
            path=opts.trace, device_trace_dir=opts.trace + "_device")
    else:
        session = contextlib.nullcontext()
    total_raw = total_cands = 0
    with session:
        for fname in opts.fnames:
            canary = None
            if opts.canary_rate > 0:
                from ..obs.canary import CanaryController

                # one controller a file: recall is a statement per run
                canary = CanaryController(rate=opts.canary_rate,
                                          dm=opts.canary_dm,
                                          snr=opts.canary_snr)
            report_out = opts.report_out
            if report_out and len(opts.fnames) > 1:
                root = os.path.splitext(os.path.basename(str(fname)))[0]
                report_out = f"{report_out}.{root}"
            push = None
            if opts.push_webhook:
                push = [{"url": url,
                         **({"min_snr": opts.push_min_snr}
                            if opts.push_min_snr is not None else {})}
                        for url in opts.push_webhook]
            hits, _ = search_by_chunks(
                fname, chunk_length=opts.chunk_length,
                new_sample_time=opts.sample_time, tmin=opts.tmin,
                dmmin=opts.dmmin, dmmax=opts.dmmax, surelybad=opts.surelybad,
                kernel=opts.kernel, snr_threshold=opts.snr_threshold,
                output_dir=opts.output_dir,
                make_plots=False if opts.plots == "none" else opts.plots,
                show_plots=opts.show_plots, resume=not opts.no_resume,
                fft_zap=opts.fft_zap, cut_outliers=opts.cut_outliers,
                zero_dm=opts.zero_dm, max_chunks=opts.max_chunks,
                period_search=opts.period_search,
                period_sigma_threshold=opts.period_sigma,
                dispatch_timeout=opts.dispatch_timeout,
                dispatch_retries=opts.dispatch_retries,
                quarantine_policy=opts.quarantine_policy,
                http_port=opts.http_port, http_host=opts.http_host,
                canary=canary, report_out=report_out, lineage=opts.lineage,
                push=push, device=opts.device)
            total_raw += len(hits)
            if not hits or opts.no_sift:
                total_cands += len(hits)
                continue
            sift_stats = {}
            sifted = sift_hits(hits, stats=sift_stats)
            if report_out and sift_stats:
                # the driver wrote the report before the sift ran
                from ..obs.report import amend_report

                try:
                    amend_report(report_out, sift=sift_stats)
                except Exception as exc:  # noqa: BLE001 — never fatal
                    logger.warning("could not amend the survey report "
                                   "with sift telemetry (%r)", exc)
            total_cands += len(sifted)
            logger.info("%s: %d raw detections -> %d sifted candidates",
                        fname, len(hits), len(sifted))
            for c in sifted:
                logger.info("  t=%.4fs DM=%.2f snr=%.2f width=%.4gs "
                            "(%d detections)", c["time"], c["dm"], c["snr"],
                            c["width"], c["n_members"])
    logger.info("total candidates: %d (%d raw detections)", total_cands,
                total_raw)
    if opts.metrics_out:
        from ..obs.metrics import REGISTRY
        from ..obs.gate import SCHEMA_VERSION

        if opts.metrics_out.endswith(".prom"):
            n = REGISTRY.write_prometheus(opts.metrics_out)
        else:
            n = REGISTRY.write_jsonl(opts.metrics_out,
                                     schema_version=SCHEMA_VERSION)
        logger.info("metrics: %d lines -> %s", n, opts.metrics_out)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
