"""``PUmultibeam`` of the port: the batched multi-beam survey.

    python -m pulsarutils_tpu_torch.cli.beams_main BEAM0.fil BEAM1.fil ...
        [--dmmin 300] [--dmmax 400] [--snr-threshold 6] [--output-dir D]
        [--max-chunks N] [--no-resume] [--sequential] [--canary-rate R]
        [--veto-frac 0.7] [--max-real-beams 2] [--device cuda|cpu]
    python -m pulsarutils_tpu_torch.cli.beams_main --serve --http-port P
        [--http-host 127.0.0.1] [--output-dir D] [--device cuda|cpu]
        [FILE.fil ...]

Searches the files as the beams of one batched survey
(:func:`~..beams.multibeam.multibeam_search`), logs each beam's hits and
the coincidence verdicts and prints ``{"coincidence": stats}``.  With
``--serve`` it runs the job service instead
(:class:`~..beams.service.SurveyService` behind ``POST /jobs``,
``GET /jobs[/<id>]`` and ``POST /jobs/<id>/cancel`` on ``--http-port``,
``0`` for an ephemeral port, logged), each file given submitted as a
job, until interrupted.  Every flag of the JAX package's CLI, plus
``--device`` (the card by default; it raises without one).
"""

from __future__ import annotations

import argparse
import json
import logging
import os

logger = logging.getLogger("pulsarutils_tpu_torch")


def build_parser():
    parser = argparse.ArgumentParser(
        prog="PUmultibeam",
        description="Batched multi-beam single-pulse survey with "
                    "cross-beam coincidence sifting.")
    parser.add_argument("fnames", nargs="*",
                        help="same-geometry filterbank files (one per beam)")
    parser.add_argument("--dmmin", type=float, default=300.0)
    parser.add_argument("--dmmax", type=float, default=400.0)
    parser.add_argument("--snr-threshold", type=float, default=6.0)
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--max-chunks", type=int, default=None)
    parser.add_argument("--no-resume", action="store_true")
    parser.add_argument("--sequential", action="store_true",
                        help="dispatch beam by beam instead of batched (the "
                             "A/B baseline; the results are byte-identical)")
    parser.add_argument("--canary-rate", type=float, default=0.0,
                        help="per-beam canary injection rate (each beam "
                             "injects its own deterministic chunk subset)")
    parser.add_argument("--veto-frac", type=float, default=0.7,
                        help="fraction of beams that must see one (DM, "
                             "time) for the anti-coincidence RFI veto")
    parser.add_argument("--max-real-beams", type=int, default=2,
                        help="max adjacent beams a confirmed candidate may "
                             "span")
    parser.add_argument("--serve", action="store_true",
                        help="run the job service (POST /jobs) instead of "
                             "one direct survey")
    parser.add_argument("--http-port", type=int, default=None,
                        help="the job service's port (with --serve; 0 = "
                             "ephemeral, logged)")
    parser.add_argument("--http-host", default="127.0.0.1")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def _run_direct(opts):
    from ..beams.coincidence import group_summary
    from ..beams.multibeam import multibeam_search

    result = multibeam_search(
        opts.fnames, opts.dmmin, opts.dmmax,
        snr_threshold=opts.snr_threshold, output_dir=opts.output_dir,
        resume=not opts.no_resume, max_chunks=opts.max_chunks,
        batched=not opts.sequential, canary_rate=opts.canary_rate,
        veto_frac=opts.veto_frac, max_real_beams=opts.max_real_beams,
        device=opts.device)
    for beam in result["beams"]:
        logger.info("beam %s (%s): %d hit(s)%s", beam["beam"],
                    os.path.basename(beam["fname"]), len(beam["hits"]),
                    " [cancelled]" if beam["cancelled"] else "")
    coinc = result["coincidence"]
    if coinc is not None:
        for row in group_summary(coinc["groups"]):
            logger.info("coincidence %-9s t=%.3fs DM=%.1f S/N=%.1f "
                        "beams=%s (%d member(s))", row["verdict"],
                        row["time_s"], row["dm"], row["snr"],
                        ",".join(row["beams"]), row["n_members"])
        print(json.dumps({"coincidence": coinc["stats"]}))
    return 0


def _run_service(opts):
    import time

    from ..beams.service import SurveyService
    from ..obs.server import start_obs_server

    if opts.http_port is None:
        logger.error("--serve needs --http-port (0 = ephemeral)")
        return 2
    out = opts.output_dir or os.getcwd()
    service = SurveyService(out, resume=not opts.no_resume,
                            device=opts.device)
    server = start_obs_server(opts.http_port, host=opts.http_host,
                              service=service)
    logger.info("job service on http://%s:%d — POST /jobs to submit",
                opts.http_host, server.port)
    try:
        for fname in opts.fnames:
            job_id = service.submit({"fname": fname, "dmmin": opts.dmmin,
                                     "dmmax": opts.dmmax,
                                     "snr_threshold": opts.snr_threshold,
                                     "max_chunks": opts.max_chunks})
            logger.info("submitted %s as %s", fname, job_id)
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        logger.info("shutting down job service")
    finally:
        server.close()
        service.close()
    return 0


def main(args=None):
    parser = build_parser()
    opts = parser.parse_args(args)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if not opts.serve and not opts.fnames:
        parser.error("give at least one filterbank (or --serve)")
    if opts.serve:
        return _run_service(opts)
    return _run_direct(opts)


if __name__ == "__main__":
    raise SystemExit(main())
