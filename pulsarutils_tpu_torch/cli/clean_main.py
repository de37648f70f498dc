"""``PUclean``: write cleaned filterbank files.

    python -m pulsarutils_tpu_torch.cli.clean_main FILE.fil [-o OUT]
        [--surelybad C ...] [--fft-zap] [--chunksize N] [--device cpu]

The JAX package's ``PUclean`` flags, plus ``--device`` (default
``cuda``): bad channels zeroed and, with ``--fft-zap``, periodic RFI
nulled in the Fourier domain (:func:`..pipeline.cleanup.cleanup_data`);
the output keeps the input's header, ``nbits`` and ``nifs``.
"""

from __future__ import annotations

import argparse
import logging
import os

from ..pipeline.cleanup import cleanup_data


def main(args=None):
    parser = argparse.ArgumentParser(
        description="Zero bad channels (and optionally Fourier-zap periodic "
                    "RFI) and write cleaned filterbank files")
    parser.add_argument("fnames", nargs="+",
                        help="input SIGPROC filterbank files")
    parser.add_argument("-o", "--output", default=None,
                        help="output file (single input) or directory; "
                             "default: <input>_clean.fil")
    parser.add_argument("--surelybad", type=int, nargs="*", default=[])
    parser.add_argument("--fft-zap", action="store_true")
    parser.add_argument("--chunksize", type=int, default=65536)
    parser.add_argument("--device", default="cuda",
                        help="where the chunks are cleaned (cuda or cpu)")
    opts = parser.parse_args(args)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    for fname in opts.fnames:
        if opts.output and len(opts.fnames) == 1 and \
                not os.path.isdir(opts.output):
            outname = opts.output
        else:
            stem, ext = os.path.splitext(os.path.basename(fname))
            outdir = opts.output if opts.output else os.path.dirname(
                os.path.abspath(fname))
            outname = os.path.join(outdir, f"{stem}_clean{ext or '.fil'}")
        cleanup_data(fname, outname, surelybad=opts.surelybad,
                     fft_zap=opts.fft_zap, chunksize=opts.chunksize,
                     device=opts.device)
    return 0


if __name__ == "__main__":  # python -m pulsarutils_tpu_torch.cli.clean_main
    import sys

    sys.exit(main())
