"""``PUstats``: bandpass statistics and bad-channel flagging (host code, as
in the JAX package).

    python -m pulsarutils_tpu_torch.cli.stats_main FILE.fil [--refresh]
        [--surelybad C ...] [--plot OUT.png] [--show]

Writes (or reuses) ``FILE.fil.badchans``, the JAX package's format;
``--plot`` and ``--show`` need matplotlib, imported only then.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from ..pipeline.spectral_stats import get_bad_chans, get_spectral_stats

logger = logging.getLogger("pulsarutils_tpu_torch")


def main(args=None):
    parser = argparse.ArgumentParser(
        description="Detect bad (RFI-loud) channels in filterbank files")
    parser.add_argument("fnames", nargs="+",
                        help="input SIGPROC filterbank files")
    parser.add_argument("--refresh", action="store_true",
                        help="ignore any cached .badchans file")
    parser.add_argument("--surelybad", type=int, nargs="*", default=[],
                        help="channel indices to force-flag")
    parser.add_argument("--plot", metavar="OUT.png", default=None,
                        help="save a bandpass diagnostic plot")
    parser.add_argument("--show", action="store_true",
                        help="also display the bandpass figure where a "
                             "display exists (a no-op on headless hosts)")
    opts = parser.parse_args(args)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    for fname in opts.fnames:
        # one pass over the file serves both the flags and the figure
        spectra = (get_spectral_stats(fname)
                   if opts.plot or opts.show else None)
        mask = get_bad_chans(fname, surelybad=opts.surelybad,
                             refresh=opts.refresh, spectra=spectra)
        logger.info("%s: %d bad channels: %s", fname, mask.sum(),
                    np.flatnonzero(mask).tolist())
        if opts.plot or opts.show:
            _plot_bandpass(spectra, mask, opts.plot, show=opts.show)
    return 0


def _plot_bandpass(spectra, mask, outname, show=False):
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    mean_spec, std_spec = spectra
    chans = np.arange(mean_spec.size)
    fig, axes = plt.subplots(2, 1, sharex=True, figsize=(8, 6))
    for ax, spec, label in ((axes[0], mean_spec, "mean"),
                            (axes[1], std_spec, "std")):
        ax.plot(chans, spec, drawstyle="steps-mid", color="grey", lw=0.8)
        ax.plot(chans[mask], spec[mask], "rx", ms=4)
        ax.set_ylabel(f"{label} bandpass")
    axes[1].set_xlabel("channel")
    if outname:
        fig.savefig(outname, bbox_inches="tight")
        logger.info("bandpass plot -> %s", outname)
    if show:
        plt.show()
    plt.close(fig)


if __name__ == "__main__":  # python -m pulsarutils_tpu_torch.cli.stats_main
    import sys

    sys.exit(main())
