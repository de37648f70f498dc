"""The yardstick of the kernels' roofline shares: the work a chunk's
inputs need, counted once, and the card's published peaks.

A frozen copy of the formulas the port states for its kernels, so that a
change to the program cannot move the yardstick.  Each input is read once
and each output written once, whatever a kernel reads again.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, at its 700 W limit: 67e12 float32 FLOP/s on
#: the CUDA cores counting a fused multiply-add as two, so 33.5e12 plain
#: adds a second; HBM3 at 3.35e12 bytes a second
PEAK_FP32_ADDS = 33.5e12
PEAK_HBM_BYTES_S = 3.35e12
PEAKS = {"NVIDIA H100 80GB HBM3": (PEAK_FP32_ADDS, PEAK_HBM_BYTES_S)}


def bound_s(adds, nbytes, peaks=(PEAK_FP32_ADDS, PEAK_HBM_BYTES_S)):
    """Least seconds on the card: the larger of the two bounds."""
    return max(adds / peaks[0], nbytes / peaks[1])


def sweep_work(ndm, nchan, nsamples):
    """B1, the direct sweep: one add per trial, channel and sample; the
    chunk, the offsets and the dedispersed plane once each."""
    return (ndm * nchan * nsamples,
            4 * (nchan * nsamples + ndm * nsamples + ndm * nchan))


def score_work(rows, nsamples, nout):
    """B4, the boxcar scorer: ~16 adds a sample; the plane read once and
    ``nout`` float64 scores written once."""
    return 16 * rows * nsamples, 4 * rows * nsamples + 8 * nout
