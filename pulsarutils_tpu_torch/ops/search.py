"""The dedispersion search: plan -> dedisperse every trial -> boxcar S/N.

:func:`dedispersion_search` is the port of the JAX package's direct-sweep
search (``kernel="pallas"``, which its ``kernel="auto"`` picks on the
accelerator): host float64 plan and offsets, the sweep in trial
superblocks through :func:`~.dedisperse_cuda.dedisperse_plane` (the CUDA
kernel on the card, the plain version on the CPU), and the batched boxcar
scorer of the reference (``pulsarutils/dedispersion.py:186-201``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device, to_numpy
from ..utils.table import ResultTable
from .dedisperse_cuda import dedisperse_plane
from .plan import dedispersion_plan, offsets_for
from .rebin import block_sum_time

#: boxcar widths tried by the scorer (reference ``dedispersion.py:190-191``)
SEARCH_WINDOWS = (1, 2, 4, 8)

#: trials dedispersed per sweep call — bounds the live plane to
#: superblock * nsamples floats (512 x 1M = 2 GB) regardless of ndm
SUPERBLOCK = 512

#: kernels of the JAX package that later slices port, with their
#: ROADMAP.md item
LATER_KERNELS = {
    "hybrid": "queue A, item 5 (hybrid and noise certificate)",
    "fdmt": "queue A, item 4 (FDMT)",
    "fourier": "queue A, item 6 (Fourier-domain dedispersion)",
    "gather": "queue A, item 2 (the XLA gather/roll formulations)",
    "roll": "queue A, item 2 (the XLA gather/roll formulations)",
}


def score_profiles(plane):
    """Score a block of dedispersed series ``(ndm, T)``.

    Returns ``(maxvalues, stds, best_snrs, best_windows, best_peaks)`` per
    trial: the mean-subtracted series' max and std, and for boxcar block
    sums of width 1, 2, 4, 8 the best ``max / std`` with its width and
    peak sample (first argmax of the block sums times the width, as an
    integer — exact at any ``T``).

    The block-sum pyramid is incremental (width 4 sums width 2's sums,
    width 8 sums width 4's), reading less than summing each width from
    the series; ``floor(floor(T/2)/2) == floor(T/4)``, so every width
    covers the same samples.  The mean subtraction stays materialised up
    front: folding it into the reductions would read raw block sums that
    cancel catastrophically in float32 on planes with a large DC offset.
    """
    x = plane - plane.mean(dim=1, keepdim=True)
    maxvalues = x.max(dim=1).values
    stds = torch.std(x, dim=1, correction=0)
    ndm = x.shape[0]
    best_snrs = torch.zeros(ndm, dtype=x.dtype, device=x.device)
    best_windows = torch.zeros(ndm, dtype=torch.int32, device=x.device)
    best_peaks = torch.zeros(ndm, dtype=torch.int64, device=x.device)
    reb = x
    for window in SEARCH_WINDOWS:
        if window > 1:
            reb = block_sum_time(reb, 2)
        top, arg = reb.max(dim=1)
        snr = top / torch.std(reb, dim=1, correction=0)
        better = snr > best_snrs
        best_snrs = torch.where(better, snr, best_snrs)
        best_windows = torch.where(better, window, best_windows)
        best_peaks = torch.where(better, arg * window, best_peaks)
    return maxvalues, stds, best_snrs, best_windows, best_peaks


def _search_direct(data, offsets, capture_plane):
    """Dedisperse in trial superblocks and score each; the scores come
    back to the host once, at the end."""
    ndm, nsamples = offsets.shape[0], data.shape[1]
    if ndm == 0:  # an empty plan (inverted DM range): an empty table
        plane = (torch.zeros((0, nsamples), dtype=data.dtype,
                             device=data.device) if capture_plane else None)
        return (*[np.zeros(0, np.float32)] * 3, np.zeros(0, np.int32),
                np.zeros(0, np.int64), plane)
    scores, planes = [], []
    for lo in range(0, ndm, SUPERBLOCK):
        plane = dedisperse_plane(data, offsets[lo:lo + SUPERBLOCK])
        scores.append(score_profiles(plane))
        if capture_plane:
            planes.append(plane)
    fields = [to_numpy(torch.cat([s[i] for s in scores])) for i in range(5)]
    plane = None
    if capture_plane:
        plane = planes[0] if len(planes) == 1 else torch.cat(planes)
    return (*fields, plane)


def dedispersion_search(data, dmmin, dmmax, start_freq, bandwidth, sample_time,
                        show=False, *, capture_plane=None, trial_dms=None,
                        kernel="auto", device="cuda"):
    """Sweep trial DMs over ``data`` ``(nchan, T)`` and score each series.

    ``kernel`` ``"auto"`` and ``"pallas"`` both run the exact direct sweep
    (the JAX package's names, so its flags carry over); the JAX package's
    other kernels raise ``NotImplementedError``.  ``trial_dms`` replaces
    the default plan (one trial per integer sample of band-crossing
    delay).  ``device`` is where the search runs: ``"cuda"`` (default;
    raises without a card) or ``"cpu"``.

    Returns a :class:`~..utils.table.ResultTable` with columns
    ``DM, max, std, snr, rebin, peak`` — plus the ``(ndm, T)`` plane
    tensor when ``show`` or ``capture_plane`` is set.
    """
    if kernel in LATER_KERNELS:
        raise NotImplementedError(
            f"kernel={kernel!r} is not ported yet: ROADMAP.md "
            f"{LATER_KERNELS[kernel]}")
    if kernel not in ("auto", "pallas"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if capture_plane is None:
        capture_plane = bool(show)
    if capture_plane == "memmap":
        raise NotImplementedError(
            "capture_plane='memmap' is not ported yet (ROADMAP.md queue A, "
            "item 2)")
    dev = resolve_device(device)
    data = torch.as_tensor(data).to(device=dev, dtype=torch.float32)
    if data.ndim != 2:
        raise ValueError(f"data must be (nchan, T), got {tuple(data.shape)}")
    nchan, nsamples = data.shape
    if trial_dms is None:
        trial_dms = dedispersion_plan(nchan, dmmin, dmmax, start_freq,
                                      bandwidth, sample_time)
    trial_dms = np.asarray(trial_dms, dtype=np.float64)
    offsets = offsets_for(trial_dms, nchan, start_freq, bandwidth,
                          sample_time, nsamples)
    (maxvalues, stds, best_snrs, best_windows, best_peaks,
     plane) = _search_direct(data.contiguous(), offsets, capture_plane)
    table = ResultTable({
        "DM": trial_dms,
        "max": maxvalues,
        "std": stds,
        "snr": best_snrs,
        "rebin": best_windows,
        "peak": best_peaks,
    })
    return (table, plane) if capture_plane else table
