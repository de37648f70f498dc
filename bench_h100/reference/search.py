"""The plain single-pulse search: chunk plan, trial grid, cleaning, the
direct dedispersion sweep and the boxcar scoring.

Straight from the survey's physics and the search's published rules:

* dispersion delay ``4149 * DM / f**2`` s (f in MHz), each channel's delay
  taken at its lower edge and relative to the band centre, floor-divided
  by the sample time and rounded to nearest even; shifts wrap around the
  chunk (a circular sweep);
* one trial per integer sample of band-crossing delay from ``dmmin`` to
  ``dmmax``;
* chunks twice the band-crossing delay at ``dmmax``, rounded up to a
  multiple of 1024 samples, advancing by half a chunk;
* the cleaning: divide out the Gaussian-smoothed mean light curve of the
  good channels (sigma ``min(101, T // 100 * 2 + 1)`` samples, scipy's
  ``reflect`` edges, radius ``int(4 sigma + 0.5)``), normalise each
  channel to ``(x - mean) / mean``, zero the bad channels;
* the score of a dedispersed series: minus its mean, then for boxcar block
  sums of width 1, 2, 4 and 8 samples the largest ``max / std``, with its
  width and peak sample.

Everything runs in plain PyTorch, in float64 except the channel sums,
which run in ``dtype`` (float32 as the survey's search states, or a lower
precision for the control).
"""

from __future__ import annotations

import numpy as np
import torch

DM_CONST = 4149.0
SMEAR_CONST = 8300.0
WIDTHS = (1, 2, 4, 8)


def delta_delay(dm, f_lo, f_hi):
    return DM_CONST * dm * (f_lo ** -2.0 - f_hi ** -2.0)


def chunk_plan(tsamp, dmmin, dmmax, fbottom, ftop, chan_width):
    """``(step, hop, resample)`` of the chunking."""
    step = max(int(delta_delay(dmmax, fbottom, ftop) / tsamp) * 2, 128)
    smear = SMEAR_CONST * dmmin * chan_width / fbottom ** 3
    ratio = max(smear / 10, tsamp) / tsamp
    resample = int(np.rint(ratio)) if ratio >= 2 else 1
    if step >= 1024 * resample:
        quantum = 1024 * resample
        step = -(-step // quantum) * quantum
    return step, step // 2, resample


def chunk_starts(nsamples, step, hop):
    """Chunk starts: every hop, skipping a tail shorter than a hop and a
    chunk wholly inside the one before."""
    out = []
    for s in range(0, nsamples, hop):
        if min(step, nsamples - s) < hop:
            continue
        if out and s - hop == out[-1] and out[-1] + step >= nsamples:
            continue
        out.append(s)
    return out


def trial_dms(dmmin, dmmax, fbottom, bandwidth, tsamp):
    f0, f1 = float(fbottom), float(fbottom) + float(bandwidth)
    lo = delta_delay(float(dmmin), f0, f1) / tsamp
    hi = delta_delay(float(dmmax), f0, f1) / tsamp
    return np.arange(lo, hi + 1) * tsamp / DM_CONST / (f0 ** -2.0
                                                         - f1 ** -2.0)


def offsets(dms, nchan, fbottom, bandwidth, tsamp, nsamples):
    """``(ntrial, nchan)`` int64 sample shifts, wrapped into the chunk."""
    dms = np.asarray(dms, dtype=np.float64)
    f_lo = fbottom + np.arange(nchan) * (bandwidth / nchan)
    centre = fbottom + bandwidth / 2.0
    delay = DM_CONST * dms[:, None] * (f_lo[None, :] ** -2.0
                                       - centre ** -2.0)
    shifts = np.rint(delay // tsamp)
    return (shifts % nsamples).astype(np.int64)


def _gaussian_reflect(x, sigma):
    radius = int(4.0 * float(sigma) + 0.5)
    if radius == 0:
        return x
    k = np.exp(-0.5 * (np.arange(-radius, radius + 1) / float(sigma)) ** 2)
    k /= k.sum()
    padded = x
    left = right = radius
    while left > 0 or right > 0:       # repeat the mirror while too short
        n = padded.shape[0]
        a, b = min(left, n), min(right, n)
        padded = np.concatenate([padded[:a][::-1], padded,
                                 padded[n - b:][::-1]])
        left, right = left - a, right - b
    return np.convolve(padded, k, mode="valid")


def clean(codes, bad=None, resample=1):
    """The cleaned chunk: ``codes`` ``(nchan, T)`` in ascending band order
    on the device, ``bad`` a bool ``(nchan,)`` array (ascending) or None.
    Computed in float64, returned as float32."""
    x = codes.to(torch.float64)
    nchan, n = x.shape
    bad_t = torch.zeros(nchan, dtype=torch.bool, device=x.device) \
        if bad is None else torch.as_tensor(bad, device=x.device)
    good = ~bad_t
    lc = (x * good[:, None]).sum(0) / max(int(good.sum()), 1)
    sigma = min(101, n // 100 * 2 + 1)
    smooth = _gaussian_reflect(lc.cpu().numpy(), sigma)
    smooth = np.where(smooth == 0, 1.0, smooth)
    factor = torch.from_numpy(np.median(smooth) / smooth).to(x.device)
    y = x * factor[None, :]
    spec = y.mean(1, keepdim=True)
    y = (y - spec) / torch.where(spec == 0, 1.0, spec)
    y[bad_t] = 0.0
    if resample > 1:
        m = n // resample
        y = y[:, :m * resample].reshape(nchan, m, resample).sum(-1)
    return y.to(torch.float32)


def dedisperse(x, offs, dtype=torch.float32, chan_block=64):
    """``(rows, T)`` series: row ``r`` sums every channel ``c`` of ``x``
    ``(nchan, T)`` shifted left by ``offs[r, c]``, circularly, in
    ``dtype``."""
    nchan, n = x.shape
    xx = torch.cat([x, x], dim=1).to(dtype)
    windows = xx.unfold(1, n, 1)            # (nchan, n + 1, n), a view
    offs = torch.as_tensor(offs, device=x.device)
    out = torch.zeros((offs.shape[0], n), dtype=dtype, device=x.device)
    for c0 in range(0, nchan, chan_block):
        c1 = min(c0 + chan_block, nchan)
        chans = torch.arange(c0, c1, device=x.device)
        part = windows[chans[None, :], offs[:, c0:c1]]   # (rows, cb, n)
        out += part.sum(dim=1, dtype=dtype)
    return out


def score(series):
    """Per row of ``series`` ``(rows, T)``: a dict of float64 ``snr``, int
    ``width`` and ``peak``, and the centred series' ``max`` and ``std``."""
    x = series.to(torch.float64)
    x = x - x.mean(dim=1, keepdim=True)
    rows = x.shape[0]
    best = torch.zeros(rows, dtype=torch.float64, device=x.device)
    width = torch.zeros(rows, dtype=torch.int64, device=x.device)
    peak = torch.zeros(rows, dtype=torch.int64, device=x.device)
    reb = x
    for w in WIDTHS:
        if w > 1:
            m = reb.shape[1] // 2
            reb = reb[:, :2 * m].reshape(rows, m, 2).sum(-1)
        top, arg = reb.max(dim=1)
        snr = top / reb.std(dim=1, correction=0)
        better = snr > best
        best = torch.where(better, snr, best)
        width = torch.where(better, w, width)
        peak = torch.where(better, arg * w, peak)
    return {"snr": best.cpu().numpy(), "width": width.cpu().numpy(),
            "peak": peak.cpu().numpy(),
            "max": x.max(dim=1).values.cpu().numpy(),
            "std": x.std(dim=1, correction=0).cpu().numpy()}


def sweep_scores(x, offs, dtype=torch.float32, trial_block=64):
    """:func:`score` of every row of the sweep of ``x`` at ``offs``, a
    block of trials at a time."""
    parts = []
    for lo in range(0, offs.shape[0], trial_block):
        parts.append(score(dedisperse(x, offs[lo:lo + trial_block], dtype)))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
