"""Fourier-domain dedispersion (FDD): exact fractional-sample delays.

The port of the JAX package's ``ops/fourier.py``.  Every other kernel
quantises per-channel delays to integer samples; the FDD applies each
channel's exact delay as a phase ramp on its spectrum:

    out(t) = sum_c  F^-1[ F[data_c] * exp(+2pi i f tau_c(DM)) ](t)

— a circular advance by the un-rounded ``tau_c`` (the integer kernels'
gather convention ``out[t] = x[(t + shift) mod T]``), so results line up
with them bin for bin.

Two device paths, both on torch tensors:

* **uniform-grid incremental rotation** (every standard plan grid is
  uniform in DM, and the delay is linear in DM): trials run in anchored
  superblocks.  Each superblock's first trial takes its phase from the
  exact integer-limb table; each next trial is one complex multiply by
  the constant per-channel step ramp.  Both phasors and the
  rotate-accumulate recurrence are
  :func:`~.fourier_cuda.fdd_superblock_spectra`, which takes the
  spectrum and the limb tables: the hand-written kernel on the card (one
  launch a superblock, the phasors built in registers), its plain
  version in channel blocks on the CPU;
* **arbitrary-grid fallback**: the phase table is built from the limbs
  in bounded ``(dm_block, chan_block, nbin)`` pieces and consumed at
  once, in plain torch.

Phases never come from ``f * tau`` in float32 (~0.1 rad off at
``T = 2^20``): the host splits each phase slope into 12-bit integer
limbs (36 bits for anchors, 48 for the accumulated step) and the device
forms ``k * limb`` and masks it (int64 in plain torch, wrapping
unsigned 32-bit in the kernel), which gives the values of the JAX
package's wrapping int32 products.  The spectrum is ``torch.fft``'s
(a library FFT, as the JAX package leaves it to XLA), taken in channel
blocks; every superblock is scored with :func:`~.score_cuda.score_plane`.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..utils.device import resolve_device
from .plan import channel_frequencies, dm_delay

#: trials per device block in the arbitrary-grid fallback
FOURIER_DM_BLOCK = 4
#: channels per spectrum/phase block (both paths)
FOURIER_CHAN_BLOCK = 128
#: trials per anchored superblock in the uniform-grid path
FOURIER_SUPERBLOCK = 64

#: live-set budget (bytes) off the card: the JAX package's default
FDD_HBM_BUDGET = 12 << 30

_TWO_PI = np.float32(2.0 * np.pi)


def fdd_budget_bytes(device):
    """Bytes the FDD's live set may take on ``device``: on the card what
    is free now (including PyTorch's cached but unused blocks), on the
    CPU :data:`FDD_HBM_BUDGET`."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return int(free + cached)
    return FDD_HBM_BUDGET


def _fdd_live_bytes(nchan, t, superblock, chan_block, cross=False):
    """Conservative live-set estimate of an FDD run (the JAX package's
    formula): the resident spectrum, the float32 input, the per-block
    phasors, the superblock accumulators, twice the superblock's irfft,
    and with ``cross`` the fallback's ``dm_block x chan_block x nbin``
    phase tensor."""
    nbin = t // 2 + 1
    nchan_p = -(-nchan // chan_block) * chan_block
    spec = 8 * nchan_p * nbin
    data = 4 * nchan_p * t
    phasors = 8 * nbin * 4 * chan_block
    acc = 8 * nbin * 3 * superblock
    fft = 2 * 4 * superblock * t
    phase_cross = 2 * 8 * superblock * chan_block * nbin if cross else 0
    return spec + data + phasors + acc + fft + phase_cross


def _auto_fdd_blocks(nchan, t, superblock, chan_block, cross=False,
                     budget=FDD_HBM_BUDGET):
    """Shrink ``(superblock, chan_block)`` until the live-set estimate
    fits ``budget``; warns when it had to."""
    req = (superblock, chan_block)
    min_s = 1 if cross else 8
    while (_fdd_live_bytes(nchan, t, superblock, chan_block, cross)
           > budget and (superblock > min_s or chan_block > 32)):
        if chan_block <= 32 or (superblock > min_s
                                and 20 * superblock >= 16 * chan_block):
            superblock //= 2
        else:
            chan_block //= 2
    if (superblock, chan_block) != req:
        warnings.warn(
            f"FDD blocking {req} exceeds the memory budget "
            f"({_fdd_live_bytes(nchan, t, *req, cross) >> 30} GB est. > "
            f"{budget >> 30} GB); shrunk to ({superblock}, {chan_block})",
            stacklevel=3)
    return superblock, chan_block


def fractional_delays(trial_dms, nchan, start_freq, bandwidth):
    """Un-rounded per-channel delays (s), ``(ndm, nchan)``, relative to
    the band centre (the integer path's convention)."""
    trial_dms = np.atleast_1d(np.asarray(trial_dms, dtype=np.float64))
    freqs = channel_frequencies(nchan, start_freq, bandwidth)
    center = start_freq + bandwidth / 2.0
    return (dm_delay(trial_dms[:, None], freqs[None, :])
            - dm_delay(trial_dms, center)[:, None])


def _dedisperse_fourier_numpy(data, delays, sample_time):
    """The float64 oracle: one exact phase ramp per (trial, channel)."""
    data = np.asarray(data, dtype=np.float64)
    nchan, t = data.shape
    spec = np.fft.rfft(data, axis=1)
    f = np.fft.rfftfreq(t, d=sample_time)
    out = np.empty((delays.shape[0], t))
    for d in range(delays.shape[0]):
        phase = np.exp(2j * np.pi * f[None, :] * delays[d][:, None])
        out[d] = np.fft.irfft((spec * phase).sum(axis=0), n=t)
    return out


def _uniform_spacing(trial_dms):
    """The constant DM step of a uniform grid, or ``None``."""
    dms = np.asarray(trial_dms, dtype=np.float64)
    if dms.size < 2:
        return 0.0
    d = np.diff(dms)
    step = d.mean()
    scale = max(abs(step), abs(dms).max() * 1e-12, 1e-300)
    if np.abs(d - step).max() <= 1e-8 * scale:
        return float(step)
    return None


def _phase_limbs(delays, sample_time, t):
    """36-bit phase-slope limbs: ``A = tau / (tsamp * T) mod 1`` quantised
    and split into three 12-bit limbs, int32 ``(3, ndm, nchan)``.  The
    phase at rfft bin ``k`` is ``k * A`` cycles."""
    a = np.asarray(delays, dtype=np.float64) / (sample_time * t)
    m = np.rint((a % 1.0) * (1 << 36)).astype(np.int64) & ((1 << 36) - 1)
    return np.stack([(m >> 24).astype(np.int32),
                     ((m >> 12) & 0xFFF).astype(np.int32),
                     (m & 0xFFF).astype(np.int32)])


def _step_limbs(delays_step, sample_time, t):
    """48-bit limbs (four of 12 bits) of the per-trial step ramp, whose
    error accumulates over a superblock."""
    a = np.asarray(delays_step, dtype=np.float64) / (sample_time * t)
    m = np.rint((a % 1.0) * (1 << 48)).astype(np.int64) & ((1 << 48) - 1)
    return np.stack([(m >> 36).astype(np.int32),
                     ((m >> 24) & 0xFFF).astype(np.int32),
                     ((m >> 12) & 0xFFF).astype(np.int32),
                     (m & 0xFFF).astype(np.int32)])


def _uniform_fourier_inputs(trial_dms, dm_step, nchan, start_freq,
                            bandwidth, sample_time, t, superblock):
    """Host limb tables of the uniform-grid path: ``(anchor_limbs (3,
    nblocks, nchan), step_limbs (4, nchan), ndm)``; the grid is extended
    to whole superblocks."""
    dms = np.asarray(trial_dms, dtype=np.float64)
    ndm = dms.size
    nblocks = -(-ndm // superblock)
    anchors = dms[0] + dm_step * superblock * np.arange(nblocks)
    anchor_delays = fractional_delays(anchors, nchan, start_freq, bandwidth)
    anchor_limbs = _phase_limbs(anchor_delays, sample_time, t)
    step_delays = dm_step * fractional_delays(
        np.array([1.0]), nchan, start_freq, bandwidth)[0]
    step_limbs = _step_limbs(step_delays, sample_time, t)
    return anchor_limbs, step_limbs, ndm


def limb_phase(limbs, k, kf):
    """Unit phasors ``exp(2 pi i k A)`` from limbs ``(nlimb, ...)`` int64
    and bins ``k`` (int64) / ``kf`` (float32): ``(..., nbin)`` complex64.

    The limb products are formed in int64 and masked, which gives the
    values of the JAX package's wrapping int32 products; the float32 sum
    runs in its order."""
    m = [limbs[i][..., None] for i in range(limbs.shape[0])]
    th = ((k * m[0]) & 0xFFF).to(torch.float32) * (1.0 / (1 << 12))
    th = th + ((k * m[1]) & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
    th = th + kf * m[2].to(torch.float32) * float(2.0 ** -36)
    if len(m) > 3:
        # k * m4 / 2^48 < 2^-16: no wrap possible, float32 is ample
        th = th + kf * m[3].to(torch.float32) * float(2.0 ** -48)
    return torch.polar(torch.ones_like(th), th * float(_TWO_PI))


def _blocked_rfft(data, chan_block):
    """rFFT of ``data`` rows, ``chan_block`` rows at a time (bounds the
    FFT's temporaries); ``(nchan, T//2+1)`` complex64."""
    nchan, t = data.shape
    spec = torch.empty((nchan, t // 2 + 1), dtype=torch.complex64,
                       device=data.device)
    for lo in range(0, nchan, chan_block):
        spec[lo:lo + chan_block] = torch.fft.rfft(data[lo:lo + chan_block],
                                                  dim=1)
    return spec


def _emit(series, with_scores, keep_plane, scores, planes):
    from .score_cuda import score_plane

    if with_scores:
        scores.append(score_plane(series))
    if keep_plane:
        planes.append(series)


def _uniform_run(data, trial_dms, dm_step, start_freq, bandwidth,
                 sample_time, superblock, chan_block, with_scores,
                 keep_plane):
    from .fourier_cuda import fdd_superblock_spectra

    nchan, t = data.shape
    dev = data.device
    anchor_limbs, step_limbs, ndm = _uniform_fourier_inputs(
        trial_dms, dm_step, nchan, start_freq, bandwidth, sample_time, t,
        superblock)
    spec = _blocked_rfft(data, chan_block)
    # (nblocks, 3, nchan): each superblock's anchor table contiguous
    anchors = torch.from_numpy(np.ascontiguousarray(
        anchor_limbs.transpose(1, 0, 2))).to(dev)
    steps = torch.from_numpy(np.ascontiguousarray(step_limbs)).to(dev)
    scores, planes = [], []
    for i in range(anchors.shape[0]):
        # the last superblock runs only the trials the grid has
        nsb = min(superblock, ndm - i * superblock)
        acc = fdd_superblock_spectra(spec, anchors[i], steps, nsb,
                                     chan_block=chan_block)
        series = torch.fft.irfft(acc, n=t, dim=1)
        del acc
        _emit(series, with_scores, keep_plane, scores, planes)
    return scores, planes


def _fallback_run(data, phase_limbs, dm_block, chan_block, with_scores,
                  keep_plane):
    """The arbitrary-grid path from the ``(3, ndm, nchan)`` phase limbs of
    every (trial, channel) delay."""
    nchan, t = data.shape
    nbin = t // 2 + 1
    dev = data.device
    ndm = phase_limbs.shape[1]
    limbs = torch.from_numpy(phase_limbs.astype(np.int64)).to(dev)
    spec = _blocked_rfft(data, chan_block)
    k = torch.arange(nbin, dtype=torch.int64, device=dev)
    kf = k.to(torch.float32)
    scores, planes = [], []
    for d0 in range(0, ndm, dm_block):
        d1 = min(d0 + dm_block, ndm)
        acc = torch.zeros((d1 - d0, nbin), dtype=torch.complex64,
                          device=dev)
        for lo in range(0, nchan, chan_block):
            hi = min(lo + chan_block, nchan)
            phase = limb_phase(limbs[:, d0:d1, lo:hi], k, kf)
            acc = acc + (spec[None, lo:hi] * phase).sum(dim=1)
            del phase
        _emit(torch.fft.irfft(acc, n=t, dim=1), with_scores, keep_plane,
              scores, planes)
    return scores, planes


def _fourier_device_run(data, trial_dms, start_freq, bandwidth,
                        sample_time, with_scores, with_plane, dm_block,
                        chan_block):
    """The uniform-grid path when the trial grid allows it, the fallback
    otherwise.  Returns ``(stacked scores (5, ndm) float64 or None,
    plane (ndm, T) or None)``."""
    nchan, t = data.shape
    chan_block = chan_block or FOURIER_CHAN_BLOCK
    # putpu-lint: disable=device-trip — a host plan
    trial_dms = np.atleast_1d(np.asarray(trial_dms, dtype=np.float64))
    keep_plane = with_plane or not with_scores
    if trial_dms.size == 0:  # an empty plan (inverted DM range)
        # putpu-lint: disable=float64-leak — an empty host score pack
        stacked = torch.zeros((5, 0), dtype=torch.float64)
        plane = data.new_zeros((0, t))
        return (stacked if with_scores else None,
                plane if keep_plane else None)
    budget = fdd_budget_bytes(data.device)
    dm_step = _uniform_spacing(trial_dms)
    if dm_step is not None:
        superblock = max(1, min(dm_block or FOURIER_SUPERBLOCK,
                                trial_dms.size))
        superblock, chan_block = _auto_fdd_blocks(
            nchan, t, superblock, chan_block, budget=budget)
        scores, planes = _uniform_run(
            data, trial_dms, dm_step, start_freq, bandwidth, sample_time,
            superblock, chan_block, with_scores, keep_plane)
    else:
        dm_block, chan_block = _auto_fdd_blocks(
            nchan, t, min(dm_block or FOURIER_DM_BLOCK, trial_dms.size),
            chan_block, cross=True, budget=budget)
        delays = fractional_delays(trial_dms, nchan, start_freq, bandwidth)
        scores, planes = _fallback_run(
            data, _phase_limbs(delays, sample_time, t), dm_block,
            chan_block, with_scores, keep_plane)
    stacked = torch.cat(scores, dim=1) if with_scores else None
    plane = torch.cat(planes) if keep_plane else None
    return stacked, plane


def dedisperse_fourier(data, trial_dms, start_freq, bandwidth, sample_time,
                       dm_block=None, chan_block=None, *, device="cuda"):
    """Dedisperse ``data`` ``(nchan, T)`` at exact (fractional-sample)
    delays per trial; returns the ``(ndm, T)`` float32 plane on
    ``device``.  ``dm_block`` is the uniform path's trial superblock (or
    the fallback's trial block).  The float64 reference is
    :func:`_dedisperse_fourier_numpy`."""
    dev = resolve_device(device)
    data = torch.as_tensor(data).to(device=dev, dtype=torch.float32)
    _, plane = _fourier_device_run(
        data.contiguous(), trial_dms, start_freq, bandwidth, sample_time,
        with_scores=False, with_plane=True, dm_block=dm_block,
        chan_block=chan_block)
    return plane


def search_fourier(data, trial_dms, start_freq, bandwidth, sample_time,
                   capture_plane=False, dm_block=None, chan_block=None):
    """FDD sweep + the boxcar scorer on ``data``'s device (the path of
    ``dedispersion_search(kernel="fourier")``).  Returns ``(max, std,
    snr, window, peak, plane)``: host score columns and the plane tensor
    (or None)."""
    from .search import unstack_scores

    stacked, plane = _fourier_device_run(
        data, trial_dms, start_freq, bandwidth, sample_time,
        with_scores=True, with_plane=bool(capture_plane),
        dm_block=dm_block, chan_block=chan_block)
    return unstack_scores(stacked) + (plane,)
