"""Data conditioning and RFI excision on the device.

The cleaning steps of the search driver (``renormalize_data``, the
optional ``zero_dm_filter`` and ``fft_zap_time``), with the semantics of
the reference's ``clean.py:70-111`` as the JAX package runs them on its
device: float32 values, and the Gaussian and boxcar smoothing as a
convolution in the Fourier domain at a power-of-two size with the
``scipy.ndimage`` reflect boundary.  Beside them, the reference's two
channel flaggers of its public API, :func:`get_noisier_channels` and
:func:`measure_channel_variability` (``clean.py:58-67, 114-133``).
"""

from __future__ import annotations

import numpy as np
import torch

from .robust import mad, median, median_filter_1d, ref_mad


def _as_float(x):
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.float32)


def _symmetric_pad_1d(x, left, right):
    """'reflect' boundary of scipy.ndimage (edge value repeated)."""
    if left == 0 and right == 0:
        return x
    n = x.shape[0]
    left = min(left, n)
    right = min(right, n)
    return torch.cat([x[:left].flip(0), x, x[n - right:].flip(0)])


def _convolve_valid(padded, kernel):
    """``convolve(padded, kernel, mode='valid')`` through an rFFT at the
    next power of two."""
    kernel = torch.as_tensor(kernel, dtype=padded.dtype, device=padded.device)
    n = int(padded.shape[0])
    k = int(kernel.shape[0])
    size = 1 << int(np.ceil(np.log2(max(n + k - 1, 2))))
    full = torch.fft.irfft(torch.fft.rfft(padded, n=size)
                           * torch.fft.rfft(kernel, n=size), n=size)
    return full[k - 1:n]


def gaussian_filter_1d(x, sigma, truncate=4.0):
    """Gaussian smoothing like ``scipy.ndimage.gaussian_filter1d``
    (mode='reflect', radius ``int(truncate * sigma + 0.5)``)."""
    x = _as_float(x)
    radius = int(truncate * float(sigma) + 0.5)
    if radius == 0:
        return x
    kx = np.arange(-radius, radius + 1)
    kernel = np.exp(-0.5 * (kx / float(sigma)) ** 2)
    kernel = kernel / kernel.sum()
    # for radius >= n repeat the symmetric extension until long enough
    padded = x
    left = right = radius
    while left > 0 or right > 0:
        n = padded.shape[0]
        take_l, take_r = min(left, n), min(right, n)
        padded = _symmetric_pad_1d(padded, take_l, take_r)
        left, right = left - take_l, right - take_r
    return _convolve_valid(padded, kernel)


def uniform_filter_1d(x, size):
    """Boxcar mean like ``scipy.ndimage.uniform_filter1d`` (mode='reflect',
    window centred with left bias for even sizes)."""
    x = _as_float(x)
    size = int(size)
    if size <= 1:
        return x
    left = size // 2
    right = size - 1 - left
    padded = _symmetric_pad_1d(x, left, right)
    return _convolve_valid(padded, np.full(size, 1.0 / size))


def _mask_like(badchans_mask, array):
    nchan = array.shape[0]
    if badchans_mask is None:
        return torch.zeros(nchan, dtype=torch.bool, device=array.device)
    return torch.as_tensor(badchans_mask, dtype=torch.bool,
                           device=array.device)


def _masked_channel_mean(array, good):
    """Per-sample mean over the good channels."""
    ngood = torch.clamp(good.sum(), min=1)
    return torch.where(good[:, None], array, 0.0).sum(dim=0) / ngood


def get_noisier_channels(array, medfilt_size=7, nsigma=5.0):
    """Flag channels whose mean lies above the median-filtered bandpass
    by ``nsigma`` reference-MADs (reference ``clean.py:58-67``), on the
    device the data are on.  Returns a bool ``(nchan,)`` tensor."""
    array = _as_float(array)
    spec = array.mean(dim=1)
    smooth = median_filter_1d(spec, medfilt_size)
    return spec > smooth + nsigma * ref_mad(spec)


def measure_channel_variability(array, badchans_mask=None):
    """Flag channels whose time-std falls outside the robust quartile
    fences ``[q2 - 2(q2 - q1), q2 + 2(q3 - q2)]`` of the good channels
    (reference ``clean.py:114-133``), on the device the data are on; the
    channels already bad stay flagged.  Returns a bool ``(nchan,)``
    tensor."""
    array = _as_float(array)
    bad = _mask_like(badchans_mask, array)
    spec = torch.std(array, dim=1, correction=0)
    ordered = torch.sort(torch.where(bad, torch.inf, spec)).values
    ngood = int((~bad).sum())
    q1 = ordered[ngood // 4]
    q2 = ordered[ngood // 2]
    q3 = ordered[ngood // 4 * 3]
    lowlim = q2 - 2 * (q2 - q1)
    hilim = q2 + 2 * (q3 - q2)
    return (spec < lowlim) | (spec > hilim) | bad


def zero_dm_filter(array, badchans_mask=None):
    """Subtract the per-sample mean over good channels (zero-DM filter,
    Eatough, Keane & Lyne 2009); bad channels pass through."""
    array = torch.as_tensor(array)
    good = ~_mask_like(badchans_mask, array)
    mean_t = _masked_channel_mean(array, good)
    return torch.where(good[:, None], array - mean_t[None, :], array)


def renormalize_data(array, badchans_mask=None, baseline_window=101,
                     cut_outliers=False):
    """Condition a ``(nchan, T)`` filterbank chunk for searching.

    1. divide out the Gaussian-smoothed mean lightcurve of the good
       channels (window clipped to ``nsamples // 100 * 2 + 1``);
    2. per-channel bandpass normalisation ``(x - mean_c) / mean_c``;
    3. zero the bad channels;
    4. with ``cut_outliers``, zero time bins where the boxcar-smoothed
       mean lightcurve exceeds +5 sigma or dips below -3 sigma at any
       boxcar width 1, 2, 4, 8, 16.

    Returns a new float32 tensor; the input is not modified.
    """
    array = torch.as_tensor(array).to(torch.float32)
    nchan, nsamples = array.shape
    mask = _mask_like(badchans_mask, array)
    good = ~mask

    lc = _masked_channel_mean(array, good)
    window = min(int(baseline_window), nsamples // 100 * 2 + 1)
    lc_smooth = gaussian_filter_1d(lc, window)
    lc_smooth = torch.where(lc_smooth == 0, 1.0, lc_smooth)
    factor = median(lc_smooth) / lc_smooth
    renorm = array * factor[None, :]

    spec = renorm.mean(dim=1)
    denom = torch.where(spec == 0, 1.0, spec)
    # in place on the fresh product: same operations, one chunk-sized
    # buffer fewer
    renorm.sub_(spec[:, None]).div_(denom[:, None])
    renorm.masked_fill_(mask[:, None], 0.0)

    if cut_outliers:
        lc = renorm.mean(dim=0)
        bad_bins = torch.zeros(nsamples, dtype=torch.bool, device=array.device)
        for wpow in range(5):
            width = 1 << wpow
            lc_reb = uniform_filter_1d(lc, width)
            sigma = torch.std(lc_reb[::width], correction=0)
            bad_bins |= (lc_reb > 5 * sigma) | (lc_reb < -3 * sigma)
        renorm.masked_fill_(bad_bins[None, :], 0.0)
    return renorm


def fft_zap_time(array, nsigma=5.0, protect_dc=1):
    """Null Fourier bins of periodic broadband RFI in every channel.

    rFFT each channel, flag bins whose log channel-averaged power exceeds
    a running median by ``nsigma`` MADs (the first ``protect_dc`` bins are
    never flagged), inverse transform.  Returns ``(cleaned, zapped_mask)``.
    """
    array = _as_float(array)
    spec = torch.fft.rfft(array, dim=1)
    power = (torch.abs(spec) ** 2).mean(dim=0)
    logp = torch.log(power + 1e-30)
    baseline = median_filter_1d(logp, 11)
    sigma = mad(logp - baseline)
    zap = logp > baseline + nsigma * sigma
    if protect_dc:
        keep = torch.arange(zap.shape[0], device=zap.device) < protect_dc
        zap = zap & ~keep
    spec = torch.where(zap[None, :], 0.0, spec)
    cleaned = torch.fft.irfft(spec, n=array.shape[1], dim=1)
    return cleaned, zap
