"""Robust statistics and periodicity scores on tensors.

* :func:`median` — the median as NumPy and JAX define it: the mean of the
  two middle values at even length.  ``torch.median`` returns the *lower*
  middle value instead, so it is not used anywhere in this package.
* :func:`mad` / :func:`ref_mad` — normalised median absolute deviation
  and its first-difference form (reference ``stats.py:11-32``).
* :func:`median_filter_1d` — zero-padded running median
  (``scipy.signal.medfilt`` semantics).
* :func:`z_n_test` / :func:`h_test` / :func:`digitize` — the Z^2_n and
  de Jager H statistics of a binned profile, and the count scaling they
  are fed (reference ``clean.py:183-189,252-255``);
  :func:`h_test_batch` the H-test of a batch of profiles.

Every function accepts a tensor or an array-like (turned into a CPU
tensor) and returns tensors.
"""

from __future__ import annotations

import numpy as np
import torch

#: Phi^-1(3/4): makes the MAD estimate sigma for Gaussian data.
MAD_SCALE = 0.6744897501960817


def median(x, dim=None, keepdim=False):
    """Median with NumPy's even-length convention (mean of the two middle
    values); ``dim=None`` reduces over every element."""
    x = torch.as_tensor(x)
    if dim is None:
        out = median(x.reshape(-1), dim=0)
        return out.reshape([1] * x.ndim) if keepdim else out
    n = x.shape[dim]
    ordered = torch.sort(x, dim=dim).values
    hi = ordered.narrow(dim, n // 2, 1)
    if n % 2:
        mid = hi
    else:
        mid = (ordered.narrow(dim, n // 2 - 1, 1) + hi) * 0.5
    return mid if keepdim else mid.squeeze(dim)


def mad(array, axis=None):
    """Normalised median absolute deviation ``median(|x - med|) / 0.6745``
    of ``array``; ``axis=None`` reduces over the whole array, an integer
    along that axis (the JAX package's keywords)."""
    array = torch.as_tensor(array)
    med = median(array, dim=axis, keepdim=axis is not None)
    return median(torch.abs(array - med), dim=axis) / MAD_SCALE


def ref_mad(array, window=1):
    """``mad(diff(array)) / sqrt(2)``; ``window > 1`` takes the minimum
    over non-overlapping windows of that many samples."""
    d = torch.diff(torch.as_tensor(array))
    if window and window > 1:
        n = d.shape[0] // int(window)
        if n >= 1:
            blocks = d[: n * int(window)].reshape(n, int(window))
            return torch.min(mad(blocks, axis=1)) / np.sqrt(2)
    return mad(d) / np.sqrt(2)


def median_filter_1d(x, size):
    """Running median with zero padding; ``size`` must be odd."""
    if size % 2 != 1:
        raise ValueError("median filter size must be odd")
    x = torch.as_tensor(x)
    half = size // 2
    pad = torch.zeros(half, dtype=x.dtype, device=x.device)
    windows = torch.cat([pad, x, pad]).unfold(0, size, 1)
    return median(windows, dim=1)


def z_n_test(profile, n_harmonics):
    """Z^2_n of a binned phase profile: ``(2/N) sum_{k<=n} |FFT_k|^2``."""
    # putpu-lint: disable=float64-leak — one profile, the JAX float64 statistic
    profile = torch.as_tensor(profile).to(torch.float64)
    nbin = profile.shape[0]
    n_harmonics = int(n_harmonics)
    if n_harmonics > nbin // 2:
        raise ValueError(
            f"n_harmonics={n_harmonics} exceeds the {nbin // 2} harmonics "
            f"resolvable in a {nbin}-bin profile")
    spec = torch.fft.rfft(profile)
    powers = torch.abs(spec[1:n_harmonics + 1]) ** 2
    return 2.0 / profile.sum() * powers.sum()


def h_test(profile, nmax=20):
    """de Jager H-test: ``max_m (Z^2_m - 4m + 4)``; returns ``(H, m_best)``."""
    # putpu-lint: disable=float64-leak — one profile, the JAX float64 statistic
    profile = torch.as_tensor(profile).to(torch.float64)
    n = profile.shape[0]
    nmax = int(max(1, min(nmax, n // 2 if n >= 4 else 1)))
    spec = torch.fft.rfft(profile)
    powers = torch.abs(spec[1:nmax + 1]) ** 2
    z2 = 2.0 / profile.sum() * torch.cumsum(powers, dim=0)
    m = torch.arange(1, nmax + 1, dtype=profile.dtype)
    h_candidates = z2 - 4.0 * m + 4.0
    best = torch.argmax(h_candidates)
    return h_candidates[best], best + 1


def h_test_batch(profiles, nmax=20, total=None):
    """H-test of a batch of profiles ``(nprof, nbin)``: ``(H, m_best)``.

    ``total`` overrides the ``2 / total`` normalisation (default: each
    profile's sum, the event-count convention); for profiles folded from
    Gaussian data pass ``T * sigma**2``.  A float tensor keeps its dtype
    (the device path runs float32); anything else becomes float64.
    """
    profiles = torch.as_tensor(profiles)
    if not profiles.is_floating_point():
        # putpu-lint: disable=float64-leak — integer input, the JAX promotion
        profiles = profiles.to(torch.float64)
    nbin = profiles.shape[1]
    nmax = int(max(1, min(nmax, nbin // 2 if nbin >= 4 else 1)))
    if total is None:
        total = profiles.sum(dim=1, keepdim=True)
    else:
        total = torch.as_tensor(total).to(
            device=profiles.device, dtype=profiles.dtype).reshape(-1, 1)
    spec = torch.fft.rfft(profiles, dim=1)
    powers = torch.abs(spec[:, 1:nmax + 1]) ** 2
    # a tensor divide: Python's 2.0 / tensor is a reciprocal multiply
    z2 = torch.full_like(total, 2.0) / total * torch.cumsum(powers, dim=1)
    m = torch.arange(1, nmax + 1, device=profiles.device)[None, :]
    h_candidates = z2 - 4.0 * m + 4.0
    best = torch.argmax(h_candidates, dim=1)
    h = torch.gather(h_candidates, 1, best[:, None])[:, 0]
    return h, best + 1


def digitize(data, center=None, scale=None):
    """``rint(clip((x - median) / MAD * 3, 0, inf))`` as int32 counts;
    integer input passes through unchanged."""
    data = torch.as_tensor(data)
    if not data.is_floating_point():
        return data
    std = mad(data) if scale is None else scale
    med = median(data) if center is None else center
    scaled = (data - med) / std * 3.0
    scaled = torch.where(scaled < 0, 0.0, scaled)
    return torch.round(scaled).to(torch.int32)
