"""Bandpass statistics and bad-channel detection (host side).

* :func:`get_spectral_stats` — one-pass mean and std bandpass spectra from
  running ``sum(x)`` / ``sum(x^2)`` moments over file blocks (reference
  ``stats.py:35-60``), in float64; the blocks come through the reader, so
  a 1/2/4-bit file is decoded on the host and a multi-IF file read as its
  IF sum, as in the JAX package;
* :func:`get_bad_chans` — channels above ``medfilt(spec, 11) +
  4 * ref_mad(spec)`` on either spectrum, cached in ``<file>.badchans``
  (reference ``stats.py:63-90``), the format the JAX package reads and
  writes;
* the moments as functions (:func:`moment_accumulate`,
  :func:`moments_to_spectra`), and :func:`spectral_stats_scan`, a loop
  over blocks already on the device that keeps its accumulator there
  (the JAX package's ``spectral_stats_scan_jax``).  The bad-channel scan
  of a file stays the host float64 loop above, as on the JAX package's
  main path.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io.sigproc import FilterbankReader
from ..ops.robust import median_filter_1d, ref_mad


def moment_accumulate(carry, block):
    """Fold one ``(nchans, n)`` block into the running ``(sum, sumsq,
    count)``; ``block`` (an array or a tensor) is cast to the sums'
    dtype.  A pure function, the JAX package's."""
    s, sq, n = carry
    block_f = (block.to(s.dtype) if isinstance(block, torch.Tensor)
               else block.astype(s.dtype) if hasattr(block, "astype")
               else block)
    return (s + block_f.sum(axis=1),
            sq + (block_f ** 2).sum(axis=1),
            n + block.shape[1])


def moments_to_spectra(s, sq, n):
    """Running moments -> ``(mean, std)`` spectra, ``std = sqrt(E[x^2] -
    E[x]^2)`` clipped at 0 (reference ``stats.py:55-57``); arrays or
    tensors."""
    mean = s / n
    var = sq / n - mean ** 2
    if isinstance(var, torch.Tensor):
        return mean, torch.sqrt(torch.clamp(var, min=0.0))
    return mean, np.sqrt(np.maximum(var, 0.0))


def spectral_stats_scan(chunks):
    """Mean and std spectra of ``chunks`` ``(nchunks, nchans, chunk_len)``
    (a tensor on its device), the accumulator kept there: the JAX
    package's ``spectral_stats_scan_jax``, in float32 around a
    per-channel pivot (the first chunk's mean), so the variance does not
    cancel in ``E[x^2] - E[x]^2`` when the bandpass baseline is large.
    Returns ``(mean, std)`` float32 tensors on the chunks' device."""
    chunks = torch.as_tensor(chunks).to(torch.float32)
    nchans = chunks.shape[1]
    pivot = chunks[0].mean(dim=1)
    carry = (torch.zeros(nchans, dtype=torch.float32, device=chunks.device),
             torch.zeros(nchans, dtype=torch.float32, device=chunks.device),
             torch.zeros((), dtype=torch.float32, device=chunks.device))
    for block in chunks:
        carry = moment_accumulate(carry, block - pivot[:, None])
    mean, std = moments_to_spectra(*carry)
    return pivot + mean, std


def get_spectral_stats(source, chunksize=10000):
    """Mean and std spectra of a filterbank path or reader, or of an
    in-memory ``(nchans, nsamples)`` array."""
    if isinstance(source, (str, os.PathLike)):
        source = FilterbankReader(source)
    if not isinstance(source, FilterbankReader):
        data = np.asarray(source, dtype=float)
        return data.mean(axis=1), data.std(axis=1)
    s = np.zeros(source.nchans)
    sq = np.zeros(source.nchans)
    n = 0
    for _, block in source.iter_blocks(chunksize):
        s = s + block.sum(axis=1)
        sq = sq + (block ** 2).sum(axis=1)
        n = n + block.shape[1]
    mean = s / n
    return mean, np.sqrt(np.maximum(sq / n - mean ** 2, 0.0))


def flag_bad_channels(mean_spec, std_spec, medfilt_size=11, nsigma=4.0):
    """Flag channels above the median-filtered baseline of either
    spectrum by ``nsigma`` reference-MADs (reference ``stats.py:70-77``)."""
    bad = None
    for spec in (mean_spec, std_spec):
        spec = torch.as_tensor(np.asarray(spec, dtype=np.float64))
        smooth = median_filter_1d(spec, medfilt_size)
        flagged = spec > smooth + nsigma * ref_mad(spec)
        bad = flagged if bad is None else bad | flagged
    return bad.numpy()


def get_bad_chans(source, cache=None, surelybad=(), refresh=False,
                  spectra=None):
    """Bad-channel mask (file channel order) with a ``.badchans`` text
    cache beside a file source; ``surelybad`` channels are always bad.
    ``spectra=(mean, std)`` reuses bandpass spectra already computed
    (``PUstats --plot``) instead of reading the file again."""
    path = source if isinstance(source, (str, os.PathLike)) else None
    if cache is None and path is not None:
        cache = f"{path}.badchans"
    if spectra is None and cache is not None and os.path.exists(cache) \
            and not refresh:
        bad = np.loadtxt(cache).astype(bool)
    else:
        bad = flag_bad_channels(*(spectra if spectra is not None
                                  else get_spectral_stats(source)))
        if cache is not None:
            np.savetxt(cache, [bad.astype(int)], fmt="%d")
    bad = np.array(bad, dtype=bool).reshape(-1)
    for chan in surelybad:
        bad[int(chan)] = True
    return bad
