"""Rebinning: block-sum down-sampling along the channel and time axes,
and the fractional stretch of the acceleration search.

The block sums truncate trailing elements that do not fill a whole
block, like the reference's ``quick_chan_rebin`` and ``quick_resample``
(``pulsarutils/dedispersion.py:15-57``).
"""

from __future__ import annotations

import torch


def quick_chan_rebin(counts, factor):
    """Rebin a ``(nchan, T)`` tensor along the channel (first) axis by an
    integer ``factor``, on the device it is on (reference
    ``pulsarutils/dedispersion.py:15-35``).  Trailing channels that do not
    fill a block are truncated; the dtype is kept, as in the JAX
    package:

    >>> quick_chan_rebin(torch.ones((5, 3), dtype=torch.float64), 2)
    tensor([[2., 2., 2.],
            [2., 2., 2.]], dtype=torch.float64)
    >>> quick_chan_rebin(torch.arange(8).reshape(4, 2), 2)
    tensor([[ 2,  4],
            [10, 12]])
    """
    counts = torch.as_tensor(counts)
    nchan, nbin = counts.shape
    n = int(nchan // factor)
    return counts[: n * factor, :].reshape(n, factor, nbin).sum(dim=1)


def quick_resample(counts, factor):
    """Rebin a ``(nchan, T)`` or ``(T,)`` tensor along time by ``factor``.

    Floating tensors keep their dtype; anything else sums in float32, the
    device convention of this package.
    """
    counts = torch.as_tensor(counts)
    squeeze = counts.ndim == 1
    if squeeze:
        counts = counts[None, :]
    nchan, nbin = counts.shape
    n = int(nbin // factor)
    if not counts.is_floating_point():
        counts = counts.to(torch.float32)
    out = counts[:, : n * factor].reshape(nchan, n, factor).sum(dim=2)
    return out[0] if squeeze else out


def block_sum_time(x, factor):
    """Block-sum a batch of series ``(..., T)`` along the last axis,
    truncating ``T`` to a multiple of ``factor``."""
    n = x.shape[-1] // factor
    return x[..., : n * factor].reshape(*x.shape[:-1], n, factor).sum(dim=-1)


def stretch_resample(x, indices):
    """``out[..., n] = x[..., indices[n]]``: resample the time (last) axis
    at integer indices precomputed on the host in float64 and already
    clipped to the axis (the acceleration search's quadratic stretch)."""
    x = torch.as_tensor(x)
    idx = torch.as_tensor(indices, device=x.device).to(torch.int64)
    return torch.index_select(x, -1, idx)
