"""Rebinning: block-sum down-sampling along the time axis.

Both functions truncate trailing samples that do not fill a whole block,
like the reference's ``quick_resample`` (``pulsarutils/dedispersion.py:
38-57``).
"""

from __future__ import annotations

import torch


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
