"""The direct dedispersion sweep in plain PyTorch.

``out[d, t] = sum_c x[c, (t + off[d, c]) mod T]`` for a block of trials,
accumulated over channels in ascending order, in float32, from zeros —
the order of the Pallas kernel (``pulsarutils_tpu/ops/
pallas_dedisperse.py``) and of ``dedisperse_block_roll_jax``, so its plane
equals theirs bit for bit.  It is the reference the CUDA kernel
(:mod:`.dedisperse_cuda`) is held against, and the sweep of
``device="cpu"`` runs.  The circular wrap is the reference's ``np.roll``
convention: a dispersed track that runs past the chunk end continues at
its start.
"""

from __future__ import annotations

import numpy as np
import torch


def dedisperse_plane_plain(data, offsets):
    """Dedispersed plane ``(ndm, T)`` of ``data`` ``(nchan, T)`` at the
    gather offsets ``offsets`` ``(ndm, nchan)`` (any integers; wrapped
    mod ``T``)."""
    nchan, nsamples = data.shape
    if not isinstance(offsets, torch.Tensor):
        offsets = np.array(offsets, dtype=np.int64)  # a writable copy
    off = torch.as_tensor(offsets, device=data.device).to(torch.int64)
    off = off % nsamples
    out = torch.zeros(off.shape[0], nsamples, dtype=data.dtype,
                      device=data.device)
    for c in range(nchan):
        # row t of the doubled channel's length-T windows is the channel
        # rolled left by t, so one row gather reads every trial's shift
        windows = torch.cat([data[c], data[c]]).unfold(0, nsamples, 1)
        out += windows[off[:, c]]
    return out
