"""Write a cleaned copy of a filterbank file (the JAX package's
``cleanup_data``, the reference's ``clean.py:354-357`` made real).

The file is read in chunks of frames; on ``device`` each chunk's flagged
channels are zeroed and, with ``fft_zap``, periodic broadband RFI is
nulled in the Fourier domain (:func:`..ops.clean_ops.fft_zap_time`, in
float64, the mask applied again after the inverse transform); the output
keeps the header, channel order, ``nbits`` and ``nifs`` of the input, its
bytes those of the JAX package's ``PUclean`` (rounded and clipped as its
writer does).  A multi-IF file is cleaned plane by plane under one mask,
that of the IF-summed bandpass.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..io.sigproc import FilterbankReader, FilterbankWriter, read_header
from ..ops.clean_ops import fft_zap_time
from ..utils.device import resolve_device, to_numpy
from .spectral_stats import get_bad_chans

logger = logging.getLogger("pulsarutils_tpu_torch")


def cleanup_data(fname, outname, surelybad=(), fft_zap=False,
                 chunksize=65536, device="cuda", summary=None):
    """Stream-clean ``fname`` into ``outname``; returns the bad-channel
    mask (file order: :func:`.spectral_stats.get_bad_chans` and
    ``surelybad``).  ``device``: where the chunks are cleaned (``"cuda"``
    by default, raising without a card; ``"cpu"`` on request).  Each
    chunk's frames cross to ``device`` as stored (a low-bit file's packed
    bytes), are decoded, cleaned in float64 and encoded there
    (:meth:`~..io.sigproc.FilterbankReader.frame_values`,
    :meth:`~..io.sigproc.FilterbankWriter.encode_frames`), and come back
    as the output's frames.  ``summary``, a dict, receives ``zapped``
    (each chunk's zapped Fourier bins, a list of ``(istart, if, bins)``)
    and ``nzapped`` (their total)."""
    dev = resolve_device(device)
    mask = get_bad_chans(fname, surelybad=surelybad)
    reader = FilterbankReader(fname)
    raw_header, _ = read_header(fname)
    raw_header.setdefault("nbits", reader.header.get("nbits", 32))
    nchans, nifs = reader.nchans, reader.nifs
    flagged = torch.as_tensor(np.tile(mask, nifs)).to(dev)
    zapped_bins = []
    with FilterbankWriter(outname, raw_header) as writer:
        for istart in range(0, reader.nsamples, chunksize):
            frames = torch.from_numpy(reader.read_frames(
                istart, chunksize).view(reader.frame_dtype)).to(dev)
            values = reader.frame_values(frames).masked_fill_(flagged, 0.0)
            # each IF plane on its own, the mask applied again after the
            # inverse transform (it leaks a little into zeroed channels)
            for k in range(nifs if fft_zap else 0):
                cols = slice(k * nchans, (k + 1) * nchans)
                plane, zapped = fft_zap_time(values[:, cols].T.contiguous())
                values[:, cols] = plane.T
                zapped_bins.append((istart, k,
                                    np.flatnonzero(to_numpy(zapped))))
            if fft_zap:
                values.masked_fill_(flagged, 0.0)
            writer.write_frames(writer.encode_frames(values))
    nzapped = sum(len(b) for *_, b in zapped_bins)
    logger.info("cleaned %s -> %s (%d bad channels%s)", fname, outname,
                int(mask.sum()),
                f", {nzapped} Fourier bins zapped" if fft_zap else "")
    if summary is not None:
        summary.update(zapped=zapped_bins, nzapped=nzapped)
    return mask
