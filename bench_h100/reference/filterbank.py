"""A plain SIGPROC filterbank reader and low-bit decode.

Written from the SIGPROC format itself: a header of length-prefixed
keyword strings between ``HEADER_START`` and ``HEADER_END``, then
time-major frames.  Samples of 1, 2 or 4 bits are packed least
significant bits first: the frame's first channel sits in the lowest bits
of its first byte.  Channel ``i`` is centred on ``fch1 + i * foff``.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

INT_KEYS = ("machine_id", "telescope_id", "data_type", "barycentric",
            "pulsarcentric", "nbits", "nsamples", "nchans", "nifs", "nbeams",
            "ibeam")
DOUBLE_KEYS = ("az_start", "za_start", "src_raj", "src_dej", "tstart",
               "tsamp", "fch1", "foff", "refdm", "period")
STRING_KEYS = ("source_name", "rawdatafile")


def read_header(path):
    """``(header, data_offset)`` of a SIGPROC file."""
    header = {}
    with open(path, "rb") as f:
        def word():
            (n,) = struct.unpack("<i", f.read(4))
            return f.read(n).decode("ascii")

        if word() != "HEADER_START":
            raise ValueError(f"{path}: not a SIGPROC file")
        while True:
            key = word()
            if key == "HEADER_END":
                break
            if key in INT_KEYS:
                (header[key],) = struct.unpack("<i", f.read(4))
            elif key in DOUBLE_KEYS:
                (header[key],) = struct.unpack("<d", f.read(8))
            elif key in STRING_KEYS:
                header[key] = word()
            else:
                raise ValueError(f"{path}: unknown key {key!r}")
        offset = f.tell()
    nchans, nbits = header["nchans"], header["nbits"]
    frame_bytes = nchans * header.get("nifs", 1) * nbits // 8
    header["nsamples_in_file"] = (os.path.getsize(path) - offset) // frame_bytes
    header["frame_bytes"] = frame_bytes
    return header, offset


def band(header):
    """``(fbottom, bandwidth, descending)`` in MHz: the lower edge of the
    lowest channel, the total width, and whether the file stores the band
    from the top down."""
    nchans, fch1, foff = header["nchans"], header["fch1"], header["foff"]
    centres = fch1 + np.arange(nchans) * foff
    return (float(centres.min() - abs(foff) / 2), abs(foff) * nchans,
            foff < 0)


def read_frames(path, istart, nsamps):
    """The raw packed frames ``(n, frame_bytes)`` uint8 of samples
    ``istart .. istart + nsamps`` (fewer at the end of the file)."""
    header, offset = read_header(path)
    n = max(0, min(int(nsamps), header["nsamples_in_file"] - int(istart)))
    fb = header["frame_bytes"]
    with open(path, "rb") as f:
        f.seek(offset + int(istart) * fb)
        raw = f.read(n * fb)
    return np.frombuffer(bytearray(raw), dtype=np.uint8).reshape(n, fb)


def decode(frames, nbits, nchans, device):
    """The codes of packed ``frames`` as a float32 ``(nchans, n)`` tensor
    on ``device``, in file channel order."""
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    per = 8 // nbits
    parts = [(x >> (k * nbits)) & ((1 << nbits) - 1) for k in range(per)]
    codes = torch.stack(parts, dim=-1).reshape(x.shape[0], -1)[:, :nchans]
    return codes.to(torch.float32).T.contiguous()


def read_badchans(path):
    """The bad-channel list beside a file (file channel order), as bool."""
    with open(path) as f:
        return np.array([int(v) for v in f.read().split()], dtype=bool)
