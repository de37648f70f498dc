"""SIGPROC filterbank I/O.

A binary header of length-prefixed keyword/value records between
``HEADER_START`` and ``HEADER_END``, then time-major frames of
``nifs * nchans`` samples of 8, 16 or 32 bits, little-endian.  Packed
1, 2 and 4-bit files are not read or written by this package yet
(ROADMAP.md, the low-bit path).

The search's read comes in two parts: :meth:`FilterbankReader.
read_frames_into` copies the raw frames, as they are stored (one byte per
sample for 8-bit data), into a caller's host buffer (the chunk loop's
page-locked staging buffer, :mod:`..utils.staging`), and
:meth:`FilterbankReader.block_from_frames` turns the frames, once on the
device, into the float32 ``(nchan, n)`` ascending block there.
:meth:`FilterbankReader.read_block_tensor` is the two in one call.  The
chunk loop's reads fire the ``read`` fault seam (:mod:`..faults.inject`),
as the JAX package's ``read_block`` does.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from ..faults import inject as fault_inject

_INT_KEYS = {
    "machine_id", "telescope_id", "data_type", "barycentric",
    "pulsarcentric", "nbits", "nsamples", "nchans", "nifs", "nbeams",
    "ibeam",
}
_DOUBLE_KEYS = {
    "az_start", "za_start", "src_raj", "src_dej", "tstart", "tsamp",
    "fch1", "foff", "refdm", "period",
}
_STR_KEYS = {"source_name", "rawdatafile"}
#: single-byte keys (sigproc's ``signed`` flag for 8-bit data)
_CHAR_KEYS = {"signed"}

_DTYPES = {8: np.uint8, 16: np.uint16, 32: np.float32}


def _check_nbits(nbits):
    if nbits in (1, 2, 4):
        raise NotImplementedError(
            f"nbits={nbits}: packed low-bit filterbanks are not ported yet "
            "(ROADMAP.md, the low-bit path)")
    if nbits not in _DTYPES:
        raise ValueError(f"unsupported nbits={nbits}")


def _pack_string(s):
    b = s.encode("ascii")
    return struct.pack("<i", len(b)) + b


def _pack_record(key, value):
    rec = _pack_string(key)
    if key in _INT_KEYS:
        rec += struct.pack("<i", int(value))
    elif key in _DOUBLE_KEYS:
        rec += struct.pack("<d", float(value))
    elif key in _STR_KEYS:
        rec += _pack_string(str(value))
    elif key in _CHAR_KEYS:
        rec += struct.pack("<b", int(value))
    else:
        raise KeyError(f"unknown SIGPROC header key {key!r}")
    return rec


def _read_exact(f, n, path, what):
    offset = f.tell()
    data = f.read(n)
    if len(data) != n:
        raise ValueError(
            f"{path}: truncated SIGPROC header — expected {n} bytes for "
            f"{what} at byte offset {offset}, got {len(data)}")
    return data


def read_header(path):
    """Parse a SIGPROC header.  Returns ``(header_dict, data_offset)``."""
    header = {}
    with open(path, "rb") as f:
        def read_string():
            (n,) = struct.unpack(
                "<i", _read_exact(f, 4, path, "a string length"))
            if not 0 < n < 128:
                raise ValueError(f"corrupt SIGPROC header string length {n}")
            return _read_exact(f, n, path, "a header string").decode("ascii")

        if read_string() != "HEADER_START":
            raise ValueError(f"{path}: not a SIGPROC filterbank file")
        while True:
            key = read_string()
            if key == "HEADER_END":
                break
            if key in _INT_KEYS:
                (header[key],) = struct.unpack(
                    "<i", _read_exact(f, 4, path, f"int key {key!r}"))
            elif key in _DOUBLE_KEYS:
                (header[key],) = struct.unpack(
                    "<d", _read_exact(f, 8, path, f"double key {key!r}"))
            elif key in _STR_KEYS:
                header[key] = read_string()
            elif key in _CHAR_KEYS:
                (header[key],) = struct.unpack(
                    "<b", _read_exact(f, 1, path, f"char key {key!r}"))
            else:
                raise ValueError(f"{path}: unknown header key {key!r}")
        return header, f.tell()


def derived_header(header, data_size_bytes):
    """Add the fields the pipeline consumes: band edges (``fbottom``,
    ``ftop``, ``bandwidth``; channel ``i`` is centred on ``fch1 + i *
    foff``) and ``nsamples`` (capped at what the data section holds)."""
    h = dict(header)
    nchans = h["nchans"]
    nifs = h.get("nifs", 1)
    nbits = h.get("nbits", 32)
    fch1, foff = h["fch1"], h["foff"]
    centres = fch1 + np.arange(nchans) * foff
    h["bandwidth"] = abs(foff) * nchans
    h["fbottom"] = float(centres.min() - abs(foff) / 2)
    h["ftop"] = float(centres.max() + abs(foff) / 2)
    bytes_per_sample = nchans * nifs * nbits // 8
    available = int(data_size_bytes // bytes_per_sample)
    if "nsamples" not in h or h["nsamples"] <= 0:
        h["nsamples"] = available
    else:
        h["nsamples"] = min(int(h["nsamples"]), available)
    h.setdefault("tstart", 0.0)
    return h


class FilterbankReader:
    """Memory-mapped SIGPROC filterbank reader.

    A multi-IF file (``nifs > 1``, frames laid out ``[t][if][chan]``)
    reads as its total intensity, the IF planes summed.
    """

    def __init__(self, path):
        self.path = path
        raw_header, offset = read_header(path)
        data_size = os.path.getsize(path) - offset
        self.header = derived_header(raw_header, data_size)
        nbits = self.header.get("nbits", 32)
        _check_nbits(nbits)
        self.nifs = self.header.get("nifs", 1)
        dtype = _DTYPES[nbits]
        if nbits == 8 and self.header.get("signed"):
            dtype = np.int8
        self._mmap = np.memmap(path, dtype=dtype, mode="r", offset=offset,
                               shape=(self.header["nsamples"],
                                      self.nifs * self.nchans))

    @property
    def nsamples(self):
        return self.header["nsamples"]

    @property
    def nchans(self):
        return self.header["nchans"]

    @property
    def band_descending(self):
        return self.header["foff"] < 0

    @property
    def nbeams(self):
        n = self.header.get("nbeams")
        return int(n) if n is not None else None

    @property
    def ibeam(self):
        b = self.header.get("ibeam")
        return int(b) if b is not None else None

    @property
    def frame_dtype(self):
        """The host dtype of :meth:`read_frames_into`'s buffer: the file's,
        with uint16 viewed as int16 (few tensor operations take uint16;
        :meth:`block_from_frames` widens it back)."""
        dtype = self._mmap.dtype
        return np.dtype(np.int16) if dtype == np.uint16 else dtype

    def read_frames(self, istart, nsamps):
        """A copy of the raw frames ``(n, nifs * nchans)`` in file dtype
        (no fault seam)."""
        istart = int(istart)
        nsamps = int(min(nsamps, self.nsamples - istart))
        return np.array(self._mmap[istart:istart + nsamps])

    def read_frames_into(self, istart, nsamps, out):
        """Copy the raw frames of ``nsamps`` samples from ``istart`` into
        the leading rows of ``out`` (a host array of
        :attr:`frame_dtype`, ``(>= n, nifs * nchans)``); returns the
        number of samples copied.  Fires the ``read`` seam (an error, or a
        truncated length) as :meth:`read_block` does.  A plain copy: no
        device call, so it runs on a reader thread."""
        istart = int(istart)
        fault_inject.fire("read", chunk=istart)
        nsamps = int(min(nsamps, self.nsamples - istart))
        nsamps = fault_inject.truncated_length("read", istart, nsamps)
        src = self._mmap[istart:istart + nsamps]
        np.copyto(out[:nsamps], src.view(out.dtype))
        return nsamps

    def block_from_frames(self, frames):
        """The float32 ``(nchans, n)`` contiguous ascending block of raw
        ``frames`` ``(n, nifs * nchans)`` (a tensor in :attr:`frame_dtype`,
        on any device), computed where the frames are."""
        if frames.dtype == torch.int16 and self._mmap.dtype == np.uint16:
            frames = frames.to(torch.int32) & 0xFFFF
        block = self._frames_to_block(frames.to(torch.float32))
        if self.band_descending:
            block = block.flip(0)
        return block.contiguous()

    def _frames_to_block(self, frames):
        frames = frames.reshape(frames.shape[0], self.nifs, self.nchans)
        return (frames[:, 0] if self.nifs == 1 else frames.sum(1)).T

    def host_samples(self, frames):
        """The ``(n, nchans)`` host samples of raw ``frames`` ``(n, nifs *
        nchans)`` (a numpy array in :attr:`frame_dtype`), channels in
        ascending order: the transpose of :meth:`read_block`'s
        ``band_ascending`` block.  One IF: a view in the file's dtype;
        several: their float64 sum."""
        frames = np.asarray(frames).view(self._mmap.dtype)
        if self.nifs == 1:
            samples = frames
        else:
            samples = frames.reshape(frames.shape[0], self.nifs,
                                     self.nchans).astype(float).sum(1)
        return samples[:, ::-1] if self.band_descending else samples

    def read_block(self, istart, nsamps, band_ascending=False):
        """Float64 ``(nchans, n)`` host block, file channel order unless
        ``band_ascending``.  Fires the ``read`` seam, as the JAX
        package's ``read_block`` does."""
        istart = int(istart)
        fault_inject.fire("read", chunk=istart)
        nsamps = int(min(nsamps, self.nsamples - istart))
        nsamps = fault_inject.truncated_length("read", istart, nsamps)
        block = self._frames_to_block(
            self.read_frames(istart, nsamps).astype(float))
        if band_ascending and self.band_descending:
            block = block[::-1]
        return block

    def read_block_tensor(self, istart, nsamps, device):
        """Float32 ``(nchans, n)`` contiguous block on ``device``, in
        ascending frequency order.

        The frames cross to the device in their stored dtype and are
        converted, transposed and (for a descending band) flipped there
        (:meth:`block_from_frames`).  No fault seam.
        """
        raw = self.read_frames(istart, nsamps)
        frames = torch.from_numpy(raw.view(self.frame_dtype)).to(device)
        return self.block_from_frames(frames)

    def iter_blocks(self, chunksize, band_ascending=False):
        """Yield ``(istart, block)`` float64 host blocks over the file."""
        for istart in range(0, self.nsamples, chunksize):
            yield istart, self.read_block(istart, chunksize,
                                          band_ascending=band_ascending)


class FilterbankWriter:
    """Streaming single-IF SIGPROC filterbank writer (time-major frames).
    Integer formats round and clip."""

    def __init__(self, path, header):
        self.path = path
        self.header = dict(header)
        self.nchans = int(self.header["nchans"])
        if int(self.header.get("nifs", 1)) != 1:
            raise ValueError("the writer writes single-IF files only")
        self.nbits = int(self.header.get("nbits", 32))
        _check_nbits(self.nbits)
        self._dtype = _DTYPES[self.nbits]
        if self.nbits == 8 and self.header.get("signed"):
            self._dtype = np.int8
        self._file = open(path, "wb")
        self._file.write(_pack_string("HEADER_START"))
        for key in sorted(set(self.header) & (_INT_KEYS | _DOUBLE_KEYS |
                                              _STR_KEYS | _CHAR_KEYS)):
            if key == "nsamples":
                continue  # computed from data size on read
            self._file.write(_pack_record(key, self.header[key]))
        self._file.write(_pack_string("HEADER_END"))

    def write_block(self, block):
        """Write a ``(nchans, n)`` block."""
        block = np.asarray(block)
        if block.ndim != 2 or block.shape[0] != self.nchans:
            raise ValueError(f"block of shape {block.shape}, expected "
                             f"({self.nchans}, n)")
        frames = np.ascontiguousarray(block.T)
        if self.nbits < 32:
            info = np.iinfo(self._dtype)
            frames = np.clip(np.rint(frames), info.min, info.max)
        self._file.write(frames.astype(self._dtype).tobytes())

    def close(self):
        if not self._file.closed:
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_filterbank(path, data, tsamp, fch1, foff, nbits=32, tstart=0.0,
                     source_name="pulsarutils_tpu_torch", **extra):
    """Write a whole ``(nchans, nsamples)`` array as a filterbank file."""
    data = np.asarray(data)
    header = {
        "nchans": data.shape[0],
        "nbits": nbits,
        "nifs": 1,
        "tsamp": tsamp,
        "fch1": fch1,
        "foff": foff,
        "tstart": tstart,
        "source_name": source_name,
        "machine_id": 0,
        "telescope_id": 0,
        "data_type": 1,
    }
    header.update(extra)
    with FilterbankWriter(path, header) as w:
        w.write_block(data)
    return header


def header_from_simulated(sim_header, descending=False):
    """Map a simulator header (ascending band, band-edge keys) onto writer
    kwargs (``fch1``/``foff`` channel-centre convention)."""
    nchan = sim_header["nchans"]
    df = sim_header["bandwidth"] / nchan
    if descending:
        fch1 = sim_header["fbottom"] + sim_header["bandwidth"] - df / 2
        foff = -df
    else:
        fch1 = sim_header["fbottom"] + df / 2
        foff = df
    return {"tsamp": sim_header["tsamp"], "fch1": fch1, "foff": foff}


def write_simulated_filterbank(path, array, sim_header, descending=False,
                               **extra):
    """Write a simulator-convention array (row 0 = lowest frequency) as a
    filterbank file, flipping the rows for a descending-band header."""
    data = np.asarray(array)[::-1] if descending else array
    kw = header_from_simulated(sim_header, descending=descending)
    kw.update(extra)
    return write_filterbank(path, data, **kw)
