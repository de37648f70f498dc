"""SIGPROC filterbank I/O.

A binary header of length-prefixed keyword/value records between
``HEADER_START`` and ``HEADER_END``, then time-major frames of
``nifs * nchans`` samples of 1, 2, 4, 8, 16 or 32 bits, little-endian;
1, 2 and 4-bit samples are packed LSB-first into whole bytes
(:mod:`.lowbit`).  A multi-IF file stores its IF planes interleaved per
frame, ``[t][if][chan]``.

The search's read comes in two parts: :meth:`FilterbankReader.
read_frames_into` copies the raw frames, as they are stored (one byte per
sample for 8-bit data, the packed bytes of a low-bit file), into a
caller's host buffer (the chunk loop's page-locked staging buffer,
:mod:`..utils.staging`), and :meth:`FilterbankReader.block_from_frames`
turns the frames, once on the device, into the float32 ``(nchan, n)``
ascending block there (a low-bit file's unpack included).
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


#: packed widths (:mod:`.lowbit`)
_LOWBIT = (1, 2, 4)


def _check_width(nbits, nchans, nifs):
    """Raise unless ``nbits`` is a SIGPROC width and a frame of ``nifs *
    nchans`` values at that width fills whole bytes."""
    if nbits in _LOWBIT:
        if (nifs * nchans * nbits) % 8:
            raise ValueError(
                f"nchans={nchans} x nifs={nifs} at nbits={nbits} does not "
                "pack to whole bytes")
    elif nbits not in _DTYPES:
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

    ``if_mode`` decides what a multi-IF file (``nifs > 1``, frames laid
    out ``[t][if][chan]``) reads as: ``"sum"`` (the default), its total
    intensity, the IF planes summed; an integer ``k``, IF plane ``k``
    alone.

    A low-bit file (1, 2 or 4 bits) maps its raw bytes,
    :attr:`bytes_per_frame` a frame: :meth:`read_block` decodes them on
    the host, :meth:`read_block_packed` returns them as stored, and the
    frame API of the chunk loop (:attr:`frame_dtype`,
    :meth:`read_frames_into`, :meth:`block_from_frames`,
    :meth:`host_samples`) carries the packed bytes, unpacked where the
    frames are (:func:`.lowbit.device_unpack_block`).
    """

    def __init__(self, path, if_mode="sum"):
        self.path = path
        raw_header, offset = read_header(path)
        data_size = os.path.getsize(path) - offset
        self.header = derived_header(raw_header, data_size)
        self.nbits = nbits = self.header.get("nbits", 32)
        self.nifs = nifs = self.header.get("nifs", 1)
        if if_mode != "sum":
            k = int(if_mode)
            if not 0 <= k < nifs:
                raise ValueError(f"if_mode={if_mode!r}: file has {nifs} "
                                 "IF planes")
        self.if_mode = if_mode
        _check_width(nbits, self.nchans, nifs)
        width = nifs * self.nchans  # values per frame
        if nbits in _LOWBIT:
            dtype, width = np.uint8, width * nbits // 8
        else:
            dtype = _DTYPES[nbits]
            if nbits == 8 and self.header.get("signed"):
                dtype = np.int8
        self._mmap = np.memmap(path, dtype=dtype, mode="r", offset=offset,
                               shape=(self.header["nsamples"], width))

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
    def packed(self):
        """True for a packed 1, 2 or 4-bit file."""
        return self.nbits in _LOWBIT

    @property
    def frame_width(self):
        """Stored values a frame: ``nifs * nchans``, or the bytes a frame
        of a packed file."""
        return self._mmap.shape[1]

    @property
    def bytes_per_frame(self):
        return self._mmap.shape[1] * self._mmap.dtype.itemsize

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
        """The host dtype of :meth:`read_frames_into`'s buffer: the file's
        (uint8 for a packed file), with uint16 viewed as int16 (few tensor
        operations take uint16; :meth:`block_from_frames` widens it
        back)."""
        dtype = self._mmap.dtype
        return np.dtype(np.int16) if dtype == np.uint16 else dtype

    def read_frames(self, istart, nsamps):
        """A copy of the raw frames ``(n, frame_width)`` in file dtype (no
        fault seam)."""
        istart = int(istart)
        nsamps = int(min(nsamps, self.nsamples - istart))
        return np.array(self._mmap[istart:istart + nsamps])

    def _seamed_length(self, istart, nsamps):
        """Fire the ``read`` seam (an error, or a truncated length) for a
        read of ``nsamps`` samples from ``istart``; the length to read."""
        fault_inject.fire("read", chunk=istart)
        nsamps = int(min(nsamps, self.nsamples - istart))
        return fault_inject.truncated_length("read", istart, nsamps)

    def read_frames_into(self, istart, nsamps, out):
        """Copy the raw frames of ``nsamps`` samples from ``istart`` into
        the leading rows of ``out`` (a host array of
        :attr:`frame_dtype`, ``(>= n, frame_width)``); returns the number
        of samples copied.  Fires the ``read`` seam as :meth:`read_block`
        does.  A plain copy: no device call, so it runs on a reader
        thread."""
        istart = int(istart)
        nsamps = self._seamed_length(istart, nsamps)
        src = self._mmap[istart:istart + nsamps]
        np.copyto(out[:nsamps], src.view(out.dtype))
        return nsamps

    def read_block_packed(self, istart, nsamps):
        """The raw packed frames ``(n, bytes_per_frame)`` uint8 of a
        single-IF low-bit file, with the ``read`` seam (what
        :class:`.lowbit.PackedFrames` carries).  A multi-IF file is
        refused: the device unpack takes the first ``nchans`` values of a
        frame, which is IF 0 and not what ``if_mode`` asks for."""
        if not self.packed:
            raise ValueError("read_block_packed needs a packed low-bit file "
                             f"(nbits={self.nbits})")
        if self.nifs != 1:
            raise ValueError(
                f"read_block_packed is single-IF only (nifs={self.nifs}); "
                "use read_block, which honours if_mode")
        istart = int(istart)
        nsamps = self._seamed_length(istart, nsamps)
        return np.asarray(self._mmap[istart:istart + nsamps])

    def _select_if(self, frames):
        """``(n, nchans)`` of frames ``(n, nifs * nchans)`` (numpy or
        torch) after :attr:`if_mode`."""
        frames = frames.reshape(frames.shape[0], self.nifs, self.nchans)
        if self.nifs == 1:
            return frames[:, 0]
        if self.if_mode == "sum":
            return frames.sum(1)
        return frames[:, int(self.if_mode)]

    def frame_values(self, frames, dtype=torch.float64):
        """The stored values of raw ``frames`` ``(n, frame_width)`` (a
        tensor in :attr:`frame_dtype`, on any device) as ``(n, nifs *
        nchans)`` in ``dtype``, file channel order, every IF, computed
        where the frames are (a packed file's codes unpacked there)."""
        if self.packed:
            from .lowbit import unpack_codes

            frames = unpack_codes(frames, self.nbits)
        elif frames.dtype == torch.int16 and self._mmap.dtype == np.uint16:
            frames = frames.to(torch.int32) & 0xFFFF
        return frames.to(dtype)

    def block_from_frames(self, frames):
        """The float32 ``(nchans, n)`` contiguous ascending block of raw
        ``frames`` ``(n, frame_width)`` (a tensor in :attr:`frame_dtype`,
        on any device), computed where the frames are; one IF of a packed
        file is unpacked straight into it
        (:func:`.lowbit.device_unpack_block`)."""
        if self.packed and self.nifs == 1:
            from .lowbit import device_unpack_block

            return device_unpack_block(frames, self.nbits, self.nchans,
                                       self.band_descending)
        block = self._select_if(self.frame_values(frames,
                                                  torch.float32)).T
        if self.band_descending:
            block = block.flip(0)
        return block.contiguous()

    def host_samples(self, frames):
        """The ``(n, nchans)`` host samples of raw ``frames`` ``(n,
        frame_width)`` (a numpy array in :attr:`frame_dtype`), channels in
        ascending order: the transpose of :meth:`read_block`'s
        ``band_ascending`` block.  One IF: a view in the file's dtype (a
        packed file's rows decoded to float32 codes); several: their
        float64 sum, or the IF :attr:`if_mode` names."""
        frames = np.asarray(frames).view(self._mmap.dtype)
        if self.packed:
            frames = self._host_values(frames, torch.float32)
        if self.nifs == 1:
            samples = frames
        else:
            samples = self._select_if(frames.astype(float))
        return samples[:, ::-1] if self.band_descending else samples

    def _host_values(self, raw, dtype=torch.float64):
        """:meth:`frame_values` of host frames ``raw`` (file or frame
        dtype), as a numpy array."""
        raw = np.require(raw, requirements=["C", "W"])
        return self.frame_values(torch.from_numpy(raw.view(
            self.frame_dtype)), dtype).numpy()

    def unpack_frames(self, raw, band_ascending=False):
        """The float64 ``(nchans, n)`` host block of raw frames ``raw``
        ``(n, frame_width)`` (packed or not), file channel order unless
        ``band_ascending``: :meth:`frame_values` on the host."""
        block = self._select_if(self._host_values(raw)).T
        if band_ascending and self.band_descending:
            block = block[::-1]
        return block

    def read_block(self, istart, nsamps, band_ascending=False):
        """Float64 ``(nchans, n)`` host block, file channel order unless
        ``band_ascending``; a packed file is decoded on the host.  Fires
        the ``read`` seam, as the JAX package's ``read_block`` does."""
        istart = int(istart)
        nsamps = self._seamed_length(istart, nsamps)
        raw = np.asarray(self._mmap[istart:istart + nsamps])
        return self.unpack_frames(raw, band_ascending=band_ascending)

    def read_block_tensor(self, istart, nsamps, device):
        """Float32 ``(nchans, n)`` contiguous block on ``device``, in
        ascending frequency order.

        The frames cross to the device as stored (a packed file's packed
        bytes) and are converted, transposed and (for a descending band)
        flipped there (:meth:`block_from_frames`).  No fault seam.
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
    """Streaming SIGPROC filterbank writer (time-major frames).

    Integer formats round and clip: 8 and 16 bits to their dtype's range,
    1, 2 and 4 bits to their codes, then packed (:func:`.lowbit.pack`).
    With ``nifs > 1`` in the header, :meth:`write_block` takes ``(nifs,
    nchans, n)`` blocks and interleaves the IF planes per frame
    (``[t][if][chan]``, the layout the reader expects).
    """

    def __init__(self, path, header):
        self.path = path
        self.header = dict(header)
        self.nchans = int(self.header["nchans"])
        self.nifs = int(self.header.get("nifs", 1))
        self.nbits = int(self.header.get("nbits", 32))
        _check_width(self.nbits, self.nchans, self.nifs)
        if self.nbits in _LOWBIT:
            self._dtype = np.uint8
        else:
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
        """Write a ``(nchans, n)`` block, or ``(nifs, nchans, n)`` for a
        multi-IF file."""
        block = np.asarray(block)
        if self.nifs > 1:
            if block.ndim != 3 or block.shape[:2] != (self.nifs,
                                                      self.nchans):
                raise ValueError(
                    f"multi-IF block must be ({self.nifs}, {self.nchans}, "
                    f"n); got {block.shape}")
            frames = np.ascontiguousarray(block.transpose(2, 0, 1)).reshape(
                block.shape[2], self.nifs * self.nchans)
        else:
            if block.ndim != 2 or block.shape[0] != self.nchans:
                raise ValueError(f"block of shape {block.shape}, expected "
                                 f"({self.nchans}, n)")
            frames = np.ascontiguousarray(block.T)
        values = torch.from_numpy(frames)
        if not values.is_floating_point():
            values = values.to(torch.float64)
        self.write_frames(self.encode_frames(values))

    def encode_frames(self, values):
        """The stored frames of float ``values`` ``(n, nifs * nchans)``
        (a tensor on any device, time-major, file channel order), rounded
        and clipped there as the JAX package's writer does: 8 and 16 bits
        ``rint`` then clip to the dtype's range; 1, 2 and 4 bits a float32
        cast, ``rint``, clip to the codes and LSB-first packing; 32 bits
        a float32 cast.  (16-bit samples come back as int32: few tensor
        operations take uint16.)"""
        if self.nbits == 32:
            return values.to(torch.float32)
        if self.nbits in _LOWBIT:
            from .lowbit import pack_codes

            codes = values.to(torch.float32).round().clamp_(
                0, (1 << self.nbits) - 1).to(torch.uint8)
            return pack_codes(codes, self.nbits)
        info = np.iinfo(self._dtype)
        out = values.round().clamp_(info.min, info.max)
        return out.to(torch.int32 if self.nbits == 16
                      else torch.from_numpy(np.empty(0, self._dtype)).dtype)

    def write_frames(self, frames):
        """Write frames :meth:`encode_frames` made (a tensor or array on
        any device)."""
        host = np.ascontiguousarray(frames.cpu().numpy()
                                    if isinstance(frames, torch.Tensor)
                                    else frames)
        self._file.write(host.astype(self._dtype, copy=False).tobytes())

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
