"""1/2/4-bit sample packing and unpacking for SIGPROC filterbanks.

SIGPROC packs low-bit samples LSB-first within each byte: the channel with
the lowest index of a frame sits in the least-significant bits.  Two
decodes of the same bytes, equal value for value:

* numpy shift and mask on the host (:func:`unpack_numpy`,
  :func:`unpack`; :func:`pack_numpy`, :func:`pack`: ``np.rint``, then
  clip to ``0 .. 2^nbits - 1``), the JAX package's host decode and
  encode: the sampled statistics of the reader thread
  (:func:`sample_codes`);
* torch shift and mask on the frames' device (:func:`unpack_codes`,
  :func:`device_unpack_block`; :func:`pack_codes` the other way): the
  chunk loop uploads the packed bytes, ``nbits / 32`` of the float32
  block's, and unpacks them on the card; the reader's host blocks,
  :meth:`PackedFrames.to_host`, the writer and ``PUclean`` decode and
  encode with the same functions
  (:meth:`~.sigproc.FilterbankReader.frame_values`,
  :meth:`~.sigproc.FilterbankWriter.encode_frames`).

:class:`PackedFrames` carries a packed chunk to
:func:`~..ops.search.dedispersion_search`.
"""

from __future__ import annotations

import numpy as np
import torch

#: values per byte for each supported width
_PER_BYTE = {1: 8, 2: 4, 4: 2}


def _check(nbits):
    if nbits not in _PER_BYTE:
        raise ValueError(f"unsupported nbits={nbits}")


def unpack_numpy(packed, nbits):
    """Packed uint8 -> float32 codes, LSB-first."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8).ravel()
    per = _PER_BYTE[nbits]
    mask = (1 << nbits) - 1
    shifts = np.arange(per, dtype=np.uint8) * nbits
    out = (packed[:, None] >> shifts[None, :]) & mask
    return out.astype(np.float32).ravel()


def pack_numpy(values, nbits):
    """Float values -> packed uint8: ``np.rint``, clipped to the codes,
    LSB-first."""
    per = _PER_BYTE[nbits]
    maxval = (1 << nbits) - 1
    v = np.asarray(values, dtype=np.float32).ravel()
    if v.size % per:
        raise ValueError(f"value count {v.size} not a multiple of {per}")
    q = np.clip(np.rint(v), 0, maxval).astype(np.uint8).reshape(-1, per)
    shifts = np.arange(per, dtype=np.uint8) * nbits
    return np.bitwise_or.reduce(q << shifts[None, :], axis=1).astype(np.uint8)


def unpack(packed, nbits):
    """Packed uint8 buffer -> float32 codes (numpy)."""
    _check(nbits)
    return unpack_numpy(packed, nbits)


def pack(values, nbits):
    """Float values -> packed uint8 (numpy)."""
    _check(nbits)
    return pack_numpy(values, nbits)


def accum_dtype(nbits, nchan):
    """Name of the smallest integer dtype that holds a full-channel sum of
    ``nbits``-bit codes exactly (``int16`` below 2^15, ``int32`` below
    2^24, where its float32 view is exact too), else None:
    :func:`..precision.exactness_domain`'s rule."""
    from ..precision import exactness_domain

    return exactness_domain(nchan, nbits=nbits).accum_dtype


def unpack_codes(frames, nbits):
    """Packed frames ``(n, nbytes)`` uint8 (a tensor on any device) ->
    their ``(n, nbytes * 8 / nbits)`` uint8 codes, LSB-first, on the
    frames' device.  Shift and mask stay in uint8: a shift of uint8 by a
    uint8 tensor and a mask by a Python int do not promote."""
    _check(nbits)
    shifts = torch.arange(_PER_BYTE[nbits], dtype=torch.uint8,
                          device=frames.device) * nbits
    vals = (frames[:, :, None] >> shifts) & ((1 << nbits) - 1)
    return vals.reshape(frames.shape[0], -1)


def pack_codes(codes, nbits):
    """``(n, m)`` uint8 codes below ``2^nbits`` (a tensor on any device,
    ``m`` a multiple of ``8 / nbits``) -> ``(n, m * nbits / 8)`` packed
    uint8, LSB-first: :func:`unpack_codes` inverted."""
    _check(nbits)
    per = _PER_BYTE[nbits]
    shifts = torch.arange(per, dtype=torch.uint8,
                          device=codes.device) * nbits
    parts = codes.reshape(codes.shape[0], -1, per) << shifts
    out = parts[..., 0]
    for j in range(1, per):
        out = out | parts[..., j]
    return out


def device_unpack_block(frames, nbits, nchan, band_descending=False,
                        dtype=torch.float32):
    """Packed frames ``(n, bytes_per_frame)`` uint8 (a tensor on any
    device, one IF) -> the ``(nchan, n)`` contiguous block in ``dtype``
    on the frames' device, ascending band (``band_descending`` flips the
    file's channel order, as ``read_block(band_ascending=True)`` does).
    The frame's padding values past ``nchan`` are cut before the
    transpose, which runs on the one-byte codes before their
    conversion."""
    codes = unpack_codes(frames, nbits)[:, :nchan].T
    if band_descending:
        codes = codes.flip(0)
    return codes.contiguous().to(dtype)


def sample_codes(frames, nbits, nchan, max_rows=4096):
    """Bounded strided decode of packed frames -> ``(nchan, k)`` float32
    codes in FILE channel order: at most ``max_rows`` frames, whatever the
    chunk's size (the reader thread's statistics: the packed canary's
    noise scale, the code-domain gate)."""
    frames = np.asarray(frames)
    stride = max(1, frames.shape[0] // int(max_rows))
    per_frame = frames.shape[1] * _PER_BYTE[nbits]
    return unpack_numpy(frames[::stride], nbits).reshape(
        -1, per_frame)[:, :int(nchan)].T


class PackedFrames:
    """A packed low-bit chunk: the raw ``(nsamps, bytes_per_frame)`` uint8
    frames of one IF (as :meth:`~.sigproc.FilterbankReader.
    read_block_packed` returns them) and what decodes them.  ``shape`` is
    the LOGICAL ``(nchan, nsamps)`` block shape."""

    __slots__ = ("frames", "nbits", "nchan", "band_descending")

    def __init__(self, frames, nbits, nchan, band_descending=False):
        _check(nbits)
        self.frames = np.asarray(frames)
        if self.frames.ndim != 2 or self.frames.dtype != np.uint8:
            raise ValueError(
                "PackedFrames wants the raw (nsamps, bytes_per_frame) "
                f"uint8 frames; got {self.frames.dtype} "
                f"{self.frames.shape}")
        self.nbits = int(nbits)
        self.nchan = int(nchan)
        self.band_descending = bool(band_descending)

    @classmethod
    def read(cls, reader, istart, nsamps):
        """One packed chunk of a single-IF low-bit reader."""
        return cls(reader.read_block_packed(istart, nsamps), reader.nbits,
                   reader.nchans, band_descending=reader.band_descending)

    @property
    def shape(self):
        """Logical decoded shape ``(nchan, nsamps)``."""
        return (self.nchan, int(self.frames.shape[0]))

    @property
    def nsamps(self):
        return int(self.frames.shape[0])

    @property
    def nbytes(self):
        """The packed bytes (what crosses to the device)."""
        return int(self.frames.nbytes)

    @property
    def float_nbytes(self):
        """The bytes of the float32 block."""
        return self.nchan * self.nsamps * 4

    def meta(self, dtype_name="float32"):
        """Hashable unpack descriptor ``(nbits, nchan, descending,
        dtype)``."""
        return (self.nbits, self.nchan, self.band_descending,
                str(dtype_name))

    def to_device(self, device, dtype=torch.float32):
        """Upload the PACKED bytes to ``device`` and unpack them there:
        the ascending ``(nchan, nsamps)`` block in ``dtype``."""
        frames = torch.from_numpy(np.require(self.frames,
                                             requirements=["C", "W"]))
        return device_unpack_block(frames.to(device), self.nbits,
                                   self.nchan, self.band_descending, dtype)

    def to_host(self):
        """The host decode: the float32 ``(nchan, nsamps)`` ascending
        block (:func:`device_unpack_block` on the host: the transpose
        runs on the one-byte codes, on the host's threads)."""
        frames = torch.from_numpy(np.require(self.frames,
                                             requirements=["C", "W"]))
        return device_unpack_block(frames, self.nbits, self.nchan,
                                   self.band_descending).numpy()
