"""The live feed's wire format, version 1 (the JAX package's, byte for
byte).

One packet carries a contiguous run of time samples for a contiguous
channel range, as float32 frames or :mod:`.lowbit` packed codes: a
1/2/4-bit payload becomes a :class:`~.lowbit.PackedFrames` chunk that is
unpacked on the card, so the wire carries bytes, not floats.

Layout (little-endian, 40-byte header + payload)::

    magic     4s   b"PUTP"
    version   B    PACKET_VERSION (1)
    nbits     B    0 = float32 frames; 1/2/4 = lowbit packed codes
    flags     B    bit 0: band_descending payload channel order
    _pad      B    zero
    nchan     H    channels in this packet's range
    chan0     H    first channel of the range (0 = full band)
    nsamps    I    time samples (frames) in the payload
    seq       Q    monotone packet counter (gap/reorder detection)
    sample0   Q    absolute sample index of the first frame
    payload_len I  payload bytes that follow the header
    crc32     I    zlib.crc32 of the payload (corruption detection)

The payload is **frame-major**: ``nsamps`` frames, each ``nchan`` float32
values or ``ceil(nchan * nbits / 8)`` packed bytes (one
:class:`~.lowbit.PackedFrames` row), so reassembly is a row copy.

Framing is self-delimiting (the header carries ``payload_len``): the same
byte stream works over TCP, one UDP datagram a packet, or a flat file
piped through ``nc``.  Decode errors raise :class:`PacketError`; a CRC
mismatch raises its subclass :class:`PacketCorruptError`, so the
assembler counts the packet as lost (a gap), never as data.  Host code
only (numpy, ``zlib``).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

__all__ = ["PACKET_MAGIC", "PACKET_VERSION", "HEADER_SIZE", "Packet",
           "PacketError", "PacketCorruptError", "encode_packet",
           "decode_packet", "read_packet_stream", "packetize_array"]

PACKET_MAGIC = b"PUTP"
PACKET_VERSION = 1

_HEADER = struct.Struct("<4sBBBBHHIQQII")
HEADER_SIZE = _HEADER.size

_FLAG_BAND_DESCENDING = 0x01

#: packed payload bytes per frame, keyed by nbits (0 = float32)
_PER_BYTE = {1: 8, 2: 4, 4: 2}


class PacketError(ValueError):
    """Malformed packet: bad magic, unsupported version, short buffer,
    or inconsistent header/payload lengths."""


class PacketCorruptError(PacketError):
    """Structurally valid packet whose payload fails its CRC — the
    assembler treats the samples as lost (a gap), never as data."""


def frame_nbytes(nchan, nbits):
    """Payload bytes per time sample for this channel count/depth."""
    nchan = int(nchan)
    if nbits == 0:
        return 4 * nchan
    if nbits not in _PER_BYTE:
        raise PacketError(f"unsupported nbits {nbits!r} (0, 1, 2 or 4)")
    per = _PER_BYTE[nbits]
    return (nchan + per - 1) // per


@dataclass(frozen=True)
class Packet:
    """One decoded packet: header fields + the frame-major payload.

    ``payload`` is the raw bytes; :meth:`frames` views them as the
    ``(nsamps, frame_nbytes)`` uint8 array (packed) or
    ``(nsamps, nchan)`` float32 array (nbits == 0).
    """

    seq: int
    sample0: int
    nsamps: int
    nchan: int
    chan0: int
    nbits: int
    band_descending: bool
    payload: bytes

    def frames(self):
        """Frame-major payload view (no copy)."""
        if self.nbits == 0:
            return np.frombuffer(self.payload, dtype=np.float32).reshape(
                self.nsamps, self.nchan)
        return np.frombuffer(self.payload, dtype=np.uint8).reshape(
            self.nsamps, frame_nbytes(self.nchan, self.nbits))


def encode_packet(*, seq, sample0, nchan, nbits, payload, chan0=0,
                  band_descending=False):
    """Serialize one packet; ``payload`` must be the frame-major bytes
    of a whole number of frames."""
    payload = bytes(payload)
    fb = frame_nbytes(nchan, nbits)
    if fb == 0 or len(payload) % fb:
        raise PacketError(
            f"payload of {len(payload)} bytes is not a whole number of "
            f"{fb}-byte frames (nchan={nchan}, nbits={nbits})")
    nsamps = len(payload) // fb
    flags = _FLAG_BAND_DESCENDING if band_descending else 0
    header = _HEADER.pack(PACKET_MAGIC, PACKET_VERSION, int(nbits),
                          flags, 0, int(nchan), int(chan0), nsamps,
                          int(seq), int(sample0), len(payload),
                          zlib.crc32(payload) & 0xFFFFFFFF)
    return header + payload


def decode_packet(buf):
    """Decode one packet from ``buf`` (header + payload, exact or
    longer); returns ``(Packet, bytes_consumed)``."""
    buf = bytes(buf)
    if len(buf) < HEADER_SIZE:
        raise PacketError(f"short header: {len(buf)} < {HEADER_SIZE}")
    (magic, version, nbits, flags, _pad, nchan, chan0, nsamps, seq,
     sample0, payload_len, crc) = _HEADER.unpack_from(buf)
    if magic != PACKET_MAGIC:
        raise PacketError(f"bad magic {magic!r}")
    if version != PACKET_VERSION:
        raise PacketError(f"unsupported packet version {version}")
    if nbits not in (0, 1, 2, 4):
        raise PacketError(f"unsupported nbits {nbits}")
    if payload_len != nsamps * frame_nbytes(nchan, nbits):
        raise PacketError(
            f"payload_len {payload_len} inconsistent with "
            f"{nsamps} frames of {frame_nbytes(nchan, nbits)} bytes")
    end = HEADER_SIZE + payload_len
    if len(buf) < end:
        raise PacketError(f"short payload: {len(buf)} < {end}")
    payload = buf[HEADER_SIZE:end]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise PacketCorruptError(
            f"payload CRC mismatch on seq {seq} (sample0 {sample0})")
    return Packet(seq=seq, sample0=sample0, nsamps=nsamps, nchan=nchan,
                  chan0=chan0, nbits=nbits,
                  band_descending=bool(flags & _FLAG_BAND_DESCENDING),
                  payload=payload), end


def read_packet_stream(read, on_corrupt=None):
    """Generator over packets from a byte-stream ``read(n)`` callable
    (socket ``recv`` adapter or file ``read``).  ``read`` must return
    b"" at EOF and at most ``n`` bytes otherwise.  Raises
    :class:`PacketError` on a torn header/payload (mid-packet EOF).

    The stream is length-framed, so one corrupt payload does not lose
    framing: with ``on_corrupt`` given a CRC-rejected packet is
    reported to it and skipped (its samples surface as a gap);
    without, :class:`PacketCorruptError` propagates.
    """
    def read_exact(n, *, partial_ok=False):
        parts = []
        got = 0
        while got < n:
            piece = read(n - got)
            if not piece:
                if got == 0 and partial_ok:
                    return b""
                raise PacketError(
                    f"stream ended mid-packet ({got}/{n} bytes)")
            parts.append(piece)
            got += len(piece)
        return b"".join(parts)

    while True:
        header = read_exact(HEADER_SIZE, partial_ok=True)
        if not header:
            return
        payload_len = _HEADER.unpack_from(header)[10]
        try:
            pkt, _ = decode_packet(header + read_exact(payload_len))
        except PacketCorruptError as exc:
            if on_corrupt is None:
                raise
            on_corrupt(exc)
            continue
        yield pkt


def packetize_array(data, *, samples_per_packet=256, nbits=0, nchan=None,
                    sample0=0, seq0=0, band_descending=False):
    """Cut a block into encoded packets (the local feeder and the tests;
    a real backend does this on the correlator).

    ``data`` is either a ``(nchan, nsamps)`` float array (``nbits`` 0)
    or the raw ``(nsamps, bytes_per_frame)`` uint8 packed-frame array
    of a :class:`~.lowbit.PackedFrames` (``nbits`` 1/2/4; pass the
    logical ``nchan`` explicitly when the last byte is padding).
    Returns a list of encoded packet byte strings with consecutive
    ``seq`` and ``sample0`` fields.
    """
    if nbits == 0:
        arr = np.ascontiguousarray(np.asarray(data, dtype=np.float32).T)
        nchan = arr.shape[1]
    else:
        arr = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
        if nchan is None:
            nchan = _PER_BYTE[nbits] * arr.shape[1]
        elif frame_nbytes(nchan, nbits) != arr.shape[1]:
            raise PacketError(
                f"nchan {nchan} needs {frame_nbytes(nchan, nbits)} "
                f"bytes/frame, got rows of {arr.shape[1]}")
    out = []
    step = int(samples_per_packet)
    for i, off in enumerate(range(0, arr.shape[0], step)):
        rows = arr[off:off + step]
        out.append(encode_packet(
            seq=seq0 + i, sample0=sample0 + off, nchan=nchan,
            nbits=nbits, payload=rows.tobytes(),
            band_descending=band_descending))
    return out
