"""1/2/4-bit sample packing and unpacking for SIGPROC filterbanks.

SIGPROC packs low-bit samples LSB-first within each byte: the channel with
the lowest index of a frame sits in the least-significant bits.  Three
decodes of the same bytes, equal value for value:

* the host decode and encode, :func:`unpack` and :func:`pack` (``rint``,
  round half to even, then clip to ``0 .. 2^nbits - 1``): the JAX
  package's C++ lookup-table loops (``native/unpack.cpp``, the same
  file), built with the host's C++ compiler at first use and loaded with
  ``ctypes``; where no compiler works, or with ``PUTPU_NO_NATIVE=1``,
  the numpy shift and mask (:func:`unpack_numpy`, :func:`pack_numpy`),
  logged once.  The reader's host blocks, a CPU ``PUclean``, the
  writer's host encode and :meth:`PackedFrames.to_host` go through them
  (:meth:`~.sigproc.FilterbankReader.frame_values` and
  :meth:`~.sigproc.FilterbankWriter.encode_frames` on a CPU tensor);
  :data:`native_calls` counts the native calls.  The sampled statistics
  of the reader thread (:func:`sample_codes`) stay numpy, as in JAX;
* torch shift and mask on the frames' device (:func:`unpack_codes`,
  :func:`device_unpack_block`; :func:`pack_codes` the other way): the
  chunk loop uploads the packed bytes, ``nbits / 32`` of the float32
  block's, and unpacks them on the card, and a card's ``PUclean``
  decodes and encodes there.

:class:`PackedFrames` carries a packed chunk to
:func:`~..ops.search.dedispersion_search`.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import sys
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

logger = logging.getLogger("pulsarutils_tpu_torch")

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PACKAGE_DIR, "native", "unpack.cpp")
_BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")

#: values per byte for each supported width
_PER_BYTE = {1: 8, 2: 4, 4: 2}

_lib = None
_lib_tried = False
_lib_lock = threading.Lock()
_count_lock = threading.Lock()

#: calls of the native decode and encode so far (``chip_smoke.py`` reads
#: it beside the kernels' launch counters)
native_calls = 0


def _build_library():
    """Compile ``native/unpack.cpp`` to a shared library; its path, or
    None when no compiler works.

    It builds into the package's ``_build/``, else (not writable) a
    per-user temp directory, under a name that carries the source's hash
    (an edit rebuilds).  The compile writes a temp name and renames it
    into place: the rename is atomic, so a concurrent process (parallel
    test workers) never loads a half-written library."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    tag = f"cpython{sys.version_info.major}{sys.version_info.minor}"
    uid = (os.getuid() if hasattr(os, "getuid")
           else os.environ.get("USERNAME", "user"))
    build_dirs = [_BUILD_DIR,
                  os.path.join(tempfile.gettempdir(),
                               f"pulsarutils_tpu_torch_native_{uid}")]
    for d in build_dirs:
        try:
            os.makedirs(d, exist_ok=True)
            out = os.path.join(d, f"_unpack.{tag}.{digest}.so")
            if os.path.exists(out):
                return out
            tmp = f"{out}.tmp{os.getpid()}"
            try:
                _compile(tmp)
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):  # a failed build leaves nothing
                    os.unlink(tmp)
            return out
        except (OSError, subprocess.SubprocessError) as exc:
            logger.debug("native unpack build failed in %s: %s", d, exc)
    logger.info("native low-bit unpacker unavailable (no working C++ "
                "compiler); using the numpy decode — equal bytes, slower "
                "on large low-bit files")
    return None


def _compile(out):
    """Build ``unpack.cpp`` with ``$CXX``, else the first of ``g++``,
    ``clang++``, ``c++`` that works (``-O3 -shared -fPIC``); raises the
    last failure when none does."""
    compilers = ([os.environ["CXX"]] if os.environ.get("CXX")
                 else ["g++", "clang++", "c++"])
    last = None
    for cxx in compilers:
        try:
            subprocess.run([cxx, "-O3", "-shared", "-fPIC", "-o", out,
                            _SRC], check=True, capture_output=True,
                           timeout=120)
            return
        except (OSError, subprocess.SubprocessError) as exc:
            last = exc
    raise last


def _load():
    """The loaded native library, built at the first call (None without
    one, or with ``PUTPU_NO_NATIVE=1``); tried once a process."""
    global _lib, _lib_tried
    with _lib_lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        if os.environ.get("PUTPU_NO_NATIVE") == "1":
            return None
        try:
            path = _build_library()
            if path is None:
                return None
            lib = ctypes.CDLL(path)
            for name in ("unpack1", "unpack2", "unpack4", "pack1", "pack2",
                         "pack4"):
                getattr(lib, name).argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
            _lib = lib
        except OSError as exc:
            logger.debug("native unpack unavailable: %s", exc)
            _lib = None
        return _lib


def native_available():
    """True when the C++ decode compiled and loaded."""
    return _load() is not None


def _count_native():
    global native_calls
    with _count_lock:
        native_calls += 1


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


def _native_run(fn, src, dst, n_bytes, src_step, dst_step):
    """``fn(src, dst, n_bytes)`` over ``n_bytes`` packed bytes.  The C++
    loops are single-threaded, so a call of 2 MiB or more runs in byte
    slices of at least 1 MiB on up to 8 threads (``ctypes`` releases
    the GIL during the call; each slice writes its own part of ``dst``,
    so the result is the single call's).  ``src_step``/``dst_step``: the
    bytes of ``src``/``dst`` a packed byte takes."""
    parts = min(8, os.cpu_count() or 1, n_bytes >> 20)
    if parts <= 1:
        fn(src, dst, n_bytes)
        return
    bounds = [n_bytes * i // parts for i in range(parts + 1)]
    with ThreadPoolExecutor(parts) as pool:
        list(pool.map(lambda lo, hi: fn(src + lo * src_step,
                                        dst + lo * dst_step, hi - lo),
                      bounds[:-1], bounds[1:]))


def unpack(packed, nbits):
    """Packed uint8 buffer -> float32 codes (the native decode when it
    loads, else numpy)."""
    _check(nbits)
    lib = _load()
    if lib is None:
        return unpack_numpy(packed, nbits)
    packed = np.ascontiguousarray(packed, dtype=np.uint8).ravel()
    per = _PER_BYTE[nbits]
    out = np.empty(packed.size * per, dtype=np.float32)
    _native_run(getattr(lib, f"unpack{nbits}"), packed.ctypes.data,
                out.ctypes.data, packed.size, 1, 4 * per)
    _count_native()
    return out


def pack(values, nbits):
    """Float values -> packed uint8, clipped to the codes (the native
    encode when it loads, else numpy)."""
    _check(nbits)
    lib = _load()
    if lib is None:
        return pack_numpy(values, nbits)
    per = _PER_BYTE[nbits]
    v = np.ascontiguousarray(values, dtype=np.float32).ravel()
    if v.size % per:
        raise ValueError(f"value count {v.size} not a multiple of {per}")
    out = np.empty(v.size // per, dtype=np.uint8)
    _native_run(getattr(lib, f"pack{nbits}"), v.ctypes.data,
                out.ctypes.data, out.size, 4 * per, 1)
    _count_native()
    return out


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


def unpack_from_meta(data, meta):
    """:func:`device_unpack_block` of packed frames ``data`` (a tensor)
    from a :meth:`PackedFrames.meta` tuple ``(nbits, nchan, descending,
    dtype name)``."""
    nbits, nchan, descending, dtype_name = meta
    return device_unpack_block(data, nbits, nchan,
                               band_descending=descending,
                               dtype=getattr(torch, dtype_name))


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
        """The host decode (:func:`unpack`) to the float32 ``(nchan,
        nsamps)`` ascending block.  The transposing copy runs on torch's
        host threads: numpy's copy of the transposed float32 view runs
        on one and took longer than the decode."""
        per_frame = self.frames.shape[1] * _PER_BYTE[self.nbits]
        block = torch.from_numpy(unpack(self.frames, self.nbits).reshape(
            self.nsamps, per_frame))[:, :self.nchan].T
        if self.band_descending:
            block = block.flip(0)
        return block.contiguous().numpy()
