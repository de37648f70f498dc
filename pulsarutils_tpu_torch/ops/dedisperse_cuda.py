"""The direct-sweep CUDA kernel (``csrc/dedisperse.cu``) bound to PyTorch.

:func:`dedisperse_plane` is the sweep the search calls: on a CUDA tensor it
launches the hand-written kernel (or raises), on a CPU tensor it runs the
plain version :func:`~.dedisperse.dedisperse_plane_plain`.  Both give the
same plane bit for bit.

The host side of a launch (:func:`launch_plan`) rebases the offsets so
that a block of trials never straddles the circular wrap, folds the
rebase constant into the kernel's store index, and measures the largest
per-channel offset spread within one block of trials, which sizes the
shared-memory window or sends the kernel to its global-memory branch.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..utils.device import to_numpy
from .dedisperse import dedisperse_plane_plain

#: tiling compiled into csrc/dedisperse.cu (checked against the library
#: when it is loaded)
TRIAL_BLOCK = 32
TIME_TILE = 512
CHAN_BLOCK = 16

#: dynamic shared memory a block may use for its channel windows; a
#: larger window takes the global-memory branch
SMEM_BUDGET = 96 * 1024

#: kernel launches made so far (the number of calls that reached the card)
launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        from ..utils import nvcc

        lib = nvcc.load("dedisperse")
        lib.dedisperse_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.dedisperse_launch.restype = ctypes.c_int
        lib.dedisperse_error_string.argtypes = [ctypes.c_int]
        lib.dedisperse_error_string.restype = ctypes.c_char_p
        lib.dedisperse_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.dedisperse_geometry.restype = None
        dims = [ctypes.c_int() for _ in range(3)]
        lib.dedisperse_geometry(*[ctypes.byref(d) for d in dims])
        built = tuple(d.value for d in dims)
        if built != (TRIAL_BLOCK, TIME_TILE, CHAN_BLOCK):
            raise RuntimeError(
                f"csrc/dedisperse.cu tiling {built} differs from the host's "
                f"{(TRIAL_BLOCK, TIME_TILE, CHAN_BLOCK)}")
        _lib = lib
    return _lib


def rebase_offsets(offsets, nsamples):
    """Wrapped ``[0, T)`` offsets -> non-negative offsets without the wrap
    discontinuity, plus the constant ``k`` they were shifted by.

    ``x[c, (t + off) mod T] == x[c, (t + k + rebased) mod T]``, so the
    kernel computes the plane at time ``(t + k) mod T`` and stores it at
    ``t``.  Returns ``(rebased int32, k)``.
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    half = nsamples // 2
    signed = (offsets + half) % nsamples - half
    k = int(signed.min(initial=0))
    return (signed - k).astype(np.int32), k


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Host-side arguments of one kernel launch."""
    offsets: np.ndarray   # (ndm, nchan) int32, rebased
    store_shift: int      # the kernel's value at u is stored at (u + shift) mod T
    spread: int           # largest per-channel offset range in a trial block
    win: int              # shared-memory window length per channel
    use_smem: bool        # False: the kernel's global-memory branch


def launch_plan(offsets, nsamples):
    """Plan a launch for ``offsets`` ``(ndm, nchan)`` over ``nsamples``."""
    rebased, k = rebase_offsets(offsets, nsamples)
    starts = np.arange(0, rebased.shape[0], TRIAL_BLOCK)
    spread = int((np.maximum.reduceat(rebased, starts, axis=0)
                  - np.minimum.reduceat(rebased, starts, axis=0)).max())
    win = TIME_TILE + spread
    return LaunchPlan(offsets=rebased, store_shift=(-k) % nsamples,
                      spread=spread, win=win,
                      use_smem=CHAN_BLOCK * win * 4 <= SMEM_BUDGET)


def dedisperse_plane_cuda(data, offsets, store_shift, win, use_smem):
    """Launch the kernel on ``data`` (nchan, T) float32 and the rebased
    ``offsets`` (ndm, nchan) int32, both contiguous on one CUDA device.

    Returns the ``(ndm, T)`` plane, allocated here; the launch is queued
    on the current stream and not synchronised.
    """
    global launches
    for name, t, dtype in (("data", data, torch.float32),
                           ("offsets", offsets, torch.int32)):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"{name} must be a {dtype} tensor, got "
                            f"{getattr(t, 'dtype', type(t))}")
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nchan, nsamples = data.shape
    ndm = offsets.shape[0]
    if offsets.shape[1] != nchan or ndm == 0 or nchan == 0:
        raise ValueError(f"offsets shape {tuple(offsets.shape)} does not "
                         f"match data shape {tuple(data.shape)}")
    if nsamples >= 2 ** 30 or not TIME_TILE <= win < 2 ** 30:
        raise ValueError(f"nsamples={nsamples}, win={win} out of range")
    if data.device.type != "cuda" or offsets.device != data.device:
        raise ValueError(f"data and offsets must be on one CUDA device, got "
                         f"{data.device} and {offsets.device}")
    lib = _library()
    out = torch.empty((ndm, nsamples), dtype=torch.float32,
                      device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = lib.dedisperse_launch(
        data.data_ptr(), offsets.data_ptr(), out.data_ptr(), nchan, nsamples,
        ndm, int(store_shift), int(win), int(bool(use_smem)),
        data.device.index or 0, stream)
    if err != 0:
        raise RuntimeError("dedisperse kernel launch failed: "
                           + lib.dedisperse_error_string(err).decode())
    launches += 1
    return out


def dedisperse_plane(data, offsets):
    """Dedispersed plane ``out[d, t] = sum_c data[c, (t + off[d, c]) % T]``.

    ``data`` is a float32 ``(nchan, T)`` tensor; ``offsets`` the host
    ``(ndm, nchan)`` integer table (numpy array or CPU tensor).  A CUDA
    tensor runs the kernel; a CPU tensor runs the plain version.
    """
    if data.device.type == "cpu":
        return dedisperse_plane_plain(data, offsets)
    if data.device.type != "cuda":
        raise ValueError(f"no dedispersion sweep for device {data.device}")
    plan = launch_plan(to_numpy(offsets), data.shape[1])
    off = torch.from_numpy(plan.offsets).to(data.device)
    return dedisperse_plane_cuda(data, off, plan.store_shift, plan.win,
                                 plan.use_smem)
