"""The FDD rotate-accumulate kernel (``csrc/fdd.cu``) bound to PyTorch.

:func:`fdd_superblock_spectra` computes ``out[n, f] = sum_c u[c, f] *
step[c, f]^n`` for the ``n < superblock`` trials of one superblock: on a
CUDA tensor it launches the hand-written kernel (or raises), on a CPU
tensor it runs the plain version :func:`fdd_superblock_spectra_plain`.
The two sum the channels in different orders, so they agree to float32
tolerance, not bit for bit (the JAX package's Pallas and scan forms
differ the same way).
"""

from __future__ import annotations

import ctypes

import torch

#: geometry compiled into csrc/fdd.cu (checked when the library loads)
THREADS = 128
TRIAL_BLOCK = 32

#: kernel launches made so far (the number of calls that reached the card)
launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        from ..utils import nvcc

        lib = nvcc.load("fdd")
        lib.fdd_launch.argtypes = ([ctypes.c_void_p] * 3
                                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.fdd_launch.restype = ctypes.c_int
        lib.fdd_error_string.argtypes = [ctypes.c_int]
        lib.fdd_error_string.restype = ctypes.c_char_p
        lib.fdd_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.fdd_geometry.restype = None
        dims = [ctypes.c_int() for _ in range(2)]
        lib.fdd_geometry(*[ctypes.byref(d) for d in dims])
        built = tuple(d.value for d in dims)
        if built != (THREADS, TRIAL_BLOCK):
            raise RuntimeError(f"csrc/fdd.cu geometry {built} differs from "
                               f"the host's {(THREADS, TRIAL_BLOCK)}")
        _lib = lib
    return _lib


def fdd_superblock_spectra_plain(u, step, superblock, acc=None):
    """The plain version: a loop over trials, the rotation state one
    ``(nchan, nbin)`` tensor (never ``(superblock, nchan, nbin)``).
    Trial ``n`` adds ``sum_c rot_n`` with ``rot_0 = u``, ``rot_{n+1} =
    rot_n * step``.  Returns ``acc`` plus the sums (``acc`` updated in
    place when given)."""
    out = acc if acc is not None else torch.zeros(
        (superblock, u.shape[1]), dtype=torch.complex64, device=u.device)
    rot = u
    for n in range(superblock):
        out[n] += rot.sum(dim=0)
        if n + 1 < superblock:
            rot = rot * step
    return out


def _check(name, t, nchan=None, nbin=None):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.complex64:
        raise TypeError(f"{name} must be a complex64 tensor, got "
                        f"{getattr(t, 'dtype', type(t))}")
    if t.ndim != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be 2-D and contiguous, got shape "
                         f"{tuple(t.shape)}")
    if nbin is not None and t.shape[1] != nbin:
        raise ValueError(f"{name} has {t.shape[1]} bins, expected {nbin}")
    if nchan is not None and t.shape[0] != nchan:
        raise ValueError(f"{name} has {t.shape[0]} rows, expected {nchan}")


def fdd_superblock_spectra_cuda(u, step, superblock, acc=None):
    """Launch the kernel: ``u``, ``step`` ``(nchan, nbin)`` complex64,
    contiguous, on one CUDA device.  With ``acc`` ``(superblock, nbin)``
    the sums are added into it (``acc + sum``, the JAX package's
    association); else a new output is allocated.  Queued on the current
    stream, not synchronised."""
    global launches
    _check("u", u)
    nchan, nbin = u.shape
    _check("step", step, nchan, nbin)
    if nchan == 0 or not 0 < superblock < 2 ** 20 or nbin >= 2 ** 30:
        raise ValueError(f"nchan={nchan}, nbin={nbin}, superblock="
                         f"{superblock} out of range")
    if u.device.type != "cuda" or step.device != u.device:
        raise ValueError(f"u and step must be on one CUDA device, got "
                         f"{u.device} and {step.device}")
    accumulate = acc is not None
    if accumulate:
        _check("acc", acc, superblock, nbin)
        if acc.device != u.device:
            raise ValueError("acc must be on the device of u")
        out = acc
    else:
        out = torch.empty((superblock, nbin), dtype=torch.complex64,
                          device=u.device)
    lib = _library()
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = lib.fdd_launch(u.data_ptr(), step.data_ptr(), out.data_ptr(),
                         nchan, nbin, int(superblock), int(accumulate),
                         u.device.index or 0, stream)
    if err != 0:
        raise RuntimeError("fdd kernel launch failed: "
                           + lib.fdd_error_string(err).decode())
    launches += 1
    return out


def fdd_superblock_spectra(u, step, superblock, acc=None):
    """``[acc +] sum_c u[c] * step[c]^n`` for ``n < superblock``:
    ``(superblock, nbin)`` complex64.  The kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if u.device.type == "cpu":
        return fdd_superblock_spectra_plain(u, step, superblock, acc=acc)
    if u.device.type != "cuda":
        raise ValueError(f"no FDD kernel for device {u.device}")
    return fdd_superblock_spectra_cuda(u.contiguous(), step.contiguous(),
                                       superblock, acc=acc)
