"""The fused FDD kernel (``csrc/fdd.cu``) bound to PyTorch.

:func:`fdd_superblock_spectra` computes, for the ``n < superblock``
trials of one superblock,

    out[n, f] = sum_c spec[c, f] * rot0[c, f] * step[c, f]^n

with ``rot0`` and ``step`` the unit phasors of the superblock's anchor
limbs ``(3, nchan)`` and of the per-trial step limbs ``(4, nchan)``
(:func:`~.fourier.limb_phase`).  On a CUDA tensor it launches the
hand-written kernel, which builds both phasors in registers (or raises);
on a CPU tensor it runs the plain version :func:`fdd_fused_plain`, the
composition ``spec * limb_phase(anchor)`` -> the rotate-accumulate
recurrence :func:`fdd_superblock_spectra_plain` with
``limb_phase(step)``, in channel blocks.  The two sum the channels in
different orders and take cos/sin from different libraries, so they
agree to float32 tolerance, not bit for bit (the JAX package's Pallas
and scan forms differ the same way).
"""

from __future__ import annotations

import ctypes

import torch

from ..obs import roofline
from ..utils import nvcc

#: geometry compiled into csrc/fdd.cu (checked when the library loads)
THREADS = 128
TRIAL_BLOCK = 64

#: kernel launches made so far (the number of calls that reached the card)
launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = nvcc.load("fdd")
        lib.fdd_launch.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.fdd_launch.restype = ctypes.c_int
        lib.fdd_error_string.argtypes = [ctypes.c_int]
        lib.fdd_error_string.restype = ctypes.c_char_p
        lib.fdd_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.fdd_geometry.restype = None
        dims = [ctypes.c_int() for _ in range(2)]
        lib.fdd_geometry(*[ctypes.byref(d) for d in dims])
        built = tuple(d.value for d in dims)
        if built != (THREADS, TRIAL_BLOCK):
            raise nvcc.KernelBuildError(
                f"csrc/fdd.cu geometry {built} differs from the host's "
                f"{(THREADS, TRIAL_BLOCK)}")
        _lib = lib
    return _lib


def fdd_superblock_spectra_plain(u, step, superblock, acc=None):
    """The rotate-accumulate recurrence: a loop over trials, the rotation
    state one ``(nchan, nbin)`` tensor (never ``(superblock, nchan,
    nbin)``).  Trial ``n`` adds ``sum_c rot_n`` with ``rot_0 = u``,
    ``rot_{n+1} = rot_n * step``.  Returns ``acc`` plus the sums (``acc``
    updated in place when given)."""
    out = acc if acc is not None else torch.zeros(
        (superblock, u.shape[1]), dtype=torch.complex64, device=u.device)
    rot = u
    for n in range(superblock):
        out[n] += rot.sum(dim=0)
        if n + 1 < superblock:
            rot = rot * step
    return out


def fdd_fused_plain(spec, anchor_limbs, step_limbs, superblock,
                    chan_block=128):
    """The plain version of the fused kernel: per block of ``chan_block``
    channels, ``u = spec * limb_phase(anchor)`` and the recurrence with
    ``limb_phase(step)``, added into one ``(superblock, nbin)``
    accumulator (so the temporaries stay ``(chan_block, nbin)``)."""
    from .fourier import limb_phase

    nchan, nbin = spec.shape
    dev = spec.device
    k = torch.arange(nbin, dtype=torch.int64, device=dev)
    kf = k.to(torch.float32)
    anchors = anchor_limbs.to(torch.int64)
    steps = step_limbs.to(torch.int64)
    acc = torch.zeros((superblock, nbin), dtype=torch.complex64, device=dev)
    for lo in range(0, nchan, chan_block):
        hi = min(lo + chan_block, nchan)
        rot0 = limb_phase(anchors[:, lo:hi], k, kf)
        step = limb_phase(steps[:, lo:hi], k, kf)
        acc = fdd_superblock_spectra_plain(spec[lo:hi] * rot0, step,
                                           superblock, acc=acc)
        del rot0, step
    return acc


def _check_limbs(name, t, nlimb, nchan, device):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{name} must be an int32 tensor, got "
                        f"{getattr(t, 'dtype', type(t))}")
    if tuple(t.shape) != (nlimb, nchan) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({nlimb}, {nchan}) "
                         f"limb table, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the spectrum on "
                         f"{device}")


def fdd_superblock_spectra_cuda(spec, anchor_limbs, step_limbs, superblock):
    """Launch the kernel: ``spec`` ``(nchan, nbin)`` complex64, the limb
    tables ``(3, nchan)`` and ``(4, nchan)`` int32, all contiguous on one
    CUDA device.  Returns a new ``(superblock, nbin)`` complex64 tensor;
    queued on the current stream, not synchronised."""
    global launches
    if not isinstance(spec, torch.Tensor) or spec.dtype != torch.complex64:
        raise TypeError(f"spec must be a complex64 tensor, got "
                        f"{getattr(spec, 'dtype', type(spec))}")
    if spec.ndim != 2 or not spec.is_contiguous():
        raise ValueError(f"spec must be 2-D and contiguous, got shape "
                         f"{tuple(spec.shape)}")
    nchan, nbin = spec.shape
    if nchan == 0 or not 0 < superblock < 2 ** 20 or nbin >= 2 ** 24:
        raise ValueError(f"nchan={nchan}, nbin={nbin}, superblock="
                         f"{superblock} out of range")
    _check_limbs("anchor_limbs", anchor_limbs, 3, nchan, spec.device)
    _check_limbs("step_limbs", step_limbs, 4, nchan, spec.device)
    if spec.device.type != "cuda":
        raise ValueError(f"spec must be on a CUDA device, got {spec.device}")
    out = torch.empty((superblock, nbin), dtype=torch.complex64,
                      device=spec.device)
    lib = _library()
    stream = torch.cuda.current_stream(spec.device).cuda_stream
    err = lib.fdd_launch(spec.data_ptr(), anchor_limbs.data_ptr(),
                         step_limbs.data_ptr(), out.data_ptr(), nchan, nbin,
                         int(superblock), spec.device.index or 0, stream)
    if err != 0:
        raise nvcc.launch_error("fdd kernel",
                                lib.fdd_error_string(err).decode())
    launches += 1
    return out


def fdd_superblock_spectra(spec, anchor_limbs, step_limbs, superblock,
                           chan_block=128):
    """``sum_c spec[c] * rot0[c] * step[c]^n`` for ``n < superblock``:
    ``(superblock, nbin)`` complex64.  The kernel for a CUDA tensor (one
    launch over every channel), the plain version for a CPU tensor (in
    blocks of ``chan_block`` channels)."""
    with roofline.measure(spec.device, "fdd_rotate_accumulate",
                          lambda: roofline.fdd_work(*spec.shape,
                                                    superblock)):
        if spec.device.type == "cpu":
            return fdd_fused_plain(spec, anchor_limbs, step_limbs,
                                   superblock, chan_block=chan_block)
        if spec.device.type != "cuda":
            raise ValueError(f"no FDD kernel for device {spec.device}")
        return fdd_superblock_spectra_cuda(spec.contiguous(), anchor_limbs,
                                           step_limbs, superblock)
