"""The one-pass scorer kernel (``csrc/score.cu``) bound to PyTorch.

:func:`score_plane` scores a coarse (FDMT) plane: on a CUDA tensor it
launches the hand-written kernel (or raises), on a CPU tensor it runs the
plain version :func:`~.search.score_profiles_chunked`.  Both return the
stacked ``(5, rows)`` float64 scores (``(6, rows)`` with the sliding
certificate row) of :func:`~.search.score_profiles_stacked`: windows and
peaks are equal, floats agree to float32 reduction order.
"""

from __future__ import annotations

import ctypes

import torch

from ..obs import roofline
from ..utils import nvcc

#: geometry compiled into csrc/score.cu (checked against the library when
#: it is loaded)
THREADS = 256
CENTRE_SAMPLES = 4096

#: kernel launches made so far (the number of calls that reached the card)
launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = nvcc.load("score")
        lib.score_launch.argtypes = ([ctypes.c_void_p] * 2
                                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.score_launch.restype = ctypes.c_int
        lib.score_error_string.argtypes = [ctypes.c_int]
        lib.score_error_string.restype = ctypes.c_char_p
        lib.score_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.score_geometry.restype = None
        dims = [ctypes.c_int() for _ in range(2)]
        lib.score_geometry(*[ctypes.byref(d) for d in dims])
        built = tuple(d.value for d in dims)
        if built != (THREADS, CENTRE_SAMPLES):
            raise nvcc.KernelBuildError(
                f"csrc/score.cu geometry {built} differs from the host's "
                f"{(THREADS, CENTRE_SAMPLES)}")
        _lib = lib
    return _lib


def score_plane_cuda(plane, with_cert=False):
    """Launch the scorer on ``plane`` ``(rows, T)`` float32, contiguous, on
    a CUDA device, ``T >= 8``.  Returns the ``(5|6, rows)`` float64
    stacked scores, allocated here; queued on the current stream."""
    global launches
    if not isinstance(plane, torch.Tensor) or plane.dtype != torch.float32:
        raise TypeError(f"plane must be a torch.float32 tensor, got "
                        f"{getattr(plane, 'dtype', type(plane))}")
    if plane.ndim != 2:
        raise ValueError(f"plane must be 2-D, got shape {tuple(plane.shape)}")
    if not plane.is_contiguous():
        raise ValueError("plane must be contiguous")
    rows, nsamples = plane.shape
    if rows == 0 or not 8 <= nsamples < 2 ** 30:
        raise ValueError(f"plane shape {tuple(plane.shape)}: need rows > 0 "
                         "and 8 <= T < 2^30")
    if plane.device.type != "cuda":
        raise ValueError(f"plane must be on a CUDA device, got "
                         f"{plane.device}")
    lib = _library()
    # putpu-lint: disable=float64-leak — the kernel writes the float64 score pack
    out = torch.empty((6 if with_cert else 5, rows), dtype=torch.float64,
                      device=plane.device)
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    err = lib.score_launch(plane.data_ptr(), out.data_ptr(), rows, nsamples,
                           int(bool(with_cert)), plane.device.index or 0,
                           stream)
    if err != 0:
        raise nvcc.launch_error("score kernel",
                                lib.score_error_string(err).decode())
    launches += 1
    return out


def score_plane(plane, with_cert=False):
    """Stacked scores of ``plane`` ``(rows, T)``: the kernel for a CUDA
    tensor, the plain :func:`~.search.score_profiles_chunked` for a CPU
    tensor."""
    nout = (6 if with_cert else 5) * plane.shape[0]
    with roofline.measure(plane.device, "one_pass_scorer",
                          lambda: roofline.score_work(*plane.shape, nout)):
        if plane.device.type == "cpu":
            from .search import score_profiles_chunked

            return score_profiles_chunked(plane, with_cert=with_cert)
        if plane.device.type != "cuda":
            raise ValueError(f"no scorer for device {plane.device}")
        return score_plane_cuda(plane.contiguous(), with_cert=with_cert)
