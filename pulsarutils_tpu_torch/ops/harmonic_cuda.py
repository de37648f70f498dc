"""The harmonic scorer kernel (``csrc/harmonic.cu``) bound to PyTorch.

:func:`harmonic_peaks` median-normalises raw power spectra and runs the
incremental harmonic stack, returning the peak value and first peak bin
at every harmonic depth: on a CUDA tensor it launches the hand-written
kernel (or raises), on a CPU tensor it runs the plain version
(:func:`~.periodicity.normalize_power` then
:func:`~.periodicity.harmonic_peaks_plain`).  Both take the same true
divides and add the harmonics in the same order, so the peaks agree bit
for bit.  :func:`score_power` adds the false-alarm / best-depth / sigma
chain in PyTorch, as the JAX package's wrapper does in XLA.
"""

from __future__ import annotations

import ctypes

import torch

from .periodicity import (HARMONIC_SUMS, band_edges, best_depth,
                          harmonic_depths, harmonic_peaks_plain,
                          normalize_power)

#: geometry compiled into csrc/harmonic.cu (checked when the library loads)
THREADS = 512
MAX_DEPTHS = 5

#: kernel launches made so far (the number of calls that reached the card)
launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        from ..utils import nvcc

        lib = nvcc.load("harmonic")
        lib.harmonic_launch.argtypes = ([ctypes.c_void_p] * 3
                                        + [ctypes.c_int] * 6
                                        + [ctypes.c_void_p])
        lib.harmonic_launch.restype = ctypes.c_int
        lib.harmonic_error_string.argtypes = [ctypes.c_int]
        lib.harmonic_error_string.restype = ctypes.c_char_p
        lib.harmonic_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.harmonic_geometry.restype = None
        dims = [ctypes.c_int() for _ in range(2)]
        lib.harmonic_geometry(*[ctypes.byref(d) for d in dims])
        built = tuple(d.value for d in dims)
        if built != (THREADS, MAX_DEPTHS):
            raise RuntimeError(f"csrc/harmonic.cu geometry {built} differs "
                               f"from the host's {(THREADS, MAX_DEPTHS)}")
        _lib = lib
    return _lib


def _check_depths(depths):
    depths = tuple(int(h) for h in depths)
    if not depths or depths != HARMONIC_SUMS[:len(depths)]:
        raise ValueError(f"depths {depths} must be a non-empty prefix of "
                         f"{HARMONIC_SUMS}")
    return depths


def harmonic_peaks_cuda(power, depths, lo, hi):
    """Launch the kernel on raw power spectra ``power`` (rows, nbins)
    float32, contiguous, on a CUDA device.  Returns ``(vals (rows,
    ndepth) float32, bins (rows, ndepth) int32)``, allocated here;
    queued on the current stream."""
    global launches
    depths = _check_depths(depths)
    if not isinstance(power, torch.Tensor) or power.dtype != torch.float32:
        raise TypeError(f"power must be a torch.float32 tensor, got "
                        f"{getattr(power, 'dtype', type(power))}")
    if power.ndim != 2 or not power.is_contiguous():
        raise ValueError(f"power must be 2-D and contiguous, got shape "
                         f"{tuple(power.shape)}")
    rows, nbins = power.shape
    if rows == 0 or not 2 <= nbins < 2 ** 27:
        raise ValueError(f"power shape {tuple(power.shape)}: need rows > 0 "
                         "and 2 <= nbins < 2^27")
    if power.device.type != "cuda":
        raise ValueError(f"power must be on a CUDA device, got "
                         f"{power.device}")
    lib = _library()
    nd = len(depths)
    vals = torch.empty((rows, nd), dtype=torch.float32, device=power.device)
    bins = torch.empty((rows, nd), dtype=torch.int32, device=power.device)
    stream = torch.cuda.current_stream(power.device).cuda_stream
    err = lib.harmonic_launch(power.data_ptr(), vals.data_ptr(),
                              bins.data_ptr(), rows, nbins, nd, int(lo),
                              int(hi), power.device.index or 0, stream)
    if err != 0:
        raise RuntimeError("harmonic kernel launch failed: "
                           + lib.harmonic_error_string(err).decode())
    launches += 1
    return vals, bins


def harmonic_peaks(power, depths, lo, hi):
    """Per-depth peak values and first peak bins of the median-normalised
    harmonic stack of raw spectra ``power`` (rows, nbins): the kernel for
    a CUDA tensor, the plain version for a CPU tensor."""
    if power.device.type == "cpu":
        return harmonic_peaks_plain(normalize_power(power),
                                    _check_depths(depths), lo, hi)
    if power.device.type != "cuda":
        raise ValueError(f"no harmonic scorer for device {power.device}")
    return harmonic_peaks_cuda(power.contiguous(), depths, lo, hi)


def score_power(power, nsamples, tsamp, max_harmonics=16, fmin=None,
                fmax=None):
    """``normalize_power`` -> harmonic stack -> best depth of raw spectra
    ``power`` (..., nbins) of a length-``nsamples`` series: the dict
    ``freq, power, nharm, log_sf, sigma`` (tensors on its device)."""
    power = torch.as_tensor(power).to(torch.float32)
    lead, nbins = power.shape[:-1], power.shape[-1]
    lo, hi = band_edges(nbins, nsamples, tsamp, fmin, fmax)
    depths = harmonic_depths(max_harmonics)
    vals, bins = harmonic_peaks(power.reshape(-1, nbins), depths, lo, hi)
    vals = vals.reshape(*lead, len(depths))
    bins = bins.reshape(*lead, len(depths))
    return best_depth(vals, bins, depths, nsamples, tsamp)
