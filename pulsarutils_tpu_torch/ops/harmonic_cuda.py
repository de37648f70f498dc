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

The stack follows a :mod:`..precision` policy, as the Pallas kernel's
does: ``f32``; ``f32_compensated`` and ``split_f32`` (one branch: a
TwoSum carry beside each accumulator); ``bf16_operand_f32_accum``
(bfloat16-rounded bins added in float32).  The kernel is a template on
the policy (:data:`POLICY_CODES`).

The kernel has two branches (:func:`choose_cluster` picks one per
launch): a row held in the shared memory of a thread-block cluster of 2,
4, 8 or 16 blocks, each block a slice of ``slice_bins`` bins (read from
device memory once), the harmonic stack reading each harmonic's
decimated copy of the row from a scratch buffer; or, for rows longer
than 16 blocks hold, one block a row reading the row from device memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..precision import static_policy
from ..obs import roofline
from ..utils import nvcc
from .periodicity import (HARMONIC_SUMS, band_edges, best_depth,
                          harmonic_depths, harmonic_peaks_plain,
                          normalize_power)

#: geometry compiled into csrc/harmonic.cu (checked when the library loads)
THREADS = 512
MAX_DEPTHS = 5

#: blocks a row in the cluster branch; sizes above 8 are non-portable
#: cluster sizes, which an H100 schedules
CLUSTER_SIZES = (2, 4, 8, 16)

#: keys of the first radix pass's bucket a cluster block keeps for the
#: later passes (``kCand``); a block with more scans its slice instead
CLUSTER_CANDIDATES = 3072

#: shared memory of a cluster block besides its slice (``ClusterShared``:
#: two 2048-bin histograms, 3072 candidate keys, the scan, the selection,
#: the harmonic arrays' offsets and the peaks)
CLUSTER_FIXED_SMEM = 29508

#: shared memory one block may take (227 KB), and one SM holds (228 KB,
#: of which the card keeps 1 KB for each resident block)
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472


#: the kernel's policy code of each :mod:`..precision` policy
POLICY_CODES = {"f32": 0, "f32_compensated": 1, "split_f32": 1,
                "bf16_operand_f32_accum": 2}


def padded(q):
    """Where local bin ``q`` of a slice sits in shared memory: chunks of
    32 bins, one pad word after each."""
    return q + q // 32


def cluster_smem_bytes(slice_bins):
    """Shared memory of a cluster block that holds ``slice_bins`` bins."""
    return CLUSTER_FIXED_SMEM + 4 * (padded(slice_bins) + 1)


def _max_slice():
    lo, hi = 0, SMEM_PER_BLOCK
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if cluster_smem_bytes(mid) <= SMEM_PER_BLOCK \
            else (lo, mid - 1)
    return lo


#: the most bins one cluster block holds
MAX_SLICE = _max_slice()


def slice_bins(nbins, cluster):
    """Bins each block of a ``cluster``-block row holds (the last block
    holds the rest): a multiple of 32."""
    per_block = -(-int(nbins) // int(cluster))
    return -(-per_block // 32) * 32


def scratch_floats(nbins, depths):
    """Floats of one cluster's harmonic arrays: ``D_j[i] = norm[i*j]`` for
    ``i < ceil(nbins / j)``, ``j`` up to the deepest depth."""
    return sum(-(-int(nbins) // j) for j in range(1, depths[-1] + 1))


def cluster_fits(nbins, cluster):
    """Whether a ``cluster``-block cluster holds a row of ``nbins``."""
    return int(cluster) in CLUSTER_SIZES and slice_bins(
        nbins, cluster) <= MAX_SLICE


def choose_cluster(nbins, rows, sms):
    """The branch for ``rows`` rows of ``nbins`` bins on a card of ``sms``
    SMs: 1 (the global branch) where no cluster holds a row; else the
    smallest cluster size at which two blocks share an SM (one block's
    copy-in then overlaps the other's work), or the smallest that holds
    the row; raised while ``rows x size`` blocks leave SMs idle."""
    fits = [c for c in CLUSTER_SIZES if cluster_fits(nbins, c)]
    if not fits:
        return 1
    two = [c for c in fits if 2 * (cluster_smem_bytes(
        slice_bins(nbins, c)) + 1024) <= SMEM_PER_SM]
    cluster = (two or fits)[0]
    while rows * cluster < sms and cluster < fits[-1]:
        cluster = fits[fits.index(cluster) + 1]
    return cluster

#: kernel launches made so far, by policy (the calls that reached the card)
launches = dict.fromkeys(POLICY_CODES, 0)

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = nvcc.load("harmonic")
        lib.harmonic_launch.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 9
                                        + [ctypes.c_void_p])
        lib.harmonic_launch.restype = ctypes.c_int
        lib.harmonic_active_clusters.argtypes = [ctypes.c_int] * 4
        lib.harmonic_active_clusters.restype = ctypes.c_int
        lib.harmonic_error_string.argtypes = [ctypes.c_int]
        lib.harmonic_error_string.restype = ctypes.c_char_p
        lib.harmonic_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)] * 5
        lib.harmonic_geometry.restype = None
        dims = [ctypes.c_int() for _ in range(5)]
        lib.harmonic_geometry(*[ctypes.byref(d) for d in dims])
        built = tuple(d.value for d in dims)
        host = (THREADS, MAX_DEPTHS, CLUSTER_SIZES[-1], CLUSTER_FIXED_SMEM,
                MAX_SLICE)
        if built != host:
            raise nvcc.KernelBuildError(
                f"csrc/harmonic.cu geometry {built} differs from the "
                f"host's {host}")
        _lib = lib
    return _lib


def _check_depths(depths):
    depths = tuple(int(h) for h in depths)
    if not depths or depths != HARMONIC_SUMS[:len(depths)]:
        raise ValueError(f"depths {depths} must be a non-empty prefix of "
                         f"{HARMONIC_SUMS}")
    return depths


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _active_clusters(nbins, cluster, code, index):
    got = _library().harmonic_active_clusters(nbins, cluster, code, index)
    if got < 0:
        raise RuntimeError("harmonic_active_clusters failed: "
                           + _library().harmonic_error_string(-got).decode())
    return got


def active_clusters(nbins, cluster, device, policy=None):
    """How many ``cluster``-block clusters holding a row of ``nbins`` bins
    the card of ``device`` runs at once under ``policy`` (0: it cannot
    run one)."""
    return _active_clusters(int(nbins), int(cluster),
                            POLICY_CODES[static_policy(policy)],
                            torch.device(device).index or 0)


def _check_power(power):
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
    return rows, nbins


def harmonic_peaks_cuda(power, depths, lo, hi, cluster=None, policy=None):
    """Launch the kernel on raw power spectra ``power`` (rows, nbins)
    float32, contiguous, on a CUDA device, the stack under the precision
    ``policy``.  ``cluster``: blocks a row (1 takes the global branch;
    None lets :func:`choose_cluster` pick).  The cluster branch runs as
    many clusters as the card holds at once (at most one a row), each
    walking its rows.  Returns ``(vals (rows, ndepth) float32, bins (rows,
    ndepth) int32)``, allocated here with the clusters' scratch; queued on
    the current stream."""
    policy = static_policy(policy)
    depths = _check_depths(depths)
    rows, nbins = _check_power(power)
    if cluster is None:
        cluster = choose_cluster(nbins, rows, _sms(power.device.index or 0))
    elif cluster != 1 and not cluster_fits(nbins, cluster):
        raise ValueError(f"no {cluster}-block cluster holds {nbins} bins "
                         f"(sizes {CLUSTER_SIZES}, {MAX_SLICE} bins a "
                         "block)")
    nd = len(depths)
    vals = torch.empty((rows, nd), dtype=torch.float32, device=power.device)
    bins = torch.empty((rows, nd), dtype=torch.int32, device=power.device)
    clusters, scratch = 0, None
    if cluster > 1:
        clusters = min(rows, active_clusters(nbins, cluster, power.device,
                                             policy))
        if clusters < 1:
            raise RuntimeError(f"the card runs no {cluster}-block cluster "
                               f"of {nbins}-bin rows")
        scratch = torch.empty(clusters * scratch_floats(nbins, depths),
                              dtype=torch.float32, device=power.device)
    lib = _library()
    stream = torch.cuda.current_stream(power.device).cuda_stream
    err = lib.harmonic_launch(
        power.data_ptr(), vals.data_ptr(), bins.data_ptr(),
        None if scratch is None else scratch.data_ptr(), rows, nbins, nd,
        int(lo), int(hi), int(cluster), clusters, POLICY_CODES[policy],
        power.device.index or 0, stream)
    if err != 0:
        raise nvcc.launch_error("harmonic kernel",
                                lib.harmonic_error_string(err).decode())
    launches[policy] += 1
    return vals, bins


def harmonic_peaks(power, depths, lo, hi, policy=None):
    """Per-depth peak values and first peak bins of the median-normalised
    harmonic stack of raw spectra ``power`` (rows, nbins) under the
    precision ``policy``: the kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    with roofline.measure(power.device, "harmonic_scorer",
                          lambda: roofline.b6_work(
                              *power.shape, _check_depths(depths),
                              static_policy(policy))):
        if power.device.type == "cpu":
            return harmonic_peaks_plain(normalize_power(power),
                                        _check_depths(depths), lo, hi,
                                        policy=policy)
        if power.device.type != "cuda":
            raise ValueError(
                f"no harmonic scorer for device {power.device}")
        return harmonic_peaks_cuda(power.contiguous(), depths, lo, hi,
                                   policy=policy)


def score_power(power, nsamples, tsamp, max_harmonics=16, fmin=None,
                fmax=None, policy=None):
    """``normalize_power`` -> harmonic stack (under the precision
    ``policy``) -> best depth of raw spectra ``power`` (..., nbins) of a
    length-``nsamples`` series: the dict ``freq, power, nharm, log_sf,
    sigma`` (tensors on its device)."""
    power = torch.as_tensor(power).to(torch.float32)
    lead, nbins = power.shape[:-1], power.shape[-1]
    lo, hi = band_edges(nbins, nsamples, tsamp, fmin, fmax)
    depths = harmonic_depths(max_harmonics)
    vals, bins = harmonic_peaks(power.reshape(-1, nbins), depths, lo, hi,
                                policy=policy)
    vals = vals.reshape(*lead, len(depths))
    bins = bins.reshape(*lead, len(depths))
    return best_depth(vals, bins, depths, nsamples, tsamp)
