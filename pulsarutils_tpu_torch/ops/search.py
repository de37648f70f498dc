"""The dedispersion search: plan -> dedisperse every trial -> boxcar S/N.

:func:`dedispersion_search` is the port of the JAX package's search
façade, with six kernels:

* ``"pallas"``: the exact direct sweep (the JAX package's
  ``kernel="pallas"``): host float64 plan and offsets, the sweep in trial
  superblocks through :func:`~.dedisperse_cuda.dedisperse_plane`, and the
  batched boxcar scorer of the reference
  (``pulsarutils/dedispersion.py:186-201``);
* ``"auto"``: the measured choice among ``"pallas"``, ``"roll"`` and
  ``"gather"`` at the search's geometry
  (:func:`~..tuning.autotune.resolve_search_kernel`; the direct sweep
  below the tuning floor, with ``PUTPU_AUTOTUNE=off`` and for plane
  captures);
* ``"gather"``/``"roll"``: the JAX package's portable formulations of the
  same sweep (:func:`~.dedisperse.dedisperse_block_chunked`), trial block
  by trial block, whose channel sums follow a :mod:`..precision` policy
  (``precision=``, else ``PUTPU_PRECISION``; ``"auto"`` measured by
  :func:`~..tuning.autotune.resolve_search_policy`), after the memory
  preflight (:mod:`..resilience.memory_budget`); on the card the plain
  ``f32`` gather is the direct sweep itself (:func:`direct_gather`);
* ``"fdmt"``: the tree transform over every integer band-delay trial
  (:func:`~.fdmt.fdmt_transform`) scored in one pass
  (:func:`~.score_cuda.score_plane`), one host readback;
* ``"hybrid"``: the FDMT coarse sweep with the sliding certificate row,
  the noise certificate and guarantee loop (:mod:`.certify`), and an
  exact direct-sweep rescore of every row that could hold the best hit
  (or, with ``snr_floor``, any above-floor detection) — the JAX
  package's ``_search_jax_hybrid``: on the card a floorless search runs
  its first round as one chain of launches and one readback
  (:func:`_fused_seed`), elsewhere the two-stage path; every rescore
  gathers its rows from the plan's offset table kept on the device;
* ``"fourier"``: Fourier-domain dedispersion at exact fractional-sample
  delays (:func:`~.fourier.search_fourier`).

Every path scores its trials with :func:`~.score_cuda.score_plane`. On a
CUDA tensor each kernel wrapper launches its hand-written kernel; on a
CPU tensor it runs its plain version.
"""

from __future__ import annotations

import functools
import logging
import os
import tempfile
import weakref

import numpy as np
import torch

from ..obs import roofline
from ..resilience import ladder as _ladder
from ..utils.device import resolve_device, to_numpy
from ..utils.logging_utils import budget_bucket, budget_count
from ..utils.nvcc import KernelBuildError
from ..utils.table import ResultTable
from .dedisperse_cuda import (TRIAL_BLOCKS, dedisperse_plane,
                              dedisperse_rows, device_plan, row_table)
from .plan import dedispersion_plan, offsets_for
from .rebin import block_sum_time

logger = logging.getLogger("pulsarutils_tpu_torch")

#: boxcar widths tried by the scorer (reference ``dedispersion.py:190-191``)
SEARCH_WINDOWS = (1, 2, 4, 8)

#: sliding windows of the hybrid's certificate scorer.
#: :func:`cert_profile_scores` and ``csrc/score.cu`` unroll exactly these
#: widths, and ``certify._cert_retention_from_offsets`` bounds the same
#: set: change all three together
CERT_WINDOWS = (2, 3, 4)

#: trials dedispersed per sweep call — bounds the live plane to
#: superblock * nsamples floats (512 x 1M = 2 GB) regardless of ndm
SUPERBLOCK = 512

#: superblock rows at the OOM ladder's floor: B1's larger trial block
LADDER_FLOOR_ROWS = TRIAL_BLOCKS[-1]

#: the kernels :func:`dedispersion_search` takes
KERNELS = ("auto", "pallas", "gather", "roll", "fdmt", "hybrid", "fourier")

#: soft cap on the gather workspace (elements) of one trial block
GATHER_BUDGET_ELEMENTS = 1 << 28

#: rescore-call row buckets (requested rows pad up to the next bucket,
#: as in the JAX package, so each rescore is one sweep launch of 8, 16
#: or 32 trials)
HYBRID_RESCORE_BUCKETS = (8, 16, 32)

#: top-k coarse rows the fused seed program rescores on the device (with
#: their grid neighbours, padded to one :data:`HYBRID_SEED_BUCKET`)
HYBRID_SEED_TOPK = 2

#: rows the fused seed program rescores exactly (the JAX package's
#: choice, kept apart from :data:`HYBRID_RESCORE_BUCKETS`)
HYBRID_SEED_BUCKET = 8

#: rows the fused program's need stage rescores: the top flagged rows of
#: the guarantee loop's first round, evaluated on the device; a chunk
#: flagging more falls through to the host loop
HYBRID_NEED_BUCKET = 8

#: cap on guarantee-loop iterations before the hybrid rescores every
#: remaining candidate row (correctness is then trivial)
HYBRID_MAX_ROUNDS = 20

#: the legacy structural trust fraction of the coarse sweep, used only
#: when no certificate scores are supplied (``rho_cert=False``); the
#: hybrid otherwise uses the per-config bound of :mod:`.certify`
HYBRID_COARSE_TRUST = 0.60


# ---------------------------------------------------------------------------
# The disk-spilled plane
# ---------------------------------------------------------------------------

def plane_memmap(ndm, nsamples, directory=None, delete=False):
    """A disk-backed ``(ndm, nsamples)`` float32 plane (a ``.npy`` memmap)
    for ``capture_plane="memmap"``: a 4096-trial x 1M-sample capture is
    16 GB, beyond host RAM on many hosts.  The file is a valid ``.npy``
    (``np.load(..., mmap_mode="r")`` reopens it) at ``plane.filename``.

    Directory: ``directory``, else ``$PUTPU_PLANE_DIR``, else the system
    temp dir.  The file persists (diagnostics may outlive the search)
    until :func:`release_plane`; ``delete=True`` ties it to the returned
    memmap instead (unlinked when it is garbage-collected)."""
    directory = directory or os.environ.get("PUTPU_PLANE_DIR") or None
    fd, path = tempfile.mkstemp(suffix=".npy", prefix="putpu_plane_",
                                dir=directory)
    os.close(fd)
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                   shape=(int(ndm), int(nsamples)))
    if delete:
        weakref.finalize(mm, _unlink_quiet, path)
    return mm


def _unlink_quiet(path):
    try:
        os.unlink(path)
    except OSError:
        pass


def release_plane(plane):
    """Unlink the file behind a :func:`plane_memmap` capture; a no-op for
    any other plane.  Safe to call twice."""
    path = getattr(plane, "filename", None)
    if path:
        _unlink_quiet(path)


# ---------------------------------------------------------------------------
# Scorers (plain PyTorch)
# ---------------------------------------------------------------------------

def _centred(plane):
    """``plane`` minus its row means, each mean summed in float64 and
    rounded to the plane's float32 once.  A float32 sum of a row with a
    large DC offset is off by several of the mean's ulps (~1e-3 at 1e4,
    a relative error of ~3e-4 in the maxima); the rounded exact mean is
    within half an ulp, and the CUDA scorer reproduces it."""
    # putpu-lint: disable=float64-leak — one float64 mean a row, rounded
    mean = plane.mean(dim=1, keepdim=True, dtype=torch.float64)
    return plane - mean.to(plane.dtype)


def score_profiles(plane):
    """Score a block of dedispersed series ``(ndm, T)``.

    Returns ``(maxvalues, stds, best_snrs, best_windows, best_peaks)`` per
    trial: the mean-subtracted series' max and std, and for boxcar block
    sums of width 1, 2, 4, 8 the best ``max / std`` with its width and
    peak sample (first argmax of the block sums times the width, as an
    integer — exact at any ``T``).

    The block-sum pyramid is incremental (width 4 sums width 2's sums,
    width 8 sums width 4's), reading less than summing each width from
    the series; ``floor(floor(T/2)/2) == floor(T/4)``, so every width
    covers the same samples.  The mean subtraction stays materialised up
    front: folding it into the reductions would read raw block sums that
    cancel catastrophically in float32 on planes with a large DC offset.
    """
    x = _centred(plane)
    maxvalues = x.max(dim=1).values
    stds = torch.std(x, dim=1, correction=0)
    ndm = x.shape[0]
    best_snrs = torch.zeros(ndm, dtype=x.dtype, device=x.device)
    best_windows = torch.zeros(ndm, dtype=torch.int32, device=x.device)
    best_peaks = torch.zeros(ndm, dtype=torch.int64, device=x.device)
    reb = x
    for window in SEARCH_WINDOWS:
        if window > 1:
            reb = block_sum_time(reb, 2)
        top, arg = reb.max(dim=1)
        snr = top / torch.std(reb, dim=1, correction=0)
        better = snr > best_snrs
        best_snrs = torch.where(better, snr, best_snrs)
        best_windows = torch.where(better, window, best_windows)
        best_peaks = torch.where(better, arg * window, best_peaks)
    return maxvalues, stds, best_snrs, best_windows, best_peaks


def score_profiles_stacked(plane):
    """:func:`score_profiles` packed into ONE ``(5, ndm)`` float64 tensor
    (rows ``max, std, snr, window, peak``), so a search reads its scores
    back to the host in one transfer.  Float64 holds the float32 scores
    and every integer window and peak exactly (the JAX package packs
    float32, exact only below 2^24 samples)."""
    # putpu-lint: disable=float64-leak — the score pack, exact at any length
    return torch.stack([s.to(torch.float64) for s in score_profiles(plane)])


def cert_profile_scores(plane):
    """Sliding-window certificate score per row of a (coarse) plane:
    ``max_t (x * box_w)(t) / (std * sqrt(w))`` for ``w`` in
    :data:`CERT_WINDOWS` over all alignments, circular.  Pulse-phase
    invariant, which is what makes the hybrid's retention bound usable."""
    assert CERT_WINDOWS == (2, 3, 4), \
        "cert_profile_scores structurally unrolls widths 2/3/4"
    x = _centred(plane)
    std = torch.std(x, dim=1, correction=0)
    s2 = x + torch.roll(x, -1, dims=1)
    best = s2.max(dim=1).values / (std * float(np.float32(np.sqrt(2.0))))
    s3 = s2 + torch.roll(x, -2, dims=1)
    best = torch.maximum(best, s3.max(dim=1).values
                         / (std * float(np.float32(np.sqrt(3.0)))))
    s4 = s2 + torch.roll(s2, -2, dims=1)
    return torch.maximum(best, s4.max(dim=1).values / (std * 2.0))


def score_profiles_chunked(plane, chunk=512, with_cert=False):
    """:func:`score_profiles_stacked` over row chunks of a large plane,
    bounding the scorer's temporaries to ``chunk`` rows (128 with the
    certificate row, whose sliding sums add three plane-sized temps).
    Returns ``(5, rows)`` float64, or ``(6, rows)`` with ``with_cert``
    (the certificate scores appended)."""
    if with_cert:
        chunk = min(chunk, 128)
    rows = plane.shape[0]

    def one(sub):
        stacked = score_profiles_stacked(sub)
        if with_cert:
            # putpu-lint: disable=float64-leak — the score pack's cert row
            cert = cert_profile_scores(sub).to(torch.float64)
            stacked = torch.cat([stacked, cert[None]])
        return stacked

    return torch.cat([one(plane[lo:min(lo + chunk, rows)])
                      for lo in range(0, rows, chunk)], dim=1)


def unstack_scores(stacked):
    """Host side of a stacked score pack (one readback): ``(max, std, snr)``
    float32, windows int32, peaks int64, and the certificate scores as a
    sixth float32 element when the pack has them."""
    stacked = to_numpy(stacked)
    out = (stacked[0].astype(np.float32), stacked[1].astype(np.float32),
           stacked[2].astype(np.float32), stacked[3].astype(np.int32),
           stacked[4].astype(np.int64))
    if stacked.shape[0] > 5:
        out = out + (stacked[5].astype(np.float32),)
    return out


# ---------------------------------------------------------------------------
# The exact direct sweep
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _direct_sweep(dms_bytes, nchan, start_freq, bandwidth, sample_time,
                  nsamples, superblock, device):
    """The sweep's superblocks for one geometry, made once and kept (the
    shift table is the same for every chunk of a file): per superblock,
    its read-only ``(rows, nchan)`` offsets and, off the CPU, their
    :func:`~.dedisperse_cuda.device_plan` (else None)."""
    offsets = offsets_for(np.frombuffer(dms_bytes, dtype=np.float64), nchan,
                          start_freq, bandwidth, sample_time, nsamples)
    offsets.flags.writeable = False
    blocks = [offsets[lo:lo + superblock]
              for lo in range(0, offsets.shape[0], superblock)]
    return [(b, None if device.type == "cpu"
             else device_plan(b, nsamples, device)) for b in blocks]


def ladder_blocks(ndm):
    """The :data:`LADDER_FLOOR_ROWS`-trial blocks of the direct sweep's
    first superblock for ``ndm`` trials: the most passes the OOM ladder
    (:mod:`..resilience.ladder`) can split it into."""
    return -(-min(max(int(ndm), 1), SUPERBLOCK) // LADDER_FLOOR_ROWS)


def ladder_superblock(ndm):
    """The direct sweep's superblock rows at the OOM ladder's current
    level: :data:`SUPERBLOCK` undegraded; after ``n`` descents a
    superblock's :func:`ladder_blocks` split into ``2**n`` passes, down
    to one block a launch."""
    nblocks = ladder_blocks(ndm)
    passes = _ladder.direct_plan("pallas", nblocks)
    if passes <= 1:
        return SUPERBLOCK
    return LADDER_FLOOR_ROWS * -(-nblocks // passes)


def _search_direct_laddered(data, trial_dms, start_freq, bandwidth,
                            sample_time, capture_plane):
    """The direct sweep with the OOM ladder: an out-of-memory error
    descends a level and the sweep runs again in smaller superblocks.  A
    trial row is an independent sum over channels, scored on its own, so
    every level gives the undivided sweep's table bit for bit.  At the
    floor (one trial block a launch) the error propagates to the chunk
    loop, which descends no further."""
    nchan, nsamples = data.shape
    nblocks = ladder_blocks(len(trial_dms))
    while True:
        superblocks = _direct_sweep(
            trial_dms.tobytes(), nchan, float(start_freq), float(bandwidth),
            float(sample_time), nsamples, ladder_superblock(len(trial_dms)),
            data.device)
        try:
            return _search_direct(data, superblocks, capture_plane)
        except (ValueError, TypeError, KernelBuildError):
            raise  # deterministic: never an OOM
        except Exception as exc:
            if not _ladder.is_resource_exhausted(exc) \
                    or _ladder.direct_maxed("pallas", nblocks):
                raise
            _ladder.oom_event("direct_sweep")
            logger.warning("direct sweep out of memory (%r); ladder step "
                           "split_dm", exc)
            del superblocks
            _ladder.descend("split_dm")
            _ladder.count_split("ladder")


def _search_direct(data, superblocks, capture_plane):
    """Dedisperse ``superblocks`` (:func:`_direct_sweep`'s) and score each
    (the one-pass scorer on the card); the scores come back to the host
    once, at the end."""
    from .score_cuda import score_plane

    nsamples = data.shape[1]
    if not superblocks:  # an empty plan (inverted DM range): an empty table
        plane = (torch.zeros((0, nsamples), dtype=data.dtype,
                             device=data.device) if capture_plane else None)
        return (*[np.zeros(0, np.float32)] * 3, np.zeros(0, np.int32),
                np.zeros(0, np.int64), plane)
    ndm = sum(rows.shape[0] for rows, _ in superblocks)
    mm = plane_memmap(ndm, nsamples) if capture_plane == "memmap" else None
    scores, planes = [], []
    lo = 0
    try:
        for rows, planned in superblocks:
            with budget_bucket("search/dispatch"):
                plane = dedisperse_plane(data, rows, planned)
                scores.append(score_plane(plane))
                budget_count("dispatches", 2)
            if mm is not None:
                # the disk spill: the host holds one superblock at a time,
                # the disk the plane; the largest transfer of the search,
                # so it has a bucket of its own and one readback
                with budget_bucket("search/plane_spill"):
                    mm[lo:lo + plane.shape[0]] = to_numpy(plane)
                    budget_count("readbacks")
            elif capture_plane:
                planes.append(plane)
            lo += rows.shape[0]
            del plane
    except BaseException:
        release_plane(mm)  # a ladder descent starts a new file
        raise
    with budget_bucket("search/readback"):
        fields = unstack_scores(torch.cat(scores, dim=1))
        budget_count("readbacks")
    plane = None
    if mm is not None:
        mm.flush()
        plane = mm
    elif capture_plane:
        plane = planes[0] if len(planes) == 1 else torch.cat(planes)
    return (*fields, plane)


# ---------------------------------------------------------------------------
# The gather and roll formulations
# ---------------------------------------------------------------------------

def auto_chan_block(nchan, nsamples, dm_block):
    """Largest power-of-two channel block that divides ``nchan`` and keeps
    ``dm_block * chan_block * nsamples`` within
    :data:`GATHER_BUDGET_ELEMENTS`; None where the whole channel axis
    fits."""
    if dm_block * nchan * nsamples <= GATHER_BUDGET_ELEMENTS:
        return None
    block = 1
    candidate = 2
    while candidate <= nchan:
        if (nchan % candidate == 0
                and dm_block * candidate * nsamples <= GATHER_BUDGET_ELEMENTS):
            block = candidate
        candidate *= 2
    return block


def block_offsets(offsets, dm_block):
    """Pad the trial axis of ``offsets`` ``(ndm, nchan)`` to a multiple of
    ``dm_block`` (repeating the last trial, sliced off after the sweep)
    and reshape it to ``(nblocks, dm_block, nchan)``."""
    ndm, nchan = offsets.shape
    npad = (-ndm) % dm_block
    if npad:
        offsets = np.concatenate([offsets, offsets[-1:].repeat(npad, axis=0)])
    return offsets.reshape(-1, dm_block, nchan)


def formulation_scores(data, blocks, chan_block, formulation, policy,
                       planes=None):
    """Dedisperse each trial block of ``blocks`` ``(nblocks, dm_block,
    nchan)`` (offsets on ``data``'s device) with the gather or roll
    formulation and score it through :func:`~.score_cuda.score_plane`
    (B4 on the card).  Returns the ``(5, nblocks * dm_block)`` float64
    scores, left on the device; ``planes`` (a list) collects each
    block's plane.  Integer sums of packed codes are scored as their
    float32 view (the same values).  The body of a gather or roll sweep,
    and of every beam of a batch (:mod:`..beams.batcher`), that
    :func:`direct_gather` leaves to torch."""
    from .dedisperse import dedisperse_block_chunked
    from .score_cuda import score_plane

    scores = []
    for offs in blocks:
        plane = dedisperse_block_chunked(data, offs, chan_block,
                                         formulation, policy)
        if not plane.is_floating_point():
            plane = plane.to(torch.float32)  # exact integer sums
        scores.append(score_plane(plane))
        if planes is not None:
            planes.append(plane)
    return torch.cat(scores, dim=1)


def direct_gather(device, dtype, formulation, policy):
    """Whether a ``formulation`` sweep of ``dtype`` data on ``device``
    under ``policy`` runs as the direct sweep (:func:`direct_scores`): the
    plain ``f32`` gather of float32 data on a card.  The gather's
    contract, ``sum_c x[c, (t + off[d, c]) mod T]`` in float32, is B1's in
    B1's ascending channel order (the reference's association,
    :mod:`.dedisperse`), so its table is the direct sweep's bit for bit.
    Every other policy, an integer sum of packed codes, the roll and every
    CPU tensor keep torch's sweep (:func:`formulation_scores`): they
    define another arithmetic, or are the CPU tests' reference paths."""
    return (formulation == "gather" and policy is None
            and dtype == torch.float32
            and torch.device(device).type == "cuda")


def sweep_offsets(trial_dms, nchan, start_freq, bandwidth, sample_time,
                  nsamples, dm_block, device, direct):
    """The offsets a sweep of ``trial_dms`` at ``nsamples`` samples reads
    on ``device``: where ``direct`` (:func:`direct_gather`), the direct
    sweep's :data:`SUPERBLOCK`-trial superblocks (:func:`_direct_sweep`'s,
    kept per geometry) for :func:`direct_scores`; else the padded
    ``(nblocks, dm_block, nchan)`` device offsets of torch's sweep
    (:func:`formulation_scores`)."""
    # putpu-lint: disable=device-trip — a host trial grid
    dms = np.asarray(trial_dms, dtype=np.float64)
    if direct:
        return _direct_sweep(dms.tobytes(), int(nchan), float(start_freq),
                             float(bandwidth), float(sample_time),
                             int(nsamples), SUPERBLOCK, torch.device(device))
    offsets = offsets_for(dms, nchan, start_freq, bandwidth, sample_time,
                          nsamples)
    return torch.from_numpy(block_offsets(offsets, dm_block)).to(device)


def direct_scores(data, superblocks):
    """The ``(5, ndm)`` float64 scores of ``data`` over ``superblocks``
    (:func:`_direct_sweep`'s), left on the device: B1 then B4 a
    superblock (their plain versions on a CPU tensor), no readback, no
    gathered workspace.  Each row is :func:`_search_direct`'s bit for
    bit."""
    from .score_cuda import score_plane

    return torch.cat([score_plane(dedisperse_plane(data, rows, planned))
                      for rows, planned in superblocks], dim=1)


def _search_formulation(data, offsets, capture_plane, formulation, policy,
                        dm_block, chan_block, packed_nbits=0):
    """Dedisperse ``offsets`` ``(ndm, nchan)`` with the gather or roll
    formulation, ``dm_block`` trials at a time (default up to 32), the
    gather in blocks of ``chan_block`` channels (default
    :func:`auto_chan_block`), and score each trial block through
    :func:`~.score_cuda.score_plane`.

    First the memory preflight, where the JAX package runs it
    (:func:`~..resilience.memory_budget.preflight_direct`): where the
    estimated footprint does not fit the headroom the OOM ladder
    descends, and the trial blocks run in
    :func:`~..resilience.ladder.direct_plan` passes, each pass's scores
    read back before the next (one readback at level 0).  A trial row is
    an independent sum scored on its own, so every level gives the same
    table bit for bit.  On the card the sweep's allocator high-water
    mark is then folded into the model's calibration
    (:func:`~..resilience.memory_budget.observe`).  Each trial block is
    its own launch already (the OOM ladder's floor), so an out-of-memory
    error propagates to the chunk loop.  ``packed_nbits``: the bits a
    sample of packed input had (the model's operand term)."""
    from ..resilience import memory_budget as _membudget

    ndm = offsets.shape[0]
    nchan, nsamples = data.shape
    if ndm == 0:  # an empty plan (inverted DM range): an empty table
        plane = (torch.zeros((0, nsamples), dtype=data.dtype,
                             device=data.device) if capture_plane else None)
        return (*[np.zeros(0, np.float32)] * 3, np.zeros(0, np.int32),
                np.zeros(0, np.int64), plane)
    if dm_block is None:
        dm_block = max(1, min(ndm, 32))
    if chan_block is None:
        chan_block = auto_chan_block(nchan, nsamples, dm_block)
    blocks = torch.from_numpy(block_offsets(offsets, dm_block)).to(
        data.device)
    nblocks = blocks.shape[0]
    _membudget.preflight_direct(
        formulation, nchan, nsamples, ndm, dm_block=dm_block,
        chan_block=chan_block, capture_plane=bool(capture_plane),
        nblocks=nblocks, packed_nbits=packed_nbits, device=data.device)
    passes = _ladder.direct_plan(formulation, nblocks)
    per_pass = -(-nblocks // passes)
    calibrate = _membudget.allocator_reports_limit(data.device)
    if calibrate:
        torch.cuda.reset_peak_memory_stats(data.device)
    fields, planes = [], []
    for lo in range(0, nblocks, per_pass):
        fields.append(to_numpy(formulation_scores(
            data, blocks[lo:lo + per_pass], chan_block, formulation, policy,
            planes if capture_plane else None)))
    if calibrate:
        _membudget.observe(nchan, nsamples, ndm, _membudget.estimate_direct(
            nchan, nsamples, ndm, dm_block=dm_block, chan_block=chan_block,
            formulation=formulation, capture_plane=bool(capture_plane),
            dm_passes=passes, packed_nbits=packed_nbits)["total"],
            data.device)
    fields = unstack_scores(np.concatenate(fields, axis=1)[:, :ndm])
    plane = torch.cat(planes)[:ndm] if capture_plane else None
    return (*fields, plane)


def _sweep_policy(kernel, precision):
    """The precision policy a sweep of ``kernel`` runs under, validated as
    the JAX package validates it: ``precision`` if given, else
    ``PUTPU_PRECISION``, else ``f32``.  Only the gather and roll channel
    sums take a policy other than ``f32``.  The direct sweep and the FDD
    declare float32 and raise ``ValueError`` on any other; the FDMT and
    the hybrid raise on an explicit one, the FDMT ignores the variable
    and the hybrid checks its name (its rescore is the float32 direct
    sweep).  ``"auto"`` is measured at the sweep's geometry for the
    gather and roll (and for ``kernel="auto"``, should the tuner pick
    one of them): ``"auto"`` is returned for the caller to resolve;
    every other kernel takes the static ``f32`` pairing.  Returns None
    for ``f32``, else the strategy name."""
    from ..precision import engage, resolve_policy, static_policy

    if kernel in ("fdmt", "hybrid"):
        if precision not in (None, "f32", "auto"):
            raise ValueError(
                "precision policies apply to the gather/roll channel "
                f"reductions; got precision={precision!r} with "
                f"kernel={kernel!r}")
        if kernel == "hybrid":
            resolve_policy(None)
        return None
    name = resolve_policy(precision)
    if name == "auto" and kernel in ("gather", "roll", "auto"):
        return "auto"
    name = static_policy(name)
    if name != "f32" and kernel not in ("gather", "roll"):
        raise ValueError(
            "precision policies apply to the gather/roll channel "
            f"reductions; kernel={kernel!r} is float32-only (got policy "
            f"{name!r})")
    if name == "f32":
        return None
    return engage(name)


# ---------------------------------------------------------------------------
# The FDMT sweep and the hybrid
# ---------------------------------------------------------------------------

def _search_fdmt(data, dmmin, dmmax, start_freq, bandwidth, sample_time,
                 capture_plane, with_cert=False):
    """FDMT sweep over the integer band-delay grid on ``[dmmin, dmmax]``
    (:func:`~.fdmt.fdmt_trial_dms`): the transform, the one-pass scorer,
    one host readback.  Returns ``(trial_dms, scores, plane)``: the
    :func:`unstack_scores` tuple (with the certificate row when
    ``with_cert``) and the ``(ndm, T)`` plane or None."""
    from .fdmt import fdmt_transform, fdmt_trial_dms
    from .score_cuda import score_plane

    nchan = data.shape[0]
    trial_dms, n_lo, n_hi = fdmt_trial_dms(nchan, dmmin, dmmax, start_freq,
                                           bandwidth, sample_time)
    with budget_bucket("search/coarse"):
        plane = fdmt_transform(data, n_hi, start_freq, bandwidth,
                               min_delay=n_lo)
        stacked = score_plane(plane, with_cert=with_cert)
        budget_count("dispatches")
    with budget_bucket("search/coarse_readback"):
        scores = unstack_scores(stacked)
        budget_count("readbacks")
    return trial_dms, scores, (plane if capture_plane else None)


def iter_rescore_buckets(rows):
    """Yield ``(rows_block, padded_block)`` per fixed-size bucket: the
    request split into :data:`HYBRID_RESCORE_BUCKETS`-sized blocks, each
    padded (repeating its last row) up to the next bucket."""
    rows = np.asarray(rows)
    top = HYBRID_RESCORE_BUCKETS[-1]
    for blk_lo in range(0, len(rows), top):
        blk = rows[blk_lo:blk_lo + top]
        bucket = next(b for b in HYBRID_RESCORE_BUCKETS if b >= len(blk))
        yield blk, np.concatenate(
            [blk, blk[-1:].repeat(bucket - len(blk))])


def nearest_rows(sorted_grid, targets):
    """Index of the nearest ``sorted_grid`` entry for each target value
    (plan-grid trial DMs onto the coarse integer-band-delay grid)."""
    sorted_grid = np.asarray(sorted_grid)
    targets = np.asarray(targets)
    pos = np.searchsorted(sorted_grid, targets)
    lo = np.clip(pos - 1, 0, len(sorted_grid) - 1)
    hi = np.clip(pos, 0, len(sorted_grid) - 1)
    return np.where(np.abs(sorted_grid[lo] - targets)
                    <= np.abs(sorted_grid[hi] - targets), lo, hi)


def hybrid_guarantee_loop(coarse_snrs, snrs, exact, rescore,
                          snr_floor=None, seed_done=False,
                          cert_scores=None, rho_cert=None,
                          cert_slack=None):
    """The hybrid's seed + guarantee iteration.

    ``snrs``/``exact`` are mutated in place by ``rescore(rows)``.  The
    seed rescores the plausible-best rows (coarse S/N within 0.5 of the
    coarse best; with ``snr_floor``, every row within 0.75 of the floor)
    and their grid neighbours.  Each round then rescores every row that
    could still beat the exact best: with ``cert_scores``/``rho_cert``,
    a row whose sliding certificate score reaches ``rho_cert *
    best_exact - cert_slack`` (or, with ``snr_floor``, ``rho_cert *
    snr_floor - cert_slack``), and any row whose displayed coarse score
    already beats the exact best or the floor; without them, the legacy
    margins.  After :data:`HYBRID_MAX_ROUNDS` every remaining row is
    rescored.  ``seed_done=True`` skips the seeding round.
    """
    from .certify import HYBRID_CERT_SLACK

    if cert_slack is None:
        cert_slack = HYBRID_CERT_SLACK
    ndm = len(coarse_snrs)
    if not seed_done:
        seed = (coarse_snrs >= coarse_snrs.max() - 0.5)
        if snr_floor is not None:
            seed |= coarse_snrs >= snr_floor - 0.75
        seed_idx = np.flatnonzero(seed)
        grown = np.unique(np.clip(seed_idx[:, None]
                                  + np.arange(-1, 2)[None, :], 0, ndm - 1))
        rescore(grown)
    cert_based = cert_scores is not None and rho_cert is not None
    for _round in range(HYBRID_MAX_ROUNDS):
        best_exact = snrs[exact].max()
        if cert_based:
            need = (~exact) & (cert_scores
                               >= rho_cert * best_exact - cert_slack)
            # a row DISPLAYING a coarse score above the exact best must be
            # exact, or argbest could land on a non-exact row
            need |= (~exact) & (coarse_snrs >= best_exact)
            if snr_floor is not None:
                need |= (~exact) & (cert_scores >= rho_cert * snr_floor
                                    - cert_slack)
                need |= (~exact) & (coarse_snrs >= snr_floor)
        else:
            under = (snrs[exact] - coarse_snrs[exact]).max(initial=0.0)
            margin = max(1.5 * under, HYBRID_COARSE_TRUST * best_exact, 0.25)
            need = (~exact) & (coarse_snrs >= best_exact - margin)
            if snr_floor is not None:
                need |= (~exact) & (coarse_snrs >= snr_floor - 0.75)
        todo = np.flatnonzero(need)
        if todo.size == 0:
            break
        rescore(todo)
    else:
        # round budget exhausted: rescore EVERY remaining row
        todo = np.flatnonzero(~exact)
        if todo.size:
            rescore(todo)


def hybrid_certificate_gate(cert_scores, coarse_snrs, snrs, exact, rescore,
                            *, nchan, trial_dms, start_freq, bandwidth,
                            sample_time, nsamples, snr_floor,
                            noise_certificate, seed_done=False,
                            rho_cert=None, cert_slack=None):
    """The certificate check + guarantee loop.

    Computes the per-config retention bound (unless ``rho_cert`` gives it;
    ``rho_cert=False`` opts out of the certificate machinery and drops
    the loop to the legacy margins), certifies the chunk signal-free when
    ``noise_certificate`` and ``snr_floor`` permit (skipping the loop),
    and otherwise runs :func:`hybrid_guarantee_loop` with the cert-based
    skip criterion.  Returns ``(certified, rho_cert_min)``.

    The JAX package also turns the certificate off when its TPU transform
    zero-pads a time axis that no tile divides, because the bound assumes
    circular time.  The port's transform is circular mod ``T`` at every
    ``T`` and never pads, so that guard has nothing to catch here.
    """
    from .certify import certify_noise_only, retention_bound

    if rho_cert is False:
        cert_scores = None
        noise_certificate = False

    rho_cert_min = None
    certified = False
    if cert_scores is not None:
        if rho_cert is not None:
            rho_cert_min = float(rho_cert)
        else:
            rho_cert_min = retention_bound(nchan, trial_dms, start_freq,
                                           bandwidth, sample_time, nsamples,
                                           cert=True)
        certified = bool(noise_certificate
                         and certify_noise_only(cert_scores, snr_floor,
                                                rho_cert_min,
                                                coarse_snrs=coarse_snrs,
                                                slack=cert_slack))
    if not certified:
        hybrid_guarantee_loop(coarse_snrs, snrs, exact, rescore,
                              snr_floor=snr_floor, seed_done=seed_done,
                              cert_scores=cert_scores,
                              rho_cert=rho_cert_min,
                              cert_slack=cert_slack)
    return certified, rho_cert_min


def fused_masked_topk(score, mask, bucket):
    """Up to ``bucket`` rows of ``mask``, chosen on the device: the top
    of ``score`` restricted to ``mask`` by a stable descending sort (ties
    to the lower index, as ``jax.lax.top_k``; masked rows are ``-inf``),
    slots beyond the flagged count ``n = mask.sum()`` repeating the top
    row, so every index names a flagged row or a duplicate of one.
    Returns ``(sel, n)``: int64 ``(bucket,)`` and a 0-d count, both on
    ``score``'s device."""
    ndm = score.shape[0]
    k = min(bucket, ndm)
    masked = torch.where(mask, score, torch.full_like(score, -np.inf))
    sel = torch.sort(masked, descending=True, stable=True).indices[:k]
    if bucket > k:
        sel = torch.cat([sel, sel[:1].expand(bucket - k)])
    n = mask.sum()
    slots = torch.arange(bucket, device=score.device)
    return torch.where(slots < n, sel, sel[0]), n


def fused_need_stage(coarse, best_exact, rescored, cert_params, bucket2):
    """The guarantee loop's round-1 need mask (:func:`hybrid_guarantee_loop`'s
    certificate criterion, both consistency guards and the floor terms)
    against the seed's ``best_exact``, on the device.  ``coarse`` is the
    ``(6, ndm)`` plan-grid score pack (row 2 the block S/N, row 5 the
    certificate score), ``cert_params`` the ``(rho, slack, floor)``
    tensor of :func:`~.certify.fused_cert_params` (``+inf`` disables the
    certificate or the floor terms).  Returns ``(sel2, n_need)``: the top
    ``bucket2`` flagged rows by certificate score and the flagged count
    (:func:`fused_masked_topk`)."""
    rho, slack, floor = cert_params[0], cert_params[1], cert_params[2]
    snr_c, cert = coarse[2], coarse[5]
    need = cert >= rho * best_exact - slack
    need |= snr_c >= best_exact          # consistency guard
    need |= cert >= rho * floor - slack  # floor contract
    need |= snr_c >= floor               # its consistency guard
    need &= ~rescored
    return fused_masked_topk(cert, need, bucket2)


def unpack_fused_hybrid(packed, ndm, bucket, bucket2):
    """Host inverse of the fused seed program's packed readback:
    ``[coarse (6*ndm) | sel (bucket) | exact (5*bucket) | n_seed (1) |
    sel2 (bucket2) | exact2 (5*bucket2) | n_need (1)]``, the last four
    parts absent when ``bucket2 == 0``.  The port packs float64 (the
    scorer's own type: peaks exact at any ``T``); a float32 pack, the JAX
    package's, unpacks the same (indices exact below 2^24).  Returns
    ``(coarse, sel, seed_scores, n_seed, sel2, need_scores, n_need)``,
    ``coarse`` float64 ``(6, ndm)``."""
    coarse = packed[:6 * ndm].reshape(6, ndm).astype(np.float64)
    pos = 6 * ndm
    sel = np.rint(packed[pos:pos + bucket]).astype(np.int64)
    pos += bucket
    seed_scores = packed[pos:pos + 5 * bucket].reshape(5, bucket)
    pos += 5 * bucket
    n_seed = int(np.rint(packed[pos]))
    pos += 1
    if not bucket2:
        return coarse, sel, seed_scores, n_seed, None, None, 0
    sel2 = np.rint(packed[pos:pos + bucket2]).astype(np.int64)
    pos += bucket2
    need_scores = packed[pos:pos + 5 * bucket2].reshape(5, bucket2)
    n_need = int(np.rint(packed[pos + 5 * bucket2]))
    return coarse, sel, seed_scores, n_seed, sel2, need_scores, n_need


def fused_scores_to_host(scores):
    """A ``(5, n)`` score pack -> the host columns ``(max, std, snr,
    window, peak)``.  The JAX package's version also undoes its rebase
    rotation on the peak; the port's sweep stores its plane un-rotated,
    so its peaks need no correction."""
    m, s, b, w, p = (np.asarray(scores[i], dtype=np.float64)
                     for i in range(5))
    return m, s, b, np.rint(w).astype(np.int32), np.rint(p).astype(np.int64)


@functools.lru_cache(maxsize=4)
def _row_table(dms_bytes, nchan, start_freq, bandwidth, sample_time,
               nsamples, device):
    """The hybrid's :func:`~.dedisperse_cuda.row_table` for one geometry:
    the whole plan's offsets computed, rebased and uploaded once and kept
    (every chunk of a file and every rescore bucket gathers its rows from
    it).  Keyed on the geometry, as :func:`_direct_sweep`, so a cached
    table costs no host work at all."""
    offsets = offsets_for(np.frombuffer(dms_bytes, dtype=np.float64), nchan,
                          start_freq, bandwidth, sample_time, nsamples)
    return row_table(offsets, nsamples, device)


def _fused_seed(data, table, idx, cert_params, n_lo, n_hi, start_freq,
                bandwidth, bucket, bucket2):
    """The hybrid's first round as one chain of launches on the current
    stream and ONE readback: the FDMT coarse sweep and its scores with the
    certificate row, gathered onto the plan rows ``idx`` -> the top
    :data:`HYBRID_SEED_TOPK` rows by coarse S/N with their grid
    neighbours, padded to ``bucket`` -> their exact sweep (rows planned
    on the card) and scores -> the need stage against the seed's best
    exact S/N (:func:`fused_need_stage`) -> the exact sweep and scores of
    its ``bucket2`` rows -> one packed float64 readback
    (:func:`unpack_fused_hybrid`).  The need stage's launches run
    whatever its count: a host test of ``n_need`` would synchronise, and
    the host applies those rows only when ``n_need > 0``."""
    from .fdmt import fdmt_transform
    from .score_cuda import score_plane

    dev = data.device
    ndm = len(idx)
    # the host operands go up first: a copy from pageable host memory
    # waits for the stream, so one in the chain would stall it
    idx = torch.from_numpy(np.ascontiguousarray(idx)).to(dev)
    cert_params = torch.from_numpy(cert_params).to(dev)
    stacked = score_plane(fdmt_transform(data, n_hi, start_freq, bandwidth,
                                         min_delay=n_lo), with_cert=True)
    coarse = stacked[:, idx]                             # (6, ndm)
    k = min(HYBRID_SEED_TOPK, ndm)
    top = fused_masked_topk(coarse[2], torch.ones(ndm, dtype=torch.bool,
                                                  device=dev), k)[0]
    sel = torch.cat([top - 1, top, top + 1]).clamp(0, ndm - 1)
    sel = torch.cat([sel, sel[:1].expand(bucket - 3 * k)])
    exact = score_plane(dedisperse_rows(data, table, sel))  # (5, bucket)
    # putpu-lint: disable=float64-leak — the fused readback pack, exact rows
    parts = [coarse.reshape(-1), sel.to(torch.float64), exact.reshape(-1),
             # putpu-lint: disable=float64-leak — the pack's bucket entry
             torch.full((1,), float(bucket), dtype=torch.float64,
                        device=dev)]
    if bucket2:
        # the need mask in float32, as the JAX package evaluates it: the
        # scores are float32 values, the operand float32
        rescored = torch.zeros(ndm, dtype=torch.bool, device=dev)
        rescored[sel] = True
        sel2, n_need = fused_need_stage(
            coarse.to(torch.float32), exact[2].max().to(torch.float32),
            rescored, cert_params, bucket2)
        exact2 = score_plane(dedisperse_rows(data, table, sel2))
        # putpu-lint: disable=float64-leak — the fused readback pack
        parts += [sel2.to(torch.float64), exact2.reshape(-1),
                  # putpu-lint: disable=float64-leak — the pack's count
                  n_need.to(torch.float64)[None]]
    return torch.cat(parts).cpu().numpy()


def _fused_default(data):
    """Whether a hybrid search of ``data`` takes the fused seed program
    when the caller does not say: on the card, as the JAX package takes
    it on its accelerator."""
    return data.device.type == "cuda"


def _search_hybrid(data, trial_dms, start_freq, bandwidth, sample_time,
                   capture_plane, snr_floor=None, noise_certificate=True,
                   rho_cert=None, cert_slack=None, fused=None):
    """FDMT coarse sweep + exact rescore of the hit region.

    1. coarse-score every plan trial with the FDMT (each plan row takes
       the scores of its nearest integer-band-delay row), with the
       sliding certificate row;
    2. certify the chunk signal-free, or seed and iterate the guarantee
       loop (:func:`hybrid_certificate_gate`), rescoring rows exactly —
       same offsets, same sweep, same scorer as the direct search — in
       :data:`HYBRID_RESCORE_BUCKETS`-sized sweep launches, each bucket's
       rows gathered from the plan's offset table kept on the device
       (:func:`_row_table`).

    ``fused`` (None: the data are on the card) runs step 1 and the
    seed, with the first round's need stage, as one chain of launches and
    one readback (:func:`_fused_seed`) where the search is floorless (no
    ``snr_floor``, or no ``noise_certificate``), ``capture_plane`` is off,
    there are at least ``3 * HYBRID_SEED_TOPK`` trials and the OOM
    ladder's ``unfuse`` rung is not engaged; the host loop then goes on
    from the seed.  ``fused=True`` forces it on the CPU (the plain
    kernels), for the tests.

    The argbest row (DM, snr, rebin, peak) is therefore the exact
    sweep's; the ``exact`` column marks the rescored rows.  A certified
    chunk keeps its coarse scores (the certificate's claim is the absence
    of detections above ``snr_floor``).  ``capture_plane`` returns the
    coarse plane gathered onto the plan rows.
    """
    from .certify import fused_cert_params
    from .fdmt import fdmt_plan, fdmt_trial_dms
    from .fdmt_cuda import transform_work
    from .score_cuda import score_plane

    ndm = len(trial_dms)
    nchan, nsamples = data.shape
    dmmin = float(np.min(trial_dms))
    dmmax = float(np.max(trial_dms))
    if fused is None:
        fused = _fused_default(data)
    # The JAX package also requires a time tile that divides T
    # (_pick_fdmt_tile(T) > 0): its TPU transform zero-pads any other T,
    # which would move the rescore's circular wrap.  The port's transform
    # is circular mod T at every T and never pads, so there is nothing to
    # guard here.
    fused_seed = (fused and not capture_plane
                  and ndm >= 3 * HYBRID_SEED_TOPK
                  and (snr_floor is None or not noise_certificate)
                  and not _ladder.unfuse_engaged())
    table = _row_table(trial_dms.tobytes(), nchan, float(start_freq),
                       float(bandwidth), float(sample_time), nsamples,
                       data.device)

    plane = None
    n_need = 0
    if fused_seed:
        bucket = HYBRID_SEED_BUCKET
        bucket2 = min(HYBRID_NEED_BUCKET, ndm)
        cert_params = fused_cert_params(
            nchan, trial_dms, start_freq, bandwidth, sample_time, nsamples,
            snr_floor=snr_floor, rho_cert=rho_cert, cert_slack=cert_slack)
        coarse_dms, n_lo, n_hi = fdmt_trial_dms(nchan, dmmin, dmmax,
                                                start_freq, bandwidth,
                                                sample_time)
        idx = nearest_rows(coarse_dms, trial_dms)
        with budget_bucket("search/fused"):
            with roofline.measure(data.device, "fused_hybrid_seed",
                                  lambda: roofline.fused_seed_work(
                                      transform_work(fdmt_plan(
                                          nchan, float(start_freq),
                                          float(bandwidth), n_hi, n_lo),
                                          nsamples),
                                      len(coarse_dms), nchan, nsamples,
                                      (bucket, bucket2))):
                packed = _fused_seed(data, table, idx, cert_params, n_lo,
                                     n_hi, start_freq, bandwidth, bucket,
                                     bucket2)
            budget_count("dispatches")
            budget_count("readbacks")
        (coarse, sel, seed_scores, _, sel2, need_scores,
         n_need) = unpack_fused_hybrid(packed, ndm, bucket, bucket2)
        maxvalues, stds, snrs = coarse[0], coarse[1], coarse[2]
        windows = np.rint(coarse[3]).astype(np.int32)
        peaks = np.rint(coarse[4]).astype(np.int64)
        cert_scores = coarse[5]
    else:
        coarse_dms, coarse, plane = _search_fdmt(
            data, dmmin, dmmax, start_freq, bandwidth, sample_time,
            capture_plane, with_cert=True)
        idx = nearest_rows(coarse_dms, trial_dms)
        if plane is not None:
            plane = plane[torch.from_numpy(idx).to(plane.device)]
        c_max, c_std, c_snr, c_win, c_peak, c_cert = coarse
        maxvalues = c_max.astype(np.float64)[idx]
        stds = c_std.astype(np.float64)[idx]
        snrs = c_snr.astype(np.float64)[idx]
        windows = c_win[idx]
        peaks = c_peak[idx]
        cert_scores = c_cert.astype(np.float64)[idx]
    coarse_snrs = snrs.copy()
    exact = np.zeros(ndm, dtype=bool)

    def apply(blk, scored):
        m, s, b, w, p = scored
        k = len(blk)
        maxvalues[blk] = m[:k]
        stds[blk] = s[:k]
        snrs[blk] = b[:k]
        windows[blk] = w[:k]
        peaks[blk] = p[:k]
        exact[blk] = True

    rescore_kernel = {}

    def kernel_of_rescore():
        """The two-stage path's rescore kernel: ONE tuner resolution at
        the chunk geometry (the whole plan's ``ndm``), shared by every
        bucket and made at the first rescore (a certified chunk never
        pays it), as in the JAX package — a bucket-sized key would tune
        mid-loop, and neighbouring buckets could differ.  The fused seed
        program's path keeps the direct sweep, as the JAX package's
        accelerator path keeps its Pallas kernel."""
        if "k" not in rescore_kernel:
            kern = "pallas"
            if not fused_seed:
                from ..tuning.autotune import resolve_search_kernel

                kern = resolve_search_kernel(
                    nchan, nsamples, ndm, None, False, start_freq,
                    bandwidth, sample_time, trial_dms, device=data.device)
            rescore_kernel["k"] = kern
        return rescore_kernel["k"]

    def rescore(rows):
        """Exact scores for ``rows``: per bucket, one direct-sweep launch
        of the table's rows and one scorer launch, or the gather or roll
        formulation's sweep of the bucket's trials where the tuner chose
        it (:func:`kernel_of_rescore`)."""
        budget_count("rescore_calls")
        budget_count("rescore_rows", len(rows))
        kern = kernel_of_rescore()
        for blk, padded in iter_rescore_buckets(rows):
            with budget_bucket("search/rescore"):
                if kern == "pallas":
                    scored = unstack_scores(
                        score_plane(dedisperse_rows(data, table, padded)))
                else:
                    scored = _search_formulation(
                        data, offsets_for(trial_dms[padded], nchan,
                                          start_freq, bandwidth,
                                          sample_time, nsamples),
                        False, kern, None, None, None)[:5]
                budget_count("dispatches")
                budget_count("readbacks")
            apply(blk, scored)

    if fused_seed:
        # the device's seed rows, and its need-stage rows only where the
        # stage flagged any (its scores are then of flagged rows)
        apply(sel, fused_scores_to_host(seed_scores))
        if n_need > 0:
            apply(sel2, fused_scores_to_host(need_scores))
    certified, rho_cert_min = hybrid_certificate_gate(
        cert_scores, coarse_snrs, snrs, exact, rescore, nchan=nchan,
        trial_dms=trial_dms, start_freq=start_freq, bandwidth=bandwidth,
        sample_time=sample_time, nsamples=nsamples, snr_floor=snr_floor,
        noise_certificate=noise_certificate, seed_done=fused_seed,
        rho_cert=rho_cert, cert_slack=cert_slack)
    logger.debug("hybrid: %d/%d rows rescored exactly%s%s", exact.sum(),
                 ndm, f" (device need stage flagged {n_need})"
                 if fused_seed else "",
                 " (noise-certified)" if certified else "")
    return (maxvalues, stds, snrs, windows, peaks, exact, plane,
            cert_scores, certified, rho_cert_min)


# ---------------------------------------------------------------------------
# Public façade
# ---------------------------------------------------------------------------

def dedispersion_search(data, dmmin, dmmax, start_freq, bandwidth, sample_time,
                        show=False, *, capture_plane=None, trial_dms=None,
                        kernel="auto", snr_floor=None, noise_certificate=True,
                        rho_cert=None, cert_slack=None, precision=None,
                        dm_block=None, chan_block=None, dtype=None,
                        device="cuda"):
    """Sweep trial DMs over ``data`` ``(nchan, T)`` and score each series.

    ``data`` is a float block or a :class:`~..io.lowbit.PackedFrames`, a
    packed 1/2/4-bit chunk: its packed bytes go to ``device`` and are
    unpacked there (:func:`~..io.lowbit.device_unpack_block`), to float32
    for every kernel but ``"gather"`` and ``"roll"``, which sum the codes
    in the exact integer type of :func:`~..io.lowbit.accum_dtype` (int16
    or int32) unless the plane is captured, and score the integer plane's
    float32 view (the same values).  ``dtype``: the input's dtype, float32
    (None) only, as the JAX package requires of packed input.

    ``kernel``: ``"pallas"`` runs the exact direct sweep (the JAX
    package's names, so its flags carry over); ``"gather"`` and
    ``"roll"`` the JAX package's portable formulations of it, whose
    channel sums follow ``precision`` (on the card the ``f32`` gather of
    float32 data runs the direct sweep, the same sums,
    :func:`direct_gather`); ``"auto"`` the fastest of the
    three at this geometry on ``device``, measured once and cached
    (:func:`~..tuning.autotune.resolve_search_kernel`: the direct sweep
    below ``PUTPU_AUTOTUNE_MIN`` elements, with ``PUTPU_AUTOTUNE=off``
    and for plane captures); ``"fdmt"`` the tree transform on
    its own integer band-delay grid (``trial_dms``, if given, only bounds
    the DM range); ``"hybrid"`` the FDMT coarse sweep plus the exact
    rescore of the hit region (exact hits on the plan grid);
    ``"fourier"`` Fourier-domain dedispersion at the un-rounded delays.
    ``trial_dms`` replaces the default plan (one trial per integer sample
    of band-crossing delay).

    ``precision``: the :mod:`..precision` policy of the gather and roll
    channel sums (``"f32"``, ``"f32_compensated"``, ``"split_f32"``,
    ``"bf16_operand_f32_accum"``, or ``"auto"``: for the gather and roll
    the measured pairing, :func:`~..tuning.autotune.
    resolve_search_policy`, else ``f32``); None reads
    ``PUTPU_PRECISION``, else ``f32``.  A policy
    other than ``f32`` raises ``ValueError`` with the direct sweep and
    the FDD (from the argument or the variable) and with the FDMT and the
    hybrid (from the argument; the FDMT ignores the variable, the hybrid
    checks its name and rescores in float32), as in the JAX package.
    ``dm_block`` and ``chan_block``: the gather and roll formulations'
    trial and channel blocks (defaults: up to 32 trials, the channel
    block that keeps a gather within :data:`GATHER_BUDGET_ELEMENTS`).

    Hybrid only: ``snr_floor`` makes every row that could hold an
    above-floor detection exact and enables the noise certificate
    (``noise_certificate``, default on; the verdict is in
    ``table.meta["certified"]``); ``rho_cert`` gives the per-config
    certificate retention bound (None: computed from the merge tables;
    False: no certificate, legacy margins); ``cert_slack`` overrides
    :data:`~.certify.HYBRID_CERT_SLACK`.

    ``device`` is where the search runs: ``"cuda"`` (default; raises
    without a card) or ``"cpu"``.

    ``capture_plane="memmap"`` (the direct sweep only) spills each
    superblock's plane to a ``.npy`` memmap on disk (:func:`plane_memmap`)
    and returns that ``np.memmap``; free its file with
    :func:`release_plane`.  The other kernels hold the whole plane on the
    device and raise ``ValueError``, as the JAX package's do.

    Returns a :class:`~..utils.table.ResultTable` with columns
    ``DM, max, std, snr, rebin, peak`` (the hybrid adds ``exact`` and
    ``cert`` and a certificate ``meta``) — plus the ``(ndm, T)`` plane
    tensor when ``show`` or ``capture_plane`` is set.
    """
    from ..io.lowbit import PackedFrames, accum_dtype

    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    policy = _sweep_policy(kernel, precision)
    if capture_plane is None:
        capture_plane = bool(show)
    packed = data if isinstance(data, PackedFrames) else None
    if dtype is not None and dtype not in (torch.float32, "float32"):
        raise ValueError(
            "packed low-bit input unpacks to float32 (or an exact integer "
            "accumulator); pass dtype=None" if packed is not None else
            f"dtype={dtype!r}: the search takes float32 input only")
    if capture_plane == "memmap" and kernel not in ("auto", "pallas"):
        why = {"fdmt": "the tree transform is one whole-plane program",
               "hybrid": "the hybrid's coarse plane is one whole-plane "
                         "program"}.get(kernel, "the gather, roll and FDD "
                                        "kernels hold the plane in device "
                                        "memory")
        raise ValueError("capture_plane='memmap' requires kernel="
                         f"'pallas'/'auto' ({why})")
    dev = resolve_device(device)
    if packed is not None:
        acc = (accum_dtype(packed.nbits, packed.nchan)
               if kernel in ("gather", "roll") and not capture_plane
               else None)
        data = packed.to_device(dev, getattr(torch, acc or "float32"))
    else:
        data = torch.as_tensor(data).to(device=dev, dtype=torch.float32)
    if data.ndim != 2:
        raise ValueError(f"data must be (nchan, T), got {tuple(data.shape)}")
    data = data.contiguous()
    nchan, nsamples = data.shape

    if kernel == "fdmt":
        if trial_dms is not None:
            dmmin = float(np.min(trial_dms))
            dmmax = float(np.max(trial_dms))
        trial_dms, scores, plane = _search_fdmt(
            data, dmmin, dmmax, start_freq, bandwidth, sample_time,
            capture_plane)
        table = ResultTable(dict(zip(
            ("DM", "max", "std", "snr", "rebin", "peak"),
            (trial_dms, *scores))))
        return (table, plane) if capture_plane else table

    if trial_dms is None:
        with budget_bucket("search/plan"):
            trial_dms = dedispersion_plan(nchan, dmmin, dmmax, start_freq,
                                          bandwidth, sample_time)
    # putpu-lint: disable=device-trip — a host plan
    trial_dms = np.asarray(trial_dms, dtype=np.float64)
    if kernel == "auto":
        kernel = "pallas"  # an empty plan: nothing to measure
        if len(trial_dms):
            from ..tuning.autotune import resolve_search_kernel

            kernel = resolve_search_kernel(
                nchan, nsamples, len(trial_dms), None, capture_plane,
                start_freq, bandwidth, sample_time, trial_dms,
                dm_block=dm_block, chan_block=chan_block, device=dev)
    if policy == "auto":
        policy = None
        if kernel in ("gather", "roll") and len(trial_dms):
            from ..precision import engage
            from ..tuning.autotune import resolve_search_policy

            name = resolve_search_policy(
                kernel, nchan, nsamples, len(trial_dms), start_freq,
                bandwidth, sample_time, trial_dms, dm_block=dm_block,
                chan_block=chan_block, device=dev).split("+", 1)[1]
            policy = None if name == "f32" else engage(name)

    if kernel == "fourier":
        from .fourier import search_fourier

        *scores, plane = search_fourier(
            data, trial_dms, start_freq, bandwidth, sample_time,
            capture_plane=capture_plane)
        table = ResultTable(dict(zip(
            ("DM", "max", "std", "snr", "rebin", "peak"),
            (trial_dms, *scores))))
        return (table, plane) if capture_plane else table

    if kernel == "hybrid":
        from .certify import cert_meta

        (maxvalues, stds, best_snrs, best_windows, best_peaks, exact,
         plane, cert_scores, certified, rho_out) = _search_hybrid(
            data, trial_dms, start_freq, bandwidth, sample_time,
            capture_plane, snr_floor=snr_floor,
            noise_certificate=noise_certificate, rho_cert=rho_cert,
            cert_slack=cert_slack)
        table = ResultTable({
            "DM": trial_dms,
            "max": maxvalues,
            "std": stds,
            "snr": best_snrs,
            "rebin": best_windows,
            "peak": best_peaks,
            "exact": exact,
            "cert": cert_scores,
        }, meta=cert_meta(certified, rho_out, snr_floor, cert_slack))
        return (table, plane) if capture_plane else table

    if kernel in ("gather", "roll") \
            and not direct_gather(data.device, data.dtype, kernel, policy):
        offsets = offsets_for(trial_dms, nchan, start_freq, bandwidth,
                              sample_time, nsamples)
        (maxvalues, stds, best_snrs, best_windows, best_peaks,
         plane) = _search_formulation(
             data, offsets, capture_plane, kernel, policy, dm_block,
             chan_block,
             packed_nbits=packed.nbits if packed is not None else 0)
    else:
        (maxvalues, stds, best_snrs, best_windows, best_peaks,
         plane) = _search_direct_laddered(data, trial_dms, start_freq,
                                          bandwidth, sample_time,
                                          capture_plane)
    table = ResultTable({
        "DM": trial_dms,
        "max": maxvalues,
        "std": stds,
        "snr": best_snrs,
        "rebin": best_windows,
        "peak": best_peaks,
    })
    return (table, plane) if capture_plane else table
