"""Sharded dedispersion sweep over a (dm, chan) device mesh.

The port of the JAX package's module, the exact direct sweep laid over
a :class:`~.mesh.Mesh`:

* the input ``(nchan, T)`` is split over the ``chan`` axis: each shard
  reads its channel slice, a view of the input where the shard's device
  is the input's (a virtual mesh on one card needs no more memory than
  the single-device search) and one copy per device and slice elsewhere;
* the offset table ``(ndm, nchan)`` is split over both axes;
* each shard dedisperses its (trial shard x channel shard) block: B1
  (:func:`~..ops.dedisperse_cuda.dedisperse_plane`) under
  ``kernel="pallas"``, the gather formulation under ``"gather"`` (its
  roll-accumulate form on the CPU, as the JAX package's mesh runs it
  there);
* the channel shards' partial planes are added on the dm row's first
  device in ascending channel-shard order (:func:`chan_sum`, the JAX
  package's ``psum``, which on its CPU backend is the same ascending
  sum), and B4 (:func:`~..ops.score_cuda.score_plane`) scores each dm
  shard's rows;
* the dm shards' score blocks are concatenated in shard order (across
  processes by :func:`~.mesh.fetch_global`) and read back once.

Every shard's launches are queued on its device's current stream before
anything is read back.  The port's B1 stores its plane un-rotated, so
the JAX package's ``jnp.roll(dedisp, -roll_k)`` after the sum has no
counterpart: the planes agree as they are.  With ``chan=1`` there is no
channel sum at all and each row is the single-device sweep's row.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..obs import roofline
from ..ops.dedisperse import dedisperse_block_chunked
from ..ops.dedisperse_cuda import dedisperse_plane, device_plan
from ..ops.plan import dedispersion_plan, offsets_for
from ..ops.score_cuda import score_plane
from ..ops.search import auto_chan_block, unstack_scores
from ..utils.device import to_numpy
from ..utils.logging_utils import budget_bucket, budget_count
from ..utils.table import ResultTable
from .mesh import fetch_global, pad_to_multiple

__all__ = ["sharded_dedispersion_search", "chan_sum", "Placement",
           "MESH_KERNELS"]

#: per-shard kernels of the sharded sweep (the JAX package's names)
MESH_KERNELS = ("pallas", "gather")


def norm_device(dev):
    """``dev`` as a ``torch.device`` with its index (``cuda`` -> the
    current card), so that shard devices compare equal to tensors'."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(x, dev):
    """``x`` on ``dev``: itself where it is there already, else a copy
    queued behind the work that made it (an event on its device's
    current stream that ``dev``'s current stream waits for).  A copy to
    the host is synchronous, so the host never reads it early."""
    dev = norm_device(dev)
    if x.device == dev:
        return x
    if x.device.type == "cuda" and dev.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(x.device))
        torch.cuda.current_stream(dev).wait_event(event)
    return x.to(dev, non_blocking=dev.type == "cuda")


def mesh_source(data, mesh):
    """A search input as a float32 tensor on a mesh device: a packed
    low-bit chunk (:class:`~..io.lowbit.PackedFrames`) unpacked on the
    mesh's first device, a host array uploaded there once, a tensor
    already on a mesh device left where it is."""
    from ..io.lowbit import PackedFrames

    home = norm_device(mesh.home)
    if isinstance(data, PackedFrames):
        return data.to_device(home, torch.float32)
    if isinstance(data, torch.Tensor):
        data = data.to(dtype=torch.float32)
        if data.device not in {norm_device(d) for d in mesh.devices.flat}:
            data = data.to(home)
        return data.contiguous()
    # putpu-lint: disable=device-trip — not a tensor here: host data
    return torch.as_tensor(np.asarray(data, dtype=np.float32)).to(
        home).contiguous()


class Placement:
    """The shards' inputs on their devices: the ``(rows, ...)`` slice
    ``[lo, hi)`` of ``source`` is a view where a shard's device is the
    source's, else one copy per device and slice, made at first use."""

    def __init__(self, source):
        self.source = source
        self._copies = {}

    def slice(self, dev, lo, hi):
        dev = norm_device(dev)
        if dev == self.source.device:
            return self.source[lo:hi]
        key = (str(dev), int(lo), int(hi))
        if key not in self._copies:
            self._copies[key] = to_device(self.source[lo:hi], dev)
        return self._copies[key]


def chan_sum(partials, dev):
    """The channel shards' partial planes added on ``dev`` in ascending
    shard order, ``((p0 + p1) + p2) + ...`` — the JAX package's ``psum``
    on its CPU backend, bit for bit.  The first partial is the
    accumulator (every partial is a fresh plane).  ``partials`` may be a
    generator that makes each shard's plane as the sum reaches it; then
    at most two planes of a dm row are alive at a time."""
    acc = None
    for p in partials:
        p = to_device(p, dev)
        acc = p if acc is None else acc.add_(p)
        del p
    return acc


def shard_bounds(n, parts):
    """``[lo, hi)`` of each of ``parts`` equal shards of ``n`` rows, the
    last ones short or empty (the JAX package pads to ``parts * ceil(n /
    parts)`` and slices back)."""
    per = -(-n // parts) if n else 0
    return [(min(i * per, n), min((i + 1) * per, n)) for i in range(parts)]


def jax_rebase_bound(offsets, nsamples):
    """The JAX package's Pallas halo bound of ``offsets``: the largest
    offset after its 128-aligned signed rebase.  The port's B1 plans its
    own window per launch; this bound only validates ``pallas_max_off``
    as the JAX package does."""
    offsets = np.asarray(offsets, dtype=np.int64)
    half = nsamples // 2
    signed = (offsets + half) % nsamples - half
    k = 128 * int(np.floor(signed.min(initial=0) / 128))
    return int((signed - k).max(initial=0))


@functools.lru_cache(maxsize=16)
def offsets_table(dms_bytes, nchan, start_freq, bandwidth, sample_time,
                  nsamples):
    """The int32 offset table of a trial grid (``dms_bytes``, float64) at
    one geometry, made once and shared read-only: every chunk of a file
    sweeps the same table (the single-device sweep keeps its own the same
    way, ``ops/search.py:_direct_sweep``)."""
    offsets = offsets_for(np.frombuffer(dms_bytes, dtype=np.float64), nchan,
                          start_freq, bandwidth, sample_time, nsamples)
    offsets.flags.writeable = False
    return offsets


@functools.lru_cache(maxsize=64)
def _shard_plan(geometry, lo, hi, c_lo, c_hi, device):
    """:func:`~..ops.dedisperse_cuda.device_plan` of the (trial shard x
    channel shard) block ``[lo, hi) x [c_lo, c_hi)`` of
    :func:`offsets_table`'s table (columns past the band are the zero
    padding), kept per geometry and device."""
    table = offsets_table(*geometry)
    offs = np.zeros((hi - lo, c_hi - c_lo), dtype=np.int32)
    real = max(0, min(c_hi, table.shape[1]) - c_lo)
    offs[:, :real] = table[lo:hi, c_lo:c_lo + real]
    return device_plan(offs, geometry[-1], device)


def shard_partial(data, offs, kernel, chan_block=None, policy=None,
                  planned=None):
    """One shard's partial plane of its channel slice ``data`` at its
    host offsets ``offs`` ``(rows, channels)``: B1 under ``"pallas"``
    (its plain version on the CPU; ``planned``, the block's device plan,
    saves planning it again), else the gather formulation (the
    roll-accumulate on the CPU) under ``policy``."""
    if kernel == "pallas":
        return dedisperse_plane(data, offs, planned)
    form = "roll" if data.device.type == "cpu" else "gather"
    plane = dedisperse_block_chunked(
        # putpu-lint: disable=device-trip — host offsets
        data, torch.from_numpy(np.asarray(offs, dtype=np.int64)).to(
            data.device), chan_block if form == "gather" else None, form,
        policy)
    return plane if plane.is_floating_point() else plane.to(torch.float32)


def dm_chan_axes(mesh):
    """``(dm, chan)`` sizes of ``mesh``; ``ValueError`` without both axes."""
    if "dm" not in mesh.shape or "chan" not in mesh.shape:
        raise ValueError(f"mesh axes {tuple(mesh.shape)} must include "
                         "['chan', 'dm'] (build one with make_mesh((d, c), "
                         "('dm', 'chan')))")
    return mesh.shape["dm"], mesh.shape["chan"]


def sharded_dedispersion_search(data, dmmin, dmmax, start_freq, bandwidth,
                                sample_time, mesh, *, trial_dms=None,
                                capture_plane=False, chan_block=None,
                                dtype=None, kernel="auto",
                                plane_handle=False, offsets=None,
                                pallas_max_off=None, precision=None):
    """Run the full DM sweep sharded over ``mesh`` axes ``("dm", "chan")``.

    Same result contract as :func:`~..ops.search.dedispersion_search`
    (same plan, same host float64 offsets, same scorer) — only the
    execution layout differs.  ``data`` is a float32 ``(nchan, T)``
    array or tensor (a host input is uploaded to the mesh's first device
    once), or a :class:`~..io.lowbit.PackedFrames`, whose packed bytes
    go to that device and are unpacked there once, before the split.

    ``kernel``: ``"auto"`` (:func:`~..tuning.autotune.
    resolve_mesh_kernel`: the direct sweep on all-CUDA float32 meshes,
    measured against the gather there above the tuning floor, and the
    gather elsewhere), ``"pallas"`` (B1 per shard) or ``"gather"``.

    ``plane_handle`` (with ``capture_plane``) keeps the captured plane
    on the devices, dm-sharded, as a :class:`~.sharded_plane.
    ShardedPlane`; else the plane is read back as host numpy.

    ``offsets`` (with an explicit ``trial_dms``) supplies the int32
    offset rows of those trials (the sharded hybrid's rescore buckets
    slice one cached table).  ``pallas_max_off`` is the JAX package's
    static halo bound: it must cover the subset's rebased bound
    (``ValueError`` otherwise); the port's B1 sizes its window per
    launch.

    ``precision`` names a :mod:`..precision` policy of the per-shard
    channel sums (the sum over channel shards stays plain float32).
    ``"auto"`` is ``f32`` on a mesh, and only the gather takes a policy
    other than ``f32``.
    """
    from ..precision import engage, resolve_policy

    dm_size, chan_size = dm_chan_axes(mesh)
    if dtype is not None and dtype not in (torch.float32, "float32",
                                           np.float32):
        raise ValueError(f"dtype={dtype!r}: the sharded sweep takes float32 "
                         "input only")
    if capture_plane and mesh.process_count > 1:
        raise ValueError("plane capture needs a single-process mesh: only "
                         "the score blocks cross processes")
    home = norm_device(mesh.home)
    data = mesh_source(data, mesh)
    nchan, nsamples = data.shape

    with budget_bucket("search/plan"):
        if trial_dms is None:
            trial_dms = dedispersion_plan(nchan, dmmin, dmmax, start_freq,
                                          bandwidth, sample_time)
        trial_dms = np.asarray(trial_dms, dtype=np.float64)
        ndm = len(trial_dms)
        geometry = None
        if offsets is None:
            # the host plan math, kept per geometry: the counter shows a
            # rebuild (a cache miss) in the chunk budget
            geometry = (trial_dms.tobytes(), nchan, float(start_freq),
                        float(bandwidth), float(sample_time), nsamples)
            misses = offsets_table.cache_info().misses
            offsets = offsets_table(*geometry)
            if offsets_table.cache_info().misses > misses:
                budget_count("offset_tables")
        else:
            offsets = np.asarray(offsets, dtype=np.int32)
            if offsets.shape != (ndm, nchan):
                raise ValueError(f"offsets shape {offsets.shape} does not "
                                 f"match ({ndm}, {nchan})")
        # channels pad with zeros to a multiple of the chan axis, as in
        # the JAX package: a zero channel adds +0 to every sum
        offsets, _ = pad_to_multiple(offsets, 1, chan_size, mode="constant")
        if nchan % chan_size:
            data = torch.cat([data, torch.zeros(
                (offsets.shape[1] - nchan, nsamples), dtype=data.dtype,
                device=data.device)])
    nchan_pad = offsets.shape[1]

    if kernel == "auto":
        from ..tuning.autotune import resolve_mesh_kernel

        kernel = resolve_mesh_kernel(mesh, nchan, nsamples, ndm, start_freq,
                                     bandwidth, sample_time, trial_dms)
    if kernel not in MESH_KERNELS:
        raise ValueError(f"kernel={kernel!r}: the sharded sweep runs "
                         f"{MESH_KERNELS} or 'auto'")
    if kernel == "pallas" and pallas_max_off is not None:
        bound = jax_rebase_bound(pad_to_multiple(offsets, 0, dm_size)[0],
                                 nsamples)
        if pallas_max_off < bound:
            raise ValueError(f"pallas_max_off={pallas_max_off} does not "
                             f"cover the subset bound {bound}")

    eff_policy = resolve_policy(precision)
    if eff_policy == "auto":
        eff_policy = "f32"   # the policy tuner measures single devices
    if eff_policy != "f32" and kernel == "pallas":
        raise ValueError("precision policies other than 'f32' need the "
                         "gather mesh kernel (the per-shard direct sweep "
                         "accumulates plain f32)")
    policy = None if eff_policy == "f32" else engage(eff_policy)

    grid = mesh.grid()
    rows_of = shard_bounds(ndm, dm_size)
    chans_of = shard_bounds(nchan_pad, chan_size)
    placement = Placement(data)
    local = [(i, rows_of[mesh.dm_offset + i]) for i in range(grid.shape[0])]
    work = [(hi - lo, c_hi - c_lo) for _, (lo, hi) in local if hi > lo
            for c_lo, c_hi in chans_of]

    def partial(i, j, lo, hi):
        """Shard ``(i, j)``'s partial plane of trial rows ``[lo, hi)``."""
        c_lo, c_hi = chans_of[j]
        dev = norm_device(grid[i, j])
        block = chan_block
        if kernel == "gather" and block is None:
            block = auto_chan_block(c_hi - c_lo, nsamples, hi - lo)
        planned = None
        if kernel == "pallas" and geometry is not None \
                and dev.type == "cuda":
            planned = _shard_plan(geometry, lo, hi, c_lo, c_hi, dev)
        return shard_partial(placement.slice(dev, c_lo, c_hi),
                             offsets[lo:hi, c_lo:c_hi], kernel, block,
                             policy, planned)

    scores, planes = [], []
    with budget_bucket("search/dispatch"), roofline.measure(
            home, "sharded_sweep",
            lambda: _sweep_work(work, len(chans_of), nsamples)):
        for i, (lo, hi) in local:
            if hi <= lo:
                continue
            # each partial made as the ascending sum reaches it
            dedisp = chan_sum((partial(i, j, lo, hi)
                               for j in range(chan_size)), grid[i, 0])
            scores.append(score_plane(dedisp))
            if capture_plane:
                planes.append(dedisp)
            del dedisp
        budget_count("dispatches")

    plane = None
    if capture_plane:
        if plane_handle:
            from .sharded_plane import ShardedPlane

            plane = ShardedPlane(planes, mesh, "dm", np.arange(ndm))
        else:
            with budget_bucket("search/readback"):
                plane = (np.concatenate([to_numpy(p) for p in planes])
                         if planes else np.zeros((0, nsamples), np.float32))
                budget_count("readbacks")
    with budget_bucket("search/readback"):
        local_scores = (torch.cat([to_device(s, home) for s in scores], dim=1)
                        if scores else torch.zeros(
                            # putpu-lint: disable=float64-leak — an empty pack
                            (5, 0), dtype=torch.float64))
        stacked = fetch_global(local_scores, mesh)[:, :ndm]
        budget_count("readbacks")
    maxvalues, stds, snrs, windows, peaks = unstack_scores(stacked)
    table = ResultTable({
        "DM": trial_dms,
        "max": maxvalues,
        "std": stds,
        "snr": snrs,
        "rebin": windows,
        "peak": peaks,
    })
    if capture_plane:
        return table, plane
    return table


def _sweep_work(shards, chan_shards, nsamples):
    """The sharded sweep's ``(operations, bytes)``: each (trial shard x
    channel shard) B1 launch, and the B4 scoring of each dm shard's rows
    (one in every ``chan_shards`` entries of ``shards``)."""
    ops = nbytes = 0
    for k, (rows, chans) in enumerate(shards):
        parts = [roofline.sweep_work(rows, chans, nsamples)]
        if k % chan_shards == 0:
            parts.append(roofline.score_work(rows, nsamples, 5 * rows))
        for o, b in parts:
            ops, nbytes = ops + o, nbytes + b
    return ops, nbytes
