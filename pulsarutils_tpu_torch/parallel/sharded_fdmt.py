"""DM-sliced sharded FDMT and the mesh hybrid.

The port of the JAX package's module.  :mod:`.sharded` lays the exact
direct sweep over a ``(dm, chan)`` mesh; this module lays the FDMT (the
coarse transform behind ``kernel="fdmt"`` and the hybrid) over the
``dm`` axis:

* the trial-delay range ``[n_lo, n_hi]`` splits into one contiguous
  slice per dm shard (:func:`slice_delay_range`);
* each dm shard runs the port's own transform on its slice
  (:func:`~..ops.fdmt.fdmt_transform` with ``min_delay=lo,
  max_delay=hi``: the B3 head, B2a and B2b on the card) on the dm row's
  first device, and B4 scores its rows.  Rows outside the slice are
  never built.  Each slice's rows equal the single-device transform's
  rows, because the tracks and the summation order are the same;
* the slices' score blocks are concatenated in shard order (across
  processes by :func:`~.mesh.fetch_global`).

The JAX package pads each device's merge tables to common shapes and
ships them as sharded operands, because ``shard_map`` compiles one
program; a loop over shards needs none of that.  The input is read whole
by every dm shard (each trial needs the whole band): a view where the
shard's device is the input's.  There is no communication inside the
transform.

:func:`sharded_hybrid_search` is the mesh hybrid: the sharded FDMT as the
coarse stage, the hybrid's guarantee loop and certificate
(:mod:`..ops.certify`), and the exact rescore through
:func:`~.sharded.sharded_dedispersion_search` over the whole mesh.  Its
first round runs fused where it may (:func:`_fused_mesh_round`).
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from ..obs import roofline
from ..ops.fdmt import fdmt_plan, fdmt_transform, fdmt_trial_dms
from ..ops.plan import dedispersion_plan
from ..ops.score_cuda import score_plane
from ..utils.logging_utils import budget_bucket, budget_count
from ..utils.table import ResultTable
from .mesh import fetch_global, pad_to_multiple
from .sharded import (Placement, chan_sum, mesh_source, norm_device,
                      offsets_table, shard_bounds, to_device)

__all__ = ["sharded_fdmt_search", "sharded_hybrid_search",
           "slice_delay_range"]

logger = logging.getLogger("pulsarutils_tpu_torch")


def slice_delay_range(n_lo, n_hi, n_slices):
    """Split ``[n_lo, n_hi]`` (inclusive) into contiguous near-equal
    slices; returns a list of ``(lo, hi)`` pairs.  Requires at least one
    trial per slice."""
    total = n_hi - n_lo + 1
    if total < n_slices:
        raise ValueError(f"{total} trials cannot fill {n_slices} devices; "
                         "use a smaller mesh or a wider DM range")
    edges = [n_lo + (total * i) // n_slices for i in range(n_slices + 1)]
    return [(edges[i], edges[i + 1] - 1) for i in range(n_slices)]


def _coarse_shards(data, slices, mesh, axis, start_freq, bandwidth,
                   with_cert):
    """Each local dm shard's delay-sliced transform and its B4 scores, on
    the dm row's device: ``[(plane, stacked), ...]`` in shard order."""
    placement = Placement(data)
    devs = mesh.axis_devices(axis)
    first = mesh.dm_offset if axis == "dm" else 0
    out = []
    for i, dev in enumerate(devs):
        lo, hi = slices[first + i]
        src = placement.slice(dev, 0, data.shape[0])
        plane = fdmt_transform(src, hi, start_freq, bandwidth, min_delay=lo)
        out.append((plane, score_plane(plane, with_cert=with_cert)))
    return out


def sharded_fdmt_search(data, dmmin, dmmax, start_freq, bandwidth,
                        sample_time, mesh, axis="dm", use_pallas=None,
                        with_cert=False, capture_plane=False):
    """FDMT sweep with the trial-DM axis sharded over ``mesh[axis]``.

    Same scientific contract as ``dedispersion_search(kernel="fdmt")``
    (the integer band-delay trial grid), each dm shard transforming its
    delay slice.  ``data`` may be a :class:`~..io.lowbit.PackedFrames`
    (unpacked once on the mesh's first device).  ``use_pallas`` is the
    JAX package's switch between its Pallas and XLA merges; the port has
    one schedule (the CUDA kernels on the card, their plain versions on
    the CPU, bit for bit alike), so only ``use_pallas=False`` on a CUDA
    mesh means something, and it raises: a search on the card never
    runs the plain versions.

    Returns a :class:`~..utils.table.ResultTable` (``DM, max, std, snr,
    rebin, peak``, and ``cert`` with ``with_cert``) over the whole grid;
    with ``capture_plane`` ``(table, plane)``, ``plane`` a
    :class:`~.sharded_plane.ShardedPlane` of the slices on their devices.
    """
    from ..ops.search import unstack_scores

    if axis not in mesh.shape:
        raise ValueError(f"mesh axes {tuple(mesh.shape)} lack {axis!r}")
    if use_pallas is False and mesh.all_cuda:
        raise ValueError("use_pallas=False would run the plain FDMT on the "
                         "card; the card runs its kernels")
    if capture_plane and mesh.process_count > 1:
        raise ValueError("plane capture needs a single-process mesh: only "
                         "the score blocks cross processes")
    data = mesh_source(data, mesh)
    nchan = data.shape[0]
    n_dev = mesh.shape[axis]
    trial_dms, n_lo, n_hi = fdmt_trial_dms(nchan, dmmin, dmmax, start_freq,
                                           bandwidth, sample_time)
    slices = slice_delay_range(n_lo, n_hi, n_dev)
    home = norm_device(mesh.home)
    with budget_bucket("search/coarse"):
        shards = _coarse_shards(data, slices, mesh, axis, start_freq,
                                bandwidth, with_cert)
        budget_count("dispatches")
    with budget_bucket("search/coarse_readback"):
        stacked = fetch_global(torch.cat([to_device(s, home)
                                          for _, s in shards], dim=1), mesh)
        budget_count("readbacks")
    scores = unstack_scores(stacked)
    columns = dict(zip(("DM", "max", "std", "snr", "rebin", "peak"),
                       (trial_dms, *scores[:5])))
    if with_cert:
        columns["cert"] = scores[5]
    table = ResultTable(columns)
    if not capture_plane:
        return table
    from .sharded_plane import ShardedPlane

    plane = ShardedPlane([p for p, _ in shards], mesh, axis,
                         np.arange(len(trial_dms)))
    return table, plane


@functools.lru_cache(maxsize=8)
def _rescore_tables(geometry, nchan_rs, chan_bounds, devices):
    """The mesh rescore's offset tables on the devices, for rows the card
    picks: per channel shard, its columns of the plan's table
    (:func:`~.sharded.offsets_table`, zero columns past the band) as a
    :func:`~..ops.dedisperse_cuda.row_table` (B1's rows planned on the
    device) and as raw offsets (the gather formulation), on each device
    that shard runs on."""
    from ..ops.dedisperse_cuda import row_table

    table = offsets_table(*geometry)
    offs = np.zeros((table.shape[0], nchan_rs), dtype=np.int32)
    offs[:, :table.shape[1]] = table
    out = {}
    for j, (c_lo, c_hi) in enumerate(chan_bounds):
        for dev in devices[j]:
            key = (j, str(dev))
            if key not in out:
                cols = np.ascontiguousarray(offs[:, c_lo:c_hi])
                out[key] = (row_table(cols, geometry[-1], dev),
                            torch.from_numpy(cols.astype(np.int64)).to(dev))
    return out


def _fused_mesh_round(data, data_rs, mesh, slices, idx, start_freq,
                      bandwidth, geometry, cert_params, bucket, bucket2,
                      rescore_kernel, chan_block):
    """The mesh hybrid's first round, one chain of launches and ONE
    readback (the JAX package's one ``shard_map`` program):

    the dm-sliced coarse FDMT and its scores with the certificate row ->
    the dm shards' packs concatenated (the all-gather) and mapped onto
    the plan rows ``idx`` -> the guarantee loop's OWN seed rule on the
    device (plausible-best and floor rows, grown by their +-1 grid
    neighbours, clipped) -> its top ``bucket`` rows exactly rescored over
    the whole (dm, chan) mesh, with the unfused path's layout (each
    shard its row slice over its channel slice, the ascending channel
    sum, B4) -> the need stage (:func:`~..ops.search.fused_need_stage`)
    rescored the same way -> one packed float64 readback
    (:func:`~..ops.search.unpack_fused_hybrid`).  The masks are made in
    float32, as the JAX package makes them; every score is rounded to
    float32, as the unfused path's readback rounds it, so the two paths
    give the same table.  The need stage's launches run whatever its
    count; the host applies them only when it is positive."""
    from ..ops.dedisperse import dedisperse_block_chunked
    from ..ops.dedisperse_cuda import dedisperse_rows
    from ..ops.search import fused_masked_topk, fused_need_stage

    home = norm_device(mesh.home)
    grid = mesh.grid()
    dm_size, chan_size = mesh.shape["dm"], mesh.shape["chan"]
    nchan_rs = data_rs.shape[0]
    chans_of = shard_bounds(nchan_rs, chan_size)
    tables = _rescore_tables(
        geometry, nchan_rs, tuple(chans_of),
        tuple(tuple(dict.fromkeys(norm_device(d) for d in grid[:, j]))
              for j in range(chan_size)))
    placement = Placement(data_rs)
    ndm = len(idx)
    idx_t = torch.from_numpy(np.ascontiguousarray(idx)).to(home)
    cert_t = torch.from_numpy(cert_params).to(home)

    coarse = _coarse_shards(data, slices, mesh, "dm", start_freq, bandwidth,
                            True)
    stacked = torch.cat([to_device(s, home) for _, s in coarse], dim=1)
    if mesh.process_count > 1:
        stacked = torch.from_numpy(fetch_global(stacked, mesh)).to(home)
    coarse = stacked[:, idx_t].to(torch.float32)            # (6, ndm)
    snr_c = coarse[2]
    seed = snr_c >= snr_c.max() - 0.5
    seed |= snr_c >= cert_t[2] - 0.75
    grown = seed.clone()
    grown[1:] |= seed[:-1]
    grown[:-1] |= seed[1:]
    sel, n_seed = fused_masked_topk(snr_c, grown, bucket)

    def partial(i, j, sub):
        """Shard ``(i, j)``'s partial plane of the rows ``sub``."""
        c_lo, c_hi = chans_of[j]
        dev = norm_device(grid[i, j])
        table, raw = tables[(j, str(dev))]
        sub = to_device(sub, dev)
        src = placement.slice(dev, c_lo, c_hi)
        if rescore_kernel == "pallas":
            return dedisperse_rows(src, table, sub)
        form = "roll" if dev.type == "cpu" else "gather"
        return dedisperse_block_chunked(
            src, raw[sub], chan_block if form == "gather" else None, form)

    def rescore_rows(rows):
        rps = rows.shape[0] // dm_size
        blocks = []
        for i in range(grid.shape[0]):
            g = mesh.dm_offset + i
            sub = rows[g * rps:(g + 1) * rps]
            dedisp = chan_sum((partial(i, j, sub) for j in range(chan_size)),
                              grid[i, 0])
            blocks.append(to_device(score_plane(dedisp), home))
        scores = torch.cat(blocks, dim=1)
        if mesh.process_count > 1:
            scores = torch.from_numpy(fetch_global(scores, mesh)).to(home)
        return scores.to(torch.float32)                     # (5, rows)

    exact = rescore_rows(sel)
    parts = [coarse.reshape(-1), sel.to(torch.float32), exact.reshape(-1),
             n_seed.to(torch.float32)[None]]
    if bucket2:
        rescored = torch.zeros(ndm, dtype=torch.bool, device=home)
        rescored[sel] = True
        sel2, n_need = fused_need_stage(coarse, exact[2].max(), rescored,
                                        cert_t, bucket2)
        exact2 = rescore_rows(sel2)
        parts += [sel2.to(torch.float32), exact2.reshape(-1),
                  n_need.to(torch.float32)[None]]
    # putpu-lint: disable=float64-leak — the fused readback pack, exact rows
    return torch.cat([p.to(torch.float64) for p in parts]).cpu().numpy()


def _mesh_fused_default(mesh):
    """Whether a mesh hybrid takes the fused first round when the caller
    does not say: on a mesh of host devices, as the JAX package does; on
    a card mesh the two-stage composition, which on the H100 launches
    the same kernels and ran 4-7% faster (``chip_smoke.py``'s
    ``mesh_fdmt``: the fused round plans its rescore rows on the card,
    whose B1 window is the whole offset table's)."""
    return all(norm_device(d).type != "cuda" for d in mesh.devices.flat)


def sharded_hybrid_search(data, dmmin, dmmax, start_freq, bandwidth,
                          sample_time, mesh, snr_floor=None,
                          noise_certificate=True, capture_plane=False,
                          rho_cert=None, cert_slack=None, fused=None):
    """Hybrid (exact hits at coarse cost) over a ``(dm, chan)`` mesh.

    The mesh composition of ``dedispersion_search(kernel="hybrid")``:
    the coarse stage is the dm-sliced sharded FDMT (the ``chan`` axis is
    idle there), and the exact rescore of candidate rows runs through
    :func:`~.sharded.sharded_dedispersion_search` over the whole mesh.
    The guarantee loop, the certificate skip criterion and the noise
    certificate are the single-device hybrid's, so the contract is the
    same: the returned argbest row holds the exact sweep's scores
    (unless ``meta["certified"]``), and the ``exact`` column marks exact
    rows.  ``rho_cert``/``cert_slack`` as ``dedispersion_search``'s.

    ``capture_plane`` returns ``(table, plane)``, ``plane`` a
    :class:`~.sharded_plane.ShardedPlane` of the coarse plane remapped to
    the plan grid.

    ``fused``: ``None`` (default) runs the first round — coarse FDMT,
    the loop's own seed rule, the exact seed and need rescore — as one
    chain of launches with one readback (:func:`_fused_mesh_round`) on a
    mesh of host devices (a card mesh takes the two-stage composition,
    :func:`_mesh_fused_default`) where it is eligible: no plane capture,
    no certificate-mode floor, the certificate machinery on, a trial
    grid at least one seed bucket wide, and the OOM ladder's ``unfuse``
    rung not engaged.  ``fused=True`` runs it on any mesh.  The
    guarantee loop is the escape hatch: rows the fused round did not
    rescore go through the sharded sweep, and a seed or need stage that
    overflowed its bucket is discarded and redone on the host, so the
    rescored set is that of ``fused=False`` (up to float32-vs-float64
    ties on the mask criteria).  ``fused=False`` forces the two-stage
    composition; ``fused=True`` raises where the fused round is not
    eligible.
    """
    from ..faults import inject as fault_inject
    from ..ops.certify import cert_meta, fused_cert_params
    from ..ops.search import (HYBRID_NEED_BUCKET, HYBRID_SEED_BUCKET,
                              auto_chan_block, fused_scores_to_host,
                              hybrid_certificate_gate, iter_rescore_buckets,
                              nearest_rows, unpack_fused_hybrid)
    from ..resilience import ladder as _ladder
    from ..tuning.autotune import resolve_mesh_kernel
    from .sharded import dm_chan_axes, sharded_dedispersion_search

    dm_size, chan_size = dm_chan_axes(mesh)
    data = mesh_source(data, mesh)
    nchan, nsamples = data.shape
    # the plan grid and its offset table, made once a geometry and shared
    # by every rescore bucket and chunk
    # putpu-lint: disable=device-trip — a host plan
    trial_dms = np.asarray(dedispersion_plan(nchan, dmmin, dmmax, start_freq,
                                             bandwidth, sample_time),
                           dtype=np.float64)
    geometry = (trial_dms.tobytes(), nchan, float(start_freq),
                float(bandwidth), float(sample_time), int(nsamples))
    offsets_full = offsets_table(*geometry)
    ndm = len(trial_dms)

    # the per-shard rescore kernel, one resolution at the chunk geometry:
    # the fused round and the escape hatch rescore with the same kernel
    rescore_kernel = resolve_mesh_kernel(mesh, nchan, nsamples, ndm,
                                         start_freq, bandwidth, sample_time,
                                         trial_dms)
    offsets_raw, _ = pad_to_multiple(offsets_full, 1, chan_size,
                                     mode="constant")
    nchan_rs = offsets_raw.shape[1]
    data_rs = (torch.cat([data, torch.zeros((nchan_rs - nchan, nsamples),
                                            dtype=data.dtype,
                                            device=data.device)])
               if nchan_rs > nchan else data)

    def _round_up(x, m):
        return -(-x // m) * m

    bucket = _round_up(HYBRID_SEED_BUCKET, dm_size)
    bucket2 = _round_up(min(HYBRID_NEED_BUCKET, ndm), dm_size)
    fused_why = None
    if capture_plane:
        fused_why = "capture_plane needs the two-stage coarse program"
    elif snr_floor is not None and noise_certificate:
        fused_why = ("certificate mode: a certified chunk should pay one "
                     "coarse dispatch, not a burned seed rescore")
    elif rho_cert is False:
        fused_why = ("rho_cert=False drops the loop to legacy margins, "
                     "whose adaptive term the device cannot evaluate")
    elif ndm < max(bucket, bucket2):
        fused_why = f"trial grid ({ndm}) narrower than the seed bucket"
    # (the JAX package also keeps a TPU time axis that no tile divides off
    # the fused program; the port's transform never pads time)
    if fused is True and fused_why is not None:
        raise ValueError(f"fused=True not eligible: {fused_why}")
    use_fused = fused is not False and fused_why is None
    if fused is None and use_fused and (_ladder.unfuse_engaged()
                                        or not _mesh_fused_default(mesh)):
        use_fused = False   # the OOM ladder's "unfuse" rung, or a card mesh

    plane = None
    n_seed = n_need = 0
    seed_done = False
    if use_fused:
        fdmt_dms, n_lo, n_hi = fdmt_trial_dms(nchan, dmmin, dmmax,
                                              start_freq, bandwidth,
                                              sample_time)
        idx = nearest_rows(fdmt_dms, trial_dms)
        slices = slice_delay_range(n_lo, n_hi, dm_size)
        chan_block = auto_chan_block(nchan_rs // chan_size, nsamples,
                                     bucket // dm_size)
        cert_params = fused_cert_params(
            nchan, trial_dms, start_freq, bandwidth, sample_time, nsamples,
            snr_floor=snr_floor, rho_cert=rho_cert, cert_slack=cert_slack)
        try:
            # the "mesh" fault site also fires here, for direct callers
            fault_inject.fire("mesh", chunk=None)
            home = norm_device(mesh.home)
            with budget_bucket("search/fused"), roofline.measure(
                    home, "sharded_fused_hybrid",
                    lambda: _fused_work(nchan, nsamples, start_freq,
                                        bandwidth, slices, nchan_rs,
                                        (bucket, bucket2))):
                packed = _fused_mesh_round(
                    data, data_rs, mesh, slices, idx, start_freq, bandwidth,
                    geometry, cert_params, bucket, bucket2,
                    rescore_kernel, chan_block)
                budget_count("dispatches")
                budget_count("readbacks")
        except (ValueError, TypeError):
            raise
        except Exception as exc:
            if fused is True or not _ladder.is_resource_exhausted(exc):
                raise
            # the fused round's footprint ran out of memory: the two-stage
            # composition (the "unfuse" rung), whose rescored set is the
            # fused round's
            _ladder.oom_event("mesh_fused")
            _ladder.descend("unfuse")
            logger.warning("fused mesh hybrid ran out of memory (%r); "
                           "un-fusing to the two-stage composition", exc)
            use_fused = False
        else:
            (coarse, sel, seed_scores, n_seed, sel2, need_scores,
             n_need) = unpack_fused_hybrid(packed, ndm, bucket, bucket2)
            # what the device's masks flagged, and whether a stage
            # outgrew its bucket (the loop then redoes that stage)
            budget_count("fused_seed_rows", n_seed)
            budget_count("fused_need_rows", n_need)
            budget_count("fused_seed_overflow", int(n_seed > bucket))
            budget_count("fused_need_overflow", int(n_need > bucket2))
            maxvalues, stds, snrs = coarse[0], coarse[1], coarse[2]
            windows = np.rint(coarse[3]).astype(np.int32)
            peaks = np.rint(coarse[4]).astype(np.int64)
            cert_scores = coarse[5]
    if not use_fused:
        coarse_out = sharded_fdmt_search(data, dmmin, dmmax, start_freq,
                                         bandwidth, sample_time, mesh,
                                         axis="dm", with_cert=True,
                                         capture_plane=capture_plane)
        t_coarse, plane = (coarse_out if capture_plane
                           else (coarse_out, None))
        with budget_bucket("search/coarse_readback"):
            idx = nearest_rows(np.asarray(t_coarse["DM"]), trial_dms)
            if plane is not None:
                plane = plane.remap(idx)
            maxvalues = np.asarray(t_coarse["max"], np.float64)[idx]
            stds = np.asarray(t_coarse["std"], np.float64)[idx]
            snrs = np.asarray(t_coarse["snr"], np.float64)[idx]
            windows = np.asarray(t_coarse["rebin"], np.int32)[idx]
            peaks = np.asarray(t_coarse["peak"], np.int64)[idx]
            cert_scores = np.asarray(t_coarse["cert"], np.float64)[idx]
            budget_count("readbacks")

    coarse_snrs = snrs.copy()
    exact = np.zeros(ndm, dtype=bool)

    def _apply(blk, scored):
        m, s, b, w, p = scored
        k = len(blk)
        maxvalues[blk] = m[:k]
        stds[blk] = s[:k]
        snrs[blk] = b[:k]
        windows[blk] = w[:k]
        peaks[blk] = p[:k]
        exact[blk] = True

    def rescore(rows):
        """Escape hatch: exact scores through the sharded sweep, slices of
        the one cached offset table, the same per-shard kernel as the
        fused round."""
        budget_count("rescore_calls")
        budget_count("rescore_rows", len(rows))
        for blk, padded in iter_rescore_buckets(rows):
            # (the JAX package also pins its Pallas halo over the whole
            # table here, one compiled program for every bucket; B1 plans
            # its window per launch)
            t_ex = sharded_dedispersion_search(
                data_rs, dmmin, dmmax, start_freq, bandwidth, sample_time,
                mesh=mesh, trial_dms=trial_dms[padded],
                offsets=offsets_raw[padded], kernel=rescore_kernel)
            _apply(blk, (np.asarray(t_ex["max"]), np.asarray(t_ex["std"]),
                         np.asarray(t_ex["snr"]), np.asarray(t_ex["rebin"]),
                         np.asarray(t_ex["peak"])))

    if use_fused and n_seed <= bucket:
        # the device covered the loop's whole seed round, with the escape
        # hatch's scores; a need stage that fit its bucket completes round
        # one, an overflowed one is redone by the loop
        _apply(sel, fused_scores_to_host(seed_scores))
        seed_done = True
        if 0 < n_need <= bucket2:
            _apply(sel2, fused_scores_to_host(need_scores))

    certified, rho_cert_min = hybrid_certificate_gate(
        cert_scores, coarse_snrs, snrs, exact, rescore, nchan=nchan,
        trial_dms=trial_dms, start_freq=start_freq, bandwidth=bandwidth,
        sample_time=sample_time, nsamples=nsamples, snr_floor=snr_floor,
        noise_certificate=noise_certificate, seed_done=seed_done,
        rho_cert=rho_cert, cert_slack=cert_slack)
    table = ResultTable({
        "DM": trial_dms,
        "max": maxvalues,
        "std": stds,
        "snr": snrs,
        "rebin": windows,
        "peak": peaks,
        "exact": exact,
        "cert": cert_scores,
    }, meta=cert_meta(certified, rho_cert_min, snr_floor, cert_slack))
    return (table, plane) if capture_plane else table


def _fused_work(nchan, nsamples, start_freq, bandwidth, slices, nchan_rs,
                buckets):
    """The fused mesh round's ``(operations, bytes)``: each slice's
    transform and scoring, and the sweep and scoring of each bucket."""
    from ..ops.fdmt_cuda import transform_work

    ops = nbytes = 0
    rows = 0
    for lo, hi in slices:
        o, b = transform_work(fdmt_plan(nchan, float(start_freq),
                                        float(bandwidth), hi, lo), nsamples)
        ops, nbytes, rows = ops + o, nbytes + b, rows + hi - lo + 1
    o, b = roofline.fused_seed_work((0, 0), rows, nchan_rs, nsamples,
                                    buckets)
    return ops + o, nbytes + b
