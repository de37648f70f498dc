"""Streaming search of a long series, and the time-sharded ring sweep.

* :func:`plan_chunks` and :func:`iter_chunk_starts`: the overlap-save
  chunking (reference ``clean.py:296-325``): a chunk holds twice the
  band-crossing delay at ``dmmax`` and advances by half a chunk, so every
  pulse lies whole in at least one chunk;
* :func:`stream_search`: the search of an iterable of chunks, pulled at
  most one chunk ahead (a file reader or a live producer), each chunk
  through :func:`~..ops.search.dedispersion_search` or the mesh searches,
  with the chunk loop's failure handling and observers;
* :func:`ring_dedisperse`: the sequence-parallel sweep, the time axis
  sharded over a ``("time",)`` mesh, each shard taking its right
  neighbour's block hop by hop, the global circular dedispersion of a
  series no single device holds.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from ..ops.plan import delta_delay, dm_broadening

logger = logging.getLogger("pulsarutils_tpu_torch")


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Physics-driven streaming geometry."""
    step: int            # samples per chunk
    hop: int             # chunk advance (step // 2 -> 50% overlap)
    resample: int        # time-rebin factor applied to each chunk
    sample_time: float   # post-resample sample time


def plan_chunks(nsamples, sample_time, dmmin, dmmax, start_freq, stop_freq,
                foff, chunk_length=None, new_sample_time=None, min_step=128):
    """Choose chunk size, hop and resampling from the search physics.

    * ``chunk_length`` defaults to the band-crossing delay at ``dmmax``;
      the chunk holds twice that;
    * data are resampled so the new sample time is ~1/10 of the minimum
      intra-channel DM smearing;
    * a chunk of at least 1024 resampled samples is rounded up to a
      multiple of 1024 of them (the JAX package's tile quantum, kept so
      both packages search the same chunk grid).
    """
    if chunk_length is None:
        chunk_length = delta_delay(dmmax, start_freq, stop_freq)
    step = max(int(chunk_length / sample_time) * 2, min_step)

    dm_dt = dm_broadening(dmmin, start_freq, abs(foff))
    if new_sample_time is None:
        new_sample_time = max(dm_dt / 10, sample_time)
    ratio = new_sample_time / sample_time
    resample = int(np.rint(ratio)) if ratio >= 2 else 1

    if step >= 1024 * resample:
        quantum = 1024 * resample
        step = -(-step // quantum) * quantum
    return ChunkPlan(step=step, hop=step // 2, resample=resample,
                     sample_time=resample * sample_time)


def iter_chunk_starts(nsamples, plan, tmin=0, sample_time=None):
    """Chunk start indices with 50% overlap, skipping a final fragment
    shorter than half a chunk and one wholly inside the previous chunk."""
    prev = None
    for istart in range(0, nsamples, plan.hop):
        if sample_time is not None and istart * sample_time < tmin:
            continue
        if min(plan.step, nsamples - istart) < plan.hop:
            continue
        if (prev is not None and istart - plan.hop == prev
                and prev + plan.step >= nsamples):
            continue
        prev = istart
        yield istart


def _iter_lookahead(chunks):
    """Pull-lazy iteration with exactly one chunk of lookahead.

    :func:`stream_search` consumes its producer as an iterator (a live
    feed cannot hold an observation in memory); pulling one item ahead
    lets the producer build chunk ``k + 1`` while chunk ``k`` is searched,
    with at most two produced-but-unconsumed chunks at any moment.  A
    list gives the same order and results."""
    it = iter(chunks)
    try:
        pending = next(it)
    except StopIteration:
        return
    for item in it:
        yield pending
        pending = item
    yield pending


def stream_search(chunks, dmmin, dmmax, start_freq, bandwidth, sample_time,
                  *, device="cuda", snr_threshold=6.0, trial_dms=None,
                  dm_block=None, chan_block=None, budget=None, mesh=None,
                  kernel="auto", dispatch_timeout=None, dispatch_retries=0,
                  skip_failed=False, health=None, http_port=None,
                  http_host="127.0.0.1", canary=None, plane_consumer=None,
                  lineage=None, push=None):
    """Search an iterable of ``(istart, chunk)`` pairs, each chunk a
    ``(nchan, step)`` block (an array, a tensor or a packed
    :class:`~..io.lowbit.PackedFrames`).

    The JAX package's ``stream_search`` with ``device=`` in place of
    ``backend=`` (the card unless the caller asks for the CPU).  ``chunks``
    is pulled lazily, at most one chunk ahead of the one being searched
    (:func:`_iter_lookahead`); a list also gives the progress total.
    Returns ``(results, hits)``: ``(istart, table)`` for every searched
    chunk, and ``(istart, table, best_row)`` for those whose best S/N
    clears ``snr_threshold``.

    Routing: with ``mesh``, ``kernel="hybrid"`` goes to
    :func:`~.sharded_fdmt.sharded_hybrid_search`, ``"fdmt"`` to
    :func:`~.sharded_fdmt.sharded_fdmt_search`, anything else to
    :func:`~.sharded.sharded_dedispersion_search` (a plane consumer gets
    its :class:`~.sharded_plane.ShardedPlane` handle); without one,
    :func:`~..ops.search.dedispersion_search` on ``device`` with
    ``kernel``.

    ``budget`` (a :class:`~..utils.logging_utils.BudgetAccountant`) opens
    one chunk budget a chunk: the search's buckets land per chunk, and a
    kernel build after the first chunk is flagged as a retrace.

    Failures: ``dispatch_timeout`` bounds each attempt on a watchdog
    thread, ``dispatch_retries`` re-attempts a failed chunk, and
    ``skip_failed=True`` drops a chunk that still fails (logged and
    counted in ``putpu_stream_chunks_failed_total``).  An out-of-memory
    error is not retried as a transient: the OOM ladder descends
    (``unfuse`` for the hybrid, else ``split_dm``) and the chunk runs
    again, smaller and with the same table.  ``ValueError``,
    ``TypeError`` and kernel build errors
    (:class:`~..utils.nvcc.KernelBuildError`) always propagate: they
    would fail every chunk alike.  Nothing falls back to another device.

    Observers, as in ``search_by_chunks``: ``http_port`` serves
    ``/metrics``, ``/healthz`` and ``/progress`` while the stream runs
    (``http_host`` the bind address); ``health`` a caller's
    :class:`~..obs.health.HealthEngine` (made when ``http_port`` is set);
    ``canary`` a :class:`~..obs.canary.CanaryController` or a rate: its
    pulses are injected before the search (into the packed codes of a
    packed chunk), matched in the tables and kept out of ``hits``, a
    genuine weaker pulse promoted in a canary's place; ``plane_consumer``
    ``fn(istart, plane, table)`` forces plane capture and receives each
    plane; ``lineage`` and ``push`` stamp and publish each hit (a stream
    has no store, so the hit is its "persisted" stage).  Each is off when
    None.
    """
    import contextlib
    import json as _json
    import time as _time

    import torch

    from ..faults import inject as fault_inject
    from ..faults.policy import call_with_deadline
    from ..io.lowbit import PackedFrames
    from ..obs import metrics as _metrics
    from ..obs.canary import CanaryController, inject_tensor, science_hit
    from ..obs.health import HealthEngine
    from ..obs.lineage import LineageRecorder
    from ..obs.push import AlertBroker
    from ..obs.server import start_obs_server
    from ..obs.trace import set_track, span
    from ..ops.search import dedispersion_search
    from ..resilience import ladder as _ladder
    from ..utils.device import resolve_device, to_numpy
    from ..utils.nvcc import KernelBuildError

    if mesh is None:
        # no card: raise before the first chunk
        target_type = resolve_device(device).type
    else:
        target_type = torch.device(mesh.devices.flat[0]).type
    # each stream session starts undegraded (a descent within it sticks)
    _ladder.reset()

    @contextlib.contextmanager
    def traced_chunk(istart):
        # without a budget, the chunk's spans go on its own track here
        with set_track(f"chunk {istart}"):
            with span("chunk", chunk=istart):
                yield

    if budget is not None:
        budget.begin_stream()

    # the plane-consumer seam forces capture; the keyword is passed only
    # when armed, so a stream without it dispatches as before
    capture_kw = {"capture_plane": True} if plane_consumer is not None \
        else {}

    def run_one(istart, chunk):
        fault_inject.fire("dispatch", chunk=istart, device=str(device))
        if mesh is not None:
            if kernel == "hybrid":
                from .sharded_fdmt import sharded_hybrid_search

                return sharded_hybrid_search(
                    chunk, dmmin, dmmax, start_freq, bandwidth,
                    sample_time, mesh=mesh, **capture_kw)
            if kernel == "fdmt":
                from .sharded_fdmt import sharded_fdmt_search

                return sharded_fdmt_search(
                    chunk, dmmin, dmmax, start_freq, bandwidth,
                    sample_time, mesh=mesh, **capture_kw)
            from .sharded import sharded_dedispersion_search

            return sharded_dedispersion_search(
                chunk, dmmin, dmmax, start_freq, bandwidth, sample_time,
                mesh=mesh, trial_dms=trial_dms, chan_block=chan_block,
                # a consumer gets the dm-sharded handle, never a plane
                # gathered onto one device
                **(dict(capture_kw, plane_handle=True) if capture_kw
                   else {}))
        return dedispersion_search(
            chunk, dmmin, dmmax, start_freq, bandwidth, sample_time,
            trial_dms=trial_dms, dm_block=dm_block, chan_block=chan_block,
            kernel=kernel, device=device, **capture_kw)

    def run_guarded(istart, chunk):
        last = None
        attempt = 0
        oom_descents = 0
        attempts = max(int(dispatch_retries), 0) + 1
        while attempt < attempts:
            try:
                return call_with_deadline(lambda: run_one(istart, chunk),
                                          dispatch_timeout)
            except (ValueError, TypeError, KernelBuildError):
                raise  # deterministic: every chunk would fail alike
            except Exception as exc:  # device errors share no base class
                last = exc
                if _ladder.is_resource_exhausted(exc) \
                        and oom_descents < 2 * len(_ladder.STEPS):
                    # not a transient fault: the ladder's next rung runs
                    # the chunk smaller, with the same table, without
                    # spending a retry
                    _ladder.oom_event("stream")
                    _ladder.descend("unfuse" if kernel == "hybrid"
                                    else "split_dm")
                    oom_descents += 1
                    logger.warning(
                        "stream chunk %s ran out of memory (%r); ladder "
                        "level %d, re-dispatching smaller", istart, exc,
                        _ladder.level())
                    continue
                attempt += 1
                if attempt < attempts:
                    _metrics.counter("putpu_dispatch_retries_total").inc()
                logger.warning("stream chunk %s search failed (%r); %s",
                               istart, exc,
                               "retrying" if attempt < attempts
                               else "giving up")
        raise last

    if canary is not None and not isinstance(canary, CanaryController):
        canary = CanaryController(rate=float(canary))
    if canary is not None and canary.rate <= 0.0:
        canary = None
    if http_port is not None and health is None:
        health = HealthEngine()
    if lineage is True:
        lineage = LineageRecorder(source="stream_search")
    elif not lineage:
        lineage = None          # False/0/"" mean off (a CLI flag)
    push_owned = False
    if not push:
        push = None
    elif not isinstance(push, AlertBroker):
        push = AlertBroker(push, health=health)
        push_owned = True

    results = []
    hits = []
    total = len(chunks) if hasattr(chunks, "__len__") else None
    t_run0 = _time.time()

    def _progress_snapshot():
        done = len(results)
        elapsed = _time.time() - t_run0
        rate = done / elapsed if elapsed > 0 and done else None
        doc = {"chunks_done": done, "chunks_total": total,
               "elapsed_s": round(elapsed, 1),
               "eta_s": (round((total - done) / rate, 1)
                         if rate and total is not None else None),
               "hits": len(hits)}
        if canary is not None:
            doc["canary"] = canary.summary()
        return doc

    obs_server = (start_obs_server(http_port, health=health,
                                   progress_fn=_progress_snapshot,
                                   host=http_host, push=push)
                  if http_port is not None else None)

    def _oom_events_total():
        return sum(m.get("value", 0)
                   for m in _metrics.REGISTRY.snapshot()
                   if m.get("name") == "putpu_oom_events_total")

    health_oom_base = [_oom_events_total()] if health is not None else None

    def _health_update(istart, wall_s, candidates=None, contained=False):
        if health is not None:
            oom_now = _oom_events_total()
            oom_delta = oom_now - health_oom_base[0]
            health_oom_base[0] = oom_now
            health.update(istart, wall_s=wall_s, candidates=candidates,
                          quarantined=contained, oom_events=oom_delta,
                          canary=canary.summary()
                          if canary is not None else None)

    def _emit_candidate(istart, chunk, best):
        """Lineage and push at a hit (canary rows never reach here); the
        emit point is the stream's "persisted" stage."""
        if lineage is None and push is None:
            return
        dm = float(best["DM"])
        snr = float(best["snr"])
        width = float(best["rebin"]) * float(sample_time)
        iend = istart + int(chunk.shape[1])
        cl = None
        if lineage is not None:
            cl = lineage.candidate(istart, iend, dm=dm, snr=snr,
                                   width=width)
            lineage.persisted(cl, writer=None)
        if push is not None:
            push.publish(
                {"schema_version": 1, "kind": "candidate",
                 "source": "stream_search", "chunk": int(istart),
                 "iend": int(iend), "dm": dm, "snr": snr,
                 "width_s": width},
                on_delivered=(None if cl is None else
                              lambda sub, _lat, _cl=cl:
                              lineage.delivered(_cl, sub)))

    try:
        for istart, chunk in _iter_lookahead(chunks):
            # with a budget the accountant opens the chunk's spans;
            # without one they are opened here
            ctx = (budget.chunk(istart) if budget is not None
                   else traced_chunk(istart))
            with ctx:
                t_chunk = _time.perf_counter()
                is_packed = isinstance(chunk, PackedFrames)
                if lineage is not None:
                    # a stream has no reader thread: receipt is "read"
                    lineage.mark(istart, "read")
                if canary is not None:
                    if not canary._bound:
                        canary.bind(nchan=chunk.shape[0],
                                    start_freq=start_freq,
                                    bandwidth=bandwidth, tsamp=sample_time,
                                    dmmin=dmmin, dmmax=dmmax)
                    if is_packed:
                        # quantised into the codes: recall is measured
                        # on packed streams too
                        chunk = PackedFrames(
                            canary.maybe_inject_packed(
                                chunk.frames, istart, nbits=chunk.nbits,
                                nchan=chunk.nchan,
                                band_descending=chunk.band_descending),
                            chunk.nbits, chunk.nchan,
                            band_descending=chunk.band_descending)
                    elif isinstance(chunk, torch.Tensor):
                        # the bump sized from a strided subsample read
                        # back, added where the chunk is (to a copy)
                        stride = max(1, int(chunk.shape[1]) // 65536)
                        bump = canary.injection(
                            istart, int(chunk.shape[1]),
                            to_numpy(chunk[:, ::stride].T))
                        if bump is not None:
                            chunk = inject_tensor(
                                chunk.to(torch.float32, copy=True), bump)
                    else:
                        chunk = canary.maybe_inject(chunk, istart)
                # the bytes this chunk's search uploads: the packed
                # bytes, or the float32 block; none for a tensor already
                # on a device of the search's kind
                if not (isinstance(chunk, torch.Tensor)
                        and chunk.device.type == target_type):
                    _metrics.counter("putpu_bytes_uploaded_total").inc(
                        int(chunk.nbytes) if is_packed
                        else 4 * int(np.prod(np.shape(chunk))))
                if is_packed:
                    _metrics.counter(
                        "putpu_lowbit_packed_chunks_total").inc()
                    _metrics.counter(
                        "putpu_lowbit_bytes_saved_total").inc(
                        chunk.float_nbytes - chunk.nbytes)
                if lineage is not None:
                    lineage.mark(istart, "dispatch")
                try:
                    with (budget.bucket("search") if budget is not None
                          else span("search")):
                        result = run_guarded(istart, chunk)
                    if plane_consumer is not None:
                        table, _plane = result
                        plane_consumer(istart, _plane, table)
                    else:
                        table = result
                except (ValueError, TypeError, KernelBuildError):
                    raise
                except Exception:
                    if not skip_failed:
                        raise
                    # containment: one broken chunk does not end a long
                    # stream; it is counted, logged and absent from the
                    # results
                    _metrics.counter(
                        "putpu_stream_chunks_failed_total").inc()
                    if canary is not None:
                        canary.discard(istart)
                    if lineage is not None:
                        lineage.discard(istart)
                    _health_update(istart,
                                   wall_s=_time.perf_counter() - t_chunk,
                                   contained=True)
                    continue
                if lineage is not None:
                    lineage.mark(istart, "ready")
                canary_obs = (canary.observe(istart, table, snr_threshold)
                              if canary is not None else None)
                results.append((istart, table))
                _metrics.counter("putpu_stream_chunks_total").inc()
                is_hit, sci_table, best, _ = science_hit(
                    canary, canary_obs, istart, table, snr_threshold,
                    f"stream chunk {istart}")
                if is_hit:
                    hits.append((istart, sci_table, best))
                    _metrics.counter("putpu_stream_hits_total").inc()
                    _emit_candidate(istart, chunk, best)
                if health is not None:
                    ncand = int(np.count_nonzero(
                        np.asarray(table["snr"], dtype=np.float64)
                        > float(snr_threshold)))
                    if canary_obs is not None:
                        # canary-lit rows are not a candidate storm
                        ncand = max(ncand - canary_obs["n_above_near"], 0)
                    _health_update(istart,
                                   wall_s=_time.perf_counter() - t_chunk,
                                   candidates=ncand)
                if lineage is not None:
                    # a hit's lineage froze at its verdict; dropping the
                    # chunk's marks bounds the recorder's memory
                    lineage.discard(istart)
    finally:
        if push is not None and push_owned:
            # a bounded drain: a stuck subscriber cannot hold the exit
            logger.info("PUSH_JSON %s", _json.dumps(push.close()))
        if obs_server is not None:
            obs_server.close()
    return results, hits


# ---------------------------------------------------------------------------
# The time-sharded ring sweep
# ---------------------------------------------------------------------------

def ring_offsets(trial_dms, nchan, start_freq, bandwidth, sample_time):
    """The ring's gather offsets: the integer shifts rebased to their
    global minimum, ``(offsets int64 (ndm, nchan), base, span)``, offsets
    in ``[0, span]``."""
    from ..ops.plan import dedispersion_shifts_batch

    trial_dms = np.asarray(trial_dms, dtype=np.float64)
    shifts = np.rint(dedispersion_shifts_batch(
        trial_dms, nchan, start_freq, bandwidth,
        sample_time)).astype(np.int64)
    base = int(shifts.min()) if shifts.size else 0
    offsets = shifts - base
    span = int(offsets.max()) if offsets.size else 0
    return offsets, base, span


def _ring_geometry(nchan, nsamples, n_time, trial_dms, start_freq, bandwidth,
                   sample_time):
    """``(offsets, t_loc, n_hops, rotation)`` with the JAX package's two
    checks: ``T`` divisible by the ``time`` axis, the span shorter than
    ``T``."""
    if nsamples % n_time:
        raise ValueError(f"T={nsamples} not divisible by time axis {n_time}")
    t_loc = nsamples // n_time
    offsets, base, span = ring_offsets(trial_dms, nchan, start_freq,
                                       bandwidth, sample_time)
    if span >= nsamples:
        raise ValueError(
            f"intra-band delay span {span} exceeds the sequence length "
            f"{nsamples}; enlarge the chunk (plan_chunks sizes it correctly)")
    n_hops = max(1, -(-(span + 1) // t_loc))
    # ring_result[d, t] = dedispersed[d, (t - base) mod T]: rolling by
    # (-base) mod T undoes the rebasing
    return offsets, t_loc, n_hops, (-base) % nsamples


def ring_dedisperse(data, trial_dms, start_freq, bandwidth, sample_time,
                    mesh):
    """Globally circular dedispersion of a time-sharded series.

    The sequence-parallel sweep: ``data`` ``(nchan, T)``, ``T`` divisible
    by the size of ``mesh``'s ``"time"`` axis, shard ``i`` holding samples
    ``[i T_loc, (i + 1) T_loc)`` on the axis's ``i``-th device (a view of
    ``data`` where that is its device, else a copy).  One controller walks
    the shards: at hop ``h`` shard ``i`` holds shard ``i + h``'s block and
    its right neighbour's (passed by a copy to shard ``i``'s device, a
    view where both are on one device) and adds, for each trial, the
    channels whose rebased delay falls in that window, channel by channel
    in ascending order.  The offsets are the shifts rebased to their
    global minimum (in ``[0, span]``), the hop count ``ceil((span + 1) /
    T_loc)``, and the rotation the rebasing leaves is undone at the end.
    Every output element is a sum of the same terms as the global sweep
    (:func:`ring_plain`, in the same order bit for bit), within float32
    rounding of it in another order.

    The workspace is bounded: a step gathers one channel's window for
    every trial at once, ``(ndm, T_loc)``, never the ``(ndm, nchan, 2
    T_loc)`` broadcast of the JAX package's program.  Which channels a
    hop adds, and for which trials, comes from the host's offset table:
    the loop never waits for the device.  Returns the ``(ndm, T)``
    float32 plane on the mesh's first device.
    """
    import torch

    from .sharded import norm_device, to_device

    devices = [norm_device(d) for d in mesh.axis_devices("time")]
    n_time = len(devices)
    if isinstance(data, torch.Tensor):
        src = data.to(torch.float32)
    else:
        src = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
    nchan, nsamples = src.shape
    offsets, t_loc, n_hops, rotation = _ring_geometry(
        nchan, nsamples, n_time, trial_dms, start_freq, bandwidth,
        sample_time)
    ndm = offsets.shape[0]
    shards = [to_device(src[:, i * t_loc:(i + 1) * t_loc], dev)
              for i, dev in enumerate(devices)]
    offs = {}
    outs = []
    for i, dev in enumerate(devices):
        if dev not in offs:
            offs[dev] = torch.from_numpy(offsets).to(dev)
        off = offs[dev]
        acc = torch.zeros((ndm, t_loc), dtype=torch.float32, device=dev)
        for h in range(n_hops):
            cur = to_device(shards[(i + h) % n_time], dev)
            nxt = to_device(shards[(i + h + 1) % n_time], dev)
            rel = off - h * t_loc
            valid = (rel >= 0) & (rel < t_loc)
            host_rel = offsets - h * t_loc
            host_valid = (host_rel >= 0) & (host_rel < t_loc)
            _ring_accumulate(acc, cur, nxt, rel.clamp(0, t_loc), valid,
                             host_valid)
        outs.append(acc)
    home = devices[0]
    plane = torch.cat([to_device(o, home) for o in outs], dim=1)
    return torch.roll(plane, rotation, dims=1)


def _ring_accumulate(acc, cur, nxt, rel, valid, host_valid):
    """One hop of a shard: ``acc[d] += ext[c, rel[d, c]:][:T_loc]`` over
    the channels ``c`` valid for trial ``d``, ascending, where ``ext`` is
    ``cur`` followed by ``nxt``.  ``host_valid`` is ``valid`` on the host:
    a channel valid for no trial is skipped, one valid for every trial is
    added unmasked (adding the masked zeros would leave the sums as they
    are: ``acc`` is never ``-0.0``)."""
    import torch

    t_loc = acc.shape[1]
    any_valid = host_valid.any(axis=0)
    all_valid = host_valid.all(axis=0)
    for c in np.flatnonzero(any_valid):
        ext = torch.cat([cur[c], nxt[c]])
        rows = ext.unfold(0, t_loc, 1)[rel[:, c]]
        if not all_valid[c]:
            rows = torch.where(valid[:, c, None], rows, 0.0)
        acc += rows


def ring_plain(data, trial_dms, start_freq, bandwidth, sample_time, n_time):
    """The ring sweep's arithmetic on the whole series on one device, no
    shards: for each hop, each channel in ascending order adds its rolled
    row to the trials whose delay falls in that hop's window.  Each output
    element is the same sum of the same terms in the same order as
    :func:`ring_dedisperse` on a ``time`` axis of ``n_time``: its plain
    reference, bit for bit."""
    import torch

    src = torch.as_tensor(data).to(torch.float32)
    nchan, nsamples = src.shape
    offsets, t_loc, n_hops, rotation = _ring_geometry(
        nchan, nsamples, n_time, trial_dms, start_freq, bandwidth,
        sample_time)
    off = torch.from_numpy(offsets).to(src.device)
    acc = torch.zeros((off.shape[0], nsamples), dtype=torch.float32,
                      device=src.device)
    hop = off // t_loc
    wrapped = off % nsamples
    for h in range(n_hops):
        for c in range(nchan):
            valid = hop[:, c] == h
            if not bool(valid.any()):
                continue
            rows = torch.cat([src[c], src[c]]).unfold(
                0, nsamples, 1)[wrapped[:, c]]
            acc += torch.where(valid[:, None], rows, 0.0)
    return torch.roll(acc, rotation, dims=1)
