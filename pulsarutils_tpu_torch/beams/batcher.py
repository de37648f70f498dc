"""Batched beam dispatch: N same-geometry chunks, one readback.

A receiver with many beams searches every beam at one geometry: one
trial grid, one offset table.  :class:`BeamBatcher` runs the per-beam
body once per beam, each beam's block copied into one device slot that
the next beam reuses, with every beam's scores left on the device, and
reads the stacked ``(B, 5, ndm)`` scores back once: one dispatch and
one readback per batch against ``2B`` for the beams searched one after
another (the JAX package runs the batch as one jitted ``lax.map`` over a
stacked operand; the port's loop holds one beam's operand at a time).

* The per-beam body is one function (:func:`beam_scores`): the device
  unpack of a packed beam, the optional conditioning, then the gather or
  roll sweep with every trial block scored by B4
  (:func:`~..ops.search.formulation_scores`).  A batch and a single
  beam run the same body on the same values, so each beam's table is
  bit for bit the sequential one.
* The formulation is measured by the tuner under a batch-keyed geometry
  (``...|b<N>``, :func:`~..tuning.autotune.resolve_batched_kernel`);
  only ``"roll"`` and ``"gather"`` ride in a batch, as in the JAX
  package, whose direct-sweep kernel cannot run inside its batch map.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops.plan import offsets_for
from ..ops.search import auto_chan_block, block_offsets, formulation_scores
from ..tuning.geometry import PLAN_CACHE_SIZE
from ..utils.device import on_device, resolve_device, to_numpy
from ..utils.logging_utils import budget_bucket, budget_count
from ..utils.nvcc import KernelBuildError
from ..utils.table import ResultTable

logger = logging.getLogger("pulsarutils_tpu_torch")

__all__ = ["BeamBatcher", "BeamGeometryError", "beam_scores",
           "batched_scores", "batched_probe_runners"]


class BeamGeometryError(ValueError):
    """Beams offered for one batch do not share a chunk geometry."""


def _as_tensor(block):
    """A beam's block as a tensor: itself, or a host tensor over the
    array (a writable C-ordered copy where it is neither)."""
    if isinstance(block, torch.Tensor):
        return block
    return torch.from_numpy(np.require(block, requirements=["C", "W"]))


def beam_scores(beam, offset_blocks, chan_block, formulation, packed=None,
                prep=None, policy=None):
    """The per-beam body shared by the batched and the single-beam search.

    ``beam`` is the ``(nchan, T)`` float block on the device, or with
    ``packed`` = ``(nbits, nchan, band_descending, accum dtype name)`` the
    raw ``(T, bytes_per_frame)`` uint8 frames, unpacked here
    (:func:`~..io.lowbit.device_unpack_block`) to that dtype (an integer
    accumulator when nothing downstream needs floats).  ``prep`` =
    ``(renormalize, resample)`` conditions the beam on the device.
    Returns the ``(5, nblocks * dm_block)`` float64 scores, on the
    device."""
    if packed is not None:
        from ..io.lowbit import device_unpack_block

        nbits, nchan, descending, acc = packed
        beam = device_unpack_block(beam, nbits, nchan, descending,
                                   getattr(torch, acc))
    if prep is not None:
        renorm, resample = prep
        if renorm:
            from ..ops.clean_ops import renormalize_data

            beam = renormalize_data(beam)
        if resample > 1:
            from ..ops.rebin import quick_resample

            beam = quick_resample(beam, resample)
    return formulation_scores(beam.contiguous(), offset_blocks, chan_block,
                              formulation, policy)


def batched_scores(data, offset_blocks, chan_block, formulation, packed=None,
                   prep=None, policy=None):
    """:func:`beam_scores` of every beam of the stacked operand ``data``
    (leading batch axis), stacked: ``(B, 5, nblocks * dm_block)`` on the
    device."""
    return torch.stack([beam_scores(beam, offset_blocks, chan_block,
                                    formulation, packed, prep, policy)
                        for beam in data])


def batched_probe_runners(candidates, nchan, nsamples, batch, sub_dms,
                          start_freq, bandwidth, sample_time, dm_block=None,
                          chan_block=None, device="cpu"):
    """Measurement runners for the tuner's batch-keyed geometry.

    One synthetic chunk per beam, drawn on ``device`` from a generator
    seeded per beam: :func:`~..tuning.autotune.synthetic_chunk`'s model
    (noise of standard deviation 0.5, a pulse of ``10 / sqrt(nchan)`` on
    the middle probe trial's exact track at ``T / 3``); ``{kernel:
    run}``, each ``run()`` the batched search of the stack, returning
    beam 0's host ``(max, std, snr, window, peak)``.  ``dm_block`` and
    ``chan_block`` are the blocking the batcher dispatches with, so the
    probe times the search the batcher runs."""
    sub_dms = np.asarray(sub_dms, dtype=np.float64)
    ndm = len(sub_dms)
    offsets = offsets_for(sub_dms, nchan, start_freq, bandwidth,
                          sample_time, nsamples)
    dev = torch.device(device)
    cols = torch.from_numpy((nsamples // 3 + offsets[ndm // 2].astype(
        np.int64)) % nsamples).to(dev)
    chans = torch.arange(nchan, device=dev)
    amp = float(np.float32(10.0 / np.sqrt(nchan)))
    synth = torch.empty((max(int(batch), 1), nchan, nsamples),
                        dtype=torch.float32, device=dev)
    for b, beam in enumerate(synth):
        gen = torch.Generator(device=dev)
        gen.manual_seed(1601 + b)
        torch.randn((nchan, nsamples), generator=gen, device=dev, out=beam)
        beam *= 0.5
        beam[chans, cols] += amp
    if dm_block is None:
        dm_block = 32
    blocks = torch.from_numpy(block_offsets(
        offsets, min(int(dm_block), ndm))).to(dev)

    def make(kern):
        def run():
            pack = to_numpy(batched_scores(synth, blocks, chan_block,
                                           kern)[0])[:, :ndm]
            return (pack[0].astype(np.float32), pack[1].astype(np.float32),
                    pack[2].astype(np.float32), pack[3].astype(np.int32),
                    pack[4].astype(np.int64))
        return run

    return {k: make(k) for k in candidates}


class BeamBatcher:
    """Align and dispatch same-geometry chunks from N beams.

    Bound to one chunk geometry at construction (``nchan`` channels,
    ``nsamples`` searched samples, the shared ``trial_dms`` grid) and to
    ``device`` (the card unless the caller asks for the CPU).
    :meth:`search` takes the beams' blocks of one chunk epoch and returns
    one :class:`~..utils.table.ResultTable` per beam.  ``batch_hint``
    sizes the tuner's batch-keyed measurement (the key carries it).

    ``kernel``: ``"roll"`` or ``"gather"``; None resolves through the
    tuner (:func:`~..tuning.autotune.resolve_batched_kernel`; static:
    the roll on the CPU, the gather on the card).  ``precision``: one
    :mod:`..precision` policy for every beam (``"auto"`` runs ``f32``:
    the policy tuner measures the single-beam search).

    ``packed`` = ``(nbits, band_descending)``: :meth:`search` takes each
    beam's raw ``(nsamps, bytes_per_frame)`` uint8 frames, uploads the
    packed bytes and unpacks each beam on the device; with no ``prep``
    the sweep sums the codes in the exact integer type of
    :func:`~..io.lowbit.accum_dtype`.  ``prep`` = ``(renormalize,
    resample)`` conditions each beam on the device (the multi-beam
    driver's packed modes set both).
    """

    def __init__(self, nchan, nsamples, trial_dms, start_freq, bandwidth,
                 sample_time, *, dm_block=None, chan_block=None,
                 kernel=None, batch_hint=1, packed=None, prep=None,
                 precision=None, device="cuda"):
        self.device = resolve_device(device)
        self.nchan = int(nchan)
        self.nsamples = int(nsamples)
        self.trial_dms = np.asarray(trial_dms, dtype=np.float64)
        self.start_freq = float(start_freq)
        self.bandwidth = float(bandwidth)
        self.sample_time = float(sample_time)
        self.ndm = len(self.trial_dms)
        if dm_block is None:
            dm_block = max(1, min(self.ndm, 32))
        self.dm_block = int(dm_block)
        if chan_block is None:
            # the single-beam sweep's rule: the same blocking, the same
            # float association
            chan_block = auto_chan_block(self.nchan, self.nsamples,
                                         self.dm_block)
        self.chan_block = chan_block
        if kernel is None:
            from ..tuning.autotune import resolve_batched_kernel

            kernel = resolve_batched_kernel(
                self.nchan, self.nsamples, self.ndm, max(int(batch_hint), 1),
                self.start_freq, self.bandwidth, self.sample_time,
                self.trial_dms, dm_block=self.dm_block,
                chan_block=self.chan_block, device=self.device)
        if kernel not in ("roll", "gather"):
            raise ValueError(
                f"BeamBatcher kernel={kernel!r}: only the gather and roll "
                "formulations ('roll'/'gather') run in a beam batch")
        self.kernel = kernel
        from ..precision import engage, resolve_policy

        eff_policy = resolve_policy(precision)
        if eff_policy == "auto":
            eff_policy = "f32"
        self.policy = None if eff_policy == "f32" else eff_policy
        if self.policy is not None:
            engage(self.policy)
        self.prep = ((bool(prep[0]), int(prep[1]))
                     if prep is not None else None)
        self.packed_meta = None
        if packed is not None:
            from ..io.lowbit import accum_dtype

            nbits, descending = packed
            # integer sums only when nothing downstream needs floats and
            # the exactness bound holds; conditioning unpacks to float32
            acc = (accum_dtype(nbits, self.nchan)
                   if self.prep is None else None) or "float32"
            self.packed_meta = (int(nbits), self.nchan, bool(descending),
                                acc)
        # device offset tables per series length: interior chunks share
        # one, a ragged last chunk gets its own (the sweep wraps mod T)
        self._offs_dev = {}

    def _offsets_dev(self, nsamples):
        dev = self._offs_dev.get(int(nsamples))
        if dev is None:
            offsets = offsets_for(self.trial_dms, self.nchan,
                                  self.start_freq, self.bandwidth,
                                  self.sample_time, int(nsamples))
            dev = torch.from_numpy(block_offsets(offsets, self.dm_block)).to(
                self.device)
            if len(self._offs_dev) >= PLAN_CACHE_SIZE:
                self._offs_dev.clear()  # bounded; geometries are few
            self._offs_dev[int(nsamples)] = dev
        return dev

    # -- dispatch ------------------------------------------------------------

    def _check(self, blocks):
        shapes = {tuple(np.shape(b)) for b in blocks}
        if len(shapes) != 1:
            raise BeamGeometryError(
                f"beam blocks of one batch must share a shape; got "
                f"{sorted(shapes)} — same-geometry chunks only")
        shape = next(iter(shapes))
        if self.packed_meta is not None:
            nbits = self.packed_meta[0]
            bpf = self.nchan * nbits // 8
            if len(shape) != 2 or shape[1] != bpf:
                raise BeamGeometryError(
                    f"packed beam blocks have shape {shape}; this batcher "
                    f"expects raw (nsamps, {bpf}) frames at {nbits} bits x "
                    f"{self.nchan} channels")
            return shape[0]
        if len(shape) != 2 or shape[0] != self.nchan:
            raise BeamGeometryError(
                f"beam blocks have shape {shape}; this batcher is bound to "
                f"{self.nchan} channels")
        return shape[1]

    def _searched_len(self, raw_len):
        """The series length after ``prep``'s resample (the offset
        table's key): it truncates as the host ``quick_resample``
        does."""
        if self.prep is not None and self.prep[1] > 1:
            return int(raw_len) // self.prep[1]
        return int(raw_len)

    def _tables(self, stacked):
        tables = []
        for pack in stacked:
            pack = pack[:, :self.ndm]
            maxvalues, stds, snrs = (pack[i].astype(np.float32).astype(
                np.float64) for i in range(3))
            tables.append(ResultTable({
                "DM": self.trial_dms, "max": maxvalues, "std": stds,
                "snr": snrs, "rebin": np.rint(pack[3]).astype(np.int32),
                "peak": np.rint(pack[4]).astype(np.int64)}))
        return tables

    def _operand(self, block, slot):
        """``(operand, slot)``: ``block`` on the device in the batcher's
        dtype, as itself where it is a tensor there already, else copied
        into ``slot`` (made on the first copy and reused by the next
        beam: the device holds one beam's operand, whatever the batch),
        with the upload counts of the bytes that cross: a packed batcher
        ships the raw bytes and counts what they save."""
        from ..obs import metrics as obs_metrics

        dtype = torch.uint8 if self.packed_meta is not None \
            else torch.float32
        if isinstance(block, torch.Tensor) and block.dtype == dtype \
                and on_device(block, self.device):
            return block, slot  # the body reads its operand, never writes it
        with budget_bucket("search/dispatch/upload"):
            src = _as_tensor(block)
            if slot is None:
                slot = torch.empty(tuple(src.shape), dtype=dtype,
                                   device=self.device)
            slot.copy_(src)
        if self.packed_meta is not None:
            obs_metrics.counter("putpu_lowbit_packed_chunks_total").inc()
            obs_metrics.counter("putpu_lowbit_bytes_saved_total").inc(
                self.nchan * int(src.shape[0]) * 4 - int(src.numel()))
        obs_metrics.counter("putpu_bytes_uploaded_total").inc(
            int(slot.numel() * slot.element_size()))
        return slot, slot

    def _scores(self, blocks, searched):
        """The batch's stacked ``(B, 5, ndm')`` scores, left on the
        device: each beam brought to the device (:meth:`_operand`, one
        reused slot) and run through :func:`beam_scores` in turn."""
        offs_dev = self._offsets_dev(searched)
        slot, scores = None, []
        for block in blocks:
            operand, slot = self._operand(block, slot)
            scores.append(beam_scores(operand, offs_dev, self.chan_block,
                                      self.kernel, self.packed_meta,
                                      self.prep, self.policy))
        return torch.stack(scores)

    def max_batch(self, nsamples=None):
        """The beam-batch width the memory budget admits for one dispatch
        on this batcher's device (None: budget unknown, no cap), the
        bound :meth:`search` splits against before it dispatches."""
        from ..resilience.memory_budget import max_beam_batch

        return max_beam_batch(
            self.nchan, int(nsamples or self.nsamples), self.ndm,
            dm_block=self.dm_block, chan_block=self.chan_block,
            formulation=self.kernel,
            packed_nbits=self.packed_meta[0] if self.packed_meta else 0,
            device=self.device)

    def search(self, blocks):
        """Search one chunk epoch of all beams in one dispatch.

        ``blocks``: B ``(nchan, nsamples)`` arrays or tensors (one per
        beam, any host/device mix), or B raw ``(nsamps,
        bytes_per_frame)`` frames on a ``packed`` batcher.  Returns B
        tables, each bit for bit the :meth:`search_single` table of its
        beam.  The budget counts one ``dispatches`` and one ``readbacks``
        for the batch.

        Out of memory: a batch whose estimate does not fit the measured
        headroom is split before the dispatch (a ``preflight`` split);
        a dispatch that still runs out of memory runs again as two
        half-batches (the ladder's ``halve_batch`` rung), each beam's
        table the unsplit batch's bit for bit.  A single beam that runs
        out of memory has no smaller batch: the error propagates.
        """
        from ..faults import inject as fault_inject
        from ..resilience import ladder as _ladder

        raw_len = self._check(blocks)
        searched = self._searched_len(raw_len)
        cap = self.max_batch(searched)
        if cap is not None and 1 <= cap < len(blocks):
            _ladder.count_split("preflight")
            return (self.search(blocks[:cap])
                    + self.search(blocks[cap:]))
        try:
            fault_inject.fire("beams", chunk=None, batch=len(blocks))
            with budget_bucket("search/dispatch"):
                out = self._scores(blocks, searched)
                budget_count("dispatches")
            with budget_bucket("search/readback"):
                stacked = to_numpy(out)
                budget_count("readbacks")
        except (ValueError, TypeError, KernelBuildError):
            raise  # deterministic: never an out-of-memory error
        except Exception as exc:  # device errors share no base class
            if len(blocks) <= 1 or not _ladder.is_resource_exhausted(exc):
                raise
            _ladder.oom_event("beam_batch")
            _ladder.descend("halve_batch")
            _ladder.count_split("ladder")
            half = (len(blocks) + 1) // 2
            logger.warning(
                "batched beam dispatch (%d beams) ran out of memory (%r); "
                "re-dispatching as two half-batches (%d + %d, each beam's "
                "table unchanged)", len(blocks), exc, half,
                len(blocks) - half)
            return (self.search(blocks[:half])
                    + self.search(blocks[half:]))
        return self._tables(stacked)

    def search_single(self, block):
        """One beam through the same per-beam body, one dispatch and one
        readback: the sequential arm and the bit-identity reference of
        :meth:`search`."""
        searched = self._searched_len(self._check([block]))
        with budget_bucket("search/dispatch"):
            out = self._scores([block], searched)
            budget_count("dispatches")
        with budget_bucket("search/readback"):
            stacked = to_numpy(out)
            budget_count("readbacks")
        return self._tables(stacked)[0]
