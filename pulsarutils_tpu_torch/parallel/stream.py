"""Overlap-save chunking of a long series (reference ``clean.py:296-325``).

The chunk holds twice the band-crossing delay at ``dmmax`` and advances
by half a chunk, so every pulse lies whole in at least one chunk.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.plan import delta_delay, dm_broadening


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
