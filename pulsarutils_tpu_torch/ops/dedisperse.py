"""The direct dedispersion sweep in plain PyTorch.

``out[d, t] = sum_c x[c, (t + off[d, c]) mod T]`` for a block of trials,
accumulated over channels in ascending order, in float32, from zeros —
the order of the Pallas kernel (``pulsarutils_tpu/ops/
pallas_dedisperse.py``) and of ``dedisperse_block_roll_jax``, so its plane
equals theirs bit for bit.  It is the reference the CUDA kernel
(:mod:`.dedisperse_cuda`) is held against, and the sweep of
``device="cpu"`` runs.  The circular wrap is the reference's ``np.roll``
convention: a dispersed track that runs past the chunk end continues at
its start.

Beside it, the JAX package's two portable formulations of the same sweep
(``dedisperse_block_roll_jax``, ``dedisperse_block_jax``,
``dedisperse_block_chunked_jax``), whose channel sums follow a
:mod:`..precision` policy: :func:`dedisperse_block_roll`,
:func:`dedisperse_block` and :func:`dedisperse_block_chunked`, plain
torch ops as they are XLA programs there.  Under ``f32`` the roll
formulation's plane equals :func:`dedisperse_plane_plain`'s.

And the reference's host API, in NumPy as the JAX package keeps it:
:func:`roll_and_sum` and :func:`dedisperse` (one trial); the card's
sweep is :func:`~.search.dedispersion_search`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..precision import cast_operand, neumaier_sum, split_sum, strategy
from .plan import normalize_shifts


def roll_and_sum(array, sum_array, n):
    """Add ``np.roll(array, n)`` into ``sum_array`` in place and return it
    (host NumPy; reference ``pulsarutils/dedispersion.py:60-83``, the
    in-place contract included):

    >>> array = np.arange(10)
    >>> sum_array = np.zeros(10)
    >>> bool(np.allclose(roll_and_sum(array, sum_array, 3), np.roll(array, 3)))
    True
    >>> sum_array is roll_and_sum(array, sum_array, 3)
    True
    """
    t = len(sum_array)
    n = int(n) % t
    # np.roll(array, n)[i] = array[(i - n) mod t]: two slice-adds, no
    # temporary
    sum_array[n:] += array[:t - n]
    sum_array[:n] += array[t - n:]
    return sum_array


def dedisperse(data, shifts):
    """Dedisperse one ``(nchan, nsamples)`` array at one DM's shifts (host
    NumPy): ``out[t] = sum_c data[c, (t + shifts[c]) mod T]``, the
    reference's negate-normalise-roll (``dedispersion.py:93-98``) as one
    gather and sum."""
    t = data.shape[1]
    sh = normalize_shifts(-np.asarray(shifts), t)
    idx = (np.arange(t)[None, :] - sh[:, None]) % t
    return np.take_along_axis(np.asarray(data), idx, axis=1).sum(axis=0)


def dedisperse_plane_plain(data, offsets):
    """Dedispersed plane ``(ndm, T)`` of ``data`` ``(nchan, T)`` at the
    gather offsets ``offsets`` ``(ndm, nchan)`` (any integers; wrapped
    mod ``T``)."""
    nchan, nsamples = data.shape
    if not isinstance(offsets, torch.Tensor):
        offsets = np.array(offsets, dtype=np.int64)  # a writable copy
    off = torch.as_tensor(offsets, device=data.device).to(torch.int64)
    off = off % nsamples
    out = torch.zeros(off.shape[0], nsamples, dtype=data.dtype,
                      device=data.device)
    for c in range(nchan):
        # row t of the doubled channel's length-T windows is the channel
        # rolled left by t, so one row gather reads every trial's shift
        windows = torch.cat([data[c], data[c]]).unfold(0, nsamples, 1)
        out += windows[off[:, c]]
    return out


# ---------------------------------------------------------------------------
# The gather and roll formulations, under a precision policy
# ---------------------------------------------------------------------------

def apply_dm_shifts_to_data(data, shifts, chan_block=64):
    """Roll each channel of ``data`` ``(nchan, T)`` by ``-rint(shift)``
    without summing: ``out[c, t] = data[c, (t + rint(shift[c])) % T]``, on
    ``data``'s device (the diagnostic figure's dedispersed waterfall; the
    JAX package's function of the same name).  The gather runs in blocks
    of ``chan_block`` channels, so its index stays small."""
    data = torch.as_tensor(data)
    t = data.shape[1]
    # putpu-lint: disable=device-trip — host shifts
    sh = torch.from_numpy(np.rint(np.asarray(shifts)).astype(np.int64))
    sh = sh.to(data.device)
    ramp = torch.arange(t, device=data.device)
    out = torch.empty_like(data)
    for c0 in range(0, data.shape[0], chan_block):
        idx = (ramp[None, :] + sh[c0:c0 + chan_block, None]) % t
        out[c0:c0 + chan_block] = torch.gather(data[c0:c0 + chan_block], 1,
                                               idx)
    return out


def _strategy(data, policy):
    """The :mod:`..precision` strategy of a float ``data`` under
    ``policy`` (None for plain float32): integer inputs ignore the
    policy, their integer sums being exact already."""
    return strategy(policy) if data.is_floating_point() else None


def _wrapped(offsets, data):
    if not isinstance(offsets, torch.Tensor):
        offsets = np.array(offsets, dtype=np.int64)  # a writable copy
    off = torch.as_tensor(offsets, device=data.device).to(torch.int64)
    return off % data.shape[1]


def _windows(rows):
    """``(..., T + 1, T)`` view of rows ``(..., T)``: window ``s`` is the
    row rolled left by ``s``."""
    nsamples = rows.shape[-1]
    return torch.cat([rows, rows], dim=-1).unfold(-1, nsamples, 1)


def dedisperse_block_roll(data, offsets, policy=None):
    """The roll-accumulate formulation: every trial's circular roll of
    channel 0 seeds the ``(ndm, T)`` carry, then each later channel's
    rolls are added in ascending channel order (the JAX package's
    ``dedisperse_block_roll_jax``).  ``offsets`` ``(ndm, nchan)`` are
    wrapped mod ``T``.

    Under ``f32_compensated`` and ``split_f32`` the carry is a TwoSum
    pair, its compensation seeded at zero, returning ``acc + comp``;
    under ``bf16_operand_f32_accum`` the rows are rounded to bfloat16
    before the roll and accumulated in float32.  Integer data sums in its
    own type."""
    off = _wrapped(offsets, data)
    strat = _strategy(data, policy)
    if strat is not None and strat.operand_dtype == "bfloat16":
        data = cast_operand(data, strat.name)

    def rolled(c):
        return _windows(data[c])[off[:, c]]

    acc = rolled(0)
    nchan = data.shape[0]
    if strat is not None and strat.operand_dtype == "bfloat16":
        acc = acc.to(torch.float32)
        for c in range(1, nchan):
            acc = acc + rolled(c).to(torch.float32)
        return acc
    if strat is not None and strat.accumulator in ("compensated", "split"):
        comp = torch.zeros_like(acc)
        for c in range(1, nchan):
            v = rolled(c)
            s = acc + v
            bp = s - acc
            comp = comp + ((acc - (s - bp)) + (v - bp))
            acc = s
        return acc + comp
    for c in range(1, nchan):
        acc = acc + rolled(c)
    return acc


def dedisperse_block(data, offsets, formulation, policy=None):
    """Dedisperse a block of trials: ``(ndm, T)`` from ``data`` ``(nchan,
    T)`` and gather offsets ``offsets`` ``(ndm, nchan)``.

    ``formulation``: ``"roll"`` (:func:`dedisperse_block_roll`) or
    ``"gather"`` (every trial's shifted channels gathered into ``(ndm,
    nchan, T)``, then summed over channels).

    The gather's channel sum under ``policy``: ``f32`` the plain sum
    (PyTorch's reduction order); ``bf16_operand_f32_accum`` a bfloat16
    gather summed in float32; ``f32_compensated``
    :func:`~..precision.neumaier_sum`; ``split_f32``
    :func:`~..precision.split_sum`.  Integer data sums in its own type
    and ignores the policy."""
    if formulation == "roll":
        return dedisperse_block_roll(data, offsets, policy=policy)
    if formulation != "gather":
        raise ValueError(f"unknown formulation {formulation!r}")
    off = _wrapped(offsets, data)
    strat = _strategy(data, policy)
    if strat is not None and strat.operand_dtype == "bfloat16":
        data = cast_operand(data, strat.name)  # before the gather
    chans = torch.arange(data.shape[0], device=data.device)
    gathered = _windows(data)[chans[None, :], off]  # (ndm, nchan, T)
    if not data.is_floating_point():
        return gathered.sum(dim=1, dtype=data.dtype)
    if strat is None:
        return gathered.sum(dim=1)
    if strat.operand_dtype == "bfloat16":
        return gathered.to(torch.float32).sum(dim=1)
    if strat.accumulator == "compensated":
        return neumaier_sum(gathered, dim=1)
    return split_sum(gathered, dim=1)


def dedisperse_block_chunked(data, offsets, chan_block, formulation,
                             policy=None):
    """:func:`dedisperse_block` over blocks of ``chan_block`` channels
    (``nchan`` a multiple of it), bounding the gather's workspace to
    ``ndm * chan_block * T``: the policy applies inside each block, the
    blocks' planes add in plain float32, seeded with block 0.  The roll
    formulation's workspace is ``O(ndm * T)`` already, so it is never
    chunked."""
    nchan = data.shape[0]
    if chan_block is None or chan_block >= nchan or formulation == "roll":
        return dedisperse_block(data, offsets, formulation, policy)
    if nchan % chan_block:
        raise ValueError(f"nchan {nchan} is not a multiple of chan_block "
                         f"{chan_block}")
    off = _wrapped(offsets, data)
    acc = dedisperse_block(data[:chan_block], off[:, :chan_block],
                           formulation, policy)
    for lo in range(chan_block, nchan, chan_block):
        acc = acc + dedisperse_block(data[lo:lo + chan_block],
                                     off[:, lo:lo + chan_block],
                                     formulation, policy)
    return acc
