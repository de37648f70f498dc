"""Fast DM Transform (FDMT): tree dedispersion in O(nchan · T · log nchan).

The port of the JAX package's ``ops/fdmt.py``.  The host plan
(:class:`FdmtPlan`, :func:`compose_iterations`, :func:`fdmt_tracks`,
:func:`fdmt_trial_dms`, :func:`max_band_delay`) is a copy of the JAX
package's, float64 NumPy, and its tables are pinned equal to the
reference's by the tests.  Every integer the device sees comes from here.

Row ``N`` of the transform sums one sample per channel along the
dispersion track whose band-crossing delay is ``N`` samples, with the
per-channel delays rounded *recursively* by the tree (each merge rounds
the track's crossing of the sub-band boundary; Zackay & Ofek 2017,
ApJ 835:11).  Rows are anchored at the top of the band.

The passes, each a kernel of :mod:`.fdmt_cuda` (``csrc/fdmt_merge.cu``)
on a CUDA tensor and a plain PyTorch version here:

* the fused head, the first :data:`HEAD_LEVELS` levels in one pass
  (:class:`HeadPlan`, :func:`head_plain`) where the plan allows it;
* one tree level, ``out[r, t] = state[ih[r], (t + sh[r]) mod T]
  + state[il[r], (t + s[r]) mod T]`` (``sh`` is only set in the leaf
  level, whose parents are raw channel rows): :func:`merge_plain`;
* the last two deep levels fused, ``out[r] = (A + B) + (C + D)`` of four
  rolled parents (:func:`compose_iterations`): :func:`merge4_plain`.

:func:`transform_schedule` orders them, the same on both devices.  Every
form is bit-identical to the per-level transform: the same float32 adds
in the same association (``high + low`` per level; the roll distributes
exactly over the inner add of the fused pair).

Time is circular mod ``T`` at every ``T`` (the reference's ``np.roll``
convention).  The JAX package zero-pads ``T`` on the TPU when no
power-of-two tile divides it; the port never pads.  Channels above the
band up to the next power of two (``nchan_padded``) are zero: a parent
row at or beyond the data's row count reads as zeros, so no padded copy
of the data is made.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .plan import DM_DELAY_CONST, delta_delay

#: elements of the int64 gather index a plain merge builds at once: the
#: rows of a level are merged in chunks of ``PLAIN_CHUNK_ELEMENTS // T``
#: (a whole level's index at 1023 x 2^20 would take 8.6 GB)
PLAIN_CHUNK_ELEMENTS = 1 << 24


# ---------------------------------------------------------------------------
# Plan: per-iteration merge tables (host, numpy, static) — copied from the
# JAX package's ops/fdmt.py
# ---------------------------------------------------------------------------

def _lam(f):
    return f ** -2.0


class FdmtPlan:
    """Static merge schedule for one (nchan, geometry, delay-range) tuple.

    Attributes
    ----------
    iterations : list of dict with keys
        ``idx_low``, ``idx_high`` — (rows_out,) int32 flat parent-row
        indices into the previous state's row axis;
        ``shift`` — (rows_out,) int32 circular shift applied to the
        low-band parent row;
        ``shift_high`` — (rows_out,) int32 shift for the high parent
        (leaf merge only; ``None`` for deeper iterations);
        ``nbands``, ``ndelay`` — output layout (rows_out = sum(ndelay)).
    nchan_padded : channel count rounded up to a power of two (the extra
        channels are zero and contribute nothing).
    max_delay : largest differential band delay (inclusive) produced.
    min_delay : smallest band delay produced (DM-range pruning): the final
        state holds rows ``min_delay..max_delay`` only, and every earlier
        iteration allocates just the (contiguous) parent-delay window
        those rows reach through the recursion.
    """

    def __init__(self, nchan, start_freq, bandwidth, max_delay, min_delay=0):
        self.nchan = nchan
        self.max_delay = int(max_delay)
        self.min_delay = int(min_delay)
        if not 0 <= self.min_delay <= self.max_delay:
            raise ValueError(
                f"min_delay {min_delay} outside [0, {max_delay}]")
        nch2 = 1
        while nch2 < nchan:
            nch2 *= 2
        self.nchan_padded = nch2
        # zero-padded channels sit ABOVE the real band: they keep the
        # per-channel width of the real band and add no frequency span
        df = bandwidth / nchan
        f_edge = lambda c: start_freq + min(c, nchan) * df  # noqa: E731
        maxn = self.max_delay

        # Flat row layout with per-band delay counts, allocated top-down:
        # only the (band, delay) rows some final trial requests exist.
        # The initial state is the raw data, one row per channel; the
        # leaf merge samples each channel with per-parent shifts
        # (``shift_high`` at the high channel's lower edge, ``shift`` at
        # the low channel's); deeper merges shift only the low parent.

        # pass A (top-down): per-iteration band split fractions, then the
        # contiguous delay window each band is ever asked for
        widths = []
        w = 1
        while w < nch2:
            widths.append(w)
            w *= 2
        fracs = []  # fracs[i][b]: high-band share of band b's delay split
        for w in widths:
            nb = nch2 // (2 * w)
            fr = np.empty(nb)
            for b in range(nb):
                c0, c1, c2 = 2 * b * w, (2 * b + 1) * w, (2 * b + 2) * w
                w02 = _lam(f_edge(c0)) - _lam(f_edge(c2))
                w12 = _lam(f_edge(c1)) - _lam(f_edge(c2))
                fr[b] = w12 / w02 if w02 > 0 else 0.0
            fracs.append(fr)
        used = [None] * (len(widths) + 1)
        used_min = [None] * (len(widths) + 1)
        used[-1] = np.asarray([maxn])  # final band serves minn..maxn
        used_min[-1] = np.asarray([self.min_delay])
        for i in range(len(widths) - 1, 0, -1):
            u_out, u_out_min = used[i + 1], used_min[i + 1]
            nb = len(u_out)
            u_in = np.zeros(2 * nb, np.int64)
            u_in_min = np.zeros(2 * nb, np.int64)
            for b in range(nb):
                dd = np.arange(u_out_min[b], u_out[b] + 1)
                dh = np.round(dd * fracs[i][b]).astype(np.int64)
                dl = dd - dh
                u_in[2 * b], u_in_min[2 * b] = dl.max(), dl.min()
                u_in[2 * b + 1], u_in_min[2 * b + 1] = dh.max(), dh.min()
            used[i], used_min[i] = u_in, u_in_min

        # pass B (bottom-up): flat index tables over the allocated rows
        # (band-major, delay-minor, band b holding delays
        # used_min[b]..used[b] inclusive)
        self.iterations = []
        nd_in = [1] * nch2       # the raw channels
        min_in = [0] * nch2
        for i, w in enumerate(widths):
            u_out, u_out_min = used[i + 1], used_min[i + 1]
            nd_out = [int(u_out[b] - u_out_min[b]) + 1
                      for b in range(len(u_out))]
            in_off = np.concatenate([[0], np.cumsum(nd_in)])
            out_rows = int(np.sum(nd_out))
            idx_low = np.empty(out_rows, np.int32)
            idx_high = np.empty(out_rows, np.int32)
            shift = np.empty(out_rows, np.int32)
            shift_high = np.zeros(out_rows, np.int32) if i == 0 else None
            pos = 0
            for b in range(len(nd_out)):
                dd = np.arange(u_out_min[b], u_out[b] + 1)
                dh = np.round(dd * fracs[i][b]).astype(np.int64)
                dl = dd - dh
                if i == 0:
                    # leaf merge: parents are raw channel rows, sampled
                    # at the track's delay at their lower edges (relative
                    # to the pair's top edge): high -> dh, low -> dd
                    idx_low[pos:pos + len(dd)] = in_off[2 * b]
                    idx_high[pos:pos + len(dd)] = in_off[2 * b + 1]
                    shift[pos:pos + len(dd)] = dd
                    shift_high[pos:pos + len(dd)] = dh
                else:
                    assert dh.min() >= min_in[2 * b + 1], (i, b)
                    assert dh.max() - min_in[2 * b + 1] < nd_in[2 * b + 1], \
                        (i, b)
                    assert dl.min() >= min_in[2 * b], (i, b)
                    assert dl.max() - min_in[2 * b] < nd_in[2 * b], (i, b)
                    idx_low[pos:pos + len(dd)] = (in_off[2 * b]
                                                  + dl - min_in[2 * b])
                    idx_high[pos:pos + len(dd)] = (in_off[2 * b + 1]
                                                   + dh - min_in[2 * b + 1])
                    shift[pos:pos + len(dd)] = dh
                pos += len(dd)
            self.iterations.append({
                "idx_low": idx_low,
                "idx_high": idx_high,
                "shift": shift,
                "shift_high": shift_high,
                "nbands": len(nd_out),
                "ndelay": nd_out,
            })
            nd_in = nd_out
            min_in = [int(m) for m in u_out_min]


@functools.lru_cache(maxsize=32)
def fdmt_plan(nchan, start_freq, bandwidth, max_delay, min_delay=0):
    """Cached :class:`FdmtPlan` (all-static inputs)."""
    return FdmtPlan(nchan, start_freq, bandwidth, max_delay, min_delay)


def compose_iterations(it_a, it_b):
    """Fuse two consecutive deep merge iterations into one 4-parent pass.

    With ``state_b[q] = state[ih_a[q]] + roll(state[il_a[q]], s_a[q])``
    and ``out[r] = state_b[ih_b[r]] + roll(state_b[il_b[r]], s_b[r])``,
    substituting gives (roll composition is additive, circular):

    ``out[r] = state[ih_a[ih_b[r]]]
             + roll(state[il_a[ih_b[r]]], s_a[ih_b[r]])
             + roll(state[ih_a[il_b[r]]], s_b[r])
             + roll(state[il_a[il_b[r]]], s_b[r] + s_a[il_b[r]])``

    Leaf iterations (``shift_high`` set) cannot be composed this way.
    Returns ``(idx, shift)``: lists of four ``(rows_out,)`` int32 arrays
    (parent row indices / circular shifts; parent 0's shift is 0).
    """
    if it_a["shift_high"] is not None or it_b["shift_high"] is not None:
        raise ValueError("compose_iterations requires deep (post-leaf) "
                         "iterations")
    ih_b, il_b, s_b = it_b["idx_high"], it_b["idx_low"], it_b["shift"]
    ih_a, il_a, s_a = it_a["idx_high"], it_a["idx_low"], it_a["shift"]
    idx = [ih_a[ih_b], il_a[ih_b], ih_a[il_b], il_a[il_b]]
    shift = [np.zeros_like(s_b), s_a[ih_b], s_b, s_b + s_a[il_b]]
    return ([np.ascontiguousarray(i, np.int32) for i in idx],
            [np.ascontiguousarray(s, np.int32) for s in shift])


def fdmt_tracks(plan):
    """The effective dispersion track of every final transform row.

    Walks the plan's merge tables with an offset accumulator instead of
    data: row ``r`` of the transform computes exactly
    ``out[t] = sum_c data[c, (t + tracks[r, c]) mod T]``.

    Returns int64 ``(rows_final, nchan_padded)``; rows are the plan's
    ``min_delay..max_delay`` delay slice, columns ``>= plan.nchan`` belong
    to zero-padded channels.
    """
    nchp = plan.nchan_padded
    tracks = np.zeros((nchp, nchp), np.int64)
    valid = np.eye(nchp, dtype=bool)
    for it in plan.iterations:
        tl = tracks[it["idx_low"]] + it["shift"][:, None]
        th = tracks[it["idx_high"]]
        if it["shift_high"] is not None:
            th = th + it["shift_high"][:, None]
        vl, vh = valid[it["idx_low"]], valid[it["idx_high"]]
        # low/high parents cover disjoint channel halves of the output band
        tracks = np.where(vl, tl, th) * (vl | vh)
        valid = vl | vh
    assert valid.all(), "final band must cover every channel"
    return tracks


def max_band_delay(nchan, dmmax, start_freq, bandwidth, sample_time):
    """Largest integer band-crossing delay for ``dmmax`` (plan row count)."""
    return int(np.ceil(
        delta_delay(float(dmmax), start_freq, start_freq + bandwidth)
        / sample_time))


def fdmt_trial_dms(nchan, dmmin, dmmax, start_freq, bandwidth, sample_time):
    """The FDMT's integer band-delay trial grid on ``[dmmin, dmmax]``.

    Same one-sample spacing as the reference plan, but snapped to integer
    band delays, so DM values (and occasionally the trial count) differ
    from the plan by up to one trial.  Returns ``(trial_dms, n_lo, n_hi)``
    where rows ``n_lo..n_hi`` of the transform correspond to the DMs.
    """
    f0 = float(start_freq)
    f1 = f0 + float(bandwidth)
    n_lo = int(np.ceil(delta_delay(float(dmmin), f0, f1) / sample_time))
    n_hi = int(np.floor(delta_delay(float(dmmax), f0, f1) / sample_time))
    if n_hi < n_lo:
        # narrower than one band-delay sample and straddling no integer:
        # the single nearest trial, never an empty grid
        n_hi = n_lo
    trial_n = np.arange(n_lo, n_hi + 1)
    trial_dm = (trial_n * sample_time / DM_DELAY_CONST
                / (f0 ** -2.0 - f1 ** -2.0))
    return trial_dm, n_lo, n_hi


# ---------------------------------------------------------------------------
# The merges in plain PyTorch
# ---------------------------------------------------------------------------

def _rolled_rows(state, rows, shifts):
    """``state[rows[r], (t + shifts[r]) mod T]`` as ``(len(rows), T)``;
    rows at or beyond ``state.shape[0]`` (the zero channels above the
    band) read as zeros."""
    nrows, t = state.shape
    rows = torch.as_tensor(rows, device=state.device).to(torch.int64)
    sh = torch.as_tensor(shifts, device=state.device).to(torch.int64) % t
    valid = rows < nrows
    picked = state[rows.clamp(max=nrows - 1)]
    if not bool(valid.all()):
        picked[~valid] = 0.0
    if not bool(sh.any()):
        return picked
    gather = (torch.arange(t, device=state.device)[None, :]
              + sh[:, None]) % t
    return torch.gather(picked, 1, gather)


def _row_chunks(rows_out, t):
    step = max(1, PLAIN_CHUNK_ELEMENTS // max(t, 1))
    return [(lo, min(lo + step, rows_out)) for lo in range(0, rows_out, step)]


def merge_plain(state, idx_low, idx_high, shift, shift_high=None):
    """One FDMT level: ``out[r] = roll(state[ih[r]], sh[r])
    + roll(state[il[r]], s[r])`` (rolls left, circular; ``sh`` is 0 when
    ``shift_high`` is None).  Row chunks bound the gather index."""
    rows_out = len(idx_low)
    t = state.shape[1]
    out = torch.empty((rows_out, t), dtype=state.dtype, device=state.device)
    zeros = np.zeros(rows_out, np.int32)
    # putpu-lint: disable=device-trip — a host plan table
    sh = zeros if shift_high is None else np.asarray(shift_high)
    for lo, hi in _row_chunks(rows_out, t):
        high = _rolled_rows(state, idx_high[lo:hi], sh[lo:hi])
        low = _rolled_rows(state, idx_low[lo:hi], shift[lo:hi])
        out[lo:hi] = high + low
    return out


def merge4_plain(state, idx, shift):
    """The last two deep levels in one pass: ``out[r] = (A + B) + (C + D)``
    with ``A..D = roll(state[idx[p][r]], shift[p][r])``
    (:func:`compose_iterations`), the association of the two per-level
    merges it replaces."""
    rows_out = len(idx[0])
    t = state.shape[1]
    out = torch.empty((rows_out, t), dtype=state.dtype, device=state.device)
    for lo, hi in _row_chunks(rows_out, t):
        a, b, c, d = (_rolled_rows(state, i[lo:hi], s[lo:hi])
                      for i, s in zip(idx, shift))
        out[lo:hi] = (a + b) + (c + d)
    return out


def head_plain(state, head):
    """The fused head's levels (:class:`HeadPlan`) as plain merges, one
    level after another: the function the head kernel computes."""
    for it in head.iterations:
        state = merge_plain(state, it["idx_low"], it["idx_high"],
                            it["shift"], it["shift_high"])
    return state


# ---------------------------------------------------------------------------
# The fused head: the first HEAD_LEVELS levels in one pass
# ---------------------------------------------------------------------------

#: levels fused into the head; each group of 2^HEAD_LEVELS channels is an
#: independent sub-tree (the JAX package's ``fdmt_resident.HEAD_LEVELS``)
HEAD_LEVELS = 7
HEAD_GROUP = 1 << HEAD_LEVELS

#: blocks of one cluster, which share a group's rows (``kCluster`` in
#: csrc/fdmt_merge.cu)
HEAD_CLUSTER = 8

#: input channels one block stages: one band of the group
HEAD_BAND = HEAD_GROUP // HEAD_CLUSTER

#: shared memory a head block takes: two blocks fit on one SM (227 KB)
HEAD_SMEM_BYTES = 113 * 1024


def _ceil_div(a, b):
    return -(-a // b)


def _row_owners(ndelay, p_owner, ih, il):
    """The block of a group's cluster that owns each output row of one
    level, and the row's index among that block's rows, for a group whose
    sub-bands hold ``ndelay`` rows each (rows in the level's order), whose
    rows' parents ``ih``, ``il`` the level before's blocks ``p_owner``
    hold.

    Where the level's sub-bands are no wider than a band (``HEAD_BAND``
    channels), block ``b`` owns every row of the sub-bands inside band
    ``b``, whose parents it holds itself.  A row of a wider sub-band goes
    to the owner of one of its two parents, so it reads at most one
    parent from another block: to the one that owns fewer rows so far
    (the low parent's owner on a tie)."""
    nsub = len(ndelay)
    owner, local = [], []
    if nsub >= HEAD_CLUSTER:
        per = nsub // HEAD_CLUSTER
        for b in range(HEAD_CLUSTER):
            n = int(sum(ndelay[b * per:(b + 1) * per]))
            owner += [b] * n
            local += range(n)
    else:
        counts = [0] * HEAD_CLUSTER
        for high, low in zip(p_owner[ih], p_owner[il]):
            b = int(high if counts[high] < counts[low] else low)
            owner.append(b)
            local.append(counts[b])
            counts[b] += 1
    return np.asarray(owner, np.int64), np.asarray(local, np.int64)


class HeadPlan:
    """The head's schedule for one :class:`FdmtPlan`: group-local merge
    tables for levels ``0 .. HEAD_LEVELS-1`` and the tile geometry of the
    CUDA kernel.

    Attributes
    ----------
    iterations : the plan's first ``HEAD_LEVELS`` iterations.
    tables : per level, per group, ``(ih, il, sh, sl)`` int32 arrays of the
        group's output rows: parent rows counted from the group's first
        input row, and the high and low parents' shifts (``sh`` is 0 past
        the leaf level).
    counts : ``(HEAD_LEVELS, n_groups)`` output rows of each group.
    row_starts : each group's first row in the head's output (group ``g``
        is band ``g`` of the last head level).
    max_shift : the largest shift of each level; ``halo`` their sum.
    owners : per level, per group, ``(owner, local)``: the cluster block
        that computes each output row and the row's index among that
        block's rows (:func:`_row_owners`).
    refs : per level, per group, ``(ph, pl)``: each row's high and low
        parent as ``owner << 16 | local`` of the level before (level 0:
        the input channels, channel ``c`` of the group staged by block
        ``c // HEAD_BAND`` at row ``c % HEAD_BAND``).
    block_counts : ``(HEAD_LEVELS, n_groups, HEAD_CLUSTER)`` rows each
        block computes.
    remote : per level, whether a row reads a parent another block holds.
    rows : rows a block of the cluster holds at each level.
    buf_rows : rows of the block's two shared-memory buffers.
    meta_ints : int32 words of shared memory before the buffers (the
        block's tables, counts and output rows, rounded up to 4).
    max_tile : the widest output tile the shared-memory budget holds.
    """

    def __init__(self, plan):
        nchp = plan.nchan_padded
        if nchp < HEAD_GROUP or len(plan.iterations) < HEAD_LEVELS:
            raise ValueError(f"the head needs nchan_padded >= {HEAD_GROUP} "
                             f"and >= {HEAD_LEVELS} levels")
        self.n_groups = nchp // HEAD_GROUP
        self.iterations = plan.iterations[:HEAD_LEVELS]
        self.tables = []
        counts = []
        in_offsets = np.arange(nchp + 1)
        for it in self.iterations:
            out_offsets = np.concatenate([[0], np.cumsum(it["ndelay"])])
            bpg_in = (len(in_offsets) - 1) // self.n_groups
            bpg_out = len(it["ndelay"]) // self.n_groups
            sh = it["shift_high"]
            per_group, level_counts = [], []
            for g in range(self.n_groups):
                r0 = out_offsets[g * bpg_out]
                r1 = out_offsets[(g + 1) * bpg_out]
                base = in_offsets[g * bpg_in]
                ih = it["idx_high"][r0:r1] - base
                il = it["idx_low"][r0:r1] - base
                # bands merge strictly within a group
                assert min(ih.min(), il.min()) >= 0
                assert max(ih.max(), il.max()) < (
                    in_offsets[(g + 1) * bpg_in] - base)
                shh = (np.zeros(r1 - r0, np.int32) if sh is None
                       else sh[r0:r1])
                per_group.append(tuple(
                    np.ascontiguousarray(a, np.int32)
                    for a in (ih, il, shh, it["shift"][r0:r1])))
                level_counts.append(int(r1 - r0))
            self.tables.append(per_group)
            counts.append(level_counts)
            in_offsets = out_offsets[::bpg_out]
        self.counts = np.asarray(counts, np.int64)
        self.row_starts = np.concatenate([[0], np.cumsum(self.counts[-1])])[:-1]
        self.rows_out = int(self.counts[-1].sum())
        self.max_shift = [int(max(max(t[2].max(), t[3].max()) for t in lev))
                          for lev in self.tables]
        self.halo = int(sum(self.max_shift))
        channel = np.arange(HEAD_GROUP)
        prev = [(channel // HEAD_BAND, channel % HEAD_BAND)] * self.n_groups
        self.owners, self.refs, self.remote = [], [], []
        counts = np.zeros((HEAD_LEVELS, self.n_groups, HEAD_CLUSTER),
                          np.int64)
        for lev, it in enumerate(self.iterations):
            ndelay = np.asarray(it["ndelay"])
            bpg = len(ndelay) // self.n_groups
            owners, refs, remote = [], [], False
            for g in range(self.n_groups):
                ih, il = (self.tables[lev][g][k].astype(np.int64)
                          for k in (0, 1))
                p_owner, p_local = prev[g]
                owner, local = _row_owners(ndelay[g * bpg:(g + 1) * bpg],
                                           p_owner, ih, il)
                refs.append(tuple((p_owner[i] << 16 | p_local[i])
                                  .astype(np.int32) for i in (ih, il)))
                remote |= bool((p_owner[ih] != owner).any()
                               or (p_owner[il] != owner).any())
                counts[lev, g] = np.bincount(owner, minlength=HEAD_CLUSTER)
                owners.append((owner, local))
            self.owners.append(owners)
            self.refs.append(refs)
            self.remote.append(remote)
            prev = owners
        self.block_counts = counts
        # level l's rows (l < last) go to buffer (l + 1) % 2; buffer 0
        # first holds the input, HEAD_BAND rows a block
        self.rows = [int(c.max()) for c in counts]
        self.buf_rows = (
            max([HEAD_BAND] + self.rows[1:HEAD_LEVELS - 1:2]),
            max(self.rows[0:HEAD_LEVELS - 1:2]))
        self.meta_ints = _ceil_div(4 * sum(self.rows) + HEAD_LEVELS
                                   + self.rows[-1], 4) * 4
        stride = ((HEAD_SMEM_BYTES - 4 * self.meta_ints)
                  // (4 * sum(self.buf_rows))) // 4 * 4
        self.max_tile = (stride - self.halo) // 32 * 32

    @property
    def eligible(self):
        """Whether the head runs: the halo the tiles recompute is at most
        the tile."""
        return self.max_tile >= max(self.halo, 32)

    def tile(self, nsamples):
        """Output samples per tile at ``nsamples``: the widest the budget
        holds, but no wider than ``T`` rounded up to 32."""
        return min(self.max_tile, _ceil_div(nsamples, 32) * 32)

    def stride(self, tile):
        """Floats a row of a block's buffers holds at an output tile of
        ``tile``: the tile and its halo, up to a multiple of 4 (16-byte
        copies); the kernel stages all of them."""
        return _ceil_div(tile + self.halo, 4) * 4

    def widths(self, tile):
        """Columns each level computes for an output tile of ``tile``."""
        return [tile + sum(self.max_shift[lev + 1:])
                for lev in range(HEAD_LEVELS)]

    @property
    def barriers(self):
        """Bit ``l`` set: level ``l`` needs a cluster barrier before it (it
        or the level before it reads another block's rows), else the
        block's own barrier does."""
        return sum(1 << lev for lev in range(1, HEAD_LEVELS)
                   if self.remote[lev] or self.remote[lev - 1])

    def smem_bytes(self, tile):
        """Shared memory of one block at an output tile of ``tile``."""
        return 4 * (self.meta_ints + sum(self.buf_rows) * self.stride(tile))


@functools.lru_cache(maxsize=32)
def head_plan(plan):
    """The cached :class:`HeadPlan` of ``plan``, or None where the head
    does not run (fewer than ``HEAD_LEVELS + 1`` levels, or a halo wider
    than the tile the budget holds)."""
    if (plan.nchan_padded < HEAD_GROUP
            or len(plan.iterations) <= HEAD_LEVELS):
        return None
    head = HeadPlan(plan)
    return head if head.eligible else None


# ---------------------------------------------------------------------------
# The transform
# ---------------------------------------------------------------------------

def transform_schedule(plan):
    """The passes of a transform: the fused head over the first
    ``HEAD_LEVELS`` levels where :func:`head_plan` allows it, then
    ``("merge", iteration)`` per level, the last two deep levels as one
    ``("merge4", (idx, shift))`` pass when both are deep (the pairing
    condition of the JAX package's transform).  CPU and CUDA tensors run
    the same schedule.

    Two bisection knobs, read per call (the JAX package's): the head
    with ``PUTPU_FDMT_HEAD`` and the pairing with ``PUTPU_FDMT_DEEP_PAIR``
    (``'0'`` off, ``'1'`` or unset on; :func:`~..utils.knobs.
    tristate_env`).  Off, the levels run as single-level passes (B2a on
    the card); every arm gives the same plane bit for bit."""
    iters = list(plan.iterations)
    steps = []
    head = head_plan(plan) if _knob_on("PUTPU_FDMT_HEAD") else None
    if head is not None:
        steps.append(("head", head))
        iters = iters[HEAD_LEVELS:]
    pair = None
    if (_knob_on("PUTPU_FDMT_DEEP_PAIR") and len(iters) >= 2
            and iters[-1]["shift_high"] is None
            and iters[-2]["shift_high"] is None):
        pair = compose_iterations(iters[-2], iters[-1])
        iters = iters[:-2]
    steps += [("merge", it) for it in iters]
    if pair is not None:
        steps.append(("merge4", pair))
    return steps


def _knob_on(name):
    """A kernel-path bisection knob: on unless ``name`` is ``'0'``."""
    from ..utils.knobs import tristate_env

    return tristate_env(name) is not False


def fdmt_transform(data, max_delay, start_freq, bandwidth, min_delay=0):
    """All integer-delay dedispersed series of ``data`` at once.

    ``data`` is a float32 ``(nchan, T)`` tensor; channels are the lower
    edges of a band ``start_freq .. start_freq + bandwidth`` (MHz).
    Returns the ``(max_delay - min_delay + 1, T)`` plane on ``data``'s
    device: row ``i`` sums one sample per channel along the track with
    band-crossing delay ``min_delay + i``, anchored at the top of the band.

    Both devices run :func:`transform_schedule`: a CUDA tensor through the
    CUDA kernels, a CPU tensor through their plain versions.  The two give
    the same plane bit for bit, equal to the JAX package's per-level
    transform.
    """
    from . import fdmt_cuda

    if data.ndim != 2:
        raise ValueError(f"data must be (nchan, T), got {tuple(data.shape)}")
    nchan = data.shape[0]
    plan = fdmt_plan(int(nchan), float(start_freq), float(bandwidth),
                     int(max_delay), int(min_delay))
    state = data.contiguous()
    for kind, step in transform_schedule(plan):
        if kind == "head":
            state = fdmt_cuda.head(state, step)
        elif kind == "merge":
            state = fdmt_cuda.merge(state, step)
        else:
            state = fdmt_cuda.merge4(state, *step)
    return state
