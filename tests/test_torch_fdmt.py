"""The FDMT: the port's host plan (merge tables, composed pair, tracks,
trial grid, the fused head's group tables) equals the JAX package's; its
plain transform, fused head included, equals
``fdmt_transform(use_pallas=False)`` and the Pallas per-level path with
the head off and the deep pair on (interpret mode) bit for bit; the CUDA
launch tables (merges and head), replayed on the host as the kernels
index them, give the plain versions' states; the CUDA wrappers' argument
checks."""
import numpy as np
import pytest
import torch

from pulsarutils_tpu.ops import fdmt as jfdmt
from pulsarutils_tpu.ops import fdmt_resident as jhead

from pulsarutils_tpu_torch.ops import fdmt as tfdmt
from pulsarutils_tpu_torch.ops import fdmt_cuda
from pulsarutils_tpu_torch.ops.fdmt import (HEAD_BAND, HEAD_CLUSTER,
                                            HEAD_GROUP, HEAD_LEVELS)
from pulsarutils_tpu_torch.ops.fdmt_cuda import (HEAD_PARAMS_LEN,
                                                 MAX_ROW_BLOCKS, TIME_TILE,
                                                 head_params, head_table,
                                                 merge4_table, merge_table)
from pulsarutils_tpu_torch.utils import nvcc

torch.set_num_threads(1)

# (nchan, start_freq, bandwidth, max_delay, min_delay)
GEOMETRIES = [
    (16, 1200.0, 200.0, 40, 0),
    (16, 1200.0, 200.0, 40, 17),
    (12, 1200.0, 200.0, 30, 5),        # nchan not a power of two
    (13, 1200.0, 200.0, 60, 3),
    (64, 1200.0, 200.0, 180, 20),
    (100, 1200.0, 200.0, 150, 140),    # a narrow pruned range
    (24, 110.0, 60.0, 500, 100),       # low band, long delays
]


def _geom_id(g):
    return "x".join(str(v) for v in g)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=_geom_id)
def test_plan_tables_equal_jax(geom):
    ours = tfdmt.FdmtPlan(*geom)
    ref = jfdmt.FdmtPlan(*geom)
    assert ours.nchan_padded == ref.nchan_padded
    assert (ours.min_delay, ours.max_delay) == (ref.min_delay, ref.max_delay)
    assert len(ours.iterations) == len(ref.iterations)
    for it, rit in zip(ours.iterations, ref.iterations):
        for key in ("idx_low", "idx_high", "shift"):
            np.testing.assert_array_equal(it[key], rit[key])
            assert it[key].dtype == rit[key].dtype
        if rit["shift_high"] is None:
            assert it["shift_high"] is None
        else:
            np.testing.assert_array_equal(it["shift_high"], rit["shift_high"])
        assert it["nbands"] == rit["nbands"]
        assert it["ndelay"] == rit["ndelay"]
    if len(ref.iterations) >= 2 and ref.iterations[-2]["shift_high"] is None:
        idx, shift = tfdmt.compose_iterations(*ours.iterations[-2:])
        ridx, rshift = jfdmt.compose_iterations(*ref.iterations[-2:])
        for a, b in zip(idx + shift, ridx + rshift):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tfdmt.fdmt_tracks(ours),
                                  jfdmt.fdmt_tracks(ref))


@pytest.mark.parametrize("args", [
    (1024, 300.0, 635.0, 1200.0, 200.0, 5e-4),
    (32, 100.0, 200.0, 1200.0, 200.0, 5e-4),
    (16, 150.0, 150.2, 1200.0, 200.0, 5e-4),   # narrower than one sample
    (64, 5.0, 10.0, 110.0, 60.0, 1e-3),
])
def test_trial_grid_equals_jax(args):
    dms, lo, hi = tfdmt.fdmt_trial_dms(*args)
    rdms, rlo, rhi = jfdmt.fdmt_trial_dms(*args)
    assert (lo, hi) == (rlo, rhi)
    np.testing.assert_array_equal(dms, rdms)
    nchan, _, dmmax, f0, bw, tsamp = args
    assert tfdmt.max_band_delay(nchan, dmmax, f0, bw, tsamp) == \
        jfdmt.max_band_delay(nchan, dmmax, f0, bw, tsamp)


def test_compose_rejects_leaf_iterations():
    plan = tfdmt.fdmt_plan(16, 1200.0, 200.0, 40)
    with pytest.raises(ValueError, match="deep"):
        tfdmt.compose_iterations(*plan.iterations[:2])


def _data(nchan, t, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (nchan, t)).astype(np.float32)


def _transform(data, max_delay, min_delay, f0=1200.0, bw=200.0):
    """The transform's passes on a CPU tensor, through the wrappers, in
    the schedule both devices run."""
    plan = tfdmt.fdmt_plan(data.shape[0], f0, bw, max_delay, min_delay)
    state = torch.from_numpy(data)
    for kind, step in tfdmt.transform_schedule(plan):
        if kind == "head":
            state = fdmt_cuda.head(state, step)
        elif kind == "merge":
            state = fdmt_cuda.merge(state, step)
        else:
            state = fdmt_cuda.merge4(state, *step)
    return state.numpy()


def _per_level(data, plan, levels=None):
    """The first ``levels`` (all) levels of ``plan`` through the plain
    merge, one after another."""
    state = torch.from_numpy(data)
    for it in plan.iterations[:levels]:
        state = tfdmt.merge_plain(state, it["idx_low"], it["idx_high"],
                                  it["shift"], it["shift_high"])
    return state.numpy()


@pytest.mark.parametrize("nchan, t, max_delay, min_delay", [
    (16, 2048, 40, 0), (16, 2048, 40, 17), (12, 2048, 30, 5),
    (13, 777, 60, 3), (32, 3001, 90, 0), (8, 100, 150, 20),
])
def test_plain_transform_equals_jax_xla(nchan, t, max_delay, min_delay):
    data = _data(nchan, t, nchan + t)
    ref = np.asarray(jfdmt.fdmt_transform(data, max_delay, 1200.0, 200.0,
                                          use_pallas=False,
                                          min_delay=min_delay))
    ours = tfdmt.fdmt_transform(torch.from_numpy(data), max_delay, 1200.0,
                                200.0, min_delay=min_delay).numpy()
    assert ours.shape == ref.shape == (max_delay - min_delay + 1, t)
    assert np.max(np.abs(ours - ref)) == 0.0
    paired = _transform(data, max_delay, min_delay)
    assert np.max(np.abs(paired - ref)) == 0.0
    # the fused pair runs in the CPU schedule too
    plan = tfdmt.fdmt_plan(nchan, 1200.0, 200.0, max_delay, min_delay)
    assert tfdmt.transform_schedule(plan)[-1][0] == "merge4"


@pytest.mark.parametrize("nchan, max_delay, min_delay", [(12, 40, 5)])
def test_plain_transform_equals_pallas_deep_pair(monkeypatch, nchan,
                                                 max_delay, min_delay):
    # the configuration the CUDA path ports: per-level merges, no fused
    # head, the last two levels as one 4-parent pass (interpret mode costs
    # ~20 s a case: one case with zero channels and a pruned range)
    monkeypatch.setenv("PUTPU_FDMT_HEAD", "0")
    monkeypatch.setenv("PUTPU_FDMT_DEEP_PAIR", "1")
    jfdmt._build_transform.cache_clear()
    jfdmt._transform_fn.cache_clear()
    try:
        data = _data(nchan, 2048, 100 + nchan + min_delay)
        ref = np.asarray(jfdmt.fdmt_transform(data, max_delay, 1200.0,
                                              200.0, use_pallas=True,
                                              min_delay=min_delay))
    finally:
        jfdmt._build_transform.cache_clear()
        jfdmt._transform_fn.cache_clear()
    ours = _transform(data, max_delay, min_delay)
    assert np.max(np.abs(ours - ref)) == 0.0


def test_plain_merge_chunks_rows(monkeypatch):
    # a small gather budget forces one-row chunks: same state
    data = _data(16, 512, 3)
    whole = _transform(data, 40, 0)
    monkeypatch.setattr(tfdmt, "PLAIN_CHUNK_ELEMENTS", 600)
    assert tfdmt._row_chunks(7, 512) == [(i, i + 1) for i in range(7)]
    assert np.array_equal(_transform(data, 40, 0), whole)


def _replay_grid(rows_out, nsamples, max_row_blocks):
    """The (row, sample) pairs the kernel's grid visits: time tiles of
    TIME_TILE masked at T, rows strided by the row-block count."""
    visits = np.zeros((rows_out, nsamples), np.int64)
    n_tiles = -(-nsamples // TIME_TILE)
    for by in range(min(rows_out, max_row_blocks)):
        for r in range(by, rows_out, min(rows_out, max_row_blocks)):
            for bx in range(n_tiles):
                t = bx * TIME_TILE + np.arange(TIME_TILE)
                visits[r, t[t < nsamples]] += 1
    return visits


def _replay_parent(state, row, shift, nsamples):
    """A parent read as the kernel makes it: rows at or beyond the
    state's row count are zero, ``t + shift`` wraps by one subtraction."""
    if row >= state.shape[0]:
        return np.zeros(nsamples, np.float32)
    u = np.arange(nsamples) + shift
    assert u.max() < 2 * nsamples
    u[u >= nsamples] -= nsamples
    return state[row, u]


def _replay_merge(state, table):
    ih, il, sh, sl = table
    return np.stack([
        _replay_parent(state, ih[r], sh[r], state.shape[1])
        + _replay_parent(state, il[r], sl[r], state.shape[1])
        for r in range(table.shape[1])])


def _replay_merge4(state, table):
    t = state.shape[1]
    out = []
    for r in range(table.shape[1]):
        x = [_replay_parent(state, table[p, r], table[4 + p, r], t)
             for p in range(4)]
        out.append((x[0] + x[1]) + (x[2] + x[3]))
    return np.stack(out)


@pytest.mark.parametrize("nchan, t, f0, bw, max_delay, min_delay", [
    (12, 1000, 1200.0, 200.0, 30, 5),     # zero channels above the band
    (16, 300, 1200.0, 200.0, 60, 0),
    (16, 97, 110.0, 60.0, 240, 200),      # shifts beyond T
])
def test_launch_tables_replay_equals_plain(nchan, t, f0, bw, max_delay,
                                           min_delay):
    data = _data(nchan, t, 7 * nchan + t)
    plan = tfdmt.fdmt_plan(nchan, f0, bw, max_delay, min_delay)
    state = data
    for kind, step in tfdmt.transform_schedule(plan):
        tin = torch.from_numpy(state)
        if kind == "merge":
            table = merge_table(step, t)
            assert table.shape == (4, len(step["idx_low"]))
            replay = _replay_merge(state, table)
            plain = fdmt_cuda.merge(tin, step).numpy()
        else:
            table = merge4_table(*step, t)
            assert table.shape == (8, len(step[0][0]))
            replay = _replay_merge4(state, table)
            plain = fdmt_cuda.merge4(tin, *step).numpy()
        assert table.dtype == np.int32
        shifts = table[2:] if kind == "merge" else table[4:]
        assert shifts.min() >= 0 and shifts.max() < t
        assert np.max(np.abs(replay - plain)) == 0.0
        state = plain
    assert state.shape == (max_delay - min_delay + 1, t)


@pytest.mark.parametrize("rows_out, nsamples, max_row_blocks", [
    (7, 2500, MAX_ROW_BLOCKS), (9, 1024, 4), (3, 5, 2)])
def test_launch_grid_covers_every_output_once(rows_out, nsamples,
                                              max_row_blocks):
    assert (_replay_grid(rows_out, nsamples, max_row_blocks) == 1).all()


def _launch_counts():
    return (fdmt_cuda.head_launches, fdmt_cuda.merge_launches,
            fdmt_cuda.merge4_launches)


def test_cpu_merges_do_not_count_launches():
    before = _launch_counts()
    _transform(_data(16, 256, 1), 40, 0)
    _transform(_data(256, 256, 2), 180, 40)   # with the head
    assert _launch_counts() == before


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper built or loaded the library")
    monkeypatch.setattr(nvcc, "build", refuse)
    monkeypatch.setattr(nvcc, "load", refuse)


@pytest.mark.parametrize("fn, rows", [(fdmt_cuda.merge_cuda, 4),
                                      (fdmt_cuda.merge4_cuda, 8)])
@pytest.mark.parametrize("state, table, exc, match", [
    (torch.zeros(4, 64), None, ValueError, "CUDA device"),
    (torch.zeros(4, 64, dtype=torch.float64), None, TypeError, "float32"),
    (torch.zeros(64, 4).t(), None, ValueError, "contiguous"),
    (torch.zeros(64), None, ValueError, "2-D"),
    (torch.zeros(4, 64), "int64", ValueError, "int32"),
    (torch.zeros(4, 64), "short", ValueError, "int32"),
])
def test_wrappers_reject_bad_arguments_without_building(
        no_build, fn, rows, state, table, exc, match):
    if table is None:
        table = torch.zeros(rows, 3, dtype=torch.int32)
    elif table == "int64":
        table = torch.zeros(rows, 3, dtype=torch.int64)
    else:
        table = torch.zeros(rows - 1, 3, dtype=torch.int32)
    before = _launch_counts()
    with pytest.raises(exc, match=match):
        fn(state, table)
    assert _launch_counts() == before


def test_merges_reject_other_devices(no_build):
    plan = tfdmt.fdmt_plan(4, 1200.0, 200.0, 10)
    with pytest.raises(ValueError, match="no FDMT merge"):
        fdmt_cuda.merge(torch.zeros(4, 8, device="meta"),
                        plan.iterations[0])


# ---------------------------------------------------------------------------
# The fused head
# ---------------------------------------------------------------------------

# (nchan, max_delay, min_delay): the headline grid (1024 channels, rows
# 459..970 of the JAX package's benchmark), zero channels above the band,
# and two small bands
HEAD_GEOMETRIES = [(1024, 970, 459), (1000, 970, 459), (256, 250, 100),
                   (200, 180, 40)]


@pytest.mark.parametrize("geom", HEAD_GEOMETRIES, ids=_geom_id)
def test_head_plan_equals_jax(geom):
    nchan, max_delay, min_delay = geom
    plan = tfdmt.fdmt_plan(nchan, 1200.0, 200.0, max_delay, min_delay)
    ours = tfdmt.head_plan(plan)
    ref = jhead.HeadPlan(jfdmt.fdmt_plan(nchan, 1200.0, 200.0, max_delay,
                                         min_delay), HEAD_LEVELS)
    assert ours is not None and ours.n_groups == ref.n_groups
    assert HEAD_GROUP == ref.rows_in and HEAD_LEVELS == jhead.HEAD_LEVELS
    for lev, per_group in enumerate(ours.tables):
        rtab = ref.tables[lev]
        np.testing.assert_array_equal(ours.counts[lev], rtab["counts"])
        for g, arrays in enumerate(per_group):
            n = rtab["counts"][g]
            for a, key in zip(arrays, ("idx_high", "idx_low", "shift_high",
                                       "shift")):
                np.testing.assert_array_equal(a, rtab[key][g, :n])
    np.testing.assert_array_equal(ours.row_starts, ref.row_starts)
    assert ours.rows_out == ref.rows_total
    assert ours.max_shift == ref.max_shift_per_level
    assert ours.halo == ref.halo


def test_head_schedule_gates():
    def first(nchan, max_delay, min_delay=0):
        plan = tfdmt.fdmt_plan(nchan, 1200.0, 200.0, max_delay, min_delay)
        return [k for k, _ in tfdmt.transform_schedule(plan)]
    # fewer than 128 channels, or no level after the head: per level
    assert first(64, 180) == ["merge"] * 4 + ["merge4"]
    assert first(128, 180, 40) == ["merge"] * 5 + ["merge4"]
    # 256 channels at DM 300-635: a halo of 541 samples, wider than the
    # tile the budget holds
    hp = tfdmt.HeadPlan(tfdmt.fdmt_plan(256, 1200.0, 200.0, 970, 459))
    assert hp.halo == 541 and not hp.eligible
    assert first(256, 970, 459)[0] == "merge"
    assert first(256, 250, 100) == ["head", "merge"]
    # the headline: the head, one level, the fused pair
    assert first(1024, 970, 459) == ["head", "merge", "merge4"]


def _replay_head(data, hp, table, params):
    """The head as the kernel computes it: one cluster per (group, tile);
    block ``b`` stages band ``b``'s input rows over the tile's window
    (wrapping at T) and computes the rows it owns at each level from its
    table in the flat launch table, reading each parent from the block
    its ``owner << 16 | local`` names; levels whose barrier is the block's
    own read only the block's rows.  Buffers start as NaN, so a read of a
    column or row no block wrote shows in the output."""
    nsamples, rows_valid, n_groups, tiles, tile, stride, b0, b1 = params[:8]
    rows = params[8:8 + HEAD_LEVELS]
    widths = params[8 + HEAD_LEVELS:8 + 2 * HEAD_LEVELS]
    tabs = params[8 + 2 * HEAD_LEVELS:8 + 3 * HEAD_LEVELS]
    counts_at, outs_at, barriers = params[8 + 3 * HEAD_LEVELS:]
    out = np.full((hp.rows_out, nsamples), np.nan, np.float32)
    for g in range(n_groups):
        for tile_index in range(tiles):
            t0 = tile_index * tile
            bufs = [[np.full((b0, stride), np.nan, np.float32),
                     np.full((b1, stride), np.nan, np.float32)]
                    for _ in range(HEAD_CLUSTER)]
            for rank in range(HEAD_CLUSTER):
                for rr in range(HEAD_BAND):
                    ch = g * HEAD_GROUP + rank * HEAD_BAND + rr
                    bufs[rank][0][rr] = (
                        0.0 if ch >= rows_valid
                        else data[ch, (t0 + np.arange(stride)) % nsamples])
            for lev in range(HEAD_LEVELS):
                src = lev % 2
                per_block, width = rows[lev], widths[lev]
                local_only = not (barriers >> lev) & 1 if lev else True
                for rank in range(HEAD_CLUSTER):
                    base = tabs[lev] + (g * HEAD_CLUSTER + rank) * 4 * (
                        per_block)
                    mine = table[counts_at + (lev * n_groups + g)
                                 * HEAD_CLUSTER + rank]
                    for rl in range(mine):
                        ph, pl, sh, sl = (int(table[base + k * per_block
                                                    + rl]) for k in range(4))
                        parents = []
                        for ref, shift in ((ph, sh), (pl, sl)):
                            owner, local = ref >> 16, ref & 0xFFFF
                            assert owner == rank or not local_only
                            parents.append(bufs[owner][src][
                                local, shift:shift + width])
                        high, low = parents
                        assert high.shape == low.shape == (width,)
                        value = high + low
                        if lev == HEAD_LEVELS - 1:
                            end = min(width, nsamples - t0)
                            row = table[outs_at + (g * HEAD_CLUSTER
                                                   + rank) * per_block + rl]
                            out[row, t0:t0 + end] = value[:end]
                        else:
                            bufs[rank][1 - src][rl, :width] = value
    return out


@pytest.mark.parametrize("nchan, t, max_delay, min_delay", [
    (1024, 3000, 970, 459),     # the headline grid, 5 tiles
    (1000, 2000, 970, 459),     # zero channels above the band
    (1024, 150, 970, 459),      # the window wraps T twice
    (256, 4096, 250, 100),      # 7 tiles
    (200, 777, 180, 40),
    # a wide range: a block of the top group owns no row of the last level
    (1000, 1500, 400, 0),
    # 4 groups, the last of zero channels only; blocks that own no row of
    # the wide sub-bands' levels; a partial last tile
    (384, 641, 300, 250),
])
def test_head_launch_replay_equals_plain(nchan, t, max_delay, min_delay):
    data = _data(nchan, t, nchan + 3 * t)
    plan = tfdmt.fdmt_plan(nchan, 1200.0, 200.0, max_delay, min_delay)
    hp = tfdmt.head_plan(plan)
    assert hp is not None and hp.eligible
    table, offsets = head_table(hp)
    params = head_params(hp, offsets, t, nchan)
    tile, stride = params[4], params[5]
    assert table.dtype == np.int32 and len(params) == HEAD_PARAMS_LEN == 32
    assert stride == hp.stride(tile) and params[3] * tile >= t
    assert stride % 4 == 0 and 0 <= stride - (tile + hp.halo) < 4
    # the tables, both buffers and the block's tables fit the budget, and
    # every level's reads stay inside the window the level before it
    # computed
    assert hp.smem_bytes(hp.max_tile) <= tfdmt.HEAD_SMEM_BYTES
    widths = hp.widths(tile)
    assert widths[-1] == tile
    assert widths[0] + hp.max_shift[0] == tile + hp.halo <= stride
    # band ownership: levels 0-3 read only the block's own rows, the
    # levels of wider sub-bands another block's
    assert hp.remote == [False] * 4 + [True] * 3
    assert params[-1] == 0b1110000
    replay = _replay_head(data, hp, table, params)
    plain = fdmt_cuda.head(torch.from_numpy(data), hp).numpy()
    assert np.array_equal(plain, _per_level(data, plan, HEAD_LEVELS))
    assert not np.isnan(replay).any()
    assert np.max(np.abs(replay - plain)) == 0.0


def test_head_ownership_covers_every_row_once():
    # every row of every level has one owner and one local slot; a row of
    # a wide sub-band belongs to one of its parents' owners (one remote
    # read at most), and its sub-band's blocks share the rows within two
    hp = tfdmt.head_plan(tfdmt.fdmt_plan(1000, 1200.0, 200.0, 970, 459))
    for lev in range(HEAD_LEVELS):
        for g in range(hp.n_groups):
            owner, local = hp.owners[lev][g]
            slots = set(zip(owner.tolist(), local.tolist()))
            assert len(slots) == len(owner) == hp.counts[lev][g]
            counts = np.bincount(owner, minlength=HEAD_CLUSTER)
            assert np.array_equal(counts, hp.block_counts[lev, g])
            assert counts.max() <= hp.rows[lev]
            ph, pl = hp.refs[lev][g]
            nsub = len(hp.iterations[lev]["ndelay"]) // hp.n_groups
            if nsub < HEAD_CLUSTER:
                assert ((ph >> 16 == owner) | (pl >> 16 == owner)).all()
                per_sub = counts.reshape(nsub, HEAD_CLUSTER // nsub)
                assert (per_sub.max(1) - per_sub.min(1) <= 2).all()
            else:
                assert ((ph >> 16 == owner) & (pl >> 16 == owner)).all()


@pytest.mark.parametrize("nchan, t, max_delay, min_delay", [
    (256, 2048, 250, 100), (200, 777, 180, 40), (256, 300, 180, 0)])
def test_transform_with_head_equals_jax_xla(nchan, t, max_delay, min_delay):
    data = _data(nchan, t, 5 * nchan + t)
    plan = tfdmt.fdmt_plan(nchan, 1200.0, 200.0, max_delay, min_delay)
    assert tfdmt.transform_schedule(plan)[0][0] == "head"
    ref = np.asarray(jfdmt.fdmt_transform(data, max_delay, 1200.0, 200.0,
                                          use_pallas=False,
                                          min_delay=min_delay))
    ours = tfdmt.fdmt_transform(torch.from_numpy(data), max_delay, 1200.0,
                                200.0, min_delay=min_delay).numpy()
    assert ours.shape == ref.shape == (max_delay - min_delay + 1, t)
    assert np.max(np.abs(ours - ref)) == 0.0
    assert np.max(np.abs(_per_level(data, plan) - ref)) == 0.0


def test_head_wrapper_rejects_bad_arguments_without_building(no_build):
    hp = tfdmt.head_plan(tfdmt.fdmt_plan(256, 1200.0, 200.0, 250, 100))
    table, offsets = head_table(hp)
    params = head_params(hp, offsets, 64, 256)
    tab = torch.from_numpy(table)
    before = _launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        fdmt_cuda.head_cuda(torch.zeros(256, 64), tab, params, hp.rows_out)
    with pytest.raises(ValueError, match="1-D int32"):
        fdmt_cuda.head_cuda(torch.zeros(256, 64), tab.long(), params,
                            hp.rows_out)
    with pytest.raises(TypeError, match="float32"):
        fdmt_cuda.head_cuda(torch.zeros(256, 64, dtype=torch.float64), tab,
                            params, hp.rows_out)
    with pytest.raises(ValueError, match="no FDMT merge"):
        fdmt_cuda.head(torch.zeros(256, 64, device="meta"), hp)
    assert _launch_counts() == before


def test_head_equals_jax_pallas_head():
    # the JAX package's fused head (Pallas, interpret mode; ~8 s) on one
    # small geometry: the same rows bit for bit
    nchan, t, max_delay, min_delay = 256, 2048, 180, 40
    data = _data(nchan, t, 99)
    ref = np.asarray(jhead.head_transform(data, max_delay, 1200.0, 200.0,
                                          min_delay=min_delay, t_slice=2048,
                                          interpret=True))
    hp = tfdmt.head_plan(tfdmt.fdmt_plan(nchan, 1200.0, 200.0, max_delay,
                                         min_delay))
    ours = fdmt_cuda.head(torch.from_numpy(data), hp).numpy()
    table, offsets = head_table(hp)
    replay = _replay_head(data, hp, table,
                          head_params(hp, offsets, t, nchan))
    assert ours.shape == ref.shape == (hp.rows_out, t)
    assert np.max(np.abs(ours - ref)) == 0.0
    assert np.max(np.abs(replay - ref)) == 0.0
