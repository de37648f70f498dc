"""The direct sweep: the port's plain plane equals the JAX Pallas kernel's
(both layouts, interpret mode) and ``dedisperse_block_roll_jax``'s with
max |diff| = 0; the CUDA launch plan (trial block, reuse marks, staged
windows), replayed on the host, gives the same plane for every compiled
trial block and both branches; the direct search's per-geometry plan
cache; the CUDA wrapper's argument checks."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pulsarutils_tpu.ops.dedisperse import dedisperse_block_roll_jax
from pulsarutils_tpu.ops.pallas_dedisperse import dedisperse_plane_pallas
from pulsarutils_tpu.ops.plan import dedispersion_plan as jax_plan
from pulsarutils_tpu.ops.search import _offsets_for as jax_offsets_for

from pulsarutils_tpu_torch.ops import dedisperse_cuda
from pulsarutils_tpu_torch.ops import search as tsearch
from pulsarutils_tpu_torch.ops.dedisperse import dedisperse_plane_plain
from pulsarutils_tpu_torch.ops.dedisperse_cuda import (
    TRIAL_BLOCKS, choose_trial_block, dedisperse_plane, dedisperse_plane_cuda,
    launch_plan)
from pulsarutils_tpu_torch.ops.plan import dedispersion_plan, offsets_for
from pulsarutils_tpu_torch.utils import nvcc

torch.set_num_threads(1)


def _case(name):
    """(data, offsets) for one named geometry; data from a numpy seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "plan_300_635":
        # 40 trials of the DM 300-635 plan, T not a tile multiple
        nchan, t = 32, 3000
        dms = dedispersion_plan(nchan, 300, 635, 1200.0, 200.0, 5e-4)[:40]
        off = offsets_for(dms, nchan, 1200.0, 200.0, 5e-4, t)
    elif name == "one_trial":
        nchan, t = 24, 2048
        dms = dedispersion_plan(nchan, 100, 101, 1200.0, 200.0, 5e-4)[:1]
        off = offsets_for(dms, nchan, 1200.0, 200.0, 5e-4, t)
    elif name == "low_freq_large_delay":
        # the band-crossing delay is a large fraction of T
        nchan, t = 40, 4096
        dms = dedispersion_plan(nchan, 5, 10, 110.0, 60.0, 1e-3)[-60:]
        off = offsets_for(dms, nchan, 110.0, 60.0, 1e-3, t)
    elif name == "random_offsets":
        nchan, t = 19, 2500
        off = rng.integers(0, t, (37, nchan)).astype(np.int32)
    elif name == "rescore_rows_any_order":
        # the hybrid's rescore: plan rows in any order, repeated, and
        # padded by repeating the last row up to the bucket
        nchan, t = 32, 3000
        dms = dedispersion_plan(nchan, 300, 635, 1200.0, 200.0, 5e-4)
        rows = [17, 3, 29, 3, 40, 41, 2, 2, 2, 2, 2]
        off = offsets_for(dms[rows], nchan, 1200.0, 200.0, 5e-4, t)
    elif name == "rescore_bucket_32_any_order":
        # the hybrid's largest bucket: 32 rows, shuffled, with repeats
        nchan, t = 32, 3000
        dms = dedispersion_plan(nchan, 300, 635, 1200.0, 200.0, 5e-4)
        rows = rng.permutation(np.r_[rng.integers(0, len(dms), 24), [7] * 8])
        off = offsets_for(dms[rows], nchan, 1200.0, 200.0, 5e-4, t)
    elif name == "two_trial_tail":
        # the last two trials of a plan, alone in their launch
        nchan, t = 48, 2048
        dms = dedispersion_plan(nchan, 300, 635, 1200.0, 200.0, 5e-4)[-2:]
        off = offsets_for(dms, nchan, 1200.0, 200.0, 5e-4, t)
    else:
        raise KeyError(name)
    data = rng.normal(0, 1, (nchan, t)).astype(np.float32)
    return data, off


CASES = ["plan_300_635", "one_trial", "low_freq_large_delay",
         "random_offsets", "rescore_rows_any_order",
         "rescore_bucket_32_any_order", "two_trial_tail"]


def _plain(data, off):
    return dedisperse_plane_plain(torch.from_numpy(data), off).numpy()


@pytest.mark.parametrize("layout", ["rows", "flat"])
@pytest.mark.parametrize("name", CASES)
def test_plane_equals_pallas_kernel(name, layout):
    data, off = _case(name)
    ref = np.asarray(dedisperse_plane_pallas(data, off, interpret=True,
                                             layout=layout))
    ours = _plain(data, off)
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) == 0.0


@pytest.mark.parametrize("name", CASES)
def test_plane_equals_roll_formulation(name):
    data, off = _case(name)
    ref = np.asarray(dedisperse_block_roll_jax(jnp.asarray(data),
                                               jnp.asarray(off)))
    assert np.max(np.abs(_plain(data, off) - ref)) == 0.0


def test_pulse_at_chunk_end_wraps_circularly():
    # a dispersed track within max_off of the chunk end continues at the
    # chunk start; zero padding instead would lose its tail
    nchan, t = 32, 2048
    dms = jax_plan(nchan, 300, 340, 1200.0, 200.0, 5e-4)
    off = jax_offsets_for(dms, nchan, 1200.0, 200.0, 5e-4, t)
    data = np.zeros((nchan, t), np.float32)
    k = len(dms) // 2
    for c in range(nchan):
        data[c, (t - 3 + off[k, c]) % t] = 1.0
    ref = np.asarray(dedisperse_plane_pallas(data, off, interpret=True))
    ours = _plain(data, off)
    assert np.max(np.abs(ours - ref)) == 0.0
    assert ours[k, t - 3] == nchan
    assert ours[k].argmax() == t - 3


def test_dedisperse_plane_runs_plain_on_cpu():
    data, off = _case("plan_300_635")
    before = dedisperse_cuda.launches
    out = dedisperse_plane(torch.from_numpy(data), off)
    assert torch.equal(out, torch.from_numpy(_plain(data, off)))
    assert dedisperse_cuda.launches == before


def _replay_kernel(x, plan):
    """The kernel's loops, on the host, from the plan rows it reads: per
    block of trials and time tile, channels ascending; the channel's span
    (the tile plus its largest relative offset in the block) staged from
    its least offset in two pieces split at ``T``, the rest of the window
    left unstaged (shared-memory branch), or the input read with circular
    indexing
    (global branch); each trial's values loaded only at a marked trial
    and reused from the last marked one otherwise; float32 accumulation
    from zero; stores at ``u + shift``."""
    nchan, t = x.shape
    block, tile = plan.trial_block, plan.time_tile
    ndm = plan.offsets.shape[0]
    out = np.full((ndm, t), np.nan, np.float32)
    lane = np.arange(tile)
    trials = np.arange(block)
    for b, rows in enumerate(plan.meta.astype(np.int64)):
        nd = min(block, ndm - b * block)
        for u0 in range(0, t, tile):
            u = u0 + lane
            acc = np.zeros((block, tile), np.float32)
            for c in range(nchan):
                base, mask, top = rows[c, :3]
                rel = rows[c, 3:]
                assert top == rel.max()
                marked = ((mask & 0xFFFFFFFF) >> trials) & 1 == 1
                assert marked[0]
                # the trial whose load each trial's registers hold
                src = np.maximum.accumulate(np.where(marked, trials, 0))
                r = rel[src]
                if plan.use_smem:
                    # the channel's own span, then unstaged (NaN) up to
                    # the launch's window
                    span = min(plan.win, tile + int(top))
                    start = (u0 + base) % t
                    n1 = min(span, t - start)
                    rest = np.arange(span - n1) % t
                    window = np.concatenate([
                        x[c, start:start + n1], x[c, rest],
                        np.full(plan.win - span, np.nan, np.float32)])
                    assert r.max() + tile <= span
                    acc += window[r[:, None] + lane[None, :]]
                else:
                    acc += x[c, (u[None, :] + base + r[:, None]) % t]
            keep = u < t
            out[b * block:b * block + nd,
                (u[keep] + plan.store_shift) % t] = acc[:nd][:, keep]
    return out


@pytest.mark.parametrize("branch", ["smem", "global"])
@pytest.mark.parametrize("name", CASES)
def test_launch_plan_replay_equals_plain(name, branch):
    data, off = _case(name)
    plan = launch_plan(off, data.shape[1])
    assert plan.offsets.min() >= 0 and plan.offsets.max() < data.shape[1]
    assert plan.win == plan.time_tile + plan.spread
    plan = dataclasses.replace(plan, use_smem=branch == "smem")
    assert np.max(np.abs(_replay_kernel(data, plan)
                         - _plain(data, off))) == 0.0


@pytest.mark.parametrize("branch", ["smem", "global"])
@pytest.mark.parametrize("block", TRIAL_BLOCKS)
@pytest.mark.parametrize("name", CASES)
def test_replay_each_trial_block_equals_plain(name, block, branch):
    data, off = _case(name)
    plan = launch_plan(off, data.shape[1], trial_block=block)
    assert plan.trial_block == block
    assert plan.meta.shape == (-(-off.shape[0] // block), off.shape[1],
                               block + 3)
    plan = dataclasses.replace(plan, use_smem=branch == "smem")
    assert np.array_equal(_replay_kernel(data, plan), _plain(data, off))


def test_launch_plan_spread_and_branch():
    # the plan's one-sample grid keeps a trial block's per-channel spread
    # near the block size, at any frequency; arbitrary offsets do not
    data, off = _case("low_freq_large_delay")
    assert launch_plan(off, data.shape[1]).use_smem
    dms = dedispersion_plan(1024, 300, 635, 1200.0, 200.0, 5e-4)
    head = launch_plan(offsets_for(dms, 1024, 1200.0, 200.0, 5e-4, 1 << 20),
                       1 << 20)
    assert head.spread <= head.trial_block + 1 and head.use_smem
    # most neighbouring trials share a channel's offset: loads per add
    # well below one
    assert head.distinct_share < 0.6
    rng = np.random.default_rng(0)
    wide = launch_plan(rng.integers(0, 1 << 16, (64, 32)), 1 << 16)
    assert not wide.use_smem
    assert 4 * 3 * wide.chan_block * wide.win > dedisperse_cuda.SMEM_BUDGET


@pytest.mark.parametrize("ndm, block", [(1, 8), (2, 8), (8, 8), (9, 16),
                                        (16, 16), (32, 16), (33, 16),
                                        (64, 16), (512, 16)])
def test_plan_chooses_the_covering_trial_block(ndm, block):
    # 8 trials a block covers a launch of up to 8; wider launches run in
    # 16-trial blocks
    assert choose_trial_block(ndm) == block
    plan = launch_plan(np.zeros((ndm, 5), np.int32), 4096)
    assert plan.trial_block == block
    assert plan.meta.shape == (-(-ndm // block), 5, block + 3)


def test_plan_marks_only_changed_offsets():
    off = np.array([[0, 5], [0, 6], [1, 6], [1, 5], [3, 5]], np.int32)
    plan = launch_plan(off, 100, trial_block=8)
    rows = plan.meta[0]
    assert list(rows[:, 0]) == [0, 5]                  # least offsets
    assert list(rows[:, 2]) == [3, 1]                  # largest rel
    assert list(rows[0, 3:]) == [0, 0, 1, 1, 3, 3, 3, 3]   # padded
    assert list(rows[1, 3:]) == [0, 1, 1, 0, 0, 0, 0, 0]
    assert rows[0, 1] == 0b10101 and rows[1, 1] == 0b1011
    assert plan.distinct_share == 6 / 10
    # a 16-trial block: every trial of channel 0 changes, none of channel 1
    off16 = np.arange(16, dtype=np.int32)[:, None].repeat(2, axis=1)
    off16[:, 1] = 7
    rows = launch_plan(off16, 1000, trial_block=16).meta[0]
    assert rows[0, 1] == 0xFFFF and rows[1, 1] == 1


def test_plan_cache_keys_on_content_t_and_device():
    # the direct search plans each superblock once per geometry and device
    # (the trial grid's content, T, the superblock size): a repeat hands
    # back the same plans and rows; a changed grid or T plans anew
    dms = dedispersion_plan(32, 300, 635, 1200.0, 200.0, 5e-4)[:40]
    geom = (32, 1200.0, 200.0, 5e-4)
    meta = torch.device("meta")

    def sweep(grid=dms, t=3000, superblock=16, device=meta):
        return tsearch._direct_sweep(grid.tobytes(), *geom, t, superblock,
                                     device)

    first = sweep()
    assert [rows.shape[0] for rows, _ in first] == [16, 16, 8]
    for rows, (plan, rows_on_device) in first:
        assert not rows.flags.writeable
        assert np.array_equal(plan.meta, launch_plan(rows, 3000).meta)
        assert rows_on_device.device == meta
        assert tuple(rows_on_device.shape) == plan.meta.shape
    assert np.array_equal(np.concatenate([r for r, _ in first]),
                          offsets_for(dms, *geom, 3000))
    again = sweep(grid=dms.copy())
    assert all(a[1] is f[1] for a, f in zip(again, first))
    changed = dms.copy()
    changed[3] += 0.5
    assert sweep(grid=changed)[0][1] is not first[0][1]
    assert sweep(t=3001)[0][1] is not first[0][1]
    assert [p for _, p in sweep(device=torch.device("cpu"))] == [None] * 3


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper built or loaded the library")
    monkeypatch.setattr(nvcc, "build", refuse)
    monkeypatch.setattr(nvcc, "load", refuse)


def _meta(nchan=4, dtype=torch.int32):
    return torch.zeros((1, nchan, 8 + 3), dtype=dtype)


#: a plan for 3 trials over 4 channels and 64 samples
_PLAN = launch_plan(np.zeros((3, 4), np.int32), 64)


@pytest.mark.parametrize("data, off, exc, match", [
    (torch.zeros(4, 64), _meta(), ValueError, "CUDA device"),
    (torch.zeros(4, 64, dtype=torch.float64), _meta(), TypeError,
     "float32"),
    (torch.zeros(64, 4).t(), _meta(), ValueError, "contiguous"),
    (torch.zeros(4, 64), _meta(dtype=torch.int64), TypeError, "int32"),
    (torch.zeros(4, 64), _meta(nchan=5), ValueError, "does not match"),
    (torch.zeros(64), _meta(), ValueError, "2-D"),
])
def test_wrapper_rejects_bad_arguments_without_building(no_build, data, off,
                                                        exc, match):
    before = dedisperse_cuda.launches
    with pytest.raises(exc, match=match):
        dedisperse_plane_cuda(data, off, _PLAN)
    assert dedisperse_cuda.launches == before


def test_dedisperse_plane_rejects_other_devices(no_build):
    with pytest.raises(ValueError, match="no dedispersion sweep"):
        dedisperse_plane(torch.zeros(2, 8, device="meta"),
                         np.zeros((1, 2), np.int32))
