"""The direct sweep: the port's plain plane equals the JAX Pallas kernel's
(both layouts, interpret mode) and ``dedisperse_block_roll_jax``'s with
max |diff| = 0; the CUDA launch plan's index arithmetic, replayed on the
host, gives the same plane; the CUDA wrapper's argument checks."""
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
from pulsarutils_tpu_torch.ops.dedisperse import dedisperse_plane_plain
from pulsarutils_tpu_torch.ops.dedisperse_cuda import (
    CHAN_BLOCK, TIME_TILE, TRIAL_BLOCK, dedisperse_plane,
    dedisperse_plane_cuda, launch_plan)
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
    else:
        raise KeyError(name)
    data = rng.normal(0, 1, (nchan, t)).astype(np.float32)
    return data, off


CASES = ["plan_300_635", "one_trial", "low_freq_large_delay",
         "random_offsets"]


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
    """The kernel's loops, on the host: per block of trials and time tile,
    channels ascending, windows staged from the per-channel minimum
    offset (shared-memory branch) or read with circular indexing (global
    branch), float32 accumulation from zero, stores at ``u + shift``."""
    nchan, t = x.shape
    off = plan.offsets.astype(np.int64)
    ndm = off.shape[0]
    out = np.full((ndm, t), np.nan, np.float32)
    lane = np.arange(TIME_TILE)
    for d0 in range(0, ndm, TRIAL_BLOCK):
        blk = off[d0:d0 + TRIAL_BLOCK]
        for u0 in range(0, t, TIME_TILE):
            u = u0 + lane
            acc = np.zeros((blk.shape[0], TIME_TILE), np.float32)
            for c in range(nchan):
                r = blk[:, c]
                if plan.use_smem:
                    base = r.min()
                    window = x[c, (u0 + base + np.arange(plan.win)) % t]
                    rel = r - base
                    assert rel.max() + TIME_TILE <= plan.win
                    acc += window[rel[:, None] + lane[None, :]]
                else:
                    acc += x[c, (u[None, :] + r[:, None]) % t]
            keep = u < t
            out[d0:d0 + blk.shape[0], (u[keep] + plan.store_shift) % t] = \
                acc[:, keep]
    return out


@pytest.mark.parametrize("branch", ["smem", "global"])
@pytest.mark.parametrize("name", CASES)
def test_launch_plan_replay_equals_plain(name, branch):
    data, off = _case(name)
    plan = launch_plan(off, data.shape[1])
    assert plan.offsets.min() >= 0 and plan.offsets.max() < data.shape[1]
    assert plan.win == TIME_TILE + plan.spread
    plan = dataclasses.replace(plan, use_smem=branch == "smem")
    assert np.max(np.abs(_replay_kernel(data, plan)
                         - _plain(data, off))) == 0.0


def test_launch_plan_spread_and_branch():
    # the plan's one-sample grid keeps a trial block's per-channel spread
    # near the block size, at any frequency; arbitrary offsets do not
    data, off = _case("low_freq_large_delay")
    assert launch_plan(off, data.shape[1]).use_smem
    dms = dedispersion_plan(1024, 300, 635, 1200.0, 200.0, 5e-4)
    head = launch_plan(offsets_for(dms, 1024, 1200.0, 200.0, 5e-4, 1 << 20),
                       1 << 20)
    assert head.spread <= TRIAL_BLOCK + 1 and head.use_smem
    rng = np.random.default_rng(0)
    wide = launch_plan(rng.integers(0, 1 << 16, (64, 32)), 1 << 16)
    assert not wide.use_smem
    assert CHAN_BLOCK * wide.win * 4 > dedisperse_cuda.SMEM_BUDGET


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper built or loaded the library")
    monkeypatch.setattr(nvcc, "build", refuse)
    monkeypatch.setattr(nvcc, "load", refuse)


@pytest.mark.parametrize("data, off, exc, match", [
    (torch.zeros(4, 64), torch.zeros(3, 4, dtype=torch.int32),
     ValueError, "CUDA device"),
    (torch.zeros(4, 64, dtype=torch.float64),
     torch.zeros(3, 4, dtype=torch.int32), TypeError, "float32"),
    (torch.zeros(64, 4).t(), torch.zeros(3, 4, dtype=torch.int32),
     ValueError, "contiguous"),
    (torch.zeros(4, 64), torch.zeros(3, 4, dtype=torch.int64),
     TypeError, "int32"),
    (torch.zeros(4, 64), torch.zeros(3, 5, dtype=torch.int32),
     ValueError, "does not match"),
    (torch.zeros(64), torch.zeros(3, 4, dtype=torch.int32),
     ValueError, "2-D"),
])
def test_wrapper_rejects_bad_arguments_without_building(no_build, data, off,
                                                        exc, match):
    before = dedisperse_cuda.launches
    with pytest.raises(exc, match=match):
        dedisperse_plane_cuda(data, off, 0, TIME_TILE, True)
    assert dedisperse_cuda.launches == before


def test_dedisperse_plane_rejects_other_devices(no_build):
    with pytest.raises(ValueError, match="no dedispersion sweep"):
        dedisperse_plane(torch.zeros(2, 8, device="meta"),
                         np.zeros((1, 2), np.int32))
