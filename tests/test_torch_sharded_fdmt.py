"""The dm-sliced sharded FDMT and the mesh hybrid
(``parallel/sharded_fdmt.py``) against the JAX package's on its eight
virtual CPU devices.

Each dm shard runs the port's transform on its delay slice
(``fdmt_transform(min_delay=lo, max_delay=hi)``); its rows equal the
single-device transform's rows bit for bit, because the tracks and the
summation order are the same (JAX ``parallel/sharded_fdmt.py:1-28``),
the B3 head's pruned plans included (256 channels below).  The tables
are held to the JAX mesh tables on the discrete columns, and the float
scores within the JAX package's own tolerance (rtol/atol 1e-4,
``tests/test_parallel.py``): the port scores with B4's plain version.
The mesh hybrid's fused round computes the guarantee loop's own seed
mask, so fused and unfused give the same table, and the argbest,
``DM``, ``rebin``, ``peak`` and ``exact`` columns equal the JAX
package's, fused and unfused, with the same dispatch and readback
counts.
"""
import numpy as np
import pytest
import torch

from pulsarutils_tpu.models.simulate import simulate_test_data
from pulsarutils_tpu.parallel import sharded_fdmt as jsf
from pulsarutils_tpu.parallel.mesh import make_mesh as jax_mesh
from pulsarutils_tpu.utils.logging_utils import (
    BudgetAccountant as JaxBudgetAccountant)

from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec
from pulsarutils_tpu_torch.ops.fdmt import fdmt_trial_dms, fdmt_transform
from pulsarutils_tpu_torch.ops.search import dedispersion_search
from pulsarutils_tpu_torch.parallel import sharded_fdmt as tsf
from pulsarutils_tpu_torch.parallel.mesh import make_mesh
from pulsarutils_tpu_torch.resilience import ladder
from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
#: the JAX package's tolerance between its sharded and single FDMT
FDMT_TOL = 1e-4
HYBRID_SHAPES = [(8, 1), (4, 2), (2, 4), (1, 1)]
DISCRETE = ("DM", "rebin", "peak", "exact")


@pytest.fixture(autouse=True)
def static_tuner(monkeypatch):
    # the JAX hybrid's rescore kernel goes through its tuner
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")
    ladder.reset()
    yield
    ladder.reset()


@pytest.fixture(scope="module")
def sim():
    # a strong pulse: the seed and need sets fit the device buckets, and
    # no mask criterion sits within a float32 ulp of its threshold
    array, header = simulate_test_data(150, nchan=64, nsamples=4096,
                                       signal=2.0, noise=0.4, rng=51)
    args = (100, 200.0, header["fbottom"], header["bandwidth"],
            header["tsamp"])
    return np.asarray(array, dtype=np.float32), args


def _mesh(shape, axes=("dm", "chan")):
    return make_mesh(shape, axes, devices=CPU8)


@pytest.mark.parametrize("lo, hi, n", [(10, 20, 4), (10, 30, 4), (0, 7, 8),
                                       (5, 1000, 3), (3, 3, 1)])
def test_slice_delay_range_equals_jax(lo, hi, n):
    assert tsf.slice_delay_range(lo, hi, n) == jsf.slice_delay_range(lo, hi,
                                                                     n)


def test_slice_delay_range_cannot_fill():
    for fn in (tsf.slice_delay_range, jsf.slice_delay_range):
        with pytest.raises(ValueError, match="cannot fill"):
            fn(5, 6, 8)


@pytest.mark.parametrize("shape, axes", [((8,), ("dm",)),
                                         ((4, 2), ("dm", "chan")),
                                         ((2, 4), ("dm", "chan"))])
def test_sharded_fdmt_rows_equal_single_device(sim, shape, axes):
    array, args = sim
    _, lo, hi = fdmt_trial_dms(array.shape[0], *args)
    full = fdmt_transform(torch.from_numpy(array), hi, args[2], args[3],
                          min_delay=lo)
    table, plane = tsf.sharded_fdmt_search(array, *args,
                                           mesh=_mesh(shape, axes),
                                           capture_plane=True)
    assert len(plane.shards) == shape[0]
    np.testing.assert_array_equal(plane.to_host(), full.numpy())
    # the scorer is per row: the single-device FDMT search's table, bit
    # for bit
    single = dedispersion_search(array, *args, kernel="fdmt", device="cpu")
    for col in single.colnames:
        np.testing.assert_array_equal(np.asarray(table[col]),
                                      np.asarray(single[col]))
    theirs = jsf.sharded_fdmt_search(array, *args,
                                     mesh=jax_mesh(shape, axes))
    assert table.argbest() == theirs.argbest()
    for col in ("DM", "rebin", "peak"):
        np.testing.assert_array_equal(np.asarray(table[col]),
                                      np.asarray(theirs[col]))
    np.testing.assert_allclose(table["snr"], theirs["snr"], rtol=FDMT_TOL,
                               atol=FDMT_TOL)
    assert np.isclose(table["DM"][table.argbest()], 150, atol=1.5)


def test_pruned_head_slices_equal_single_device():
    # 256 channels: every slice (delays above zero included) builds the
    # B3 head's plan, and its rows are the full transform's
    from pulsarutils_tpu_torch.ops.fdmt import (fdmt_plan, head_plan,
                                                transform_schedule)

    array, header = simulate_test_data(150, nchan=256, nsamples=2048, rng=5)
    args = (100, 300.0, header["fbottom"], header["bandwidth"],
            header["tsamp"])
    _, lo, hi = fdmt_trial_dms(256, *args)
    slices = tsf.slice_delay_range(lo, hi, 4)
    for s_lo, s_hi in slices:
        plan = fdmt_plan(256, args[2], args[3], s_hi, s_lo)
        assert head_plan(plan) is not None
        assert transform_schedule(plan)[0][0] == "head"
    full = fdmt_transform(torch.from_numpy(np.asarray(array, np.float32)),
                          hi, args[2], args[3], min_delay=lo)
    _, plane = tsf.sharded_fdmt_search(array, *args,
                                       mesh=_mesh((4,), ("dm",)),
                                       capture_plane=True)
    np.testing.assert_array_equal(plane.to_host(), full.numpy())


def test_sharded_fdmt_with_cert_and_packed(sim):
    from pulsarutils_tpu_torch.io import lowbit
    from pulsarutils_tpu_torch.io.lowbit import PackedFrames

    array, args = sim
    mesh = _mesh((4, 2))
    table = tsf.sharded_fdmt_search(array, *args, mesh=mesh, with_cert=True)
    theirs = jsf.sharded_fdmt_search(array, *args, mesh=jax_mesh((4, 2)),
                                     with_cert=True)
    np.testing.assert_allclose(table["cert"], theirs["cert"], rtol=FDMT_TOL,
                               atol=FDMT_TOL)
    codes = np.clip(np.floor(array / array.std() + 1.0), 0, 3).astype(
        np.float32)
    frames = np.stack([lowbit.pack_numpy(codes[:, t], 2)
                       for t in range(codes.shape[1])])
    packed = tsf.sharded_fdmt_search(PackedFrames(frames, 2, 64, False),
                                     *args, mesh=mesh)
    floats = tsf.sharded_fdmt_search(codes, *args, mesh=mesh)
    for col in floats.colnames:
        np.testing.assert_array_equal(np.asarray(packed[col]),
                                      np.asarray(floats[col]))


def _counts(acct):
    c = acct.chunks[0]["counters"]
    return {k: c.get(k, 0) for k in ("dispatches", "readbacks",
                                     "rescore_calls", "rescore_rows")}


@pytest.mark.parametrize("shape", HYBRID_SHAPES)
def test_mesh_hybrid_equals_jax_fused_and_unfused(sim, shape):
    array, args = sim
    mesh, jm = _mesh(shape), jax_mesh(shape)
    runs = {}
    for fused in (None, False):
        acct, jacct = BudgetAccountant(), JaxBudgetAccountant()
        with acct.chunk(0):
            ours = tsf.sharded_hybrid_search(array, *args, mesh=mesh,
                                             fused=fused)
        with jacct.chunk(0):
            theirs = jsf.sharded_hybrid_search(array, *args, mesh=jm,
                                               fused=fused)
        assert ours.argbest() == theirs.argbest()
        for col in DISCRETE:
            np.testing.assert_array_equal(np.asarray(ours[col]),
                                          np.asarray(theirs[col]),
                                          err_msg=col)
        best = ours.argbest()
        assert bool(ours["exact"][best])
        assert np.isclose(ours["snr"][best], theirs["snr"][best],
                          rtol=FDMT_TOL)
        assert ours.meta["certified"] == theirs.meta["certified"]
        assert _counts(acct) == _counts(jacct)
        runs[fused] = ours
    # the fused round rescored the loop's own seed: the same table
    fused, unfused = runs[None], runs[False]
    for col in fused.colnames:
        np.testing.assert_array_equal(np.asarray(fused[col]),
                                      np.asarray(unfused[col]), err_msg=col)
    assert fused.meta == unfused.meta


def test_fused_dispatch_count_pinned(sim):
    array, args = sim
    acct = BudgetAccountant()
    with acct.chunk("fused"):
        t = tsf.sharded_hybrid_search(array, *args, mesh=_mesh((8, 1)))
    c = acct.chunks[0]["counters"]
    assert c["dispatches"] == 1 and c["readbacks"] == 1
    assert "rescore_calls" not in c
    assert bool(t["exact"][t.argbest()])
    assert acct.trips() == 2
    acct_u = BudgetAccountant()
    with acct_u.chunk("unfused"):
        tsf.sharded_hybrid_search(array, *args, mesh=_mesh((8, 1)),
                                  fused=False)
    c_u = acct_u.chunks[0]["counters"]
    assert c_u["dispatches"] >= 2 and c_u["rescore_calls"] >= 1


def test_fused_floor_without_certificate_parity(sim):
    array, args = sim
    mesh = _mesh((4, 2))
    kw = dict(snr_floor=8.0, noise_certificate=False)
    t_f = tsf.sharded_hybrid_search(array, *args, mesh=mesh, **kw)
    t_u = tsf.sharded_hybrid_search(array, *args, mesh=mesh, fused=False,
                                    **kw)
    theirs = jsf.sharded_hybrid_search(array, *args, mesh=jax_mesh((4, 2)),
                                       **kw)
    for col in t_f.colnames:
        np.testing.assert_array_equal(np.asarray(t_f[col]),
                                      np.asarray(t_u[col]), err_msg=col)
    assert t_f.meta == t_u.meta
    np.testing.assert_array_equal(t_f["exact"], theirs["exact"])


def test_fused_gating_and_force_flag(sim):
    array, args = sim
    for search, mesh in ((tsf.sharded_hybrid_search, _mesh((4, 2))),
                         (jsf.sharded_hybrid_search, jax_mesh((4, 2)))):
        with pytest.raises(ValueError, match="certificate mode"):
            search(array, *args, mesh=mesh, snr_floor=12.0, fused=True)
        with pytest.raises(ValueError, match="legacy margins"):
            search(array, *args, mesh=mesh, rho_cert=False, fused=True)


def test_certificate_mode_equals_jax(sim):
    # a certificate-mode floor keeps the two-stage composition; a noise
    # chunk is certified by both packages
    rng = np.random.default_rng(4)
    noise = rng.normal(size=(64, 4096)).astype(np.float32)
    _, args = sim
    ours = tsf.sharded_hybrid_search(noise, *args, mesh=_mesh((4, 2)),
                                     snr_floor=12.0)
    theirs = jsf.sharded_hybrid_search(noise, *args, mesh=jax_mesh((4, 2)),
                                       snr_floor=12.0)
    assert ours.meta["certified"] == theirs.meta["certified"]
    np.testing.assert_array_equal(ours["exact"], theirs["exact"])


def test_unfuse_rung_under_an_injected_oom(sim):
    # an out-of-memory error in the fused round descends the ladder's
    # unfuse rung, and the two-stage composition gives the same table
    array, args = sim
    mesh = _mesh((4, 2))
    plan = FaultPlan([FaultSpec(site="mesh", kind="oom", times=1)])
    with plan.armed():
        got = tsf.sharded_hybrid_search(array, *args, mesh=mesh)
    assert plan.fired("mesh") == 1
    assert ladder.unfuse_engaged()
    ladder.reset()
    want = tsf.sharded_hybrid_search(array, *args, mesh=mesh, fused=False)
    for col in want.colnames:
        np.testing.assert_array_equal(np.asarray(got[col]),
                                      np.asarray(want[col]), err_msg=col)
    # fused=True never descends
    with FaultPlan([FaultSpec(site="mesh", kind="oom")]).armed(), \
            pytest.raises(torch.OutOfMemoryError):
        tsf.sharded_hybrid_search(array, *args, mesh=mesh, fused=True)
    assert not ladder.unfuse_engaged()


def test_hybrid_capture_is_the_coarse_plane_on_the_plan_grid(sim):
    from pulsarutils_tpu_torch.ops.search import nearest_rows

    array, args = sim
    table, plane = tsf.sharded_hybrid_search(array, *args,
                                             mesh=_mesh((4, 2)),
                                             capture_plane=True)
    assert plane.shape[0] == len(table["DM"])
    t0, plane0 = dedispersion_search(array, *args, kernel="fdmt",
                                     capture_plane=True, device="cpu")
    idx = nearest_rows(np.asarray(t0["DM"]), np.asarray(table["DM"]))
    np.testing.assert_array_equal(plane.to_host(), plane0.numpy()[idx])
    assert bool(table["exact"][table.argbest()])
