"""The sharded direct sweep (``parallel/sharded.py``) against the JAX
package's on its eight virtual CPU devices.

The port's mesh is ``[torch.device("cpu")] * 8``.  Both packages add
each shard's channels in ascending order (the port's plain B1 under
``kernel="pallas"``, the JAX Pallas kernel in interpret mode; under
``"gather"`` both run the roll-accumulate, the gather's CPU form) and
then the channel shards' partials in ascending shard order (the JAX
CPU ``psum`` is that sum), so the planes are equal bit for bit.  The
scores are not: the JAX mesh scores with its XLA scorer in float32, the
port with B4's plain version (float64 row means, ROADMAP C), so
``snr``, ``std`` and ``max`` are held to the JAX package's own mesh
tolerance (rtol 1e-4, ``tests/test_parallel.py``) and the discrete
columns (argbest, ``DM``, ``rebin``, ``peak``) are equal.  Against the
port's single-device search a ``chan = 1`` mesh is bit for bit (it
splits trials only); a ``chan > 1`` mesh associates the channel sum
differently and is held to the same tolerance.
"""
import numpy as np
import pytest
import torch

from pulsarutils_tpu.io.lowbit import PackedFrames as JaxPackedFrames
from pulsarutils_tpu.models.simulate import simulate_test_data
from pulsarutils_tpu.parallel.mesh import make_mesh as jax_mesh
from pulsarutils_tpu.parallel.sharded import (
    sharded_dedispersion_search as jax_sharded)

from pulsarutils_tpu_torch.io import lowbit
from pulsarutils_tpu_torch.io.lowbit import PackedFrames
from pulsarutils_tpu_torch.ops.plan import dedispersion_plan, offsets_for
from pulsarutils_tpu_torch.ops.search import dedispersion_search
from pulsarutils_tpu_torch.parallel.mesh import make_mesh
from pulsarutils_tpu_torch.parallel.sharded import (
    chan_sum, shard_bounds, sharded_dedispersion_search)
from pulsarutils_tpu_torch.parallel.sharded_plane import ShardedPlane
from pulsarutils_tpu_torch.tuning import autotune
from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
#: the JAX package's mesh tolerance on the float scores
MESH_RTOL = 1e-4
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]
FLOATS = ("max", "std", "snr")
DISCRETE = ("DM", "rebin", "peak")


@pytest.fixture(scope="module")
def sim():
    array, header = simulate_test_data(150, nchan=32, nsamples=1024, rng=3)
    args = (100, 200., header["fbottom"], header["bandwidth"],
            header["tsamp"])
    return np.asarray(array, dtype=np.float32), args


def _mesh(shape):
    return make_mesh(shape, devices=CPU8)


def assert_tables_match(ours, theirs, rtol=MESH_RTOL):
    assert ours.nrows == theirs.nrows
    assert ours.argbest() == theirs.argbest()
    for col in DISCRETE:
        np.testing.assert_array_equal(np.asarray(ours[col]),
                                      np.asarray(theirs[col]), err_msg=col)
    for col in FLOATS:
        np.testing.assert_allclose(np.asarray(ours[col]),
                                   np.asarray(theirs[col]), rtol=rtol,
                                   err_msg=col)


@pytest.mark.parametrize("kernel", ["gather", "pallas"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_sweep_equals_jax(sim, shape, kernel):
    array, args = sim
    ours, plane = sharded_dedispersion_search(
        array, *args, mesh=_mesh(shape), kernel=kernel, capture_plane=True)
    theirs, jplane = jax_sharded(array, *args, mesh=jax_mesh(shape),
                                 kernel=kernel, capture_plane=True)
    assert isinstance(plane, np.ndarray)
    np.testing.assert_array_equal(plane, np.asarray(jplane))
    assert_tables_match(ours, theirs)
    single, splane = dedispersion_search(array, *args, capture_plane=True,
                                         device="cpu")
    if shape[1] == 1:
        # trials split only: the single-device rows and scores, bit for bit
        np.testing.assert_array_equal(plane, splane.numpy())
        for col in single.colnames:
            np.testing.assert_array_equal(np.asarray(ours[col]),
                                          np.asarray(single[col]))
    else:
        assert_tables_match(ours, single)
    assert np.isclose(ours["DM"][ours.argbest()], 150, atol=1)


@pytest.mark.parametrize("shape, kernel", [((4, 2), "gather"),
                                           ((4, 2), "pallas"),
                                           ((1, 8), "gather"),
                                           ((8, 1), "pallas")])
def test_uneven_sizes_equal_jax(shape, kernel):
    # 100 channels on a chan axis of 2 or 8, a trial count no dm axis
    # divides: zero channels and short trial shards
    array, header = simulate_test_data(120, nchan=100, nsamples=512, rng=3)
    args = (100, 140., header["fbottom"], header["bandwidth"],
            header["tsamp"])
    ours, plane = sharded_dedispersion_search(
        array, *args, mesh=_mesh(shape), kernel=kernel, capture_plane=True)
    theirs, jplane = jax_sharded(array, *args, mesh=jax_mesh(shape),
                                 kernel=kernel, capture_plane=True)
    assert ours.nrows % 2 == 1  # no dm axis of 2, 4 or 8 divides it
    np.testing.assert_array_equal(plane, np.asarray(jplane))
    assert_tables_match(ours, theirs)
    assert np.isclose(ours["DM"][ours.argbest()], 120, atol=1)


def test_shard_bounds_and_ordered_chan_sum():
    assert shard_bounds(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert shard_bounds(3, 8)[3:] == [(3, 3)] * 5
    assert shard_bounds(0, 2) == [(0, 0), (0, 0)]
    rng = np.random.default_rng(1)
    parts = [torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)
                              * s) for s in (1.0, 1e4, 1e-3, 1e2)]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    got = chan_sum([p.clone() for p in parts], torch.device("cpu"))
    assert torch.equal(got, want)


def test_offsets_subsets_and_pallas_max_off(sim):
    array, args = sim
    nchan, nsamples = array.shape
    trial_dms = dedispersion_plan(nchan, *args)
    offsets = offsets_for(trial_dms, nchan, *args[2:], nsamples)
    mesh, jm = _mesh((4, 2)), jax_mesh((4, 2))
    full = sharded_dedispersion_search(array, *args, mesh=mesh,
                                       kernel="pallas")
    acct = BudgetAccountant()
    for i, lo in enumerate((0, 8, 16)):
        rows = np.arange(lo, lo + 8)
        with acct.chunk(i):
            sub = sharded_dedispersion_search(
                array, *args, mesh=mesh, trial_dms=trial_dms[rows],
                offsets=offsets[rows], kernel="pallas",
                pallas_max_off=4096)
        for col in full.colnames:
            np.testing.assert_array_equal(np.asarray(sub[col]),
                                          np.asarray(full[col])[rows])
    # the supplied-offsets path never rebuilds the plan's shift table,
    # and each call is one dispatch and one readback
    for rec in acct.chunks:
        assert "offset_tables" not in rec["counters"]
        assert rec["counters"]["dispatches"] == 1
        assert rec["counters"]["readbacks"] == 1
    rows = np.arange(8)
    for search, m in ((sharded_dedispersion_search, mesh),
                      (jax_sharded, jm)):
        with pytest.raises(ValueError, match="does not cover"):
            search(array, *args, mesh=m, trial_dms=trial_dms[rows],
                   offsets=offsets[rows], kernel="pallas", pallas_max_off=1)
        with pytest.raises(ValueError, match="offsets shape"):
            search(array, *args, mesh=m, trial_dms=np.array([150.0]),
                   offsets=np.zeros((2, nchan), np.int32))


def test_budget_counters(sim):
    from pulsarutils_tpu_torch.parallel import sharded as tsharded

    array, args = sim
    # the offset table is made once a geometry: the first call counts it,
    # the second finds it
    tsharded.offsets_table.cache_clear()
    acct = BudgetAccountant()
    with acct.chunk(0):
        sharded_dedispersion_search(array, *args, mesh=_mesh((2, 4)),
                                    kernel="pallas")
    with acct.chunk(1):
        sharded_dedispersion_search(array, *args, mesh=_mesh((2, 4)),
                                    kernel="pallas", capture_plane=True)
    c0, c1 = (rec["counters"] for rec in acct.chunks)
    assert c0 == {"offset_tables": 1, "dispatches": 1, "readbacks": 1}
    assert c1 == {"dispatches": 1, "readbacks": 2}
    for rec in acct.chunks:
        assert {"search/plan", "search/dispatch", "search/readback"} \
            <= set(rec["buckets"])


def test_plane_handle_equals_host_capture(sim):
    array, args = sim
    mesh = _mesh((4, 2))
    t_host, plane = sharded_dedispersion_search(array, *args, mesh=mesh,
                                                capture_plane=True)
    t_dev, handle = sharded_dedispersion_search(
        array, *args, mesh=mesh, capture_plane=True, plane_handle=True)
    assert isinstance(handle, ShardedPlane)
    assert handle.shape == plane.shape
    assert len(handle.shards) == 4
    np.testing.assert_array_equal(handle.to_host(), plane)
    for col in t_host.colnames:
        np.testing.assert_array_equal(np.asarray(t_host[col]),
                                      np.asarray(t_dev[col]))


def test_a_shard_on_the_source_device_reads_a_view(sim, monkeypatch):
    array, args = sim
    data = torch.from_numpy(array.copy())
    seen = []
    from pulsarutils_tpu_torch.parallel import sharded as tsharded

    real = tsharded.shard_partial

    def spy(block, *a, **kw):
        seen.append(block.untyped_storage().data_ptr())
        return real(block, *a, **kw)

    monkeypatch.setattr(tsharded, "shard_partial", spy)
    sharded_dedispersion_search(data, *args, mesh=_mesh((2, 4)),
                                kernel="pallas")
    assert len(seen) == 8
    assert set(seen) == {data.untyped_storage().data_ptr()}


@pytest.mark.parametrize("nbits", [2])
def test_packed_chunk_equals_float_and_jax(sim, nbits):
    array, args = sim
    codes = np.clip(np.floor((array - array.mean()) / array.std() + 2.0),
                    0, (1 << nbits) - 1).astype(np.float32)
    frames = np.stack([lowbit.pack_numpy(codes[::-1, t], nbits)
                       for t in range(codes.shape[1])])
    ours = sharded_dedispersion_search(
        PackedFrames(frames, nbits, codes.shape[0], True), *args,
        mesh=_mesh((4, 2)), kernel="pallas")
    floats = sharded_dedispersion_search(codes, *args, mesh=_mesh((4, 2)),
                                         kernel="pallas")
    for col in ours.colnames:
        np.testing.assert_array_equal(np.asarray(ours[col]),
                                      np.asarray(floats[col]))
    theirs = jax_sharded(JaxPackedFrames(frames, nbits, codes.shape[0], True),
                         *args, mesh=jax_mesh((4, 2)), kernel="pallas")
    assert_tables_match(ours, theirs)


@pytest.mark.parametrize("policy", ["f32_compensated",
                                    "bf16_operand_f32_accum"])
def test_precision_policy_under_gather_equals_jax(sim, policy):
    array, args = sim
    ours, plane = sharded_dedispersion_search(
        array, *args, mesh=_mesh((2, 4)), kernel="gather",
        precision=policy, capture_plane=True)
    theirs, jplane = jax_sharded(array, *args, mesh=jax_mesh((2, 4)),
                                 kernel="gather", precision=policy,
                                 capture_plane=True)
    np.testing.assert_array_equal(plane, np.asarray(jplane))
    assert_tables_match(ours, theirs)


def test_precision_policy_rejected_under_pallas(sim):
    array, args = sim
    for search, mesh in ((sharded_dedispersion_search, _mesh((2, 4))),
                         (jax_sharded, jax_mesh((2, 4)))):
        with pytest.raises(ValueError, match="gather mesh kernel"):
            search(array, *args, mesh=mesh, kernel="pallas",
                   precision="split_f32")
    # "auto" is f32 on a mesh: the direct sweep runs
    t = sharded_dedispersion_search(array, *args, mesh=_mesh((2, 4)),
                                    kernel="pallas", precision="auto")
    assert t.nrows


def test_auto_kernel_on_a_cpu_mesh_is_the_gather(sim, monkeypatch):
    array, args = sim
    monkeypatch.setenv("PUTPU_AUTOTUNE", "on")
    prev = autotune.set_tuner(autotune.KernelTuner())
    mark = autotune.decision_seq()
    try:
        auto = sharded_dedispersion_search(array, *args, mesh=_mesh((4, 2)))
    finally:
        autotune.set_tuner(prev)
    gather = sharded_dedispersion_search(array, *args, mesh=_mesh((4, 2)),
                                         kernel="gather")
    for col in auto.colnames:
        np.testing.assert_array_equal(np.asarray(auto[col]),
                                      np.asarray(gather[col]))
    recs = [r for r in autotune.decisions_since(mark)
            if r["key"].startswith("cpu-mesh|")]
    assert recs and recs[0]["kernel"] == "gather"
    assert recs[0]["key"].endswith("|m4x2")


def test_mesh_without_its_axes_raises(sim):
    array, args = sim
    with pytest.raises(ValueError, match="must include"):
        sharded_dedispersion_search(
            array, *args, mesh=make_mesh((8,), ("dm",), devices=CPU8))
    with pytest.raises(ValueError, match="sharded sweep runs"):
        sharded_dedispersion_search(array, *args, mesh=_mesh((4, 2)),
                                    kernel="roll")
