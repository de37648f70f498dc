"""The dm-sharded plane handle (``parallel/sharded_plane.py``) against
the JAX package's on its eight virtual CPU devices.

The same pulse chunk as the JAX package's ``tests/test_sharded_plane.py``,
captured by the sharded FDMT on a (4, 2) mesh of each package.  The
port's shards hold the same rows as the JAX shards (the JAX shards pad
theirs; the padding is never referenced), so the per-row products
compare row for row: the spectral scores within the JAX test's own
tolerances (the port's plain harmonic chain against the JAX XLA chain),
the H curve within rtol 1e-4 (both digitise each shard by the median
and MAD of its referenced rows, in float32), the decimated image
within the JAX test's atol 1e-2, and single rows bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from pulsarutils_tpu.ops.plan import dedispersion_shifts
from pulsarutils_tpu.parallel.mesh import make_mesh as jax_mesh
from pulsarutils_tpu.parallel import sharded_fdmt as jsf

from pulsarutils_tpu_torch.ops.periodicity import period_search_plane
from pulsarutils_tpu_torch.ops.search import dedispersion_search
from pulsarutils_tpu_torch.parallel import sharded_fdmt as tsf
from pulsarutils_tpu_torch.parallel.mesh import make_mesh
from pulsarutils_tpu_torch.parallel.sharded import sharded_dedispersion_search
from pulsarutils_tpu_torch.parallel.sharded_plane import ShardedPlane

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
ARGS = (100, 200, 1400.0, 300.0, 1e-3)


@pytest.fixture(scope="module")
def pulse_data():
    rng = np.random.default_rng(7)
    nchan, t = 64, 2048
    data = rng.normal(size=(nchan, t)).astype(np.float32)
    shifts = dedispersion_shifts(nchan, 150.0, 1400.0, 300.0, 1e-3)
    for c in range(nchan):
        data[c, (500 + int(round(shifts[c]))) % t] += 12.0
    return data


@pytest.fixture(scope="module")
def captures(pulse_data):
    ours = tsf.sharded_fdmt_search(pulse_data, *ARGS,
                                   mesh=make_mesh((4, 2), devices=CPU8),
                                   capture_plane=True)
    theirs = jsf.sharded_fdmt_search(pulse_data, *ARGS,
                                     mesh=jax_mesh((4, 2)),
                                     capture_plane=True)
    return ours, theirs


def test_rows_and_host_plane_equal_single_device(pulse_data, captures):
    (table, plane), (_, jplane) = captures
    t0, plane0 = dedispersion_search(pulse_data, *ARGS, kernel="fdmt",
                                     capture_plane=True, device="cpu")
    assert isinstance(plane, ShardedPlane)
    assert plane.shape == tuple(plane0.shape) == jplane.shape
    assert plane.ndim == 2
    np.testing.assert_array_equal(plane.to_host(), plane0.numpy())
    np.testing.assert_allclose(plane.to_host(), jplane.to_host(), atol=1e-3)
    np.testing.assert_array_equal(plane.row(5), plane0.numpy()[5])
    np.testing.assert_array_equal(plane[table.argbest()],
                                  plane0.numpy()[t0.argbest()])
    with pytest.raises(TypeError):
        plane[1:3]  # noqa: B018


def test_remap_keeps_the_shards(captures):
    (_, plane), (_, jplane) = captures
    idx = np.array([3, 3, 0, 7, 1])
    ours, theirs = plane.remap(idx), jplane.remap(idx)
    assert ours.shards[0] is plane.shards[0]
    np.testing.assert_array_equal(ours.to_host(), plane.to_host()[idx])
    np.testing.assert_allclose(ours.to_host(), theirs.to_host(), atol=1e-3)


def test_spectral_scores_equal_jax(captures):
    (_, plane), (_, jplane) = captures
    ours = plane.spectral_scores(1e-3, fmin=2.0)
    theirs = jplane.spectral_scores(1e-3, fmin=2.0)
    np.testing.assert_allclose(ours["freq"], theirs["freq"], rtol=1e-5)
    np.testing.assert_allclose(ours["power"], theirs["power"], rtol=1e-3)
    np.testing.assert_array_equal(ours["nharm"], theirs["nharm"])
    np.testing.assert_allclose(ours["sigma"], theirs["sigma"], rtol=1e-3)


@pytest.mark.parametrize("window", [1, 2, 4])
def test_h_curve_equals_jax_per_shard(captures, window):
    (table, plane), (_, jplane) = captures
    h, m = plane.h_curve(window=window)
    jh, jm = jplane.h_curve(window=window)
    assert h.shape == (len(table["DM"]),)
    np.testing.assert_allclose(h, jh, rtol=1e-4)
    np.testing.assert_array_equal(m, jm)
    # a remapped handle: each shard's statistics over its referenced rows
    idx = np.arange(0, plane.shape[0], 3)
    h2, _ = plane.remap(idx).h_curve(window=window)
    jh2, _ = jplane.remap(idx).h_curve(window=window)
    np.testing.assert_allclose(h2, jh2, rtol=1e-4)


@pytest.mark.parametrize("max_bins", [256, 1 << 20])
def test_decimated_image_equals_jax(captures, max_bins):
    (_, plane), (_, jplane) = captures
    img, factor = plane.decimated(max_bins=max_bins)
    jimg, jfactor = jplane.decimated(max_bins=max_bins)
    assert factor == jfactor
    np.testing.assert_allclose(img, jimg, atol=1e-2)
    host = plane.to_host()
    n = host.shape[1] // factor
    np.testing.assert_allclose(
        img, host[:, :n * factor].reshape(host.shape[0], n, factor).sum(2),
        rtol=1e-5, atol=1e-4)


def test_sweep_handle_and_period_search(pulse_data):
    mesh = make_mesh((4, 2), devices=CPU8)
    table, handle = sharded_dedispersion_search(
        pulse_data, *ARGS, mesh=mesh, capture_plane=True, plane_handle=True)
    t = handle.shape[1]
    kw = dict(fmin=4.0 / (t * 1e-3), refine_top=1)
    on_mesh = period_search_plane(handle, 1e-3, **kw)
    on_host = period_search_plane(handle.to_host(), 1e-3, **kw)
    assert on_mesh["best_dm_index"] == on_host["best_dm_index"]
    for key in ("best_freq", "best_h", "best_sigma", "best_m"):
        assert on_mesh[key] == on_host[key], key
    np.testing.assert_array_equal(on_mesh["sigma"], on_host["sigma"])


def test_diagnostic_figure_from_a_handle(pulse_data, captures, tmp_path):
    pytest.importorskip("matplotlib")
    from pulsarutils_tpu_torch.pipeline.diagnostics import (
        figure_arrays, plot_diagnostics)
    from pulsarutils_tpu_torch.pipeline.pulse_info import PulseInfo

    (table, plane), _ = captures
    info = PulseInfo(allprofs=pulse_data, start_freq=1400.0,
                     bandwidth=300.0, nbin=pulse_data.shape[1],
                     nchan=pulse_data.shape[0], t0=0.0,
                     pulse_freq=1.0 / (pulse_data.shape[1] * 1e-3))
    arrays = figure_arrays(info, table, plane)
    window = int(table["rebin"][table.argbest()])
    h, _ = plane.h_curve(window)
    np.testing.assert_array_equal(arrays["h"], h)
    img, factor = plane.decimated(1024)
    np.testing.assert_array_equal(arrays["plane"], img)
    assert arrays["plane_factor"] == factor
    out = plot_diagnostics(info, table, plane,
                           outname=str(tmp_path / "mesh_diag.jpg"))
    assert os.path.getsize(out) > 0
