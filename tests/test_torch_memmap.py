"""``capture_plane="memmap"`` in the port on the CPU, held against the JAX
package: the disk plane equals the dense capture across superblocks and
the JAX package's Pallas spill, the whole-plane kernels refuse it as the
JAX package's do, and ``delete=True``, ``$PUTPU_PLANE_DIR`` and
:func:`release_plane` behave as there."""
import gc
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from pulsarutils_tpu.obs.metrics import REGISTRY as JAX_REGISTRY
from pulsarutils_tpu.ops import search as jax_search
from pulsarutils_tpu.ops.search import \
    dedispersion_search as jax_dedispersion_search

from pulsarutils_tpu_torch.obs.metrics import REGISTRY
from pulsarutils_tpu_torch.ops import search as search_ops
from pulsarutils_tpu_torch.ops.periodicity import period_search_plane
from pulsarutils_tpu_torch.ops.search import (dedispersion_search,
                                              plane_memmap, release_plane)
from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

torch.set_num_threads(1)

GARGS = (1200.0, 200.0, 0.0005)


@pytest.fixture(autouse=True)
def clean_registries():
    """Both packages' process-wide registries, reset after each test."""
    yield
    REGISTRY.reset()
    JAX_REGISTRY.reset()


def make_data(nchan=32, t=2048, seed=0):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.standard_normal((nchan, t))) * 0.5).astype(np.float32)


@pytest.mark.parametrize("delete", [False, True])
def test_plane_memmap_helper(tmp_path, delete):
    mm = plane_memmap(8, 64, directory=str(tmp_path), delete=delete)
    jmm = jax_search.plane_memmap(8, 64, directory=str(tmp_path),
                                  delete=delete)
    assert isinstance(mm, np.memmap) and mm.shape == (8, 64)
    assert mm.dtype == jmm.dtype and mm.shape == jmm.shape
    mm[:] = 7.0
    mm.flush()
    back = np.load(mm.filename, mmap_mode="r")  # a valid .npy
    assert back.shape == (8, 64) and float(back[3, 3]) == 7.0
    path, jpath = mm.filename, jmm.filename
    assert os.path.basename(path).startswith("putpu_plane_")
    del back, mm, jmm
    gc.collect()
    # delete=True ties the file to the memmap; otherwise it persists
    assert os.path.exists(path) == os.path.exists(jpath) == (not delete)
    release_plane(SimpleNamespace(filename=path))
    jax_search.release_plane(SimpleNamespace(filename=jpath))
    assert not os.path.exists(path) and not os.path.exists(jpath)


def test_plane_dir_variable(tmp_path, monkeypatch):
    monkeypatch.setenv("PUTPU_PLANE_DIR", str(tmp_path))
    mm = plane_memmap(2, 16)
    jmm = jax_search.plane_memmap(2, 16)
    assert os.path.dirname(mm.filename) == os.path.dirname(jmm.filename) \
        == str(tmp_path)
    release_plane(mm)
    release_plane(mm)  # twice is safe
    release_plane(np.zeros(3))  # an in-memory plane: a no-op
    jax_search.release_plane(jmm)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("superblock", [512, 8])
def test_memmap_equals_dense_and_jax(tmp_path, monkeypatch, superblock):
    """The disk plane equals the dense capture bit for bit, with the same
    table, in one superblock and across many; and equals the JAX
    package's Pallas spill."""
    monkeypatch.setenv("PUTPU_PLANE_DIR", str(tmp_path))
    monkeypatch.setattr(search_ops, "SUPERBLOCK", superblock)
    search_ops._direct_sweep.cache_clear()
    data = make_data(nchan=16, t=1024)
    args = (100.0, 200.0, *GARGS)
    table, dense = dedispersion_search(data, *args, capture_plane=True,
                                       device="cpu")
    budget = BudgetAccountant()
    with budget.chunk(0):
        table_m, mm = dedispersion_search(data, *args,
                                          capture_plane="memmap",
                                          device="cpu")
    search_ops._direct_sweep.cache_clear()
    assert isinstance(mm, np.memmap) and mm.shape == tuple(dense.shape)
    assert os.path.dirname(mm.filename) == str(tmp_path)
    assert table.nrows > 8
    np.testing.assert_array_equal(np.asarray(mm), dense.numpy())
    for col in table.colnames:
        np.testing.assert_array_equal(table_m[col], table[col])
    spill = budget.to_json()["buckets_s"]
    assert "search/plane_spill" in spill
    assert budget.to_json()["counters"]["readbacks"] == \
        -(-table.nrows // superblock) + 1
    jtable, jmm = jax_dedispersion_search(data, *args, backend="jax",
                                          kernel="pallas",
                                          capture_plane="memmap")
    np.testing.assert_array_equal(np.asarray(mm), np.asarray(jmm))
    np.testing.assert_allclose(table_m["snr"], jtable["snr"], rtol=1e-5)
    release_plane(mm)
    release_plane(jmm)
    assert not os.listdir(tmp_path)


def test_memmap_plane_feeds_the_period_search(tmp_path, monkeypatch):
    monkeypatch.setenv("PUTPU_PLANE_DIR", str(tmp_path))
    data = make_data(nchan=16, t=2048, seed=3)
    _, mm = dedispersion_search(data, 100.0, 160.0, *GARGS,
                                capture_plane="memmap", device="cpu")
    _, dense = dedispersion_search(data, 100.0, 160.0, *GARGS,
                                   capture_plane=True, device="cpu")
    fmin = 4.0 / (mm.shape[1] * GARGS[2])
    res = period_search_plane(torch.from_numpy(np.asarray(mm)), GARGS[2],
                              fmin=fmin)
    ref = period_search_plane(dense, GARGS[2], fmin=fmin)
    assert np.isfinite(res["best_sigma"])
    assert res["best_sigma"] == ref["best_sigma"]
    release_plane(mm)


@pytest.mark.parametrize("kernel", ["fdmt", "hybrid", "fourier", "gather",
                                    "roll"])
def test_whole_plane_kernels_reject_memmap(kernel):
    data = make_data(nchan=16, t=1024)
    with pytest.raises(ValueError, match="memmap"):
        dedispersion_search(data, 100.0, 160.0, *GARGS, kernel=kernel,
                            capture_plane="memmap", device="cpu")
    with pytest.raises(ValueError, match="memmap"):
        jax_dedispersion_search(data, 100.0, 160.0, *GARGS, backend="jax",
                                kernel=kernel, capture_plane="memmap")


def test_failed_sweep_leaves_no_file(tmp_path, monkeypatch):
    """A sweep that fails mid-capture removes its half-written file (an
    OOM descent starts a new one)."""
    monkeypatch.setenv("PUTPU_PLANE_DIR", str(tmp_path))

    def boom(*args, **kwargs):
        raise RuntimeError("injected sweep failure")

    monkeypatch.setattr(search_ops, "dedisperse_plane", boom)
    with pytest.raises(RuntimeError, match="injected"):
        dedispersion_search(make_data(), 100.0, 160.0, *GARGS,
                            capture_plane="memmap", device="cpu")
    assert not os.listdir(tmp_path)
