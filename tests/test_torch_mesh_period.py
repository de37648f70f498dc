"""The periodicity workload on a mesh: the sharded trial sweeps of
``periodicity/accel.py`` and ``periodicity/fdas.py`` and
``periodicity_search(mesh=)``, against the port's single-device runs and
the JAX package's mesh programs, on the CPU.

The DM rows split over the mesh's ``dm`` axis and the trials over its
``chan`` axis, and each shard runs the single device's per-trial body on
its rows, so the port's mesh tables equal its single-device tables
exactly.  Against the JAX package's sharded programs (``xp=jnp``,
``mesh=``) the discrete fields are equal and the floats within the
tolerance the single-device tests hold (rtol 1e-5,
``tests/test_torch_periodicity.py``, ``tests/test_torch_fdas.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pulsarutils_tpu.models import simulate as jsim
from pulsarutils_tpu.io.sigproc import \
    write_simulated_filterbank as jax_write_filterbank
from pulsarutils_tpu.parallel.mesh import make_mesh as jax_mesh
from pulsarutils_tpu.periodicity import accel as jaccel
from pulsarutils_tpu.periodicity.driver import \
    periodicity_search as jax_periodicity_search
from pulsarutils_tpu.periodicity.fdas import fdas_search as jax_fdas_search

from pulsarutils_tpu_torch.parallel.mesh import make_mesh
from pulsarutils_tpu_torch.periodicity import accel as taccel
from pulsarutils_tpu_torch.periodicity.driver import periodicity_search
from pulsarutils_tpu_torch.periodicity.fdas import fdas_search
from pulsarutils_tpu_torch.tuning import autotune as ttune

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
RTOL = 1e-5
SHAPES = [(2, 2), (4, 1), (1, 4), (2, 4)]


@pytest.fixture(autouse=True)
def static_tuner(monkeypatch):
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")


def _assert_tables(ours, ref, exact=False):
    assert ours.keys() == ref.keys()
    for key in ref:
        if exact or np.asarray(ref[key]).dtype.kind in "iu":
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
        else:
            np.testing.assert_allclose(ours[key], ref[key], rtol=RTOL,
                                       err_msg=key)


@pytest.fixture(scope="module")
def accel_plane():
    arr, _ = jsim.simulate_accel_pulsar_data(
        freq=60.0, accel=2e5, nsamples=8192, nchan=8, rng=3)
    return (arr - arr.mean()).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_accel_search_on_a_mesh(accel_plane, shape):
    accels = np.linspace(-4e5, 4e5, 5)
    kw = dict(max_harmonics=8, fmin=5.0, topk=12)
    ours = taccel.accel_search(accel_plane, 5e-4, accels, device="cpu",
                               mesh=make_mesh(shape, devices=CPU8), **kw)
    single = taccel.accel_search(accel_plane, 5e-4, accels, device="cpu",
                                 **kw)
    _assert_tables(ours, single, exact=True)
    theirs = jaccel.accel_search(accel_plane, 5e-4, accels, xp=jnp,
                                 mesh=jax_mesh(shape), **kw)
    _assert_tables(ours, theirs)


@pytest.mark.parametrize("shape", [(2, 2), (3, 2), (1, 4)])
def test_fdas_search_on_a_mesh(shape):
    ndm, nsamples, tsamp = 6, 16384, 5e-4
    accels = np.linspace(-2.0e5, 2.0e5, 9)
    jerks = np.linspace(-5.0e4, 5.0e4, 5)
    f0 = int(round(0.175 * nsamples)) / (nsamples * tsamp)
    plane = ttune.synthetic_accel_plane(ndm, nsamples, tsamp, accels[6],
                                        jerk=jerks[3])
    kw = dict(jerks=jerks, max_harmonics=1, fmax=1.25 * f0, topk=8)
    ours = fdas_search(plane, tsamp, accels, device="cpu",
                       mesh=make_mesh(shape, devices=CPU8), **kw)
    single = fdas_search(plane, tsamp, accels, device="cpu", **kw)
    _assert_tables(ours, single, exact=True)
    theirs = jax_fdas_search(plane, tsamp, accels, xp=jnp,
                             mesh=jax_mesh(shape), **kw)
    _assert_tables(ours, theirs)
    assert (ours["dm_index"][0], ours["accel_index"][0],
            ours["jerk_index"][0]) == (ndm // 3, 6, 3)


def test_mesh_sweep_needs_both_axes(accel_plane):
    with pytest.raises(ValueError, match="must include"):
        taccel.accel_search(accel_plane, 5e-4, [0.0], device="cpu",
                            mesh=make_mesh((4,), ("dm",), devices=CPU8))


PSR = dict(freq=492 / (16384 * 0.0005), dm=150.0, accel=9.0e5,
           tsamp=0.0005, nsamples=16384, nchan=32, rng=13)
JOB = dict(dmmin=130.0, dmmax=170.0, accel_max=1.8e6, n_accel=9,
           sigma_threshold=8.0, chunk_length=4096 * 0.0005,
           snr_threshold=8.0)


@pytest.fixture(scope="module")
def pulsar_file(tmp_path_factory):
    arr, hdr = jsim.simulate_accel_pulsar_data(**PSR)
    path = tmp_path_factory.mktemp("psr_mesh") / "binary.fil"
    jax_write_filterbank(str(path), arr, hdr, descending=True)
    return str(path)


def _top(res):
    best = res["candidates"][0]
    return (best["dm"], best["accel"], best["freq_bin"], best["nharm"])


@pytest.mark.parametrize("backend", ["time_stretch", "fdas"])
def test_periodicity_search_on_a_mesh(pulsar_file, tmp_path, backend):
    mesh = make_mesh((2, 2), devices=CPU8)
    # FDAS on the CPU is slow: three acceleration trials keep it short
    job = JOB if backend == "time_stretch" else dict(JOB, n_accel=3)
    ours = periodicity_search(pulsar_file, output_dir=str(tmp_path / "m"),
                              device="cpu", mesh=mesh,
                              accel_backend=backend, **job)
    single = periodicity_search(pulsar_file, output_dir=str(tmp_path / "s"),
                                device="cpu", accel_backend=backend, **job)
    assert ours["complete"] and ours["fingerprint"] != single["fingerprint"]
    assert _top(ours) == _top(single)
    if backend == "time_stretch":
        # (the JAX package's FDAS mesh sweep is held cell for cell above;
        # its whole job on a mesh takes ~40 s on the CPU)
        theirs = jax_periodicity_search(
            pulsar_file, output_dir=str(tmp_path / "j"), backend="jax",
            mesh=jax_mesh((2, 2)), accel_backend=backend, **JOB)
        assert _top(ours) == _top(theirs)
    best = ours["candidates"][0]
    assert abs(best["dm"] - PSR["dm"]) < 3.0
