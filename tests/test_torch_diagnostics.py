"""The port's diagnostic figures on the CPU, held against the JAX package.

The same candidate (table and plane from the JAX package's NumPy search,
the chunk as float32) goes through both packages' figure builders; every
plotted array is compared.  Tolerances: the S/N curve, the trial DMs and
the time axes are equal bit for bit (no arithmetic differs); the light
curves, the decimated images and the H curve are reductions in another
order (torch against NumPy), within rtol 1e-5, the H curve with its
argmax equal.  An image wider than ``MAX_IMAGE_COLUMNS`` is the JAX
image summed further in time.  Then the driver: one JPEG a hit under
``"hits"``, one a chunk under ``"all"``, none when plots are off or
matplotlib is missing, each figure written before its chunk is marked
done, and the candidates and ledger unchanged by plotting.
"""
import builtins
import json
import logging
import os
from pathlib import Path

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg", force=True)
import matplotlib.pyplot as plt  # noqa: E402

from pulsarutils_tpu.ops.dedisperse import \
    apply_dm_shifts_to_data as jax_apply_shifts  # noqa: E402
from pulsarutils_tpu.ops.rebin import quick_resample as jax_resample  # noqa
from pulsarutils_tpu.ops.search import \
    dedispersion_search as jax_search  # noqa: E402
from pulsarutils_tpu.pipeline import diagnostics as jax_diag  # noqa: E402
from pulsarutils_tpu.pipeline.pulse_info import \
    PulseInfo as JaxPulseInfo  # noqa: E402

from pulsarutils_tpu_torch.io.sigproc import \
    write_simulated_filterbank  # noqa: E402
from pulsarutils_tpu_torch.models.simulate import (  # noqa: E402
    simulate_pulsar_data, simulate_test_data)
from pulsarutils_tpu_torch.obs.metrics import REGISTRY  # noqa: E402
from pulsarutils_tpu_torch.ops.dedisperse import \
    apply_dm_shifts_to_data  # noqa: E402
from pulsarutils_tpu_torch.pipeline import diagnostics  # noqa: E402
from pulsarutils_tpu_torch.pipeline.pulse_info import PulseInfo  # noqa
from pulsarutils_tpu_torch.pipeline.search_pipeline import \
    search_by_chunks  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-5
SEARCH = dict(dmmin=100.0, dmmax=200.0, chunk_length=1.024,
              snr_threshold=6.0)


@pytest.fixture(autouse=True)
def clean_state():
    """The port's process-wide registry, reset after each test."""
    yield
    REGISTRY.reset()


def _candidate(nchan, nsamples, pulsar=False):
    """A chunk, and the JAX package's NumPy table and plane of it."""
    if pulsar:
        array, header = simulate_pulsar_data(
            period=0.032, dm=150.0, tsamp=0.0005, nsamples=nsamples,
            nchan=nchan, signal=1.5, noise=0.3, rng=23)
    else:
        array, header = simulate_test_data(150, nchan=nchan,
                                           nsamples=nsamples, signal=2.0,
                                           noise=0.4, rng=17)
    array = np.asarray(array, dtype=np.float32)
    table, plane = jax_search(array, 100, 200.0, header["fbottom"],
                              header["bandwidth"], header["tsamp"],
                              backend="numpy", show=True)
    geometry = dict(start_freq=header["fbottom"],
                    bandwidth=header["bandwidth"], nbin=nsamples,
                    nchan=nchan, date="2026-07-30",
                    pulse_freq=1.0 / (nsamples * header["tsamp"]))
    return array, np.asarray(plane, dtype=np.float32), table, geometry


def test_apply_dm_shifts_equals_jax():
    rng = np.random.default_rng(3)
    data = rng.standard_normal((37, 1001)).astype(np.float32)
    shifts = rng.uniform(-1500.0, 1500.0, 37)
    want = jax_apply_shifts(data, shifts)
    got = apply_dm_shifts_to_data(torch.from_numpy(data), shifts,
                                  chan_block=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plane_h_test_equals_jax():
    _, plane, table, _ = _candidate(32, 4096, pulsar=True)
    h, m = diagnostics.plane_h_test(torch.from_numpy(plane))
    jh, jm = jax_diag.plane_h_test(plane)
    np.testing.assert_allclose(h, jh, rtol=RTOL)
    assert np.argmax(h) == np.argmax(jh)
    np.testing.assert_array_equal(m, jm)
    dms = np.asarray(table["DM"])
    assert abs(dms[np.argmax(h)] - 150) <= 5.0


def _figure_arrays(axes):
    lines = {k: axes[k].lines[0].get_data() for k in
             ("snr", "h", "lc_raw", "lc_dedisp")}
    images = {k: (np.asarray(axes[k].collections[0].get_array()),
                  axes[k].collections[0].get_coordinates())
              for k in ("raw", "dedisp", "plane")}
    return lines, images


@pytest.mark.parametrize("nsamples", [2048, 5000])
def test_figure_arrays_equal_jax(nsamples):
    array, plane, table, geometry = _candidate(32, nsamples)
    ours, axes = diagnostics.build_diagnostic_figure(
        PulseInfo(allprofs=torch.from_numpy(array), **geometry), table,
        torch.from_numpy(plane), t0=2.0)
    theirs, jaxes = jax_diag.build_diagnostic_figure(
        JaxPulseInfo(allprofs=array, **geometry), table, plane, t0=2.0)
    try:
        lines, images = _figure_arrays(axes)
        jlines, jimages = _figure_arrays(jaxes)
        # the S/N curve, the trial DMs and the time axes: bit for bit
        np.testing.assert_array_equal(lines["snr"][0], jlines["snr"][0])
        for key in ("snr", "h"):
            np.testing.assert_array_equal(lines[key][1], jlines[key][1])
        for key in ("lc_raw", "lc_dedisp"):
            np.testing.assert_array_equal(lines[key][0], jlines[key][0])
        np.testing.assert_allclose(lines["h"][0], jlines["h"][0], rtol=RTOL)
        assert np.argmax(-lines["h"][0]) == np.argmax(-jlines["h"][0])
        for key in ("lc_raw", "lc_dedisp"):
            np.testing.assert_allclose(lines[key][1], jlines[key][1],
                                       rtol=RTOL, atol=RTOL)
        window = int(table["rebin"][table.argbest("snr")])
        for key in ("raw", "dedisp", "plane"):
            img, coords = images[key]
            want, jcoords = jimages[key]
            extra = -(-want.shape[1] // diagnostics.MAX_IMAGE_COLUMNS)
            if extra > 1:    # wider than the cap: summed further in time
                want = jax_resample(want, extra)
            assert img.shape == want.shape
            np.testing.assert_allclose(img, want, rtol=RTOL, atol=RTOL)
            # the mesh's edges: the JAX package's when no cap applies
            if extra == 1:
                np.testing.assert_allclose(coords, jcoords, rtol=1e-12)
            sample_time = 1.0 / geometry["pulse_freq"] / geometry["nbin"]
            assert coords[0, -1, 0] == pytest.approx(
                2.0 + img.shape[1] * sample_time * window * extra)
        assert [t.get_text() for t in axes["snr"].texts] == \
            [t.get_text() for t in jaxes["snr"].texts]
    finally:
        plt.close(ours)
        plt.close(theirs)


def test_plot_renders_a_jpeg(tmp_path):
    array, plane, table, geometry = _candidate(32, 2048)
    info = PulseInfo(allprofs=array[:, :100], **geometry)
    out = str(tmp_path / "cand.jpg")
    diagnostics.plot_diagnostics(info, table, torch.from_numpy(plane),
                                 outname=out, t0=1.5,
                                 waterfall=torch.from_numpy(array))
    assert os.path.getsize(out) > 10_000


# -- the driver --------------------------------------------------------------

@pytest.fixture(scope="module")
def pulse_file(tmp_path_factory):
    array, header = simulate_test_data(150.0, nsamples=16384, nchan=32,
                                       signal=10.0, noise=4.0, rng=7)
    path = tmp_path_factory.mktemp("diag") / "pulse.fil"
    write_simulated_filterbank(str(path), array + 20.0, header,
                               descending=True, nbits=8)
    return str(path)


def _outputs(out):
    names = sorted(os.listdir(out))
    npz = {}
    for name in names:
        if name.endswith(".npz"):
            with np.load(os.path.join(out, name), allow_pickle=False) as d:
                npz[name] = {k: d[k].tobytes() for k in d.files}
    ledger = [n for n in names if n.startswith("progress_")]
    return names, npz, Path(out, ledger[0]).read_bytes()


def test_driver_plots_hits_before_marking_them(pulse_file, tmp_path,
                                               monkeypatch):
    real = diagnostics.plot_diagnostics
    seen = []

    def checked(info, table, plane, outname, **kw):
        # the chunk is not in the ledger yet when its figure is written
        ledger = next(Path(outname).parent.glob("progress_*.json"), None)
        done = json.loads(ledger.read_text())["done"] if ledger else []
        assert info.istart not in done
        seen.append(info.istart)
        return real(info, table, plane, outname, **kw)

    monkeypatch.setattr(diagnostics, "plot_diagnostics", checked)
    off, _ = search_by_chunks(pulse_file, device="cpu", make_plots=False,
                              output_dir=str(tmp_path / "off"), **SEARCH)
    hits, _ = search_by_chunks(pulse_file, device="cpu",
                               output_dir=str(tmp_path / "hits"), **SEARCH)
    assert hits and seen == [h[0] for h in hits]
    names, npz, ledger = _outputs(tmp_path / "hits")
    jpegs = [n for n in names if n.endswith(".jpg")]
    assert jpegs == sorted(f"pulse_{h[0]}-{h[1]}.jpg" for h in hits)
    # plotting changes no ledger byte and no table byte; the persisted
    # record gains the dedispersed profile of the captured plane, as the
    # JAX package's does when its plots capture the plane
    off_names, off_npz, off_ledger = _outputs(tmp_path / "off")
    assert ledger == off_ledger
    assert [n for n in names if not n.endswith(".jpg")] == off_names
    for name, arrays in npz.items():
        if name.endswith(".table.npz"):
            assert arrays == off_npz[name]
        else:
            assert {k: v for k, v in arrays.items() if k != "__scalars__"
                    and k != "dedisp_profile"} == \
                {k: v for k, v in off_npz[name].items()
                 if k != "__scalars__"}
            assert "dedisp_profile" in arrays


def test_driver_plots_every_chunk_under_all(pulse_file, tmp_path):
    hits, store = search_by_chunks(pulse_file, device="cpu",
                                   make_plots="all",
                                   output_dir=str(tmp_path), **SEARCH)
    jpegs = sorted(p.name for p in tmp_path.glob("*.jpg"))
    assert len(jpegs) == len(store.done_chunks) == 7
    assert len(hits) < len(jpegs)


def test_driver_without_matplotlib_warns_and_plots_nothing(
        pulse_file, tmp_path, monkeypatch, caplog):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("no matplotlib here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with caplog.at_level(logging.WARNING, logger="pulsarutils_tpu_torch"):
        hits, _ = search_by_chunks(pulse_file, device="cpu",
                                   output_dir=str(tmp_path), **SEARCH)
    assert hits
    assert not list(tmp_path.glob("*.jpg"))
    assert any("matplotlib not installed" in r.getMessage()
               for r in caplog.records)
