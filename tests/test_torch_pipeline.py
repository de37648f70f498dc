"""The slice end to end on the CPU: the port's ``search_by_chunks`` against
the JAX package's default direct-sweep driver (``kernel="pallas"``) on
small simulated 8-bit files, resume, the CLI, and the rule that the port
imports nothing of JAX or of the JAX package."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pulsarutils_tpu.pipeline.search_pipeline import \
    search_by_chunks as jax_search_by_chunks
from pulsarutils_tpu.pipeline.sift import sift_hits as jax_sift_hits

from pulsarutils_tpu_torch.cli import search_main
from pulsarutils_tpu_torch.io.sigproc import (FilterbankReader,
                                              write_simulated_filterbank)
from pulsarutils_tpu_torch.models.simulate import simulate_test_data
from pulsarutils_tpu_torch.ops.search import release_plane
from pulsarutils_tpu_torch.pipeline import search_pipeline
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks
from pulsarutils_tpu_torch.pipeline.sift import sift_hits

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PULSE_DM = 150.0
NSAMPLES = 16384
SEARCH = dict(dmmin=100.0, dmmax=200.0, chunk_length=1.024,
              snr_threshold=6.0)


def _write_pulse_file(path, descending):
    """An 8-bit file with one dispersed pulse at sample NSAMPLES // 2."""
    array, header = simulate_test_data(PULSE_DM, nsamples=NSAMPLES, nchan=32,
                                       signal=10.0, noise=4.0, rng=7)
    write_simulated_filterbank(str(path), array + 20.0, header,
                               descending=descending, nbits=8)
    return str(path)


@pytest.fixture(scope="module", params=["ascending", "descending"])
def reference(request, tmp_path_factory):
    """The file, and the JAX package's hits and ledger on it."""
    tmp = tmp_path_factory.mktemp(request.param)
    path = _write_pulse_file(tmp / "pulse.fil",
                             descending=request.param == "descending")
    hits, store = jax_search_by_chunks(
        path, backend="jax", kernel="pallas", make_plots=False,
        output_dir=str(tmp / "jax"), **SEARCH)
    return path, hits, store.done_chunks


def _assert_same_hits(ours, ref):
    assert [(h[0], h[1]) for h in ours] == [(h[0], h[1]) for h in ref]
    for (_, _, info, table), (_, _, rinfo, rtable) in zip(ours, ref):
        best, rbest = table.best_row(), rtable.best_row()
        assert best["DM"] == rbest["DM"]
        assert best["rebin"] == rbest["rebin"]
        assert best["peak"] == rbest["peak"]
        np.testing.assert_allclose(best["snr"], rbest["snr"], rtol=1e-5)
        np.testing.assert_allclose(table["snr"], rtable["snr"], rtol=1e-5)
        assert info.dm == rinfo.dm
        assert info.width == rinfo.width


def test_slice_matches_jax_driver(reference, tmp_path):
    path, ref_hits, ref_done = reference
    hits, store = search_by_chunks(path, device="cpu",
                                   output_dir=str(tmp_path), **SEARCH)
    assert hits, "the injected pulse was not found"
    _assert_same_hits(hits, ref_hits)
    assert store.done_chunks == ref_done
    ledger = json.loads(Path(store._ledger_path).read_text())
    assert ledger["done"] == ref_done
    # the strongest hit's chunk contains the pulse, at the injected DM
    istart, iend, info, _ = max(hits, key=lambda h: h[2].snr)
    assert istart <= NSAMPLES // 2 < iend
    assert abs(info.dm - PULSE_DM) < 1.0
    # the persisted candidates load back
    for istart, iend, info, table in hits:
        linfo, ltable = store.load_candidate("pulse", istart, iend)
        assert linfo.dm == info.dm and linfo.disp_H == info.disp_H
        np.testing.assert_array_equal(ltable["snr"], table["snr"])
    # both sifts keep the same candidates
    ours = [(c["time"], c["dm"], c["n_members"]) for c in sift_hits(hits)]
    theirs = [(c["time"], c["dm"], c["n_members"])
              for c in jax_sift_hits(ref_hits)]
    assert ours == theirs and ours


def test_resume_searches_only_missing_chunks(reference, tmp_path,
                                             monkeypatch):
    path, ref_hits, ref_done = reference
    searched = []
    real = search_pipeline.dedispersion_search

    def counting(array, *args, **kwargs):
        searched.append(array.shape)
        return real(array, *args, **kwargs)

    monkeypatch.setattr(search_pipeline, "dedispersion_search", counting)
    _, store = search_by_chunks(path, device="cpu", max_chunks=3,
                                output_dir=str(tmp_path), **SEARCH)
    assert store.done_chunks == ref_done[:3] and len(searched) == 3
    hits, store = search_by_chunks(path, device="cpu",
                                   output_dir=str(tmp_path), **SEARCH)
    assert len(searched) == len(ref_done)   # only the missing chunks
    assert store.done_chunks == ref_done
    _assert_same_hits(hits, ref_hits)       # earlier hits restored
    search_by_chunks(path, device="cpu", output_dir=str(tmp_path), **SEARCH)
    assert len(searched) == len(ref_done)   # nothing left to search


@pytest.mark.parametrize("nbits", [8, 16, 32])
@pytest.mark.parametrize("descending", [False, True])
def test_reader_block_tensor_equals_jax_reader(tmp_path, nbits, descending):
    from pulsarutils_tpu.io.sigproc import FilterbankReader as JaxReader

    rng = np.random.default_rng(nbits)
    array = rng.uniform(0, 250 if nbits == 8 else 6e4, (24, 700))
    header = {"bandwidth": 200., "fbottom": 1200., "nchans": 24,
              "nsamples": 700, "tsamp": 5e-4}
    path = str(tmp_path / "f.fil")
    write_simulated_filterbank(path, array, header, descending=descending,
                               nbits=nbits)
    ours, ref = FilterbankReader(path), JaxReader(path)
    assert ours.header == ref.header
    block = ours.read_block_tensor(100, 500, "cpu")
    assert block.dtype == torch.float32 and block.is_contiguous()
    expect = ref.read_block(100, 500, band_ascending=True)
    np.testing.assert_array_equal(block.numpy(), expect.astype(np.float32))
    np.testing.assert_array_equal(ours.read_block(100, 500), ref.read_block(
        100, 500))
    if nbits < 32:  # the writer rounds like the JAX package's
        np.testing.assert_array_equal(
            expect, np.rint(array)[:, 100:600])


def test_cli_searches_and_sifts(reference, tmp_path):
    path = reference[0]
    rc = search_main.main([path, "--dmmin", "100", "--dmmax", "200",
                           "--chunk-length", "1.024", "--snr-threshold", "6",
                           "--output-dir", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    assert list(tmp_path.glob("progress_*.json"))
    assert list(tmp_path.glob("pulse_*.info.npz"))
    rc = search_main.main([path, "--dmmin", "100", "--dmmax", "200",
                           "--chunk-length", "1.024", "--kernel", "hybrid",
                           "--snr-threshold", "certifiable",
                           "--output-dir", str(tmp_path / "hybrid"),
                           "--device", "cpu"])
    assert rc == 0
    assert list((tmp_path / "hybrid").glob("pulse_*.info.npz"))
    with pytest.raises(SystemExit):
        search_main.build_parser().parse_args([path, "--snr-threshold",
                                               "loose"])
    rc = search_main.main([path, "--dmmin", "100", "--dmmax", "200",
                           "--chunk-length", "1.024", "--kernel", "fourier",
                           "--snr-threshold", "6", "--period-search",
                           "--output-dir", str(tmp_path / "fourier"),
                           "--device", "cpu"])
    assert rc == 0
    assert list((tmp_path / "fourier").glob("pulse_*.info.npz"))
    rc = search_main.main([path, "--dmmin", "100", "--dmmax", "200",
                           "--chunk-length", "1.024", "--kernel", "gather",
                           "--snr-threshold", "6",
                           "--output-dir", str(tmp_path / "gather"),
                           "--device", "cpu"])
    assert rc == 0
    assert list((tmp_path / "gather").glob("pulse_*.info.npz"))
    # roll stays API-only, as in the JAX CLI
    with pytest.raises(SystemExit):
        search_main.build_parser().parse_args([path, "--kernel", "roll"])
    # the disk-spilled plane, once the last feature left out, is ported
    os.environ["PUTPU_PLANE_DIR"] = str(tmp_path)
    try:
        table, plane = search_pipeline.dedispersion_search(
            np.zeros((32, 256), np.float32), 100.0, 200.0, 1200.0, 200.0,
            5e-4, capture_plane="memmap", device="cpu")
    finally:
        del os.environ["PUTPU_PLANE_DIR"]
    assert isinstance(plane, np.memmap)
    assert plane.shape == (table.nrows, 256)
    assert os.path.dirname(plane.filename) == str(tmp_path)
    release_plane(plane)
    assert not os.path.exists(plane.filename)


def _port_sources():
    # _build/ holds build products and scratch, not sources
    package = REPO / "pulsarutils_tpu_torch"
    files = sorted(p for p in package.rglob("*.py")
                   if "_build" not in p.relative_to(package).parts)
    return files + [REPO / "chip_smoke.py"]


def test_port_sources_cover_the_live_feed_and_the_service():
    walked = {str(p.relative_to(REPO)) for p in _port_sources()}
    for name in ("ingest/__init__.py", "ingest/assembler.py",
                 "ingest/source.py", "io/packets.py",
                 "resilience/shedding.py", "beams/service.py",
                 "cli/ingest_main.py"):
        assert f"pulsarutils_tpu_torch/{name}" in walked, name


def test_port_sources_cover_the_fleet():
    walked = {str(p.relative_to(REPO)) for p in _port_sources()}
    for name in ("fleet/__init__.py", "fleet/protocol.py",
                 "fleet/journal.py", "fleet/coordinator.py",
                 "fleet/worker.py", "cli/fleet_main.py",
                 "obs/collector.py", "obs/slo.py", "obs/timeseries.py",
                 "obs/capacity.py"):
        assert f"pulsarutils_tpu_torch/{name}" in walked, name


def _forbidden(module):
    return (module == "jax" or module.startswith("jax.")
            or module == "pulsarutils_tpu"
            or module.startswith("pulsarutils_tpu."))


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_cpu_search_loads_no_jax(tmp_path):
    path = _write_pulse_file(tmp_path / "pulse.fil", descending=True)
    code = f"""
import sys
import pulsarutils_tpu_torch
hits, _ = pulsarutils_tpu_torch.search_by_chunks(
    {path!r}, dmmin=100.0, dmmax=200.0, chunk_length=1.024, device="cpu",
    output_dir={str(tmp_path / 'out')!r})
assert hits
# the hybrid path: FDMT, scorer, certificate, rescore
hits, _ = pulsarutils_tpu_torch.search_by_chunks(
    {path!r}, dmmin=100.0, dmmax=200.0, chunk_length=1.024, device="cpu",
    kernel="hybrid", snr_threshold="certifiable",
    output_dir={str(tmp_path / 'hybrid')!r})
assert hits
# the gather formulation under a precision policy
import os
from pulsarutils_tpu_torch.precision import COUNTS
os.environ["PUTPU_PRECISION"] = "f32_compensated"
hits, _ = pulsarutils_tpu_torch.search_by_chunks(
    {path!r}, dmmin=100.0, dmmax=200.0, chunk_length=1.024, device="cpu",
    kernel="gather", output_dir={str(tmp_path / 'gather')!r})
assert hits
assert COUNTS[("putpu_precision_compensated_engagements_total",
               "f32_compensated")] > 0
del os.environ["PUTPU_PRECISION"]
# the accounting and reporting layers: plots, the span and device traces,
# the canary, lineage, the report and the HTTP surface
from pulsarutils_tpu_torch.obs import trace
out = {str(tmp_path / 'observe')!r}
with trace.trace_session(out + ".json", device_trace_dir=out + "_device"):
    hits, _ = pulsarutils_tpu_torch.search_by_chunks(
        {path!r}, dmmin=100.0, dmmax=200.0, chunk_length=1.024,
        device="cpu", canary=1.0, lineage=True, http_port=0,
        report_out=out + "_report", output_dir=out)
assert hits
# the hybrid's fused seed program (the plain kernels) and the FDAS backend
import numpy as np
import torch
from pulsarutils_tpu_torch.ops import search
from pulsarutils_tpu_torch.ops.plan import dedispersion_plan
from pulsarutils_tpu_torch.periodicity import fdas_search
x = torch.from_numpy(np.random.default_rng(3).standard_normal(
    (16, 2048)).astype(np.float32))
dms = dedispersion_plan(16, 100.0, 200.0, 1200.0, 200.0, 5e-4)
assert search._search_hybrid(x, dms, 1200.0, 200.0, 5e-4, False,
                             fused=True)[5].any()
table = fdas_search(x[:4], 5e-4, [-1e5, 0.0, 1e5], topk=4, device="cpu")
assert len(table["sigma"]) == 4
bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
       or k == "pulsarutils_tpu" or k.startswith("pulsarutils_tpu.")]
assert not bad, bad
print("clean")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")
