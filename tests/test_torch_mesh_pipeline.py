"""``search_by_chunks(mesh=)`` and the mesh tuner key against the JAX
package and the port's single-device run, on the CPU.

The chunk loop's mesh route (``pipeline/search_pipeline.py``) sends
every chunk through the sharded searches; one process drives the mesh,
so the reader thread, the persist worker and the ledger are the
single-device loop's.  On a small 8-bit file the mesh run finds the
single-device run's hits (discrete fields equal, S/N within the JAX
package's mesh tolerance rtol 1e-4) and writes the same ledger: its
``done`` list is equal, and its bytes are the single-device ledger's
with the fingerprint (which holds the mesh shape, as in the JAX
package) swapped.  A ``chan = 1`` mesh gives the single-device tables
bit for bit.  The JAX package's mesh run finds the same hits.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pulsarutils_tpu.parallel.mesh import make_mesh as jax_mesh
from pulsarutils_tpu.pipeline.search_pipeline import (
    search_by_chunks as jax_search_by_chunks)
from pulsarutils_tpu.tuning import autotune as jat

from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec
from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
from pulsarutils_tpu_torch.models.simulate import simulate_test_data
from pulsarutils_tpu_torch.parallel import mesh as tmesh
from pulsarutils_tpu_torch.parallel import sharded as tsharded
from pulsarutils_tpu_torch.parallel.mesh import make_mesh
from pulsarutils_tpu_torch.pipeline import search_pipeline
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks
from pulsarutils_tpu_torch.resilience import ladder
from pulsarutils_tpu_torch.tuning import autotune as tat
from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
NSAMPLES = 16384
SEARCH = dict(dmmin=100.0, dmmax=200.0, chunk_length=1.024,
              snr_threshold=6.0)
#: the JAX package's mesh tolerance on the float scores
MESH_RTOL = 1e-4


@pytest.fixture(autouse=True)
def static_tuner(monkeypatch):
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")
    ladder.reset()
    yield
    ladder.reset()


@pytest.fixture(scope="module")
def pulse_file(tmp_path_factory):
    array, header = simulate_test_data(150.0, nsamples=NSAMPLES, nchan=32,
                                       signal=10.0, noise=4.0, rng=7)
    path = tmp_path_factory.mktemp("mesh") / "pulse.fil"
    write_simulated_filterbank(str(path), array + 20.0, header,
                               descending=True, nbits=8)
    return str(path)


def _run(path, out, kernel="auto", mesh=None, **kw):
    summary = {}
    budget = BudgetAccountant()
    hits, store = search_by_chunks(path, device="cpu", output_dir=str(out),
                                   make_plots=False, kernel=kernel,
                                   mesh=mesh, summary=summary, budget=budget,
                                   **{**SEARCH, **kw})
    ledger = Path(store._ledger_path).read_text()
    return hits, store, ledger, summary, budget


def _assert_same_hits(ours, ref, rtol=MESH_RTOL, exact=False):
    assert [(h[0], h[1]) for h in ours] == [(h[0], h[1]) for h in ref]
    assert ours
    for (_, _, info, table), (_, _, rinfo, rtable) in zip(ours, ref):
        for col in ("DM", "rebin", "peak"):
            np.testing.assert_array_equal(np.asarray(table[col]),
                                          np.asarray(rtable[col]))
        assert table.argbest() == rtable.argbest()
        assert info.dm == rinfo.dm and info.width == rinfo.width
        if exact:
            np.testing.assert_array_equal(table["snr"], rtable["snr"])
        else:
            np.testing.assert_allclose(table["snr"], rtable["snr"],
                                       rtol=rtol)


@pytest.mark.parametrize("kernel, shape", [("auto", (2, 2)),
                                           ("hybrid", (2, 2)),
                                           ("pallas", (4, 1))])
def test_mesh_run_equals_the_single_device_run(pulse_file, tmp_path, kernel,
                                               shape):
    mesh = make_mesh(shape, devices=CPU8)
    ours = _run(pulse_file, tmp_path / "mesh", kernel, mesh)
    single = _run(pulse_file, tmp_path / "one", kernel)
    hits, store, ledger, summary, budget = ours
    _assert_same_hits(hits, single[0], exact=shape[1] == 1)
    assert store.done_chunks == single[1].done_chunks
    assert summary["fallback"] is None and summary["oom_descents"] == 0
    # the ledger: the single-device ledger's bytes, the fingerprint
    # (which holds the mesh shape) swapped
    assert store.fingerprint != single[1].fingerprint
    assert ledger == single[2].replace(single[1].fingerprint,
                                       store.fingerprint)
    record = budget.to_json()
    assert record["mesh"] == list(shape)
    assert "mesh" not in single[4].to_json()
    assert record["counters"]["dispatches"] >= record["chunks"]


@pytest.mark.parametrize("kernel", ["auto", "hybrid"])
def test_mesh_run_finds_the_jax_mesh_runs_hits(pulse_file, tmp_path, kernel):
    hits, store = _run(pulse_file, tmp_path / "port", kernel,
                       make_mesh((4, 2), devices=CPU8))[:2]
    jhits, jstore = jax_search_by_chunks(
        pulse_file, backend="jax", kernel=kernel, make_plots=False,
        mesh=jax_mesh((4, 2)), output_dir=str(tmp_path / "jax"), **SEARCH)
    _assert_same_hits(hits, jhits)
    assert json.loads(Path(jstore._ledger_path).read_text())["done"] \
        == store.done_chunks


def test_period_search_and_figures_on_the_mesh(pulse_file, tmp_path):
    pytest.importorskip("matplotlib")
    mesh = make_mesh((4, 1), devices=CPU8)
    kw = dict(period_search=True, max_chunks=4)
    hits, store = search_by_chunks(pulse_file, device="cpu", mesh=mesh,
                                   kernel="pallas", make_plots="all",
                                   output_dir=str(tmp_path / "mesh"),
                                   **{**SEARCH, **kw})
    ref, _ = search_by_chunks(pulse_file, device="cpu", kernel="pallas",
                              make_plots=False,
                              output_dir=str(tmp_path / "one"),
                              **{**SEARCH, **kw})
    # a chan = 1 mesh: the single-device planes, so the same hits and
    # period fields
    _assert_same_hits(hits, ref, exact=True)
    for (_, _, info, _), (_, _, rinfo, _) in zip(hits, ref):
        assert info.period_freq == rinfo.period_freq
        assert info.period_sigma == rinfo.period_sigma
        np.testing.assert_array_equal(info.dedisp_profile,
                                      rinfo.dedisp_profile)
    figures = sorted(p.name for p in (tmp_path / "mesh").glob("*.jpg"))
    assert len(figures) == len(store.done_chunks) == 4


def test_axis_check_raises_before_reading(tmp_path):
    dm_only = make_mesh((8,), ("dm",), devices=CPU8)
    missing = str(tmp_path / "missing.fil")
    for search, mesh, kw in (
            (search_by_chunks, dm_only, {"device": "cpu"}),
            (jax_search_by_chunks, jax_mesh((8,), ("dm",)),
             {"backend": "jax"})):
        with pytest.raises(ValueError, match="must include"):
            search(missing, mesh=mesh, kernel="auto", **kw)
    with pytest.raises(ValueError, match="are not of"):
        search_by_chunks(missing, mesh=make_mesh((2, 2), devices=CPU8),
                         device="cuda")


def test_fdmt_takes_a_dm_only_mesh(pulse_file, tmp_path):
    mesh = make_mesh((4,), ("dm",), devices=CPU8)
    hits = _run(pulse_file, tmp_path / "mesh", "fdmt", mesh, max_chunks=6)[0]
    ref = _run(pulse_file, tmp_path / "one", "fdmt", max_chunks=6)[0]
    _assert_same_hits(hits, ref, exact=True)


def test_mesh_fault_site_fires(pulse_file, tmp_path):
    mesh = make_mesh((2, 2), devices=CPU8)
    # a transient mesh error is retried on the mesh
    plan = FaultPlan([FaultSpec(site="mesh", kind="error", times=1)])
    with plan.armed():
        hits, store, _, summary, _ = _run(pulse_file, tmp_path / "t",
                                          mesh=mesh, max_chunks=3)
    assert plan.fired("mesh") == 1 and summary["fallback"] is None
    # a persistent one: a CPU mesh falls back to the host path, loudly,
    # as the JAX package's mesh run falls back to NumPy
    plan = FaultPlan([FaultSpec(site="mesh", kind="error", times=None)])
    with plan.armed():
        _, _, _, summary, _ = _run(pulse_file, tmp_path / "p", mesh=mesh,
                                   max_chunks=3)
    assert plan.fired("mesh") >= 2
    assert summary["fallback"]["device"] == "cpu"


@pytest.mark.parametrize("kind, raises", [("error", RuntimeError),
                                          ("oom", None)])
def test_card_mesh_never_falls_back(monkeypatch, kind, raises):
    """On a CUDA mesh a persistent mesh error propagates after the retry
    and an OOM is quarantined as ``oom_floor``: nothing runs on the CPU
    and nothing is recorded as a fallback."""
    calls = []

    def host_search(*args, **kwargs):
        calls.append("host")
        return "table"

    monkeypatch.setattr(search_pipeline, "dedispersion_search", host_search)
    monkeypatch.setattr(tsharded, "sharded_dedispersion_search",
                        lambda *a, **k: calls.append("mesh") or "table")
    card = tmesh.make_mesh((2, 2), devices=[torch.device("cuda:0")] * 4)
    state = {}
    plan = FaultPlan([FaultSpec(site="mesh", kind=kind, times=None)])
    with plan.armed(), pytest.raises(raises or ladder.OOMFloorError):
        search_pipeline._search_with_fallback(
            None, 100, 200, 1200., 200., 5e-4, device=torch.device("cuda"),
            kernel="auto", capture_plane=False, state=state, ndm=64,
            chunk=0, mesh=card)
    assert calls == [] and state == {}
    assert plan.fired("mesh") == (2 if kind == "error" else 1)


# -- the tuner -----------------------------------------------------------------

@pytest.fixture
def fresh_tuners(monkeypatch, tmp_path):
    monkeypatch.setenv("PUTPU_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("PUTPU_AUTOTUNE", "on")
    prev = tat.set_tuner(None), jat.set_tuner(None)
    yield
    tat.set_tuner(prev[0])
    jat.set_tuner(prev[1])


@pytest.mark.parametrize("all_card", [True, False])
@pytest.mark.parametrize("f32", [True, False])
def test_static_mesh_kernel_equals_jax(all_card, f32):
    assert tat.static_mesh_kernel(all_card, f32) \
        == jat.static_mesh_kernel(all_card, f32)


def test_cpu_mesh_key_and_static_choice_equal_jax(fresh_tuners):
    import jax.numpy as jnp

    array, header = simulate_test_data(150.0, nsamples=1024, nchan=32,
                                       rng=3)
    geom = (header["fbottom"], header["bandwidth"], header["tsamp"])
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan

    dms = dedispersion_plan(32, 100.0, 200.0, *geom)
    mark, jmark = tat.decision_seq(), jat.decision_seq()
    ours = tat.resolve_mesh_kernel(make_mesh((4, 2), devices=CPU8), 32,
                                   1024, len(dms), *geom, dms)
    theirs = jat.resolve_mesh_kernel(jax_mesh((4, 2)), 32, 1024, len(dms),
                                     *geom, dms, dtype=jnp.float32)
    assert ours == theirs == "gather"
    (rec,), (jrec,) = tat.decisions_since(mark), jat.decisions_since(jmark)
    assert rec["key"] == jrec["key"] == "cpu-mesh|c32|t1024|d%d|float32|m4x2" \
        % len(dms)
    assert rec["source"] == jrec["source"] == "static"


@pytest.mark.parametrize("times, winner", [
    ({"pallas": 0.004, "gather": 0.010}, "pallas"),
    ({"pallas": 0.010, "gather": 0.004}, "gather"),
    ({"pallas": 0.004, "gather": 0.5}, "pallas")])
def test_card_mesh_decision_equals_jax_for_fake_timings(
        fresh_tuners, monkeypatch, times, winner):
    """An all-CUDA float32 mesh measures the direct sweep against the
    gather (a CPU mesh standing in, its runs real, its timings fake); the
    JAX tuner decides the same for the same timings on the same mesh key
    under its all-TPU backend."""
    from pulsarutils_tpu.tuning.cache import TuneCache as JaxTuneCache

    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan
    from pulsarutils_tpu_torch.tuning.cache import TuneCache

    monkeypatch.setattr(tmesh.Mesh, "all_cuda", property(lambda self: True))
    array, header = simulate_test_data(150.0, nsamples=1024, nchan=32,
                                       rng=3)
    geom = (header["fbottom"], header["bandwidth"], header["tsamp"])
    dms = dedispersion_plan(32, 100.0, 200.0, *geom)
    measurer = lambda kernel, run, reps: times[kernel]  # noqa: E731
    tat.set_tuner(tat.KernelTuner(cache=TuneCache(None), min_elements=0,
                                  measurer=measurer))
    mark = tat.decision_seq()
    ours = tat.resolve_mesh_kernel(make_mesh((2, 4), devices=CPU8), 32,
                                   1024, len(dms), *geom, dms)
    (rec,) = tat.decisions_since(mark)
    jtuner = jat.KernelTuner(cache=JaxTuneCache(None), min_elements=0,
                             measurer=measurer)
    ref = (np.ones(3), np.ones(3), np.array([1.0, 5.0, 2.0]),
           np.ones(3, np.int32), np.arange(3))
    theirs = jtuner.resolve(
        backend="tpu", nchan=32, nsamples=1024, ndm=len(dms),
        dtype="float32", candidates=["pallas", "gather"], static="pallas",
        runner_factory=lambda: {k: (lambda: ref) for k in ("pallas",
                                                           "gather")},
        mesh_shape=(2, 4))
    jrec = jat.decisions_since(jat.decision_seq() - 1)[0]
    assert ours == theirs == winner
    assert rec["key"].split("|", 1) == ["gpu", jrec["key"].split("|", 1)[1]]
    assert rec["key"].endswith("|m2x4")
    assert rec["source"] == jrec["source"] == "measured"
    assert rec.get("abandoned") == jrec.get("abandoned")
