"""The port's kernel autotuner (``pulsarutils_tpu_torch.tuning``), held
against the JAX package's: keys, cache files, the equivalence checks,
the tuner's decisions for the same fake timings, the card-only rule, the
budget record, the tune CLI, a measured CPU search, and the FDMT
bisection knobs."""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import pytest
import torch

from pulsarutils_tpu.ops import fdmt as jfdmt
from pulsarutils_tpu.tuning import autotune as jat
from pulsarutils_tpu.tuning import cache as jcache
from pulsarutils_tpu.tuning import geometry as jgeo
from pulsarutils_tpu_torch.cli import tune_main
from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
from pulsarutils_tpu_torch.models.simulate import simulate_test_data
from pulsarutils_tpu_torch.obs import metrics
from pulsarutils_tpu_torch.ops import fdmt as tfdmt
from pulsarutils_tpu_torch.ops.search import dedispersion_search
from pulsarutils_tpu_torch.periodicity import driver as tdriver
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks
from pulsarutils_tpu_torch.tuning import autotune as tat
from pulsarutils_tpu_torch.tuning import cache as tcache
from pulsarutils_tpu_torch.tuning import geometry as tgeo
from pulsarutils_tpu_torch.utils import logging_utils

torch.set_num_threads(1)

GEOM = (1200.0, 200.0, 5e-4)


@pytest.fixture
def fresh_tuners(monkeypatch, tmp_path):
    """Both packages' process tuners reset (a per-test cache file) and
    the port's registry cleared after the test."""
    monkeypatch.setenv("PUTPU_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.delenv("PUTPU_AUTOTUNE", raising=False)
    monkeypatch.delenv("PUTPU_AUTOTUNE_MIN", raising=False)
    metrics.REGISTRY.reset()
    prev = tat.set_tuner(None), jat.set_tuner(None)
    yield
    tat.set_tuner(prev[0])
    jat.set_tuner(prev[1])
    metrics.REGISTRY.reset()


# -- keys and the cache file -------------------------------------------------

@pytest.mark.parametrize("backend, nchan, nsamples, ndm, dtype, mesh, batch", [
    ("cpu", 64, 4096, 154, None, None, 1),
    ("gpu", 1024, 262144, 514, None, None, 1),
    ("gpu-accel", 514, 655360, 5, "float32", None, 1),
    ("cpu-precision", 256, 65536, 256, np.float32, None, 1),
    ("gpu-harmonic", 512, 131072, 16, "float32/bf16_operand_f32_accum",
     None, 1),
    ("cpu-mesh", 32, 1024, 8, None, (2, 4), 1),
    ("cpu", 32, 1024, 8, "bfloat16", None, 4),
    ("gpu", 7, 100, 1, np.float64, (8, 1), 3),
])
def test_geometry_key_equals_jax(backend, nchan, nsamples, ndm, dtype, mesh,
                                 batch):
    ours = tgeo.geometry_key(backend, nchan, nsamples, ndm, dtype, mesh,
                             batch=batch)
    assert ours == jgeo.geometry_key(backend, nchan, nsamples, ndm, dtype,
                                     mesh, batch=batch)
    assert tgeo.dtype_name(dtype) == jgeo.dtype_name(dtype)
    assert tgeo.mesh_tag(mesh) == jgeo.mesh_tag(mesh)
    assert tgeo.PLAN_CACHE_SIZE == jgeo.PLAN_CACHE_SIZE


def test_device_backend_spells_the_card_gpu():
    assert tgeo.device_backend(torch.device("cuda")) == "gpu"
    assert tgeo.device_backend(torch.device("cuda:1")) == "gpu"
    assert tgeo.device_backend("cpu") == "cpu"
    assert tgeo.dtype_name(torch.float32) == "float32"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_file_is_read_by_both_packages(tmp_path, writer):
    assert tcache.TUNE_SCHEMA_VERSION == jcache.TUNE_SCHEMA_VERSION
    path = str(tmp_path / "tune.json")
    key = tgeo.geometry_key("gpu", 1024, 262144, 514)
    store = (tcache.TuneCache if writer == "port" else jcache.TuneCache)(path)
    store.store(key, "pallas", measured_s={"pallas": 0.0123, "roll": 0.5},
                reps=3, abandoned=["roll"])
    ours = tcache.TuneCache(path).entries()
    theirs = jcache.TuneCache(path).entries()
    assert ours == theirs and ours[key]["kernel"] == "pallas"
    # both packages write the same document, stamp apart
    other = str(tmp_path / "other.json")
    (jcache.TuneCache if writer == "port" else tcache.TuneCache)(
        other).store(key, "pallas", measured_s={"pallas": 0.0123,
                                                "roll": 0.5},
                     reps=3, abandoned=["roll"])
    docs = []
    for p in (path, other):
        with open(p, encoding="utf-8") as f:
            doc = json.load(f)
        doc["entries"][key].pop("tuned_at")
        docs.append(doc)
    assert docs[0] == docs[1]
    assert tcache.check_artifact(path) == jcache.check_artifact(path)


def test_cache_default_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("PUTPU_TUNE_CACHE", raising=False)
    ours, theirs = tcache.default_cache_path(), jcache.default_cache_path()
    assert ours != theirs and "pulsarutils_tpu_torch" in ours
    monkeypatch.setenv("PUTPU_TUNE_CACHE", "/x/y.json")
    assert tcache.default_cache_path() == jcache.default_cache_path()


def _broken_open(*args, **kwargs):
    raise PermissionError("no read access")


@pytest.mark.parametrize("case", ["torn", "version", "oserror", "missing"])
def test_cache_recovery_as_jax(tmp_path, monkeypatch, case):
    outcomes = []
    for pkg, mod in (("port", tcache), ("jax", jcache)):
        path = tmp_path / f"{pkg}.json"
        if case == "torn":
            path.write_text('{"schema_version": 1, "entries": {"cpu|')
        elif case in ("version", "oserror"):
            version = 99 if case == "version" else 1
            path.write_text(json.dumps({"schema_version": version,
                                        "entries": {"k": {"kernel": "roll"}}}))
        if case == "oserror":
            monkeypatch.setattr(mod, "open", _broken_open, raising=False)
        cache = mod.TuneCache(str(path))
        monkeypatch.undo()
        outcomes.append((cache.entries(), path.exists(),
                         os.path.exists(str(path) + ".corrupt")))
    assert outcomes[0] == outcomes[1]
    entries, kept, backed_up = outcomes[0]
    assert entries == {}
    assert backed_up == (case == "torn")
    assert kept == (case in ("version", "oserror"))


# -- the equivalence checks --------------------------------------------------

def _pack(seed, n=40):
    rng = np.random.default_rng(seed)
    snr = rng.uniform(3, 6, n).astype(np.float32)
    snr[17] = 20.0
    return (rng.uniform(1, 2, n).astype(np.float32),
            rng.uniform(0.5, 1, n).astype(np.float32), snr,
            rng.choice([1, 2, 4, 8], n).astype(np.int32),
            rng.integers(0, 4096, n).astype(np.int64))


def _perturbed(case):
    ref = _pack(1)
    cand = [a.copy() for a in ref]
    if case == "argbest":
        cand[2][3] = 30.0
    elif case == "window":
        cand[3][17] = 8 if cand[3][17] != 8 else 4
    elif case == "peak":
        cand[4][17] += 1
    elif case == "within_rtol":
        cand[0] *= np.float32(1 + 5e-5)
    elif case == "beyond_rtol":
        cand[1][5] *= np.float32(1.01)
    elif case == "shape":
        cand = [a[:-1] for a in cand]
    return ref, tuple(cand)


@pytest.mark.parametrize("case", ["same", "argbest", "window", "peak",
                                  "within_rtol", "beyond_rtol", "shape"])
def test_hits_match_equals_jax(case):
    ref, cand = _perturbed(case)
    ours = tat.hits_match(ref, cand)
    assert ours == jat.hits_match(ref, cand)
    assert ours == (case in ("same", "within_rtol"))


def _spec(seed, rows=12):
    rng = np.random.default_rng(seed)
    return {"freq": rng.integers(5, 500, rows) / (4096 * 5e-4),
            "power": rng.uniform(10, 50, rows).astype(np.float32),
            "nharm": rng.choice([1, 2, 4, 8, 16], rows).astype(np.int32),
            "log_sf": -rng.uniform(5, 40, rows).astype(np.float32),
            "sigma": rng.uniform(2, 9, rows).astype(np.float32)}


@pytest.mark.parametrize("case", ["same", "nharm", "bin", "ulp_freq",
                                  "power", "missing", "none"])
def test_harmonic_packs_match_equals_jax(case):
    ref = _spec(3)
    cand = {k: v.copy() for k, v in ref.items()}
    if case == "nharm":
        cand["nharm"][2] = 32
    elif case == "bin":
        cand["freq"][4] += 1.0 / (4096 * 5e-4)
    elif case == "ulp_freq":
        cand["freq"] = np.nextafter(cand["freq"], np.inf)
    elif case == "power":
        cand["power"][1] *= np.float32(1.001)
    elif case == "missing":
        del cand["sigma"]
    elif case == "none":
        cand = None
    for scale in (None, 4096 * 5e-4):
        ours = tat.harmonic_packs_match(ref, cand, bin_scale=scale)
        assert ours == jat.harmonic_packs_match(ref, cand, bin_scale=scale)
    assert tat.harmonic_packs_match(ref, cand, bin_scale=4096 * 5e-4) == (
        case in ("same", "ulp_freq"))


def test_synthetic_chunk_and_probe_grid_equal_jax():
    offs = np.arange(16, dtype=np.int32) * 7
    assert np.array_equal(tat.synthetic_chunk(16, 1000, offs),
                          jat.synthetic_chunk(16, 1000, offs))
    grid = np.linspace(100, 300, 77)
    assert np.array_equal(tat._probe_grid(grid, 32),
                          jat._probe_grid(grid, 32))
    for name in ("TUNE_REPS", "TUNE_PROBE_TRIALS", "ABANDON_FACTOR",
                 "MIN_TUNE_ELEMENTS", "ACCEL_SIGMA_RTOL",
                 "HARMONIC_SCORE_RTOL"):
        assert getattr(tat, name) == getattr(jat, name)


@pytest.mark.parametrize("raw, expected", [
    ("", "on"), ("on", "on"), ("OFF", "off"), ("0", "off"),
    ("cache-only", "cache"), ("bogus", "on")])
def test_autotune_mode_equals_jax(monkeypatch, raw, expected):
    monkeypatch.setenv("PUTPU_AUTOTUNE", raw)
    assert tat.autotune_mode() == jat.autotune_mode() == expected


# -- the tuner's decisions for the same fake timings -------------------------

#: the fake scenarios: fake median seconds per kernel, the candidate whose
#: scores differ from the static one's, and the tuner's settings
SCENARIOS = {
    "winner": dict(times={"roll": 0.010, "gather": 0.004, "pallas": 0.006}),
    "abandon": dict(times={"roll": 0.010, "gather": 0.2, "pallas": 0.008}),
    "equiv_reject": dict(times={"roll": 0.010, "gather": 0.001,
                                "pallas": 0.02}, bad="gather"),
    "off": dict(times={"roll": 0.01, "gather": 0.001}, mode="off"),
    "cache_only": dict(times={"roll": 0.01, "gather": 0.001}, mode="cache"),
    "below_floor": dict(times={"roll": 0.01, "gather": 0.001}, floor=1 << 40),
    "single": dict(times={"roll": 0.01}, candidates=["roll"]),
    "no_runner": dict(times={"roll": 0.01, "gather": 0.001}, runner=False),
}


def _decide(pkg, scenario, backend="cpu"):
    """One resolution in ``pkg``'s tuner under ``scenario``: ``(kernel,
    decision records)``."""
    mod = tat if pkg == "port" else jat
    sc = SCENARIOS[scenario]
    times = sc["times"]
    candidates = sc.get("candidates", ["roll", "gather", "pallas"])
    ref = _pack(1)
    bad = _perturbed("argbest")[1]

    def runners():
        return {k: (lambda k=k: bad if k == sc.get("bad") else ref)
                for k in candidates}

    tuner = mod.KernelTuner(cache=(tcache if pkg == "port" else jcache)
                            .TuneCache(None), mode=sc.get("mode", "on"),
                            min_elements=sc.get("floor", 0),
                            measurer=lambda kernel, run, reps: times[kernel])
    mark = mod.decision_seq()
    kernel = tuner.resolve(backend=backend, nchan=64, nsamples=4096, ndm=154,
                           dtype="float32", candidates=candidates,
                           static=candidates[0],
                           runner_factory=(runners if sc.get("runner", True)
                                           else None))
    return kernel, mod.decisions_since(mark)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_tuner_decisions_equal_jax(fresh_tuners, scenario):
    ours, theirs = _decide("port", scenario), _decide("jax", scenario)
    assert ours == theirs
    kernel, decisions = ours
    expected = {"winner": "gather", "abandon": "pallas",
                "equiv_reject": "roll"}.get(scenario, "roll")
    assert kernel == expected
    if scenario == "off":
        assert decisions == []
        return
    (rec,) = decisions
    assert rec["kernel"] == expected
    if scenario == "abandon":
        assert rec["abandoned"] == ["gather"]
    if scenario in ("cache_only", "below_floor", "single", "no_runner"):
        assert rec["source"] == "static" and rec["reason"]


def test_tuner_cache_and_memory_hits(fresh_tuners, tmp_path):
    calls = []

    def measurer(kernel, run, reps):
        calls.append(kernel)
        return {"roll": 0.02, "gather": 0.01}[kernel]

    path = str(tmp_path / "hits.json")
    kw = dict(backend="cpu", nchan=64, nsamples=4096, ndm=10,
              dtype="float32", candidates=["roll", "gather"], static="roll",
              runner_factory=lambda: {"roll": lambda: _pack(1),
                                      "gather": lambda: _pack(1)})
    tuner = tat.KernelTuner(cache=tcache.TuneCache(path), mode="on",
                            min_elements=0, measurer=measurer)
    assert tuner.resolve(**kw) == "gather" and len(calls) == 6
    assert tuner.resolve(**kw) == "gather" and len(calls) == 6  # memory
    mark = tat.decision_seq()
    again = tat.KernelTuner(cache=tcache.TuneCache(path), mode="on",
                            min_elements=0, measurer=measurer)
    assert again.resolve(**kw) == "gather" and len(calls) == 6  # disk
    assert tat.decisions_since(mark)[0]["source"] == "cache"
    hits = metrics.REGISTRY.counter("putpu_autotune_cache_hits_total")
    assert hits.value == 2


# -- the card's rule ---------------------------------------------------------

def _failing_runners(fail):
    def boom():
        raise RuntimeError("kernel launch failed")

    return lambda: {k: (boom if k == fail else (lambda: _pack(1)))
                    for k in ("pallas", "roll", "gather")}


@pytest.mark.parametrize("backend", ["gpu", "gpu-accel", "cpu"])
def test_static_failure_propagates_on_the_card(fresh_tuners, backend):
    tuner = tat.KernelTuner(mode="on", min_elements=0,
                            measurer=lambda k, run, reps: 0.01)
    kw = dict(backend=backend, nchan=64, nsamples=4096, ndm=16,
              dtype="float32", candidates=["pallas", "roll", "gather"],
              static="pallas", runner_factory=_failing_runners("pallas"))
    if backend.startswith("gpu"):
        with pytest.raises(RuntimeError, match="launch failed"):
            tuner.resolve(**kw)
        return
    # on the CPU the JAX package's rule: the static choice, recorded
    mark = tat.decision_seq()
    assert tuner.resolve(**kw) == "pallas"
    (rec,) = tat.decisions_since(mark)
    assert rec["reason"] == "measurement failed: RuntimeError"
    jmark = jat.decision_seq()
    jtuner = jat.KernelTuner(mode="on", min_elements=0,
                             measurer=lambda k, run, reps: 0.01)
    assert jtuner.resolve(**kw) == "pallas"
    assert jat.decisions_since(jmark) == [rec]


def test_non_static_failure_is_dropped_on_the_card(fresh_tuners, caplog):
    times = {"pallas": 0.02, "roll": 0.01, "gather": 0.001}
    tuner = tat.KernelTuner(mode="on", min_elements=0,
                            measurer=lambda k, run, reps: times[k])
    mark = tat.decision_seq()
    with caplog.at_level(logging.WARNING, logger="pulsarutils_tpu_torch"):
        kernel = tuner.resolve(
            backend="gpu", nchan=64, nsamples=4096, ndm=16, dtype="float32",
            candidates=["pallas", "roll", "gather"], static="pallas",
            runner_factory=_failing_runners("gather"))
    assert kernel == "roll"
    (rec,) = tat.decisions_since(mark)
    assert rec["source"] == "measured"
    assert set(rec["measured_s"]) == {"pallas", "roll"}
    assert "dropped from the measurement" in caplog.text
    assert metrics.REGISTRY.counter(
        "putpu_autotune_static_fallbacks_total").value == 1


def test_driver_backend_resolution_propagates_on_the_card(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("B6 failed to build")

    monkeypatch.setattr(tat, "resolve_accel_backend", broken)
    args = (8, 4096, 5e-4, np.zeros(3), None, 16, None, None)
    assert tdriver._resolve_accel_backend(
        *args, torch.device("cpu")) == "time_stretch"
    with pytest.raises(RuntimeError, match="B6"):
        tdriver._resolve_accel_backend(*args, torch.device("cuda"))


def test_harmonic_kernel_resolves_statically(fresh_tuners):
    mark = tat.decision_seq()
    assert tat.resolve_harmonic_kernel(512, 131072, 5e-4,
                                       device="cpu") == "xla"
    assert tat.resolve_harmonic_kernel(512, 131072, 5e-4,
                                       device=torch.device("cuda")) == "pallas"
    assert tat.resolve_harmonic_kernel(
        512, 131072, 5e-4, policy="bf16_operand_f32_accum",
        device="cpu") == "xla"
    recs = tat.decisions_since(mark)
    assert [r["reason"] for r in recs] == ["single applicable variant"] * 3
    assert recs[0]["key"] == jgeo.geometry_key(
        "cpu-harmonic", 512, 131072, 16, "float32")
    assert recs[1]["key"].startswith("gpu-harmonic|c512|")
    assert recs[2]["key"].endswith("|float32/bf16_operand_f32_accum|m-")


# -- the budget record -------------------------------------------------------

def test_budget_record_carries_the_runs_decisions(fresh_tuners):
    acct = logging_utils.BudgetAccountant()
    assert "autotune" not in acct.to_json()
    data = np.random.default_rng(0).standard_normal((32, 1024)).astype(
        np.float32)
    dedispersion_search(data, 100, 200, *GEOM, device="cpu")
    (rec,) = acct.to_json()["autotune"]
    assert rec["kernel"] == "pallas" and rec["source"] == "static"
    assert rec["reason"].startswith("geometry below tune floor")
    acct.begin_stream()
    assert "autotune" not in acct.to_json()


# -- the tune CLI ------------------------------------------------------------

TUNE_ARGS = ["--nchan", "32", "--nsamples", "2048", "--ndm", "12",
             "--dmmin", "100", "--device", "cpu", "--reps", "1",
             "--probe-trials", "8"]


def _tuned(tmp_path, capsys):
    path = str(tmp_path / "cli.json")
    assert tune_main.main(["tune", *TUNE_ARGS, "--cache", path]) == 0
    rec = json.loads(capsys.readouterr().out)
    return path, rec


def test_tune_cli_tune(tmp_path, capsys, fresh_tuners):
    path, rec = _tuned(tmp_path, capsys)
    assert rec["source"] == "measured" and rec["static"] == "pallas"
    assert set(rec["measured_s"]) <= {"pallas", "roll", "gather"}
    assert rec["key"].startswith("cpu|c32|t2048|d")
    # a second tune reads the cache; --force measures again
    assert tune_main.main(["tune", *TUNE_ARGS, "--cache", path]) == 0
    assert json.loads(capsys.readouterr().out)["source"] == "cache"
    assert tune_main.main(["tune", *TUNE_ARGS, "--cache", path,
                           "--force"]) == 0
    assert json.loads(capsys.readouterr().out)["source"] == "measured"


def test_tune_cli_show(tmp_path, capsys, fresh_tuners):
    path, rec = _tuned(tmp_path, capsys)
    assert tune_main.main(["show", "--cache", path]) == 0
    out = capsys.readouterr().out
    assert rec["key"] in out and rec["kernel"] in out
    assert tune_main.main(["show", "--cache",
                           str(tmp_path / "none.json")]) == 0
    assert "no tuned entries" in capsys.readouterr().out


def test_tune_cli_clear(tmp_path, capsys, fresh_tuners):
    path, _ = _tuned(tmp_path, capsys)
    assert tune_main.main(["clear", "--cache", path, "--match", "c999"]) == 0
    assert "removed 0 entries" in capsys.readouterr().out
    assert tune_main.main(["clear", "--cache", path]) == 0
    assert "removed 1 entry" in capsys.readouterr().out
    assert tcache.TuneCache(path).entries() == {}


def test_tune_cli_verify(tmp_path, capsys, fresh_tuners):
    path, _ = _tuned(tmp_path, capsys)
    assert tune_main.main(["verify", "--cache", path]) == 0
    store = tcache.TuneCache(path)
    store.store("gpu-precision|c1|t1|d1|float32|m-", "gather+split_f32")
    store.store("gpu-accel|c1|t1|d1|float32|m-", "fdas")
    assert tune_main.main(["verify", "--cache", path]) == 0
    store.store("cpu|c2|t2|d2|float32|m-", "warp")
    assert tune_main.main(["verify", "--cache", path]) == 1
    assert "unknown kernel" in capsys.readouterr().out
    torn = tmp_path / "torn.json"
    torn.write_text("{")
    assert tune_main.main(["verify", "--cache", str(torn)]) == 1
    assert tune_main.main(["verify", "--cache", path,
                           "--expect-version", "2"]) == 1


# -- a measured search on the CPU --------------------------------------------

@pytest.fixture(scope="module")
def small_file(tmp_path_factory):
    array, header = simulate_test_data(150.0, nsamples=8192, nchan=32,
                                       signal=10.0, noise=4.0, rng=11)
    path = tmp_path_factory.mktemp("tune") / "pulse.fil"
    write_simulated_filterbank(str(path), array + 20.0, header,
                               descending=True, nbits=8)
    return str(path)


def _same_hits(ours, ref):
    """Equal chunks, best rows (DM, rebin, peak) and candidates; every
    trial's snr within the exact-hit-match check's rtol (the gather
    formulation may reassociate the channel sums)."""
    assert [(h[0], h[1]) for h in ours] == [(h[0], h[1]) for h in ref]
    for (_, _, info, table), (_, _, rinfo, rtable) in zip(ours, ref):
        assert (info.dm, info.width) == (rinfo.dm, rinfo.width)
        best, rbest = table.best_row(), rtable.best_row()
        assert [best[c] for c in ("DM", "rebin", "peak")] == \
            [rbest[c] for c in ("DM", "rebin", "peak")]
        assert np.allclose(table["snr"], rtable["snr"], rtol=1e-4,
                           atol=1e-6)


@pytest.mark.parametrize("kernel", ["auto", "hybrid"])
def test_measured_cpu_search_keeps_the_hits(small_file, tmp_path,
                                            monkeypatch, fresh_tuners,
                                            kernel):
    kw = dict(dmmin=100.0, dmmax=200.0, chunk_length=1.024,
              snr_threshold=6.0, kernel=kernel, device="cpu",
              make_plots=False)
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")
    ref, _ = search_by_chunks(small_file, output_dir=str(tmp_path / "off"),
                              **kw)
    monkeypatch.setenv("PUTPU_AUTOTUNE", "on")
    monkeypatch.setenv("PUTPU_AUTOTUNE_MIN", "0")
    acct = logging_utils.BudgetAccountant()
    ours, _ = search_by_chunks(small_file, output_dir=str(tmp_path / "on"),
                               budget=acct, **kw)
    assert ref
    _same_hits(ours, ref)
    measured = [r for r in acct.to_json()["autotune"]
                if r["source"] == "measured"]
    assert measured and measured[0]["key"].startswith("cpu|c32|")
    assert set(measured[0]["measured_s"]) <= {"pallas", "roll", "gather"}


def test_measured_policy_search_keeps_the_table(fresh_tuners, monkeypatch):
    monkeypatch.setenv("PUTPU_AUTOTUNE_MIN", "0")
    data = tat.synthetic_chunk(32, 2048, np.arange(32) * 3)
    ref = dedispersion_search(data, 100, 200, *GEOM, kernel="roll",
                              device="cpu")
    mark = tat.decision_seq()
    ours = dedispersion_search(data, 100, 200, *GEOM, kernel="roll",
                               precision="auto", device="cpu")
    (rec,) = tat.decisions_since(mark)
    assert rec["key"].startswith("cpu-precision|c32|t2048|")
    assert rec["source"] == "measured" and rec["static"] == "roll+f32"
    strategy = rec["kernel"].split("+", 1)[1]
    best, rbest = ours.best_row(), ref.best_row()
    assert [best[c] for c in ("DM", "rebin", "peak")] == \
        [rbest[c] for c in ("DM", "rebin", "peak")]
    from pulsarutils_tpu_torch.precision import STRATEGIES

    assert abs(best["snr"] - rbest["snr"]) <= \
        STRATEGIES[strategy].score_rtol * abs(rbest["snr"])


# -- the FDMT bisection knobs ------------------------------------------------

@pytest.mark.parametrize("knobs", [
    {"PUTPU_FDMT_HEAD": "0"}, {"PUTPU_FDMT_DEEP_PAIR": "0"},
    {"PUTPU_FDMT_HEAD": "0", "PUTPU_FDMT_DEEP_PAIR": "0"},
    {"PUTPU_FDMT_HEAD": "1", "PUTPU_FDMT_DEEP_PAIR": "1"}])
def test_fdmt_knobs_keep_the_plane(monkeypatch, knobs):
    nchan, t, max_delay, min_delay = 512, 1024, 120, 0
    data = np.random.default_rng(9).standard_normal((nchan, t)).astype(
        np.float32)
    plan = tfdmt.fdmt_plan(nchan, 1200.0, 200.0, max_delay, min_delay)
    default = tfdmt.fdmt_transform(torch.from_numpy(data), max_delay,
                                   1200.0, 200.0, min_delay=min_delay)
    kinds = [k for k, _ in tfdmt.transform_schedule(plan)]
    assert kinds[0] == "head" and kinds[-1] == "merge4"
    for name, value in knobs.items():
        monkeypatch.setenv(name, value)
    kinds = [k for k, _ in tfdmt.transform_schedule(plan)]
    assert ("head" in kinds) == (knobs.get("PUTPU_FDMT_HEAD") != "0")
    assert ("merge4" in kinds) == (knobs.get("PUTPU_FDMT_DEEP_PAIR") != "0")
    ours = tfdmt.fdmt_transform(torch.from_numpy(data), max_delay, 1200.0,
                                200.0, min_delay=min_delay)
    ref = np.asarray(jfdmt.fdmt_transform(data, max_delay, 1200.0, 200.0,
                                          use_pallas=False,
                                          min_delay=min_delay))
    assert torch.equal(ours, default)
    assert np.max(np.abs(ours.numpy() - ref)) == 0.0


def test_fdmt_knob_garbage_warns_and_keeps_the_default(monkeypatch):
    plan = tfdmt.fdmt_plan(512, 1200.0, 200.0, 120, 0)
    monkeypatch.setenv("PUTPU_FDMT_HEAD", "off")
    with pytest.warns(UserWarning, match="PUTPU_FDMT_HEAD"):
        kinds = [k for k, _ in tfdmt.transform_schedule(plan)]
    assert kinds[0] == "head"


def test_counted_plan_cache_counts_as_jax(fresh_tuners):
    calls = []

    @tgeo.counted_plan_cache("probe_plans", maxsize=2)
    def plan(n):
        calls.append(n)
        return n * 2

    assert [plan(1), plan(1), plan(2), plan(3), plan(1)] == [2, 2, 4, 6, 2]
    assert calls == [1, 2, 3, 1]  # maxsize 2 evicted 1
    hits = metrics.REGISTRY.counter("putpu_plan_cache_hits_total",
                                    cache="probe_plans").value
    misses = metrics.REGISTRY.counter("putpu_plan_cache_misses_total",
                                      cache="probe_plans").value
    assert (hits, misses) == (1, 4)
    assert plan.cache_info().hits == 1
    plan.cache_clear()
    assert plan.cache_info().currsize == 0
