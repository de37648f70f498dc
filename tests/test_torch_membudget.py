"""The port's memory preflight (``resilience/memory_budget.py``) held
against the JAX package's: the footprint model term for term, the
``PUTPU_MEM_LIMIT`` override, the calibration file and its EWMA, and
the preflight's splits of the gather and roll sweeps (bit-identical
tables, the JAX package's number of splits)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from pulsarutils_tpu.ops import search as jsearch
from pulsarutils_tpu.resilience import ladder as jladder
from pulsarutils_tpu.resilience import memory_budget as jmb
from pulsarutils_tpu_torch.obs import metrics
from pulsarutils_tpu_torch.ops.plan import dedispersion_plan
from pulsarutils_tpu_torch.ops.search import dedispersion_search
from pulsarutils_tpu_torch.resilience import ladder
from pulsarutils_tpu_torch.resilience import memory_budget as mb

torch.set_num_threads(1)

GEOM = (1200.0, 200.0, 5e-4)


@pytest.fixture
def clean(monkeypatch, tmp_path):
    """Both ladders at level 0, the calibration beside a per-test cache,
    no limit set; the port's registry cleared."""
    monkeypatch.setenv("PUTPU_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")
    monkeypatch.delenv(mb.MEM_LIMIT_ENV, raising=False)
    ladder.reset()
    jladder.reset()
    metrics.REGISTRY.reset()
    yield
    ladder.reset()
    jladder.reset()
    metrics.REGISTRY.reset()


@pytest.mark.parametrize("kw", [
    dict(nchan=1024, nsamples=1 << 18, ndm=514),
    dict(nchan=1024, nsamples=1 << 18, ndm=514, formulation="roll"),
    dict(nchan=1024, nsamples=1 << 18, ndm=514, chan_block=64,
         capture_plane=True, dm_passes=4),
    dict(nchan=64, nsamples=4096, ndm=7, dm_block=4, packed_nbits=2),
    dict(nchan=4096, nsamples=1 << 20, ndm=2000, dm_block=16, batch=3,
         formulation="roll", capture_plane=True),
    dict(nchan=13, nsamples=777, ndm=0),
])
def test_estimate_direct_equals_jax(kw):
    kw = dict(kw)
    args = kw.pop("nchan"), kw.pop("nsamples"), kw.pop("ndm")
    ours = mb.estimate_direct(*args, **kw)
    assert ours == jmb.estimate_direct(*args, **kw)
    assert ours["total"] == sum(ours[k] for k in ("operand", "workspace",
                                                  "scoring", "outputs"))
    assert mb.SAFETY_FRACTION == jmb.SAFETY_FRACTION
    assert mb.MEM_LIMIT_ENV == jmb.MEM_LIMIT_ENV


def test_mem_limit_env_is_the_budget(clean, monkeypatch):
    assert mb.device_budget_bytes("cpu") is None
    assert mb.headroom_bytes("cpu") is None
    assert not mb.allocator_reports_limit("cpu")
    monkeypatch.setenv(mb.MEM_LIMIT_ENV, "1.5e9")
    assert mb.device_budget_bytes("cpu") == jmb.device_budget_bytes() \
        == 1500000000
    # no live tensors are counted on the host: the headroom is the limit
    assert mb.headroom_bytes("cpu") == 1500000000
    assert not mb.allocator_reports_limit("cpu")
    monkeypatch.setenv(mb.MEM_LIMIT_ENV, "lots")
    assert mb.device_budget_bytes("cpu") is None


def test_calibration_round_trip_and_ewma(clean, tmp_path):
    key = mb._direct_key(1024, 1 << 18, 514, "cpu")
    assert key == jmb._direct_key(1024, 1 << 18, 514)
    assert mb.calibration_path() == str(tmp_path / "membudget_calib.json")
    assert mb.calibration_path() == jmb.calibration_path()
    assert mb.calibration_offset(key) == 1.0
    first = mb.record_calibration(key, 1000, 1500)
    second = mb.record_calibration(key, 1000, 500)
    assert first == 1.5 and second == pytest.approx(0.7 * 1.5 + 0.3 * 0.5)
    assert mb.calibration_offset(key) == round(second, 4)
    assert mb.calibrated(key, 100) == pytest.approx(100 * round(second, 4))
    assert mb.record_calibration(key, 0, 10) is None
    assert mb.record_calibration(key, 10, None) is None
    # the file is the JAX package's document: it reads the port's offset
    doc = json.loads((tmp_path / "membudget_calib.json").read_text())
    assert doc["version"] == 1 and doc["offsets"] == {key: round(second, 4)}
    jmb._calib_cache.update(path=None, offsets=None)
    assert jmb.calibration_offset(key) == round(second, 4)
    # a torn file degrades to the raw model
    (tmp_path / "membudget_calib.json").write_text("{")
    mb._calib_cache.update(path=None, offsets=None)
    assert mb.calibration_offset(key) == 1.0
    # the host keeps no allocator statistics: nothing to observe
    assert mb.observe(1024, 1 << 18, 514, 10 ** 9, "cpu") is None


@pytest.mark.parametrize("formulation, capture, head_frac", [
    ("gather", False, 0.5), ("roll", False, 0.5), ("gather", True, 0.5),
    ("roll", True, 0.95), ("gather", True, 0.9), ("roll", False, 2.0)])
def test_preflight_levels_equal_jax(clean, monkeypatch, formulation, capture,
                                    head_frac):
    nchan, nsamples, ndm, dm_block = 256, 1 << 16, 300, 8
    nblocks = -(-ndm // dm_block)
    est = mb.estimate_direct(nchan, nsamples, ndm, dm_block=dm_block,
                             formulation=formulation,
                             capture_plane=capture)["total"]
    head = int(head_frac * est)
    monkeypatch.setattr(mb, "headroom_bytes", lambda device=None: head)
    monkeypatch.setattr(jmb, "headroom_bytes", lambda: head)
    kw = dict(dm_block=dm_block, chan_block=None, capture_plane=capture,
              nblocks=nblocks)
    ours = mb.preflight_direct(formulation, nchan, nsamples, ndm,
                               device="cpu", **kw)
    theirs = jmb.preflight_direct(formulation, nchan, nsamples, ndm, **kw)
    assert ours == theirs == ladder.level() == jladder.level()
    assert ladder.direct_plan(formulation, nblocks) == \
        jladder.direct_plan(formulation, nblocks)
    assert (ours > 0) == (head_frac < 1.0 / mb.SAFETY_FRACTION)
    splits = metrics.REGISTRY.counter("putpu_oom_splits_total",
                                      stage="preflight").value
    assert splits == ours


@pytest.fixture(scope="module")
def chunk():
    rng = np.random.default_rng(5)
    data = rng.standard_normal((64, 4096)).astype(np.float32)
    data[np.arange(64), (1000 + 3 * np.arange(64)) % 4096] += 3.0
    return data


def _table(table):
    return {c: np.asarray(table[c]) for c in ("DM", "max", "std", "snr",
                                              "rebin", "peak")}


@pytest.mark.parametrize("formulation", ["gather", "roll"])
@pytest.mark.parametrize("capture", [False, True])
def test_preflight_splits_the_sweep_bit_for_bit(clean, monkeypatch, chunk,
                                                formulation, capture):
    nchan, nsamples = chunk.shape
    trial_dms = dedispersion_plan(nchan, 100.0, 300.0, *GEOM)
    ndm = len(trial_dms)
    kw = dict(trial_dms=trial_dms, kernel=formulation, dm_block=8,
              device="cpu", capture_plane=capture)
    ref = dedispersion_search(chunk, 100.0, 300.0, *GEOM, **kw)
    ref_plane = ref[1] if capture else None
    ref = ref[0] if capture else ref
    assert ladder.level() == 0
    est = mb.estimate_direct(nchan, nsamples, ndm, dm_block=8,
                             formulation=formulation,
                             capture_plane=capture)["total"]
    monkeypatch.setenv(mb.MEM_LIMIT_ENV, str(est // 2))
    ours = dedispersion_search(chunk, 100.0, 300.0, *GEOM, **kw)
    plane = ours[1] if capture else None
    ours = ours[0] if capture else ours
    splits = metrics.REGISTRY.counter("putpu_oom_splits_total",
                                      stage="preflight").value
    assert splits == ladder.level() > 0
    for col, values in _table(ref).items():
        assert np.array_equal(_table(ours)[col], values), col
    if capture:
        assert torch.equal(plane, ref_plane)
    # the JAX package splits the same geometry at the same headroom as
    # often (its CPU backend counts its live arrays as in use; the
    # port's host counts nothing, so its headroom is the limit)
    monkeypatch.setattr(jmb, "headroom_bytes", lambda: est // 2)
    jsearch.dedispersion_search(chunk, 100.0, 300.0, *GEOM, backend="jax",
                                trial_dms=trial_dms, kernel=formulation,
                                dm_block=8, capture_plane=capture)
    assert jladder.level() == splits


def test_preflight_is_inert_without_a_budget(clean, chunk):
    before = mb.estimate_direct  # the CPU default: no budget, no split
    dedispersion_search(chunk, 100.0, 300.0, *GEOM, kernel="gather",
                        device="cpu")
    assert ladder.level() == 0 and mb.estimate_direct is before
    assert metrics.REGISTRY.counter("putpu_oom_splits_total",
                                    stage="preflight").value == 0


def test_ladder_direct_plan_takes_the_formulation():
    ladder.reset()
    try:
        ladder.descend("split_dm")
        ladder.descend("split_dm")
        for form in ("gather", "roll", "pallas"):
            assert ladder.direct_plan(form, 17) == 4 == ladder.direct_plan(17)
            assert ladder.direct_step(form) == jladder.direct_step(form)
        assert not ladder.direct_maxed("roll", 17)
        assert ladder.direct_maxed("roll", 3) and ladder.direct_maxed(3)
    finally:
        ladder.reset()
