"""The port's fault containment on the CPU, held against the JAX package.

The fault plans, the integrity gate (host and tensor forms), the dispatch
deadline, the ledger with reasons, the audit and the OOM ladder, each
against the JAX package's module on the same inputs; then the port's
``search_by_chunks(device="cpu")`` and the JAX driver (``backend="jax"``,
the Pallas sweep in interpret mode) under the same fault plan on the same
file, one parametrised case a scenario: the ledger's ``done`` list and
``quarantined`` map, the quarantine manifest's records, the hits and the
counter deltas must agree.  Every thread a test starts is joined.
"""
import json
import logging
import os
import shutil
import struct
import time
import zipfile

import numpy as np
import pytest
import torch

from pulsarutils_tpu.faults import FaultPlan as JaxFaultPlan
from pulsarutils_tpu.faults import FaultSpec as JaxFaultSpec
from pulsarutils_tpu.faults import inject as jax_inject
from pulsarutils_tpu.faults import reasons as jax_reasons
from pulsarutils_tpu.faults.audit import audit_run as jax_audit_run
from pulsarutils_tpu.faults.policy import IntegrityPolicy as JaxPolicy
from pulsarutils_tpu.faults.policy import QuarantineManifest as JaxManifest
from pulsarutils_tpu.faults.policy import gate_chunk as jax_gate_chunk
from pulsarutils_tpu.io.candidates import CandidateStore as JaxStore
from pulsarutils_tpu.io.sigproc import FilterbankReader as JaxReader
from pulsarutils_tpu.obs.metrics import REGISTRY as JAX_REGISTRY
from pulsarutils_tpu.pipeline.search_pipeline import \
    search_by_chunks as jax_search_by_chunks
from pulsarutils_tpu.resilience import ladder as jax_ladder

from pulsarutils_tpu_torch.faults import (DispatchTimeoutError, FaultPlan,
                                          FaultSpec, IntegrityPolicy,
                                          QuarantineManifest, audit_run,
                                          call_with_deadline, gate_chunk,
                                          gate_frames, gate_tensor,
                                          join_abandoned,
                                          resolve_integrity_policy)
from pulsarutils_tpu_torch.faults import inject as fault_inject
from pulsarutils_tpu_torch.faults import reasons
from pulsarutils_tpu_torch.io.candidates import (CandidateStore,
                                                 config_fingerprint)
from pulsarutils_tpu_torch.io.sigproc import (FilterbankReader,
                                              write_simulated_filterbank)
from pulsarutils_tpu_torch.models.simulate import disperse_array
from pulsarutils_tpu_torch.obs.metrics import REGISTRY
from pulsarutils_tpu_torch.ops import search as search_ops
from pulsarutils_tpu_torch.pipeline import search_pipeline
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks
from pulsarutils_tpu_torch.pipeline.spectral_stats import get_bad_chans
from pulsarutils_tpu_torch.resilience import ladder
from pulsarutils_tpu_torch.utils import nvcc

torch.set_num_threads(1)

TSAMP = 0.0005
NCHAN = 64
NSAMPLES = 32768
PULSE_T = 20000                     # noise chunk: 0; hit chunks 8192, 16384
#: the JAX package's fault tests' search (tests/test_faults.py)
SEARCH = dict(dmmin=100, dmmax=200, chunk_length=8192 * TSAMP,
              snr_threshold=6.5)
JAX_KW = dict(backend="jax", kernel="pallas", make_plots=False,
              progress=False)

#: the counters both packages keep under the same names
COUNTERS = ("putpu_chunks_quarantined_total", "putpu_chunks_sanitized_total",
            "putpu_read_retries_total", "putpu_persist_retries_total",
            "putpu_persist_dead_letter_total", "putpu_dispatch_retries_total",
            "putpu_oom_floor_total", "putpu_quarantine_records_total",
            "putpu_faults_injected_total", "putpu_oom_events_total",
            "putpu_resume_pairs_skipped_total")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")
    ladder.reset()
    jax_ladder.reset()
    yield
    ladder.reset()
    jax_ladder.reset()
    assert join_abandoned(30.0) == 0


def _total(registry, name):
    return sum(m["value"] for m in registry.snapshot()
               if m["name"] == name)


def _counts(registry):
    return {name: _total(registry, name) for name in COUNTERS}


def _survey_array():
    rng = np.random.default_rng(0)
    array = np.abs(rng.normal(0, 0.5, (NCHAN, NSAMPLES))) + 20.0
    array[:, PULSE_T] += 4.0
    return disperse_array(array, 150, 1200., 200., TSAMP)


SIM_HEADER = {"bandwidth": 200., "fbottom": 1200., "nchans": NCHAN,
              "nsamples": NSAMPLES, "tsamp": TSAMP, "foff": 200. / NCHAN}


@pytest.fixture(scope="module")
def survey_file(tmp_path_factory):
    """The JAX fault tests' survey: float32 noise with one bright pulse
    at DM 150 in chunks 8192 and 16384, the bad-channel cache warm."""
    path = str(tmp_path_factory.mktemp("faults") / "survey.fil")
    write_simulated_filterbank(path, _survey_array(), SIM_HEADER,
                               descending=True)
    get_bad_chans(path)
    return path


@pytest.fixture(scope="module")
def dead_file(tmp_path_factory):
    """An 8-bit survey whose first 16384 samples hold 40 flat channels:
    chunk 0 is dead (the gate reads the stored frames), chunk 8192 is
    not."""
    array = _survey_array()
    array[:40, :16384] = 21.0
    path = str(tmp_path_factory.mktemp("dead") / "survey.fil")
    write_simulated_filterbank(path, array, SIM_HEADER, descending=True,
                               nbits=8)
    get_bad_chans(path)
    return path


def _snapshot(outdir, fingerprint):
    """Ledger bytes and per-member candidate bytes."""
    with open(os.path.join(outdir, f"progress_{fingerprint}.json"),
              "rb") as f:
        ledger = f.read()
    cands = {}
    for name in sorted(os.listdir(outdir)):
        if name.endswith(".npz"):
            with np.load(os.path.join(outdir, name),
                         allow_pickle=False) as d:
                cands[name] = {k: d[k].tobytes() for k in d.files}
    return ledger, cands


def _manifest(outdir, fingerprint):
    path = os.path.join(outdir, f"quarantine_{fingerprint}.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def _assert_same_hits(ours, ref):
    assert [(h[0], h[1]) for h in ours] == [(h[0], h[1]) for h in ref]
    for (_, _, info, table), (_, _, rinfo, rtable) in zip(ours, ref):
        best, rbest = table.best_row(), rtable.best_row()
        assert best["DM"] == rbest["DM"]
        assert best["rebin"] == rbest["rebin"]
        assert best["peak"] == rbest["peak"]
        np.testing.assert_allclose(table["snr"], rtable["snr"], rtol=1e-5)
        assert info.dm == rinfo.dm and info.width == rinfo.width


# ---------------------------------------------------------------------------
# vocabulary and fault plans
# ---------------------------------------------------------------------------

def test_reason_constants_equal_jax():
    assert reasons.__all__ == jax_reasons.__all__
    for name in jax_reasons.__all__:
        if name != "is_known_reason":
            assert getattr(reasons, name) == getattr(jax_reasons, name), name
    for reason in ("read_error", "integrity:nan_frac,dead_frac", "bogus"):
        assert reasons.is_known_reason(reason) \
            == jax_reasons.is_known_reason(reason)


def test_fault_plan_budgets_and_json_round_trip():
    specs = [dict(site="dispatch", kind="error", times=2),
             dict(site="persist", kind="error", chunks=(8,), times=None),
             dict(site="corrupt", kind="impulse", amp=50.0, seed=3),
             dict(site="read", kind="truncate", frac=0.5, exc="OSError")]
    plan = FaultPlan([FaultSpec(**s) for s in specs])
    assert plan.to_json() == JaxFaultPlan(
        [JaxFaultSpec(**s) for s in specs]).to_json()
    with plan.armed():
        for _ in range(2):
            with pytest.raises(RuntimeError, match="FAULTPLAN"):
                fault_inject.fire("dispatch", chunk=0)
        fault_inject.fire("dispatch", chunk=0)  # budget spent: no-op
        fault_inject.fire("persist", chunk=7)   # other chunk: no-op
        for _ in range(3):                      # times=None: persistent
            with pytest.raises(OSError):
                fault_inject.fire("persist", chunk=8)
        assert fault_inject.truncated_length("read", 0, 100) == 50
    assert plan.fired("dispatch") == 2 and plan.fired("persist") == 3
    fault_inject.fire("dispatch", chunk=0)      # disarmed again
    clone = FaultPlan.from_json(plan.to_json())
    assert [s.to_json() for s in clone.specs] \
        == [s.to_json() for s in plan.specs]
    assert clone.fired() == 0
    # the JAX package's plan JSON arms the port's plan
    jax_clone = FaultPlan.from_json(JaxFaultPlan.from_json(
        plan.to_json()).to_json())
    assert jax_clone.to_json() == plan.to_json()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8])
@pytest.mark.parametrize("kinds", [("nan",), ("inf",), ("dead_channels",),
                                   ("zero_run",), ("saturate",),
                                   ("impulse",), ("nan", "saturate")],
                         ids=lambda k: "+".join(k))
def test_corrupt_equals_jax(kinds, dtype):
    rng = np.random.default_rng(11)
    block = (np.abs(rng.normal(20.0, 3.0, (16, 300)))).astype(dtype)
    specs = [dict(site="corrupt", kind=k, frac=0.05, seed=4, times=None)
             for k in kinds]
    with FaultPlan([FaultSpec(**s) for s in specs]).armed():
        assert fault_inject.wants_corrupt("corrupt", 7)
        ours = fault_inject.corrupt("corrupt", block, chunk=7)
    with JaxFaultPlan([JaxFaultSpec(**s) for s in specs]).armed():
        ref = jax_inject.corrupt("corrupt", block, chunk=7)
    assert ours is not block and ours.dtype == ref.dtype
    assert ours.dtype == (np.float32 if dtype == np.uint8 else dtype)
    np.testing.assert_array_equal(ours, ref)
    # disarmed, or another chunk: the same object back
    assert fault_inject.corrupt("corrupt", block, chunk=7) is block
    assert not fault_inject.wants_corrupt("corrupt", 7)


def test_corrupt_budget_spent_reads_normally():
    plan = FaultPlan([FaultSpec(site="corrupt", kind="nan", chunks=(5,),
                                times=1)])
    block = np.ones((4, 64), np.float32)
    with plan.armed():
        assert not fault_inject.wants_corrupt("corrupt", 4)
        assert fault_inject.wants_corrupt("corrupt", 5)
        assert np.isnan(fault_inject.corrupt("corrupt", block, 5)).any()
        assert not fault_inject.wants_corrupt("corrupt", 5)
        assert fault_inject.corrupt("corrupt", block, 5) is block


def test_oom_kind_raises_the_cards_error():
    plan = FaultPlan([FaultSpec(site="dispatch", kind="oom", times=1),
                      FaultSpec(site="host", kind="oom", times=1)])
    with plan.armed():
        with pytest.raises(torch.OutOfMemoryError) as info:
            fault_inject.fire("dispatch", chunk=0)
        assert ladder.is_resource_exhausted(info.value)
        with pytest.raises(MemoryError) as info:
            fault_inject.fire("host", chunk=0)
        assert ladder.is_resource_exhausted(info.value)
    assert plan.fired() == 2


def test_env_var_arms_a_plan(monkeypatch):
    blob = FaultPlan([FaultSpec(site="read", kind="error")]).to_json()
    monkeypatch.setattr(fault_inject, "_ACTIVE", None)
    monkeypatch.setattr(fault_inject, "_ENV_CHECKED", False)
    monkeypatch.setenv("PUTPU_FAULT_PLAN", blob)
    with pytest.raises(OSError, match="FAULTPLAN"):
        fault_inject.fire("read", chunk=0)
    fault_inject.fire("read", chunk=0)  # times=1: spent


def test_env_armed_read_fault_spares_badchans_prescan(survey_file, tmp_path,
                                                      monkeypatch):
    path = str(tmp_path / "fresh.fil")
    shutil.copy(survey_file, path)  # no .badchans cache: a cold scan
    blob = FaultPlan([FaultSpec(site="read", kind="error", chunks=(0,),
                                times=1)]).to_json()
    monkeypatch.setattr(fault_inject, "_ACTIVE", None)
    monkeypatch.setattr(fault_inject, "_ENV_CHECKED", False)
    monkeypatch.setenv("PUTPU_FAULT_PLAN", blob)
    before = _total(REGISTRY, "putpu_read_retries_total")
    _, store = search_by_chunks(path, device="cpu",
                                output_dir=str(tmp_path / "out"), **SEARCH)
    plan = fault_inject.active()
    # the fault fired on the search chunk (retried, recovered), not on the
    # pre-scan of the same seam
    assert plan.fired("read") == 1
    assert _total(REGISTRY, "putpu_read_retries_total") == before + 1
    assert store.quarantined_chunks == {}
    assert store.done_chunks == [0, 8192, 16384]


# ---------------------------------------------------------------------------
# the integrity gate
# ---------------------------------------------------------------------------

def _gate_block(case):
    rng = np.random.default_rng(4)
    block = np.abs(rng.normal(1.0, 0.3, (8, 512))).astype(np.float32)
    policy = "sanitize"
    if case == "nan_channel_head":
        block[0, :50] = np.nan
    elif case == "nan_strict":
        block[0, :50] = np.nan
        policy = "strict"
    elif case == "all_nan":
        block[:] = np.nan
    elif case == "nan_channel":
        block[2] = np.nan
        block[5, 7] = np.inf
    elif case == "dead":
        block[:6] = 0.0
    elif case == "inf_and_negative":
        block -= 5.0
        block[1, ::7] = -np.inf
    elif case == "saturated":
        block[:, ::2] = block.max()
    elif case == "zero_run":
        block[:, 10:500] = 0.0
    elif case == "dc_offset":
        block = rng.normal(2e5, 5.0, (16, 4096)).astype(np.float32)
    elif case == "tiny_nan":
        block = np.abs(rng.normal(1.0, 0.3, (1024, 4096))).astype(
            np.float32)
        block[3, 100] = np.nan
        block[9, 2000] = np.nan
    elif case == "even_medians":
        block = rng.integers(0, 6, (6, 40)).astype(np.float32)
        block[:, ::5] = np.nan
    return block, policy


GATE_CASES = ["clean", "nan_channel_head", "nan_strict", "all_nan",
              "nan_channel", "dead", "inf_and_negative", "saturated",
              "zero_run", "dc_offset", "tiny_nan", "even_medians"]


@pytest.mark.parametrize("case", GATE_CASES)
def test_gate_equals_jax(case):
    """Verdict, stats and sanitized values: the host gate on the float64
    block and the tensor gate on the float32 block (the card's form) are
    the JAX package's gate_chunk on the float64 block."""
    block32, name = _gate_block(case)
    block = block32.astype(np.float64)
    policy = resolve_integrity_policy(name)
    jax_policy = JaxPolicy(sanitize=policy.sanitize)
    ref_out, ref = jax_gate_chunk(block, jax_policy)
    out, info = gate_chunk(block, policy)
    assert info == ref
    np.testing.assert_array_equal(out, ref_out)
    tensor = torch.from_numpy(block32)
    tout, tinfo = gate_tensor(tensor, policy)
    assert tinfo == ref
    if ref["verdict"] == "sanitized":
        assert tout.dtype == torch.float32
        np.testing.assert_array_equal(tout.numpy(),
                                      ref_out.astype(np.float32))
    else:
        assert tout is tensor and out is block
    if case == "tiny_nan":
        assert ref["verdict"] == "sanitized" and ref["stats"]["nan_frac"] == 0


@pytest.mark.parametrize("nbits", [8, 16, 32])
def test_gate_on_stored_frames_equals_jax(tmp_path, nbits):
    """The loop's form: the block the stored frames become on the device,
    gated there, against the JAX gate on the JAX reader's block."""
    rng = np.random.default_rng(nbits)
    array = rng.uniform(0, 200, (24, 900))
    array[:14, :] = 17.0                      # dead channels
    array[:, 300:500] = 0.0                   # a dropped-packet run
    header = {"bandwidth": 200., "fbottom": 1200., "nchans": 24,
              "nsamples": 900, "tsamp": 5e-4}
    path = str(tmp_path / "f.fil")
    write_simulated_filterbank(path, array, header, descending=True,
                               nbits=nbits)
    ours = FilterbankReader(path)
    frames = np.zeros((900, 24), ours.frame_dtype)
    n = ours.read_frames_into(0, 900, frames)
    block = ours.block_from_frames(torch.from_numpy(frames[:n]))
    ref_block = JaxReader(path).read_block(0, 900, band_ascending=True)
    for policy in (IntegrityPolicy(), IntegrityPolicy(max_dead_frac=0.6,
                                                      max_zero_frac=0.9)):
        _, info = gate_tensor(block, policy)
        if nbits == 8:  # the loop gates 8-bit frames as stored
            assert gate_frames(torch.from_numpy(frames[:n]), policy) == info
        _, ref = jax_gate_chunk(ref_block, JaxPolicy(
            max_dead_frac=policy.max_dead_frac,
            max_zero_frac=policy.max_zero_frac))
        assert info == ref


@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
@pytest.mark.parametrize("case", ["noise", "dead_zero_rail", "saturated"])
def test_gate_frames_equals_jax(dtype, case):
    """The byte histogram's counts: signed and unsigned 8-bit frames
    (``nsamp, nchan``), against the JAX gate on their float block."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(21)
    frames = rng.integers(info.min, info.max, (3000, 40), endpoint=True,
                          dtype=dtype)
    if case == "dead_zero_rail":
        frames[:, :25] = -7 if dtype == np.int8 else 7
        frames[100:2900] = 0
    elif case == "saturated":
        frames[::2] = info.max
    _, ref = jax_gate_chunk(frames.T.astype(np.float64), JaxPolicy())
    assert gate_frames(torch.from_numpy(frames), IntegrityPolicy()) == ref


def test_resolve_integrity_policy():
    assert resolve_integrity_policy("off") is None
    assert resolve_integrity_policy(None) is None
    assert resolve_integrity_policy("strict") == IntegrityPolicy(
        sanitize=False)
    with pytest.raises(ValueError, match="quarantine policy"):
        resolve_integrity_policy("bogus")


# ---------------------------------------------------------------------------
# the dispatch deadline
# ---------------------------------------------------------------------------

def test_call_with_deadline():
    assert call_with_deadline(lambda: 42) == 42           # inline when off
    assert call_with_deadline(lambda: 42, 5.0) == 42
    with pytest.raises(ZeroDivisionError):
        call_with_deadline(lambda: 1 / 0, 5.0)            # exc propagates
    t0 = time.perf_counter()
    with pytest.raises(DispatchTimeoutError, match="deadline"):
        call_with_deadline(lambda: time.sleep(1.0), 0.2)
    assert time.perf_counter() - t0 < 0.9
    assert join_abandoned(5.0) == 0


# ---------------------------------------------------------------------------
# the ledger, the manifest and the audit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("marks", [
    [(0, None)],
    [(0, None), (8192, "integrity:nan_frac")],
    [(16384, "read_error"), (0, None), (8192, None), (100000, "oom_floor"),
     (24576, "persist_dead_letter")],
    [(0, None), (0, "read_error"), (0, "read_error"), (8192, None)],
], ids=["plain", "one_reason", "unordered", "reason_after_done"])
def test_ledger_bytes_equal_jax(tmp_path, marks):
    fp = config_fingerprint(x="ledger")
    ours = CandidateStore(str(tmp_path / "t"), fp)
    ref = JaxStore(str(tmp_path / "j"), fp)
    for istart, reason in marks:
        ours.mark_done(istart, reason=reason)
        ref.mark_done(istart, reason=reason)
        with open(ours._ledger_path, "rb") as f, \
                open(ref._ledger_path, "rb") as g:
            assert f.read() == g.read()
    assert ours.quarantined_chunks == ref.quarantined_chunks
    assert ours.done_chunks == ref.done_chunks


@pytest.mark.parametrize("removable", [True, False])
def test_torn_ledger_backed_up(tmp_path, caplog, monkeypatch, removable):
    fp = config_fingerprint(x="torn")
    store = CandidateStore(str(tmp_path), fp)
    for c in (0, 8192, 16384):
        store.mark_done(c)
    path = store._ledger_path
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    if not removable:
        def refuse(src, dst):
            raise OSError("read-only directory")

        monkeypatch.setattr(os, "replace", refuse)
    with caplog.at_level(logging.WARNING, logger="pulsarutils_tpu_torch"):
        fresh = CandidateStore(str(tmp_path), fp)
    monkeypatch.undo()
    assert fresh.done_chunks == [] and not fresh.is_done(0)
    assert os.path.exists(path + ".corrupt") == removable
    backup = path + ".corrupt" if removable else "<unremovable>"
    assert any("torn/corrupt resume ledger" in r.getMessage()
               and backup in r.getMessage() for r in caplog.records)
    fresh.mark_done(0)
    assert CandidateStore(str(tmp_path), fp).done_chunks == [0]


def test_ledger_oserror_propagates(tmp_path, monkeypatch):
    import builtins

    fp = config_fingerprint(x="io")
    store = CandidateStore(str(tmp_path), fp)
    store.mark_done(0)
    real_open = builtins.open

    def flaky_open(path, *a, **k):
        if str(path).endswith(f"progress_{fp}.json"):
            raise OSError("transient EIO")
        return real_open(path, *a, **k)

    monkeypatch.setattr(builtins, "open", flaky_open)
    with pytest.raises(OSError, match="EIO"):
        CandidateStore(str(tmp_path), fp)
    monkeypatch.undo()
    assert CandidateStore(str(tmp_path), fp).done_chunks == [0]
    assert not os.path.exists(store._ledger_path + ".corrupt")


def _npz(path):
    np.savez_compressed(path, __scalars__=json.dumps({"nbin": 4}))


def _audit_dir(directory, case):
    """An output directory holding one kind of inconsistency."""
    fp = config_fingerprint(x="audit")
    store = JaxStore(str(directory), fp)
    manifest = JaxManifest(str(directory), fp)
    base = os.path.join(str(directory), "survey_{}-{}")
    if case == "torn_pair":
        store.mark_done(0)
        _npz(base.format(0, 16384) + ".info.npz")
    elif case == "dead_letter_remnant":
        _npz(base.format(0, 16384) + ".info.npz")
        manifest.record(0, 16384, "persist_dead_letter")
        store.mark_done(0, reason="persist_dead_letter")
    elif case == "quarantined_with_candidate":
        for part in ("info", "table"):
            _npz(base.format(8192, 24576) + f".{part}.npz")
        manifest.record(8192, 24576, "integrity:nan_frac")
        store.mark_done(8192, reason="integrity:nan_frac")
    elif case == "manifest_mismatch":
        manifest.record(0, 16384, "read_error")
        store.mark_done(8192, reason="short_read")
        for part in ("info", "table"):  # an unmarked pair: an orphan
            _npz(base.format(16384, 32768) + f".{part}.npz")
        _npz(os.path.join(str(directory), "other_0-16384.info.npz"))
    elif case == "torn_manifest":
        manifest.record(0, 16384, "integrity:nan_frac")
        store.mark_done(0, reason="integrity:nan_frac")
        with open(manifest.path, "a") as f:
            f.write('{"chunk": 8192, "end": 245')
    elif case == "torn_ledger":
        store.mark_done(0)
        with open(store._ledger_path, "r+b") as f:
            blob = f.read()
            f.seek(0)
            f.truncate()
            f.write(blob[: len(blob) // 2])
    return fp


@pytest.mark.parametrize("case", [
    "torn_pair", "dead_letter_remnant", "quarantined_with_candidate",
    "manifest_mismatch", "torn_manifest", "torn_ledger"])
def test_audit_equals_jax(tmp_path, case):
    fp = _audit_dir(tmp_path / "a", case)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    for repair in (False, True):
        ours = audit_run(str(tmp_path / "a"), fp, root="survey",
                         repair=repair)
        ref = jax_audit_run(str(tmp_path / "a"), fp, root="survey",
                            repair=repair)
        if repair:  # the JAX audit ran second and found nothing to repair
            ref = json.loads(json.dumps(jax_audit_run(
                str(tmp_path / "b"), fp, root="survey", repair=True)).replace(
                    str(tmp_path / "b"), str(tmp_path / "a")))
        assert ours == ref
    assert sorted(os.listdir(tmp_path / "a")) \
        == sorted(os.listdir(tmp_path / "b"))
    assert audit_run(str(tmp_path / "a"), None) \
        == jax_audit_run(str(tmp_path / "a"), None)


def test_quarantine_manifest_equals_jax(tmp_path):
    ours = QuarantineManifest(str(tmp_path / "t"), "fp")
    ref = JaxManifest(str(tmp_path / "j"), "fp")
    for m in (ours, ref):
        m.record(0, 16384, "read_error", {"error": "x"})
        m.record(8192, 24576, "integrity:nan_frac", {"nan_frac": 0.9})
    with open(ours.path, "rb") as f, open(ref.path, "rb") as g:
        assert f.read() == g.read()
    assert ours.records() == ref.records()


# ---------------------------------------------------------------------------
# the OOM ladder
# ---------------------------------------------------------------------------

def test_is_resource_exhausted():
    assert ladder.is_resource_exhausted(torch.OutOfMemoryError("x"))
    assert ladder.is_resource_exhausted(MemoryError())
    assert ladder.is_resource_exhausted(
        RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to "
                     "allocate 17179869184 bytes."))
    assert ladder.is_resource_exhausted(
        RuntimeError("CUDA error: out of memory"))
    assert not ladder.is_resource_exhausted(
        RuntimeError("FAULTPLAN: injected dispatch error (chunk=0)"))
    assert not ladder.is_resource_exhausted(
        ValueError("Out of memory-shaped but a config error"))
    assert not ladder.is_resource_exhausted(TypeError("out of memory"))


@pytest.mark.parametrize("nblocks", [1, 8, 33])
def test_direct_plan_levels_equal_jax(nblocks):
    for _ in range(7):
        assert ladder.direct_plan(nblocks) \
            == jax_ladder.direct_plan("gather", nblocks)
        assert ladder.direct_maxed(nblocks) \
            == jax_ladder.direct_maxed("gather", nblocks)
        ladder.descend("split_dm")
        jax_ladder.descend("split_dm")
    ladder.reset()
    assert ladder.level() == 0 and ladder.direct_plan(8) == 1


@pytest.mark.parametrize("capture", [False, True])
def test_split_sweep_is_bitwise_the_unsplit(capture):
    """Every ladder level's table (and plane) equals level 0's bit for
    bit: trial rows are independent sums, scored one by one."""
    rng = np.random.default_rng(5)
    data = (np.abs(rng.normal(0, 1, (64, 4096))) + 5).astype(np.float32)
    kw = dict(dmmin=100, dmmax=300, start_freq=1200., bandwidth=200.,
              sample_time=TSAMP, device="cpu", capture_plane=capture)
    ref = search_ops.dedispersion_search(data, **kw)
    ref_table, ref_plane = ref if capture else (ref, None)
    assert ref_table.nrows > 2 * search_ops.LADDER_FLOOR_ROWS
    sizes = []
    while sizes[-1:] != [search_ops.LADDER_FLOOR_ROWS]:
        ladder.descend("split_dm")
        sizes.append(search_ops.ladder_superblock(ref_table.nrows))
        out = search_ops.dedispersion_search(data, **kw)
        table, plane = out if capture else (out, None)
        for col in ref_table.colnames:
            assert np.array_equal(table[col], ref_table[col]), col
        if capture:
            assert torch.equal(plane, ref_plane)
    assert sizes == sorted(sizes, reverse=True) and len(sizes) > 1
    assert search_ops.ladder_superblock(ref_table.nrows) \
        == search_ops.LADDER_FLOOR_ROWS


def test_direct_sweep_oom_descends_and_recovers(monkeypatch):
    rng = np.random.default_rng(6)
    data = (np.abs(rng.normal(0, 1, (64, 2048))) + 5).astype(np.float32)
    kw = dict(dmmin=100, dmmax=400, start_freq=1200., bandwidth=200.,
              sample_time=TSAMP, device="cpu")
    ref = search_ops.dedispersion_search(data, **kw)
    real = search_ops._search_direct
    calls = []

    def flaky(*args, **kwargs):
        calls.append(ladder.level())
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return real(*args, **kwargs)

    monkeypatch.setattr(search_ops, "_search_direct", flaky)
    before = _total(REGISTRY, "putpu_oom_events_total")
    table = search_ops.dedispersion_search(data, **kw)
    assert calls == [0, 1] and ladder.level() == 1
    assert _total(REGISTRY, "putpu_oom_events_total") == before + 1
    for col in ref.colnames:
        assert np.array_equal(table[col], ref[col]), col
    # a configuration error is never taken for an OOM
    monkeypatch.setattr(search_ops, "_search_direct",
                        lambda *a, **k: (_ for _ in ()).throw(
                            ValueError("out of memory")))
    with pytest.raises(ValueError):
        search_ops.dedispersion_search(data, **kw)
    assert ladder.level() == 1


# ---------------------------------------------------------------------------
# the driver under a fault plan, against the JAX driver
# ---------------------------------------------------------------------------

#: scenario -> (fault specs, driver knobs for both packages)
SCENARIOS = {
    "hard_corrupt": ([dict(site="corrupt", kind="nan", chunks=(0,),
                           frac=0.9)], {}),
    "sanitized": ([dict(site="corrupt", kind="nan", chunks=(0,),
                        frac=0.02)], {}),
    "persist_transient": ([dict(site="persist", kind="error")],
                          dict(persist_backoff=0.01)),
    "persist_persistent": ([dict(site="persist", kind="error", times=None)],
                           dict(persist_backoff=0.01)),
    "read_error": ([dict(site="read", kind="error", chunks=(8192,),
                         times=None)], {}),
    "short_read": ([dict(site="read", kind="truncate", chunks=(16384,),
                         frac=0.5)], {}),
    "dispatch_transient": ([dict(site="dispatch", kind="error",
                                 chunks=(8192,))], {}),
    "dispatch_persistent": ([dict(site="dispatch", kind="error",
                                  times=None)], {}),
    "oom_transient": ([dict(site="dispatch", kind="oom", chunks=(0,))], {}),
    "oom_floor": ([dict(site="dispatch", kind="oom", chunks=(0,),
                        times=None),
                   dict(site="host", kind="oom", chunks=(0,), times=None)],
                  {}),
    "serial_hard_corrupt": ([dict(site="corrupt", kind="nan", chunks=(8192,),
                                  frac=0.9)], dict(overlap_persist=False)),
}


@pytest.fixture(scope="module")
def clean_port_run(survey_file, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("clean"))
    ladder.reset()
    _, store = search_by_chunks(survey_file, device="cpu", output_dir=out,
                                **SEARCH)
    return _snapshot(out, store.fingerprint)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_fault_scenario_equals_jax_driver(survey_file, clean_port_run,
                                          tmp_path, scenario):
    specs, knobs = SCENARIOS[scenario]
    jax_before = _counts(JAX_REGISTRY)
    with JaxFaultPlan([JaxFaultSpec(**s) for s in specs]).armed():
        ref_hits, ref_store = jax_search_by_chunks(
            survey_file, output_dir=str(tmp_path / "jax"), **JAX_KW,
            **SEARCH, **knobs)
    jax_delta = {k: v - jax_before[k]
                 for k, v in _counts(JAX_REGISTRY).items()}
    before = _counts(REGISTRY)
    summary = {}
    plan = FaultPlan([FaultSpec(**s) for s in specs])
    with plan.armed():
        hits, store = search_by_chunks(
            survey_file, device="cpu", output_dir=str(tmp_path / "port"),
            summary=summary, **SEARCH, **knobs)
    delta = {k: v - before[k] for k, v in _counts(REGISTRY).items()}
    assert plan.fired() > 0
    floor_descents = (search_ops.ladder_blocks(hits[0][3].nrows)
                      - 1).bit_length()
    if scenario == "oom_floor":
        # one ladder: the port descends only while the sweep has a smaller
        # dispatch left, then goes straight to the host path, where the
        # JAX package also re-dispatches the unchanged sweep and retries
        # it once; the outcome below is the same
        assert floor_descents >= 1
        for name, ours_n in (("putpu_oom_events_total", floor_descents + 2),
                             ("putpu_faults_injected_total",
                              floor_descents + 2),
                             ("putpu_dispatch_retries_total", 0)):
            assert delta.pop(name) == ours_n, name
            jax_delta.pop(name)
    assert store.done_chunks == ref_store.done_chunks
    assert store.quarantined_chunks == ref_store.quarantined_chunks
    ours = _manifest(str(tmp_path / "port"), store.fingerprint)
    ref = _manifest(str(tmp_path / "jax"), ref_store.fingerprint)
    if scenario == "oom_floor":  # the error texts name each package's floor
        ours = [{k: v for k, v in r.items() if k != "stats"} for r in ours]
        ref = [{k: v for k, v in r.items() if k != "stats"} for r in ref]
    assert ours == ref
    _assert_same_hits(hits, ref_hits)
    assert delta == jax_delta
    assert summary["quarantined"] == len(store.quarantined_chunks)
    assert audit_run(str(tmp_path / "port"), store.fingerprint,
                     root="survey")["ok"]
    if scenario == "dispatch_persistent":
        assert summary["fallback"] == {
            "stage": "search", "device": "cpu", "kernel": "auto",
            "chunk": 0, "from_device": "cpu", "from_kernel": "auto"}
        assert plan.fired("dispatch") == 2  # found once: sticky
    else:
        assert summary["fallback"] is None
    assert summary["oom_descents"] == {
        "oom_transient": 1, "oom_floor": floor_descents}.get(scenario, 0)
    if scenario in ("sanitized", "persist_transient", "dispatch_transient",
                    "dispatch_persistent", "oom_transient"):
        # recovered: the clean run's ledger and candidates byte for byte
        assert _snapshot(str(tmp_path / "port"),
                         store.fingerprint) == clean_port_run


def test_dead_channels_quarantined_by_the_frames_gate(dead_file, tmp_path):
    """8-bit frames gated as stored, after the upload: the dead chunk is
    quarantined with the JAX gate's stats; the next chunk is searched."""
    ref_hits, ref_store = jax_search_by_chunks(
        dead_file, output_dir=str(tmp_path / "jax"), **JAX_KW, **SEARCH)
    stages = {}
    hits, store = search_by_chunks(dead_file, device="cpu",
                                   output_dir=str(tmp_path / "port"),
                                   stage_seconds=stages, **SEARCH)
    assert store.quarantined_chunks == ref_store.quarantined_chunks \
        == {"0": "integrity:dead_frac"}
    assert _manifest(str(tmp_path / "port"), store.fingerprint) \
        == _manifest(str(tmp_path / "jax"), ref_store.fingerprint)
    _assert_same_hits(hits, ref_hits)
    assert stages["gate"] > 0


def test_quarantined_chunk_not_searched_on_resume(survey_file, tmp_path):
    out = str(tmp_path)
    spec = dict(site="corrupt", kind="nan", chunks=(0,), frac=0.9)
    with FaultPlan([FaultSpec(**spec)]).armed():
        hits, store = search_by_chunks(survey_file, device="cpu",
                                       output_dir=out, **SEARCH)
    assert store.quarantined_chunks == {"0": "integrity:nan_frac"}
    plan = FaultPlan([FaultSpec(**spec)])
    summary = {}
    with plan.armed():
        hits2, store2 = search_by_chunks(survey_file, device="cpu",
                                         output_dir=out, summary=summary,
                                         **SEARCH)
    assert plan.fired() == 0 and summary["searched"] == 0
    assert store2.quarantined_chunks == {"0": "integrity:nan_frac"}
    assert [h[:2] for h in hits2] == [h[:2] for h in hits]


def test_dispatch_hang_is_bounded(survey_file, tmp_path):
    """A 2 s hang on chunk 0 under a 1.5 s deadline (five times a chunk's
    search here): the chunk moves on (one retry), the run finds the
    pulse, and the abandoned attempt is joined."""
    plan = FaultPlan([FaultSpec(site="dispatch", kind="hang", seconds=2.0,
                                chunks=(0,))])
    before = _total(REGISTRY, "putpu_dispatch_retries_total")
    summary = {}
    with plan.armed():
        hits, store = search_by_chunks(
            survey_file, device="cpu", output_dir=str(tmp_path),
            dispatch_timeout=1.5, dispatch_retries=2, dispatch_backoff=0.01,
            summary=summary, **SEARCH)
    assert join_abandoned(30.0) == 0
    assert plan.fired() == 1 and summary["fallback"] is None
    assert _total(REGISTRY, "putpu_dispatch_retries_total") == before + 1
    assert any(lo <= PULSE_T < hi for lo, hi, _, _ in hits)
    assert store.done_chunks == [0, 8192, 16384]


#: the card's floor for a 514-trial sweep: 32 trial blocks, 5 descents
CARD_NDM = 514


def _oom():
    return torch.OutOfMemoryError("CUDA out of memory (test)")


#: case -> (kernel, the errors of successive calls (None: success),
#:          the expected exception type or None, calls, OOM descents)
CARD_CASES = {
    "persistent_error": ("auto", [RuntimeError("launch timed out")] * 9,
                         RuntimeError, 2, 0),
    "transient_error": ("auto", [RuntimeError("launch timed out"), None],
                        None, 2, 0),
    "build_error": ("auto", [nvcc.KernelBuildError("nvcc failed")],
                    nvcc.KernelBuildError, 1, 0),
    "transient_oom": ("auto", [_oom(), None], None, 2, 1),
    "persistent_oom": ("auto", [_oom()] * 9, ladder.OOMFloorError, 6, 5),
    "hybrid_oom": ("hybrid", [_oom()] * 9, ladder.OOMFloorError, 2, 1),
    "hybrid_transient_oom": ("hybrid", [_oom(), None], None, 2, 1),
}


@pytest.mark.parametrize("case", list(CARD_CASES))
def test_card_search_never_falls_back(monkeypatch, case):
    """On a CUDA device the dispatch is retried on the card, an OOM
    descends while the sweep has a smaller dispatch left (the hybrid
    descends the ``unfuse`` rung once), and then the error
    propagates (``oom_floor`` for an OOM): no call ever runs on the CPU
    and nothing is recorded as a fallback."""
    kernel, errors, raises, ncalls, descents = CARD_CASES[case]
    calls = []

    def search(*args, kernel, device, **kwargs):
        calls.append((kernel, device))
        err = errors[len(calls) - 1]
        if err is not None:
            raise err
        return "table"

    monkeypatch.setattr(search_pipeline, "dedispersion_search", search)
    fallbacks = _total(REGISTRY, "putpu_fallbacks_total")
    state = {}
    run = lambda: search_pipeline._search_with_fallback(  # noqa: E731
        None, 100, 200, 1200., 200., TSAMP, device=torch.device("cuda"),
        kernel=kernel, capture_plane=False, state=state, ndm=CARD_NDM,
        chunk=0)
    if raises is None:
        assert run() == "table"
    else:
        with pytest.raises(raises):
            run()
    assert calls == [(kernel, torch.device("cuda"))] * ncalls
    assert ladder.level() == descents
    assert state == {}
    assert _total(REGISTRY, "putpu_fallbacks_total") == fallbacks


def test_clean_failure_propagates_without_fallback(survey_file, tmp_path,
                                                   monkeypatch):
    """A failed clean fails the run: no retry on the host, nothing
    marked done."""
    def broken(*args, **kwargs):
        raise RuntimeError("clean failed (test)")

    monkeypatch.setattr(search_pipeline, "clean_chunk", broken)
    fallbacks = _total(REGISTRY, "putpu_fallbacks_total")
    with pytest.raises(RuntimeError, match="clean failed"):
        search_by_chunks(survey_file, device="cpu",
                         output_dir=str(tmp_path), **SEARCH)
    assert _total(REGISTRY, "putpu_fallbacks_total") == fallbacks
    assert not [f for f in os.listdir(tmp_path)
                if f.startswith(("progress_", "quarantine_"))]


# ---------------------------------------------------------------------------
# resume and the periodicity driver
# ---------------------------------------------------------------------------

def _truncate(path):
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])


def _bitrot(path):
    with zipfile.ZipFile(path) as z:
        first = z.infolist()[0]
    with open(path, "r+b") as f:
        f.seek(first.header_offset + 26)
        nlen, elen = struct.unpack("<HH", f.read(4))
        f.seek(first.header_offset + 30 + nlen + elen + 2)
        f.write(b"\xde\xad\xbe\xef")


@pytest.mark.parametrize("damage,suffix", [(_truncate, ".info.npz"),
                                           (_bitrot, ".table.npz")],
                         ids=["truncated_zip", "bitrotted_deflate"])
def test_resume_skips_corrupt_pair_and_counts(survey_file, tmp_path, damage,
                                              suffix):
    out = str(tmp_path)
    hits, _ = search_by_chunks(survey_file, device="cpu", output_dir=out,
                               **SEARCH)
    assert len(hits) == 2
    damage(os.path.join(out, sorted(f for f in os.listdir(out)
                                    if f.endswith(suffix))[0]))
    before = _total(REGISTRY, "putpu_resume_pairs_skipped_total")
    hits2, _ = search_by_chunks(survey_file, device="cpu", output_dir=out,
                                **SEARCH)
    assert _total(REGISTRY, "putpu_resume_pairs_skipped_total") \
        == before + 1
    assert len(hits2) == 1


def test_periodicity_driver_leaves_quarantined_chunks_out(tmp_path, caplog):
    from pulsarutils_tpu_torch.models.simulate import \
        simulate_accel_pulsar_data
    from pulsarutils_tpu_torch.periodicity import periodicity_search
    from pulsarutils_tpu_torch.periodicity.candidates import load_candidates

    arr, hdr = simulate_accel_pulsar_data(
        freq=492 / (16384 * TSAMP), dm=150.0, tsamp=TSAMP, nsamples=16384,
        nchan=32, rng=13)
    path = str(tmp_path / "psr.fil")
    write_simulated_filterbank(path, arr, hdr, descending=True)
    job = dict(dmmin=130.0, dmmax=170.0, n_accel=3, accel_max=1e5,
               chunk_length=4096 * TSAMP, snr_threshold=8.0, device="cpu",
               output_dir=str(tmp_path / "out"))
    plan = FaultPlan([FaultSpec(site="corrupt", kind="nan", chunks=(4096,),
                                frac=0.9, times=None)])
    with plan.armed(), caplog.at_level(logging.WARNING,
                                       logger="pulsarutils_tpu_torch"):
        res = periodicity_search(path, **job)
    assert plan.fired() == 1  # quarantined once, never re-searched
    assert res["complete"]
    assert res["store"].quarantined_chunks == {"4096": "integrity:nan_frac"}
    assert 4096 not in res["accumulator"].seen
    assert any("quarantined chunk(s) as zeros" in r.getMessage()
               for r in caplog.records)
    _, meta = load_candidates(res["candidates_path"])
    assert meta["quarantined_chunks"] == [4096]


# ---------------------------------------------------------------------------
# kernel build errors never fall back
# ---------------------------------------------------------------------------

def test_launch_error_classifies_missing_architecture():
    """Every refused launch is a KernelBuildError, never retried: a
    missing architecture, too many resources, an invalid configuration,
    a cluster that does not fit."""
    for message in ("no kernel image is available for execution on the "
                    "device", "too many resources requested for launch",
                    "invalid configuration argument",
                    "cluster out of resources",
                    "an illegal memory access was encountered"):
        err = nvcc.launch_error("score kernel", message)
        assert isinstance(err, nvcc.KernelBuildError), message
        assert message in str(err)


def test_build_and_load_failures_are_kernel_build_errors(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nvcc, "nvcc_path", lambda: shutil.which("false"))
    with pytest.raises(nvcc.KernelBuildError, match="nvcc failed"):
        nvcc.build(["score"])
    monkeypatch.setattr(nvcc, "_loaded", {})
    nvcc.library_path("score").write_bytes(b"not a shared library")
    with pytest.raises(nvcc.KernelBuildError, match="cannot load"):
        nvcc.load("score")


def test_kernel_build_error_propagates_without_fallback(survey_file,
                                                        tmp_path,
                                                        monkeypatch):
    """A kernel that cannot be built fails the run: no retry, no host
    fallback, nothing marked done."""
    def broken_loader(name):
        raise nvcc.KernelBuildError(f"nvcc failed for {name}.cu (test)")

    def search(*args, **kwargs):
        nvcc.load("dedisperse")  # the card path loads its kernel first
        raise AssertionError("unreachable")

    monkeypatch.setattr(nvcc, "load", broken_loader)
    monkeypatch.setattr(search_pipeline, "dedispersion_search", search)
    before = _counts(REGISTRY)
    fallbacks = _total(REGISTRY, "putpu_fallbacks_total")
    with pytest.raises(nvcc.KernelBuildError, match="nvcc failed"):
        search_by_chunks(survey_file, device="cpu",
                         output_dir=str(tmp_path), **SEARCH)
    assert _counts(REGISTRY) == before
    assert _total(REGISTRY, "putpu_fallbacks_total") == fallbacks
    # nothing was marked done: no ledger and no manifest were written
    assert not [f for f in os.listdir(tmp_path)
                if f.startswith(("progress_", "quarantine_"))]
