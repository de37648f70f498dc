"""The hybrid's device path: the fused seed program, the rescore off a
device-resident offset table, and the OOM ladder's ``unfuse`` rung.

On the CPU the port's fused program runs its plain kernels
(``_search_hybrid(..., fused=True)``).  It is held against a reference
built from the JAX package's public pieces on the CPU (the XLA transform
with its scores and certificate row, the gather onto ``nearest_rows``,
``jax.lax.top_k``, the Pallas sweep in interpret mode on the rebased
table, ``score_profiles_stacked`` and ``fused_need_stage``): its own
fused program hard-codes the compiled Pallas transform.  Discrete fields
(``sel``, ``sel2``, ``n_need``, windows, peaks) are equal and floats
within rel 1e-5: the JAX package scores the rotated plane of its rebased
sweep, whose float32 sums differ from the port's un-rotated ones in the
last ulp (the seed rows' std and snr by up to 1.3e-7 relative on the
pulse chunk below).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pulsarutils_tpu.ops import certify as jcert
from pulsarutils_tpu.ops import search as jsearch
from pulsarutils_tpu.ops.fdmt import _transform_fn
from pulsarutils_tpu.ops.fdmt import fdmt_trial_dms as jax_fdmt_trial_dms
from pulsarutils_tpu.ops.pallas_dedisperse import (
    dedisperse_plane_pallas_traced, rebase_offsets)

from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec
from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
from pulsarutils_tpu_torch.models.simulate import simulate_test_data
from pulsarutils_tpu_torch.ops import certify as tcert
from pulsarutils_tpu_torch.ops import dedisperse_cuda
from pulsarutils_tpu_torch.ops import search as tsearch
from pulsarutils_tpu_torch.ops.dedisperse import dedisperse_plane_plain
from pulsarutils_tpu_torch.ops.fdmt import fdmt_trial_dms
from pulsarutils_tpu_torch.ops.plan import dedispersion_plan, offsets_for
from pulsarutils_tpu_torch.pipeline import search_pipeline
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks
from pulsarutils_tpu_torch.resilience import ladder
from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

torch.set_num_threads(1)

GEOM = (1200.0, 200.0, 5e-4)
RTOL = 1e-5
NCHAN, NSAMPLES = 64, 4096


@pytest.fixture(autouse=True)
def clean_ladder(monkeypatch):
    # the JAX rescore resolves its formulation through the autotuner; the
    # static choice keeps its runs deterministic
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")
    ladder.reset()
    yield
    ladder.reset()


def _chunk(kind, nchan=NCHAN, t=NSAMPLES, seed=51):
    """The JAX package's simulator's chunk renormalised, as the driver
    searches it: a DM 150 pulse ("pulse"), or noise."""
    if kind == "pulse":
        arr, _ = simulate_test_data(150.0, nsamples=t, nchan=nchan,
                                    rng=seed)
    else:
        arr = np.random.default_rng(seed).standard_normal((nchan, t))
    arr = np.asarray(arr, np.float64)
    arr = (arr - arr.mean(1, keepdims=True)) / arr.std(1, keepdims=True)
    return arr.astype(np.float32)


def _plan(nchan=NCHAN):
    return dedispersion_plan(nchan, 100.0, 200.0, *GEOM)


# ---------------------------------------------------------------------------
# The shared pieces against the JAX package's
# ---------------------------------------------------------------------------

def _topk_inputs():
    rng = np.random.default_rng(4)
    cases = []
    for ndm in (3, 8, 20, 64):
        score = rng.normal(5.0, 1.0, ndm).astype(np.float32)
        score[ndm // 2:ndm // 2 + 3] = 9.5          # ties
        for mask in (rng.random(ndm) < 0.3, np.zeros(ndm, bool),
                     np.ones(ndm, bool)):
            cases.append((score, mask))
    return cases


@pytest.mark.parametrize("bucket", [1, 2, 8, 32])
def test_fused_masked_topk_equals_jax(bucket):
    for score, mask in _topk_inputs():
        sel, n = tsearch.fused_masked_topk(torch.from_numpy(score),
                                           torch.from_numpy(mask), bucket)
        jsel, jn = jsearch.fused_masked_topk(jnp.asarray(score),
                                             jnp.asarray(mask), bucket)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
        assert int(n) == int(jn)


def test_topk_ties_go_to_the_lower_index():
    score = torch.tensor([1.0, 7.0, 3.0, 7.0, 7.0, -np.inf, 7.0])
    sel, n = tsearch.fused_masked_topk(score, torch.ones(7, dtype=torch.bool),
                                       4)
    assert sel.tolist() == [1, 3, 4, 6] and int(n) == 7
    # every row masked: -inf everywhere, the lowest indices, all slots the
    # top one (n = 0)
    sel, n = tsearch.fused_masked_topk(score, torch.zeros(7, dtype=torch.bool),
                                       3)
    assert sel.tolist() == [0, 0, 0] and int(n) == 0


def _need_inputs(seed, ndm=40):
    rng = np.random.default_rng(seed)
    coarse = rng.normal(5.0, 1.5, (6, ndm)).astype(np.float32)
    coarse[5] = coarse[2] * rng.uniform(0.6, 1.0, ndm).astype(np.float32)
    coarse[5, 7:10] = 8.0                           # ties in the cert row
    rescored = rng.random(ndm) < 0.2
    return coarse, rescored


@pytest.mark.parametrize("params", [(0.6, 0.5, np.inf), (0.6, 0.5, 7.0),
                                    (np.inf, 0.5, np.inf),
                                    (np.inf, 0.5, 6.0), (0.8, 2.0, np.inf)])
@pytest.mark.parametrize("bucket2", [3, 8, 64])
def test_fused_need_stage_equals_jax(params, bucket2):
    for seed in range(4):
        coarse, rescored = _need_inputs(seed)
        best = np.float32(coarse[2].max() * 0.9)
        cp = np.asarray(params, np.float32)
        sel2, n = tsearch.fused_need_stage(
            torch.from_numpy(coarse), torch.tensor(best),
            torch.from_numpy(rescored), torch.from_numpy(cp), bucket2)
        jsel2, jn = jsearch.fused_need_stage(
            jnp.asarray(coarse), jnp.asarray(best), jnp.asarray(rescored),
            jnp.asarray(cp), bucket2)
        np.testing.assert_array_equal(sel2.numpy(), np.asarray(jsel2))
        assert int(n) == int(jn)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bucket2", [0, 8])
def test_unpack_fused_hybrid_round_trips(dtype, bucket2):
    rng = np.random.default_rng(2)
    ndm, bucket = 11, 8
    coarse = rng.normal(size=(6, ndm))
    sel = rng.integers(0, ndm, bucket)
    exact = rng.normal(size=(5, bucket))
    parts = [coarse.ravel(), sel, exact.ravel(), [bucket]]
    if bucket2:
        sel2 = rng.integers(0, ndm, bucket2)
        exact2 = rng.normal(size=(5, bucket2))
        parts += [sel2, exact2.ravel(), [3]]
    packed = np.concatenate(parts).astype(dtype)
    ours = tsearch.unpack_fused_hybrid(packed, ndm, bucket, bucket2)
    ref = jsearch.unpack_fused_hybrid(packed, ndm, bucket, bucket2)
    for a, b in zip(ours, ref):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[1], sel)
    assert ours[3] == bucket and ours[6] == (3 if bucket2 else 0)
    scores = np.stack([exact[0], exact[1], exact[2], np.full(bucket, 4.0),
                       np.arange(bucket) * 7.0])
    for a, b in zip(tsearch.fused_scores_to_host(scores),
                    jsearch.fused_scores_to_host(scores, 0, 4096)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_fused_constants_and_cert_params_equal_jax():
    for name in ("HYBRID_SEED_TOPK", "HYBRID_SEED_BUCKET",
                 "HYBRID_NEED_BUCKET"):
        assert getattr(tsearch, name) == getattr(jsearch, name)
    dms = _plan()
    for kw in ({}, {"snr_floor": 8.0}, {"rho_cert": False},
               {"rho_cert": 0.55, "cert_slack": 1.0},
               {"snr_floor": 9.5, "cert_slack": 0.0}):
        ours = tcert.fused_cert_params(NCHAN, dms, *GEOM, NSAMPLES, **kw)
        ref = jcert.fused_cert_params(NCHAN, dms, *GEOM, NSAMPLES, **kw)
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# The device-planned sweep rows
# ---------------------------------------------------------------------------

def _table(nchan=NCHAN, t=NSAMPLES):
    dms = _plan(nchan)
    off = offsets_for(dms, nchan, *GEOM, t)
    return off, dedisperse_cuda.row_table(off, t, torch.device("cpu"))


def test_row_table_bounds_every_subset_and_plans_as_the_host():
    off, table = _table()
    rebased, k = dedisperse_cuda.rebase_offsets(off, NSAMPLES)
    np.testing.assert_array_equal(table.offsets.numpy(), rebased)
    assert table.store_shift == (-k) % NSAMPLES
    assert table.win == dedisperse_cuda.TIME_TILE + table.spread
    # the largest per-channel range of the table, no wider
    assert table.spread == (rebased.max(0) - rebased.min(0)).max()
    assert table.spread < rebased.max()
    rng = np.random.default_rng(0)
    for rows in (np.arange(8), rng.integers(0, len(off), 8),
                 rng.permutation(len(off))[:16], np.arange(len(off))[::-1]):
        plan, meta = dedisperse_cuda.table_plan(table, rows)
        host = dedisperse_cuda.launch_plan(off[rows], NSAMPLES,
                                           trial_block=plan.trial_block)
        # the host plan of the same rows has its own rebase: the least
        # offsets differ by a constant, the marks and rel offsets not
        np.testing.assert_array_equal(meta.numpy()[..., 1:],
                                      host.meta[..., 1:])
        assert plan.spread >= host.spread
        assert meta.dtype == torch.int32 and meta.is_contiguous()


@pytest.mark.parametrize("branch", ["smem", "global"])
def test_table_plan_replay_equals_plain(branch):
    import dataclasses

    from test_torch_dedisperse import _replay_kernel

    data = _chunk("pulse")
    off, table = _table()
    for rows in (np.array([77, 76, 78, 40, 39, 41, 77, 77]),
                 np.arange(len(off))[::7][:16]):
        plan, meta = dedisperse_cuda.table_plan(table, rows)
        plan = dataclasses.replace(plan, meta=meta.numpy(),
                                   offsets=plan.offsets.numpy(),
                                   use_smem=branch == "smem")
        plain = dedisperse_plane_plain(torch.from_numpy(data),
                                       off[rows]).numpy()
        assert np.max(np.abs(_replay_kernel(data, plan) - plain)) == 0.0
        rows_plane = dedisperse_cuda.dedisperse_rows(
            torch.from_numpy(data), table, torch.from_numpy(rows)).numpy()
        assert np.array_equal(rows_plane, plain)


# ---------------------------------------------------------------------------
# The seed program against the JAX package's pieces
# ---------------------------------------------------------------------------

def _jax_seed_reference(data, dms, cert_params, bucket=8, bucket2=8):
    """The JAX fused seed program's steps, from public pieces on the CPU
    (the XLA transform; the Pallas sweep in interpret mode)."""
    nchan, t = data.shape
    f0, bw, tsamp = GEOM
    fdmt_dms, n_lo, n_hi = jax_fdmt_trial_dms(nchan, float(dms.min()),
                                              float(dms.max()), *GEOM)
    idx = jsearch.nearest_rows(fdmt_dms, dms)
    coarse_fn = _transform_fn(nchan, f0, bw, n_hi, t, None, False, False,
                              n_lo=n_lo, with_scores=True, with_plane=False,
                              with_cert=True)
    coarse = jnp.asarray(coarse_fn(jnp.asarray(data)))[:, idx]
    ndm = len(dms)
    k = min(jsearch.HYBRID_SEED_TOPK, ndm)
    _, top = jax.lax.top_k(coarse[2], k)
    sel = jnp.clip(jnp.concatenate([top - 1, top, top + 1]), 0, ndm - 1)
    sel = jnp.concatenate([sel, jnp.broadcast_to(sel[:1], (bucket - 3 * k,))])
    rebased, roll_k, max_off = rebase_offsets(
        jsearch._offsets_for(dms, nchan, f0, bw, tsamp, t), t)

    def rescore(rows):
        plane = dedisperse_plane_pallas_traced(
            jnp.asarray(data), jnp.asarray(rebased)[rows], max_off,
            dm_block=len(rows), interpret=True)
        return np.asarray(jsearch.score_profiles_stacked(plane, xp=jnp))

    exact = rescore(sel)
    rescored = jnp.zeros(ndm, bool).at[sel].set(True)
    sel2, n_need = jsearch.fused_need_stage(
        coarse, jnp.asarray(exact[2].max()), rescored,
        jnp.asarray(cert_params), bucket2)
    exact2 = rescore(sel2)
    return (np.asarray(coarse, np.float64), np.asarray(sel),
            jsearch.fused_scores_to_host(exact, roll_k, t),
            np.asarray(sel2), jsearch.fused_scores_to_host(exact2, roll_k, t),
            int(n_need))


def _assert_scores(ours, ref, what):
    for i, col in enumerate(("max", "std", "snr")):
        np.testing.assert_allclose(ours[i], ref[i], rtol=RTOL,
                                   err_msg=f"{what} {col}")
    for i, col in ((3, "window"), (4, "peak")):
        np.testing.assert_array_equal(ours[i], ref[i],
                                      err_msg=f"{what} {col}")


@pytest.mark.parametrize("kind, floor", [("pulse", None), ("noise", None),
                                         ("noise", 6.0)])
def test_seed_program_equals_jax_pieces(kind, floor):
    data = _chunk(kind)
    dms = _plan()
    ndm = len(dms)
    cp = tcert.fused_cert_params(NCHAN, dms, *GEOM, NSAMPLES,
                                 snr_floor=floor)
    coarse_dms, n_lo, n_hi = fdmt_trial_dms(NCHAN, float(dms.min()),
                                            float(dms.max()), *GEOM)
    idx = tsearch.nearest_rows(coarse_dms, dms)
    table = tsearch._row_table(dms.tobytes(), NCHAN, *GEOM, NSAMPLES,
                               torch.device("cpu"))
    packed = tsearch._fused_seed(torch.from_numpy(data), table, idx, cp,
                                 n_lo, n_hi, GEOM[0], GEOM[1], 8, 8)
    (coarse, sel, seed, n_seed, sel2, need,
     n_need) = tsearch.unpack_fused_hybrid(packed, ndm, 8, 8)
    (rcoarse, rsel, rseed, rsel2, rneed,
     rn_need) = _jax_seed_reference(data, dms, cp)
    np.testing.assert_array_equal(sel, rsel)
    np.testing.assert_array_equal(sel2, rsel2)
    assert n_need == rn_need and n_seed == 8
    for r in (3, 4):
        np.testing.assert_array_equal(coarse[r], rcoarse[r])
    np.testing.assert_allclose(coarse[[0, 1, 2, 5]], rcoarse[[0, 1, 2, 5]],
                               rtol=RTOL)
    _assert_scores(tsearch.fused_scores_to_host(seed), rseed, "seed")
    _assert_scores(tsearch.fused_scores_to_host(need), rneed, "need")
    if kind == "pulse":
        assert abs(dms[sel[1]] - 150.0) < 1.0


def test_rescore_off_the_table_equals_jax_rescore_kernel():
    data = _chunk("pulse")
    dms = _plan()
    table = tsearch._row_table(dms.tobytes(), NCHAN, *GEOM, NSAMPLES,
                               torch.device("cpu"))
    rebased, roll_k, max_off = rebase_offsets(
        jsearch._offsets_for(dms, NCHAN, GEOM[0], GEOM[1], GEOM[2],
                             NSAMPLES), NSAMPLES)
    rng = np.random.default_rng(9)
    for rows in (np.arange(70, 78), rng.integers(0, len(dms), 16),
                 rng.permutation(len(dms))[:32]):
        ours = tsearch.unstack_scores(tsearch.score_profiles_stacked(
            dedisperse_cuda.dedisperse_rows(torch.from_numpy(data), table,
                                            rows)))
        run = jsearch._fused_rescore_kernel(max_off, len(rows))
        m, s, b, w, p = jsearch.unstack_scores(
            run(jnp.asarray(data), jnp.asarray(rebased[rows])))
        _assert_scores(ours, (m, s, b, w, (p - roll_k) % NSAMPLES),
                       "rescore")


# ---------------------------------------------------------------------------
# The whole fused search
# ---------------------------------------------------------------------------

def _fused_table(data, **kw):
    return tsearch.dedispersion_search(data, 100.0, 200.0, *GEOM,
                                       kernel="hybrid", device="cpu", **kw)


@pytest.fixture
def force_fused(monkeypatch):
    """Take the fused path on the CPU wherever the card would."""
    monkeypatch.setattr(tsearch, "_fused_default", lambda data: True)


@pytest.mark.parametrize("kind", ["pulse", "noise"])
def test_fused_search_argbest_equals_jax_and_direct(kind, force_fused):
    data = _chunk(kind)
    ours = _fused_table(data)
    two_stage = jsearch.dedispersion_search(data, 100.0, 200.0, *GEOM,
                                            backend="jax", kernel="hybrid")
    direct = tsearch.dedispersion_search(data, 100.0, 200.0, *GEOM,
                                         device="cpu")
    b = ours.argbest()
    assert b == two_stage.argbest() == direct.argbest()
    for col in ("DM", "rebin", "peak"):
        assert ours[col][b] == two_stage[col][b] == direct[col][b]
    np.testing.assert_allclose(ours["snr"][b], two_stage["snr"][b],
                               rtol=RTOL)
    # every exact row is the direct sweep's row bit for bit
    ex = np.flatnonzero(ours["exact"])
    assert ex.size >= 3
    for col in ("max", "std", "snr", "rebin", "peak"):
        np.testing.assert_array_equal(
            np.asarray(ours[col][ex], np.float64),
            np.asarray(direct[col][ex], np.float64), err_msg=col)
    if kind == "pulse":
        assert abs(ours["DM"][b] - 150.0) < 1.0


def test_fused_and_two_stage_agree_on_every_common_exact_row(force_fused):
    data = _chunk("pulse")
    x = torch.from_numpy(data)
    dms = _plan()
    fused = tsearch._search_hybrid(x, dms, *GEOM, False, fused=True)
    two = tsearch._search_hybrid(x, dms, *GEOM, False, fused=False)
    both = fused[5] & two[5]
    assert both.any()
    for i in range(5):
        np.testing.assert_array_equal(fused[i][both], two[i][both])
    assert int(np.argmax(fused[2])) == int(np.argmax(two[2]))


@pytest.mark.parametrize("case, fused", [
    ("default_cpu", False), ("forced", True), ("floor_certificate", False),
    ("floor_no_certificate", True), ("capture_plane", False),
    ("narrow_grid", False), ("unfuse_engaged", False)])
def test_gating(case, fused, monkeypatch):
    """The JAX package's condition, with "the data are on the card" for
    its "the backend is a TPU"."""
    data = _chunk("pulse")
    x = torch.from_numpy(data)
    dms = _plan()
    calls = []
    real = tsearch._fused_seed
    monkeypatch.setattr(tsearch, "_fused_seed",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(fused=True)
    capture = False
    if case == "default_cpu":
        kw = {}
    elif case == "floor_certificate":
        kw["snr_floor"] = 8.0
    elif case == "floor_no_certificate":
        kw.update(snr_floor=8.0, noise_certificate=False)
    elif case == "capture_plane":
        capture = True
    elif case == "narrow_grid":
        dms = dms[:3 * tsearch.HYBRID_SEED_TOPK - 1]
    elif case == "unfuse_engaged":
        ladder.descend("unfuse")
    out = tsearch._search_hybrid(x, dms, *GEOM, capture, **kw)
    assert bool(calls) == fused
    assert out[5].any()


def test_hit_chunk_counts_one_dispatch_and_one_readback(force_fused):
    data = _chunk("pulse")
    acct = BudgetAccountant()
    with acct.chunk(0) as rec:
        table = _fused_table(data)
    assert rec["counters"]["dispatches"] == 1
    assert rec["counters"]["readbacks"] == 1
    assert "search/fused" in rec["buckets"]
    assert "search/rescore" not in rec["buckets"]
    assert table.best_row()["exact"]
    acct = BudgetAccountant()
    with acct.chunk(1) as rec:
        tsearch.dedispersion_search(data, 100.0, 200.0, *GEOM,
                                    kernel="hybrid", device="cpu",
                                    snr_floor=8.0)
    # with a floor the search is two-stage: the coarse trip and each
    # rescore bucket's
    assert rec["counters"]["dispatches"] == rec["counters"]["readbacks"] > 1
    assert "search/fused" not in rec["buckets"]


def test_fused_work_model_counts_the_buckets():
    from pulsarutils_tpu_torch.obs import roofline

    base = roofline.fused_seed_work((10, 20), 100, 64, 4096, ())
    seeded = roofline.fused_seed_work((10, 20), 100, 64, 4096, (8, 8))
    sweep = roofline.sweep_work(8, 64, 4096)
    score = roofline.score_work(8, 4096, 40)
    assert seeded[0] - base[0] == 2 * (sweep[0] + score[0])
    assert seeded[1] - base[1] == 2 * (sweep[1] + score[1])
    assert base == (10 + roofline.score_work(100, 4096, 600)[0],
                    20 + roofline.score_work(100, 4096, 600)[1])


# ---------------------------------------------------------------------------
# The unfuse rung through the chunk loop
# ---------------------------------------------------------------------------

SEARCH = dict(dmmin=100.0, dmmax=200.0, chunk_length=1.024,
              kernel="hybrid", snr_threshold=8.0, make_plots=False)


@pytest.fixture(scope="module")
def pulse_file(tmp_path_factory):
    array, header = simulate_test_data(150.0, nsamples=16384, nchan=32,
                                       signal=10.0, noise=4.0, rng=7)
    path = tmp_path_factory.mktemp("fused") / "pulse.fil"
    write_simulated_filterbank(str(path), array + 20.0, header,
                               descending=True, nbits=8)
    return str(path)


def test_unfuse_rung_under_an_injected_oom(pulse_file, tmp_path,
                                           monkeypatch, force_fused):
    """An OOM in a hybrid chunk on the device descends ``unfuse``; the
    chunk and the rest of the run go two-stage.  The contract: the hits
    equal, and every table's argbest row, DM, rebin and peak, and every
    row exact in both tables."""
    calls = []
    real_seed = tsearch._fused_seed
    monkeypatch.setattr(tsearch, "_fused_seed",
                        lambda *a: calls.append(1) or real_seed(*a))
    ref_hits, ref_store = search_by_chunks(
        pulse_file, device="cpu", output_dir=str(tmp_path / "fused"),
        **SEARCH)
    nchunks = len(ref_store.done_chunks)
    assert ladder.level() == 0 and ref_hits and len(calls) == nchunks

    # the chunk loop descends the unfuse rung on the card: let it take
    # the CPU run for the card's while the search runs on the CPU
    real_loop = search_pipeline._search_with_fallback
    real_search = search_pipeline.dedispersion_search
    monkeypatch.setattr(
        search_pipeline, "_search_with_fallback",
        lambda *a, device, **k: real_loop(*a, device=torch.device("cuda"),
                                          **k))
    monkeypatch.setattr(
        search_pipeline, "dedispersion_search",
        lambda *a, device, **k: real_search(*a, device="cpu", **k))
    summary = {}
    plan = FaultPlan([FaultSpec(site="dispatch", kind="oom", chunks=(0,),
                                times=1)])
    with plan.armed():
        hits, store = search_by_chunks(pulse_file, device="cpu",
                                       output_dir=str(tmp_path / "unfused"),
                                       summary=summary, **SEARCH)
    assert summary["oom_descents"] == 1 and ladder.unfuse_engaged()
    assert summary["fallback"] is None
    assert len(calls) == nchunks      # the fused path ran no more
    assert [(h[0], h[1]) for h in hits] == [(h[0], h[1]) for h in ref_hits]
    for (_, _, info, table), (_, _, rinfo, rtable) in zip(hits, ref_hits):
        b = table.argbest()
        assert b == rtable.argbest()
        for col in ("DM", "rebin", "peak"):
            assert table[col][b] == rtable[col][b]
        both = table["exact"] & rtable["exact"]
        for col in ("max", "std", "snr", "rebin", "peak"):
            np.testing.assert_array_equal(table[col][both],
                                          rtable[col][both], err_msg=col)
        assert info.dm == rinfo.dm and info.width == rinfo.width

