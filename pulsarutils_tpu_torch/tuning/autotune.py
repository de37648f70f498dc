"""Measured kernel autotuner: per-(backend, geometry) variant selection.

The port of the JAX package's ``tuning/autotune.py``.  The fastest
variant of a search depends on (platform, nchan, nsamples, ndm, dtype),
so ``kernel="auto"``, ``precision="auto"``, the two-stage hybrid's
rescore kernel, the harmonic chain and ``accel_backend="auto"`` resolve
through one :class:`KernelTuner`:

* on first sight of a :func:`~.geometry.geometry_key` the applicable
  variants are micro-benchmarked: one warm-up run excluded (kernel
  builds, first touches), the median of :data:`TUNE_REPS` timed runs,
  each fenced with ``torch.cuda.synchronize`` on the card, on synthetic
  data of the real geometry (seeded noise and one pulse on the middle
  probe trial's exact track, so the equivalence check compares decisive
  tables, not noise ties);
* a candidate's scores must pass the exact-hit-match check
  (:func:`hits_match`, or the resolver's own) against the static
  choice's before it is ever cached: tuning can change speed, never hits;
* winners persist in the versioned :class:`~.cache.TuneCache`; a second
  resolution of the same key, in this process or a later one, measures
  nothing;
* ``putpu_autotune_*`` counters and gauges, a ``search/autotune`` budget
  bucket and an ``autotune_measure`` span around every measurement, and
  the decisions in the ``BUDGET_JSON`` record and the survey report.

The fallback ladder is the JAX package's: ``PUTPU_AUTOTUNE=off``
returns the static choice with no side effect, ``cache`` reads winners
but never measures, ``on`` (the default) measures on a miss — unless
the geometry is below :data:`MIN_TUNE_ELEMENTS` (``PUTPU_AUTOTUNE_MIN``
overrides) or only one candidate applies.

**One rule differs on the card.**  The JAX package falls back to the
static choice when a measurement raises.  On the card that would hide a
hand-written kernel that fails to build or launch, so under a ``"gpu"``
key an error of the static candidate propagates, and an error of
another candidate drops that candidate from the measurement (a warning
and ``putpu_autotune_static_fallbacks_total``).  On the CPU the JAX
package's rule stands.

Static choices: the direct sweep (``"pallas"``, B1 and B4 on the card,
their plain versions on the CPU) is what ``kernel="auto"`` ran before
the tuner, on both devices; the JAX package's static CPU choice is the
roll formulation, whose tables are the direct sweep's.  The harmonic
chain has one applicable variant on each device (B6 on the card, the
plain chain on the CPU), so it resolves statically.
"""

from __future__ import annotations

import functools
import logging
import os
import threading
import time

import numpy as np

from ..utils.logging_utils import budget_bucket
from .cache import TuneCache, default_cache_path
from .geometry import device_backend, dtype_name, geometry_key

logger = logging.getLogger("pulsarutils_tpu_torch")

__all__ = ["KernelTuner", "get_tuner", "set_tuner", "autotune_mode",
           "static_search_kernel", "static_mesh_kernel", "hits_match", "harmonic_packs_match",
           "accel_tables_match", "measure_kernel_wall", "synthetic_chunk",
           "synthetic_accel_plane", "resolve_search_kernel",
           "resolve_mesh_kernel", "resolve_batched_kernel",
           "resolve_accel_backend", "resolve_search_policy",
           "resolve_harmonic_kernel", "decision_seq", "decisions_since",
           "reset_decisions", "ABANDON_FACTOR", "ACCEL_SIGMA_RTOL",
           "HARMONIC_SCORE_RTOL", "MIN_TUNE_ELEMENTS", "TUNE_REPS",
           "TUNE_PROBE_TRIALS"]

#: timed repetitions per candidate (median taken); the warm-up run that
#: absorbs the kernel builds is extra
TUNE_REPS = 3

#: trial-axis probe size for measurement runs (the full ndm stays in
#: the cache key; per-trial cost is linear in trials for every family)
TUNE_PROBE_TRIALS = 32

#: a candidate slower than this factor x the best median after one
#: timed rep is abandoned without further reps
ABANDON_FACTOR = 3.0

#: geometries below this ``nchan * nsamples`` floor resolve statically:
#: the measurement costs more than a survey at that geometry could
#: repay, and every test-sized geometry stays on the static path.
#: ``PUTPU_AUTOTUNE_MIN`` overrides.
MIN_TUNE_ELEMENTS = 1 << 25


# ---------------------------------------------------------------------------
# static heuristics (the zero-measurement fallback + escape hatch)
# ---------------------------------------------------------------------------

def static_search_kernel(f32=True):
    """What ``kernel="auto"`` runs without measuring: the direct sweep
    (``"pallas"``, the JAX package's name for it) on every device and
    for plane captures.  The JAX package's static CPU choice is
    ``"roll"``; the port keeps the direct sweep there too (its plain
    version, whose tables equal the roll formulation's).  A
    non-float32 sweep is the gather's."""
    return "pallas" if f32 else "gather"


def static_mesh_kernel(all_cuda, f32=True):
    """The per-shard kernel of the sharded paths without measuring: the
    direct sweep (B1) on all-CUDA float32 meshes, the gather elsewhere —
    the JAX package's rule with the card where it says all-TPU."""
    return "pallas" if (all_cuda and f32) else "gather"


# ---------------------------------------------------------------------------
# measurement discipline
# ---------------------------------------------------------------------------

def measure_kernel_wall(kernel, run, reps=TUNE_REPS, sync=None):
    """Median wall seconds of ``reps`` timed ``run()`` calls.

    ``sync`` (when given) is called with each run's output before the
    clock stops — ``torch.cuda.synchronize`` on the card — so a
    candidate's queued device work never lands in the next one's clock.
    Every wall second the tuner attributes comes from here, inside the
    caller's ``search/autotune`` budget bucket.
    """
    del kernel
    walls = []
    for _ in range(max(int(reps), 1)):
        t0 = time.perf_counter()
        out = run()
        if sync is not None:
            sync(out)
        walls.append(time.perf_counter() - t0)
    walls.sort()
    return walls[len(walls) // 2]


def _device_sync(device):
    """The fence of a run on ``device``: ``torch.cuda.synchronize`` on a
    CUDA device, None on the host (its runs finish before they return)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    # putpu-lint: disable=device-trip — the measurement's fence
    return lambda _out: torch.cuda.synchronize(dev)


def hits_match(ref, cand, rtol=1e-4, atol=1e-6):
    """The exact-hit-match check gating every cached winner.

    ``ref``/``cand`` are ``(max, std, snr, window, peak)`` score tuples
    over the same probe trial grid.  Equivalent means: the argbest
    trial agrees, its integer fields (boxcar window, peak sample) agree
    exactly, and every score column agrees to float tolerance (distinct
    exact formulations may reassociate float32 sums — the tolerance
    admits that and nothing more).
    """
    ref_snr = np.asarray(ref[2], dtype=np.float64)
    cand_snr = np.asarray(cand[2], dtype=np.float64)
    if ref_snr.shape != cand_snr.shape:
        return False
    ib_ref = int(np.argmax(ref_snr))
    ib_cand = int(np.argmax(cand_snr))
    if ib_ref != ib_cand:
        return False
    if int(np.asarray(ref[3])[ib_ref]) != int(np.asarray(cand[3])[ib_ref]):
        return False
    if int(np.asarray(ref[4])[ib_ref]) != int(np.asarray(cand[4])[ib_ref]):
        return False
    for r, c in zip(ref[:3], cand[:3]):
        if not np.allclose(np.asarray(r, dtype=np.float64),
                           np.asarray(c, dtype=np.float64),
                           rtol=rtol, atol=atol):
            return False
    return True


def synthetic_chunk(nchan, nsamples, offsets_mid, seed=1601):
    """Seeded noise of the real geometry + one pulse on an exact track.

    ``offsets_mid`` is the middle probe trial's int32 gather-offset row:
    the pulse is injected at ``(t0 + off[c]) mod T`` per channel, so
    dedispersing at that trial reassembles it exactly — the decisive
    argbest the equivalence check compares.  The JAX package's array,
    bit for bit.
    """
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((int(nchan), int(nsamples)),
                               dtype=np.float32) * np.float32(0.5)
    t0 = nsamples // 3
    amp = np.float32(10.0 / np.sqrt(nchan))  # matched-filter S/N ~ 20
    cols = (t0 + np.asarray(offsets_mid, dtype=np.int64)) % nsamples
    data[np.arange(nchan), cols] += amp
    return data


# ---------------------------------------------------------------------------
# mode / floor knobs
# ---------------------------------------------------------------------------

_warned_mode = set()


def autotune_mode():
    """``PUTPU_AUTOTUNE`` -> ``"on"`` / ``"cache"`` / ``"off"``.

    Unset means ``on``; an unrecognised value warns once and falls back
    to ``on``.
    """
    raw = os.environ.get("PUTPU_AUTOTUNE", "").strip().lower()
    if raw in ("off", "0", "false"):
        return "off"
    if raw in ("cache", "cache-only"):
        return "cache"
    if raw in ("", "on", "1", "true"):
        return "on"
    if raw not in _warned_mode:
        _warned_mode.add(raw)
        logger.warning("PUTPU_AUTOTUNE=%r ignored (expected on/cache/off); "
                       "autotuning stays on", raw)
    return "on"


def _min_elements():
    raw = os.environ.get("PUTPU_AUTOTUNE_MIN", "")
    if raw:
        try:
            return int(raw)
        except ValueError:
            logger.warning("PUTPU_AUTOTUNE_MIN=%r ignored (expected an "
                           "integer)", raw)
    return MIN_TUNE_ELEMENTS


# ---------------------------------------------------------------------------
# per-process decision ledger (BUDGET_JSON record / survey report)
# ---------------------------------------------------------------------------

_DECISIONS = []
_DECISIONS_LOCK = threading.Lock()


def _record_decision(rec):
    with _DECISIONS_LOCK:
        _DECISIONS.append(rec)


def decision_seq():
    """Monotonic count of decisions recorded so far (stream markers)."""
    with _DECISIONS_LOCK:
        return len(_DECISIONS)


def decisions_since(mark=0):
    """Decision records after ``mark`` (a prior :func:`decision_seq`):
    the budget record takes its mark at ``begin_stream``, so one run's
    record carries exactly that run's decisions."""
    with _DECISIONS_LOCK:
        return [dict(r) for r in _DECISIONS[int(mark):]]


def reset_decisions():
    """Test helper: drop the process decision ledger."""
    with _DECISIONS_LOCK:
        del _DECISIONS[:]


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

def _on_card(backend):
    """Whether a key's backend (``"gpu"``, ``"gpu-accel"``, ...) names the
    card, where a measurement error is not a reason to fall back."""
    return str(backend).split("-", 1)[0] == "gpu"


class KernelTuner:
    """Plan-level kernel selection: cache -> measure -> static ladder.

    ``cache`` is a :class:`~.cache.TuneCache` (in-memory when ``None``);
    ``mode`` pins the resolution mode (default: follow
    :func:`autotune_mode` per call); ``min_elements`` overrides the
    measurement floor (``None``: env/default); ``measurer`` injects the
    timing function for deterministic tests — signature
    ``measurer(kernel, run, reps)`` returning seconds (the default is
    :func:`measure_kernel_wall` with the resolver's device fence);
    ``reps``/``probe_trials`` bound the measurement work.
    """

    def __init__(self, cache=None, mode=None, min_elements=None,
                 reps=TUNE_REPS, probe_trials=TUNE_PROBE_TRIALS,
                 measurer=None):
        self.cache = cache if cache is not None else TuneCache(None)
        self.mode = mode
        self.min_elements = min_elements
        self.reps = int(reps)
        self.probe_trials = int(probe_trials)
        self.measurer = measurer
        self._lock = threading.RLock()
        self._resolved = {}  # key -> kernel (this process's decisions)

    # -- bookkeeping ---------------------------------------------------------

    def _mode(self):
        return self.mode if self.mode is not None else autotune_mode()

    def _floor(self):
        if self.min_elements is not None:
            return int(self.min_elements)
        return _min_elements()

    def _decide(self, key, kernel, source, static, measured_s=None,
                reason=None, abandoned=None):
        from ..obs import metrics as _metrics

        with self._lock:
            self._resolved[key] = kernel
            _metrics.gauge("putpu_autotune_keys").set(len(self._resolved))
        rec = {"key": key, "kernel": kernel, "source": source,
               "static": static}
        if reason:
            rec["reason"] = reason
        if abandoned:
            # these candidates' measured_s figures are ONE early-abandon
            # rep, not a median — flagged wherever the decision surfaces
            rec["abandoned"] = sorted(abandoned)
        if measured_s:
            rec["measured_s"] = {k: round(float(v), 6)
                                 for k, v in measured_s.items()}
            if static in measured_s and kernel in measured_s \
                    and measured_s[kernel] > 0:
                speedup = measured_s[static] / measured_s[kernel]
                rec["speedup_vs_static"] = round(speedup, 3)
                _metrics.gauge("putpu_autotune_speedup").set(
                    round(speedup, 4))
        if source == "static":
            _metrics.counter("putpu_autotune_static_fallbacks_total").inc()
        _record_decision(rec)
        # measured/cached selections are worth one INFO line per key;
        # routine static fallbacks (below-floor geometries) stay DEBUG
        log = logger.info if source != "static" else logger.debug
        log("autotune %s: kernel=%s (%s%s)", key, kernel, source,
            f", {reason}" if reason else "")
        return kernel

    # -- resolution ----------------------------------------------------------

    def resolve(self, *, backend, nchan, nsamples, ndm, dtype, candidates,
                static, runner_factory=None, equiv=None, sync=None,
                mesh_shape=None, batch=1):
        """One kernel name for this geometry.

        ``candidates`` is the constraint-filtered variant list (static
        choice first); ``runner_factory()`` lazily builds
        ``{kernel: run_callable}`` over synthetic data — only invoked
        when a measurement is actually going to happen.  ``equiv``
        overrides the equivalence check (``equiv(ref_scores,
        cand_scores) -> bool``; default :func:`hits_match`).  ``sync``
        fences each run of the default measurer
        (:func:`measure_kernel_wall`).  ``mesh_shape`` (the sharded
        paths') and ``batch`` (the beam batcher's width) join the key.  Under a ``"gpu"`` backend an error of
        the static candidate propagates (module docstring).
        """
        from ..obs import metrics as _metrics

        mode = self._mode()
        if mode == "off" or static not in candidates:
            # the escape hatch: zero side effects, the static path
            return static
        key = geometry_key(backend, nchan, nsamples, ndm, dtype,
                           mesh_shape=mesh_shape, batch=batch)
        with self._lock:
            hit = self._resolved.get(key)
        if hit is not None and hit in candidates:
            _metrics.counter("putpu_autotune_cache_hits_total").inc()
            return hit
        # the floor gates the DISK lookup too, not just measurement:
        # below-floor geometries resolve statically, full stop
        below_floor = nchan * nsamples < self._floor()
        entry = (self.cache.lookup(key)
                 if len(candidates) >= 2 and not below_floor else None)
        if entry is not None and entry.get("kernel") in candidates:
            _metrics.counter("putpu_autotune_cache_hits_total").inc()
            return self._decide(key, entry["kernel"], "cache", static,
                                measured_s=entry.get("measured_s"))
        if hit is not None or entry is not None:
            # the key's winner is another resolver's, outside these
            # candidates: the beam batcher's single-beam key is the
            # single-chunk search's (``batch=1`` adds no suffix).  This
            # call runs its static choice and records nothing, so the
            # search's decision stands in memory and on disk.
            return static
        _metrics.counter("putpu_autotune_cache_misses_total").inc()

        if len(candidates) < 2:
            return self._decide(key, static, "static", static,
                                reason="single applicable variant")
        if below_floor:
            return self._decide(key, static, "static", static,
                                reason=f"geometry below tune floor "
                                       f"({nchan * nsamples} < "
                                       f"{self._floor()} elements)")
        if mode == "cache":
            return self._decide(key, static, "static", static,
                                reason="cache-only mode, no tuned entry")
        if runner_factory is None:
            return self._decide(key, static, "static", static,
                                reason="no measurement runner")
        on_card = _on_card(backend)
        try:
            return self._measure(key, candidates, static, runner_factory,
                                 equiv=equiv, sync=sync, on_card=on_card)
        except Exception as exc:
            if on_card:
                raise  # a kernel of the static path failed on the card
            logger.warning("autotune measurement failed for %s (%r); "
                           "using the static heuristic", key, exc)
            return self._decide(key, static, "static", static,
                                reason=f"measurement failed: "
                                       f"{type(exc).__name__}")

    def _measure(self, key, candidates, static, runner_factory,
                 equiv=None, sync=None, on_card=False):
        """Warm up, fence, median-of-k each candidate; gate equivalence;
        cache and return the winner."""
        from ..obs import metrics as _metrics

        matcher = equiv if equiv is not None else hits_match
        measurer = self.measurer or functools.partial(measure_kernel_wall,
                                                      sync=sync)
        with self._lock:  # one measurement per key, ever
            hit = self._resolved.get(key)
            if hit is not None:
                return hit  # a racing thread measured while we waited
            with budget_bucket("search/autotune"):
                runners = runner_factory()
                medians = {}
                abandoned = set()
                ref_scores = None
                best = None
                # static first: it sets the equivalence reference AND
                # the early-abandon bar
                order = [static] + [c for c in candidates if c != static]
                for cand in order:
                    run = runners.get(cand)
                    if run is None:
                        continue
                    try:
                        median, scores = self._time_one(
                            key, cand, run, cand == static, ref_scores,
                            matcher, measurer, sync, best, abandoned)
                    except Exception as exc:
                        if not on_card or cand == static:
                            raise
                        # the card's rule: a failing non-static candidate
                        # is dropped, never the reason to fall back
                        _metrics.counter(
                            "putpu_autotune_static_fallbacks_total").inc()
                        logger.warning(
                            "autotune %s: candidate %r failed on the card "
                            "(%r) — dropped from the measurement", key,
                            cand, exc)
                        continue
                    if cand == static:
                        ref_scores = scores
                    if median is None:
                        continue  # rejected by the equivalence check
                    medians[cand] = median
                    _metrics.counter("putpu_autotune_measurements_total",
                                     kernel=cand).inc()
                    if best is None or median < best:
                        best = median
            if not medians:
                return self._decide(key, static, "static", static,
                                    reason="no candidate measured")
            winner = min(medians, key=medians.get)
            try:
                self.cache.store(key, winner, measured_s=medians,
                                 reps=self.reps,
                                 abandoned=sorted(abandoned))
            except OSError as exc:
                # a read-only cache path must not throw away a paid-for
                # measurement: keep the winner in memory for this process
                logger.warning("tune cache persist failed for %s (%r); "
                               "measured winner kept in-memory only",
                               key, exc)
            return self._decide(key, winner, "measured", static,
                                measured_s=medians, abandoned=abandoned)

    def _time_one(self, key, cand, run, is_static, ref_scores, matcher,
                  measurer, sync, best, abandoned):
        """One candidate: the warm-up run (its scores), the equivalence
        check against the static candidate's ``ref_scores``, then one
        timed rep and, unless that rep took :data:`ABANDON_FACTOR` x
        ``best`` or more, ``reps - 1`` more.  Returns ``(median, scores)``,
        the median None when the check rejected the candidate."""
        from ..obs import metrics as _metrics
        from ..obs.trace import span

        with span("autotune_measure", kernel=cand, key=key):
            scores = run()  # warm-up: kernel builds excluded
            if sync is not None:
                sync(scores)
            if not is_static and not matcher(ref_scores, scores):
                _metrics.counter("putpu_autotune_equiv_rejected_total").inc()
                logger.warning(
                    "autotune %s: variant %r failed the exact-hit-match "
                    "check — rejected (tuning may change speed, never "
                    "hits)", key, cand)
                return None, scores
            # the first wall doubles as the early-abandon probe, so no
            # rep is discarded (each measurer(.., 1) is one fenced run)
            walls = [measurer(cand, run, 1)]
            if best is not None and walls[0] > ABANDON_FACTOR * best:
                # one timed rep rules it out; its single-rep figure is
                # recorded as such (``abandoned``), never as a median
                abandoned.add(cand)
            else:
                walls += [measurer(cand, run, 1)
                          for _ in range(self.reps - 1)]
            walls.sort()
            return walls[len(walls) // 2], scores

    def decisions(self):
        """``{key: kernel}`` resolved by this tuner instance."""
        with self._lock:
            return dict(self._resolved)


# ---------------------------------------------------------------------------
# module singleton + the search-facing entry points
# ---------------------------------------------------------------------------

_tuner = None
_tuner_lock = threading.Lock()


def get_tuner():
    """The process tuner (created on first use, persistent disk cache)."""
    global _tuner
    with _tuner_lock:
        if _tuner is None:
            _tuner = KernelTuner(cache=TuneCache(default_cache_path()))
        return _tuner


def set_tuner(tuner):
    """Install ``tuner`` as the process tuner; returns the previous one
    (tests swap in deterministic tuners and restore after)."""
    global _tuner
    with _tuner_lock:
        prev = _tuner
        _tuner = tuner
        return prev


def _probe_grid(trial_dms, probe_trials):
    """``probe_trials`` trials evenly sliced from the real grid."""
    trial_dms = np.asarray(trial_dms, dtype=np.float64)
    ndm = len(trial_dms)
    probe = min(ndm, int(probe_trials))
    idx = np.unique(np.linspace(0, ndm - 1, probe).astype(np.int64))
    return trial_dms[idx]


def _probe_chunk(nchan, nsamples, sub_dms, start_freq, bandwidth,
                 sample_time, device):
    """:func:`synthetic_chunk` for the probe grid ``sub_dms``, uploaded to
    ``device`` once (every run of every candidate searches the same
    tensor, so no run pays a host-to-device copy)."""
    import torch

    from ..ops.plan import offsets_for

    mid = offsets_for(sub_dms[len(sub_dms) // 2:len(sub_dms) // 2 + 1],
                      nchan, start_freq, bandwidth, sample_time,
                      nsamples)[0]
    synth = synthetic_chunk(nchan, nsamples, mid)
    return torch.from_numpy(synth).to(device)


def _score_columns(table):
    """A search table's ``(max, std, snr, rebin, peak)`` host columns."""
    return tuple(np.asarray(table[c]) for c in
                 ("max", "std", "snr", "rebin", "peak"))


def resolve_search_kernel(nchan, nsamples, ndm, dtype, capture_plane,
                          start_freq, bandwidth, sample_time, trial_dms,
                          dm_block=None, chan_block=None, device="cpu"):
    """``kernel="auto"`` resolution of the single-device sweep on
    ``device``.

    Candidates: ``"pallas"`` (the exact direct sweep, B1 and B4 on the
    card; the static choice, :func:`static_search_kernel`), ``"roll"``
    and ``"gather"`` (the portable formulations, B4 scoring each trial
    block).  Each runs :func:`~..ops.search.dedispersion_search` on the
    probe grid at float32.  Plane captures resolve statically, as in
    the JAX package.
    """
    backend = device_backend(device)
    f32 = dtype_name(dtype) == "float32"
    static = static_search_kernel(f32)
    if capture_plane:
        return static
    candidates = [static] + [k for k in ("roll", "gather", "pallas")
                             if k != static and (k != "pallas" or f32)]

    def runner_factory():
        from ..ops.search import dedispersion_search

        sub_dms = _probe_grid(trial_dms, get_tuner().probe_trials)
        data = _probe_chunk(nchan, nsamples, sub_dms, start_freq, bandwidth,
                            sample_time, device)
        lo, hi = float(sub_dms.min()), float(sub_dms.max())

        def make(kern):
            def run():
                return _score_columns(dedispersion_search(
                    data, lo, hi, start_freq, bandwidth, sample_time,
                    trial_dms=sub_dms, kernel=kern, precision="f32",
                    dm_block=dm_block, chan_block=chan_block,
                    device=device))
            return run

        return {k: make(k) for k in candidates}

    return get_tuner().resolve(
        backend=backend, nchan=nchan, nsamples=nsamples, ndm=ndm,
        dtype=dtype_name(None if f32 else dtype), candidates=candidates,
        static=static, runner_factory=runner_factory,
        sync=_device_sync(device))


def resolve_mesh_kernel(mesh, nchan, nsamples, ndm, start_freq, bandwidth,
                        sample_time, trial_dms, dtype=None):
    """The per-shard sweep and rescore kernel of the sharded paths.

    The mesh shape joins the key (a ``(8,1)`` slice-heavy layout and a
    ``(2,4)`` channel-split one stress different kernels).  Candidates:
    ``"pallas"`` (B1 per shard; all-CUDA float32 meshes, the static
    choice there, :func:`static_mesh_kernel`) and ``"gather"``.  A CPU
    mesh has the gather alone (its roll-accumulate form inside the
    shard), so it resolves statically at no cost, as the JAX package's
    off-TPU meshes do.  The key's backend is ``"gpu"`` on the card,
    ``"cpu-mesh"`` elsewhere.
    """
    f32 = dtype_name(dtype) == "float32"
    all_cuda = mesh.all_cuda
    static = static_mesh_kernel(all_cuda, f32)
    candidates = [static] + ["gather"] if static == "pallas" else [static]
    mesh_shape = tuple(int(v) for v in mesh.shape.values())
    home = mesh.home

    def runner_factory():
        from ..parallel.sharded import sharded_dedispersion_search

        sub_dms = _probe_grid(trial_dms, get_tuner().probe_trials)
        data = _probe_chunk(nchan, nsamples, sub_dms, start_freq, bandwidth,
                            sample_time, home)

        def make(kern):
            def run():
                return _score_columns(sharded_dedispersion_search(
                    data, None, None, start_freq, bandwidth, sample_time,
                    mesh=mesh, trial_dms=sub_dms, kernel=kern))
            return run

        return {k: make(k) for k in candidates}

    return get_tuner().resolve(
        backend="gpu" if all_cuda else "cpu-mesh", nchan=nchan,
        nsamples=nsamples, ndm=ndm, dtype=dtype_name(None if f32 else dtype),
        candidates=candidates, static=static, runner_factory=runner_factory,
        sync=_device_sync(home), mesh_shape=mesh_shape)


def resolve_batched_kernel(nchan, nsamples, ndm, batch, start_freq,
                           bandwidth, sample_time, trial_dms, dm_block=None,
                           chan_block=None, device="cpu"):
    """``kernel=None`` resolution of the beam batcher on ``device``.

    The batcher (:mod:`..beams.batcher`) runs one per-beam body for every
    beam of a batch, so its candidates are the formulations that body
    holds: ``"roll"``, each trial block scored by B4, and ``"gather"``,
    which on the card runs B1 and B4 a superblock for float32 beams under
    ``f32`` (:func:`~..ops.search.direct_gather`; torch's gather
    otherwise), so its measurement times that path.
    The static choice is the JAX package's: the roll on the CPU, the
    gather on the card.  The key carries the batch width (``|b<N>``), so
    a batched winner never answers a single-beam key; the measurement
    runs the real batched search over a synthetic beam stack
    (:func:`~..beams.batcher.batched_probe_runners`) and checks beam 0's
    scores against the static formulation's.  ``dm_block`` and
    ``chan_block`` are the batcher's own blocking.
    """
    backend = device_backend(device)
    static = "roll" if backend == "cpu" else "gather"
    candidates = [static] + [k for k in ("roll", "gather") if k != static]

    def runner_factory():
        from ..beams.batcher import batched_probe_runners

        sub_dms = _probe_grid(trial_dms, get_tuner().probe_trials)
        return batched_probe_runners(candidates, nchan, nsamples, batch,
                                     sub_dms, start_freq, bandwidth,
                                     sample_time, dm_block=dm_block,
                                     chan_block=chan_block, device=device)

    return get_tuner().resolve(
        backend=backend, nchan=nchan, nsamples=nsamples, ndm=ndm,
        dtype=dtype_name(None), candidates=candidates, static=static,
        runner_factory=runner_factory, sync=_device_sync(device),
        batch=max(int(batch), 1))


# ---------------------------------------------------------------------------
# the periodicity accel-backend contender pair (time_stretch vs fdas)
# ---------------------------------------------------------------------------

#: cross-backend sigma tolerance of :func:`accel_tables_match`.  The
#: two formulations window the signal differently — integer-sample
#: stretch resampling scallops power by ~sinc^2(f0*tsamp) where the
#: truncated z/w-response template clips a few percent of template
#: energy — so bit-exact sigma equality ACROSS backends is not a
#: theorem (within a backend, the card and the CPU agree cell for
#: cell).  The discrete cell identity IS a theorem at matched trial
#: grids, and that is what the check pins exactly.
ACCEL_SIGMA_RTOL = 0.12


def accel_tables_match(ref, cand, rtol=ACCEL_SIGMA_RTOL):
    """Whether two periodicity trial tables find the same candidate.

    ``ref``/``cand`` are top-k candidate tables over the same probe
    trial grid (rows ranked best-first).  Equivalent means: the top
    candidate's discrete cell — DM row, acceleration/jerk trial index,
    harmonic depth — agrees EXACTLY, its frequency lands on the same
    Fourier bin, and its sigma agrees within ``rtol``
    (:data:`ACCEL_SIGMA_RTOL`).  A backend failing this must not replace
    the other, however fast it runs: a choice of backend may change
    speed, never hits.
    """
    if ref is None or cand is None:
        return False
    try:
        if (len(np.asarray(ref["sigma"])) == 0
                or len(np.asarray(cand["sigma"])) == 0):
            return False
        for col in ("dm_index", "accel_index", "jerk_index", "nharm"):
            if col in ref and col in cand and (
                    int(np.asarray(ref[col])[0])
                    != int(np.asarray(cand[col])[0])):
                return False
        if not np.isclose(float(np.asarray(cand["freq"])[0]),
                          float(np.asarray(ref["freq"])[0]),
                          rtol=1e-5, atol=0.0):
            return False
        return bool(np.isclose(float(np.asarray(cand["sigma"])[0]),
                               float(np.asarray(ref["sigma"])[0]),
                               rtol=float(rtol), atol=1e-2))
    except (KeyError, IndexError, TypeError, ValueError):
        return False


def synthetic_accel_plane(ndm, nsamples, tsamp, accel, jerk=0.0,
                          amp=0.6, seed=1601):
    """Seeded noise plane + one accelerated sinusoid on a probe trial.

    The injection row is ``ndm // 3`` (the canary convention) and the
    phase model is the time-stretch backend's own —
    ``phi = f0*(t + a*t^2/(2c) + j*t^3/(6c))`` — with ``f0`` placed on
    an exact Fourier bin well below Nyquist (scalloping and template
    truncation both stay small there), so both backends must put their
    top cell on the injection: the decisive comparison
    :func:`accel_tables_match` makes.
    """
    from ..periodicity.accel import C_M_S

    rng = np.random.default_rng(seed)
    plane = rng.standard_normal((int(ndm), int(nsamples)))
    k0 = max(int(round(0.175 * int(nsamples))), 4)
    f0 = k0 / (int(nsamples) * float(tsamp))
    t = np.arange(int(nsamples)) * float(tsamp)
    phase = f0 * (t + float(accel) * t * t / (2.0 * C_M_S)
                  + float(jerk) * t ** 3 / (6.0 * C_M_S))
    plane[int(ndm) // 3] += amp * np.sin(2.0 * np.pi * phase)
    return plane


def resolve_accel_backend(ndm, nsamples, tsamp, accels, jerks=None,
                          max_harmonics=16, fmin=None, fmax=None,
                          device="cpu", mesh=None):
    """``accel_backend="auto"`` resolution of the periodicity sweep on
    ``device``.

    Candidates: ``"time_stretch"`` (:func:`~..periodicity.accel.
    accel_search`, the static choice) and ``"fdas"``
    (:func:`~..periodicity.fdas.fdas_search`), both scoring with B6 on
    the card.  Measured over :func:`synthetic_accel_plane` (uploaded
    once) on the trial grid sliced evenly to the probe size, gated by
    :func:`accel_tables_match`.  The key maps ``nchan=ndm`` and
    ``ndm=ntrials`` under a ``"-accel"`` backend suffix, and a
    ``mesh``'s shape (each candidate then runs on it), as in the JAX
    package.
    """
    import torch

    backend = device_backend(device)
    static = "time_stretch"
    candidates = [static, "fdas"]
    ntrials = int(len(accels)) * (int(len(jerks))
                                  if jerks is not None else 1)

    def runner_factory():
        from ..periodicity.accel import accel_search
        from ..periodicity.fdas import fdas_search

        tuner = get_tuner()
        sub_acc = _probe_grid(accels, tuner.probe_trials)
        sub_jerks = (_probe_grid(jerks, 5)
                     if jerks is not None and len(jerks) > 1 else None)
        inj_a = float(sub_acc[(3 * len(sub_acc)) // 4])
        inj_j = (float(sub_jerks[(3 * len(sub_jerks)) // 4])
                 if sub_jerks is not None else 0.0)
        plane = torch.from_numpy(synthetic_accel_plane(
            ndm, nsamples, tsamp, inj_a, jerk=inj_j)).to(
                device=device, dtype=torch.float32)
        kw = dict(jerks=sub_jerks, max_harmonics=max_harmonics,
                  fmin=fmin, fmax=fmax, topk=8, device=device, mesh=mesh)

        def make(search):
            def run():
                table = search(plane, tsamp, sub_acc, **kw)
                return {k: np.asarray(v) for k, v in table.items()}
            return run

        return {"time_stretch": make(accel_search),
                "fdas": make(fdas_search)}

    return get_tuner().resolve(
        backend=f"{backend}-accel", nchan=int(ndm),
        nsamples=int(nsamples), ndm=ntrials, dtype=dtype_name(None),
        candidates=candidates, static=static,
        runner_factory=runner_factory, equiv=accel_tables_match,
        sync=_device_sync(device),
        mesh_shape=(tuple(int(v) for v in mesh.shape.values())
                    if mesh is not None else None))


# ---------------------------------------------------------------------------
# precision-policy candidates
# ---------------------------------------------------------------------------

def resolve_search_policy(formulation, nchan, nsamples, ndm, start_freq,
                          bandwidth, sample_time, trial_dms,
                          dm_block=None, chan_block=None, device="cpu"):
    """``precision="auto"`` resolution: the measured (formulation,
    policy) pair of a gather or roll sweep on ``device``.

    Candidates are ``"<formulation>+<strategy>"`` over
    :data:`~..precision.STRATEGIES`; the static choice is the plain
    ``f32`` pairing.  Each strategy's scores must pass
    :func:`hits_match` at its own ``score_rtol``: discrete fields
    exactly, so a lower-precision variant only wins after proving it
    cannot move a hit.  The ``"-precision"`` backend suffix keeps these
    decisions in their own key namespace.
    """
    from ..precision import STRATEGIES

    backend = device_backend(device)
    static = f"{formulation}+f32"
    candidates = [static] + [f"{formulation}+{name}"
                             for name in STRATEGIES if name != "f32"]

    def runner_factory():
        from ..ops.search import dedispersion_search

        sub_dms = _probe_grid(trial_dms, get_tuner().probe_trials)
        data = _probe_chunk(nchan, nsamples, sub_dms, start_freq, bandwidth,
                            sample_time, device)
        lo, hi = float(sub_dms.min()), float(sub_dms.max())

        def make(pair):
            pol = pair.split("+", 1)[1]

            def run():
                return (pol, _score_columns(dedispersion_search(
                    data, lo, hi, start_freq, bandwidth, sample_time,
                    trial_dms=sub_dms, kernel=formulation, precision=pol,
                    dm_block=dm_block, chan_block=chan_block,
                    device=device)))

            return run

        return {c: make(c) for c in candidates}

    def equiv(ref, cand):
        cand_pol, cand_scores = cand
        return hits_match(ref[1], cand_scores,
                          rtol=STRATEGIES[cand_pol].score_rtol)

    return get_tuner().resolve(
        backend=f"{backend}-precision", nchan=nchan, nsamples=nsamples,
        ndm=ndm, dtype=dtype_name(None), candidates=candidates,
        static=static, runner_factory=runner_factory, equiv=equiv,
        sync=_device_sync(device))


#: cross-program score tolerance of the harmonic-chain check (the JAX
#: package's): score columns at a tight rtol, discrete fields exactly
HARMONIC_SCORE_RTOL = 1e-5


def harmonic_packs_match(ref, cand, rtol=HARMONIC_SCORE_RTOL,
                         bin_scale=None):
    """Whether two periodicity scoring chains agree on one probe plane.

    ``ref``/``cand`` are per-row spec dicts (``freq, power, nharm,
    log_sf, sigma``).  Equivalent means: the harmonic depth agrees
    EXACTLY row for row, the peak's frequency names the same BIN
    (``bin_scale`` = ``nsamples * tsamp`` converts Hz back to the
    integer bin), and the score columns agree within ``rtol``.
    """
    if ref is None or cand is None:
        return False
    try:
        if not np.array_equal(np.asarray(ref["nharm"]),
                              np.asarray(cand["nharm"])):
            return False
        rf = np.asarray(ref["freq"], dtype=np.float64)
        cf = np.asarray(cand["freq"], dtype=np.float64)
        if bin_scale is not None:
            if not np.array_equal(np.rint(rf * float(bin_scale)),
                                  np.rint(cf * float(bin_scale))):
                return False
        elif not np.array_equal(rf, cf):
            return False
        for col in ("power", "log_sf", "sigma"):
            if not np.allclose(np.asarray(cand[col]),
                               np.asarray(ref[col]), rtol=float(rtol),
                               atol=1e-6):
                return False
        return True
    except (KeyError, TypeError, ValueError):
        return False


def resolve_harmonic_kernel(nrows, nsamples, tsamp, max_harmonics=16,
                            fmin=None, fmax=None, policy=None,
                            device="cpu"):
    """``kernel="auto"`` resolution of the periodicity scoring chain on
    ``device``.

    The JAX package measures its XLA chain (``"xla"``) against its
    Pallas kernel (``"pallas"``).  The port has one applicable variant
    on each device — on the card B6 (``"pallas"``, a kernel's plain
    version never runs there), on the CPU the plain chain (``"xla"``) —
    so it resolves statically with the JAX package's reason, "single
    applicable variant".  The key is the JAX package's: a
    ``"-harmonic"`` backend suffix, ``nchan`` the plane rows, ``ndm`` the
    harmonic depth, the policy part of the dtype.
    """
    backend = device_backend(device)
    static = "pallas" if backend == "gpu" else "xla"
    if policy in (None, "f32"):
        key_dtype = dtype_name(None)
    else:
        from ..precision import policy_name

        key_dtype = f"{dtype_name(None)}/{policy_name(policy)}"
    return get_tuner().resolve(
        backend=f"{backend}-harmonic", nchan=int(nrows),
        nsamples=int(nsamples), ndm=int(max_harmonics), dtype=key_dtype,
        candidates=[static], static=static)
