"""Preflight device-memory footprint estimator + persisted calibration.

The port of the JAX package's ``resilience/memory_budget.py``.  The
footprint of a gather or roll sweep is a strong function of its
geometry, so an out-of-memory error is predictable before the launch:
:func:`estimate_direct` models the per-dispatch bytes (operands, packed
frames, the gather/scan workspace, scoring temporaries, plane and score
outputs) — its terms are the JAX package's, so the two packages split
the same geometries at the same limit — and :func:`preflight_direct`
descends the OOM ladder (:mod:`.ladder`) until the estimate fits
``SAFETY_FRACTION`` of the headroom, **before** the sweep starts.

The model is first-order; the **calibration loop** fits it to the card:
:func:`observe` compares each estimate with the caching allocator's
high-water mark (``torch.cuda.max_memory_allocated``, reset before the
sweep) and persists a per-:func:`~..tuning.geometry.geometry_key`
measured/estimated ratio beside the tune cache
(``membudget_calib.json``, the tune cache's atomic-write and torn-file
rules).

The budget is ``PUTPU_MEM_LIMIT`` (bytes) when set — the test and drill
knob, and the operator's way to fence a shared card — else, on the
card, the allocator's limit (``torch.cuda.mem_get_info()[1]``).  On the
CPU there is no allocator limit: with no ``PUTPU_MEM_LIMIT`` the
preflight costs one environment read and does nothing, and nothing is
calibrated.
"""

from __future__ import annotations

import json
import os
import threading

__all__ = ["MEM_LIMIT_ENV", "SAFETY_FRACTION", "device_budget_bytes",
           "allocator_reports_limit", "headroom_bytes", "estimate_direct",
           "estimate_chunk_bytes", "max_beam_batch", "preflight_direct",
           "observe",
           "calibration_path", "calibration_offset", "calibrated",
           "record_calibration"]

#: env override (bytes) for the device memory budget
MEM_LIMIT_ENV = "PUTPU_MEM_LIMIT"

#: fraction of measured headroom a preflighted dispatch may plan into —
#: the slack absorbs allocator fragmentation and the model's first-order
#: blindness until calibration tightens it
SAFETY_FRACTION = 0.8

_CALIB_VERSION = 1
_lock = threading.Lock()
_calib_cache = {"path": None, "offsets": None}


# -- budget / headroom -------------------------------------------------------

#: the allocator limit per CUDA device index (static per process; the
#: preflight sits on the per-dispatch path and asks the card once)
_limit_probe = {}


def _device(device=None):
    """``device`` as a ``torch.device``; None is the card when there is
    one, else the host."""
    import torch

    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _allocator_limit(dev):
    """The card's allocator limit in bytes (``mem_get_info()[1]``), None
    on the host."""
    import torch

    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if index not in _limit_probe:
        _limit_probe[index] = int(torch.cuda.mem_get_info(index)[1])
    return _limit_probe[index]


def device_budget_bytes(device=None):
    """The device memory budget in bytes: ``PUTPU_MEM_LIMIT`` when set,
    else the card's allocator limit; ``None`` on the host — callers must
    treat ``None`` as "no budget known", never as infinite."""
    env = os.environ.get(MEM_LIMIT_ENV)
    if env:
        try:
            return int(float(env))
        except ValueError:
            pass
    return _allocator_limit(_device(device))


def allocator_reports_limit(device=None):
    """True on the card, whose allocator reports a limit and a high-water
    mark — the precondition for calibration.  ``PUTPU_MEM_LIMIT`` is
    deliberately ignored here: it is a fence, not a measurement, and
    calibrating the model against it would teach the estimator the
    operator's policy instead of the hardware."""
    return _allocator_limit(_device(device)) is not None


def headroom_bytes(device=None):
    """Budget minus bytes currently in live tensors (``None`` =
    unknown).  With no budget known this returns without touching the
    allocator — the preflight's no-op path costs one env read."""
    dev = _device(device)
    budget = device_budget_bytes(dev)
    if budget is None:
        return None
    from ..obs.memory import device_memory_snapshot

    snap = device_memory_snapshot(dev)
    in_use = int(snap["bytes_in_use"]) if snap else 0
    return max(budget - in_use, 0)


# -- the footprint model -----------------------------------------------------

def estimate_direct(nchan, nsamples, ndm, *, dm_block=32, chan_block=None,
                    formulation="gather", capture_plane=False, batch=1,
                    dm_passes=1, packed_nbits=0, dtype_bytes=4):
    """Per-dispatch HBM byte estimate for the direct sweep.

    Returns a dict of named terms plus ``total``:

    * ``operand`` — the resident chunk(s): ``batch x nchan x T`` floats,
      plus the raw packed frames when ``packed_nbits`` (the in-jit
      unpack briefly holds both);
    * ``workspace`` — the dedisperse working set of ONE live trial
      block: gather materialises an index + gathered pair of
      ``dm_block x chan_block x T`` elements; the roll sum's carry +
      rolled rows are ``O(dm_block x T)``;
    * ``scoring`` — the mean-subtracted copy and block-sum pyramid of
      one block's plane (~2x ``dm_block x T``);
    * ``outputs`` — score packs (small) plus, under ``capture_plane``,
      the per-pass slice of the full ``ndm x T`` plane.

    ``dm_passes`` scales only the output terms — the blocks of one
    pass share one live workspace — which is why the ladder's
    ``split_dm`` rung helps most where a capture inflates the output
    side.  The terms are the JAX package's, term for term.
    """
    nchan = int(nchan)
    nsamples = int(nsamples)
    ndm = max(int(ndm), 1)
    batch = max(int(batch), 1)
    dm_block = max(min(int(dm_block or 32), ndm), 1)
    cb = int(chan_block) if chan_block else nchan

    operand = batch * nchan * nsamples * dtype_bytes
    if packed_nbits:
        operand += batch * nchan * nsamples * packed_nbits // 8
    if formulation == "gather":
        workspace = 2 * dm_block * cb * nsamples * dtype_bytes
    else:
        workspace = 3 * dm_block * nsamples * dtype_bytes
    scoring = 2 * dm_block * nsamples * dtype_bytes
    nblocks = -(-ndm // dm_block)
    per_pass_blocks = -(-nblocks // max(int(dm_passes), 1))
    outputs = per_pass_blocks * 5 * dm_block * dtype_bytes
    if capture_plane:
        outputs += per_pass_blocks * dm_block * nsamples * dtype_bytes
    total = operand + workspace + scoring + outputs
    return {"operand": operand, "workspace": workspace,
            "scoring": scoring, "outputs": outputs, "total": total}


def estimate_chunk_bytes(nchan, nsamples_searched, ndm, device=None, **kw):
    """One chunk search's calibrated total on ``device``."""
    est = estimate_direct(nchan, nsamples_searched, ndm, **kw)["total"]
    return calibrated(_direct_key(nchan, nsamples_searched, ndm, device),
                      est)


def max_beam_batch(nchan, nsamples, ndm, *, dm_block=None, chan_block=None,
                   formulation="gather", packed_nbits=0, budget=None,
                   device=None):
    """Largest beam-batch width the budget admits (``None`` = unknown
    budget, no cap).  The batch axis multiplies the operand term only
    (the per-beam bodies run one after another, so one beam's workspace
    is live at a time); the batch is capped so the estimate fits
    :data:`SAFETY_FRACTION` of ``budget`` (default: the headroom of
    ``device``).  This is the JAX package's estimate of a stacked
    operand; the port's batcher holds one beam's operand at a time, so
    the cap is conservative there."""
    if budget is None:
        budget = headroom_bytes(device)
    if budget is None:
        return None
    one = estimate_direct(nchan, nsamples, ndm, dm_block=dm_block,
                          chan_block=chan_block, formulation=formulation,
                          packed_nbits=packed_nbits, batch=1)
    fixed = one["workspace"] + one["scoring"] + one["outputs"]
    per_beam = max(one["operand"], 1)
    usable = SAFETY_FRACTION * budget - fixed
    return max(int(usable // per_beam), 1)


# -- preflight ---------------------------------------------------------------

def preflight_direct(formulation, nchan, nsamples, ndm, *, dm_block,
                     chan_block, capture_plane, nblocks, packed_nbits=0,
                     device=None):
    """Descend the ladder BEFORE the sweep until the estimate fits the
    headroom of ``device`` (no-op when the headroom is unknown).  Each
    descent is counted as a ``preflight`` split.  Returns the resulting
    global level."""
    from . import ladder as _ladder

    head = headroom_bytes(device)
    if head is None:
        return _ladder.level()
    key = _direct_key(nchan, nsamples, ndm, device)
    while not _ladder.direct_maxed(formulation, nblocks):
        dm_passes = _ladder.direct_plan(formulation, nblocks)
        est = calibrated(key, estimate_direct(
            nchan, nsamples, ndm, dm_block=dm_block, chan_block=chan_block,
            formulation=formulation, capture_plane=capture_plane,
            dm_passes=dm_passes,
            packed_nbits=packed_nbits)["total"])
        if est <= SAFETY_FRACTION * head:
            break
        _ladder.descend(_ladder.direct_step(formulation))
        _ladder.count_split("preflight")
    return _ladder.level()


# -- calibration: persisted beside the tune cache ----------------------------

def _direct_key(nchan, nsamples, ndm, device=None):
    """The estimator's calibration key: the tuner's geometry axes, on
    ``device``'s backend (``"gpu"`` on the card)."""
    from ..tuning.geometry import device_backend, geometry_key

    return geometry_key(device_backend(_device(device)), nchan, nsamples,
                        ndm)


def calibration_path():
    """``membudget_calib.json`` in the tune cache's directory — the
    estimator's offsets live (and are isolated/overridden) exactly
    where the tuner's measurements do."""
    from ..tuning.cache import default_cache_path

    return os.path.join(os.path.dirname(default_cache_path()),
                        "membudget_calib.json")


def _load_offsets():
    path = calibration_path()
    with _lock:
        if _calib_cache["path"] == path \
                and _calib_cache["offsets"] is not None:
            return dict(_calib_cache["offsets"])
    offsets = {}
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if isinstance(doc, dict) \
                and doc.get("version") == _CALIB_VERSION \
                and isinstance(doc.get("offsets"), dict):
            offsets = {str(k): float(v)
                       for k, v in doc["offsets"].items()}
    except (OSError, ValueError, TypeError):
        # missing / torn / unreadable calibration degrades to the raw
        # model — estimates get less sharp, nothing fails (the tune
        # cache's own durability rule)
        offsets = {}
    with _lock:
        _calib_cache["path"] = path
        _calib_cache["offsets"] = dict(offsets)
    return offsets


def calibration_offset(key):
    """The persisted measured/estimated ratio for ``key`` (1.0 when
    uncalibrated)."""
    return _load_offsets().get(str(key), 1.0)


def calibrated(key, estimate):
    """Apply the persisted calibration offset to a raw estimate."""
    return estimate * calibration_offset(key)


def record_calibration(key, estimated, measured):
    """Persist ``measured/estimated`` for ``key`` (EWMA over the stored
    value so one outlier chunk cannot swing the offset).  Atomic write;
    an OSError is logged-and-dropped — calibration must never fail a
    search."""
    if not estimated or measured is None or measured <= 0:
        return None
    ratio = float(measured) / float(estimated)
    offsets = _load_offsets()
    prev = offsets.get(str(key))
    value = ratio if prev is None else 0.7 * prev + 0.3 * ratio
    offsets[str(key)] = round(value, 4)
    path = calibration_path()
    try:
        from ..io.atomic import atomic_write_json

        atomic_write_json(path,
                          {"version": _CALIB_VERSION, "offsets": offsets},
                          indent=1, sort_keys=True, trailing_newline=True)
    except OSError as exc:
        import logging

        logging.getLogger("pulsarutils_tpu_torch").warning(
            "membudget calibration persist failed (%r); offset kept "
            "in-memory only", exc)
    with _lock:
        _calib_cache["path"] = path
        _calib_cache["offsets"] = dict(offsets)
    return value


def observe(nchan, nsamples, ndm, estimated, device=None):
    """Validate one sweep's estimate against the card's high-water mark
    (``torch.cuda.max_memory_allocated``, which the caller resets before
    the sweep) and fold the ratio into the persisted calibration.  The
    host has no allocator statistics: ``None``, nothing to calibrate
    against."""
    from ..obs.memory import device_memory_snapshot

    dev = _device(device)
    snap = device_memory_snapshot(dev) if dev.type == "cuda" else None
    if not snap or not snap.get("peak_bytes_in_use"):
        return None
    return record_calibration(_direct_key(nchan, nsamples, ndm, dev),
                              estimated, snap["peak_bytes_in_use"])
