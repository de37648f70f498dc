"""Failure policy: dispatch deadlines, the data-integrity gate, the
quarantine manifest.

* :class:`DispatchPolicy` + :func:`call_with_deadline` — a wedged device
  dispatch runs on a watchdog thread with a deadline, then retries and
  falls back (``pipeline/search_pipeline.py: _search_with_fallback``);
* :func:`gate_chunk` (a host float block, numpy), :func:`gate_tensor` (a
  float32 block on any device, torch) and :func:`gate_frames` (8-bit
  frames as stored, torch) — the pre-search integrity gate:
  non-finite, dead-channel, zero and saturation fractions against an
  :class:`IntegrityPolicy`.  Recoverable chunks are **sanitized**
  (non-finite values imputed with the per-channel median, NumPy's
  ``nanmedian``), unrecoverable ones **quarantined**.  Both return the
  JAX package's ``gate_chunk`` verdict, ``stats`` and sanitized values on
  the same chunk; :func:`gate_chunk_packed` and :func:`gate_chunk_lowbit`
  — the code-domain gate of 1/2/4-bit chunks (rail, zero and
  dead-channel fractions of the codes), on the reader thread;
* :class:`QuarantineManifest` — the ``quarantine_<fingerprint>.jsonl``
  record of every quarantined chunk and persist dead-letter, which the
  end-of-run audit (:mod:`.audit`) checks against the ledger.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import warnings

import numpy as np
import torch

from ..obs import metrics as _metrics


class DispatchTimeoutError(RuntimeError):
    """A device dispatch exceeded its deadline.  A ``RuntimeError``: the
    fallback ladder treats it like any other device failure — retry, then
    the host path."""


@dataclasses.dataclass(frozen=True)
class DispatchPolicy:
    """Deadline and retry policy for one chunk's device dispatch.

    The defaults are one same-device retry, no backoff and no deadline
    (the dispatch runs inline on the calling thread).  ``timeout_s`` arms
    the watchdog: the dispatch runs on a daemon thread and a hang is
    bounded by ``timeout_s`` per attempt.  Caveats: an abandoned attempt
    keeps running — on the card too, where its launches queue beside the
    retry's and it keeps its memory until it ends (:func:`join_abandoned`
    waits for it); the deadline includes any first-call kernel build, so
    size it above the cold build or warm up first.
    """

    timeout_s: float | None = None
    retries: int = 1          # same-device re-attempts before fallback
    backoff_s: float = 0.0    # base for exponential backoff between them


#: watchdog threads whose attempt passed its deadline and was abandoned
_ABANDONED = []
_ABANDONED_LOCK = threading.Lock()


def call_with_deadline(fn, timeout_s=None):
    """Run ``fn()`` bounded by ``timeout_s`` seconds.

    ``timeout_s=None``/``0`` calls inline.  Otherwise ``fn`` runs on a
    fresh daemon thread, on the caller's current CUDA stream (PyTorch's
    current stream is per thread: work the watchdog queues must follow
    what the caller queued, such as the chunk's upload and clean), and
    :class:`DispatchTimeoutError` is raised when the deadline passes; the
    abandoned thread is left to finish, its result discarded.
    """
    if not timeout_s:
        return fn()
    import contextvars

    box = {}
    ctx = contextvars.copy_context()
    stream = (torch.cuda.current_stream() if torch.cuda.is_initialized()
              else None)

    def target():
        try:
            if stream is None:
                box["value"] = ctx.run(fn)
            else:
                with torch.cuda.stream(stream):
                    box["value"] = ctx.run(fn)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            box["exc"] = exc

    t = threading.Thread(target=target, daemon=True,
                         name="putpu-dispatch-watchdog")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        with _ABANDONED_LOCK:
            _ABANDONED.append(t)
        raise DispatchTimeoutError(
            f"device dispatch exceeded the {timeout_s}s deadline (wedged "
            "device? the attempt was abandoned).  NOTE: a first call's "
            "kernel build counts against the deadline")
    if "exc" in box:
        raise box["exc"]
    return box["value"]


def join_abandoned(timeout=None):
    """Join every abandoned watchdog thread (each within ``timeout``
    seconds); returns how many are still alive."""
    with _ABANDONED_LOCK:
        threads = list(_ABANDONED)
    for t in threads:
        t.join(timeout)
    with _ABANDONED_LOCK:
        _ABANDONED[:] = [t for t in _ABANDONED if t.is_alive()]
        return len(_ABANDONED)


# ---------------------------------------------------------------------------
# Data-integrity gate
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IntegrityPolicy:
    """Thresholds for the pre-search chunk gate.  A chunk breaching any
    ``max_*`` fraction is quarantined; a chunk with a sub-threshold
    non-finite fraction is sanitized when ``sanitize`` is set (the
    ``"sanitize"`` policy) or quarantined when not (``"strict"``)."""

    max_nan_frac: float = 0.25
    max_dead_frac: float = 0.5
    max_sat_frac: float = 0.5
    max_zero_frac: float = 0.75
    sanitize: bool = True


def resolve_integrity_policy(policy):
    """``"sanitize"`` / ``"strict"`` / ``"off"`` / an
    :class:`IntegrityPolicy` / None -> a policy or None."""
    if policy is None or policy == "off" or policy is False:
        return None
    if isinstance(policy, IntegrityPolicy):
        return policy
    if policy == "sanitize":
        return IntegrityPolicy()
    if policy == "strict":
        return IntegrityPolicy(sanitize=False)
    raise ValueError(f"quarantine policy {policy!r}: expected 'sanitize', "
                     "'strict', 'off' or an IntegrityPolicy")


def chunk_stats(block, finite=None):
    """Integrity fractions of a ``(nchan, nsamp)`` host float block, at
    full precision: non-finite, dead channels (zero variance over the
    finite values, two-pass with float64 accumulation), exact zeros, and
    values pinned at the block maximum (non-finite values count as 0
    there).  ``finite`` takes a precomputed ``np.isfinite(block)``."""
    block = np.asarray(block)
    if finite is None:
        finite = np.isfinite(block)
    n = block.size
    nfinite = int(finite.sum())
    nan_frac = (n - nfinite) / n
    safe = np.where(finite, block, 0.0)
    cnt = finite.sum(axis=1)
    denom = np.maximum(cnt, 1)
    mean = safe.sum(axis=1, dtype=np.float64) / denom
    mean_s = mean.astype(safe.dtype, copy=False)
    dev = np.where(finite, safe - mean_s[:, None], 0.0)
    var = np.einsum("ct,ct->c", dev, dev, dtype=np.float64) / denom
    dead_frac = float(((var <= 0) | (cnt == 0)).mean())
    zero_frac = float(((block == 0) & finite).sum() / n)
    if nfinite:
        vmax = float(safe.max())
        sat_frac = float(((block == vmax) & finite).sum() / n)
    else:
        sat_frac = 0.0
    return {"nan_frac": float(nan_frac), "dead_frac": dead_frac,
            "zero_frac": zero_frac, "sat_frac": sat_frac}


def _verdict(raw, policy):
    """The gate's decision on the raw fractions: ``(verdict, reasons)``,
    the verdict ``"quarantine"``, ``"clean"`` or ``"sanitize"``.  The
    six-decimal rounding of the reported stats is display only."""
    reasons = [name for name, frac, lim in (
        ("nan_frac", raw["nan_frac"], policy.max_nan_frac),
        ("dead_frac", raw["dead_frac"], policy.max_dead_frac),
        ("zero_frac", raw["zero_frac"], policy.max_zero_frac),
        ("sat_frac", raw["sat_frac"], policy.max_sat_frac),
    ) if frac > lim]
    if reasons:
        return "quarantine", reasons
    if raw["nan_frac"] == 0.0:
        return "clean", []
    if not policy.sanitize:
        return "quarantine", ["nan_frac(strict)"]
    return "sanitize", []


def gate_chunk(block, policy):
    """Gate one host float chunk.  Returns ``(block, info)``, ``info`` =
    ``{"verdict": "clean"|"sanitized"|"quarantine", "stats": {...},
    "reasons": [...]}``; a clean or quarantined chunk comes back as the
    same object, a sanitized one as a new array with every non-finite
    value replaced by its channel's median of finite values (0 for a
    channel with none)."""
    block_arr = np.asarray(block)
    finite = np.isfinite(block_arr)
    raw = chunk_stats(block_arr, finite=finite)
    stats = {k: round(v, 6) for k, v in raw.items()}
    verdict, reasons = _verdict(raw, policy)
    if verdict != "sanitize":
        return block, {"verdict": verdict, "stats": stats,
                       "reasons": reasons}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # all-NaN channel median
        med = np.nanmedian(np.where(finite, block_arr, np.nan), axis=1)
    med = np.where(np.isfinite(med), med, 0.0)
    out = np.where(finite, block_arr, med[:, None])
    return out, {"verdict": "sanitized", "stats": stats, "reasons": []}


def _finite_median(block, finite):
    """Per-row median of the finite values of ``block`` in float64, the
    mean of the two middle values at an even count (NumPy's
    ``nanmedian``), 0 for a row with none (:mod:`..ops.robust`'s rule:
    ``torch.nanmedian`` takes the lower middle value instead)."""
    ordered = torch.sort(torch.where(finite, block.to(torch.float64),
                                     float("inf")), dim=1).values
    cnt = finite.sum(dim=1, keepdim=True)
    hi = ordered.gather(1, (cnt // 2).clamp(max=block.shape[1] - 1))
    lo = ordered.gather(1, ((cnt - 1) // 2).clamp(min=0))
    med = (lo + hi) * 0.5
    return torch.where(cnt > 0, med, torch.zeros_like(med))


def gate_tensor(block, policy):
    """:func:`gate_chunk` on a float32 ``(nchan, nsamp)`` tensor on any
    device: the same verdict, ``stats`` and sanitized values (cast to
    float32) as the host gate on the same values widened to float64.

    On exact float32 values the fractions reduce to counts: a channel is
    dead when its finite values are all equal (or it has none), and
    every fraction is a count over the block or channel size.  One host
    readback of the counts."""
    finite = torch.isfinite(block)
    n, nchan = block.numel(), block.shape[0]
    safe = torch.where(finite, block, torch.zeros((), dtype=block.dtype,
                                                  device=block.device))
    inf = float("inf")
    lo = torch.where(finite, block, inf).amin(dim=1)
    hi = torch.where(finite, block, -inf).amax(dim=1)
    cnt = finite.sum(dim=1)
    dead = ((lo == hi) | (cnt == 0)).sum()
    zeros = ((block == 0) & finite).sum()
    sat = ((block == safe.amax()) & finite).sum()
    nfinite, ndead, nzero, nsat = torch.stack(
        [cnt.sum(), dead, zeros, sat]).tolist()
    raw = {"nan_frac": (n - nfinite) / n, "dead_frac": ndead / nchan,
           "zero_frac": nzero / n,
           "sat_frac": nsat / n if nfinite else 0.0}
    stats = {k: round(v, 6) for k, v in raw.items()}
    verdict, reasons = _verdict(raw, policy)
    if verdict != "sanitize":
        return block, {"verdict": verdict, "stats": stats,
                       "reasons": reasons}
    med = _finite_median(block, finite).to(block.dtype)
    out = torch.where(finite, block, med)
    return out, {"verdict": "sanitized", "stats": stats, "reasons": []}


def gate_frames(frames, policy):
    """The gate's ``info`` for integer frames ``(nsamp, nchan)`` as one IF
    stores them (8-bit samples, on any device): the verdict and ``stats``
    of :func:`gate_chunk` on their float block, computed on the stored
    bytes, a quarter of the float32 block's.  Integers hold no NaN or
    Inf, so nothing is ever sanitized and the frames are not returned.

    The zero and saturation counts come from a histogram of the bytes
    (``torch.bincount``, 256 bins): a sum over a block-sized boolean
    mask would first widen it to int64, eight bytes a sample."""
    lo, hi = frames.amin(dim=0), frames.amax(dim=0)
    counts = torch.bincount(frames.reshape(-1).view(torch.uint8),
                            minlength=256)
    vmax = hi.amax().to(torch.uint8).long()  # int8 wraps onto its byte
    ndead, nzero, nsat = torch.stack([
        (lo == hi).sum(), counts[0], counts[vmax]]).tolist()
    n, nchan = frames.numel(), frames.shape[1]
    raw = {"nan_frac": 0.0, "dead_frac": ndead / nchan,
           "zero_frac": nzero / n, "sat_frac": nsat / n}
    verdict, reasons = _verdict(raw, policy)
    return {"verdict": verdict, "stats": {k: round(v, 6)
                                          for k, v in raw.items()},
            "reasons": reasons}


def lowbit_code_stats(codes, nbits):
    """Integrity fractions of a low-bit CODE block ``(nchan, n)`` (integer
    values ``0 .. 2^nbits - 1`` in any numeric dtype): ``zero_frac``,
    codes at the bottom rail (dropped packets); ``rail_frac``, codes at
    the top rail (a clipped digitiser, saturating RFI); ``dead_frac``,
    channels whose codes never change.  The float gate's fractions mean
    nothing on codes: a healthy 1-bit chunk sits at a rail half the
    time."""
    codes = np.asarray(codes)
    mask = (1 << int(nbits)) - 1
    zero_frac = float((codes == 0).mean())
    rail_frac = float((codes == mask).mean())
    dead_frac = float((codes.max(axis=1) == codes.min(axis=1)).mean())
    return {"zero_frac": zero_frac, "rail_frac": rail_frac,
            "dead_frac": dead_frac, "nbits": int(nbits)}


def _lowbit_verdict(raw, nbits, policy):
    """The code-domain rule of the packed and host-decoded low-bit gates.
    Healthy uniform codes already put ``2^-nbits`` of the samples on each
    rail, so the policy's zero and saturation limits are read as the
    share of the way from there to 100%: ``limit' = expected + (1 -
    expected) * limit``.  Codes hold nothing to sanitize: the verdict is
    ``"clean"`` or ``"quarantine"`` under every policy."""
    expected = 2.0 ** -int(nbits)
    zero_lim = expected + (1.0 - expected) * policy.max_zero_frac
    rail_lim = expected + (1.0 - expected) * policy.max_sat_frac
    stats = {k: (round(v, 6) if isinstance(v, float) else v)
             for k, v in raw.items()}
    reasons = [name for name, frac, lim in (
        ("zero_frac", raw["zero_frac"], zero_lim),
        ("rail_frac", raw["rail_frac"], rail_lim),
        ("dead_frac", raw["dead_frac"], policy.max_dead_frac),
    ) if frac > lim]
    if reasons:
        return {"verdict": "quarantine", "stats": stats,
                "reasons": reasons}
    return {"verdict": "clean", "stats": stats, "reasons": []}


def gate_chunk_packed(frames, nbits, nchan, policy, max_rows=4096):
    """Gate one PACKED low-bit chunk ``(nsamps, bytes_per_frame)`` uint8
    from a strided decode of at most ``max_rows`` frames
    (:func:`~..io.lowbit.sample_codes`), on the reader thread; returns
    ``(frames, info)`` with the frames untouched."""
    from ..io.lowbit import sample_codes

    frames = np.asarray(frames)
    codes = sample_codes(frames, nbits, nchan, max_rows=max_rows)
    return frames, _lowbit_verdict(lowbit_code_stats(codes, nbits),
                                   nbits, policy)


def gate_chunk_lowbit(block, nbits, policy, max_cols=4096):
    """Gate one host-DECODED low-bit chunk (a float code block ``(nchan,
    n)``, the multi-IF path) by the rule of :func:`gate_chunk_packed`, on
    a strided subsample of at most ``max_cols`` columns."""
    block = np.asarray(block)
    stride = max(1, block.shape[1] // int(max_cols))
    return block, _lowbit_verdict(
        lowbit_code_stats(block[:, ::stride], nbits), nbits, policy)


# ---------------------------------------------------------------------------
# Quarantine manifest
# ---------------------------------------------------------------------------

class QuarantineManifest:
    """Append-only ``quarantine_<fingerprint>.jsonl`` beside the candidate
    store: one JSON record per quarantined chunk or persist dead-letter
    (``{"chunk", "end", "reason", "stats"?}``).  Created on the first
    record, so a clean run's output directory holds no manifest.  Records
    come from the main loop and the persist worker: appends are locked."""

    def __init__(self, directory, fingerprint=None):
        self.directory = str(directory)
        self.fingerprint = fingerprint
        self.path = os.path.join(
            self.directory, f"quarantine_{fingerprint or 'noresume'}.jsonl")
        self._lock = threading.Lock()

    def record(self, chunk, end, reason, stats=None):
        rec = {"chunk": int(chunk), "end": int(end), "reason": str(reason)}
        if stats:
            rec["stats"] = stats
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            os.makedirs(self.directory, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(line + "\n")
        _metrics.counter("putpu_quarantine_records_total").inc()
        return rec

    def records(self):
        """Every record in file order (``[]`` without a manifest); a torn
        line (a crash mid-append) is skipped."""
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
        return out

    def chunks(self, reason_prefix=None):
        """Set of quarantined chunk starts, optionally only those whose
        reason starts with ``reason_prefix``."""
        return {r["chunk"] for r in self.records()
                if reason_prefix is None
                or str(r["reason"]).startswith(reason_prefix)}
