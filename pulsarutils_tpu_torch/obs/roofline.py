"""Per-launch roofline accounting: measured time against a work model.

The port of the JAX package's module.  The JAX package reads each
dispatch's FLOPs and bytes from XLA's cost analysis of the compiled
program; the port's kernels are hand-written, so each states its work
here, as a function of its shapes: the float32 operations it must do
and the bytes it must move (each input read once, each output written
once).  The same formulas give ``chip_smoke.py``'s bounds, so one count
serves both:

* B1, the direct sweep (:func:`sweep_work`): one add per trial, channel
  and sample; the data, the offsets and the plane once each;
* B3, B2a and B2b, the FDMT passes (:func:`fdmt_pass_work`): the adds
  of the rows they build; the input and output states and the tables;
* B4, the one-pass scorer (:func:`score_work`): ~16 adds a sample;
  the plane read and the scores written;
* B5, the FDD rotate-accumulate (:func:`fdd_work`): a complex multiply
  and add (6 operations) per trial, channel and bin; the spectrum, the
  phase limbs and the output;
* B6, the harmonic scorer (:func:`b6_work`): the stack's harmonic adds
  under each precision policy; the power rows read and the peaks
  written;
* ``device_clean`` (:func:`clean_work`): the chunk read and written;
* the hybrid's fused seed program (:func:`fused_seed_work`): its coarse
  passes, their scoring, and the sweep and scoring of its seed and need
  buckets.

Times are the card's own: a CUDA event pair around each launch on the
current stream, read back lazily (:func:`flush`), so recording adds no
synchronisation; on the CPU the wall clock.  The peaks are the card's,
from :data:`CARD_PEAKS` keyed by ``torch.cuda.get_device_name()``,
unless :func:`set_peaks` or the ``PUTPU_PEAK_FLOPS`` /
``PUTPU_PEAK_BYTES_PER_S`` variables give them (either overrides the
table); a card not in the table (and the CPU) without them gets no
fraction, only the achieved rates.  Accounting is opt-in
(:func:`enable`, the CLI's ``--trace``, or
``PUTPU_ROOFLINE=1``); disabled, :func:`begin` is one global read.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

from . import metrics

__all__ = ["CARD_PEAKS", "PEAK_FP32_ADDS", "PEAK_HBM_BYTES_S",
           "B6_OPS_PER_ADD", "bound_ms", "sweep_bound_ms", "b6_bound_ms",
           "sweep_work", "fdmt_pass_work", "score_work", "fdd_work",
           "b6_work", "clean_work", "fused_seed_work", "enable", "disable",
           "enabled", "set_peaks", "begin", "end", "flush", "record",
           "table",
           "log_table", "reset"]

#: NVIDIA H100 SXM data-sheet peaks (700 W).  The sheet's 67 TFLOP/s
#: float32 on the CUDA cores counts each fused multiply-add as two
#: operations; a plain float32 add is one operation per lane per clock,
#: so adds issue at half that: 33.5e12 adds/s.  HBM3 bandwidth 3.35 TB/s.
PEAK_FP32_ADDS = 33.5e12
PEAK_HBM_BYTES_S = 3.35e12

#: ``torch.cuda.get_device_name()`` -> (float32 operations/s, bytes/s)
CARD_PEAKS = {"NVIDIA H100 80GB HBM3": (PEAK_FP32_ADDS, PEAK_HBM_BYTES_S)}

#: float32 operations of one harmonic add of B6's stack under each policy:
#: a TwoSum step is 7 (compensated, split); a bf16 rounding costs 2 a bin
#: (the conversion there and back), counted apart
B6_OPS_PER_ADD = {"f32": 1, "f32_compensated": 7, "split_f32": 7,
                  "bf16_operand_f32_accum": 1}


def bound_ms(adds, nbytes):
    """Least time on the H100: the larger of ``adds`` float32 operations
    over the add rate and ``nbytes`` over the memory rate, in ms, with
    what sets it (``"operations"`` or ``"bytes"``)."""
    t_ops, t_bytes = adds / PEAK_FP32_ADDS, nbytes / PEAK_HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# -- work models: (float32 operations, bytes) of one launch ------------------

def sweep_work(ndm, nchan, nsamples):
    """B1: its adds, and its bytes (input, offsets and plane, each once)."""
    return (ndm * nchan * nsamples,
            4 * (nchan * nsamples + ndm * nsamples + ndm * nchan))


def sweep_bound_ms(ndm, nchan, nsamples):
    """Least time for the sweep (:func:`sweep_work`)."""
    return bound_ms(*sweep_work(ndm, nchan, nsamples))


def fdmt_pass_work(adds_per_sample, nsamples, rows_in, rows_out,
                   table_numel):
    """An FDMT pass: ``adds_per_sample`` adds for each of ``nsamples``
    samples (the head: its rows' counts summed; a merge level: one a row
    built; the fused last two levels: three a row); each input and output
    state once, and the int32 tables."""
    return (adds_per_sample * nsamples,
            4 * nsamples * (rows_in + rows_out) + 4 * table_numel)


def score_work(rows, nsamples, nout):
    """B4: ~16 adds a sample; the plane read once, the ``nout`` float64
    scores written once."""
    return 16 * rows * nsamples, 4 * rows * nsamples + 8 * nout


def fdd_work(nchan, nbin, superblock, phasor_ops=0):
    """B5: one complex multiply (2 FMUL + 2 FFMA) and one complex add
    (2 FADD) per (trial, channel, bin), plus ``phasor_ops`` per channel and
    bin for the phasor build; the spectrum and the limbs read once, the
    output written once."""
    return ((6 * superblock + phasor_ops) * nchan * nbin,
            8 * nchan * nbin + 4 * 7 * nchan + 8 * superblock * nbin)


def b6_work(rows, nbins, depths, policy="f32"):
    """B6 under ``policy``: the stack's harmonic adds (with the TwoSum's
    and the depths' ``acc + comp`` under compensation, the bf16
    roundings); one read of the power rows and the peaks written."""
    adds = rows * sum(-(-nbins // j) for j in range(1, depths[-1] + 1))
    ops = B6_OPS_PER_ADD[policy] * adds
    if B6_OPS_PER_ADD[policy] > 1:
        ops += rows * nbins * len(depths)
    if policy == "bf16_operand_f32_accum":
        ops += 2 * rows * nbins
    return ops, 4 * rows * nbins + 8 * rows * len(depths)


def b6_bound_ms(rows, nbins, depths, policy):
    """B6's bound under ``policy`` (:func:`b6_work`)."""
    return bound_ms(*b6_work(rows, nbins, depths, policy))


def clean_work(nchan, nsamples):
    """``device_clean``: the chunk read and the cleaned chunk written (its
    operations are not counted: a bytes-only model)."""
    return 0, 8 * nchan * nsamples


def fused_seed_work(coarse_work, coarse_rows, nchan, nsamples, buckets):
    """The hybrid's fused seed program: ``coarse_work``, the FDMT passes'
    ``(operations, bytes)``, the scoring of their ``coarse_rows`` rows
    with the certificate row, and a B1 sweep and a B4 scoring of each of
    the ``buckets`` (the seed's rows, the need stage's)."""
    ops, nbytes = coarse_work
    parts = [score_work(coarse_rows, nsamples, 6 * coarse_rows)]
    for rows in buckets:
        parts += [sweep_work(rows, nchan, nsamples),
                  score_work(rows, nsamples, 5 * rows)]
    for o, b in parts:
        ops, nbytes = ops + o, nbytes + b
    return ops, nbytes


# -- accounting --------------------------------------------------------------

_LOCK = threading.Lock()
_ENABLED = None          # tri-state: None = read the environment once
_PEAKS = None            # (operations/s, bytes/s), either may be None
_STATS = {}              # name -> accumulated dict
_PENDING = []            # (name, start event, end event, work)


def enable():
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def enabled():
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = os.environ.get("PUTPU_ROOFLINE", "") not in ("", "0")
    return _ENABLED


def set_peaks(peak_flops=None, peak_bytes_per_s=None):
    """Pin the roofline peaks (operations/s, bytes/s) instead of the
    card's :data:`CARD_PEAKS` row; ``None`` leaves that bound unset."""
    global _PEAKS
    _PEAKS = (peak_flops, peak_bytes_per_s)


def _peaks():
    global _PEAKS
    if _PEAKS is None:
        env_f = os.environ.get("PUTPU_PEAK_FLOPS")
        env_b = os.environ.get("PUTPU_PEAK_BYTES_PER_S")
        if env_f or env_b:
            _PEAKS = (float(env_f) if env_f else None,
                      float(env_b) if env_b else None)
            return _PEAKS
        _PEAKS = (None, None)
        try:
            import torch

            if torch.cuda.is_available():
                _PEAKS = CARD_PEAKS.get(torch.cuda.get_device_name(),
                                        (None, None))
        except Exception:  # noqa: BLE001 — no card: no fraction
            pass
    return _PEAKS


def reset():
    """Clear the accumulated stats and pending records (tests)."""
    global _PEAKS
    with _LOCK:
        _STATS.clear()
        _PENDING.clear()
    _PEAKS = None


def begin(device):
    """Start a measurement of a launch on ``device``; ``None`` when
    disabled (the matching :func:`end` is then free).  On a card, a CUDA
    event on the current stream; on the CPU, the wall clock."""
    if not enabled():
        return None
    if getattr(device, "type", device) == "cuda":
        import torch

        start = torch.cuda.Event(enable_timing=True)
        start.record()
        return start
    return time.perf_counter()


def end(token, name, work):
    """Finish a measurement started by :func:`begin`; ``work`` is the
    launch's ``(operations, bytes)``."""
    if token is None:
        return
    if isinstance(token, float):
        record(name, work, time.perf_counter() - token)
        return
    import torch

    stop = torch.cuda.Event(enable_timing=True)
    stop.record()
    with _LOCK:
        _PENDING.append((name, token, stop, work))


@contextlib.contextmanager
def measure(device, name, work):
    """Charge the block, one wrapper's launch on ``device``, to kernel
    ``name``: :func:`begin` before it, :func:`end` after it with
    ``work()``, the launch's ``(operations, bytes)``.  Free when
    accounting is off (``work`` is then never called); a block that
    raises records nothing."""
    token = begin(device)
    yield
    if token is not None:
        end(token, name, work())


def flush():
    """Read back the pending CUDA event pairs (waiting for their
    launches) and record them."""
    with _LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    for name, start, stop, work in pending:
        stop.synchronize()
        record(name, work, start.elapsed_time(stop) / 1e3)


def record(name, work, wall_s):
    """Attribute one completed launch of ``work`` ``(operations, bytes)``
    taking ``wall_s`` seconds to kernel ``name``."""
    ops, nbytes = float(work[0]), float(work[1])
    with _LOCK:
        st = _STATS.setdefault(name, {"calls": 0, "wall_s": 0.0,
                                      "flops": 0.0, "bytes": 0.0,
                                      "uncosted": 0})
        st["calls"] += 1
        st["wall_s"] += wall_s
        st["flops"] += ops
        st["bytes"] += nbytes
    if wall_s > 0:
        metrics.gauge("putpu_roofline_gflops", kernel=name).set(
            round(ops / wall_s / 1e9, 3))
        metrics.gauge("putpu_roofline_gbytes_per_s", kernel=name).set(
            round(nbytes / wall_s / 1e9, 3))
        frac = _fraction(ops, nbytes, wall_s)
        if frac is not None:
            metrics.gauge("putpu_roofline_frac_of_ideal", kernel=name).set(
                round(frac, 4))


def _fraction(ops, nbytes, wall_s):
    peak_f, peak_b = _peaks()
    bounds = [ops / peak_f if peak_f else None,
              nbytes / peak_b if peak_b else None]
    bounds = [b for b in bounds if b is not None]
    if not bounds or wall_s <= 0:
        return None
    return max(bounds) / wall_s


def table():
    """Per-kernel rows with the JAX package's keys: calls, wall, work
    (``gflops_total`` counts float32 operations), achieved rates and the
    fraction of the bound (``None`` without the card's peaks)."""
    flush()
    with _LOCK:
        stats = {k: dict(v) for k, v in _STATS.items()}
    rows = []
    for name, st in sorted(stats.items(), key=lambda kv: -kv[1]["wall_s"]):
        wall = st["wall_s"]
        row = {"kernel": name, "calls": st["calls"],
               "wall_s": round(wall, 4),
               "gflops_total": round(st["flops"] / 1e9, 3),
               "gbytes_total": round(st["bytes"] / 1e9, 3),
               "achieved_gflops": (round(st["flops"] / wall / 1e9, 3)
                                   if wall > 0 else None),
               "achieved_gbytes_per_s": (round(st["bytes"] / wall / 1e9, 3)
                                         if wall > 0 else None),
               "frac_of_ideal": None,
               "uncosted_calls": st["uncosted"]}
        frac = _fraction(st["flops"], st["bytes"], wall)
        if frac is not None and st["flops"] + st["bytes"] > 0:
            row["frac_of_ideal"] = round(frac, 4)
        rows.append(row)
    return rows


def log_table(log=None):
    """Log the table, one line a kernel; a no-op when it is empty."""
    rows = table()
    if not rows:
        return rows
    if log is None:
        import logging

        log = logging.getLogger("pulsarutils_tpu_torch")
    log.info("roofline (card time of each launch against its work model):")
    for r in rows:
        frac = ("-" if r["frac_of_ideal"] is None
                else f"{100.0 * r['frac_of_ideal']:.1f}%")
        log.info("  %-28s %4d calls %8.3fs  %10.2f GF/s %10.2f GB/s  "
                 "bound %s", r["kernel"], r["calls"], r["wall_s"],
                 r["achieved_gflops"] or 0.0,
                 r["achieved_gbytes_per_s"] or 0.0, frac)
    return rows
