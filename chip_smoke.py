#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pulsarutils_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--quick | --breakdown | --overlap |
                           --observe | --lowbit | --autotune | --mesh |
                           --beams | --service | --fleet]

Phases, one JSON line each:

1. environment: the card (``nvidia-smi`` name and power limit, printed
   raw on a line of its own), PyTorch and CUDA versions; TF32 is turned
   off for matmuls and cuDNN;
2. build: every CUDA source of the port's paths (the direct sweep, the
   FDMT merges, the one-pass scorer, the FDD rotate-accumulate, the
   harmonic scorer), with ``nvcc``, all started together;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, timed with CUDA events (one warm-up, median of 5), beside its
   bound:
   - the direct sweep (B1) at the headline geometry (1024 channels x
     2^20 samples, the 514-trial DM 300-635 plan, in the search's
     512-trial superblocks), at 8 and 16 rows (the hybrid's rescore
     buckets) and the plan's 2-trial tail, and on edge cases (rows in
     any order with repeats among them, at 16 and at 32 rows; 40
     trials), in the plan's branch and the other one, max |diff| == 0;
     each launch's trial block and the share of distinct offsets;
   - the FDMT passes (B3: the first seven levels fused; B2a: one level;
     B2b: the last two levels fused), pass by pass through the headline
     transform (1024 x 2^20, the 512-trial DM 300+ grid of the JAX
     package's benchmark) and on edge cases (nchan 1000, T = 300007,
     T = 150, a pruned range, a group of zero channels with blocks that
     own no rows, a wide range) and through the end-to-end hybrid's
     1024 x 2^18 chunk, max |diff| == 0; B3 also against B2a over its
     seven levels;
   - the one-pass scorer (B4) on the headline coarse plane and on edge
     cases (odd T, rows not a multiple of 8, a DC offset of 1e4):
     windows and peaks equal, floats within rtol 2e-4, atol 1e-5;
   - the FDD (B5): the path on edge cases (nchan not a multiple of the
     channel block, odd T, one trial, superblock > ndm, trial-block
     tails, a non-uniform grid) against the float64 oracle (atol 2e-3),
     the fused kernel (spectrum and phase limbs in, one launch a
     superblock) against plain on small odd shapes and one 64-trial
     headline superblock (within 1e-4 of the largest output), and the
     whole 514-trial sweep of ``dedispersion_search(kernel="fourier")``
     (one B5 launch a superblock), kernels timed apart;
   - the harmonic scorer (B6), under each of its four precision policies
     (``f32``, ``f32_compensated``, ``split_f32``,
     ``bf16_operand_f32_accum``), on edge cases (rows not a multiple of 8,
     even and odd median lengths, an all-zero row, a half-zero row, zero
     tails that cross a slice boundary, the two middle values in the
     first and the last slice, a lower middle value that ends its run,
     rows long enough for the global branch alone, a band, an empty
     band, 1 and 4 harmonics), each through the branch the wrapper picks
     and through every branch that holds its rows (the global one and
     every cluster size), then the same, each branch timed, at the main
     paths' shapes (512 and 2 x 131,073 bins of ``period_search``, 514 x
     327,681 of a ``PUperiod`` trial) and on the power of a 512 x 2^20
     plane: peak bins and values equal to plain's under the same policy,
     the false-alarm chain within rtol 1e-5 with depths and bins exact;
4. hybrid headline: the JAX package's benchmark data (1024 x 2^20,
   |N(0,1)| / 2, an impulse at T/2 dispersed at DM 350) searched by
   ``dedispersion_search(kernel="hybrid")`` (the fused seed program: B4 =
   B1 + 1 launches, B1 >= 2, the dispatches and readbacks of one call
   printed, one each unless the host loop runs) and by the full exact
   sweep; the hybrid's best row must equal the sweep's (argbest, DM,
   rebin, peak; snr within rel 1e-5) and its every exact row the sweep's
   row; B1 on the seed and need rows (planned on the card) equal to
   plain bit for bit; coarse, fused, two-stage and sweep times; then the
   hybrid's breakdown (``hybrid_breakdown``, at 1024 x 2^18 and 1024 x
   2^20, fused and two-stage: the budget's buckets, B1 and B4 card
   time, the rows' planning on the card, the rest; one 8-row B1 launch
   planned on the card against the host-planned one, each bit for bit
   and timed against its bound); then the
   direct sweep through its entry points, phase by phase (B1 through
   its wrapper at the superblocks, the rescore buckets and the tail; the
   exact search's first call and its repeats split into B1, B4 and the
   rest); then B6 and B3 at the main paths' shapes, phase by phase (B6
   at 512 and 2 x 131,073 bins of ``period_search``, 514 x 327,681 of
   the ``PUperiod`` job and 512 x 524,289, the whole stack against one
   harmonic; B3 at 1024 x 2^20 and 1024 x 2^18, the launch against one
   that stages its input and passes its barriers only, and against the
   first four levels alone and the last three alone);
5. end to end: a simulated 1024-channel 8-bit filterbank with a dispersed
   pulse, searched by the port's ``search_by_chunks`` on the card in
   2^18-sample chunks with the direct sweep, then with the hybrid (at
   S/N 8, fused on every chunk; at S/N 8 with an injected OOM at the
   first dispatch, the ``unfuse`` rung taken and every chunk two-stage,
   its hits, best rows and common exact rows the fused run's; at the
   certifiable floor, two-stage), then with the FDD: the pulse
   must be found in its chunk at the injected DM, the hybrid's hits must
   equal the direct sweep's, and each path's kernels must have launched
   (their counts are set to 0 before each run and read after it); the
   cleaned chunk and a cut of the search are checked against the CPU
   path; then the precision policies (``e2e_precision``): the file with
   ``kernel="roll"`` under ``PUTPU_PRECISION=f32_compensated`` and
   ``kernel="gather"`` under ``bf16_operand_f32_accum``, each beside its
   ``f32`` run (hits equal, snr within the strategy's ``score_rtol``;
   roll's ``f32`` hits equal the direct sweep's), the roll ``f32`` plane
   of the pulse's chunk equal to B1's bit for bit, and
   ``spectral_search`` of that 514-trial plane under every policy
   (each row's best bin and depth equal to ``f32``'s with its power
   within the strategy's ``score_rtol``, or, where a noise row's best
   moved, its sigma within that tolerance); every main-path run must
   report no fallback, no OOM descent and no quarantined chunk;
   then the failure drill (``e2e_faults``): on the same file, each
   scenario a FaultPlan armed against a clean run — a transient dispatch
   error (one retry, equal tables), NaNs below the gate's threshold
   (sanitized, equal files) and a hard corruption (quarantined,
   recorded, not searched on resume), these two on quarter chunks (2^16
   samples: the noise chunk and the pulse's) against a clean run of that
   geometry, as the corrupted chunk goes through the host float64 path, a transient and a persistent persist error
   (retried; dead-lettered), a persistent read error (``read_error``,
   the other chunks searched), a ``torch.OutOfMemoryError`` at the
   dispatch (the ladder descends, the tables and files bit for bit the
   clean run's), a 5 s hang under a 1 s deadline (the chunk moves on,
   the watchdog joined), a persistent OOM at the dispatch (the ladder
   to its floor, then ``oom_floor``, the other chunks' tables the clean
   run's) and a persistent dispatch fault (the error propagates after
   its retry: the card never falls back to the host);
6. periodicity: a 1024-channel 8-bit file of the same geometry holding
   a ~10 Hz pulsar at DM 400, searched by ``search_by_chunks(
   period_search=True)`` (the pulsar in every chunk) and by
   ``periodicity_search`` with 5 acceleration trials and the canary
   (the pulsar the best candidate, the canary recovered); then FDAS
   (``e2e_fdas``): the JAX package's benchmark case (a jerked sinusoid
   on a synthetic 8 x 16384 plane, 9 accelerations x 5 jerks) through
   ``fdas_search`` and ``accel_search`` on the card (each recovering the
   injected cell, the tables equivalent, both walls), the pulsar job
   again with ``accel_backend="fdas"`` resumed from the first job's
   ledger and snapshot (the pulsar and the canary recovered, the best
   candidate equivalent to the time-stretch job's; the trial sweep's
   seconds, the peak device bytes, B6's launches), and ``fdas_search``
   on the card against the CPU on 8 DM rows of that plane (discrete
   fields equal, sigma within rel 1e-4);
7. the overlapped loop (``e2e_overlap``): a 6-chunk, 0.94 GB file of
   the same geometry (DM 400 pulses in 4 chunks) searched serially and
   overlapped in the order S, O, O, S: equal hits, byte-equal ledgers
   and candidate files, B1 and B4 twice a chunk, stage seconds, chunks/s
   and peak device bytes per run;
8. accounting and reporting (``e2e_observe``, run after the drill on the
   end-to-end file): the direct sweep at S/N 8 once plain, once under
   the span tracer and the device profiler alone (its hits and ledger
   bytes equal the plain run's; the loop's own busy share) and once with
   every observer on (diagnostic plots of the hits, the survey report,
   the span trace and the ``torch.profiler`` device trace with roofline
   accounting, a ``.prom`` metrics file, the HTTP surface on an
   ephemeral port scraped from a thread during the loop, the canary in
   every chunk, lineage, push to a webhook served by this script): the
   hits equal the plain run's (snr within 1e-2: the canary's bump moves
   the chunk's statistics), the ledger bytes equal, B1 and B4 as many
   launches, canary recall 1.0, ``/healthz`` answered, the Prometheus
   text parsed, one JPEG a hit (or ``plots: skipped (no matplotlib)``),
   ``BUDGET_JSON`` logged, both device traces written and holding CUDA
   events in the loop; it prints the three loops' seconds, seconds a
   plot, the budget's unattributed share and the card's busy share over
   each traced loop from its device trace;
9. the low-bit files (``e2e_lowbit``): the device unpack at 1024 x 2^18,
   1, 2 and 4 bits in both band orders, equal to the host decode bit for
   bit and timed against its byte bound; the end-to-end geometry at 2
   bits (the DM 400 pulse quantised, 168 MB) and an 8-bit twin holding
   the same codes, searched direct at S/N 8 in the order packed, twin,
   twin, packed: equal hits, tables and ledgers, B1 and B4 as often as on
   the twin, a quarter of its uploaded bytes, the ``putpu_lowbit_*``
   counts of the JAX package's definition, stage seconds of each run;
   1 and 4 bits the same over two chunks; the hybrid and the FDD on the
   2-bit file against the twin (B3, B2a, B2b and B5 launched on packed
   data); a copy with the first chunk at the top rail (quarantined with
   the code gate's reason); the packed canary in every chunk (the science
   hits unchanged); ``capture_plane="memmap"`` of one 514-trial chunk
   equal to the dense capture bit for bit, its file removed by
   ``release_plane``; ``PUclean`` on the card against the CPU (bytes
   equal; with ``--fft-zap`` the zapped bins equal, the differing codes
   counted); ``period_search`` on a 2-bit copy of the pulsar file (the
   pulsar in every chunk);
10. the mesh (``parallel/``), on virtual meshes of the one card:
   ``mesh_sweep`` (the sharded direct sweep of the e2e chunk, 1024 x
   2^18 and 514 trials, on (1, 1), (4, 1), (2, 2) and (1, 4) meshes:
   each plane equal to its plain version on the card, plain B1 per shard
   and the same ascending channel sum, bit for bit, the table to that
   plane's B4 scores; against the single-device search bit for bit at
   chan = 1, else the discrete columns equal and S/N within rtol 1e-4,
   the max difference printed; B1 and B4 launches, ms and peak bytes
   beside the single device's); ``mesh_fdmt`` (the sharded FDMT and the
   mesh hybrid, fused and two-stage (the card mesh's default), on
   bench.py's 1024 x 2^20 data on (4, 1) and (2, 2): each slice's rows
   against the single-device transform, B3, B2a, B2b launched, the
   hybrid's best row the single device's, fused == two-stage, the fused
   round's seed and need rows and its B1 launches no more than the
   two-stage path's); ``e2e_mesh`` (``search_by_chunks(mesh=
   (2, 2))`` on the e2e file, direct and hybrid at S/N 8: the
   single-device runs' hits and ledger, no fallback, no OOM descent; a
   persistent ``mesh``-site error raises with nothing marked done; the
   figure's arrays from a ``ShardedPlane`` and its period search);
   ``mesh_period`` (``ShardedPlane.spectral_scores`` against the
   single-device spectral search, and the pulsar job on a (2, 2) mesh
   against the single-device job's best candidate); ``multihost``
   (``python -m pulsarutils_tpu_torch.parallel.live`` at the e2e chunk's
   width, 1024 x 2^18 and 514 trials: two gloo ranks on cuda:0 and one
   NCCL rank, each printing ``MULTIHOST LIVE: OK``);
11. the tuner, the knobs, the preflight and the library surface:
   ``fdmt_knobs`` (the coarse plane under ``PUTPU_FDMT_HEAD=0`` and
   ``PUTPU_FDMT_DEEP_PAIR=0`` equal to the default's bit for bit at
   1024 x 2^18 and 1024 x 2^20, the launches of B3, B2a and B2b and the
   coarse ms of each setting); ``autotune`` (``resolve_search_kernel`` at
   the e2e chunk: each candidate's median, the abandoned ones, the winner
   and the equivalence verdicts, then a memory hit and a disk hit; the
   e2e file with ``kernel="auto"`` under ``PUTPU_AUTOTUNE=on`` with a
   cold cache and ``off``: equal hits, the decision in the budget
   record, B1 twice a chunk outside the tuner's probe;
   ``resolve_search_policy`` for the gather and the file under the
   measured policy beside ``f32``; ``resolve_harmonic_kernel`` on the
   card; after the periodicity job, ``resolve_accel_backend`` at its
   geometry and the job with the backend named, resumed: the same best
   candidate); ``preflight`` (gather and roll on the pulse's chunk under
   ``PUTPU_MEM_LIMIT`` at half the model's estimate: splits, the ladder
   level, the table bit for bit; then the allocator's high-water mark
   over the estimate and the calibration file); ``surface``
   (``quick_chan_rebin``, ``get_noisier_channels``,
   ``measure_channel_variability`` and ``spectral_stats_scan`` on the
   card against the CPU, the scan's flags against ``.badchans``).  Every
   phase that searches a file runs with a cold tune cache of its own in
   a fresh directory (``cold_tuner``; the phases whose loops are timed
   warm it first) and prints its tuning seconds (``autotune_cost``);
   launches inside the tuner's measurements are kept apart (the
   ``autotune probe`` paths of the kernels line);
12. streaming and batched beams: ``ring`` (after ``mesh_fdmt``:
   ``ring_dedisperse`` on virtual ``("time",)`` meshes of the card, the
   e2e chunk's 1024 x 2^18 with 64 trials of its plan on 4 shards, one
   hop, and 1024 x 4096 on 8 shards, two hops: bit for bit with
   ``ring_plain``, within rtol 1e-4 and atol 1e-3 of B1's plane; ms and
   peak bytes); ``e2e_stream`` (after ``e2e_mesh``: the e2e file's
   chunks read and cleaned on the card by a generator through
   ``stream_search``, direct and hybrid at S/N 8, every hit chunk's
   table bit for bit ``search_by_chunks``'; on a (2, 2) mesh; with the
   canary in every chunk; ``skip_failed`` under a persistent dispatch
   error on one chunk; a 2-bit packed chunk against its host unpack);
   ``e2e_beams`` (after ``e2e_overlap``: four beam files of the e2e
   geometry, a DM 400 pulse in beam 1 alone and one in all four beams,
   through ``multibeam_search`` batched and beam by beam after the cold
   ``|b4`` tuning, on 2 chunks (3 blocks: depth cut from 4 chunks):
   tables, ledgers and candidate files bit for bit, B4
   136 launches an arm, 2/2 against 8/8 dispatches and readbacks, the
   sift confirming the first pulse and vetoing the second; an injected
   ``beams`` OOM (``halve_batch``, the same tables); 2-bit copies of 2
   beams on 1 chunk (depth cut from 4 beams and 2 chunks),
   ``packed="device"`` against ``"host"`` byte for byte, the upload
   ratio 16);
13. the live feed and the job service (A10a, A15): ``e2e_ingest`` (after
   ``e2e_observe``: ``PUingest listen --like`` the e2e file and ``PUingest
   feed`` as two processes, float32 frames over TCP at the full width,
   1024 x 2^18 chunks and the 514-trial plan: the delivered chunks the
   file's samples byte for byte, each table the disk stream's bit for bit,
   the pulse found, B1 and B4 launched, ``unaccounted: 0``; then in this
   process a 2-bit file packed on the wire (``PackedFrames`` to the
   device unpack), one ``FaultPlan`` per ``ingest`` kind, a ``feed_gap``
   quarantine, a slow consumer shedding (``shed_overrun``) and one chunk
   over UDP; wall seconds, wire MB/s, packets/s and search seconds of
   each run); ``e2e_service`` (after ``mesh_period``: ``PUmultibeam
   --serve --http-port 0 --device cuda`` as a process driven over HTTP:
   a bad spec's 400, a periodicity job on the pulsar file equal to
   ``e2e_puperiod``'s with B6 launched, two single-pulse jobs on two
   copies of the e2e file co-batched and bit for bit a direct
   ``multibeam_search``, a job cancelled while queued, a job cancelled
   mid-run and resumed from its ledger, ``/healthz``; seconds per job,
   dispatches and readbacks, launches, the per-job counters).  The
   children run the package's CLIs unchanged (:func:`cli_child` wraps
   the drivers to count launches and keep tables);
14. the fleet (A10b): ``e2e_fleet`` (after ``e2e_service``):
   ``fleet_main coordinator`` (no card visible to it) and two
   ``fleet_main worker --device cuda`` processes, each fenced to half
   the card by ``PUTPU_MEM_LIMIT``, over the e2e file, the coordinator
   SIGKILLed after a chunk and relaunched with ``--recover`` on its
   port (ledger and candidates ``e2e_search``'s byte for byte); a worker
   SIGKILLed holding a hybrid lease and the survey finished by an
   in-process card worker (``e2e_hybrid``'s S/N 8 bytes); a partitioned
   zombie's write refused by the epoch fence and its completion stale;
   a periodicity unit on the pulsar file (``e2e_puperiod``'s
   candidates, B6 as often); the survey wall, seconds a unit, round
   trips, recovery seconds, journal records, capacity advice, budgets
   and launches of each run;
15. the kernels line (B6 once per policy; the launches by path include
   the mesh, stream, beam, ingest, service and fleet phases'), then
   ``{"ok": true, "device": {...}}`` last.

Any failed check exits non-zero before the last line.  Without a CUDA
device, or without the package beside this script, it exits non-zero
and prints no result.  ``--quick`` stops after the kernel checks at small
shapes (a first run of a new kernel).  ``--breakdown`` runs only the
build and the breakdowns of the direct sweep, B6 and B3, which call
only the wrappers' entry points (a copy of this script beside another
checkout times that checkout the same way), and the hybrid's.
``--overlap`` runs only the build and ``e2e_overlap``, ``--observe`` the
build, the end-to-end file and ``e2e_observe``, ``--lowbit`` the build
and ``e2e_lowbit`` (with its own pulsar file), ``--autotune`` the build,
the end-to-end and pulsar files and the phases of item 11, ``--mesh``
the build and the phases of item 10 (with the single-device runs they
compare with), ``--beams`` the build, the end-to-end file and the
phases of item 12, ``--service`` the build, the end-to-end and pulsar
files and the phases of item 13 (with ``e2e_period``, which
``e2e_service`` compares with), ``--fleet`` the build, the end-to-end
and pulsar files and ``e2e_period`` and ``e2e_fleet`` (the references of
runs A and B made in the phase).  None of the ten prints the last line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

#: each phase's tune cache lives in a directory under this one (set in
#: :func:`main`, inside the checkout's build directory; removed at the end)
TUNE_ROOT = None

#: dynamic shared memory one block may take on an H100 (227 KB)
SMEM_PER_BLOCK = 232448

#: the headline geometry of the JAX package's benchmark
NCHAN, NSAMPLES = 1024, 1 << 20
START_FREQ, BANDWIDTH, TSAMP = 1200.0, 200.0, 5e-4
DMMIN, DMMAX = 300.0, 635.0

#: the hybrid headline: the JAX package's benchmark grid (bench.py), 512
#: integer band-delay trials from DM 300, a pulse at DM 350
HYB_NTRIALS = 512
HYB_DM = 350.0

#: the scorer's tolerance between the kernel and its plain version: the
#: JAX package's own between its Pallas and XLA scorers
SCORE_RTOL, SCORE_ATOL = 2e-4, 1e-5

#: end-to-end file: 2.5 chunks of 2^18 samples (4 chunks at 50% overlap)
E2E_CHUNK = 1 << 18
E2E_NSAMPLES = 5 * E2E_CHUNK // 2
E2E_DM = 400.0


#: the script's start on the host clock (``elapsed_s`` of every line)
_T0 = time.perf_counter()


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": round(time.perf_counter() - _T0, 1)}),
          flush=True)


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


#: timed runs of a plain version (after its warm-up): the median of 2
#: (the plain sweep at the headline takes 4 s a call; depth cut from 5)
PLAIN_RUNS = 2


def time_ms(torch, fn, runs=5, warm_up=True):
    """Median and all of ``runs`` CUDA-event timings of ``fn`` (ms), after
    one warm-up call unless ``warm_up`` is false."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def _roofline():
    """The port's work models and the card's peaks
    (``pulsarutils_tpu_torch/obs/roofline.py``): the bounds printed here
    and the driver's roofline table count the same work."""
    from pulsarutils_tpu_torch.obs import roofline

    return roofline


def bound_ms(adds, nbytes):
    """Least time on the card: the larger of ``adds`` float32 adds over
    the add rate and ``nbytes`` over the memory rate, in ms, with what
    sets it."""
    return _roofline().bound_ms(adds, nbytes)


def sweep_bound_ms(ndm, nchan, nsamples):
    """Least time for the sweep: its adds, and its bytes (input, offsets
    and plane, each once)."""
    return _roofline().sweep_bound_ms(ndm, nchan, nsamples)


def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("environment", card=card, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         tf32_matmul=False, tf32_cudnn=False)
    return card


def phase_build():
    from pulsarutils_tpu_torch.utils import nvcc

    t0 = time.perf_counter()
    built = nvcc.build(["dedisperse", "fdmt_merge", "score", "fdd",
                        "harmonic"])
    for name, (path, seconds, log) in built.items():
        resources = [line.strip() for line in log.splitlines()
                     if "registers" in line or "spill" in line]
        emit("build", source=f"pulsarutils_tpu_torch/csrc/{name}.cu",
             library=path.name, seconds=round(seconds, 3),
             ptxas=resources)
    emit("build_total", seconds=round(time.perf_counter() - t0, 3))


def _sweep_case(torch, name, data, offsets, *, timed=True,
                superblock=None):
    """Kernel vs plain on one input, in the plan's branch and forced into
    the other (where its window fits a block's shared memory); returns
    the case's record."""
    import dataclasses

    from pulsarutils_tpu_torch.ops import dedisperse_cuda as dc
    from pulsarutils_tpu_torch.ops.dedisperse import dedisperse_plane_plain

    ndm, nchan = offsets.shape
    nsamples = data.shape[1]
    superblock = superblock or ndm
    blocks = [offsets[lo:lo + superblock]
              for lo in range(0, ndm, superblock)]
    plans = [dc.launch_plan(b, nsamples) for b in blocks]
    metas = [torch.from_numpy(p.meta).to(data.device) for p in plans]

    def kernel(plans=plans):
        return [dc.dedisperse_plane_cuda(data, m, p)
                for m, p in zip(metas, plans)]

    def wrapper():
        return [dc.dedisperse_plane(data, b) for b in blocks]

    def plain():
        return [dedisperse_plane_plain(data, b) for b in blocks]

    got = torch.cat(wrapper())
    want = torch.cat(plain())
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite plane")
    check(diff == 0.0, f"{name}: kernel differs from plain by {diff}")
    check(torch.equal(torch.cat(kernel()), want),
          f"{name}: kernel launch differs from the wrapper's")
    branches = {"smem" if p.use_smem else "global" for p in plans}
    for use_smem in (True, False):
        other = [dataclasses.replace(p, use_smem=use_smem) for p in plans]
        if (use_smem and any(o.smem_bytes > SMEM_PER_BLOCK for o in other)
                or other == plans):
            continue
        check(torch.equal(torch.cat(kernel(other)), want),
              f"{name}: the {'smem' if use_smem else 'global'} branch "
              "differs from plain")
        branches.add("smem" if use_smem else "global")
    bound, bound_by = sweep_bound_ms(ndm, nchan, nsamples)
    record = {"case": name, "ndm": ndm, "nchan": nchan,
              "nsamples": nsamples, "launches_per_call": len(blocks),
              "trial_blocks": [p.trial_block for p in plans],
              "use_smem": [p.use_smem for p in plans],
              "branches_checked": sorted(branches),
              "spread": max(p.spread for p in plans),
              "smem_bytes": [p.smem_bytes for p in plans],
              "distinct_share": sum(p.distinct_share * p.offsets.shape[0]
                                    for p in plans) / ndm,
              "max_abs_diff": diff, "tolerance": "max_abs_diff == 0",
              "bound_ms": bound, "bound_by": bound_by}
    if timed:
        record["kernel_ms"], record["kernel_runs_ms"] = time_ms(torch, kernel)
        record["plain_ms"], record["plain_runs_ms"] = time_ms(
            torch, plain, runs=PLAIN_RUNS,
            warm_up=False)
        record["bound_share"] = bound / record["kernel_ms"]
    del got, want
    torch.cuda.empty_cache()
    emit("kernel_check", kernel="B1 sweep", **record)
    return record


def phase_kernels(torch, np, seed, quick):
    from pulsarutils_tpu_torch.ops.dedisperse_cuda import (
        TRIAL_BLOCKS, choose_trial_block, launch_plan)
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan, offsets_for
    from pulsarutils_tpu_torch.ops.search import SUPERBLOCK

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def data(nchan, nsamples):
        return torch.from_numpy(rng.standard_normal(
            (nchan, nsamples), dtype=np.float32)).to(dev)

    def plan_offsets(nchan, nsamples, dmmin=DMMIN, dmmax=DMMAX,
                     f0=START_FREQ, bw=BANDWIDTH, tsamp=TSAMP):
        dms = dedispersion_plan(nchan, dmmin, dmmax, f0, bw, tsamp)
        return offsets_for(dms, nchan, f0, bw, tsamp, nsamples)

    timed = not quick
    records = []
    # edge cases first: small, and each exercises one boundary
    # 110-170 MHz: the band-crossing delay is ~half of a 4096-sample chunk
    low = plan_offsets(256, 4096, 5.0, 10.0, 110.0, 60.0, 1e-3)[-96:]
    cases = [
        ("t_not_tile_multiple", 256, 300007, plan_offsets(256, 300007)),
        ("one_trial", 256, 1 << 16, plan_offsets(256, 1 << 16)[:1]),
        ("nchan_not_chan_block_multiple", 1000, 1 << 16,
         plan_offsets(1000, 1 << 16)[:70]),
        ("large_max_off_smem", 256, 4096, low),
        ("large_spread_global_branch", 256, 1 << 16,
         rng.integers(0, 1 << 16, (96, 256)).astype(np.int32)),
        # the hybrid's rescore: plan rows in any order, repeated, padded
        # by repeating the last row up to the bucket
        ("rescore_rows_any_order", 1024, 1 << 16,
         plan_offsets(1024, 1 << 16)[[301, 17, 480, 17, 99, 100, 5, 5, 5,
                                      5, 5, 5, 5, 5, 5, 5]]),
        # the hybrid's largest rescore bucket: 32 rows in any order with
        # repeats (two 16-trial blocks)
        ("rescore_bucket_32_any_order", 1024, 1 << 16,
         plan_offsets(1024, 1 << 16)[rng.permutation(
             np.r_[rng.integers(0, 514, 24), [7] * 8])]),
        # a launch of 33-64 trials: three 16-trial blocks, the last partial
        ("trials_40", 256, 1 << 16, plan_offsets(256, 1 << 16)[100:140]),
    ]
    for name, nchan, nsamples, off in cases:
        plan = launch_plan(off, nsamples)
        if name == "large_spread_global_branch":
            check(not plan.use_smem, f"{name}: took the smem branch")
        if name == "large_max_off_smem":
            check(plan.use_smem and plan.offsets.max() > nsamples // 4,
                  f"{name}: max offset {plan.offsets.max()} / smem "
                  f"{plan.use_smem}")
        rec = _sweep_case(torch, name, data(nchan, nsamples), off,
                          timed=timed)
        check(rec["trial_blocks"] == [choose_trial_block(off.shape[0])],
              f"{name}: trial blocks {rec['trial_blocks']}")
        records.append(rec)
    if quick:
        return None, records, None
    head_data = data(NCHAN, NSAMPLES)
    head_off = plan_offsets(NCHAN, NSAMPLES)
    head = _sweep_case(torch, "headline", head_data, head_off,
                       superblock=SUPERBLOCK)
    check(head["ndm"] == 514 and head["launches_per_call"] == 2,
          f"headline plan: {head['ndm']} trials, "
          f"{head['launches_per_call']} launches")
    check(head["trial_blocks"] == [TRIAL_BLOCKS[-1], TRIAL_BLOCKS[0]],
          f"headline trial blocks {head['trial_blocks']}")
    # one launch each at the hybrid's rescore buckets and the plan's tail
    head["buckets"] = {}
    for label, rows in (("bucket_8", head_off[200:208]),
                        ("bucket_16", head_off[200:216]),
                        ("tail_2", head_off[SUPERBLOCK:])):
        rec = _sweep_case(torch, label, head_data, rows)
        check(rec["trial_blocks"] == [max(8, rows.shape[0])],
              f"{label}: trial blocks {rec['trial_blocks']}")
        head["buckets"][label] = rec
    torch.cuda.empty_cache()
    return head, records, head_data


def _fdmt_case(torch, name, data, max_delay, min_delay, *, f0=START_FREQ,
               bw=BANDWIDTH, timed=True):
    """The transform pass by pass: each pass's kernel (through its
    wrapper, and launched alone for timing) against its plain version on
    the same input state, and the fused head also against the per-level
    kernel over its levels; returns the per-pass records and the plane."""
    from pulsarutils_tpu_torch.ops import fdmt_cuda as fc
    from pulsarutils_tpu_torch.ops.fdmt import (fdmt_plan, fdmt_transform,
                                                head_plain, merge4_plain,
                                                merge_plain,
                                                transform_schedule)

    nchan, nsamples = data.shape
    plan = fdmt_plan(nchan, float(f0), float(bw), int(max_delay),
                     int(min_delay))
    state = data
    records = []
    for level, (kind, step) in enumerate(transform_schedule(plan)):
        rows_in = state.shape[0]
        extra = {}
        if kind == "head":
            np_table, offsets = fc.head_table(step)
            params = fc.head_params(step, offsets, nsamples, rows_in)
            table = torch.from_numpy(np_table)
            rows_out = step.rows_out

            def wrapper(state=state, step=step):
                return fc.head(state, step)

            def kernel(state=state, table=table.to(state.device),
                       params=params, rows_out=rows_out):
                return fc.head_cuda(state, table, params, rows_out)

            def plain(state=state, step=step):
                return head_plain(state, step)

            def per_level(state=state, step=step):
                for it in step.iterations:
                    state = fc.merge(state, it)
                return state
            adds = nsamples * int(step.counts.sum(axis=1).sum())
            max_shift = max(step.max_shift)
            max_shift_high = int(max(t[2].max() for t in step.tables[0]))
            extra = {"levels": len(step.iterations), "tile": params[4],
                     "tiles_per_group": params[3], "groups": step.n_groups,
                     "halo": step.halo, "buffer_rows": list(step.buf_rows),
                     "smem_bytes_per_block": step.smem_bytes(params[4]),
                     "remote_levels": [lev for lev, r in
                                       enumerate(step.remote) if r],
                     "cluster_barriers": bin(step.barriers).count("1") + 1,
                     "blocks_without_rows": int(
                         (step.block_counts == 0).sum())}
        elif kind == "merge":
            table = torch.from_numpy(fc.merge_table(step, nsamples))
            rows_out = table.shape[1]

            def wrapper(state=state, step=step):
                return fc.merge(state, step)

            def kernel(state=state, table=table.to(state.device)):
                return fc.merge_cuda(state, table)

            def plain(state=state, step=step):
                return merge_plain(state, step["idx_low"], step["idx_high"],
                                   step["shift"], step["shift_high"])
            adds = rows_out * nsamples
            max_shift = int(table[2:].max())
            max_shift_high = int(table[2].max())
        else:
            table = torch.from_numpy(fc.merge4_table(*step, nsamples))
            rows_out = table.shape[1]

            def wrapper(state=state, step=step):
                return fc.merge4(state, *step)

            def kernel(state=state, table=table.to(state.device)):
                return fc.merge4_cuda(state, table)

            def plain(state=state, step=step):
                return merge4_plain(state, *step)
            adds = 3 * rows_out * nsamples
            max_shift = int(table[4:].max())
            max_shift_high = 0
        label = {"head": "B3 head", "merge": "B2a merge",
                 "merge4": "B2b merge4"}[kind]
        got = wrapper()
        want = plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name} pass {level}: "
              "non-finite state")
        diff = float((got - want).abs().max())
        check(diff == 0.0, f"{name} pass {level} ({kind}): kernel differs "
              f"from plain by {diff}")
        del want
        if kind == "head":
            chain = per_level()
            torch.cuda.synchronize()
            extra["per_level_b2a_max_abs_diff"] = float(
                (got - chain).abs().max())
            check(torch.equal(got, chain), f"{name}: the head differs from "
                  "the per-level kernel over its levels")
            del chain
        bound, bound_by = bound_ms(*_roofline().fdmt_pass_work(
            adds // nsamples, nsamples, rows_in, rows_out, table.numel()))
        record = {"case": name, "level": level, "kernel": label,
                  "nchan": nchan, "nsamples": nsamples,
                  "rows_in": rows_in, "rows_out": rows_out,
                  "leaf": kind == "merge" and step["shift_high"] is not None,
                  "max_shift": max_shift, "max_shift_high": max_shift_high,
                  "max_abs_diff": diff,
                  "tolerance": "max_abs_diff == 0", "bound_ms": bound,
                  "bound_by": bound_by, **extra}
        if timed:
            record["kernel_ms"], record["kernel_runs_ms"] = time_ms(torch,
                                                                    kernel)
            record["wrapper_ms"], _ = time_ms(torch, wrapper)
            record["plain_ms"], record["plain_runs_ms"] = time_ms(
                torch, plain, runs=PLAIN_RUNS,
                warm_up=False)
            record["bound_share"] = bound / record["kernel_ms"]
            if kind == "head":
                record["per_level_b2a_ms"], _ = time_ms(torch, per_level)
        emit("kernel_check", **record)
        records.append(record)
        state = got
    whole = fdmt_transform(data, max_delay, f0, bw, min_delay=min_delay)
    check(torch.equal(whole, state), f"{name}: fdmt_transform differs from "
          "the pass-by-pass chain")
    check(state.shape == (max_delay - min_delay + 1, nsamples),
          f"{name}: plane shape {tuple(state.shape)}")
    del whole
    return records, state


def phase_fdmt(torch, np, seed, quick, head_data):
    """B3, B2a and B2b on edge cases, then through the headline
    transform."""
    from pulsarutils_tpu_torch.ops.fdmt import fdmt_trial_dms
    from pulsarutils_tpu_torch.ops.plan import dmmax_for_trials

    rng = np.random.default_rng(seed + 1)
    dev = torch.device("cuda")

    def data(nchan, nsamples):
        return torch.from_numpy(rng.standard_normal(
            (nchan, nsamples), dtype=np.float32)).to(dev)

    def rows(nchan, dmmin, dmmax, f0=START_FREQ, bw=BANDWIDTH, tsamp=TSAMP):
        _, n_lo, n_hi = fdmt_trial_dms(nchan, dmmin, dmmax, f0, bw, tsamp)
        return n_hi, n_lo

    timed = not quick
    records = []
    head_first = ["B3 head", "B2a merge", "B2b merge4"]
    cases = [
        # nchan not a power of two: zero channels above the band
        ("nchan_1000_padded", data(1000, 1 << 16),
         rows(1000, DMMIN, DMMAX), {}, head_first),
        # no power-of-two tile divides T, through the head and per level
        ("t_300007", data(1024, 300007), rows(1024, DMMIN, DMMAX), {},
         head_first),
        ("t_300007_per_level", data(256, 300007), rows(256, DMMIN, DMMAX),
         {}, ["B2a merge"] * 6 + ["B2b merge4"]),
        # T shorter than the head's window: it wraps T twice
        ("t_150", data(1024, 150), rows(1024, DMMIN, DMMAX), {},
         head_first),
        # a group of zero channels only, blocks that own no row of the
        # wide sub-bands' levels, a partial last tile
        ("zero_group_384", data(384, 65521), (300, 250), {}, None),
        # a wide range: a block owns no row of the last head level
        ("wide_range_1000", data(1000, 1 << 15), (400, 0), {}, None),
        # a narrow pruned range: min_delay > 0, few rows per level
        ("pruned_narrow", data(256, 1 << 16), rows(256, 500.0, 505.0), {},
         None),
        # 110-170 MHz: band delays up to ~2000 samples in a 1536-sample
        # chunk, so the host reduces shifts mod T
        ("shifts_beyond_t", data(64, 1536),
         rows(64, 5.0, 10.0, 110.0, 60.0, 1e-3),
         {"f0": 110.0, "bw": 60.0}, ["B2a merge"] * 4 + ["B2b merge4"]),
    ]
    for name, x, (n_hi, n_lo), geom, kinds in cases:
        recs, plane = _fdmt_case(torch, name, x, n_hi, n_lo, timed=timed,
                                 **geom)
        got = [r["kernel"] for r in recs]
        check(kinds is None or got == kinds, f"{name}: schedule {got}")
        records += recs
        del x, plane
    # the leaf form of B2a samples both parents with shifts of their own
    check(any(r["leaf"] and r["max_shift_high"] > 0 for r in records),
          "no leaf pass with a high-parent shift")
    check(any(r["case"] == "pruned_narrow" and r["level"] == 0 for r in
              records), "pruned case missing")
    if quick:
        torch.cuda.empty_cache()
        return None, records, None
    dmmax = dmmax_for_trials(DMMIN, HYB_NTRIALS, START_FREQ, BANDWIDTH,
                             TSAMP)
    n_hi, n_lo = rows(NCHAN, DMMIN, dmmax)
    head, plane = _fdmt_case(torch, "headline", head_data, n_hi, n_lo)
    check(n_hi - n_lo + 1 == HYB_NTRIALS
          and [r["kernel"] for r in head] == head_first
          and head[0]["max_shift_high"] > 0,
          f"headline transform: rows {n_lo}..{n_hi}, passes "
          f"{[r['kernel'] for r in head]}")
    # the end-to-end hybrid's chunk, made on the card
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    chunk = torch.randn((NCHAN, E2E_CHUNK), generator=gen, device="cuda")
    e2e, e2e_plane = _fdmt_case(torch, "e2e_hybrid_chunk", chunk,
                                *rows(NCHAN, DMMIN, DMMAX))
    check([r["kernel"] for r in e2e] == head_first,
          f"e2e hybrid chunk: passes {[r['kernel'] for r in e2e]}")
    del chunk, e2e_plane
    torch.cuda.empty_cache()
    return head, records + e2e, plane


def _score_case(torch, np, name, plane, *, with_cert=True, timed=True):
    """B4 against its plain version on one plane."""
    from pulsarutils_tpu_torch.ops.score_cuda import (score_plane,
                                                      score_plane_cuda)
    from pulsarutils_tpu_torch.ops.search import score_profiles_chunked

    rows, nsamples = plane.shape
    got = score_plane(plane, with_cert=with_cert).cpu().numpy()
    want = score_profiles_chunked(plane, with_cert=with_cert).cpu().numpy()
    check(np.isfinite(got).all(), f"{name}: non-finite scores")
    check(np.array_equal(got[3], want[3]), f"{name}: windows differ in "
          f"{int((got[3] != want[3]).sum())} rows")
    check(np.array_equal(got[4], want[4]), f"{name}: peaks differ in "
          f"{int((got[4] != want[4]).sum())} rows")
    floats = [0, 1, 2] + ([5] if with_cert else [])
    err = float(max(np.abs(got[k] - want[k]).max() for k in floats))
    used = {name: float((np.abs(got[k] - want[k])
                         / (SCORE_ATOL + SCORE_RTOL * np.abs(want[k]))).max())
            for k, name in zip(floats, ("max", "std", "snr", "cert"))}
    rel = max(used.values())
    check(rel <= 1.0, f"{name}: scores outside rtol {SCORE_RTOL} / atol "
          f"{SCORE_ATOL} (share of the tolerance used: {used})")
    bound, bound_by = bound_ms(*_roofline().score_work(rows, nsamples,
                                                       got.size))
    record = {"case": name, "rows": rows, "nsamples": nsamples,
              "with_cert": with_cert, "max_abs_diff": err,
              "tolerance_used": used, "windows_equal": True,
              "peaks_equal": True,
              "tolerance": f"rtol {SCORE_RTOL}, atol {SCORE_ATOL}",
              "bound_ms": bound, "bound_by": bound_by}
    if timed:
        def kernel():
            return score_plane_cuda(plane, with_cert=with_cert)

        def plain():
            return score_profiles_chunked(plane, with_cert=with_cert)
        record["kernel_ms"], record["kernel_runs_ms"] = time_ms(torch, kernel)
        record["plain_ms"], record["plain_runs_ms"] = time_ms(
            torch, plain, runs=PLAIN_RUNS)
        record["bound_share"] = bound / record["kernel_ms"]
    emit("kernel_check", kernel="B4 score", **record)
    return record


def phase_score(torch, np, seed, quick, coarse_plane):
    """B4 on edge cases, then on the headline coarse plane."""
    rng = np.random.default_rng(seed + 2)
    dev = torch.device("cuda")

    def plane(rows, nsamples, dc=0.0):
        x = rng.standard_normal((rows, nsamples), dtype=np.float32)
        x += np.float32(dc)
        x[rows // 3, nsamples // 3:nsamples // 3 + 4] += 9.0  # width 4
        x[rows // 2, nsamples - 2] += 12.0  # cert window wraps the end
        return torch.from_numpy(x).to(dev)

    timed = not quick
    records = [
        _score_case(torch, np, "odd_T", plane(97, 300007), timed=timed),
        _score_case(torch, np, "rows_not_multiple_of_8", plane(13, 1 << 16),
                    timed=timed),
        _score_case(torch, np, "rows_13_no_cert", plane(13, 1 << 16),
                    with_cert=False, timed=timed),
        _score_case(torch, np, "dc_offset_1e4", plane(64, 1 << 16, 1e4),
                    timed=timed),
        # a ragged last group of 3 samples and two width-8 blocks
        _score_case(torch, np, "short_T_19", plane(5, 19), timed=False),
    ]
    head = None
    if coarse_plane is not None:
        head = _score_case(torch, np, "headline_coarse_plane", coarse_plane)
    torch.cuda.empty_cache()
    return head, records


#: B5: the kernel against its plain version, relative to the largest
#: output (the two sum channels in different orders); the FDD path
#: against the float64 oracle at the JAX package's test tolerance, on
#: unit-normal data
FDD_REL_TOL = 1e-4
FDD_ORACLE_ATOL = 2e-3

#: B6 and its chain: scores within the JAX package's harmonic_packs_match
#: rtol; peak bins, depths and frequency bins exact
HARMONIC_RTOL = 1e-5


#: B5's in-kernel phasor build per (channel, bin), counted from
#: csrc/fdd.cu: two limb phasors (3 and 4 limbs: the integer products,
#: masks, conversions and the float32 sum, 14 and 18 instructions; th *
#: 2 pi; sincosf's reduction, two polynomials and quadrant selects, ~24
#: each) and the complex product spec * rot0 (4)
FDD_PHASOR_OPS = 14 + 18 + 2 * (1 + 24) + 4


def _fdd_kernel_case(torch, name, spec, anchor, step, superblock,
                     chan_block, *, timed=True):
    """B5 against its plain version on one superblock: the kernel builds
    the phasors from the limbs itself, in one launch over every
    channel."""
    from pulsarutils_tpu_torch.ops import fourier_cuda as fc

    nchan, nbin = spec.shape

    def kernel():
        return fc.fdd_superblock_spectra_cuda(spec, anchor, step, superblock)

    def plain():
        return fc.fdd_fused_plain(spec, anchor, step, superblock,
                                  chan_block=chan_block)

    before = fc.launches
    got = fc.fdd_superblock_spectra(spec, anchor, step, superblock,
                                    chan_block=chan_block)
    launched = fc.launches - before
    want = plain()
    torch.cuda.synchronize()
    check(launched == 1, f"{name}: {launched} launches for one superblock")
    check(bool(torch.isfinite(torch.view_as_real(got)).all()),
          f"{name}: non-finite spectra")
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    rel = diff / max(scale, 1e-30)
    check(rel <= FDD_REL_TOL, f"{name}: kernel differs from plain by "
          f"{diff} ({rel:.3g} of the largest output, tolerance "
          f"{FDD_REL_TOL})")
    # the recurrence alone, and with the phasor build's instructions
    bound, bound_by = bound_ms(*_roofline().fdd_work(nchan, nbin,
                                                     superblock))
    bound_ph, bound_ph_by = bound_ms(*_roofline().fdd_work(
        nchan, nbin, superblock, FDD_PHASOR_OPS))
    record = {"case": name, "nchan": nchan, "nbin": nbin,
              "superblock": superblock, "chan_block_plain": chan_block,
              "launches_per_call": launched, "max_abs_diff": diff,
              "max_abs_plain": scale, "rel_diff": rel,
              "tolerance": f"max_abs_diff <= {FDD_REL_TOL} x max|plain|",
              "bound_ms": bound, "bound_by": bound_by,
              "bound_with_phasors_ms": bound_ph,
              "bound_with_phasors_by": bound_ph_by,
              "phasor_ops_per_channel_bin": FDD_PHASOR_OPS}
    if timed:
        record["kernel_ms"], record["kernel_runs_ms"] = time_ms(torch, kernel)
        record["plain_ms"], record["plain_runs_ms"] = time_ms(
            torch, plain, runs=PLAIN_RUNS,
            warm_up=False)
        record["bound_share"] = bound / record["kernel_ms"]
        record["bound_with_phasors_share"] = bound_ph / record["kernel_ms"]
    del got, want
    emit("kernel_check", kernel="B5 fdd", **record)
    return record


def _timed_launches(torch, module, name):
    """Wrap ``module.name`` so every call is timed with CUDA events;
    returns the list of (start, end) events and an undo function."""
    real = getattr(module, name)
    spans = []

    def wrapped(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    setattr(module, name, wrapped)
    return spans, lambda: setattr(module, name, real)


def phase_fdd(torch, np, seed, quick):
    """B5: the FDD path on edge cases against the float64 oracle, the
    kernel against plain on one headline superblock, then the full
    headline sweep through ``dedispersion_search(kernel="fourier")``."""
    from pulsarutils_tpu_torch.ops import fourier as fo
    from pulsarutils_tpu_torch.ops import fourier_cuda as fc
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan
    from pulsarutils_tpu_torch.ops.search import dedispersion_search

    rng = np.random.default_rng(seed + 3)
    geom = (START_FREQ, BANDWIDTH, TSAMP)
    jagged = np.linspace(300.0, 400.0, 12)
    jagged[5] += 3.0
    cases = [
        # (name, nchan, T, trial DMs, dm_block)
        ("nchan_200_not_chan_block_multiple", 200, 4096,
         np.linspace(300.0, 400.0, 40), None),
        ("odd_T_4095", 64, 4095, np.linspace(300.0, 350.0, 20), None),
        ("one_trial", 64, 4096, np.array([350.0]), None),
        ("superblock_gt_ndm", 64, 4096, np.linspace(300.0, 320.0, 10), 64),
        ("trial_block_tails", 96, 4096, np.linspace(300.0, 400.0, 70), 48),
        ("non_uniform_fallback", 64, 4096, jagged, None),
    ]
    records = []
    for name, nchan, t, dms, dm_block in cases:
        data = rng.standard_normal((nchan, t)).astype(np.float32)
        ref = fo._dedisperse_fourier_numpy(
            data, fo.fractional_delays(dms, nchan, START_FREQ, BANDWIDTH),
            TSAMP)
        fc.launches = 0
        got = fo.dedisperse_fourier(data, dms, *geom, dm_block=dm_block,
                                    device="cuda")
        torch.cuda.synchronize()
        launched = fc.launches
        cpu = fo.dedisperse_fourier(data, dms, *geom, dm_block=dm_block,
                                    device="cpu").numpy()
        got = got.cpu().numpy()
        diff = float(np.abs(got - ref).max())
        check(got.shape == ref.shape and np.isfinite(got).all(),
              f"{name}: plane {got.shape}")
        check(diff <= FDD_ORACLE_ATOL, f"{name}: FDD differs from the "
              f"float64 oracle by {diff} (atol {FDD_ORACLE_ATOL})")
        uniform = fo._uniform_spacing(dms) is not None
        check((launched > 0) == uniform, f"{name}: {launched} B5 launches "
              f"on a {'uniform' if uniform else 'non-uniform'} grid")
        record = {"case": name, "nchan": nchan, "nsamples": t,
                  "ndm": len(dms), "dm_block": dm_block,
                  "uniform_grid": uniform, "launches": launched,
                  "oracle_max_abs_diff": diff,
                  "cpu_path_max_abs_diff": float(np.abs(got - cpu).max()),
                  "tolerance": f"oracle atol {FDD_ORACLE_ATOL}"}
        emit("fdd_check", **record)
        records.append(record)
    # the kernel alone on small odd shapes: random spectra and limbs
    for name, nchan, nbin, nsb in (("kernel_nchan_5_nbin_300", 5, 300, 16),
                                   ("kernel_superblock_70", 37, 1025, 70),
                                   ("kernel_nchan_300", 300, 777, 64)):
        spec = torch.from_numpy((rng.standard_normal((nchan, nbin))
                                 + 1j * rng.standard_normal((nchan, nbin)))
                                .astype(np.complex64)).cuda()
        anchor = torch.from_numpy(rng.integers(0, 1 << 12, (3, nchan))
                                  .astype(np.int32)).cuda()
        step = torch.from_numpy(rng.integers(0, 1 << 12, (4, nchan))
                                .astype(np.int32)).cuda()
        records.append(_fdd_kernel_case(torch, name, spec, anchor, step,
                                        nsb, 16, timed=False))
    if quick:
        torch.cuda.empty_cache()
        return None, records
    # the headline: one 64-trial superblock of the DM 300-635 plan
    data = torch.from_numpy(rng.standard_normal(
        (NCHAN, NSAMPLES), dtype=np.float32)).cuda()
    dms = dedispersion_plan(NCHAN, DMMIN, DMMAX, *geom)
    superblock, chan_block = fo.FOURIER_SUPERBLOCK, fo.FOURIER_CHAN_BLOCK
    anchors, steps, ndm = fo._uniform_fourier_inputs(
        dms, fo._uniform_spacing(dms), NCHAN, START_FREQ, BANDWIDTH, TSAMP,
        NSAMPLES, superblock)
    spec = fo._blocked_rfft(data, chan_block)
    anchor0 = torch.from_numpy(np.ascontiguousarray(anchors[:, 0])).cuda()
    step_limbs = torch.from_numpy(np.ascontiguousarray(steps)).cuda()
    head = _fdd_kernel_case(torch, "headline_superblock", spec, anchor0,
                            step_limbs, superblock, chan_block)
    del spec
    torch.cuda.empty_cache()

    # the full sweep, kernel launches timed apart
    args = (DMMIN, DMMAX, *geom)

    def sweep():
        return dedispersion_search(data, *args, kernel="fourier",
                                   device="cuda")

    sweep()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        reset_counts()
        spans, undo = _timed_launches(torch, fc,
                                      "fdd_superblock_spectra_cuda")
        try:
            t0 = time.perf_counter()
            table = sweep()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        finally:
            undo()
        kernel_ms = sum(s.elapsed_time(e) for s, e in spans)
        counts = read_counts()
    nsuper = -(-ndm // superblock)
    check(table.nrows == ndm and np.isfinite(table["snr"]).all(),
          f"fourier sweep table {table.nrows} rows")
    check(counts["B5"] == nsuper and counts["B4"] == nsuper,
          f"fourier sweep launches {counts}: one B5 and one B4 launch a "
          f"superblock expected ({nsuper})")
    nbin = NSAMPLES // 2 + 1
    sweep_bytes = (8 * NCHAN * nbin + 28 * NCHAN) * nsuper + 8 * ndm * nbin
    sweep_bound, sweep_by = bound_ms(6 * ndm * NCHAN * nbin, sweep_bytes)
    sweep_bound_ph, _ = bound_ms(
        (6 * ndm + FDD_PHASOR_OPS * nsuper) * NCHAN * nbin, sweep_bytes)
    full = {"ndm": ndm, "superblocks": nsuper, "launches": counts,
            "kernel_ms": kernel_ms, "sweep_ms": statistics.median(walls),
            "sweep_runs_ms": walls, "kernel_bound_ms": sweep_bound,
            "kernel_bound_by": sweep_by,
            "kernel_bound_with_phasors_ms": sweep_bound_ph,
            "dm_trials_per_s": ndm / (statistics.median(walls) / 1e3)}
    emit("fdd_sweep", nchan=NCHAN, nsamples=NSAMPLES, dm_range=[DMMIN, DMMAX],
         **full)
    del data
    torch.cuda.empty_cache()
    return {**head, "sweep": full}, records


#: B6's precision policies (the Pallas kernel's ``policy`` branches)
B6_POLICIES = ("f32", "f32_compensated", "split_f32",
               "bf16_operand_f32_accum")

def b6_bound_ms(rows, nbins, depths, policy):
    """B6's bound under ``policy``: one read of the power rows and the
    peaks written, against the stack's operations (its harmonic adds, the
    TwoSum's and the depths' ``acc + comp`` under compensation, the bf16
    roundings)."""
    return _roofline().b6_bound_ms(rows, nbins, depths, policy)


def _harmonic_case(torch, np, name, power, nsamples, *, max_harmonics=16,
                   fmin=None, fmax=None, timed=False, policy="f32"):
    """B6 under ``policy`` against its plain version on raw spectra
    ``power``, through the wrapper's branch and every branch that holds
    the rows, then the whole chain against the plain chain."""
    from pulsarutils_tpu_torch.ops import harmonic_cuda as hc
    from pulsarutils_tpu_torch.ops.periodicity import (
        band_edges, harmonic_depths, harmonic_peaks_plain, normalize_power,
        score_normalized_power)

    rows, nbins = power.shape
    lo, hi = band_edges(nbins, nsamples, TSAMP, fmin, fmax)
    depths = harmonic_depths(max_harmonics)
    vals, bins = hc.harmonic_peaks(power, depths, lo, hi, policy=policy)
    pvals, pbins = harmonic_peaks_plain(normalize_power(power), depths, lo,
                                        hi, policy=policy)
    torch.cuda.synchronize()
    name = f"{name}[{policy}]"
    check(torch.equal(bins, pbins), f"{name}: peak bins differ in "
          f"{int((bins != pbins).sum())} of {bins.numel()} cells")
    val_diff = float((vals - pvals).abs().max())
    check(bool(torch.isfinite(vals).all()) and val_diff == 0.0,
          f"{name}: peak values differ from plain by {val_diff}")
    # every branch that holds the row, each bit for bit
    auto = hc.choose_cluster(nbins, rows, torch.cuda.get_device_properties(
        0).multi_processor_count)
    branches = [1] + [c for c in hc.CLUSTER_SIZES
                      if hc.cluster_fits(nbins, c)]
    branch_ms = {}
    for cluster in branches:
        def branch(cluster=cluster):
            return hc.harmonic_peaks_cuda(power, depths, lo, hi,
                                          cluster=cluster, policy=policy)
        bv, bb = branch()
        torch.cuda.synchronize()
        check(torch.equal(bb, pbins) and torch.equal(bv, pvals),
              f"{name}: the {cluster}-block branch differs from plain "
              f"(bins in {int((bb != pbins).sum())} cells, values by "
              f"{float((bv - pvals).abs().max())})")
        if timed:
            branch_ms[cluster], _ = time_ms(torch, branch)
    got = hc.score_power(power, nsamples, TSAMP, max_harmonics=max_harmonics,
                         fmin=fmin, fmax=fmax, policy=policy)
    want = score_normalized_power(normalize_power(power), nsamples, TSAMP,
                                  max_harmonics=max_harmonics, fmin=fmin,
                                  fmax=fmax, policy=policy)
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.cpu().numpy() for k, v in want.items()}
    scale = nsamples * TSAMP
    check(np.array_equal(got["nharm"], want["nharm"])
          and np.array_equal(np.rint(got["freq"] * scale),
                             np.rint(want["freq"] * scale)),
          f"{name}: depth or frequency bin differs")
    for col in ("power", "log_sf", "sigma"):
        check(np.allclose(got[col], want[col], rtol=HARMONIC_RTOL,
                          atol=1e-6), f"{name}: {col} outside rtol "
              f"{HARMONIC_RTOL}")
    bound, bound_by = b6_bound_ms(rows, nbins, depths, policy)
    record = {"case": name, "policy": policy, "rows": rows, "nbins": nbins,
              "nsamples": nsamples, "depths": list(depths), "band": [lo, hi],
              "peak_bins_equal": True, "max_abs_diff": val_diff,
              "cluster": auto, "branches_equal": branches,
              "tolerance": "peak bins and values equal; chain rtol "
                           f"{HARMONIC_RTOL}",
              "bound_ms": bound, "bound_by": bound_by}
    if timed:
        def kernel():
            return hc.harmonic_peaks_cuda(power, depths, lo, hi,
                                          policy=policy)

        def plain():
            return harmonic_peaks_plain(normalize_power(power), depths, lo,
                                        hi, policy=policy)
        record["kernel_ms"], record["kernel_runs_ms"] = time_ms(torch, kernel)
        record["branch_ms"] = branch_ms
        # the wrapper's choice against the fastest branch in this run
        record["auto_fastest"] = branch_ms[auto] <= min(branch_ms.values())
        record["plain_ms"], record["plain_runs_ms"] = time_ms(
            torch, plain, runs=PLAIN_RUNS)
        record["bound_share"] = bound / record["kernel_ms"]
    emit("kernel_check", kernel="B6 harmonic", **record)
    return record


def _device_power(torch, gen, rows, t):
    """Raw power spectra of ``rows`` white-noise series of ``t`` samples,
    made on the card from ``gen`` (the rFFT in slabs of 64 rows)."""
    from pulsarutils_tpu_torch.ops.periodicity import power_spectrum

    power = torch.empty((rows, t // 2 + 1), device="cuda")
    for lo in range(0, rows, 64):
        hi = min(rows, lo + 64)
        power[lo:hi] = power_spectrum(torch.randn(
            (hi - lo, t), generator=gen, device="cuda"))
    return power


#: the shapes B6 runs at on its main paths: (rows, samples a series):
#: ``period_search``'s 512-row launch and its 2-row tail a chunk, the
#: ``spectral_search`` of a single-pulse chunk's 514-trial plane
#: (``e2e_precision``), and a ``PUperiod`` acceleration trial
HARMONIC_MAIN_SHAPES = {"period_search_512": (512, E2E_CHUNK),
                        "period_search_tail_2": (2, E2E_CHUNK),
                        "spectral_search_514": (514, E2E_CHUNK),
                        "puperiod_514": (514, E2E_NSAMPLES)}


def phase_harmonic(torch, np, seed, quick):
    """B6 under every policy on edge cases, then at the main paths' shapes
    and on the power of a 512 x 2^20 plane; returns, by policy, the
    headline record, the edge cases' and the main shapes' (by label)."""
    from pulsarutils_tpu_torch.ops.periodicity import power_spectrum

    rng = np.random.default_rng(seed + 4)

    def power_of(rows, t, zero_row=None, zero_tail=None):
        x = rng.standard_normal((rows, t)).astype(np.float32)
        tt = np.arange(t) * TSAMP
        f0 = (t // 20) / (t * TSAMP)
        x[rows // 3] += 1.5 * np.square(np.sin(np.pi * f0 * tt))  # tone row
        x[rows // 2] += 0.4 * np.sin(2 * np.pi * f0 * tt)
        p = power_spectrum(torch.from_numpy(x).cuda())
        if zero_row is not None:
            p[zero_row] = 0.0
        if zero_tail is not None:
            p[zero_tail, p.shape[1] // 2:] = 0.0  # many equal values
        return p

    from pulsarutils_tpu_torch.ops import harmonic_cuda as hc

    def straddling(rows, t):
        # zero tails from 5 bins before the start of a chunk of 32 bins,
        # a different chunk a row, over the chunks of every block
        p = power_of(rows, t)
        for r in range(rows):
            p[r, 32 * (37 * r + 101) - 5:] = 0.0
        return p

    def middles_apart(t):
        # an even-length median whose two middle values lie in block 0's
        # first chunk and in a chunk of the last block (bin nbins - 2, in
        # chunk 2^k - 1), and one whose lower middle value ends a run
        nbins = t // 2 + 1
        half = nbins // 2
        p = np.zeros((2, nbins), np.float32)
        p[0, 1], p[0, nbins - 2] = 100.0, 101.0
        p[0, 2:half + 1] = np.linspace(1.0, 99.0, half - 1)
        p[0, half + 1:nbins - 2] = np.linspace(102.0, 199.0,
                                               nbins - half - 3)
        p[0, nbins - 1] = 200.0
        p[1, 1:half + 1] = 3.0
        p[1, half + 1:] = 5.0 + np.arange(nbins - half - 1,
                                          dtype=np.float32)
        return torch.from_numpy(p).cuda()

    cases = [
        ("rows_13_even_median", power_of(13, 4096, zero_row=4, zero_tail=6),
         4096, {}),
        ("zero_tail_across_slices", straddling(6, 1 << 16), 1 << 16, {}),
        ("middle_values_in_two_slices", middles_apart(1 << 16), 1 << 16, {}),
        # rows longer than 16 blocks hold: the global branch on its own
        ("global_branch_2^21", power_of(3, 1 << 21, zero_tail=1), 1 << 21,
         {}),
        ("odd_T_4095_odd_median", power_of(13, 4095, zero_tail=1), 4095, {}),
        ("band_fmin_fmax", power_of(8, 8192), 8192,
         {"fmin": 20.0, "fmax": 300.0}),
        # fmin above Nyquist: an empty band, every peak at bin 0
        ("empty_band", power_of(3, 4096), 4096, {"fmin": 1001.0}),
        ("max_harmonics_1", power_of(9, 4096), 4096, {"max_harmonics": 1}),
        ("max_harmonics_4", power_of(9, 4096), 4096, {"max_harmonics": 4}),
    ]
    records = {policy: [_harmonic_case(torch, np, label, power, t,
                                       policy=policy, **kw)
                        for label, power, t, kw in cases]
               for policy in B6_POLICIES}
    del cases
    for policy, recs in records.items():
        checked = set().union(*(r["branches_equal"] for r in recs))
        check(checked == {1, *hc.CLUSTER_SIZES}, f"B6 {policy} branches "
              f"checked: {sorted(checked)}")
        check([r["cluster"] for r in recs if r["case"].startswith(
            "global_branch_2^21")] == [1], "the 2^21 rows did not take the "
              "global branch")
    if quick:
        torch.cuda.empty_cache()
        return None, records, {}
    # every branch that holds the row, bit for bit, at the main paths'
    # shapes (the automatic choice included), under every policy
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    main = {policy: {} for policy in B6_POLICIES}
    for label, (rows, t) in HARMONIC_MAIN_SHAPES.items():
        power = _device_power(torch, gen, rows, t)
        for policy in B6_POLICIES:
            main[policy][label] = _harmonic_case(torch, np, label, power, t,
                                                 timed=True, policy=policy)
        del power
        torch.cuda.empty_cache()
    power = power_of(512, NSAMPLES)
    head = {policy: _harmonic_case(torch, np, "headline_512x2^20", power,
                                   NSAMPLES, timed=True, policy=policy)
            for policy in B6_POLICIES}
    del power
    torch.cuda.empty_cache()
    return head, records, main


#: launches inside the tuner's measurements since :func:`reset_counts`
#: (:func:`read_counts` leaves them out, so each path's counts are its own
#: work; :data:`PROBES` keeps each phase's as a path of its own)
_PROBE = {}

#: per phase, the launches of the tuner's measurements (the autotune probe)
PROBES = {}


def reset_counts():
    """Set every kernel's launch count to 0."""
    from pulsarutils_tpu_torch.ops import (dedisperse_cuda, fdmt_cuda,
                                           fourier_cuda, harmonic_cuda,
                                           score_cuda)

    dedisperse_cuda.launches = 0
    fdmt_cuda.head_launches = 0
    fdmt_cuda.merge_launches = 0
    fdmt_cuda.merge4_launches = 0
    score_cuda.launches = 0
    fourier_cuda.launches = 0
    for policy in harmonic_cuda.launches:
        harmonic_cuda.launches[policy] = 0
    _PROBE.clear()


def _raw_counts():
    """Every kernel's launch count since :func:`reset_counts`: B6 under
    ``f32`` as "B6", under another policy as "B6[policy]"."""
    from pulsarutils_tpu_torch.ops import (dedisperse_cuda, fdmt_cuda,
                                           fourier_cuda, harmonic_cuda,
                                           score_cuda)

    return {"B1": dedisperse_cuda.launches, "B2a": fdmt_cuda.merge_launches,
            "B2b": fdmt_cuda.merge4_launches, "B3": fdmt_cuda.head_launches,
            "B4": score_cuda.launches, "B5": fourier_cuda.launches,
            **{("B6" if policy == "f32" else f"B6[{policy}]"): n
               for policy, n in harmonic_cuda.launches.items()}}


def read_counts():
    """Every kernel's launch count since :func:`reset_counts`, less the
    launches inside the tuner's measurements (:func:`read_probe_counts`)."""
    return {k: v - _PROBE.get(k, 0) for k, v in _raw_counts().items()}


def read_probe_counts():
    """The launches inside the tuner's measurements since
    :func:`reset_counts`."""
    return {k: _PROBE.get(k, 0) for k in _raw_counts()}


def _counting_tuner(cache):
    """The process tuner of a phase: the package's :class:`KernelTuner`
    that also counts the launches and the seconds of its measurements
    (:data:`_PROBE`, ``probe``, ``seconds``: the whole measurement, its
    set-up (the synthetic data made and uploaded) and each candidate's
    runs) and keeps each candidate's warm-up output
    (``outputs[key][candidate]``, the equivalence checks' inputs)."""
    from pulsarutils_tpu_torch.tuning.autotune import KernelTuner

    class CountingTuner(KernelTuner):
        def __init__(self):
            super().__init__(cache=cache)
            self.probe = {}
            self.seconds = {}
            self.outputs = {}

        def _measure(self, key, candidates, static, runner_factory,
                     **kwargs):
            before = _raw_counts()
            spent = self.seconds.setdefault(key, {})

            def timed_factory():
                t0 = time.perf_counter()
                try:
                    return runner_factory()
                finally:
                    spent["setup"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            try:
                return super()._measure(key, candidates, static,
                                        timed_factory, **kwargs)
            finally:
                spent["total"] = time.perf_counter() - t0
                for k, v in _raw_counts().items():
                    d = v - before.get(k, 0)
                    self.probe[k] = self.probe.get(k, 0) + d
                    _PROBE[k] = _PROBE.get(k, 0) + d

        def _time_one(self, key, cand, *args, **kwargs):
            t0 = time.perf_counter()
            median, scores = super()._time_one(key, cand, *args, **kwargs)
            self.seconds.setdefault(key, {})[cand] = \
                time.perf_counter() - t0
            self.outputs.setdefault(key, {})[cand] = scores
            return median, scores

    return CountingTuner()


def e2e_trial_dms():
    """The end-to-end files' plan: DM 300-635 over 1024 channels."""
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan

    return dedispersion_plan(NCHAN, DMMIN, DMMAX, START_FREQ, BANDWIDTH,
                             TSAMP)


#: the cache the ``warm`` phases share (a file under :data:`TUNE_ROOT`)
WARM_CACHE = "warm_phases_tune_cache.json"


@contextlib.contextmanager
def cold_tuner(label, warm=False):
    """One phase's tuning state: ``PUTPU_TUNE_CACHE`` in a fresh
    temporary directory under :data:`TUNE_ROOT` (so no phase, and no run of
    this script, reads an earlier one's winners) and a fresh counting
    process tuner.  ``warm`` resolves the end-to-end chunk's search kernel
    first (what ``cli.tune_main tune`` does before a survey), so the
    phase's timed loops hold no measurement.  The ``warm`` phases share
    their winners: each starts from a copy of the cache the earlier ones
    left (:data:`WARM_CACHE`) and leaves its own there, so a key is
    measured once a run (the e2e key by the first, the (2, 2) mesh key by
    ``e2e_mesh``, ...), as ``tune_main tune`` leaves a cache; the
    ``autotune`` phases measure their keys cold on their own.  On exit
    the phase's probe launches go to :data:`PROBES` and its tuning
    seconds are printed."""
    from pulsarutils_tpu_torch.tuning import autotune
    from pulsarutils_tpu_torch.tuning.cache import TuneCache

    tmp = TUNE_ROOT / label
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    prev_env = os.environ.get("PUTPU_TUNE_CACHE")
    os.environ["PUTPU_TUNE_CACHE"] = str(tmp / "tune_cache.json")
    warmed = TUNE_ROOT / WARM_CACHE
    if warm and warmed.is_file():
        shutil.copyfile(warmed, tmp / "tune_cache.json")
    tuner = _counting_tuner(TuneCache(str(tmp / "tune_cache.json")))
    prev = autotune.set_tuner(tuner)
    try:
        if warm:
            dms = e2e_trial_dms()
            autotune.resolve_search_kernel(
                NCHAN, E2E_CHUNK, len(dms), None, False, START_FREQ,
                BANDWIDTH, TSAMP, dms, device="cuda")
        yield tuner
    finally:
        if warm and (tmp / "tune_cache.json").is_file():
            shutil.copyfile(tmp / "tune_cache.json", warmed)
        autotune.set_tuner(prev)
        if prev_env is None:
            os.environ.pop("PUTPU_TUNE_CACHE", None)
        else:
            os.environ["PUTPU_TUNE_CACHE"] = prev_env
        shutil.rmtree(tmp, ignore_errors=True)
        if any(tuner.probe.values()):
            PROBES[label] = {k: tuner.probe.get(k, 0) for k in _raw_counts()}
        emit("autotune_cost", label=label, warm=warm,
             seconds=tuner.seconds, decisions=tuner.decisions(),
             probe_launches={k: v for k, v in tuner.probe.items() if v})


@contextlib.contextmanager
def env_set(**values):
    """Environment variables set for the block, restored after."""
    prev = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fdmt_launches(nchan, dmmin, dmmax, f0=START_FREQ, bw=BANDWIDTH,
                  tsamp=TSAMP):
    """Launches of B3, B2a and B2b that one coarse sweep of this geometry
    makes, from the transform's own schedule."""
    from pulsarutils_tpu_torch.ops.fdmt import (fdmt_plan, fdmt_trial_dms,
                                                transform_schedule)

    _, n_lo, n_hi = fdmt_trial_dms(nchan, dmmin, dmmax, f0, bw, tsamp)
    kinds = [k for k, _ in transform_schedule(
        fdmt_plan(nchan, f0, bw, n_hi, n_lo))]
    return {"B3": kinds.count("head"), "B2a": kinds.count("merge"),
            "B2b": kinds.count("merge4")}


def _hit_mismatch(ours, ref, snr_rtol=1e-5):
    """The first difference between two hit lists (chunks, best DM, rebin,
    peak, snr within ``snr_rtol``), or None."""
    if [(h[0], h[1]) for h in ours] != [(h[0], h[1]) for h in ref]:
        return (f"chunks {[(h[0], h[1]) for h in ours]} vs "
                f"{[(h[0], h[1]) for h in ref]}")
    for (lo, _, info, table), (_, _, rinfo, rtable) in zip(ours, ref):
        best, rbest = table.best_row(), rtable.best_row()
        for col in ("DM", "rebin", "peak"):
            if best[col] != rbest[col]:
                return f"chunk {lo}: {col} {best[col]} vs {rbest[col]}"
        if abs(best["snr"] - rbest["snr"]) > snr_rtol * abs(rbest["snr"]):
            return f"chunk {lo}: snr {best['snr']} vs {rbest['snr']}"
        if info.dm != rinfo.dm or info.width != rinfo.width:
            return f"chunk {lo}: candidate {info.dm}/{info.width}"
    return None


def check_clean_run(summary, label):
    """A main-path run: no fallback, no OOM descent, nothing quarantined."""
    check(summary.get("fallback") is None,
          f"{label}: fell back: {summary.get('fallback')}")
    check(summary.get("oom_descents") == 0,
          f"{label}: {summary.get('oom_descents')} OOM descents")
    check(summary.get("quarantined") == 0,
          f"{label}: {summary.get('quarantined')} chunks quarantined")


def phase_hybrid_headline(torch, np, seed):
    """The JAX package's benchmark: hybrid vs the full exact sweep."""
    from pulsarutils_tpu_torch.ops.fdmt import fdmt_trial_dms
    from pulsarutils_tpu_torch.ops.plan import (dedispersion_shifts,
                                                dmmax_for_trials)
    from pulsarutils_tpu_torch.ops.search import (_search_fdmt,
                                                  _search_hybrid,
                                                  dedispersion_search)

    dmmax = dmmax_for_trials(DMMIN, HYB_NTRIALS, START_FREQ, BANDWIDTH,
                             TSAMP)
    t0 = time.perf_counter()
    # bench.py's data: |N(0, 1)| / 2, an impulse at T/2, rolled per
    # channel by the DM 350 shifts
    rng = np.random.default_rng(seed)
    array = rng.standard_normal((NCHAN, NSAMPLES), dtype=np.float32)
    np.abs(array, out=array)
    array *= 0.5
    array[:, NSAMPLES // 2] += 1.0
    shifts = np.rint(np.asarray(dedispersion_shifts(
        NCHAN, HYB_DM, START_FREQ, BANDWIDTH, TSAMP))).astype(int) % NSAMPLES
    for c in range(NCHAN):
        array[c] = np.roll(array[c], shifts[c])
    data = torch.from_numpy(array).cuda()
    del array
    make_s = time.perf_counter() - t0
    args = (DMMIN, dmmax, START_FREQ, BANDWIDTH, TSAMP)

    def hybrid():
        return dedispersion_search(data, *args, kernel="hybrid",
                                   device="cuda")

    def exact():
        return dedispersion_search(data, *args, kernel="pallas",
                                   device="cuda")

    def wall(fn, runs=3):
        times, out = [], None
        for _ in range(runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        return out, statistics.median(times), times

    reset_counts()
    t = time.perf_counter()
    table = hybrid()   # first call: the retention bound (host) included
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t)
    counts = read_counts()
    want = fdmt_launches(NCHAN, float(table["DM"].min()),
                         float(table["DM"].max()))
    # the fused schedule: one scorer launch for the coarse plane, one for
    # the seed's rows and one for the need stage's, one per host-loop
    # bucket; a sweep launch for each but the coarse plane's
    check(want["B3"] == 1 and all(counts[k] == v for k, v in want.items())
          and counts["B1"] >= 2 and counts["B4"] == 1 + counts["B1"],
          f"hybrid headline launches {counts}, schedule {want}")
    # one dispatch and one readback for the fused program, one each per
    # host-loop bucket (its B1 launches but the program's two)
    trips = _budget_of(hybrid)
    check(trips["counters"].get("dispatches")
          == trips["counters"].get("readbacks") == counts["B1"] - 1
          and "search/fused" in trips["buckets"],
          f"hybrid headline trips {trips}, launches {counts}")
    table, hybrid_ms, hybrid_runs = wall(hybrid)
    trial_dms = np.asarray(table["DM"])
    # the two-stage rescore's kernel at this key resolves to the static
    # direct sweep from the cache-only tuner: its cold measurement at 1024
    # x 2^20 took 19-25 s a run (the gather and roll at full depth), and
    # the tuner's own phases measure it (the direct sweep wins every key)
    with env_set(PUTPU_AUTOTUNE="cache"):
        _, two_stage_ms, two_stage_runs = wall(lambda: _search_hybrid(
            data, trial_dms, START_FREQ, BANDWIDTH, TSAMP, False,
            fused=False))
        two_trips = _budget_of(lambda: _search_hybrid(
            data, trial_dms, START_FREQ, BANDWIDTH, TSAMP, False,
            fused=False))
    rows_check = _seed_rows_bitwise(torch, np, data, trial_dms)
    ref, exact_ms, exact_runs = wall(exact)
    coarse_dms = fdmt_trial_dms(NCHAN, float(table["DM"].min()),
                                float(table["DM"].max()), START_FREQ,
                                BANDWIDTH, TSAMP)[0]
    coarse_ms, coarse_runs = time_ms(torch, lambda: _search_fdmt(
        data, float(table["DM"].min()), float(table["DM"].max()),
        START_FREQ, BANDWIDTH, TSAMP, False, with_cert=True))
    best_h, best_p = table.argbest(), ref.argbest()
    match = {
        "argbest_equal": best_h == best_p,
        "dm_byte_equal": bool(table["DM"][best_h] == ref["DM"][best_p]),
        "rebin_equal": int(table["rebin"][best_h])
        == int(ref["rebin"][best_p]),
        "peak_equal": int(table["peak"][best_h]) == int(ref["peak"][best_p]),
        "snr_close": bool(abs(table["snr"][best_h] - ref["snr"][best_p])
                          <= 1e-5 * abs(ref["snr"][best_p])),
        "snr_rel_diff": float(abs(table["snr"][best_h] - ref["snr"][best_p])
                              / abs(ref["snr"][best_p])),
        "rescored_rows": int(np.count_nonzero(table["exact"])),
    }
    # every exact row is the exact sweep's row: the same B1 sums (the
    # rows planned on the card), B4 row by row
    ex = np.flatnonzero(table["exact"])
    exact_rows = {col: float(np.max(np.abs(
        np.asarray(table[col][ex], np.float64)
        - np.asarray(ref[col][ex], np.float64)))) for col in
        ("max", "std", "snr", "rebin", "peak")}
    check(exact_rows["rebin"] == 0 and exact_rows["peak"] == 0
          and all(exact_rows[c] <= 1e-6 * float(np.max(np.abs(ref[c])))
                  for c in ("max", "std", "snr")),
          f"hybrid exact rows differ from the sweep's: {exact_rows}")
    ndm = table.nrows
    emit("hybrid_headline", nchan=NCHAN, nsamples=NSAMPLES, ndm=ndm,
         coarse_rows=len(coarse_dms), dm_range=[DMMIN, dmmax],
         injected_dm=HYB_DM, best_dm=float(table["DM"][best_h]),
         best_snr=float(table["snr"][best_h]), exact_hit_match=match,
         launches=counts, data_seconds=make_s, first_call_ms=first_ms,
         coarse_ms=coarse_ms, coarse_runs_ms=coarse_runs,
         hybrid_ms=hybrid_ms, hybrid_runs_ms=hybrid_runs,
         dispatches=trips["counters"].get("dispatches"),
         readbacks=trips["counters"].get("readbacks"),
         buckets_s=trips["buckets"],
         two_stage_ms=two_stage_ms, two_stage_runs_ms=two_stage_runs,
         two_stage_dispatches=two_trips["counters"].get("dispatches"),
         two_stage_readbacks=two_trips["counters"].get("readbacks"),
         two_stage_buckets_s=two_trips["buckets"],
         exact_rows_max_abs_diff_vs_sweep=exact_rows,
         seed_rows_b1_vs_plain=rows_check,
         exact_sweep_ms=exact_ms, exact_sweep_runs_ms=exact_runs,
         hybrid_dm_trials_per_s=ndm / (hybrid_ms / 1e3),
         exact_dm_trials_per_s=ref.nrows / (exact_ms / 1e3),
         coarse_dm_trials_per_s=len(coarse_dms) / (coarse_ms / 1e3),
         meta=table.meta)
    failed = [k for k, v in match.items() if isinstance(v, bool) and not v]
    check(not failed, f"exact_hit_match failed on {failed}")
    check(abs(table["DM"][best_h] - HYB_DM) < 1.0,
          f"hybrid best DM {table['DM'][best_h]} vs injected {HYB_DM}")
    del data
    torch.cuda.empty_cache()
    return {"hybrid_ms": hybrid_ms, "coarse_ms": coarse_ms,
            "exact_ms": exact_ms, "two_stage_ms": two_stage_ms}


def _budget_of(fn):
    """The budget record (buckets in seconds, counters) of one call of
    ``fn`` under a :class:`BudgetAccountant`."""
    from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

    acct = BudgetAccountant()
    with acct.chunk(0) as rec:
        fn()
    return {"buckets": rec["buckets"], "counters": rec["counters"]}


def _seed_rows_bitwise(torch, np, data, trial_dms):
    """The fused seed program's seed and need rows of ``data``: B1 planned
    on the card over the device-resident table against the plain sweep
    of the same offsets, bit for bit."""
    from pulsarutils_tpu_torch.ops import search
    from pulsarutils_tpu_torch.ops.certify import fused_cert_params
    from pulsarutils_tpu_torch.ops.dedisperse import dedisperse_plane_plain
    from pulsarutils_tpu_torch.ops.dedisperse_cuda import dedisperse_rows
    from pulsarutils_tpu_torch.ops.fdmt import fdmt_trial_dms
    from pulsarutils_tpu_torch.ops.plan import offsets_for

    nchan, nsamples = data.shape
    ndm = len(trial_dms)
    geom = (START_FREQ, BANDWIDTH, TSAMP)
    coarse_dms, n_lo, n_hi = fdmt_trial_dms(
        nchan, float(trial_dms.min()), float(trial_dms.max()), *geom)
    table = search._row_table(trial_dms.tobytes(), nchan, *geom, nsamples,
                              data.device)
    bucket, bucket2 = search.HYBRID_SEED_BUCKET, search.HYBRID_NEED_BUCKET
    packed = search._fused_seed(
        data, table, search.nearest_rows(coarse_dms, trial_dms),
        fused_cert_params(nchan, trial_dms, *geom, nsamples), n_lo, n_hi,
        START_FREQ, BANDWIDTH, bucket, bucket2)
    _, sel, _, _, sel2, _, n_need = search.unpack_fused_hybrid(
        packed, ndm, bucket, bucket2)
    offsets = offsets_for(trial_dms, nchan, *geom, nsamples)
    out = {"n_need": n_need, "use_smem": table.use_smem,
           "window": table.win, "spread": table.spread}
    for name, rows in (("seed", sel), ("need", sel2)):
        kernel = dedisperse_rows(data, table,
                                 torch.from_numpy(rows).to(data.device))
        plain = dedisperse_plane_plain(data, offsets[rows])
        diff = float((kernel - plain).abs().max())
        check(diff == 0.0, f"B1 on the {name} rows {rows.tolist()} differs "
              f"from plain by {diff}")
        out[name] = {"rows": rows.tolist(), "max_abs_diff": diff}
    return out


def phase_sweep_breakdown(torch, np, seed):
    """The direct sweep through its entry points only, at the headline
    geometry: B1 through ``dedisperse_plane`` (host planning and upload
    included) at the search's superblocks, the hybrid's 8- and 16-row
    rescore buckets and the plan's 2-trial tail, with the card time of
    its kernel launches; then ``dedispersion_search(kernel="pallas")``
    (the direct sweep ``kernel="auto"`` ran before it was measured), its
    first call on the geometry and its repeats split into B1, B4 and the
    rest.  It uses no name that earlier versions of the package lack, so
    this script can time another checkout of the package (``--breakdown``
    in a copy of the script beside it)."""
    from pulsarutils_tpu_torch.ops import dedisperse_cuda as dc
    from pulsarutils_tpu_torch.ops import score_cuda as sc
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan, offsets_for
    from pulsarutils_tpu_torch.ops.search import dedispersion_search

    rng = np.random.default_rng(seed + 5)
    data = torch.from_numpy(rng.standard_normal(
        (NCHAN, NSAMPLES), dtype=np.float32)).cuda()
    geom = (START_FREQ, BANDWIDTH, TSAMP)
    offsets = offsets_for(dedispersion_plan(NCHAN, DMMIN, DMMAX, *geom),
                          NCHAN, *geom, NSAMPLES)
    superblock = 512
    record = {"nchan": NCHAN, "nsamples": NSAMPLES, "b1": {}}

    def spans_ms(spans, runs):
        return sum(s.elapsed_time(e) for s, e in spans) / runs

    for label, rows in (("superblocks_514", offsets),
                        ("bucket_8", offsets[200:208]),
                        ("bucket_16", offsets[200:216]),
                        ("tail_2", offsets[superblock:])):
        blocks = [rows[lo:lo + superblock]
                  for lo in range(0, rows.shape[0], superblock)]

        def sweep(blocks=blocks):
            return [dc.dedisperse_plane(data, b) for b in blocks]

        sweep()  # the warm-up, untimed
        spans, undo = _timed_launches(torch, dc, "dedisperse_plane_cuda")
        try:
            wrapper_ms, runs = time_ms(torch, sweep, warm_up=False)
        finally:
            undo()
        record["b1"][label] = {
            "trials": int(rows.shape[0]), "launches": len(blocks),
            "wrapper_ms": wrapper_ms, "wrapper_runs_ms": runs,
            "kernel_ms": spans_ms(spans, len(runs))}
        torch.cuda.empty_cache()

    def search():
        dedispersion_search(data, DMMIN, DMMAX, *geom, kernel="pallas",
                            device="cuda")
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    search()
    first_ms = 1e3 * (time.perf_counter() - t0)
    walls = []
    b1, undo1 = _timed_launches(torch, dc, "dedisperse_plane_cuda")
    b4, undo4 = _timed_launches(torch, sc, "score_plane_cuda")
    try:
        for _ in range(3):
            t0 = time.perf_counter()
            search()
            walls.append(1e3 * (time.perf_counter() - t0))
    finally:
        undo1()
        undo4()
    wall = statistics.median(walls)
    kernels = {"B1": spans_ms(b1, 3), "B4": spans_ms(b4, 3)}
    record["exact_sweep"] = {
        "trials": int(offsets.shape[0]), "first_call_ms": first_ms,
        "wall_ms": wall, "wall_runs_ms": walls,
        "launches": {"B1": len(b1) // 3, "B4": len(b4) // 3},
        "kernel_ms": kernels, "beside_kernels_ms": wall - sum(kernels.values())}
    emit("sweep_breakdown", **record)
    del data
    torch.cuda.empty_cache()
    return record


def _bench_data_on_card(torch, np, nsamples, seed):
    """bench.py's kind of chunk, made on the card: |N(0, 1)| / 2 with an
    impulse at T/2 rolled per channel by the DM 350 shifts."""
    from pulsarutils_tpu_torch.ops.plan import dedispersion_shifts

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((NCHAN, nsamples), generator=gen, device="cuda").abs_()
    x *= 0.5
    x[:, nsamples // 2] += 1.0
    shifts = np.rint(np.asarray(dedispersion_shifts(
        NCHAN, HYB_DM, START_FREQ, BANDWIDTH, TSAMP))).astype(np.int64)
    for c in range(NCHAN):
        x[c] = torch.roll(x[c], int(shifts[c] % nsamples))
    return x


def phase_hybrid_breakdown(torch, np, seed):
    """The hybrid's search split, fused and two-stage, at the end-to-end
    chunk (1024 x 2^18, the DM 300-635 plan) and the headline (1024 x
    2^20, bench.py's 512-trial grid): the budget's buckets (the fused
    program, the coarse sweep and its readback, the host loop's rescore
    buckets, the certificate bound), the card time of B1 and B4 (CUDA
    events around each launch), the host's planning of a bucket's rows
    on the card, and the rest; then one 8-row B1 launch planned on the
    card (the table's static window) against the same rows planned on
    the host (their own window), each against plain bit for bit and
    against its bound."""
    from pulsarutils_tpu_torch.ops import dedisperse_cuda as dc
    from pulsarutils_tpu_torch.ops import score_cuda as sc
    from pulsarutils_tpu_torch.ops.dedisperse import dedisperse_plane_plain
    from pulsarutils_tpu_torch.ops.plan import (dedispersion_plan,
                                                dmmax_for_trials, offsets_for)
    from pulsarutils_tpu_torch.ops.search import _row_table, _search_hybrid

    geom = (START_FREQ, BANDWIDTH, TSAMP)
    out = {}
    for label, nsamples, dmmax in (
            ("e2e_chunk", E2E_CHUNK, DMMAX),
            ("headline", NSAMPLES, dmmax_for_trials(DMMIN, HYB_NTRIALS,
                                                    *geom))):
        data = _bench_data_on_card(torch, np, nsamples, seed + 11)
        dms = dedispersion_plan(NCHAN, DMMIN, dmmax, *geom)
        rec = {"nchan": NCHAN, "nsamples": nsamples, "ndm": len(dms)}
        for mode, fused in (("fused", True), ("two_stage", False)):
            def search():
                return _search_hybrid(data, dms, *geom, False, fused=fused)

            search()   # the warm-up: the certificate bound, the table
            torch.cuda.synchronize()
            b1, undo1 = _timed_launches(torch, dc, "dedisperse_plane_cuda")
            b4, undo4 = _timed_launches(torch, sc, "score_plane_cuda")
            try:
                t0 = time.perf_counter()
                budget = _budget_of(search)
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
            finally:
                undo1()
                undo4()
            buckets = {k: 1e3 * v for k, v in budget["buckets"].items()}
            kernels = {"B1": sum(a.elapsed_time(b) for a, b in b1),
                       "B4": sum(a.elapsed_time(b) for a, b in b4)}
            rec[mode] = {"wall_ms": wall, "buckets_ms": buckets,
                         "counters": budget["counters"],
                         "launches": {"B1": len(b1), "B4": len(b4)},
                         "card_ms": kernels,
                         "rest_ms": wall - sum(buckets.values())}
        table = _row_table(dms.tobytes(), NCHAN, *geom, nsamples,
                           data.device)
        offsets = offsets_for(dms, NCHAN, *geom, nsamples)
        best = int(np.argmin(np.abs(dms - HYB_DM)))
        seed_rows = np.clip(np.array([best - 1, best, best + 1, 60, 61, 62,
                                      best - 1, best - 1]), 0, len(dms) - 1)
        plan_ms = {}
        for n in (8, 32):
            rows = torch.arange(n, device="cuda") * 3 % len(dms)
            walls = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dc.table_plan(table, rows)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
            plan_ms[f"rows_{n}"] = statistics.median(walls)
        rec["plan_rows_on_card_ms"] = plan_ms
        plain = dedisperse_plane_plain(data, offsets[seed_rows])
        dplan, dmeta = dc.table_plan(table, torch.from_numpy(seed_rows)
                                     .cuda())
        hplan, hmeta = dc.device_plan(offsets[seed_rows], nsamples,
                                      data.device)
        launch = {}
        for name, plan, meta in (("card_planned", dplan, dmeta),
                                 ("host_planned", hplan, hmeta)):
            got = dc.dedisperse_plane_cuda(data, meta, plan)
            diff = float((got - plain).abs().max())
            check(diff == 0.0, f"{label}: the {name} 8-row B1 launch "
                  f"differs from plain by {diff}")
            ms, runs = time_ms(torch, lambda plan=plan, meta=meta:
                               dc.dedisperse_plane_cuda(data, meta, plan))
            launch[name] = {"kernel_ms": ms, "runs_ms": runs,
                            "window": plan.win, "use_smem": plan.use_smem,
                            "max_abs_diff": diff}
        bound, by = sweep_bound_ms(8, NCHAN, nsamples)
        launch["bound_ms"], launch["bound_by"] = bound, by
        launch["rows"] = seed_rows.tolist()
        rec["b1_8_rows"] = launch
        emit("hybrid_breakdown", case=label, **rec)
        out[label] = rec
        del data, plain
        torch.cuda.empty_cache()
    return out


def phase_kernel_breakdown(torch, np, seed):
    """B6 and B3 split into their phases at the main paths' shapes,
    through the wrappers' entry points only (so that the script also
    times an older checkout of the package).

    B6: the whole stack (16 harmonics) against one harmonic, which is
    the median and a single read of the row, so the difference is the
    stack's harmonics 2-16.  B3: the launch against the same launch with
    every level's row count set to 0 in its table, which stages the
    input and passes the barriers but computes no level, and against
    launches that compute levels 0-3 only and levels 4-6 only."""
    from pulsarutils_tpu_torch.ops import fdmt_cuda as fc
    from pulsarutils_tpu_torch.ops import harmonic_cuda as hc
    from pulsarutils_tpu_torch.ops.fdmt import (fdmt_plan, fdmt_trial_dms,
                                                head_plan)
    from pulsarutils_tpu_torch.ops.plan import dmmax_for_trials

    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    record = {"b6": {}, "b3": {}}
    depths = (1, 2, 4, 8, 16)
    shapes = {**HARMONIC_MAIN_SHAPES, "timed_512": (512, NSAMPLES)}
    for label, (rows, t) in shapes.items():
        power = _device_power(torch, gen, rows, t)
        nbins = power.shape[1]
        bound, bound_by = b6_bound_ms(rows, nbins, depths, "f32")

        def run(d, power=power, nbins=nbins):
            return hc.harmonic_peaks_cuda(power, d, 1, nbins)

        full_ms, full_runs = time_ms(torch, lambda: run(depths))
        one_ms, _ = time_ms(torch, lambda: run((1,)))
        record["b6"][label] = {
            "rows": rows, "nbins": nbins, "ms": full_ms,
            "runs_ms": full_runs, "median_and_one_harmonic_ms": one_ms,
            "harmonics_2_16_ms": full_ms - one_ms, "bound_ms": bound,
            "bound_by": bound_by, "bound_share": bound / full_ms}
        del power
        torch.cuda.empty_cache()

    headline_dmmax = dmmax_for_trials(DMMIN, HYB_NTRIALS, START_FREQ,
                                      BANDWIDTH, TSAMP)
    for label, t, dmmax in (("headline", NSAMPLES, headline_dmmax),
                            ("e2e_hybrid_chunk", E2E_CHUNK, DMMAX)):
        _, n_lo, n_hi = fdmt_trial_dms(NCHAN, DMMIN, dmmax, START_FREQ,
                                       BANDWIDTH, TSAMP)
        hp = head_plan(fdmt_plan(NCHAN, START_FREQ, BANDWIDTH, int(n_hi),
                                 int(n_lo)))
        state = torch.randn((NCHAN, t), generator=gen, device="cuda")
        table, offsets = fc.head_table(hp)
        params = fc.head_params(hp, offsets, t, NCHAN)

        def counts_zeroed(levels, table=table, offsets=offsets):
            # the row counts, levels first, zeroed at ``levels``
            out = table.copy()
            out[offsets[-2]:offsets[-1]].reshape(len(hp.max_shift), -1)[
                list(levels)] = 0
            return torch.from_numpy(out).cuda()

        def launch(tab, state=state, params=params, hp=hp):
            return lambda: fc.head_cuda(state, tab, params, hp.rows_out)

        nlev = len(hp.max_shift)
        idle = counts_zeroed(range(nlev))
        table = torch.from_numpy(table).cuda()
        full_ms, full_runs = time_ms(torch, launch(table))
        stage_ms, _ = time_ms(torch, launch(idle))
        # the first four levels alone, and the other three alone
        first_ms, _ = time_ms(torch, launch(counts_zeroed(range(4, nlev))))
        last_ms, _ = time_ms(torch, launch(counts_zeroed(range(4))))
        bound, bound_by = bound_ms(*_roofline().fdmt_pass_work(
            int(hp.counts.sum()), t, NCHAN, hp.rows_out, table.numel()))
        record["b3"][label] = {
            "nsamples": t, "rows": [int(n_lo), int(n_hi)],
            "rows_out": hp.rows_out, "ms": full_ms, "runs_ms": full_runs,
            "staging_and_barriers_ms": stage_ms,
            "levels_ms": full_ms - stage_ms,
            "levels_0_3_ms": first_ms - stage_ms,
            "levels_4_6_ms": last_ms - stage_ms, "bound_ms": bound,
            "bound_by": bound_by, "bound_share": bound / full_ms}
        del state, table, idle
        torch.cuda.empty_cache()
    emit("kernel_breakdown", **record)
    return record


def phase_e2e_hybrid(torch, np, workdir, path, chunk_length, nchunks,
                     direct_hits):
    """The end-to-end file through the hybrid: at S/N 8 (floorless: the
    fused seed program on every chunk), the same with the OOM ladder's
    ``unfuse`` rung engaged by an injected OOM at the first chunk's
    dispatch (two-stage on every chunk), then at the certifiable floor
    (the noise certificate; two-stage)."""
    from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan
    from pulsarutils_tpu_torch.pipeline.search_pipeline import \
        search_by_chunks

    common = dict(chunk_length=chunk_length, dmmin=DMMIN, dmmax=DMMAX,
                  device="cuda", make_plots=False)
    dms = dedispersion_plan(NCHAN, DMMIN, DMMAX, START_FREQ, BANDWIDTH,
                            TSAMP)
    per_chunk = fdmt_launches(NCHAN, float(dms.min()), float(dms.max()))
    check(per_chunk["B3"] == 1, f"e2e schedule {per_chunk}")
    runs, hits_of = {}, {}
    unfuse = FaultPlan([FaultSpec(site="dispatch", kind="oom", times=1)])
    for label, threshold, fused in (("snr_8", 8.0, True),
                                    ("snr_8_unfused", 8.0, False),
                                    ("certifiable", "certifiable", False)):
        stages, summary = {}, {}
        reset_counts()
        t0 = time.perf_counter()
        with (unfuse.armed() if label == "snr_8_unfused"
              else contextlib.nullcontext()):
            hits, store = search_by_chunks(
                str(path), kernel="hybrid", snr_threshold=threshold,
                output_dir=str(workdir / f"out_hybrid_{label}"),
                stage_seconds=stages, summary=summary, **common)
        wall = time.perf_counter() - t0
        counts = read_counts()
        floor = summary["snr_threshold"]
        if label == "snr_8_unfused":
            check(summary.get("fallback") is None
                  and summary.get("oom_descents") == 1
                  and summary.get("quarantined") == 0,
                  f"{label}: {summary}")
            # the rung's contract: the same hits, best rows and rows
            # exact in both runs
            bad = _hit_mismatch(hits, hits_of["snr_8"])
            check(bad is None, f"{label}: hits differ from the fused "
                  f"run's: {bad}")
            for (_, _, _, t), (_, _, _, r) in zip(hits, hits_of["snr_8"]):
                both = np.asarray(t["exact"]) & np.asarray(r["exact"])
                check(all(np.array_equal(np.asarray(t[c])[both],
                                         np.asarray(r[c])[both])
                          for c in ("max", "std", "snr", "rebin", "peak")),
                      f"{label}: a row exact in both runs differs")
        else:
            check_clean_run(summary, f"e2e_hybrid {label}")
        # the fused program on every chunk, or on none
        check(("search/fused" in stages) == fused
              and ("search/coarse" in stages) != fused,
              f"{label}: stages {sorted(stages)}")
        hits_of[label] = hits
        check(summary["searched"] == nchunks, f"{label}: searched "
              f"{summary['searched']} of {nchunks} chunks")
        check(all(counts[k] == v * nchunks for k, v in per_chunk.items())
              and counts["B4"] == nchunks + counts["B1"],
              f"{label}: launches {counts} for {nchunks} chunks "
              f"(schedule {per_chunk} a chunk)")
        uncertified = nchunks - summary["certified"]
        check(counts["B1"] >= uncertified, f"{label}: {counts['B1']} sweep "
              f"launches for {uncertified} uncertified chunks")
        if floor >= 8.0:
            ref = [h for h in direct_hits if h[2].snr > floor]
        else:
            ref_summary = {}
            ref, _ = search_by_chunks(
                str(path), snr_threshold=floor,
                output_dir=str(workdir / f"out_direct_{label}"),
                summary=ref_summary, **common)
            check_clean_run(ref_summary, f"e2e_hybrid direct {label}")
        bad = _hit_mismatch(hits, ref)
        check(bad is None, f"{label}: hybrid hits differ from the direct "
              f"sweep's at S/N {floor}: {bad}")
        check(len(store.done_chunks) == nchunks, f"{label}: ledger")
        loop_s = wall - stages.get("badchans", 0.0)
        emit("e2e_hybrid", run=label, snr_threshold=floor,
             snr_floor=summary["snr_floor"], chunks=nchunks,
             certified_chunks=summary["certified"], hits=len(hits),
             fused=fused, oom_descents=summary.get("oom_descents"),
             launches=counts,
             launches_per_chunk={k: v / nchunks for k, v in counts.items()},
             wall_s=wall, chunk_loop_s=loop_s,
             chunks_per_s=nchunks / loop_s, stage_seconds=stages,
             hits_equal_direct=True)
        runs[label] = counts
    runs["hits"] = hits_of
    return runs


def phase_e2e_fourier(torch, np, workdir, path, chunk_length, nchunks):
    """The end-to-end file through ``kernel="fourier"``."""
    from pulsarutils_tpu_torch.ops.fourier import FOURIER_SUPERBLOCK
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan
    from pulsarutils_tpu_torch.pipeline.search_pipeline import \
        search_by_chunks

    dms = dedispersion_plan(NCHAN, DMMIN, DMMAX, START_FREQ, BANDWIDTH,
                            TSAMP)
    stages, summary = {}, {}
    reset_counts()
    t0 = time.perf_counter()
    hits, store = search_by_chunks(
        str(path), kernel="fourier", chunk_length=chunk_length, dmmin=DMMIN,
        dmmax=DMMAX, snr_threshold=8.0, output_dir=str(workdir / "out_fdd"),
        device="cuda", make_plots=False, stage_seconds=stages,
        summary=summary)
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_clean_run(summary, "e2e_fourier")
    nsuper = -(-len(dms) // FOURIER_SUPERBLOCK)
    check(counts["B5"] == nchunks * nsuper
          and counts["B4"] == nchunks * nsuper,
          f"fourier e2e launches {counts} for {nchunks} chunks")
    check(len(store.done_chunks) == nchunks, "fourier e2e ledger")
    check(hits, "fourier e2e: the injected pulse was not found")
    pulse_t = E2E_NSAMPLES // 2
    istart, iend, info, table = max(hits, key=lambda h: h[2].snr)
    spacing = float(dms[1] - dms[0])
    check(istart <= pulse_t < iend, f"fourier best hit in chunk "
          f"{istart}-{iend}")
    check(abs(info.dm - E2E_DM) <= spacing, f"fourier DM {info.dm} vs "
          f"injected {E2E_DM} (spacing {spacing})")
    loop_s = wall - stages.get("badchans", 0.0)
    emit("e2e_fourier", chunks=nchunks, trials=len(dms), hits=len(hits),
         best={"istart": istart, "iend": iend, "dm": info.dm,
               "snr": info.snr, "width_s": info.width},
         launches=counts,
         launches_per_chunk={k: v / nchunks for k, v in counts.items()},
         wall_s=wall, chunk_loop_s=loop_s, chunks_per_s=nchunks / loop_s,
         stage_seconds=stages)
    return counts


#: the e2e_precision runs: a formulation under a policy, each beside the
#: same formulation under f32
PRECISION_RUNS = (("roll", "f32_compensated"),
                  ("gather", "bf16_operand_f32_accum"))


def _policy_hit_mismatch(ours, ref, rtol):
    """The first difference between two hit lists (chunks, best DM, rebin,
    peak, snr within ``rtol``), or None."""
    if [(h[0], h[1]) for h in ours] != [(h[0], h[1]) for h in ref]:
        return (f"chunks {[(h[0], h[1]) for h in ours]} vs "
                f"{[(h[0], h[1]) for h in ref]}")
    for (lo, _, _, table), (_, _, _, rtable) in zip(ours, ref):
        best, rbest = table.best_row(), rtable.best_row()
        for col in ("DM", "rebin", "peak"):
            if best[col] != rbest[col]:
                return f"chunk {lo}: {col} {best[col]} vs {rbest[col]}"
        if abs(best["snr"] - rbest["snr"]) > rtol * abs(rbest["snr"]):
            return f"chunk {lo}: snr {best['snr']} vs {rbest['snr']}"
    return None


def phase_e2e_precision(torch, np, workdir, path, chunk_length, nchunks,
                        direct_hits):
    """The precision policies end to end: ``search_by_chunks`` on the
    end-to-end file with ``kernel="roll"`` under ``PUTPU_PRECISION=
    f32_compensated`` and ``kernel="gather"`` under
    ``bf16_operand_f32_accum``, each beside its ``f32`` run (the hits
    equal, snr within the strategy's ``score_rtol``; roll's ``f32`` hits
    equal the direct sweep's); then, on the pulse's chunk, the roll
    ``f32`` plane against B1's bit for bit, ``spectral_search`` of that
    514-trial plane under every policy (B6 at 514 x 131,073) against the
    ``f32`` search, and B6 on that plane's power under every policy,
    through every branch, against its plain version bit for bit."""
    import os

    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader
    from pulsarutils_tpu_torch.ops.periodicity import (power_spectrum,
                                                       spectral_search)
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan
    from pulsarutils_tpu_torch.ops.search import dedispersion_search
    from pulsarutils_tpu_torch.pipeline.search_pipeline import (
        clean_chunk, search_by_chunks)
    from pulsarutils_tpu_torch.precision import STRATEGIES

    dms = dedispersion_plan(NCHAN, DMMIN, DMMAX, START_FREQ, BANDWIDTH,
                            TSAMP)
    blocks = -(-len(dms) // 32)  # the formulations' default trial block
    launches = {}
    try:
        for kernel, policy in PRECISION_RUNS:
            hits_by = {}
            for pol in ("f32", policy):
                os.environ["PUTPU_PRECISION"] = pol
                stages, summary = {}, {}
                reset_counts()
                t0 = time.perf_counter()
                hits, store = search_by_chunks(
                    str(path), kernel=kernel, chunk_length=chunk_length,
                    dmmin=DMMIN, dmmax=DMMAX, snr_threshold=8.0,
                    output_dir=str(workdir / f"out_{kernel}_{pol}"),
                    device="cuda", make_plots=False, stage_seconds=stages,
                    summary=summary)
                wall = time.perf_counter() - t0
                counts = read_counts()
                check_clean_run(summary, f"e2e_precision {kernel} {pol}")
                check(counts["B4"] == nchunks * blocks and counts["B1"] == 0,
                      f"{kernel} {pol}: launches {counts} for {nchunks} "
                      f"chunks of {blocks} trial blocks")
                check(len(store.done_chunks) == nchunks,
                      f"{kernel} {pol}: ledger")
                check(hits, f"{kernel} {pol}: the pulse was not found")
                hits_by[pol] = hits
                launches[f"{kernel} under {pol} (e2e_precision)"] = counts
                loop_s = wall - stages.get("badchans", 0.0)
                emit("e2e_precision", kernel=kernel, policy=pol,
                     chunks=nchunks, trials=len(dms), hits=len(hits),
                     best=[{"istart": h[0], "dm": h[2].dm, "snr": h[2].snr,
                            "rebin": int(h[3].best_row()["rebin"]),
                            "peak": int(h[3].best_row()["peak"])}
                           for h in hits],
                     launches=counts, wall_s=wall, chunk_loop_s=loop_s,
                     chunks_per_s=nchunks / loop_s, stage_seconds=stages)
            rtol = STRATEGIES[policy].score_rtol
            bad = _policy_hit_mismatch(hits_by[policy], hits_by["f32"], rtol)
            check(bad is None, f"{kernel}: hits under {policy} differ from "
                  f"f32's: {bad}")
            if kernel == "roll":
                # roll adds the channels in B1's order: the same scores
                bad = _hit_mismatch(hits_by["f32"], direct_hits)
                check(bad is None, f"roll f32 hits differ from the direct "
                      f"sweep's: {bad}")
    finally:
        os.environ.pop("PUTPU_PRECISION", None)

    # the pulse's chunk: the roll f32 plane against B1's
    istart = max(direct_hits, key=lambda h: h[2].snr)[0]
    reader = FilterbankReader(str(path))
    raw = reader.read_block_tensor(istart, E2E_CHUNK, "cuda")
    chunk = clean_chunk(raw, torch.zeros(NCHAN, dtype=torch.bool,
                                         device="cuda"))
    del raw
    args = (DMMIN, DMMAX, START_FREQ, BANDWIDTH, TSAMP)
    t_b1, plane = dedispersion_search(chunk, *args, capture_plane=True,
                                      device="cuda")
    t_roll, plane_roll = dedispersion_search(
        chunk, *args, kernel="roll", precision="f32", capture_plane=True,
        device="cuda")
    torch.cuda.synchronize()
    check(torch.equal(plane_roll, plane), "the roll f32 plane differs from "
          f"B1's in {int((plane_roll != plane).sum())} cells")
    check(all(np.array_equal(t_roll[c], t_b1[c]) for c in t_b1),
          "the roll f32 table differs from B1's")
    del plane_roll, chunk

    # the spectral search of that plane under every policy
    scale = E2E_CHUNK * TSAMP
    spec, spectral = {}, {}
    for policy in B6_POLICIES:
        reset_counts()
        out = spectral_search(plane, TSAMP, policy=policy)
        torch.cuda.synchronize()
        counts = read_counts()
        key = "B6" if policy == "f32" else f"B6[{policy}]"
        check(counts[key] == 1, f"spectral_search {policy}: launches "
              f"{counts}")
        spec[policy] = {k: v.cpu().numpy() for k, v in out.items()}
        ms, runs = time_ms(torch, lambda policy=policy: spectral_search(
            plane, TSAMP, policy=policy))
        spectral[policy] = {"launches": counts[key], "launch_counts": counts,
                            "spectral_search_ms": ms,
                            "spectral_search_runs_ms": runs}
    ref = spec["f32"]
    ref_bins = np.rint(ref["freq"] * scale)
    for policy in B6_POLICIES:
        got = spec[policy]
        rtol = STRATEGIES[policy].score_rtol
        same = ((np.rint(got["freq"] * scale) == ref_bins)
                & (got["nharm"] == ref["nharm"]))
        rel = (np.abs(got["power"] - ref["power"])
               / np.maximum(np.abs(ref["power"]), 1e-30))
        rel_sigma = (np.abs(got["sigma"] - ref["sigma"])
                     / np.maximum(np.abs(ref["sigma"]), 1e-30))
        check(bool(np.all(np.isfinite(got["power"]))), f"spectral_search "
              f"{policy}: non-finite powers")
        check(bool(np.all(rel[same] <= rtol)), f"spectral_search {policy}: "
              f"power at the same bin and depth off by "
              f"{float(rel[same].max(initial=0.0))}, above rtol {rtol}")
        # a row whose best bin or depth moved is a near-tie of noise (of
        # bins, or of depths by false-alarm probability): its best
        # significance within the strategy's tolerance of f32's
        check(bool(np.all(rel_sigma[~same] <= rtol)), f"spectral_search "
              f"{policy}: {int((~same).sum())} rows moved, the largest "
              f"sigma change {float(rel_sigma[~same].max(initial=0.0))} "
              f"above rtol {rtol}")
        best = int(np.argmax(got["sigma"]))
        spectral[policy].update(
            rows=len(same), rows_same_bin_and_nharm=int(same.sum()),
            rows_moved=np.flatnonzero(~same).tolist()[:20],
            max_power_rel_diff_same_rows=float(rel[same].max(initial=0.0)),
            max_sigma_rel_diff_moved_rows=float(
                rel_sigma[~same].max(initial=0.0)),
            best_row={"row": best, "freq": float(got["freq"][best]),
                      "nharm": int(got["nharm"][best]),
                      "sigma": float(got["sigma"][best])},
            score_rtol=rtol)
    # B6 on that plane's power, the launch the search made, against its
    # plain version under every policy, every branch bit for bit
    shape = list(plane.shape)
    power = power_spectrum(plane)
    del plane
    plane_records = {policy: _harmonic_case(
        torch, np, "e2e_precision_plane", power, E2E_CHUNK, timed=True,
        policy=policy) for policy in B6_POLICIES}
    del power
    emit("e2e_precision_chunk", istart=int(istart),
         plane=shape, roll_f32_plane_equals_b1=True,
         b6_equals_plain_on_plane=True, spectral=spectral)
    torch.cuda.empty_cache()
    return {"runs": launches, "spectral": spectral,
            "plane_records": plane_records}


#: the periodic pulsar file: the e2e geometry, a pulse train at DM 400 on
#: an exact Fourier bin of the whole observation (~10 Hz), 2 ms wide, its
#: peak 3/8 of the per-channel noise (after the simulator's folded normal,
#: ~S/N 3 a sample dedispersed: weak single pulses, a strong periodicity)
PSR_BIN = 3277
PSR_FREQ = PSR_BIN / (E2E_NSAMPLES * TSAMP)


def _psr_match(freq, dm, spacing, t_obs):
    """The recovered frequency is the pulsar's (or an integer harmonic or
    sub-harmonic) within 1.5 / T_obs, its DM within five trials (a 2 ms
    wide pulse stays coherent over a few DM trials, so noise picks the
    best row among them)."""
    ratio = max(freq, PSR_FREQ) / min(freq, PSR_FREQ)
    r = round(ratio)
    freq_ok = r >= 1 and abs(ratio - r) * min(freq, PSR_FREQ) <= 1.5 / t_obs
    return bool(freq_ok and abs(dm - E2E_DM) <= 5 * spacing)


def _write_pulsar_file(np, path, seed):
    """The pulsar file: the end-to-end geometry, 8 bits, a ~10 Hz pulse
    train at DM 400."""
    from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
    from pulsarutils_tpu_torch.models.simulate import \
        simulate_accel_pulsar_data

    array, header = simulate_accel_pulsar_data(
        freq=PSR_FREQ, dm=E2E_DM, accel=0.0, tsamp=TSAMP,
        nsamples=E2E_NSAMPLES, nchan=NCHAN, start_freq=START_FREQ,
        bandwidth=BANDWIDTH, signal=3.0, noise=8.0, duty_cycle=0.02,
        floor=20.0, rng=seed + 5)
    write_simulated_filterbank(str(path), array, header, descending=True,
                               nbits=8)


def phase_e2e_period(torch, np, workdir, seed, written_s=None):
    """A periodic pulsar file (written here, or beforehand in
    ``written_s`` seconds by :func:`write_data_files`) searched per chunk
    (``period_search``) and by the full-observation periodicity job (with
    its canary)."""
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan
    from pulsarutils_tpu_torch.periodicity.driver import periodicity_search
    from pulsarutils_tpu_torch.pipeline.search_pipeline import \
        search_by_chunks

    path = workdir / "pulsar.fil"
    t0 = time.perf_counter()
    if written_s is None:
        _write_pulsar_file(np, path, seed)
    emit("e2e_period_file", path=path.name, nchan=NCHAN,
         nsamples=E2E_NSAMPLES, nbits=8, dm=E2E_DM, freq_hz=PSR_FREQ,
         bytes=path.stat().st_size,
         seconds=round(time.perf_counter() - t0 if written_s is None
                       else written_s, 3),
         written_beside_the_kernel_checks=written_s is not None)
    dms = dedispersion_plan(NCHAN, DMMIN, DMMAX, START_FREQ, BANDWIDTH,
                            TSAMP)
    spacing = float(dms[1] - dms[0])
    chunk_length = E2E_CHUNK // 2 * TSAMP
    common = dict(chunk_length=chunk_length, snr_threshold=8.0,
                  device="cuda")

    # 1. the per-chunk period stage of search_by_chunks
    stages, summary = {}, {}
    reset_counts()
    t0 = time.perf_counter()
    hits, store = search_by_chunks(
        str(path), dmmin=DMMIN, dmmax=DMMAX, period_search=True,
        make_plots=False, output_dir=str(workdir / "out_period"),
        stage_seconds=stages,
        summary=summary, **common)
    wall = time.perf_counter() - t0
    per_chunk = read_counts()
    check_clean_run(summary, "e2e_period_chunks")
    nchunks = len(store.done_chunks)
    check(nchunks == 4 and per_chunk["B6"] > 0 and per_chunk["B1"] > 0,
          f"period_search launches {per_chunk}, {nchunks} chunks")
    t_chunk = E2E_CHUNK * TSAMP
    found = [h for h in hits if h[2].period_freq is not None
             and _psr_match(h[2].period_freq, h[2].period_dm, spacing,
                            t_chunk)]
    check(len(found) == nchunks, f"pulsar found in {len(found)} of "
          f"{nchunks} chunks: {[(h[2].period_freq, h[2].period_dm, h[2].period_sigma) for h in hits]}")
    loop_s = wall - stages.get("badchans", 0.0)
    emit("e2e_period_chunks", chunks=nchunks, hits=len(hits),
         periodic=[{"istart": h[0], "freq": h[2].period_freq,
                    "dm": h[2].period_dm, "sigma": h[2].period_sigma,
                    "m": h[2].period_M} for h in hits],
         launches=per_chunk, wall_s=wall, chunk_loop_s=loop_s,
         chunks_per_s=nchunks / loop_s, stage_seconds=stages)

    # 2. the full-observation job with a small acceleration grid
    stages, summary = {}, {}
    reset_counts()
    t0 = time.perf_counter()
    res = periodicity_search(
        str(path), DMMIN, DMMAX, accel_max=1000.0, n_accel=5, canary=True,
        output_dir=str(workdir / "out_puperiod"), stage_seconds=stages,
        summary=summary, **common)
    wall = time.perf_counter() - t0
    job = read_counts()
    check_clean_run(summary, "e2e_puperiod")
    acc = res["accumulator"]
    t_obs = acc.nout * acc.tsamp
    check(res["complete"] and res["candidates"], "periodicity job: no "
          "candidates")
    best = res["candidates"][0]
    check(_psr_match(best["freq"], best["dm"], spacing, t_obs),
          f"periodicity job best candidate f={best['freq']} "
          f"DM={best['dm']} vs {PSR_FREQ} Hz, DM {E2E_DM}")
    check(res["canary"]["recovered"], f"canary missed: {res['canary']}")
    check(job["B6"] >= len(res["accels"]) and job["B1"] > 0,
          f"periodicity job launches {job}")
    emit("e2e_puperiod", chunks=len(acc.chunk_starts), ndm=acc.ndm,
         nout=acc.nout, rebin=acc.rebin, t_obs_s=t_obs,
         accels=[float(a) for a in res["accels"]],
         best={k: best[k] for k in ("dm", "accel", "freq", "freq_bin",
                                    "nharm", "sigma", "h", "m")},
         kept=len(res["candidates"]), sift=res["sift"],
         canary=res["canary"], launches=job, wall_s=wall,
         trial_sweep_s=res["seconds"]["trials"],
         fold_s=res["seconds"]["fold"], stage_seconds=stages)
    return {"period_search": per_chunk, "periodicity_search": job,
            "job": res, "job_dir": workdir / "out_puperiod",
            "trial_sweep_s": res["seconds"]["trials"]}


def _one_row(cand):
    """A candidate dict as a one-row trial table for
    ``accel_tables_match``."""
    import numpy as np

    return {k: np.array([cand[k]]) for k in (
        "dm_index", "accel_index", "jerk_index", "nharm", "freq", "sigma")}


def phase_e2e_fdas(torch, np, workdir, seed, period):
    """``accel_backend="fdas"`` on the card: (i) the JAX package's
    benchmark case (a jerked sinusoid on a synthetic 8 x 16384 plane, 9
    accelerations x 5 jerks) through ``fdas_search`` and ``accel_search``,
    each recovering the injected cell, the two tables equivalent; (ii)
    the pulsar file's periodicity job (514 x 655,360 plane, 5
    accelerations, the canary) with the FDAS backend, resumed from the
    time-stretch job's ledger and snapshot: the pulsar and the canary
    recovered, its best candidate equivalent to the time-stretch job's;
    (iii) ``fdas_search`` on the card against the CPU on one block of 8
    DM rows of that plane."""
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan
    from pulsarutils_tpu_torch.periodicity.accel import accel_search
    from pulsarutils_tpu_torch.periodicity.driver import periodicity_search
    from pulsarutils_tpu_torch.periodicity.fdas import fdas_search
    from pulsarutils_tpu_torch.tuning.autotune import (accel_tables_match,
                                                       synthetic_accel_plane)

    # (i) the benchmark case
    tsamp, nsamples, ndm = 5e-4, 16384, 8
    accels = np.linspace(-2e5, 2e5, 9)
    jerks = np.linspace(-5e4, 5e4, 5)
    inj_a, inj_j, inj_dm = 6, 3, ndm // 3
    k0 = int(round(0.175 * nsamples))
    f0 = k0 / (nsamples * tsamp)
    plane = torch.from_numpy(synthetic_accel_plane(
        ndm, nsamples, tsamp, float(accels[inj_a]),
        jerk=float(jerks[inj_j]), seed=20).astype(np.float32)).cuda()
    kw = dict(jerks=jerks, max_harmonics=1, fmax=1.25 * f0, topk=8,
              device="cuda")
    bench = {}
    tables = {}
    for name, fn in (("time_stretch", accel_search), ("fdas", fdas_search)):
        fn(plane, tsamp, accels, **kw)   # the warm-up
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tables[name] = fn(plane, tsamp, accels, **kw)
            walls.append(1e3 * (time.perf_counter() - t0))
        tbl = tables[name]
        cell = (int(tbl["dm_index"][0]), int(tbl["accel_index"][0]),
                int(tbl["jerk_index"][0]), int(tbl["freq_bin"][0]))
        want = (inj_dm, inj_a, inj_j, k0)
        check(cell[:3] == want[:3] and abs(cell[3] - k0) <= 1,
              f"{name}: top cell {cell}, injected {want}")
        bench[name] = {"wall_ms": statistics.median(walls),
                       "walls_ms": walls, "top_cell": cell,
                       "sigma": float(tbl["sigma"][0])}
    match = accel_tables_match(tables["time_stretch"], tables["fdas"])
    check(match, f"benchmark case: the backends' tables differ: {bench}")
    emit("e2e_fdas", case="benchmark", ndm=ndm, nsamples=nsamples,
         accels=len(accels), jerks=len(jerks), tables_match=match, **bench)

    # (ii) the pulsar file's job, resumed from the time-stretch job's files
    path = workdir / "pulsar.fil"
    dms = dedispersion_plan(NCHAN, DMMIN, DMMAX, START_FREQ, BANDWIDTH,
                            TSAMP)
    spacing = float(dms[1] - dms[0])
    stages, summary = {}, {}
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = periodicity_search(
        str(path), DMMIN, DMMAX, accel_max=1000.0, n_accel=5, canary=True,
        accel_backend="fdas", output_dir=str(period["job_dir"]),
        stage_seconds=stages, summary=summary,
        chunk_length=E2E_CHUNK // 2 * TSAMP, snr_threshold=8.0,
        device="cuda")
    wall = time.perf_counter() - t0
    job = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check_clean_run(summary, "e2e_fdas")
    acc = res["accumulator"]
    t_obs = acc.nout * acc.tsamp
    check(res["complete"] and res["candidates"]
          and res["accel_backend"] == "fdas", "fdas job: no candidates")
    best = res["candidates"][0]
    check(_psr_match(best["freq"], best["dm"], spacing, t_obs),
          f"fdas job best candidate f={best['freq']} DM={best['dm']} vs "
          f"{PSR_FREQ} Hz, DM {E2E_DM}")
    check(res["canary"]["recovered"], f"fdas canary missed: {res['canary']}")
    check(job["B6"] >= len(res["accels"]), f"fdas job launches {job}")
    stretch_best = period["job"]["candidates"][0]
    agree = accel_tables_match(_one_row(stretch_best), _one_row(best))
    check(agree, f"fdas best {best} vs time_stretch best {stretch_best}")
    emit("e2e_fdas", case="periodicity_job", ndm=acc.ndm, nout=acc.nout,
         accels=[float(a) for a in res["accels"]],
         best={k: best[k] for k in ("dm", "accel", "freq", "freq_bin",
                                    "nharm", "sigma")},
         time_stretch_best={k: stretch_best[k] for k in (
             "dm", "accel", "freq", "freq_bin", "nharm", "sigma")},
         tables_match=agree, canary=res["canary"], launches=job,
         wall_s=wall, trial_sweep_s=res["seconds"]["trials"],
         time_stretch_trial_sweep_s=period["trial_sweep_s"],
         peak_device_bytes=peak, bytes_before=base_bytes,
         peak_extra_bytes=peak - base_bytes, stage_seconds=stages)

    # (iii) the card against the CPU on one block of DM rows
    d0 = max(0, min(acc.ndm - 8, int(best["dm_index"]) - 4))
    block = np.ascontiguousarray(acc.plane[d0:d0 + 8], dtype=np.float32)
    kw = dict(max_harmonics=4, fmax=20.0, topk=16)
    card = fdas_search(block, acc.tsamp, [-1000.0, 0.0, 1000.0],
                       device="cuda", **kw)
    host = fdas_search(block, acc.tsamp, [-1000.0, 0.0, 1000.0],
                       device="cpu", **kw)
    discrete = all(np.array_equal(card[k], host[k]) for k in (
        "dm_index", "accel_index", "jerk_index", "freq_bin", "nharm"))
    rel = float(np.max(np.abs(card["sigma"] - host["sigma"])
                       / np.abs(host["sigma"])))
    check(discrete and rel <= 1e-4, f"fdas card vs CPU: discrete "
          f"{discrete}, sigma rel {rel}")
    emit("e2e_fdas", case="card_vs_cpu", rows=[d0, d0 + 8],
         discrete_equal=discrete, sigma_max_rel_diff=rel)
    del plane, block
    torch.cuda.empty_cache()
    return {"periodicity_search": job, "trial_sweep_s":
            res["seconds"]["trials"], "peak_extra_bytes": peak - base_bytes}


def _write_e2e_file(np, path, seed):
    from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
    from pulsarutils_tpu_torch.models.simulate import simulate_test_data

    array, header = simulate_test_data(
        E2E_DM, tsamp=TSAMP, nsamples=E2E_NSAMPLES, nchan=NCHAN,
        start_freq=START_FREQ, bandwidth=BANDWIDTH, signal=12.0, noise=8.0,
        rng=seed)
    array += 20.0
    write_simulated_filterbank(str(path), array, header, descending=True,
                               nbits=8)


def write_data_files(argv):
    """A child's entry (``python3 -c CODE WORKDIR SEED``): write the
    end-to-end and pulsar files (host NumPy simulations, ~1 min each) into
    WORKDIR and their seconds into ``WORKDIR/data_files.json``, while the
    parent times the kernels on the card."""
    import numpy as np

    sys.path.insert(0, str(REPO))
    workdir, seed = Path(argv[0]), int(argv[1])
    t0 = time.perf_counter()
    _write_e2e_file(np, workdir / "e2e.fil", seed)
    t1 = time.perf_counter()
    _write_pulsar_file(np, workdir / "pulsar.fil", seed)
    t2 = time.perf_counter()
    (workdir / "data_files.json").write_text(json.dumps(
        {"e2e_s": t1 - t0, "pulsar_s": t2 - t1}))
    return 0


def _start_data_writer(workdir, seed):
    """Start :func:`write_data_files` in a child process."""
    with open(workdir / "data_files.log", "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
             "chip_smoke.write_data_files(sys.argv[1:]))", str(workdir),
             str(seed)], cwd=str(REPO), stdout=fh, stderr=subprocess.STDOUT)
    _CHILDREN.append(proc)
    return proc


def _join_data_writer(proc, workdir):
    """Wait for the data files; their writing seconds."""
    rc = proc.wait(timeout=900)
    check(rc == 0, f"the data files' writer: rc {rc}: "
          f"{(workdir / 'data_files.log').read_text()[-3000:]}")
    return json.loads((workdir / "data_files.json").read_text())


def phase_end_to_end(torch, np, seed, workdir, written_s=None):
    """The e2e file (written here, or beforehand in ``written_s``
    seconds by :func:`write_data_files`) through ``search_by_chunks``."""
    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan
    from pulsarutils_tpu_torch.pipeline.search_pipeline import (
        clean_chunk, plan_survey, search_by_chunks)
    from pulsarutils_tpu_torch.ops.search import dedispersion_search

    path = workdir / "e2e.fil"
    t0 = time.perf_counter()
    if written_s is None:
        _write_e2e_file(np, path, seed)
    emit("e2e_file", path=path.name, nchan=NCHAN, nsamples=E2E_NSAMPLES,
         nbits=8, dm=E2E_DM, bytes=path.stat().st_size,
         seconds=round(time.perf_counter() - t0 if written_s is None
                       else written_s, 3),
         written_beside_the_kernel_checks=written_s is not None)

    chunk_length = E2E_CHUNK // 2 * TSAMP
    sp = plan_survey(str(path), chunk_length=chunk_length, dmmin=DMMIN,
                     dmmax=DMMAX)
    check(sp["plan"].step == E2E_CHUNK, f"chunk of {sp['plan'].step}")
    dms = dedispersion_plan(NCHAN, DMMIN, DMMAX, START_FREQ, BANDWIDTH,
                            TSAMP)
    stages, summary = {}, {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    hits, store = search_by_chunks(
        str(path), chunk_length=chunk_length, dmmin=DMMIN, dmmax=DMMAX,
        snr_threshold=8.0, output_dir=str(workdir / "out"), device="cuda",
        make_plots=False, stage_seconds=stages, summary=summary)
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_clean_run(summary, "e2e_search")
    launches = counts["B1"]
    nchunks = len(sp["chunk_starts"])
    loop_s = wall - stages.get("badchans", 0.0)
    check(launches == 2 * nchunks and counts["B4"] == launches,
          f"{launches} sweep and {counts['B4']} scorer launches for "
          f"{nchunks} chunks")
    check(store.done_chunks == sp["chunk_starts"], "ledger incomplete")
    check(Path(store._ledger_path).is_file(), "no ledger file")
    check(hits, "the injected pulse was not found")
    pulse_t = E2E_NSAMPLES // 2
    istart, iend, info, table = max(hits, key=lambda h: h[2].snr)
    spacing = float(dms[1] - dms[0])
    check(istart <= pulse_t < iend, f"best hit in chunk {istart}-{iend}")
    check(abs(info.dm - E2E_DM) <= spacing,
          f"DM {info.dm} vs injected {E2E_DM} (spacing {spacing})")
    check(table.nrows == len(dms) and np.isfinite(table["snr"]).all(),
          "hit table shape or values")
    check(all(store.load_candidate(path.stem, h[0], h[1])[0].dm == h[2].dm
              for h in hits), "persisted candidates")
    emit("e2e_search", chunks=nchunks, chunk_samples=E2E_CHUNK,
         trials=len(dms), launches=launches, hits=len(hits),
         best={"istart": istart, "iend": iend, "dm": info.dm,
               "snr": info.snr, "width_s": info.width},
         dm_spacing=spacing, wall_s=wall, chunk_loop_s=loop_s,
         chunks_per_s=nchunks / loop_s,
         dm_trials_per_s=nchunks * len(dms) / loop_s,
         stage_seconds=stages,
         peak_device_bytes=torch.cuda.max_memory_allocated())

    # the device path against the CPU path, on the pulse's chunk
    reader = FilterbankReader(str(path))
    mask = torch.zeros(NCHAN, dtype=torch.bool)
    raw = reader.read_block_tensor(istart, E2E_CHUNK, "cpu")
    clean_cpu = clean_chunk(raw, mask)
    clean_gpu = clean_chunk(raw.cuda(), mask.cuda()).cpu()
    clean_diff = float((clean_gpu - clean_cpu).abs().max())
    check(clean_diff <= 1e-4, f"clean: GPU vs CPU max |diff| {clean_diff}")
    cut = clean_gpu[:128, :1 << 16]
    args = (DMMIN, DMMAX, START_FREQ, BANDWIDTH, TSAMP)
    t_gpu = dedispersion_search(cut, *args, device="cuda")
    t_cpu = dedispersion_search(cut, *args, device="cpu")
    for col in ("DM", "rebin", "peak"):
        check(np.array_equal(t_gpu[col], t_cpu[col]), f"search {col}")
    snr_rel = float(np.max(np.abs(t_gpu["snr"] - t_cpu["snr"])
                           / np.abs(t_cpu["snr"])))
    check(snr_rel <= 1e-5, f"search snr rel diff {snr_rel}")
    emit("e2e_reference", clean_max_abs_diff=clean_diff,
         search_cut=list(cut.shape), search_snr_max_rel_diff=snr_rel)
    return counts, hits, path, chunk_length, nchunks


#: e2e_overlap: the e2e geometry over 7 blocks of 2^17 samples (6 chunks
#: of 2^18 at 50% overlap, 0.94 GB; depth cut from 12 chunks), a DM 400
#: pulse mid-block in these blocks: chunks 0-1 and 3-4 hold one, 2 and 5
#: none
OVERLAP_BLOCKS = 7
OVERLAP_PULSE_BLOCKS = (1, 4)


def _write_block_file(torch, np, path, nchan, nblocks, block, pulse_blocks,
                      seed):
    """An 8-bit descending-band filterbank written block by block (host
    memory stays at one block): the seeded simulator's model
    (``models/simulate.simulate_test_data``: ``|N(impulse, 8)|`` noise,
    an impulse of 12 mid-block in every channel of ``pulse_blocks``,
    channels rolled by their DM 400 delays), plus 20, drawn on the card
    from a generator seeded with ``seed`` and rounded as the writer
    rounds."""
    from pulsarutils_tpu_torch.io.sigproc import (FilterbankWriter,
                                                  header_from_simulated)
    from pulsarutils_tpu_torch.ops.plan import dedispersion_shifts

    sim = {"nchans": nchan, "bandwidth": BANDWIDTH, "fbottom": START_FREQ,
           "tsamp": TSAMP}
    header = {"nchans": nchan, "nbits": 8, "nifs": 1, "tstart": 0.0,
              "source_name": "chip_smoke", "machine_id": 0,
              "telescope_id": 0, "data_type": 1,
              **header_from_simulated(sim, descending=True)}
    shifts = np.rint(dedispersion_shifts(nchan, E2E_DM, START_FREQ,
                                         BANDWIDTH, TSAMP)).astype(np.int64)
    idx = ((torch.arange(block, device="cuda")[None, :]
            - torch.from_numpy(shifts).cuda()[:, None]) % block)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    with FilterbankWriter(str(path), header) as writer:
        for b in range(nblocks):
            x = torch.randn((nchan, block), generator=gen, device="cuda")
            x *= 8.0
            if b in pulse_blocks:
                x[:, block // 2] += 12.0
            x = torch.gather(x.abs_(), 1, idx) + 20.0
            writer.write_block(x.flip(0).cpu().numpy())  # file order
            del x
    torch.cuda.empty_cache()


def _snapshot(np, outdir):
    """Ledger bytes and every candidate file's members, byte for byte."""
    out = {}
    for name in sorted(p.name for p in outdir.iterdir()):
        if name.startswith("progress_"):
            out[name] = (outdir / name).read_bytes()
        elif name.endswith(".npz"):
            with np.load(outdir / name, allow_pickle=False) as d:
                out[name] = {k: d[k].tobytes() for k in d.files}
    return out


def _tables_equal(np, ours, ref):
    """Two hit lists with equal chunks and every table column equal."""
    if [h[:2] for h in ours] != [h[:2] for h in ref]:
        return False
    return all(np.array_equal(a[3][c], b[3][c])
               for a, b in zip(ours, ref) for c in b[3].colnames)


def phase_e2e_overlap(torch, np, workdir, seed):
    """The chunk loop on a 6-chunk file: serial (``overlap_persist=
    False``) and overlapped runs in the order S, O, O, S, each into a
    fresh directory.  Every run: equal hits and tables, byte-equal
    ledgers and candidate files, B1 and B4 twice a chunk, no fallback."""
    from pulsarutils_tpu_torch.pipeline.search_pipeline import (
        plan_survey, search_by_chunks)
    from pulsarutils_tpu_torch.pipeline.spectral_stats import get_bad_chans

    path = workdir / "overlap.fil"
    t0 = time.perf_counter()
    _write_block_file(torch, np, path, NCHAN, OVERLAP_BLOCKS, E2E_CHUNK // 2,
                      OVERLAP_PULSE_BLOCKS, seed + 11)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    get_bad_chans(str(path))  # the cache, before the timed runs
    badchans_s = time.perf_counter() - t0
    chunk_length = E2E_CHUNK // 2 * TSAMP
    sp = plan_survey(str(path), chunk_length=chunk_length, dmmin=DMMIN,
                     dmmax=DMMAX)
    nchunks = len(sp["chunk_starts"])
    check(nchunks == OVERLAP_BLOCKS - 1, f"overlap file: {nchunks} chunks")
    emit("e2e_overlap_file", path=path.name, nchan=NCHAN,
         nsamples=OVERLAP_BLOCKS * E2E_CHUNK // 2, nbits=8, dm=E2E_DM,
         pulse_blocks=list(OVERLAP_PULSE_BLOCKS),
         bytes=path.stat().st_size, write_s=write_s, badchans_s=badchans_s)
    runs, first = [], None
    for i, overlap in enumerate((False, True, True, False)):
        label = f"{i + 1}_{'overlapped' if overlap else 'serial'}"
        out = workdir / f"out_overlap_{label}"
        stages, summary = {}, {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        hits, store = search_by_chunks(
            str(path), chunk_length=chunk_length, dmmin=DMMIN, dmmax=DMMAX,
            snr_threshold=8.0, output_dir=str(out), device="cuda",
            make_plots=False, stage_seconds=stages, summary=summary,
            overlap_persist=overlap)
        wall = time.perf_counter() - t0
        counts = read_counts()
        check_clean_run(summary, f"e2e_overlap {label}")
        check(counts["B1"] == 2 * nchunks and counts["B4"] == 2 * nchunks,
              f"e2e_overlap {label}: launches {counts} for {nchunks} chunks")
        check(store.done_chunks == sp["chunk_starts"],
              f"e2e_overlap {label}: ledger")
        # each pulse block lies in two chunks; two may miss S/N 8
        check(len(hits) >= 2 * len(OVERLAP_PULSE_BLOCKS) - 2,
              f"e2e_overlap {label}: {len(hits)} hits")
        snap = _snapshot(np, out)
        loaded = [store.load_candidate(path.stem, h[0], h[1])
                  for h in hits]
        if first is None:
            first = (hits, snap, loaded)
        else:
            check(_tables_equal(np, hits, first[0]),
                  f"e2e_overlap {label}: hits differ from run 1")
            check(snap == first[1], f"e2e_overlap {label}: ledger or "
                  "candidate bytes differ from run 1")
            for (info, table), (rinfo, rtable) in zip(loaded, first[2]):
                check(np.array_equal(info.allprofs, rinfo.allprofs)
                      and info.dm == rinfo.dm and info.snr == rinfo.snr
                      and all(np.array_equal(table[c], rtable[c])
                              for c in rtable.colnames),
                      f"e2e_overlap {label}: loaded candidates differ")
        loop_s = wall - stages.get("badchans", 0.0)
        rec = dict(run=label, overlap_persist=overlap, chunks=nchunks,
                   hits=len(hits), launches=counts, wall_s=wall,
                   chunk_loop_s=loop_s, chunks_per_s=nchunks / loop_s,
                   stage_seconds=stages,
                   peak_device_bytes=torch.cuda.max_memory_allocated(),
                   fallback=summary.get("fallback"),
                   oom_descents=summary.get("oom_descents"))
        emit("e2e_overlap", **rec)
        runs.append(rec)
        shutil.rmtree(out, ignore_errors=True)
    path.unlink()
    return runs


def _counter_deltas(before):
    from pulsarutils_tpu_torch.obs.metrics import REGISTRY

    now = {}
    for m in REGISTRY.snapshot():
        if m["type"] != "counter":
            continue
        key = m["name"] + "".join(f"{{{k}={v}}}"
                                  for k, v in sorted(m["labels"].items()))
        now[key] = m["value"]
    if before is None:
        return now
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def phase_e2e_faults(torch, np, workdir, path, chunk_length, nchunks, seed):
    """The failure drill on the card: each scenario arms a FaultPlan and
    checks its outcome against a clean run of the same file."""
    from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec
    from pulsarutils_tpu_torch.faults import inject
    from pulsarutils_tpu_torch.faults.policy import join_abandoned
    from pulsarutils_tpu_torch.ops.search import ladder_blocks
    from pulsarutils_tpu_torch.pipeline.search_pipeline import (
        plan_survey, search_by_chunks)

    common = dict(chunk_length=chunk_length, dmmin=DMMIN, dmmax=DMMAX,
                  snr_threshold=8.0, device="cuda", make_plots=False)
    starts = plan_survey(str(path), **{k: common[k] for k in (
        "chunk_length", "dmmin", "dmmax")})["chunk_starts"]
    pulse_t = E2E_NSAMPLES // 2
    hit_chunks = [s for s in starts if s <= pulse_t < s + E2E_CHUNK]
    noise_chunk = starts[0]
    check(noise_chunk not in hit_chunks and len(hit_chunks) == 2,
          f"drill chunks {starts}, hits in {hit_chunks}")

    def run(label, specs=(), out=None, expect_error=False, **kw):
        """One drill run; with ``expect_error`` an exception out of the
        search is returned as ``error`` for the scenario to check."""
        out = workdir / f"out_drill_{label}" if out is None else out
        plan = FaultPlan([FaultSpec(**s) for s in specs])
        before = _counter_deltas(None)
        summary, stages = {}, {}
        hits, store, error = [], None, None
        reset_counts()
        t0 = time.perf_counter()
        inject.arm(plan)
        try:
            hits, store = search_by_chunks(
                str(path), output_dir=str(out), summary=summary,
                stage_seconds=stages, **{**common, **kw})
        except Exception as exc:  # noqa: BLE001 — checked by the scenario
            if not expect_error:
                raise
            error = exc
        finally:
            inject.disarm()
        return dict(label=label, hits=hits, store=store, out=out,
                    summary=summary, plan=plan, error=error,
                    seconds=time.perf_counter() - t0,
                    counters=_counter_deltas(before), launches=read_counts())

    def report(r, **extra):
        store = r["store"]
        emit("e2e_faults", scenario=r["label"], seconds=r["seconds"],
             fired=r["plan"].fired(), counters=r["counters"],
             launches=r["launches"], hits=[h[0] for h in r["hits"]],
             error=None if r["error"] is None else repr(r["error"]),
             done=None if store is None else store.done_chunks,
             quarantined=None if store is None else store.quarantined_chunks,
             summary={k: r["summary"].get(k) for k in (
                 "searched", "quarantined", "fallback", "oom_descents")},
             **extra)

    def manifest(r):
        p = r["out"] / f"quarantine_{r['store'].fingerprint}.jsonl"
        return ([json.loads(line) for line in p.read_text().splitlines()]
                if p.exists() else [])

    clean = run("clean")
    check_clean_run(clean["summary"], "e2e_faults clean")
    base = _snapshot(np, clean["out"])
    report(clean)

    # a transient dispatch error: one retry, no fallback, equal tables
    r = run("dispatch_transient", [dict(
        site="dispatch", kind="error", chunks=(hit_chunks[0],))])
    check(r["plan"].fired() == 1
          and r["counters"].get("putpu_dispatch_retries_total") == 1,
          f"dispatch_transient: {r['counters']}")
    check(r["summary"]["fallback"] is None, "dispatch_transient fell back")
    check(_tables_equal(np, r["hits"], clean["hits"])
          and _snapshot(np, r["out"]) == base,
          "dispatch_transient: tables or files differ from the clean run")
    report(r)

    # the two scenarios whose corrupted chunk goes through the host
    # float64 path run on quarter chunks (2^16 samples) of the noise chunk
    # and the pulse's chunks, against a clean run of that geometry: the
    # same checks at a quarter of the host work
    short = dict(chunk_length=E2E_CHUNK // 8 * TSAMP)
    short_starts = plan_survey(str(path), dmmin=DMMIN, dmmax=DMMAX,
                               **short)["chunk_starts"]
    short_noise = short_starts[0]
    subset = [short_noise] + [s for s in short_starts
                              if s <= pulse_t < s + E2E_CHUNK // 4]
    check(len(subset) == 3, f"drill quarter chunks {subset}")
    clean_short = run("clean_quarter", chunks=subset, **short)
    check_clean_run(clean_short["summary"], "e2e_faults clean_quarter")
    check(clean_short["hits"], "e2e_faults clean_quarter: no hit")
    base_short = _snapshot(np, clean_short["out"])
    report(clean_short)

    # NaNs below the threshold in one chunk: sanitized, equal hits
    r = run("nan_sanitized", [dict(
        site="corrupt", kind="nan", chunks=(short_noise,), frac=0.02)],
        chunks=subset, **short)
    check(r["counters"].get("putpu_chunks_sanitized_total") == 1
          and not r["store"].quarantined_chunks,
          f"nan_sanitized: {r['counters']}")
    check(_tables_equal(np, r["hits"], clean_short["hits"])
          and _snapshot(np, r["out"]) == base_short,
          "nan_sanitized: hits or files differ from the clean run")
    report(r)

    # a hard corruption: quarantined, recorded; a resumed run searches
    # nothing
    r = run("hard_corrupt", [dict(
        site="corrupt", kind="nan", chunks=(short_noise,), frac=0.9)],
        chunks=subset, **short)
    recs = manifest(r)
    check(r["store"].quarantined_chunks
          == {str(short_noise): "integrity:nan_frac"}
          and [(x["chunk"], x["reason"]) for x in recs]
          == [(short_noise, "integrity:nan_frac")],
          f"hard_corrupt: {r['store'].quarantined_chunks}, {recs}")
    check(_tables_equal(np, r["hits"], clean_short["hits"]),
          "hard_corrupt: hits differ from the clean run")
    again = run("hard_corrupt_resumed", [dict(
        site="corrupt", kind="nan", chunks=(short_noise,), frac=0.9)],
        out=r["out"], chunks=subset, **short)
    check(again["summary"]["searched"] == 0 and again["plan"].fired() == 0,
          f"hard_corrupt resume searched {again['summary']['searched']}")
    report(r, manifest=recs)
    report(again)

    # a persist error: transient, retried; persistent, dead-lettered
    r = run("persist_transient", [dict(site="persist", kind="error")],
            persist_backoff=0.01)
    check(r["counters"].get("putpu_persist_retries_total") == 1
          and _snapshot(np, r["out"]) == base,
          f"persist_transient: {r['counters']}")
    report(r)
    r = run("persist_persistent", [dict(
        site="persist", kind="error", times=None)], persist_backoff=0.01)
    recs = manifest(r)
    dead = {str(c): "persist_dead_letter" for c in hit_chunks}
    check(r["store"].quarantined_chunks == dead
          and sorted(x["chunk"] for x in recs) == hit_chunks
          and all(x["reason"] == "persist_dead_letter" for x in recs),
          f"persist_persistent: {r['store'].quarantined_chunks}, {recs}")
    report(r, manifest=recs)

    # a persistent read error on one chunk: read_error, the rest searched
    last = starts[-1]
    r = run("read_error", [dict(site="read", kind="error",
                                      chunks=(last,), times=None)])
    check(r["store"].quarantined_chunks == {str(last): "read_error"}
          and r["store"].done_chunks == starts
          and r["counters"].get("putpu_read_retries_total") == 2,
          f"read_error: {r['store'].quarantined_chunks} {r['counters']}")
    check(_tables_equal(np, r["hits"],
                        [h for h in clean["hits"] if h[0] != last]),
          "read_error: the other chunks' hits differ")
    report(r)

    # torch.OutOfMemoryError at the dispatch seam: the ladder descends and
    # the tables are the undisturbed run's bit for bit
    r = run("oom_dispatch", [dict(site="dispatch", kind="oom",
                                        chunks=(hit_chunks[0],))])
    check(r["summary"]["oom_descents"] >= 1
          and r["summary"]["fallback"] is None,
          f"oom_dispatch: {r['summary']}")
    check(_tables_equal(np, r["hits"], clean["hits"])
          and _snapshot(np, r["out"]) == base,
          "oom_dispatch: tables or files differ from the clean run")
    check(r["launches"]["B1"] > 2 * nchunks,
          f"oom_dispatch: {r['launches']} (smaller superblocks)")
    report(r)

    # a 5 s hang under a 1 s deadline: the chunk moves on within the bound
    r = run("dispatch_hang", [dict(
        site="dispatch", kind="hang", seconds=5.0, chunks=(noise_chunk,))],
        dispatch_timeout=1.0)
    alive = join_abandoned(60.0)
    check(alive == 0, f"dispatch_hang: {alive} watchdog threads alive")
    check(r["summary"]["fallback"] is None
          and r["counters"].get("putpu_dispatch_retries_total") == 1
          and _tables_equal(np, r["hits"], clean["hits"]),
          f"dispatch_hang: {r['summary']} {r['counters']}")
    check(r["seconds"] < clean["seconds"] + 4.0,
          f"dispatch_hang: {r['seconds']} s against the clean "
          f"{clean['seconds']} s")
    report(r)

    # a persistent OOM at the dispatch seam: the ladder descends until
    # the sweep is one trial block a launch, then the chunk is quarantined
    # as oom_floor; the other chunks are searched in the floor's
    # superblocks, with the clean run's tables
    floor_descents = (ladder_blocks(clean["hits"][0][3].nrows)
                      - 1).bit_length()
    r = run("oom_floor", [dict(site="dispatch", kind="oom",
                               chunks=(noise_chunk,), times=None)])
    check(r["store"].quarantined_chunks == {str(noise_chunk): "oom_floor"}
          and r["counters"].get("putpu_oom_floor_total") == 1
          and r["summary"]["oom_descents"] == floor_descents
          and r["summary"]["fallback"] is None
          and r["plan"].fired() == floor_descents + 1,
          f"oom_floor: {r['store'].quarantined_chunks} {r['summary']} "
          f"{r['counters']}")
    check(_tables_equal(np, r["hits"], clean["hits"]),
          "oom_floor: the other chunks' hits differ from the clean run")
    report(r, manifest=manifest(r))

    # a persistent dispatch fault: on the card the error propagates after
    # its one retry; nothing falls back to the host, nothing is marked
    r = run("dispatch_persistent", [dict(site="dispatch", kind="error",
                                         times=None)], expect_error=True)
    check(isinstance(r["error"], RuntimeError)
          and "injected dispatch error" in str(r["error"])
          and r["plan"].fired() == 2
          and not r["counters"].get("putpu_fallbacks_total{stage=search}")
          and not any(p.name.startswith("progress_")
                      for p in r["out"].iterdir()),
          f"dispatch_persistent: {r['error']!r}, fired "
          f"{r['plan'].fired()}, {r['counters']}")
    report(r)


#: e2e_observe: the hits' snr with the canary in every chunk against the
#: plain run's (the bump moves the chunk's bandpass and row statistics)
OBSERVE_SNR_RTOL = 1e-2

#: device trace events that occupy the card (the profiler's categories)
DEVICE_BUSY_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_share(trace_path):
    """The card's busy share over the chunk loop, from a ``torch.profiler``
    Chrome trace: the union of its CUDA kernel, copy and set intervals,
    clipped to the loop's window (the first ``chunk`` range's start to the
    end of the last ``chunk`` or ``persist_drain`` range, the spans the
    driver annotates), over the window.  Returns ``(share, window_s,
    busy_s, device_events)``; the share is None without device events."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") in ("chunk", "persist_drain")]
    check(marks, f"{trace_path}: no chunk ranges in the device trace")
    lo = min(float(e["ts"]) for e in marks if e["name"] == "chunk")
    hi = max(float(e["ts"]) + float(e["dur"]) for e in marks)
    spans = sorted((max(float(e["ts"]), lo),
                    min(float(e["ts"]) + float(e["dur"]), hi))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in DEVICE_BUSY_CATS)
    spans = [(a, b) for a, b in spans if b > a]
    busy, end = 0.0, lo
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = hi - lo
    return (busy / window if spans else None, window / 1e6, busy / 1e6,
            len(spans))


def _checked_busy_share(trace_path, label):
    """:func:`device_busy_share` of a run's device trace, which must exist
    and hold CUDA events inside the loop's window."""
    check(trace_path.is_file(), f"{label}: no device trace at {trace_path}")
    busy = device_busy_share(trace_path)
    check(busy[3] > 0 and busy[0] is not None,
          f"{label}: the device trace holds no CUDA kernel or copy event "
          f"in the chunk loop")
    return busy


def parse_prometheus(text):
    """``{(name, labels): value}`` of a Prometheus text exposition; raises
    CheckFailed on a line that does not parse."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name, _, labels = head.partition("{")
        check(name and name.replace("_", "").isalnum(),
              f"prometheus line {line!r}")
        try:
            out[(name, labels.rstrip("}"))] = float(value)
        except ValueError:
            raise CheckFailed(f"prometheus value in {line!r}") from None
    return out


class _LogCapture:
    """Records of the package's logger during a block (INFO and up)."""

    def __init__(self):
        import logging

        self.records = []
        self.logger = logging.getLogger("pulsarutils_tpu_torch")
        self.handler = logging.Handler()
        self.handler.emit = self.records.append

    def __enter__(self):
        import logging

        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)

    def lines(self, prefix):
        return [r.getMessage()[len(prefix):].strip() for r in self.records
                if r.getMessage().startswith(prefix)]


def _webhook_sink():
    """A webhook on 127.0.0.1 that records the JSON bodies posted to it:
    ``(server, thread, received)``."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    received = []

    class Sink(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 — http.server API
            n = int(self.headers.get("Content-Length") or 0)
            received.append(json.loads(self.rfile.read(n).decode()))
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, received


def _figure_arrays_on_card(torch, np, path, hit):
    """The diagnostic figure's arrays of a hit chunk, computed on the card
    at its full size (what the plot path reads back), timed; and on a cut
    of the chunk (128 channels, 2^15 samples), against the same function
    on the CPU (the light curves and images within rtol 1e-5, the H curve
    too with its argmax equal)."""
    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader
    from pulsarutils_tpu_torch.ops.search import dedispersion_search
    from pulsarutils_tpu_torch.pipeline.diagnostics import figure_arrays
    from pulsarutils_tpu_torch.pipeline.pulse_info import PulseInfo
    from pulsarutils_tpu_torch.pipeline.search_pipeline import clean_chunk

    istart = hit[0]
    reader = FilterbankReader(str(path))
    mask = torch.zeros(NCHAN, dtype=torch.bool, device="cuda")
    chunk = clean_chunk(reader.read_block_tensor(istart, E2E_CHUNK, "cuda"),
                        mask)
    out = {}
    for label, data in (("chunk", chunk), ("cut", chunk[:128, :1 << 15])):
        data = data.contiguous()
        table, plane = dedispersion_search(
            data, DMMIN, DMMAX, START_FREQ, BANDWIDTH, TSAMP,
            capture_plane=True, device="cuda")
        info = PulseInfo(allprofs=data, start_freq=START_FREQ,
                         bandwidth=BANDWIDTH, nbin=data.shape[1],
                         nchan=data.shape[0],
                         pulse_freq=1.0 / (data.shape[1] * TSAMP))
        figure_arrays(info, table, plane)           # warm
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = figure_arrays(info, table, plane)
            walls.append(time.perf_counter() - t0)
        out[label] = {"shape": list(data.shape), "plane_rows": table.nrows,
                      "window": got["window"],
                      "seconds": statistics.median(walls),
                      "images": {k: list(got[k].shape)
                                 for k in ("raw", "dedisp", "plane")}}
        if label == "cut":
            want = figure_arrays(
                PulseInfo(allprofs=data.cpu(), start_freq=START_FREQ,
                          bandwidth=BANDWIDTH, nbin=data.shape[1],
                          nchan=data.shape[0],
                          pulse_freq=1.0 / (data.shape[1] * TSAMP)),
                table, plane.cpu())
            for k in ("lc_raw", "lc_dedisp", "h", "raw", "dedisp",
                      "plane"):
                check(np.allclose(got[k], want[k], rtol=1e-5, atol=1e-5),
                      f"figure arrays: {k} on the card differs from the CPU")
            check(np.argmax(got["h"]) == np.argmax(want["h"]),
                  "figure arrays: H curve argmax")
        del table, plane
    del chunk
    torch.cuda.empty_cache()
    return out


def phase_e2e_observe(torch, np, workdir, path, chunk_length, nchunks):
    """The e2e file with the direct sweep at S/N 8: one plain run, one
    under the span tracer and the device profiler alone, then one with
    every observer on — plots of the hits, the survey report,
    the span trace and the ``torch.profiler`` device trace with roofline
    accounting, a ``.prom`` metrics file, the HTTP surface on an
    ephemeral port scraped from a thread during the loop, the canary on
    every chunk, lineage, and push to a webhook served here.  The science
    hits and the ledger bytes must equal the plain run's, B1 and B4 launch
    as often, the canary be recovered in every chunk, ``/healthz``
    answer, the Prometheus text parse and hold the loop's counters, a
    JPEG exist per hit (or matplotlib be missing, said so), the
    ``BUDGET_JSON`` line be logged, and both device traces hold CUDA
    events inside the chunk loop."""
    import threading
    import urllib.error
    import urllib.request

    from pulsarutils_tpu_torch.obs import metrics as obs_metrics
    from pulsarutils_tpu_torch.obs import roofline, trace
    from pulsarutils_tpu_torch.obs.canary import CanaryController
    from pulsarutils_tpu_torch.pipeline.search_pipeline import \
        search_by_chunks

    common = dict(chunk_length=chunk_length, dmmin=DMMIN, dmmax=DMMAX,
                  snr_threshold=8.0, device="cuda")
    stages, summary = {}, {}
    reset_counts()
    t0 = time.perf_counter()
    with _LogCapture() as plain_log:
        plain, plain_store = search_by_chunks(
            str(path), output_dir=str(workdir / "obs_plain"),
            make_plots=False, stage_seconds=stages, summary=summary,
            **common)
    plain_call = time.perf_counter() - t0 - stages.get("badchans", 0.0)
    plain_counts = read_counts()
    check_clean_run(summary, "e2e_observe plain")
    plain_budget = json.loads(plain_log.lines("BUDGET_JSON")[0])

    # the plain run again under the span tracer and the device profiler
    # alone: the loop's own busy share, without the canary's host work
    traced_dir = workdir / "traced_trace.json_device"
    stages_tr, summary_tr = {}, {}
    with _LogCapture() as traced_log:
        with trace.trace_session(str(workdir / "traced_trace.json"),
                                 device_trace_dir=str(traced_dir)):
            traced, traced_store = search_by_chunks(
                str(path), output_dir=str(workdir / "obs_traced"),
                make_plots=False, stage_seconds=stages_tr,
                summary=summary_tr, **common)
    check_clean_run(summary_tr, "e2e_observe traced")
    bad = _hit_mismatch(traced, plain)
    check(bad is None, f"e2e_observe traced: hits differ: {bad}")
    check(Path(traced_store._ledger_path).read_bytes()
          == Path(plain_store._ledger_path).read_bytes(),
          "e2e_observe traced: ledger bytes differ from the plain run's")
    traced_budget = json.loads(traced_log.lines("BUDGET_JSON")[0])
    traced_busy = _checked_busy_share(traced_dir / trace.DEVICE_TRACE_FILE,
                                      "e2e_observe traced")

    try:
        import matplotlib  # noqa: F401
        plots = True
    except ImportError:
        plots = False
        print("plots: skipped (no matplotlib)", flush=True)
    out = workdir / "obs_on"
    trace_path = workdir / "observe_trace.json"
    device_dir = Path(str(trace_path) + "_device")
    sink, sink_thread, received = _webhook_sink()
    canary = CanaryController(rate=1.0, snr=12.0)
    scrapes = {"/healthz": [], "/metrics": []}
    stop = threading.Event()

    def scrape(log):
        """Scrape the surface until ``stop``; its port comes from the
        driver's log line."""
        port = None
        while not stop.is_set():
            if port is None:
                found = log.lines("live search surface on http://")
                port = int(found[0].split(":")[1].split()[0]) if found \
                    else None
            for endpoint in (scrapes if port is not None else ()):
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{endpoint}",
                            timeout=5) as r:
                        scrapes[endpoint].append((r.status,
                                                  r.read().decode()))
                except urllib.error.HTTPError as exc:
                    scrapes[endpoint].append((exc.code, ""))
                except OSError:
                    pass
            stop.wait(0.05)

    stages_on, summary_on = {}, {}
    roofline.reset()
    roofline.enable()
    try:
        with _LogCapture() as log:
            scraper = threading.Thread(target=scrape, args=(log,),
                                       daemon=True)
            scraper.start()
            reset_counts()
            t0 = time.perf_counter()
            try:
                with trace.trace_session(str(trace_path),
                                         device_trace_dir=str(device_dir)):
                    hits, store = search_by_chunks(
                        str(path), output_dir=str(out), make_plots="hits",
                        report_out=str(workdir / "observe_report"),
                        http_port=0, canary=canary, lineage=True,
                        push=[f"http://127.0.0.1:{sink.server_port}/alert"],
                        stage_seconds=stages_on, summary=summary_on,
                        **common)
                on_wall = time.perf_counter() - t0
            finally:
                stop.set()
                scraper.join()
            counts = read_counts()
        prom_path = workdir / "observe_metrics.prom"
        obs_metrics.REGISTRY.write_prometheus(str(prom_path))
    finally:
        roofline.disable()
        sink.shutdown()
        sink.server_close()
        sink_thread.join()
    on_call = on_wall - stages_on.get("badchans", 0.0)
    check_clean_run(summary_on, "e2e_observe")

    # the canary's bump moves each chunk's bandpass and row statistics a
    # little: the pulse's snr within OBSERVE_SNR_RTOL, the rest exact
    bad = _hit_mismatch(hits, plain, snr_rtol=OBSERVE_SNR_RTOL)
    check(bad is None, f"e2e_observe: hits differ from the plain run: {bad}")
    check(Path(store._ledger_path).read_bytes()
          == Path(plain_store._ledger_path).read_bytes(),
          "e2e_observe: ledger bytes differ from the plain run's")
    for k in ("B1", "B4"):
        check(counts[k] == plain_counts[k], f"e2e_observe: {k} launched "
              f"{counts[k]} times, the plain run {plain_counts[k]}")
    jpegs = sorted(p.name for p in out.glob("*.jpg"))
    if plots:
        check(jpegs == sorted(f"{path.stem}_{h[0]}-{h[1]}.jpg"
                              for h in hits),
              f"e2e_observe: JPEGs {jpegs} for hits "
              f"{[(h[0], h[1]) for h in hits]}")
    recall = canary.summary()
    check(recall["injected"] == nchunks and recall["recall"] == 1.0,
          f"e2e_observe: canary {recall}")
    health = [s for s, _ in scrapes["/healthz"]]
    check(health and all(s in (200, 503) for s in health),
          f"e2e_observe: /healthz answered {health[:5]}")
    live = [t for s, t in scrapes["/metrics"] if s == 200]
    check(live, "e2e_observe: /metrics never answered")
    parse_prometheus(live[-1])
    prom = parse_prometheus(prom_path.read_text())
    for name in ("putpu_chunks_total", "putpu_hits_total",
                 "putpu_dispatches_total", "putpu_bytes_uploaded_total",
                 "putpu_chunk_wall_seconds_count",
                 "putpu_canary_injected_total",
                 "putpu_candidate_latency_seconds_count",
                 "putpu_push_delivered_total"):
        check(any(k[0] == name for k in prom),
              f"e2e_observe: {name} missing from the .prom file")
    check(prom[("putpu_canary_recovered_total", "")] >= nchunks,
          "e2e_observe: canary recoveries missing from the .prom file")
    budget = log.lines("BUDGET_JSON")
    check(len(budget) == 1, "e2e_observe: no BUDGET_JSON line")
    budget = json.loads(budget[0])
    pushed = log.lines("PUSH_JSON")
    check(len(received) == len(hits) and pushed
          and json.loads(pushed[0])["delivered"] == len(hits),
          f"e2e_observe: {len(received)} alerts for {len(hits)} hits")
    lineage = sorted(out.glob("*.lineage.json"))
    check(len(lineage) == len(hits),
          f"e2e_observe: {len(lineage)} lineage docs for {len(hits)} hits")
    check((workdir / "observe_report.md").is_file()
          and trace_path.is_file(), "e2e_observe: report or trace missing")
    figure = _figure_arrays_on_card(torch, np, path, hits[0])
    busy = _checked_busy_share(device_dir / trace.DEVICE_TRACE_FILE,
                               "e2e_observe")
    nplots = len(jpegs)
    # the chunk loop: the chunks' walls and the persist queue's tail
    plain_loop = plain_budget["wall_s"] + stages.get("persist_drain", 0.0)
    traced_loop = (traced_budget["wall_s"]
                   + stages_tr.get("persist_drain", 0.0))
    on_loop = budget["wall_s"] + stages_on.get("persist_drain", 0.0)
    emit("e2e_observe", chunks=nchunks, hits=len(hits),
         plain_chunk_loop_s=plain_loop, traced_chunk_loop_s=traced_loop,
         observed_chunk_loop_s=on_loop,
         observe_cost_share=on_loop / plain_loop - 1.0,
         traced_device_busy_share=traced_busy[0],
         traced_device_window_s=traced_busy[1],
         traced_device_busy_s=traced_busy[2],
         traced_device_events=traced_busy[3],
         traced_stage_seconds=stages_tr,
         plain_call_s=plain_call, observed_call_s=on_call,
         plain_budget_unattributed_share=(plain_budget["unattributed_s"]
                                          / plain_budget["wall_s"]),
         plots=nplots if plots else "skipped (no matplotlib)",
         plot_s=stages_on.get("plot", 0.0),
         seconds_per_plot=(stages_on.get("plot", 0.0) / nplots
                           if nplots else None),
         budget_wall_s=budget["wall_s"],
         budget_unattributed_s=budget["unattributed_s"],
         budget_unattributed_share=(budget["unattributed_s"]
                                    / budget["wall_s"]),
         budget_buckets_s=budget["buckets_s"],
         unattributed_per_chunk_s=[c["unattributed_s"]
                                   for c in budget["per_chunk"]],
         plain_unattributed_per_chunk_s=[
             c["unattributed_s"] for c in plain_budget["per_chunk"]],
         budget_counters=budget["counters"], rtt_s=budget.get("rtt_s"),
         device_busy_share=busy[0], device_window_s=busy[1],
         device_busy_s=busy[2], device_events=busy[3],
         figure_arrays=figure,
         canary=recall, healthz_scrapes=len(health),
         metrics_scrapes=len(live), alerts=len(received),
         lineage_docs=len(lineage),
         roofline=[{k: r[k] for k in ("kernel", "calls", "wall_s",
                                      "frac_of_ideal")}
                   for r in roofline.table()],
         launches=counts, plain_launches=plain_counts,
         stage_seconds=stages_on, plain_stage_seconds=stages)
    return counts


#: e2e_lowbit: the end-to-end file's geometry at 1, 2 and 4 bits, each
#: beside an 8-bit twin holding the same codes: blocks of 2^17 samples
#: (the 2-bit file's 5 blocks are the end-to-end file's four chunks; 1
#: and 4 bits take two chunks, depth cut, widths not)
LOWBIT_BLOCKS = {2: 5, 1: 3, 4: 3}
#: the code step of each width on the simulator's |N(impulse, 8)|
#: samples: 2 bits at 6 (the code-0 share ~55%, the top rail ~2.4%), 4
#: at 1.5, 1 bit at 6.7 (~40% ones: neither the 8-bit twin's zero nor its
#: saturation share reaches the float gate's limit)
LOWBIT_STEP = {1: 6.7, 2: 6.0, 4: 1.5}
#: the 2-bit copy of the pulsar file: codes at its 8-bit values 23, 26
#: and 30 (|N| at 2.5, 5.5 and 9.5 above the floor of 20: its quartiles)
PSR_2BIT_EDGES = (23.0, 26.0, 30.0)


def _write_lowbit_pair(torch, np, path, twin, nbits, nblocks, seed):
    """A ``nbits`` descending-band filterbank and its 8-bit twin, written
    block by block with the same codes: the seeded simulator's model
    (``|N(impulse, 8)|``, an impulse of 12 at the file's middle sample in
    every channel, channels rolled by their DM 400 delays, drawn on the
    card) cut into codes of :data:`LOWBIT_STEP` and clipped at the top,
    encoded on the card (``FilterbankWriter.encode_frames``: packed for
    ``nbits``, one byte a code for the twin)."""
    from pulsarutils_tpu_torch.io.sigproc import (FilterbankWriter,
                                                  header_from_simulated)
    from pulsarutils_tpu_torch.ops.plan import dedispersion_shifts

    block = E2E_CHUNK // 2
    sim = {"nchans": NCHAN, "bandwidth": BANDWIDTH, "fbottom": START_FREQ,
           "tsamp": TSAMP}
    header = {"nchans": NCHAN, "nifs": 1, "tstart": 0.0,
              "source_name": "chip_smoke", "machine_id": 0,
              "telescope_id": 0, "data_type": 1,
              **header_from_simulated(sim, descending=True)}
    shifts = np.rint(dedispersion_shifts(NCHAN, E2E_DM, START_FREQ,
                                         BANDWIDTH, TSAMP)).astype(np.int64)
    idx = ((torch.arange(block, device="cuda")[None, :]
            - torch.from_numpy(shifts).cuda()[:, None]) % block)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    top = float((1 << nbits) - 1)
    with FilterbankWriter(str(path), {**header, "nbits": nbits}) as w, \
            FilterbankWriter(str(twin), {**header, "nbits": 8}) as w8:
        for b in range(nblocks):
            x = torch.randn((NCHAN, block), generator=gen, device="cuda")
            x *= 8.0
            if b == nblocks // 2:  # nblocks is odd
                x[:, block // 2] += 12.0
            x = torch.gather(x.abs_(), 1, idx)
            codes = torch.floor(x / LOWBIT_STEP[nbits]).clamp_(max=top)
            frames = codes.flip(0).T  # time-major, file channel order
            w.write_frames(w.encode_frames(frames))
            w8.write_frames(w8.encode_frames(frames))
            del x, codes, frames
    torch.cuda.empty_cache()


def _lowbit_run(torch, path, out, **kw):
    """One ``search_by_chunks`` run on the card of the e2e geometry at S/N
    8 (unless ``kw`` says otherwise): hits, store, launches, counter
    deltas, stage seconds, the loop's seconds."""
    from pulsarutils_tpu_torch.pipeline.search_pipeline import \
        search_by_chunks

    stages, summary = {}, {}
    kw = {"snr_threshold": 8.0, **kw}
    before = _counter_deltas(None)
    reset_counts()
    t0 = time.perf_counter()
    hits, store = search_by_chunks(
        str(path), chunk_length=E2E_CHUNK // 2 * TSAMP, dmmin=DMMIN,
        dmmax=DMMAX, output_dir=str(out), device="cuda", make_plots=False,
        stage_seconds=stages, summary=summary, **kw)
    wall = time.perf_counter() - t0
    return {"hits": hits, "store": store, "counts": read_counts(),
            "counters": _counter_deltas(before), "stages": stages,
            "summary": summary, "wall_s": wall,
            "loop_s": wall - stages.get("badchans", 0.0), "out": out}


def _lowbit_stages(run):
    st = run["stages"]
    return {**{k: st.get(k, 0.0) for k in ("read_decode", "read",
                                          "upload_wait", "gate", "clean",
                                          "search")},
            "loop": run["loop_s"]}


def _check_twin(np, label, packed, twin, nbits, nchunks, kernels):
    """A packed run against its 8-bit twin's: equal hits and tables, equal
    ledgers, equal launches of ``kernels`` (each launched), the packed
    upload ``nbits / 8`` of the twin's and the ``putpu_lowbit_*`` counts
    of the JAX package's definition."""
    for run, which in ((packed, "packed"), (twin, "twin")):
        check_clean_run(run["summary"], f"{label} {which}")
    check(packed["hits"], f"{label}: the pulse was not found")
    check(_tables_equal(np, packed["hits"], twin["hits"]),
          f"{label}: hits differ from the 8-bit twin's: "
          f"{_hit_mismatch(packed['hits'], twin['hits'])}")
    check(all(h[2].dm == t[2].dm and h[2].snr == t[2].snr
              for h, t in zip(packed["hits"], twin["hits"])),
          f"{label}: candidates differ from the twin's")
    check(packed["store"].done_chunks == twin["store"].done_chunks
          and len(packed["store"].done_chunks) == nchunks,
          f"{label}: ledgers {packed['store'].done_chunks} vs "
          f"{twin['store'].done_chunks}")
    for k in kernels:
        check(packed["counts"][k] == twin["counts"][k] > 0,
              f"{label}: {k} launched {packed['counts'][k]} times, "
              f"{twin['counts'][k]} on the twin")
    up = packed["counters"].get("putpu_bytes_uploaded_total", 0)
    tup = twin["counters"].get("putpu_bytes_uploaded_total", 0)
    check(up * 8 == tup * nbits and up > 0,
          f"{label}: uploaded {up} bytes against the twin's {tup}")
    c = packed["counters"]
    saved = nchunks * E2E_CHUNK * NCHAN * (4 - nbits / 8)
    check(c.get("putpu_lowbit_packed_chunks_total") == nchunks
          and c.get("putpu_lowbit_bytes_saved_total") == saved,
          f"{label}: lowbit counters {c.get('putpu_lowbit_packed_chunks_total')}"
          f" / {c.get('putpu_lowbit_bytes_saved_total')} (want {nchunks} / "
          f"{saved})")
    return {"uploaded_bytes": up, "twin_uploaded_bytes": tup,
            "launches": packed["counts"], "twin_launches": twin["counts"],
            "hits": len(packed["hits"]),
            "stage_seconds": _lowbit_stages(packed),
            "twin_stage_seconds": _lowbit_stages(twin)}


def _unpack_case(torch, np, nbits):
    """The device unpack at 1024 x 2^18 against the host decode, both band
    orders, bit for bit, and its CUDA-event ms against its byte bound
    (packed bytes read, float32 written)."""
    from pulsarutils_tpu_torch.io.lowbit import (device_unpack_block,
                                                 unpack_numpy)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(nbits)
    frames = torch.randint(0, 256, (E2E_CHUNK, NCHAN * nbits // 8),
                           generator=gen, dtype=torch.uint8, device="cuda")
    # the host decode in its frame-major layout, compared on the card with
    # the transposed unpack (a host comparison of the transposed 1 GB
    # blocks took ~15 s a width)
    oracle = torch.from_numpy(unpack_numpy(frames.cpu().numpy(), nbits)
                              .reshape(E2E_CHUNK, NCHAN)).cuda()
    out = {}
    for descending in (False, True):
        got = device_unpack_block(frames, nbits, NCHAN, descending)
        want = oracle.flip(1) if descending else oracle
        check(torch.equal(got.T, want),
              f"device unpack {nbits}-bit descending={descending}: not the "
              "host decode")
        ms, _ = time_ms(torch, lambda d=descending: device_unpack_block(
            frames, nbits, NCHAN, d))
        bms, by = bound_ms(0, frames.numel() + 4 * NCHAN * E2E_CHUNK)
        out["descending" if descending else "ascending"] = {
            "ms": ms, "bound_ms": bms, "bound_by": by,
            "bound_share": bms / ms}
    emit("e2e_lowbit_unpack", nbits=nbits, nchan=NCHAN, nsamples=E2E_CHUNK,
         packed_bytes=frames.numel(), equal_host=True, **out)
    return out


def _write_pulsar_2bit(torch, np, src, dst):
    """The 2-bit copy of the pulsar file: its 8-bit values cut at
    :data:`PSR_2BIT_EDGES`, block by block on the card, and packed
    there."""
    from pulsarutils_tpu_torch.io.sigproc import (FilterbankReader,
                                                  FilterbankWriter,
                                                  read_header)

    reader = FilterbankReader(str(src))
    header, _ = read_header(str(src))
    with FilterbankWriter(str(dst), {**header, "nbits": 2}) as w:
        for istart in range(0, reader.nsamples, E2E_CHUNK // 2):
            x = reader.read_block_tensor(istart, E2E_CHUNK // 2, "cuda")
            codes = sum((x >= e).float() for e in PSR_2BIT_EDGES)
            if reader.band_descending:
                codes = codes.flip(0)
            w.write_frames(w.encode_frames(codes.T))


def _lowbit_clean(torch, np, path, workdir):
    """``PUclean`` on the 2-bit file on the card against the CPU run:
    the bytes without ``--fft-zap``; with it, the zapped bins, and the
    codes that differ counted."""
    import logging

    from pulsarutils_tpu_torch.cli import clean_main
    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader
    from pulsarutils_tpu_torch.io.lowbit import unpack_numpy
    from pulsarutils_tpu_torch.pipeline.cleanup import cleanup_data

    out = {}
    root = logging.getLogger()
    saved = root.handlers[:], root.level
    try:
        for label, device in (("card", "cuda"), ("host", "cpu")):
            dst = workdir / f"clean_{label}.fil"
            t0 = time.perf_counter()
            rc = clean_main.main([str(path), "-o", str(dst), "--device",
                                  device])
            out[f"{label}_s"] = time.perf_counter() - t0
            check(rc == 0, f"PUclean --device {device} returned {rc}")
    finally:
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
    a, b = (workdir / "clean_card.fil").read_bytes(), \
        (workdir / "clean_host.fil").read_bytes()
    check(a == b, "PUclean: the card's output bytes differ from the CPU's")
    out["bytes"] = len(a)
    del a, b
    zap = {}
    for label, device in (("card", "cuda"), ("host", "cpu")):
        summary = {}
        t0 = time.perf_counter()
        cleanup_data(str(path), str(workdir / f"zap_{label}.fil"),
                     fft_zap=True, device=device, summary=summary)
        out[f"fft_zap_{label}_s"] = time.perf_counter() - t0
        zap[label] = summary
    check(len(zap["card"]["zapped"]) == len(zap["host"]["zapped"])
          and all(np.array_equal(g[2], c[2]) and g[:2] == c[:2]
                  for g, c in zip(zap["card"]["zapped"],
                                  zap["host"]["zapped"])),
          "PUclean --fft-zap: the zapped bins differ between card and CPU")
    raw = [FilterbankReader(str(workdir / f"zap_{d}.fil"))._mmap
           for d in ("card", "host")]
    differ = np.flatnonzero(np.asarray(raw[0]).ravel()
                            != np.asarray(raw[1]).ravel())
    codes = 0
    if differ.size:
        ga = unpack_numpy(np.asarray(raw[0]).ravel()[differ], 2)
        gb = unpack_numpy(np.asarray(raw[1]).ravel()[differ], 2)
        codes = int(np.count_nonzero(ga != gb))
    out.update(zapped_bins=zap["card"]["nzapped"], codes_differing=codes,
               codes=int(raw[0].size * 4))
    del raw
    for name in ("clean_card", "clean_host", "zap_card", "zap_host"):
        (workdir / f"{name}.fil").unlink()
    return out


def phase_e2e_lowbit(torch, np, workdir, seed, pulsar=None):
    """1/2/4-bit files through every path on the card, each against its
    8-bit twin: the device unpack, the packed chunk loop (direct; at 2
    bits also the hybrid, the FDD and ``period_search`` on a 2-bit copy
    of the pulsar file), the code-domain gate on a railed copy, the
    packed canary, the memmap spill and ``PUclean``.  Returns the launch
    counts of each packed path."""
    from pulsarutils_tpu_torch.io.lowbit import PackedFrames
    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader
    from pulsarutils_tpu_torch.obs.canary import CanaryController
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan
    from pulsarutils_tpu_torch.ops.search import (dedispersion_search,
                                                  release_plane)
    from pulsarutils_tpu_torch.pipeline.spectral_stats import get_bad_chans
    from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

    launches = {}
    unpack = {n: _unpack_case(torch, np, n) for n in (1, 2, 4)}

    # 1. the 2-bit file and its twin, direct sweep: P, T, T, P
    files = {}
    for nbits in (2, 1, 4):
        t0 = time.perf_counter()
        path, twin = workdir / f"lb{nbits}.fil", workdir / f"lb{nbits}_8.fil"
        _write_lowbit_pair(torch, np, path, twin, nbits,
                           LOWBIT_BLOCKS[nbits], seed + 20 + nbits)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        get_bad_chans(str(path))  # the cache, before the timed runs
        scan_s = time.perf_counter() - t0
        # the twin holds the same codes: the same bad channels
        shutil.copy(f"{path}.badchans", f"{twin}.badchans")
        files[nbits] = (path, twin)
        emit("e2e_lowbit_file", nbits=nbits, nchan=NCHAN,
             nsamples=LOWBIT_BLOCKS[nbits] * E2E_CHUNK // 2,
             bytes=path.stat().st_size, twin_bytes=twin.stat().st_size,
             write_s=write_s, badchans_s=scan_s)
        if nbits != 2:
            continue
        runs = [_lowbit_run(torch, p, workdir / f"out_lb2_{i}")
                for i, p in enumerate((path, twin, twin, path))]
        nchunks = len(runs[0]["store"].done_chunks)
        check(nchunks == 4, f"2-bit file: {nchunks} chunks")
        rec = _check_twin(np, "e2e_lowbit 2-bit", runs[0], runs[1], 2,
                          nchunks, ("B1", "B4"))
        _check_twin(np, "e2e_lowbit 2-bit (repeat)", runs[3], runs[2], 2,
                    nchunks, ("B1", "B4"))
        check(runs[0]["counts"]["B1"] == 2 * nchunks,
              f"2-bit direct: {runs[0]['counts']}")
        emit("e2e_lowbit_direct", nbits=2, chunks=nchunks, **rec,
             order="packed, twin, twin, packed",
             runs_stage_seconds=[_lowbit_stages(r) for r in runs])
        launches["2-bit direct sweep (e2e_lowbit)"] = runs[0]["counts"]
        packed_run = runs[0]
        for r in runs[1:]:
            shutil.rmtree(r["out"], ignore_errors=True)

    # 2. 1 and 4 bits: two chunks each against their twins
    for nbits in (1, 4):
        path, twin = files[nbits]
        p = _lowbit_run(torch, path, workdir / f"out_lb{nbits}_p")
        t = _lowbit_run(torch, twin, workdir / f"out_lb{nbits}_t")
        rec = _check_twin(np, f"e2e_lowbit {nbits}-bit", p, t, nbits, 2,
                          ("B1", "B4"))
        emit("e2e_lowbit_direct", nbits=nbits, chunks=2, **rec)
        launches[f"{nbits}-bit direct sweep (e2e_lowbit)"] = p["counts"]
        for r in (p, t):
            shutil.rmtree(r["out"], ignore_errors=True)
        path.unlink()
        twin.unlink()

    # 3. the hybrid and the FDD on the 2-bit file
    path, twin = files[2]
    for kernel, kernels in (("hybrid", ("B1", "B2a", "B2b", "B3", "B4")),
                            ("fourier", ("B4", "B5"))):
        p = _lowbit_run(torch, path, workdir / f"out_lb2_{kernel}",
                        kernel=kernel)
        t = _lowbit_run(torch, twin, workdir / f"out_lb2_{kernel}_t",
                        kernel=kernel)
        rec = _check_twin(np, f"e2e_lowbit 2-bit {kernel}", p, t, 2, 4,
                          kernels)
        emit("e2e_lowbit_kernel", nbits=2, kernel=kernel, **rec)
        launches[f"2-bit {kernel} (e2e_lowbit)"] = p["counts"]
        for r in (p, t):
            shutil.rmtree(r["out"], ignore_errors=True)
    twin.unlink()

    # 4. the gate: a copy with the first chunk's codes all at the top rail
    railed = workdir / "lb2_railed.fil"
    shutil.copy(path, railed)
    # the clean file's bad channels: the gate is what this run checks
    shutil.copy(f"{path}.badchans", f"{railed}.badchans")
    reader = FilterbankReader(str(railed))
    offset = reader._mmap.offset
    nbytes = E2E_CHUNK * reader.bytes_per_frame
    del reader
    with open(railed, "r+b") as f:
        f.seek(offset)
        f.write(b"\xff" * nbytes)
    g = _lowbit_run(torch, railed, workdir / "out_lb2_railed")
    check(g["summary"]["quarantined"] == 1
          and list(g["store"].quarantined_chunks) == ["0"],
          f"e2e_lowbit gate: quarantined {g['store'].quarantined_chunks}")
    man = [json.loads(line) for line in (g["out"] / (
        f"quarantine_{g['store'].fingerprint}.jsonl")).read_text()
        .splitlines()]
    check(len(man) == 1 and man[0]["reason"]
          == "integrity:rail_frac,dead_frac" and man[0]["chunk"] == 0,
          f"e2e_lowbit gate: manifest {man}")
    check(g["store"].done_chunks == packed_run["store"].done_chunks,
          "e2e_lowbit gate: ledger")
    clear = [h for h in packed_run["hits"] if h[0] >= E2E_CHUNK]
    check(_tables_equal(np, [h for h in g["hits"] if h[0] >= E2E_CHUNK],
                        clear), "e2e_lowbit gate: the chunks clear of the "
          "railed samples differ from the clean run's")
    emit("e2e_lowbit_gate", quarantined=g["store"].quarantined_chunks,
         manifest=man, hits=len(g["hits"]),
         stage_seconds=_lowbit_stages(g))
    shutil.rmtree(g["out"], ignore_errors=True)
    railed.unlink()

    # 5. the packed canary in every chunk
    canary = CanaryController(rate=1.0, snr=40.0, seed=seed)
    c = _lowbit_run(torch, path, workdir / "out_lb2_canary", canary=canary)
    check_clean_run(c["summary"], "e2e_lowbit canary")
    summ = canary.summary()
    check(summ["injected"] == 4 and c["counters"].get(
        "putpu_canary_packed_injections_total") == 4,
        f"e2e_lowbit canary: {summ}, {c['counters']}")
    off = packed_run["hits"]
    check([h[:2] for h in c["hits"]] == [h[:2] for h in off]
          and all(h[2].dm == o[2].dm and abs(h[2].snr - o[2].snr)
                  <= 1e-2 * o[2].snr for h, o in zip(c["hits"], off)),
          "e2e_lowbit canary: the science hits changed: "
          f"{[(h[0], h[2].dm, h[2].snr) for h in c['hits']]} vs "
          f"{[(h[0], h[2].dm, h[2].snr) for h in off]}")
    emit("e2e_lowbit_canary", injected=summ["injected"],
         recovered=summ["recovered"], recall=summ["recall"],
         snr_ratio=summ.get("snr_ratio_mean"), hits=len(c["hits"]),
         launches=c["counts"], stage_seconds=_lowbit_stages(c))
    shutil.rmtree(c["out"], ignore_errors=True)

    # 6. the disk-spilled plane of one chunk, 514 trials
    pf = PackedFrames.read(FilterbankReader(str(path)), E2E_CHUNK,
                           E2E_CHUNK)
    args = (DMMIN, DMMAX, START_FREQ, BANDWIDTH, TSAMP)
    table, dense = dedispersion_search(pf, *args, capture_plane=True,
                                       device="cuda")
    os.environ["PUTPU_PLANE_DIR"] = str(workdir)
    budget = BudgetAccountant()
    try:
        reset_counts()
        t0 = time.perf_counter()
        with budget.chunk(0):
            table_m, mm = dedispersion_search(pf, *args,
                                              capture_plane="memmap",
                                              device="cuda")
        memmap_s = time.perf_counter() - t0
    finally:
        del os.environ["PUTPU_PLANE_DIR"]
    counts = read_counts()
    ndm = len(dedispersion_plan(NCHAN, *args))
    check(isinstance(mm, np.memmap) and mm.shape == (ndm, E2E_CHUNK)
          and Path(mm.filename).parent == workdir,
          f"memmap: {type(mm)} {getattr(mm, 'shape', None)}")
    on_disk = np.load(mm.filename, mmap_mode="r")
    check(np.array_equal(on_disk, dense.cpu().numpy()),
          "memmap: the plane on disk is not the dense capture")
    check(all(np.array_equal(table_m[k], table[k]) for k in table.colnames),
          "memmap: the table differs from the dense capture's")
    size = Path(mm.filename).stat().st_size
    del on_disk, dense
    release_plane(mm)
    check(not Path(mm.filename).exists(), "memmap: release_plane left the "
          "file")
    spill = budget.to_json()["buckets_s"].get("search/plane_spill")
    emit("e2e_lowbit_memmap", ndm=ndm, nsamples=E2E_CHUNK, file_bytes=size,
         equal_dense=True, launches=counts, search_s=memmap_s,
         plane_spill_s=spill)
    launches["2-bit chunk, capture_plane='memmap' (e2e_lowbit_memmap)"] = \
        counts
    del mm

    # 7. PUclean on the card against the CPU
    clean = _lowbit_clean(torch, np, path, workdir)
    emit("e2e_lowbit_clean", **clean)
    path.unlink()

    # 8. period_search on the 2-bit copy of the pulsar file
    if pulsar is None:
        pulsar = workdir / "pulsar.fil"
        _write_pulsar_file(np, pulsar, seed)
    psr2 = workdir / "pulsar_2bit.fil"
    _write_pulsar_2bit(torch, np, pulsar, psr2)
    r = _lowbit_run(torch, psr2, workdir / "out_psr2", period_search=True)
    check_clean_run(r["summary"], "e2e_lowbit period_search")
    dms = dedispersion_plan(NCHAN, *args)
    spacing = float(dms[1] - dms[0])
    nchunks = len(r["store"].done_chunks)
    found = [h for h in r["hits"] if h[2].period_freq is not None
             and _psr_match(h[2].period_freq, h[2].period_dm, spacing,
                            E2E_CHUNK * TSAMP)]
    check(nchunks == 4 and len(found) == nchunks and r["counts"]["B6"] > 0,
          f"2-bit pulsar found in {len(found)} of {nchunks} chunks: "
          f"{[(h[2].period_freq, h[2].period_dm, h[2].period_sigma) for h in r['hits']]}")
    check(r["counters"].get("putpu_lowbit_packed_chunks_total") == nchunks,
          "2-bit pulsar: not searched packed")
    emit("e2e_lowbit_period", chunks=nchunks, bytes=psr2.stat().st_size,
         periodic=[{"istart": h[0], "freq": h[2].period_freq,
                    "dm": h[2].period_dm, "sigma": h[2].period_sigma}
                   for h in r["hits"]],
         launches=r["counts"], stage_seconds=_lowbit_stages(r))
    launches["2-bit direct sweep with period_search (e2e_lowbit)"] = \
        r["counts"]
    shutil.rmtree(r["out"], ignore_errors=True)
    psr2.unlink()
    return {"launches": launches, "unpack": unpack}


def phase_autotune_search(torch, np, workdir, path, chunk_length, nchunks):
    """The tuner on the card at the end-to-end chunk (1024 x 2^18, the
    DM 300-635 plan): ``resolve_search_kernel`` measured, then a memory
    hit and a disk hit; the e2e file with ``kernel="auto"`` under
    ``PUTPU_AUTOTUNE=on`` (cold) and ``off`` (equal hits, the decision in
    the budget record, B1 twice a chunk outside the probe);
    ``resolve_search_policy`` for the gather with the file searched under
    ``PUTPU_PRECISION=auto`` beside ``f32``; ``resolve_harmonic_kernel``
    on the card."""
    from pulsarutils_tpu_torch.obs.metrics import REGISTRY
    from pulsarutils_tpu_torch.pipeline.search_pipeline import \
        search_by_chunks
    from pulsarutils_tpu_torch.precision import STRATEGIES
    from pulsarutils_tpu_torch.tuning import autotune
    from pulsarutils_tpu_torch.tuning.cache import TuneCache
    from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

    dms = e2e_trial_dms()
    geom = (START_FREQ, BANDWIDTH, TSAMP)
    common = dict(chunk_length=chunk_length, dmmin=DMMIN, dmmax=DMMAX,
                  snr_threshold=8.0, device="cuda", make_plots=False)

    # 1. one resolution, measured; a memory hit; a disk hit
    with cold_tuner("autotune_resolve") as tuner:
        reset_counts()
        mark = autotune.decision_seq()
        t0 = time.perf_counter()
        winner = autotune.resolve_search_kernel(
            NCHAN, E2E_CHUNK, len(dms), None, False, *geom, dms,
            device="cuda")
        first_s = time.perf_counter() - t0
        probe = read_probe_counts()
        rec, = autotune.decisions_since(mark)
        key = rec["key"]
        outputs = tuner.outputs[key]
        verdicts = {c: autotune.hits_match(outputs["pallas"], o)
                    for c, o in outputs.items()}
        check(rec["source"] == "measured" and rec["static"] == "pallas"
              and winner in rec["measured_s"],
              f"resolve_search_kernel: {rec}")
        check(probe["B1"] > 0 and probe["B4"] > 0,
              f"the probe launched no sweep: {probe}")
        check(key == f"gpu|c{NCHAN}|t{E2E_CHUNK}|d{len(dms)}|float32|m-",
              f"key {key}")
        hits_before = REGISTRY.counter(
            "putpu_autotune_cache_hits_total").value
        t0 = time.perf_counter()
        again = autotune.resolve_search_kernel(
            NCHAN, E2E_CHUNK, len(dms), None, False, *geom, dms,
            device="cuda")
        memory_s = time.perf_counter() - t0
        check(again == winner and read_probe_counts() == probe
              and autotune.decision_seq() == mark + 1
              and REGISTRY.counter("putpu_autotune_cache_hits_total").value
              == hits_before + 1,
              "a second resolution measured again")
        fresh = autotune.KernelTuner(cache=TuneCache(tuner.cache.path))
        prev = autotune.set_tuner(fresh)
        try:
            disk = autotune.resolve_search_kernel(
                NCHAN, E2E_CHUNK, len(dms), None, False, *geom, dms,
                device="cuda")
        finally:
            autotune.set_tuner(prev)
        disk_rec = autotune.decisions_since(mark)[-1]
        check(disk == winner and disk_rec["source"] == "cache"
              and read_probe_counts() == probe,
              f"a fresh tuner on the file: {disk_rec}")
    emit("autotune", case="resolve_search_kernel", key=key, winner=winner,
         measured_s=rec["measured_s"], abandoned=rec.get("abandoned", []),
         speedup_vs_static=rec.get("speedup_vs_static"),
         equivalent=verdicts, first_resolve_s=first_s,
         memory_hit_s=memory_s, disk_hit=disk_rec["source"],
         probe_launches={k: v for k, v in probe.items() if v})

    # 2. the e2e file, kernel="auto": cold and on, then off
    runs = {}
    for mode in ("on", "off"):
        with cold_tuner(f"autotune_e2e_{mode}"), \
                env_set(PUTPU_AUTOTUNE=mode):
            budget = BudgetAccountant()
            stages, summary = {}, {}
            reset_counts()
            t0 = time.perf_counter()
            hits, _ = search_by_chunks(
                str(path), output_dir=str(workdir / f"out_autotune_{mode}"),
                budget=budget, stage_seconds=stages, summary=summary,
                **common)
            wall = time.perf_counter() - t0
            counts, probe = read_counts(), read_probe_counts()
            check_clean_run(summary, f"autotune_e2e_{mode}")
            record = budget.to_json().get("autotune", [])
        runs[mode] = dict(hits=hits, counts=counts, probe=probe,
                          record=record, wall=wall, stages=stages)
        emit("autotune", case=f"e2e_file_autotune_{mode}", wall_s=wall,
             autotune_s=stages.get("search/autotune", 0.0),
             stage_seconds=stages, launches=counts,
             probe_launches={k: v for k, v in probe.items() if v},
             budget_autotune=record)
    bad = _hit_mismatch(runs["on"]["hits"], runs["off"]["hits"])
    check(bad is None, f"autotune on vs off: {bad}")
    measured = [r for r in runs["on"]["record"] if r["key"] == key
                and r["source"] == "measured"]
    check(measured, f"the budget record names no measured decision for "
          f"{key}: {runs['on']['record']}")
    check(runs["off"]["record"] == [] and not any(
        runs["off"]["probe"].values()), "PUTPU_AUTOTUNE=off measured")
    for mode in ("on", "off"):
        b1 = runs[mode]["counts"]["B1"]
        check(b1 == 2 * nchunks,
              f"autotune {mode}: {b1} B1 launches outside the probe")
    check(runs["on"]["probe"]["B1"] > 0, "the e2e run's probe launched no B1")

    # 3. the gather's precision policy
    with cold_tuner("autotune_policy"):
        mark = autotune.decision_seq()
        t0 = time.perf_counter()
        pair = autotune.resolve_search_policy(
            "gather", NCHAN, E2E_CHUNK, len(dms), *geom, dms, device="cuda")
        policy_s = time.perf_counter() - t0
        prec = autotune.decisions_since(mark)[0]
        strategy = pair.split("+", 1)[1]
        hits_by = {}
        for label, policy in (("f32", "f32"), ("auto", "auto")):
            with env_set(PUTPU_PRECISION=policy):
                reset_counts()
                hits_by[label], _ = search_by_chunks(
                    str(path), kernel="gather",
                    output_dir=str(workdir / f"out_autotune_gather_{label}"),
                    **common)
        rtol = STRATEGIES[strategy].score_rtol
        bad = _policy_hit_mismatch(hits_by["auto"], hits_by["f32"], rtol)
        check(bad is None, f"gather under the measured policy {pair}: {bad}")
    emit("autotune", case="resolve_search_policy", key=prec["key"],
         winner=pair, measured_s=prec.get("measured_s"),
         abandoned=prec.get("abandoned", []), source=prec["source"],
         seconds=policy_s, score_rtol=rtol)

    # 4. the harmonic chain: one applicable variant on the card
    with cold_tuner("autotune_harmonic"):
        mark = autotune.decision_seq()
        kern = autotune.resolve_harmonic_kernel(
            514, (1 << 18) // 2 + 1, TSAMP, device="cuda")
        hrec, = autotune.decisions_since(mark)
    check(kern == "pallas" and hrec["source"] == "static"
          and hrec.get("reason") == "single applicable variant",
          f"resolve_harmonic_kernel on the card: {hrec}")
    emit("autotune", case="resolve_harmonic_kernel", decision=hrec)
    return {"winner": winner, "on": runs["on"]["counts"],
            "off": runs["off"]["counts"]}


def phase_autotune_accel(torch, np, workdir, period):
    """``resolve_accel_backend`` at the pulsar job's geometry (both
    medians, the winner, the two probe tables' ``accel_tables_match``),
    and the job with that backend named, resumed from the
    ``accel_backend="auto"`` job's files: the same best candidate."""
    from pulsarutils_tpu_torch.periodicity.driver import periodicity_search
    from pulsarutils_tpu_torch.tuning import autotune

    res = period["job"]
    acc = res["accumulator"]
    fmin = 4.0 / (acc.nout * acc.tsamp)
    with cold_tuner("autotune_accel") as tuner:
        mark = autotune.decision_seq()
        t0 = time.perf_counter()
        winner = autotune.resolve_accel_backend(
            acc.ndm, acc.nout, acc.tsamp, res["accels"], max_harmonics=16,
            fmin=fmin, device="cuda")
        seconds = time.perf_counter() - t0
        rec, = autotune.decisions_since(mark)
        outputs = tuner.outputs[rec["key"]]
        match = autotune.accel_tables_match(outputs["time_stretch"],
                                            outputs["fdas"])
    check(rec["source"] == "measured", f"resolve_accel_backend: {rec}")
    auto_backend = res["accel_backend"]
    reset_counts()
    t0 = time.perf_counter()
    named = periodicity_search(
        str(workdir / "pulsar.fil"), DMMIN, DMMAX, accel_max=1000.0,
        n_accel=5, canary=True, accel_backend=auto_backend,
        output_dir=str(period["job_dir"]), chunk_length=E2E_CHUNK // 2 * TSAMP,
        snr_threshold=8.0, device="cuda")
    wall = time.perf_counter() - t0
    best, auto_best = named["candidates"][0], res["candidates"][0]
    cell = ("dm_index", "accel_index", "freq_bin", "nharm")
    check([best[k] for k in cell] == [auto_best[k] for k in cell]
          and best["sigma"] == auto_best["sigma"],
          f"the {auto_backend} job's best {best} vs the auto job's "
          f"{auto_best}")
    emit("autotune", case="resolve_accel_backend", key=rec["key"],
         winner=winner, auto_job_backend=auto_backend,
         measured_s=rec.get("measured_s"),
         abandoned=rec.get("abandoned", []),
         speedup_vs_static=rec.get("speedup_vs_static"),
         accel_tables_match=match, seconds=seconds,
         named_job_wall_s=wall,
         best={k: best[k] for k in (*cell, "freq", "sigma")})
    return {"winner": winner, "named_job": read_counts()}


def phase_fdmt_knobs(torch, np, seed):
    """``PUTPU_FDMT_HEAD=0`` and ``PUTPU_FDMT_DEEP_PAIR=0`` against the
    default schedule at the end-to-end chunk (1024 x 2^18, DM 300-635)
    and the headline (1024 x 2^20, the 512-trial grid): the coarse plane
    bit for bit, the launches of B3, B2a and B2b of one transform, and
    its ms (CUDA events, one warm-up, median of 5)."""
    from pulsarutils_tpu_torch.ops.fdmt import fdmt_transform, fdmt_trial_dms
    from pulsarutils_tpu_torch.ops.plan import dmmax_for_trials

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    settings = (("default", {}), ("PUTPU_FDMT_HEAD=0",
                                  {"PUTPU_FDMT_HEAD": "0"}),
                ("PUTPU_FDMT_DEEP_PAIR=0", {"PUTPU_FDMT_DEEP_PAIR": "0"}))
    paths = {}
    out = {}
    for label, nsamples, dmmax in (
            ("e2e_chunk", E2E_CHUNK, DMMAX),
            ("headline", NSAMPLES, dmmax_for_trials(
                DMMIN, HYB_NTRIALS, START_FREQ, BANDWIDTH, TSAMP))):
        data = torch.randn((NCHAN, nsamples), generator=gen, device="cuda")
        _, n_lo, n_hi = fdmt_trial_dms(NCHAN, DMMIN, dmmax, START_FREQ,
                                       BANDWIDTH, TSAMP)

        def run():
            return fdmt_transform(data, n_hi, START_FREQ, BANDWIDTH,
                                  min_delay=n_lo)

        ref = None
        recs = {}
        for name, env in settings:
            with env_set(**env):
                reset_counts()
                plane = run()
                torch.cuda.synchronize()
                counts = read_counts()
                ms, times = time_ms(torch, run)
            if ref is None:
                ref = plane
            equal = bool(torch.equal(plane, ref))
            check(equal, f"fdmt_knobs {label}: {name} changed the plane")
            recs[name] = {"B3": counts["B3"], "B2a": counts["B2a"],
                          "B2b": counts["B2b"], "coarse_ms": ms,
                          "coarse_times_ms": times, "bit_equal": equal}
            paths[f"fdmt_knobs {label} {name}"] = counts
            del plane
        d = recs["default"]
        check(d["B3"] == 1 and d["B2b"] == 1
              and recs["PUTPU_FDMT_HEAD=0"]["B3"] == 0
              and recs["PUTPU_FDMT_HEAD=0"]["B2a"] == d["B2a"] + 7
              and recs["PUTPU_FDMT_DEEP_PAIR=0"]["B2b"] == 0
              and recs["PUTPU_FDMT_DEEP_PAIR=0"]["B2a"] == d["B2a"] + 2,
              f"fdmt_knobs {label}: launches {recs}")
        emit("fdmt_knobs", case=label, nchan=NCHAN, nsamples=nsamples,
             rows=n_hi - n_lo + 1, **recs)
        out[label] = recs
        del data, ref
        torch.cuda.empty_cache()
    return out, paths


def phase_preflight(torch, np, workdir, path, hits):
    """The memory preflight on the card: ``kernel="gather"`` and
    ``"roll"`` on the pulse's end-to-end chunk with ``PUTPU_MEM_LIMIT`` at
    half the model's estimate (``putpu_oom_splits_total`` and the ladder
    level rise, the table equal to the unconstrained one bit for bit),
    then with no limit the allocator's high-water mark over the model's
    estimate, and the calibration file written."""
    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader
    from pulsarutils_tpu_torch.obs.metrics import REGISTRY
    from pulsarutils_tpu_torch.ops.search import (auto_chan_block,
                                                  dedispersion_search)
    from pulsarutils_tpu_torch.pipeline.search_pipeline import clean_chunk
    from pulsarutils_tpu_torch.resilience import ladder
    from pulsarutils_tpu_torch.resilience import memory_budget as mb

    dms = e2e_trial_dms()
    ndm = len(dms)
    istart = max(hits, key=lambda h: h[2].snr)[0]
    reader = FilterbankReader(str(path))
    raw = reader.read_block_tensor(istart, E2E_CHUNK, "cuda")
    chunk = clean_chunk(raw, torch.zeros(NCHAN, dtype=torch.bool,
                                         device="cuda"))
    del raw
    args = (DMMIN, DMMAX, START_FREQ, BANDWIDTH, TSAMP)
    dm_block = min(ndm, 32)
    chan_block = auto_chan_block(NCHAN, E2E_CHUNK, dm_block)
    out = {}
    with cold_tuner("preflight"):
        split_tables = {}
        for form in ("gather", "roll"):
            est = mb.estimate_direct(NCHAN, E2E_CHUNK, ndm,
                                     dm_block=dm_block,
                                     chan_block=chan_block,
                                     formulation=form)["total"]
            splits = REGISTRY.counter("putpu_oom_splits_total",
                                      stage="preflight")
            before = splits.value
            ladder.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with env_set(PUTPU_MEM_LIMIT=est // 2):
                split_tables[form] = dedispersion_search(
                    chunk, *args, trial_dms=dms, kernel=form,
                    precision="f32", device="cuda")
            split_s = time.perf_counter() - t0
            level = ladder.level()
            ladder.reset()
            check(splits.value > before and level > 0,
                  f"preflight {form}: splits {splits.value - before}, "
                  f"level {level}")
            out[form] = {"estimate_bytes": est, "limit_bytes": est // 2,
                         "splits": splits.value - before, "level": level,
                         "split_s": split_s}
        for form in ("gather", "roll"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table = dedispersion_search(chunk, *args, trial_dms=dms,
                                        kernel=form, precision="f32",
                                        device="cuda")
            whole_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            check(ladder.level() == 0, "an unconstrained run descended")
            for col in ("DM", "max", "std", "snr", "rebin", "peak"):
                check(np.array_equal(table[col], split_tables[form][col]),
                      f"preflight {form}: column {col} differs after the "
                      "split")
            key = mb._direct_key(NCHAN, E2E_CHUNK, ndm, "cuda")
            out[form].update(peak_bytes=peak,
                             measured_over_estimate=peak
                             / out[form]["estimate_bytes"],
                             whole_s=whole_s,
                             calibration_offset=mb.calibration_offset(key))
        calib = Path(mb.calibration_path())
        check(calib.is_file() and key in json.loads(
            calib.read_text())["offsets"],
            f"no calibration for {key} in {calib}")
    emit("preflight", chunk=istart, ndm=ndm, dm_block=dm_block,
         chan_block=chan_block, key=key, **out)
    del chunk
    torch.cuda.empty_cache()
    return out


#: the tolerance of a float32 device reduction against the same call on
#: the CPU (the port's surface tests state it)
SURFACE_RTOL = 1e-5


def phase_surface(torch, np, path):
    """The reference's library surface on the card against the same call
    on the CPU: ``quick_chan_rebin``, ``get_noisier_channels`` and
    ``measure_channel_variability`` on the end-to-end file's first chunk,
    ``spectral_stats_scan`` over the whole file in 2^17-sample chunks;
    that scan's flag mask equal to the host scan's ``.badchans``."""
    from pulsarutils_tpu_torch import (get_bad_chans, get_noisier_channels,
                                       measure_channel_variability,
                                       quick_chan_rebin)
    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader
    from pulsarutils_tpu_torch.pipeline.spectral_stats import (
        flag_bad_channels, spectral_stats_scan)

    reader = FilterbankReader(str(path))
    block = reader.read_block_tensor(0, E2E_CHUNK, "cpu")
    card = block.cuda()
    rec = {}
    t0 = time.perf_counter()
    reb, reb_cpu = quick_chan_rebin(card, 4), quick_chan_rebin(block, 4)
    rel = float(((reb.cpu() - reb_cpu).abs()
                 / reb_cpu.abs().clamp(min=1e-30)).max())
    check(reb.device.type == "cuda" and rel <= SURFACE_RTOL,
          f"quick_chan_rebin: rel {rel}")
    rec["quick_chan_rebin"] = {"shape": list(reb.shape), "max_rel": rel}
    for name, fn in (("get_noisier_channels", get_noisier_channels),
                     ("measure_channel_variability",
                      measure_channel_variability)):
        on_card, on_cpu = fn(card), fn(block)
        equal = bool(torch.equal(on_card.cpu(), on_cpu))
        check(on_card.device.type == "cuda" and equal,
              f"{name}: card and CPU flags differ")
        rec[name] = {"flagged": int(on_cpu.sum()), "equal": equal}
    step = E2E_CHUNK // 2
    chunks = torch.stack([torch.from_numpy(b.astype(np.float32)) for _, b in
                          reader.iter_blocks(step)]).cuda()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mean, std = spectral_stats_scan(chunks)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t1
    mean_cpu, std_cpu = spectral_stats_scan(chunks.cpu())
    rel_mean = float(((mean.cpu() - mean_cpu).abs() / mean_cpu.abs()).max())
    rel_std = float(((std.cpu() - std_cpu).abs() / std_cpu.abs()).max())
    check(rel_mean <= SURFACE_RTOL and rel_std <= SURFACE_RTOL,
          f"spectral_stats_scan: card vs CPU rel {rel_mean}, {rel_std}")
    flags = flag_bad_channels(mean.cpu().numpy(), std.cpu().numpy())
    host = get_bad_chans(str(path))
    check(np.array_equal(flags, host), f"spectral_stats_scan flags "
          f"{np.flatnonzero(flags)} vs .badchans {np.flatnonzero(host)}")
    rec["spectral_stats_scan"] = {
        "chunks": list(chunks.shape), "max_rel_mean": rel_mean,
        "max_rel_std": rel_std, "scan_s": scan_s,
        "flagged": int(flags.sum()), "badchans_equal": True}
    emit("surface", seconds=time.perf_counter() - t0, tolerance=SURFACE_RTOL,
         **rec)
    del chunks, card
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# the mesh (parallel/): virtual meshes of the one card
# ---------------------------------------------------------------------------

#: the mesh sweep's virtual meshes of the card, (dm, chan)
MESH_SHAPES = ((1, 1), (4, 1), (2, 2), (1, 4))

#: the JAX package's tolerance on S/N between its mesh and single-device
#: sweeps (``tests/test_parallel.py``): a mesh with chan > 1 adds its
#: channel-shard partials in another association than one sweep does
MESH_SNR_RTOL = 1e-4


def _card_mesh(torch, shape, axes=("dm", "chan")):
    """A mesh of ``shape`` whose every shard is the card (virtual shards)."""
    from pulsarutils_tpu_torch.parallel.mesh import make_mesh

    n = 1
    for s in shape:
        n *= s
    return make_mesh(shape, axes, devices=[torch.device("cuda", 0)] * n)


def _mesh_plain_plane(torch, data, offsets, shape):
    """The sharded sweep's plain version on the card: per dm shard, each
    channel shard's plain B1 on its channel slice, then the same
    ascending sum of the partials (``parallel/sharded.py:chan_sum``)."""
    from pulsarutils_tpu_torch.ops.dedisperse import dedisperse_plane_plain
    from pulsarutils_tpu_torch.parallel.sharded import chan_sum, shard_bounds

    rows = shard_bounds(offsets.shape[0], shape[0])
    chans = shard_bounds(offsets.shape[1], shape[1])
    planes = []
    for lo, hi in rows:
        if hi > lo:
            planes.append(chan_sum(
                [dedisperse_plane_plain(data[c_lo:c_hi],
                                        offsets[lo:hi, c_lo:c_hi])
                 for c_lo, c_hi in chans], data.device))
    return planes


def _table_diff(np, ours, ref, floats=("max", "std", "snr")):
    """Largest relative difference of the float columns, and whether the
    discrete columns (DM, rebin, peak, argbest) are equal."""
    discrete = (ours.argbest() == ref.argbest() and all(
        np.array_equal(np.asarray(ours[c]), np.asarray(ref[c]))
        for c in ("DM", "rebin", "peak")))
    rel = max(float(np.max(np.abs(np.asarray(ours[c], np.float64)
                                  - np.asarray(ref[c], np.float64))
                           / np.maximum(np.abs(np.asarray(ref[c],
                                                          np.float64)),
                                        1e-30))) for c in floats)
    return discrete, rel


def _tables_bitwise(np, ours, ref):
    return all(np.array_equal(np.asarray(ours[c]), np.asarray(ref[c]))
               for c in ref.colnames)


def phase_mesh_sweep(torch, np, seed):
    """The sharded direct sweep on virtual meshes of the card at the e2e
    chunk (1024 x 2^18, the 514-trial DM 300-635 plan): each mesh's plane
    equal to its plain version on the card (plain B1 per shard, the same
    ascending channel sum) bit for bit and its table to that plane's B4
    scores bit for bit; against the single-device search, bit for bit at
    chan = 1, else the discrete columns equal and S/N within the JAX
    package's mesh tolerance; B1 and B4 launches, card ms and peak bytes
    beside the single-device search's."""
    from pulsarutils_tpu_torch.ops.plan import offsets_for
    from pulsarutils_tpu_torch.ops.score_cuda import score_plane
    from pulsarutils_tpu_torch.ops.search import (dedispersion_search,
                                                  unstack_scores)
    from pulsarutils_tpu_torch.parallel.sharded import \
        sharded_dedispersion_search
    from pulsarutils_tpu_torch.utils.table import ResultTable

    data = _bench_data_on_card(torch, np, E2E_CHUNK, seed).contiguous()
    dms = e2e_trial_dms()
    args = (DMMIN, DMMAX, START_FREQ, BANDWIDTH, TSAMP)
    offsets = offsets_for(dms, NCHAN, START_FREQ, BANDWIDTH, TSAMP,
                          E2E_CHUNK)

    def single():
        return dedispersion_search(data, *args, kernel="pallas",
                                   device="cuda")

    ref, ref_plane = dedispersion_search(data, *args, kernel="pallas",
                                         capture_plane=True, device="cuda")
    single_ms, _ = time_ms(torch, single, runs=3)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    single()
    torch.cuda.synchronize()
    single_peak = torch.cuda.max_memory_allocated() - base
    out = {}
    for shape in MESH_SHAPES:
        mesh = _card_mesh(torch, shape)

        def sweep():
            return sharded_dedispersion_search(data, *args, mesh=mesh,
                                               kernel="pallas")

        reset_counts()
        table, handle = sharded_dedispersion_search(
            data, *args, mesh=mesh, kernel="pallas", capture_plane=True,
            plane_handle=True)
        counts = read_counts()
        nshards = sum(1 for p in handle.shards) * shape[1]
        check(counts["B1"] == nshards and counts["B4"] == len(handle.shards),
              f"mesh_sweep {shape}: launches {counts}")
        plain = _mesh_plain_plane(torch, data, offsets, shape)
        planes_equal = all(torch.equal(a, b)
                           for a, b in zip(handle.shards, plain))
        check(planes_equal and len(plain) == len(handle.shards),
              f"mesh_sweep {shape}: a shard's plane differs from its plain "
              "version")
        plain_table = ResultTable(dict(zip(
            ("DM", "max", "std", "snr", "rebin", "peak"),
            (dms, *unstack_scores(torch.cat([score_plane(p)
                                             for p in plain], dim=1))))))
        check(_tables_bitwise(np, table, plain_table),
              f"mesh_sweep {shape}: the table differs from the plain "
              "program's")
        discrete, rel = _table_diff(np, table, ref)
        if shape[1] == 1:
            same_plane = torch.equal(torch.cat(handle.shards), ref_plane)
            check(same_plane and _tables_bitwise(np, table, ref),
                  f"mesh_sweep {shape}: not the single-device table bit "
                  "for bit")
        check(discrete and rel <= MESH_SNR_RTOL,
              f"mesh_sweep {shape}: against the single device: discrete "
              f"{discrete}, max rel diff {rel}")
        del handle, plain
        mesh_ms, _ = time_ms(torch, sweep, runs=3)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sweep()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        out[shape] = counts
        emit("mesh_sweep", mesh=list(shape), trials=len(dms),
             chunk=[NCHAN, E2E_CHUNK], launches=counts,
             plane_equals_plain=True, table_equals_plain=True,
             single_bitwise=shape[1] == 1, discrete_equal_single=discrete,
             max_rel_diff_single=rel, rtol=MESH_SNR_RTOL,
             ms=mesh_ms, single_ms=single_ms, ratio=mesh_ms / single_ms,
             peak_bytes=peak, single_peak_bytes=single_peak)
    del data, ref_plane
    torch.cuda.empty_cache()
    return out


def phase_mesh_fdmt(torch, np, seed):
    """The sharded FDMT and the mesh hybrid (fused and unfused) on the JAX
    package's benchmark data (1024 x 2^20, bench.py), on (4, 1) and
    (2, 2) meshes of the card: each slice's rows against the
    single-device transform (bit for bit, else within rtol/atol 1e-4 and
    said so), the tables against the single-device FDMT search, the
    hybrid's best row against the single-device hybrid's, fused ==
    unfused; B3, B2a, B2b, B1 and B4 launched."""
    from pulsarutils_tpu_torch.ops.fdmt import (fdmt_plan, fdmt_transform,
                                                fdmt_trial_dms,
                                                transform_schedule)
    from pulsarutils_tpu_torch.ops.plan import (dedispersion_plan,
                                                dmmax_for_trials)
    from pulsarutils_tpu_torch.ops.search import dedispersion_search
    from pulsarutils_tpu_torch.parallel.sharded_fdmt import (
        sharded_fdmt_search, sharded_hybrid_search, slice_delay_range)
    from pulsarutils_tpu_torch.tuning.autotune import resolve_mesh_kernel
    from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

    dmmax = dmmax_for_trials(DMMIN, HYB_NTRIALS, START_FREQ, BANDWIDTH,
                             TSAMP)
    args = (DMMIN, dmmax, START_FREQ, BANDWIDTH, TSAMP)
    data = _bench_data_on_card(torch, np, NSAMPLES, seed).contiguous()
    plan_dms = np.asarray(dedispersion_plan(NCHAN, *args), dtype=np.float64)
    _, n_lo, n_hi = fdmt_trial_dms(NCHAN, *args)
    full = fdmt_transform(data, n_hi, START_FREQ, BANDWIDTH, min_delay=n_lo)
    ref = dedispersion_search(data, *args, kernel="fdmt", device="cuda")
    ref_h = dedispersion_search(data, *args, kernel="hybrid", device="cuda")

    def wall(fn, runs=3):
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        return statistics.median(times)

    single_ms = wall(lambda: dedispersion_search(
        data, *args, kernel="fdmt", device="cuda"))
    single_h_ms = wall(lambda: dedispersion_search(
        data, *args, kernel="hybrid", device="cuda"))
    out = {}
    for shape in ((4, 1), (2, 2)):
        mesh = _card_mesh(torch, shape)
        slices = slice_delay_range(n_lo, n_hi, shape[0])
        kinds = [k for lo, hi in slices for k, _ in transform_schedule(
            fdmt_plan(NCHAN, START_FREQ, BANDWIDTH, hi, lo))]
        want = {"B3": kinds.count("head"), "B2a": kinds.count("merge"),
                "B2b": kinds.count("merge4")}
        reset_counts()
        table, handle = sharded_fdmt_search(data, *args, mesh=mesh,
                                            capture_plane=True)
        counts = read_counts()
        check(all(counts[k] == v for k, v in want.items())
              and counts["B3"] > 0 and counts["B2a"] + counts["B2b"] > 0
              and counts["B4"] == shape[0],
              f"mesh_fdmt {shape}: launches {counts}, schedule {want}")
        bitwise, max_diff = True, 0.0
        for (lo, hi), rows in zip(slices, handle.shards):
            part = full[lo - n_lo:hi - n_lo + 1]
            if not torch.equal(rows, part):
                bitwise = False
                max_diff = max(max_diff, float((rows - part).abs().max()))
                check(torch.allclose(rows, part, rtol=1e-4, atol=1e-4),
                      f"mesh_fdmt {shape}: slice {lo}-{hi} beyond 1e-4")
        if bitwise:
            check(_tables_bitwise(np, table, ref),
                  f"mesh_fdmt {shape}: equal rows, a different table")
        else:
            discrete, rel = _table_diff(np, table, ref)
            check(discrete and rel <= 1e-4,
                  f"mesh_fdmt {shape}: table discrete {discrete} rel {rel}")
        del handle
        fdmt_ms = wall(lambda: sharded_fdmt_search(data, *args, mesh=mesh))
        # the mesh key's kernel resolved before the counts: the tuner's
        # measurement launches belong to no search
        resolve_mesh_kernel(mesh, NCHAN, NSAMPLES, len(plan_dms),
                            START_FREQ, BANDWIDTH, TSAMP, plan_dms)
        runs = {}
        # fused=None is the card mesh's default: the two-stage composition
        for fused, label in ((True, "fused"), (None, "unfused")):
            reset_counts()
            budget = BudgetAccountant()
            with budget.chunk(0):
                t_h = sharded_hybrid_search(data, *args, mesh=mesh,
                                            fused=fused)
            hc = read_counts()
            stage = {k: v for k, v in budget.chunks[0]["counters"].items()
                     if k.startswith(("fused_", "rescore_", "dispatches",
                                      "readbacks"))}
            check(all(hc[k] > 0 for k in ("B1", "B3", "B4"))
                  and hc["B2a"] + hc["B2b"] > 0,
                  f"mesh_fdmt {shape} hybrid fused={fused}: launches {hc}")
            check(("fused_seed_rows" in stage) == (fused is True),
                  f"mesh_fdmt {shape} hybrid fused={fused}: counters "
                  f"{stage}")
            best, rbest = t_h.argbest(), ref_h.argbest()
            check(best == rbest and bool(t_h["exact"][best]) and all(
                t_h[c][best] == ref_h[c][best] for c in ("DM", "rebin",
                                                         "peak")),
                  f"mesh_fdmt {shape} hybrid fused={fused}: best row "
                  f"{best} vs the single device's {rbest}")
            rel = abs(float(t_h["snr"][best]) - float(ref_h["snr"][best])) \
                / abs(float(ref_h["snr"][best]))
            check(rel == 0.0 if shape[1] == 1 else rel <= MESH_SNR_RTOL,
                  f"mesh_fdmt {shape} hybrid: best snr rel diff {rel}")
            ms = wall(lambda: sharded_hybrid_search(data, *args, mesh=mesh,
                                                    fused=fused))
            runs[label] = dict(
                table=t_h, launches=hc, ms=ms, best_snr_rel_diff=rel,
                exact_rows=int(np.sum(t_h["exact"])), counters=stage)
        check(_tables_bitwise(np, runs["fused"]["table"],
                              runs["unfused"]["table"]),
              f"mesh_fdmt {shape}: the fused and unfused tables differ")
        # the fused round rescored what the loop's first round would, so
        # it launches no more than the two-stage path
        check(runs["fused"]["launches"]["B1"]
              <= runs["unfused"]["launches"]["B1"],
              f"mesh_fdmt {shape}: fused B1 {runs['fused']['launches']} "
              f"against two-stage {runs['unfused']['launches']}")
        out[shape] = {k: v["launches"] for k, v in runs.items()}
        out[shape]["fdmt"] = counts
        emit("mesh_fdmt", mesh=list(shape), slices=slices,
             data=[NCHAN, NSAMPLES], launches=counts,
             slices_bitwise=bitwise, slices_max_abs_diff=max_diff,
             fdmt_ms=fdmt_ms, single_fdmt_ms=single_ms,
             hybrid={k: {f: v[f] for f in ("launches", "ms",
                                          "best_snr_rel_diff",
                                          "exact_rows", "counters")}
                     for k, v in runs.items()},
             single_hybrid_ms=single_h_ms, fused_equals_unfused=True)
    del data, full
    torch.cuda.empty_cache()
    return out


def phase_e2e_mesh(torch, np, workdir, path, chunk_length, nchunks,
                   direct_hits, hybrid_hits):
    """``search_by_chunks(mesh=)`` on the end-to-end file on a (2, 2)
    mesh of the card, direct and hybrid at S/N 8: the single-device runs'
    hits (S/N within the mesh tolerance) and ledger ``done``, no fallback,
    no OOM descent; a persistent ``mesh``-site error raises with nothing
    marked done; the diagnostic figure's arrays from a ShardedPlane of a
    hit chunk (the figure itself where matplotlib is installed)."""
    from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec
    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader
    from pulsarutils_tpu_torch.ops.periodicity import period_search_plane
    from pulsarutils_tpu_torch.parallel.sharded import \
        sharded_dedispersion_search
    from pulsarutils_tpu_torch.pipeline.diagnostics import (figure_arrays,
                                                            plot_diagnostics)
    from pulsarutils_tpu_torch.pipeline.pulse_info import PulseInfo
    from pulsarutils_tpu_torch.pipeline.search_pipeline import (
        clean_chunk, plan_survey, search_by_chunks)

    mesh = _card_mesh(torch, (2, 2))
    common = dict(chunk_length=chunk_length, dmmin=DMMIN, dmmax=DMMAX,
                  snr_threshold=8.0, device="cuda", make_plots=False)
    starts = plan_survey(str(path), chunk_length=chunk_length, dmmin=DMMIN,
                         dmmax=DMMAX)["chunk_starts"]
    runs = {}
    for label, kernel, ref in (("direct", "auto", direct_hits),
                               ("hybrid_snr_8", "hybrid", hybrid_hits)):
        if ref is None:   # --mesh: the single-device run here
            ref, _ = search_by_chunks(
                str(path), kernel=kernel,
                output_dir=str(workdir / f"out_mesh_ref_{label}"), **common)
        from pulsarutils_tpu_torch.utils.logging_utils import \
            BudgetAccountant

        stages, summary, budget = {}, {}, BudgetAccountant()
        reset_counts()
        t0 = time.perf_counter()
        hits, store = search_by_chunks(
            str(path), kernel=kernel, mesh=mesh, stage_seconds=stages,
            summary=summary, budget=budget,
            output_dir=str(workdir / f"out_mesh_{label}"), **common)
        wall = time.perf_counter() - t0
        counts = read_counts()
        check_clean_run(summary, f"e2e_mesh {label}")
        bad = _hit_mismatch(hits, ref, snr_rtol=MESH_SNR_RTOL)
        check(bad is None, f"e2e_mesh {label}: hits differ from the "
              f"single-device run's: {bad}")
        check(store.done_chunks == starts, f"e2e_mesh {label}: ledger")
        # the direct run's per-shard kernel is the tuner's (B1 per shard,
        # or the gather); B4 scores each dm shard
        check(counts["B4"] >= 2 * nchunks
              and counts["B1"] in ((0, 4 * nchunks) if kernel == "auto"
                                   else range(1, 10 ** 6))
              and (kernel != "hybrid" or counts["B3"] > 0),
              f"e2e_mesh {label}: launches {counts}")
        if kernel == "hybrid":
            # a card mesh's hybrid is the two-stage composition
            check("search/fused" not in stages
                  and "search/coarse_readback" in stages,
                  f"e2e_mesh {label}: stages {sorted(stages)}")
        loop_s = wall - stages.get("badchans", 0.0)
        runs[label] = counts
        emit("e2e_mesh", run=label, mesh=[2, 2], chunks=nchunks,
             hits=len(hits), launches=counts, wall_s=wall,
             chunk_loop_s=loop_s, chunks_per_s=nchunks / loop_s,
             stage_seconds=stages, fallback=summary["fallback"],
             oom_descents=summary["oom_descents"], hits_equal_single=True,
             search_s_per_chunk=[
                 {k: round(v, 4) for k, v in c["buckets"].items()
                  if k.startswith("search")} for c in budget.chunks],
             budget_mesh=budget.to_json(max_per_chunk=0).get("mesh"))

    # a persistent mesh-site error: the card never falls back
    out = workdir / "out_mesh_persistent"
    plan = FaultPlan([FaultSpec(site="mesh", kind="error", times=None)])
    error = None
    with plan.armed():
        try:
            search_by_chunks(str(path), mesh=mesh, output_dir=str(out),
                             **common)
        except RuntimeError as exc:
            error = exc
    check(error is not None and "injected mesh error" in str(error)
          and plan.fired() == 2
          and not any(p.name.startswith("progress_")
                      for p in out.iterdir()),
          f"e2e_mesh persistent: {error!r}, fired {plan.fired()}")
    emit("e2e_mesh", run="mesh_persistent", error=repr(error),
         fired=plan.fired(), marked_done=0)

    # the figure of a hit chunk from the dm-sharded plane, and its
    # period search, shard by shard
    hit = max(direct_hits or ref, key=lambda h: h[2].snr)
    reader = FilterbankReader(str(path))
    chunk = clean_chunk(reader.read_block_tensor(hit[0], E2E_CHUNK, "cuda"),
                        torch.zeros(NCHAN, dtype=torch.bool, device="cuda"))
    reset_counts()
    table, handle = sharded_dedispersion_search(
        chunk, DMMIN, DMMAX, START_FREQ, BANDWIDTH, TSAMP, mesh=mesh,
        capture_plane=True, plane_handle=True)
    info = PulseInfo(allprofs=chunk, start_freq=START_FREQ,
                     bandwidth=BANDWIDTH, nbin=E2E_CHUNK, nchan=NCHAN,
                     pulse_freq=1.0 / (E2E_CHUNK * TSAMP))
    t0 = time.perf_counter()
    arrays = figure_arrays(info, table, handle)
    fig_s = time.perf_counter() - t0
    check(arrays["plane"].shape[0] == table.nrows
          and np.isfinite(arrays["plane"]).all()
          and np.isfinite(arrays["h"]).all()
          and arrays["h"].shape == (table.nrows,),
          "e2e_mesh figure arrays from the ShardedPlane")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        figure = "skipped (no matplotlib)"
        print("plots: skipped (no matplotlib)", flush=True)
    else:
        figure = plot_diagnostics(info, table, handle,
                                  outname=str(workdir / "mesh_figure.jpg"))
    pres = period_search_plane(handle, TSAMP,
                               fmin=4.0 / (E2E_CHUNK * TSAMP), refine_top=1)
    figure_counts = read_counts()
    check(figure_counts["B6"] > 0, f"e2e_mesh: {figure_counts}")
    emit("e2e_mesh", run="figure_from_sharded_plane", chunk=hit[0],
         images={k: list(arrays[k].shape) for k in ("raw", "dedisp",
                                                    "plane")},
         plane_factor=arrays["plane_factor"], figure=str(figure),
         seconds=fig_s, period_best_sigma=float(pres["best_sigma"]),
         launches=figure_counts)
    runs["figure_and_period_search"] = figure_counts
    del chunk, handle
    torch.cuda.empty_cache()
    return runs


def phase_mesh_period(torch, np, workdir, period):
    """The periodicity workload on a (2, 2) mesh of the card: the pulsar
    file's job (the single-device job's settings, the DM rows and trials
    split over the mesh) against the single-device job's best candidate,
    and ``ShardedPlane.spectral_scores`` (B6 per shard) of the pulse
    file's chunk plane on a (4, 1) mesh against the single-device
    spectral search of the same plane."""
    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader
    from pulsarutils_tpu_torch.ops.periodicity import _spectral_chunk
    from pulsarutils_tpu_torch.ops.search import dedispersion_search
    from pulsarutils_tpu_torch.parallel.sharded import \
        sharded_dedispersion_search
    from pulsarutils_tpu_torch.periodicity.driver import periodicity_search
    from pulsarutils_tpu_torch.pipeline.search_pipeline import clean_chunk

    path = workdir / "pulsar.fil"
    reader = FilterbankReader(str(path))
    chunk = clean_chunk(reader.read_block_tensor(0, E2E_CHUNK, "cuda"),
                        torch.zeros(NCHAN, dtype=torch.bool, device="cuda"))
    args = (DMMIN, DMMAX, START_FREQ, BANDWIDTH, TSAMP)
    _, plane = dedispersion_search(chunk, *args, capture_plane=True,
                                   kernel="pallas", device="cuda")
    fmin = 4.0 / (E2E_CHUNK * TSAMP)
    want = _spectral_chunk(plane, TSAMP, 16, fmin, None)
    reset_counts()
    _, handle = sharded_dedispersion_search(
        chunk, *args, mesh=_card_mesh(torch, (4, 1)), kernel="pallas",
        capture_plane=True, plane_handle=True)
    got = handle.spectral_scores(TSAMP, fmin=fmin)
    spec_counts = read_counts()
    # the same plane rows (chan = 1), transformed in other batches: rows
    # whose best cell is the same hold the same sigma within 1e-5, and the
    # pulsar's row (the best) is one of them
    same = (got["freq"] == want["freq"]) & (got["nharm"] == want["nharm"])
    rel = float(np.max(np.abs(got["sigma"][same] - want["sigma"][same])
                       / np.maximum(np.abs(want["sigma"][same]), 1e-30)))
    best = int(np.argmax(want["sigma"]))
    check(spec_counts["B6"] > 0 and same[best]
          and int(np.argmax(got["sigma"])) == best
          and same.mean() >= 0.99 and rel <= 1e-5,
          f"mesh_period spectral: B6 {spec_counts['B6']}, "
          f"{int(same.sum())}/{len(same)} rows alike, sigma rel {rel}")
    del chunk, plane, handle
    torch.cuda.empty_cache()

    stages, summary = {}, {}
    reset_counts()
    t0 = time.perf_counter()
    res = periodicity_search(
        str(path), DMMIN, DMMAX, accel_max=1000.0, n_accel=5, canary=True,
        output_dir=str(workdir / "out_puperiod_mesh"), device="cuda",
        chunk_length=E2E_CHUNK // 2 * TSAMP, snr_threshold=8.0,
        mesh=_card_mesh(torch, (2, 2)), stage_seconds=stages,
        summary=summary)
    wall = time.perf_counter() - t0
    job = read_counts()
    check_clean_run(summary, "mesh_period job")
    best, ref = res["candidates"][0], period["job"]["candidates"][0]
    keys = ("dm", "accel", "freq_bin", "nharm")
    check(all(best[k] == ref[k] for k in keys)
          and res["canary"]["recovered"],
          f"mesh_period job: best {[best[k] for k in keys]} vs the single "
          f"device's {[ref[k] for k in keys]}, canary {res['canary']}")
    check(job["B6"] > 0 and job["B1"] > 0, f"mesh_period job: {job}")
    emit("mesh_period", spectral_mesh=[4, 1],
         spectral_rows_alike=int(same.sum()), spectral_rows=len(same),
         spectral_sigma_max_rel_diff=rel, spectral_launches=spec_counts,
         job_mesh=[2, 2], best={k: best[k] for k in keys + ("sigma",)},
         single_best_sigma=ref["sigma"],
         sigma_rel_diff=abs(best["sigma"] - ref["sigma"]) / ref["sigma"],
         canary=res["canary"], launches=job, wall_s=wall,
         trial_sweep_s=res["seconds"]["trials"],
         single_trial_sweep_s=period["trial_sweep_s"], stage_seconds=stages)
    return {"spectral": spec_counts, "job": job}


#: the multi-process checks: (label, arguments of parallel.live, seconds)
#: both at the end-to-end chunk's width (1024 x 2^18, DM 300-635: 514
#: trials, the pulse at DM 400)
MULTIHOST_CHUNK = ["--nchan", str(NCHAN), "--nsamples", str(E2E_CHUNK),
                   "--dmmin", str(DMMIN), "--dmmax", str(DMMAX),
                   "--dm", str(E2E_DM)]
MULTIHOST_RUNS = (
    ("gloo_2_ranks", ["--nproc", "2", "--backend", "gloo", "--device",
                      "cuda:0", "--local", "2", "--chan", "2",
                      *MULTIHOST_CHUNK], 300),
    ("nccl_1_rank", ["--nproc", "1", "--backend", "nccl", "--device",
                     "cuda:0", "--local", "4", "--chan", "2",
                     *MULTIHOST_CHUNK], 300),
)


def phase_multihost():
    """``python -m pulsarutils_tpu_torch.parallel.live`` on the card at the
    e2e chunk's width: two gloo ranks each driving two virtual shards of
    cuda:0 (dm across the ranks, chan within), and one NCCL rank, the two
    runs started together (each its own processes and ports); each must
    print ``MULTIHOST LIVE: OK`` (every rank's sharded sweep, FDMT and
    hybrid tables, two-stage and fused, equal the single-process tables
    of the same mesh, bit for bit).  Every process started is stopped."""
    env = {k: v for k, v in os.environ.items() if k != "PUTPU_LIVE_RANK"}
    t0 = time.perf_counter()
    procs = []
    try:
        for label, extra, limit in MULTIHOST_RUNS:
            procs.append((label, extra, limit, subprocess.Popen(
                [sys.executable, "-m", "pulsarutils_tpu_torch.parallel.live",
                 "--timeout", str(limit - 30), *extra],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=str(REPO), env=env)))
        for label, extra, limit, proc in procs:
            try:
                out, err = proc.communicate(
                    timeout=max(limit - (time.perf_counter() - t0), 1))
            except subprocess.TimeoutExpired as exc:
                raise CheckFailed(f"multihost {label}: timed out") from exc
            seconds = time.perf_counter() - t0
            lines = out.strip().splitlines()
            check(proc.returncode == 0 and "MULTIHOST LIVE: OK" in out,
                  f"multihost {label}: rc {proc.returncode}: "
                  f"{out[-1500:]} {err[-1500:]}")
            emit("multihost", run=label, args=extra,
                 seconds_since_both_started=seconds, result=lines[-1],
                 ranks=[ln for ln in lines if ln.startswith("rank ")])
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


# ---------------------------------------------------------------------------
# Streaming and batched beams (A6): e2e_beams, e2e_stream, ring
# ---------------------------------------------------------------------------

#: e2e_beams: beams of the end-to-end geometry, BEAM_BLOCKS blocks of 2^17
#: samples (2 chunks of 2^18 at 50% overlap: depth cut from 5 blocks and 4
#: chunks to fit the script's time); beam 1 alone holds a DM 400 pulse
#: mid-block BEAM_PULSE_BLOCK (sample 327,680, chunk 1 only), every beam
#: one mid-block BEAM_RFI_BLOCK (sample 65,536, chunk 0 only): the sift
#: confirms the first and vetoes the second
BEAM_COUNT = 4
BEAM_BLOCKS = 3
BEAM_PULSE_BEAM = 1
BEAM_PULSE_BLOCK = 2
BEAM_RFI_BLOCK = 0

#: the ring phase's trials: evenly spaced over the end-to-end plan, its
#: first and last (DM 635, the widest span) among them
RING_TRIALS = 64


def _write_beam_files(torch, np, workdir, seed, nbits=8,
                      nblocks=BEAM_BLOCKS, nbeams=BEAM_COUNT):
    """The beams' filterbanks (``nbeams`` and ``ibeam`` in their headers),
    written block by block from the card: 8 bits as
    :func:`_write_block_file` draws them (``|N(0, 8)|`` + 20, a 12 impulse
    a channel); 2 bits ``N(1.5, 0.6)`` codes with a 1.5 impulse a channel,
    rounded and packed on the card by the writer (``encode_frames``).
    Each beam its own generator; the pulses are dispersed at DM 400."""
    from pulsarutils_tpu_torch.io.sigproc import (FilterbankWriter,
                                                  header_from_simulated)
    from pulsarutils_tpu_torch.ops.plan import dedispersion_shifts

    block = E2E_CHUNK // 2
    sim = {"nchans": NCHAN, "bandwidth": BANDWIDTH, "fbottom": START_FREQ,
           "tsamp": TSAMP}
    shifts = np.rint(dedispersion_shifts(NCHAN, E2E_DM, START_FREQ,
                                         BANDWIDTH, TSAMP)).astype(np.int64)
    idx = ((torch.arange(block, device="cuda")[None, :]
            - torch.from_numpy(shifts).cuda()[:, None]) % block)
    paths = []
    for b in range(nbeams):
        header = {"nchans": NCHAN, "nbits": nbits, "nifs": 1, "tstart": 0.0,
                  "source_name": f"chip_smoke_beam{b}", "machine_id": 0,
                  "telescope_id": 0, "data_type": 1, "nbeams": BEAM_COUNT,
                  "ibeam": b, **header_from_simulated(sim, descending=True)}
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1000 * seed + 17 + b)
        path = workdir / f"beam{b}_{nbits}bit.fil"
        with FilterbankWriter(str(path), header) as writer:
            for k in range(nblocks):
                x = torch.randn((NCHAN, block), generator=gen, device="cuda")
                pulse = (k == BEAM_RFI_BLOCK
                         or (b == BEAM_PULSE_BEAM and k == BEAM_PULSE_BLOCK))
                if nbits == 8:
                    x *= 8.0
                    if pulse:
                        x[:, block // 2] += 12.0
                    x = torch.gather(x.abs_(), 1, idx) + 20.0
                else:
                    x = x * 0.6 + 1.5
                    if pulse:
                        x[:, block // 2] += 1.5
                    x = torch.gather(x, 1, idx)
                writer.write_frames(writer.encode_frames(x.flip(0).T))
                del x
        paths.append(path)
    torch.cuda.empty_cache()
    return paths


def _counter_value(name, **labels):
    from pulsarutils_tpu_torch.obs import metrics

    return metrics.REGISTRY.counter(name, **labels).value


def _oom_events():
    from pulsarutils_tpu_torch.obs import metrics

    return sum(m.get("value", 0) for m in metrics.REGISTRY.snapshot()
               if m.get("name") == "putpu_oom_events_total")


def _beam_tables_equal(np, ours, ref):
    """Two multibeam results with equal per-beam tables, bit for bit."""
    for a, b in zip(ours["beams"], ref["beams"]):
        if [s for s, _ in a["tables"]] != [s for s, _ in b["tables"]]:
            return False
        if not all(_tables_bitwise(np, t1, t2)
                   for (_, t1), (_, t2) in zip(a["tables"], b["tables"])):
            return False
    return True


def phase_e2e_beams(torch, np, workdir, seed):
    """Four beams of the end-to-end geometry through ``multibeam_search``
    on the card, batched and beam by beam: the tables, ledgers and
    candidate files bit for bit, 1 dispatch and 1 readback an epoch
    against 4 and 4, B4 once a trial block of every beam-chunk, the
    coincidence sift confirming the one-beam pulse and vetoing the
    all-beam one; the cold ``|b4`` tuning timed once before the arms;
    2-bit copies of 2 beams on 1 chunk, ``packed="device"`` against
    ``"host"``,
    byte for byte, with the upload ratio (both arms decode with the same
    torch function, on the card and on the host: ``e2e_lowbit_unpack``
    holds it against the NumPy decode); an injected ``beams`` OOM on
    two 2-bit copies' first epoch (the ``halve_batch`` rung, the same
    tables)."""
    from pulsarutils_tpu_torch.beams import multibeam_search
    from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec
    from pulsarutils_tpu_torch.ops.search import auto_chan_block
    from pulsarutils_tpu_torch.resilience import ladder
    from pulsarutils_tpu_torch.tuning import autotune
    from pulsarutils_tpu_torch.tuning.geometry import geometry_key
    from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

    t0 = time.perf_counter()
    paths = _write_beam_files(torch, np, workdir, seed)
    emit("e2e_beams_files", beams=BEAM_COUNT, nchan=NCHAN,
         nsamples=E2E_NSAMPLES, nbits=8,
         bytes=sum(p.stat().st_size for p in paths),
         seconds=time.perf_counter() - t0)
    dms = e2e_trial_dms()
    ndm = len(dms)
    nblocks = -(-ndm // 32)
    chunk_length = E2E_CHUNK // 2 * TSAMP

    # the cold batch-keyed tuning, once; the arms below run warm
    reset_counts()
    t0 = time.perf_counter()
    kernel = autotune.resolve_batched_kernel(
        NCHAN, E2E_CHUNK, ndm, BEAM_COUNT, START_FREQ, BANDWIDTH, TSAMP,
        dms, dm_block=32, chan_block=auto_chan_block(NCHAN, E2E_CHUNK, 32),
        device="cuda")
    tune_s = time.perf_counter() - t0
    key = geometry_key("gpu", NCHAN, E2E_CHUNK, ndm, batch=BEAM_COUNT)
    check(key.endswith(f"|b{BEAM_COUNT}") and kernel in ("roll", "gather"),
          f"e2e_beams tuning: {key} -> {kernel}")
    emit("e2e_beams_tuning", key=key, kernel=kernel, seconds=tune_s,
         probe_launches=read_probe_counts())

    def arm(label, out, main=True, **kw):
        acc = BudgetAccountant()
        uploaded = _counter_value("putpu_bytes_uploaded_total")
        oom0 = _oom_events()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = multibeam_search(
            [str(p) for p in kw.pop("paths", paths)], DMMIN, DMMAX,
            snr_threshold=8.0, chunk_length=chunk_length,
            output_dir=str(workdir / out), budget=acc, keep_tables=True,
            device="cuda", **kw)
        wall = time.perf_counter() - t0
        counts = read_counts()
        if main:
            check(ladder.level() == 0 and _oom_events() == oom0,
                  f"e2e_beams {label}: an OOM descent on a main run")
        record = acc.to_json(max_per_chunk=0)
        rec = {"wall_s": wall, "epochs": len(acc.chunks),
               "dispatches": acc.counters_total.get("dispatches", 0),
               "readbacks": acc.counters_total.get("readbacks", 0),
               "buckets_s": record["buckets_s"],
               "bytes_uploaded": _counter_value(
                   "putpu_bytes_uploaded_total") - uploaded,
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "launches": counts}
        emit("e2e_beams", run=label, kernel=kernel,
             hits={b["beam"]: len(b["hits"]) for b in res["beams"]},
             **rec)
        return res, rec

    batched, brec = arm("batched", "beams_batched", batched=True)
    sequential, srec = arm("sequential", "beams_sequential", batched=False)
    nchunks = brec["epochs"]
    check(nchunks == BEAM_BLOCKS - 1, f"e2e_beams: {nchunks} epochs")
    for label, rec, trips in (("batched", brec, nchunks),
                              ("sequential", srec, BEAM_COUNT * nchunks)):
        check(rec["launches"]["B4"] == BEAM_COUNT * nchunks * nblocks
              and rec["launches"]["B1"] == 0,
              f"e2e_beams {label}: launches {rec['launches']}, predicted "
              f"B4 {BEAM_COUNT * nchunks * nblocks}")
        check(rec["dispatches"] == trips and rec["readbacks"] == trips,
              f"e2e_beams {label}: {rec['dispatches']} dispatches, "
              f"{rec['readbacks']} readbacks for {nchunks} epochs")
    # each arm uploads every beam-chunk once, one beam's operand on the
    # card at a time
    check(brec["bytes_uploaded"] == srec["bytes_uploaded"]
          == BEAM_COUNT * nchunks * NCHAN * E2E_CHUNK * 4
          and brec["peak_device_bytes"]
          <= 1.25 * srec["peak_device_bytes"],
          f"e2e_beams: uploads {brec['bytes_uploaded']} batched, "
          f"{srec['bytes_uploaded']} beam by beam; peak "
          f"{brec['peak_device_bytes']} batched, "
          f"{srec['peak_device_bytes']} beam by beam")
    check(_beam_tables_equal(np, batched, sequential),
          "e2e_beams: batched tables differ from the sequential ones")
    check(_snapshot(np, workdir / "beams_batched")
          == _snapshot(np, workdir / "beams_sequential"),
          "e2e_beams: ledgers or candidate files differ")
    groups = batched["coincidence"]["groups"]
    confirmed = [g for g in groups if g["verdict"] == "confirmed"
                 and g["beams"] == [BEAM_PULSE_BEAM]]
    vetoed = [g for g in groups if g["verdict"] == "rfi"
              and g["n_beams"] == BEAM_COUNT]
    pulse_t = (BEAM_PULSE_BLOCK * E2E_CHUNK // 2 + E2E_CHUNK // 4) * TSAMP
    rfi_t = (BEAM_RFI_BLOCK * E2E_CHUNK // 2 + E2E_CHUNK // 4) * TSAMP
    spacing = float(dms[1] - dms[0])
    check(any(abs(g["time"] - pulse_t) < 1.0
              and abs(g["dm"] - E2E_DM) <= 2 * spacing for g in confirmed),
          f"e2e_beams: the one-beam pulse was not confirmed: {groups}")
    check(any(abs(g["time"] - rfi_t) < 1.0 for g in vetoed),
          f"e2e_beams: the all-beam pulse was not vetoed: {groups}")
    emit("e2e_beams_coincidence", stats=batched["coincidence"]["stats"],
         groups=[{k: g[k] for k in ("verdict", "beams", "n_members",
                                    "time", "dm", "snr")}
                 for g in groups],
         batched_search_over_sequential=(brec["buckets_s"]["search"]
                                         / srec["buckets_s"]["search"]),
         tables_equal=True, files_equal=True)

    # 2-bit copies of 2 beams on 1 chunk (depth cut from 4 beams and 2
    # chunks): device unpack against host unpack
    t0 = time.perf_counter()
    packed_paths = _write_beam_files(torch, np, workdir, seed, nbits=2,
                                     nblocks=2, nbeams=2)
    write_s = time.perf_counter() - t0
    dev, drec = arm("packed_device", "beams_packed_device",
                    paths=packed_paths, packed="device")
    host, hrec2 = arm("packed_host", "beams_packed_host",
                      paths=packed_paths, packed="host")
    check(drec["epochs"] == 1 and drec["launches"]["B4"]
          == len(packed_paths) * nblocks == hrec2["launches"]["B4"],
          f"e2e_beams packed: {drec['launches']}, {hrec2['launches']}")
    check(_beam_tables_equal(np, dev, host)
          and _snapshot(np, workdir / "beams_packed_device")
          == _snapshot(np, workdir / "beams_packed_host"),
          "e2e_beams packed: device and host arms differ")
    check(any(b["hits"] for b in dev["beams"]),
          "e2e_beams packed: no hit on the 2-bit pulse")
    ratio = hrec2["bytes_uploaded"] / drec["bytes_uploaded"]
    check(ratio == 16, f"e2e_beams packed: upload ratio {ratio}")
    emit("e2e_beams_packed", nbits=2, chunks=1, write_s=write_s,
         upload_ratio_host_over_device=ratio, tables_equal=True,
         files_equal=True)

    # the halve_batch rung on the first epoch of the packed device arm's
    # two beams (depth cut from four)
    plan = FaultPlan([FaultSpec(site="beams", kind="oom", times=1)])
    steps = _counter_value("putpu_oom_ladder_steps_total", step="halve_batch")
    with plan.armed():
        halved, hrec = arm("halve_batch", "beams_halved", main=False,
                           paths=packed_paths[:2], packed="device",
                           max_chunks=1, resume=False)
    check(plan.fired() == 1 and _counter_value(
        "putpu_oom_ladder_steps_total", step="halve_batch") == steps + 1
          and hrec["dispatches"] == 2
          and hrec["launches"]["B4"] == 2 * nblocks,
          f"e2e_beams halve_batch: fired {plan.fired()}, {hrec}")
    for a, b in zip(halved["beams"], dev["beams"]):
        check(_tables_bitwise(np, a["tables"][0][1], b["tables"][0][1]),
              f"e2e_beams halve_batch: beam {a['beam']} table differs")
    ladder.reset()
    for p in paths + packed_paths:
        p.unlink()
    return {"multibeam batched (e2e_beams)": brec["launches"],
            "multibeam beam by beam (e2e_beams)": srec["launches"],
            "multibeam halve_batch rung, 2-bit, 2 beams, 1 epoch (e2e_beams)":
                hrec["launches"],
            "multibeam 2-bit packed=device (e2e_beams)": drec["launches"],
            "multibeam 2-bit packed=host (e2e_beams)": hrec2["launches"]}


def phase_e2e_stream(torch, np, workdir, path, chunk_length, seed):
    """``stream_search`` over the end-to-end file's cleaned chunks, made
    on the card by a generator (the bad-channel mask, the read and the
    clean of the chunk loop), direct and hybrid at S/N 8: every hit
    chunk's table equal bit for bit to ``search_by_chunks``' on the same
    file, the same hits.  Then on a (2, 2) mesh of the card (the direct
    run's hits, S/N within the mesh tolerance), with the canary in every
    chunk (the science hits unchanged), with a persistent dispatch error
    on one chunk under ``skip_failed`` (the other chunks' tables the
    direct run's), and a 2-bit packed chunk against its host unpack
    (bit for bit; the host unpack is the same torch decode run on the
    host, which ``e2e_lowbit_unpack`` holds against the NumPy decode)."""
    from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec
    from pulsarutils_tpu_torch.io.lowbit import PackedFrames, pack_codes
    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader
    from pulsarutils_tpu_torch.obs.canary import CanaryController
    from pulsarutils_tpu_torch.parallel.stream import stream_search
    from pulsarutils_tpu_torch.pipeline.search_pipeline import (
        clean_chunk, plan_survey, search_by_chunks)
    from pulsarutils_tpu_torch.pipeline.spectral_stats import get_bad_chans
    from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

    reader = FilterbankReader(str(path))
    starts = plan_survey(str(path), chunk_length=chunk_length, dmmin=DMMIN,
                         dmmax=DMMAX)["chunk_starts"]
    mask = get_bad_chans(str(path))
    if reader.band_descending:
        mask = mask[::-1]
    mask = torch.as_tensor(mask.copy()).cuda()
    geom = (DMMIN, DMMAX, START_FREQ, BANDWIDTH, TSAMP)

    def producer(pulled):
        for s in starts:
            pulled.append(s)
            yield s, clean_chunk(reader.read_block_tensor(s, E2E_CHUNK,
                                                          "cuda"), mask)

    launches, out = {}, {}

    def run(label, **kw):
        acc, pulled = BudgetAccountant(), []
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        results, hits = stream_search(producer(pulled), *geom,
                                      snr_threshold=8.0, device="cuda",
                                      budget=acc, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        launches[f"stream_search {label} (e2e_stream)"] = counts
        emit("e2e_stream", run=label, chunks=len(results), hits=len(hits),
             launches=counts, wall_s=wall,
             buckets_s=acc.to_json(max_per_chunk=0)["buckets_s"],
             search_s_per_chunk=[c["buckets"].get("search")
                                 for c in acc.chunks])
        return results, hits

    for label, kernel in (("direct", "pallas"), ("hybrid", "hybrid")):
        ref, _ = search_by_chunks(
            str(path), chunk_length=chunk_length, dmmin=DMMIN, dmmax=DMMAX,
            snr_threshold=8.0, kernel=kernel, device="cuda",
            make_plots=False, output_dir=str(workdir / f"stream_ref_{label}"))
        results, hits = run(label, kernel=kernel)
        check([s for s, _ in results] == starts,
              f"e2e_stream {label}: chunks {[s for s, _ in results]}")
        check([h[0] for h in hits] == [h[0] for h in ref] and ref,
              f"e2e_stream {label}: hits {[h[0] for h in hits]} vs "
              f"{[h[0] for h in ref]}")
        tables = dict(results)
        for lo, _, _, rtable in ref:
            check(_tables_bitwise(np, tables[lo], rtable),
                  f"e2e_stream {label}: chunk {lo}'s table differs from "
                  "search_by_chunks'")
        out[label] = (results, hits)
    direct_results, direct_hits = out["direct"]

    _, mesh_hits = run("direct on a 2x2 mesh", mesh=_card_mesh(torch,
                                                               (2, 2)))
    check([h[0] for h in mesh_hits] == [h[0] for h in direct_hits]
          and all(a[2]["DM"] == b[2]["DM"] and a[2]["rebin"] == b[2]["rebin"]
                  and abs(a[2]["snr"] - b[2]["snr"])
                  <= MESH_SNR_RTOL * abs(b[2]["snr"])
                  for a, b in zip(mesh_hits, direct_hits)),
          "e2e_stream mesh: hits differ from one device's")

    canary = CanaryController(rate=1.0, seed=seed)
    _, canary_hits = run("direct, canary in every chunk", kernel="pallas",
                         canary=canary)
    summary = canary.summary()
    check([h[0] for h in canary_hits] == [h[0] for h in direct_hits]
          and summary["injected"] == len(starts)
          and summary["recovered"] == len(starts),
          f"e2e_stream canary: hits {[h[0] for h in canary_hits]}, "
          f"{summary}")

    plan = FaultPlan([FaultSpec(site="dispatch", chunks=(starts[1],),
                                times=None)])
    with plan.armed():
        kept, _ = run("direct, skip_failed with one failing chunk",
                      kernel="pallas", skip_failed=True)
    ref_tables = dict(direct_results)
    check([s for s, _ in kept] == [s for s in starts if s != starts[1]]
          and all(_tables_bitwise(np, t, ref_tables[s]) for s, t in kept),
          f"e2e_stream skip_failed: {[s for s, _ in kept]}")

    # a 2-bit packed chunk, drawn and packed on the card
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 99)
    codes = (torch.randn((E2E_CHUNK, NCHAN), generator=gen, device="cuda")
             * 0.6 + 1.5).round_().clamp_(0, 3).to(torch.uint8)
    frames = pack_codes(codes, 2).cpu().numpy()
    packed = PackedFrames(frames, 2, NCHAN, band_descending=True)
    uploaded = _counter_value("putpu_bytes_uploaded_total")
    (_, t_packed), = stream_search([(0, packed)], *geom, device="cuda",
                                   kernel="pallas")[0]
    mid = _counter_value("putpu_bytes_uploaded_total")
    (_, t_host), = stream_search([(0, packed.to_host())], *geom,
                                 device="cuda", kernel="pallas")[0]
    ratio = (_counter_value("putpu_bytes_uploaded_total") - mid) \
        / (mid - uploaded)
    check(_tables_bitwise(np, t_packed, t_host) and ratio == 16,
          f"e2e_stream packed: tables equal "
          f"{_tables_bitwise(np, t_packed, t_host)}, ratio {ratio}")
    emit("e2e_stream_packed", nbits=2, upload_ratio_host_over_packed=ratio,
         tables_equal=True)
    return launches


def phase_ring(torch, np, seed):
    """``ring_dedisperse`` on virtual ``("time",)`` meshes of the card:
    the end-to-end chunk (1024 x 2^18, 64 trials of the end-to-end plan,
    4 shards: one hop) and a multi-hop case (1024 x 4096, 8 shards);
    bit for bit with its plain program (``ring_plain``), within rtol 1e-4
    and atol 1e-3 of B1's plane of the same trials; ms and peak bytes."""
    from pulsarutils_tpu_torch.ops.dedisperse_cuda import dedisperse_plane
    from pulsarutils_tpu_torch.ops.plan import offsets_for
    from pulsarutils_tpu_torch.parallel.stream import (_ring_geometry,
                                                       ring_dedisperse,
                                                       ring_plain)

    all_dms = e2e_trial_dms()
    dms = all_dms[np.unique(np.linspace(0, len(all_dms) - 1,
                                        RING_TRIALS).round().astype(int))]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 4242)
    out = {}
    for label, nsamples, shards in (("e2e_chunk", E2E_CHUNK, 4),
                                    ("multi_hop", 4096, 8)):
        data = torch.randn((NCHAN, nsamples), generator=gen, device="cuda")
        mesh = _card_mesh(torch, (shards,), ("time",))
        _, t_loc, hops, _ = _ring_geometry(NCHAN, nsamples, shards, dms,
                                           START_FREQ, BANDWIDTH, TSAMP)
        geom = (dms, START_FREQ, BANDWIDTH, TSAMP)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ring = ring_dedisperse(data, *geom, mesh)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms, _ = time_ms(torch, lambda: ring_dedisperse(data, *geom, mesh),
                        runs=2)
        plain = ring_plain(data, *geom, shards)
        plain_ms, _ = time_ms(torch, lambda: ring_plain(data, *geom, shards),
                              runs=2)
        b1 = dedisperse_plane(data, offsets_for(dms, NCHAN, START_FREQ,
                                                BANDWIDTH, TSAMP, nsamples))
        diff = float((ring - b1).abs().max())
        check(torch.equal(ring, plain),
              f"ring {label}: differs from its plain program")
        check(torch.allclose(ring, b1, rtol=1e-4, atol=1e-3),
              f"ring {label}: max |diff| {diff} from B1's plane")
        check(hops == (1 if label == "e2e_chunk" else 2),
              f"ring {label}: {hops} hops")
        emit("ring", case=label, nchan=NCHAN, nsamples=nsamples,
             shards=shards, t_loc=t_loc, trials=len(dms), hops=hops,
             plain_equal=True, b1_max_abs_diff=diff,
             b1_bitwise=bool(torch.equal(ring, b1)), ms=ms,
             plain_ms=plain_ms, peak_device_bytes=peak)
        out[label] = ms
        del data, ring, plain, b1
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The live feed and the job service (A10a, A15): e2e_ingest, e2e_service
# ---------------------------------------------------------------------------

#: a CLI child: ``python3 -c CHILD_CODE OUT.json MODULE ARGS...`` from the
#: checkout runs ``MODULE.main(ARGS)`` (:func:`cli_child`)
CHILD_CODE = ("import sys, chip_smoke; "
              "sys.exit(chip_smoke.cli_child(sys.argv[1:]))")

#: every child process started, killed in :func:`main`'s ``finally`` if a
#: failed check left one running
_CHILDREN = []


def cli_child(argv):
    """Run a CLI of the package, ``MODULE.main(ARGS)``, in this process
    under a counting tuner (the tune cache of ``$PUTPU_TUNE_CACHE``) and
    write ``OUT.json``: its exit code and wall seconds, the launches of
    every kernel outside the tuner's measurements, and one record a call
    of ``stream_search``, ``multibeam_search``, ``periodicity_search``
    and ``search_by_chunks`` (the fleet worker's entry point; not the
    calls the periodicity job makes): its launches, seconds and budget; a
    search's leased chunks, fence, hits and ledger; a stream's chunk
    digests, hits and tables, the tables as ``table_<istart>.npz`` in the
    directory ``OUT``; the live feed's wire times from ``ChunkAssembler.push``.
    The CLI runs unchanged: the calls are wrapped, not replaced."""
    import importlib

    import numpy as np

    sys.path.insert(0, str(REPO))
    from pulsarutils_tpu_torch.beams import multibeam
    from pulsarutils_tpu_torch.ingest import assembler
    from pulsarutils_tpu_torch.parallel import stream
    from pulsarutils_tpu_torch.periodicity import driver
    from pulsarutils_tpu_torch.pipeline import search_pipeline
    from pulsarutils_tpu_torch.tuning import autotune
    from pulsarutils_tpu_torch.tuning.cache import TuneCache
    from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

    out_path, module, *args = argv
    tables_dir = Path(out_path).with_suffix("")
    tables_dir.mkdir(parents=True, exist_ok=True)
    autotune.set_tuner(_counting_tuner(TuneCache(
        os.environ["PUTPU_TUNE_CACHE"])))
    reset_counts()
    calls = []
    wire = {"first": None, "last": None, "packets": 0, "bytes": 0}
    #: recorded calls in progress: a search_by_chunks inside another
    #: recorded call (the periodicity job's) is that call's, not a record
    depth = [0]

    def recorded(name, fn):
        def wrapper(*a, **kw):
            if name == "search_by_chunks" and depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            try:
                return record(*a, **kw)
            finally:
                depth[0] -= 1

        def record(*a, **kw):
            rec = {"call": name}
            acc = None
            if name != "periodicity_search" and kw.get("budget") is None:
                acc = kw["budget"] = BudgetAccountant()
            digests = {}
            if name == "stream_search":
                def digesting(chunks):
                    for istart, chunk in chunks:
                        digests[int(istart)] = _sha1(
                            np, getattr(chunk, "frames", chunk))
                        yield istart, chunk

                a = (digesting(a[0]),) + a[1:]
            before = read_counts()
            t0 = time.perf_counter()
            result = fn(*a, **kw)
            rec["seconds"] = time.perf_counter() - t0
            after = read_counts()
            rec["launches"] = {k: after[k] - before.get(k, 0) for k in after}
            if acc is not None:
                record = acc.to_json(max_per_chunk=0)
                rec["buckets_s"] = record["buckets_s"]
                rec["counters"] = dict(acc.counters_total)
                rec["search_s_per_chunk"] = [c["buckets"].get("search")
                                             for c in acc.chunks]
            if name == "stream_search":
                results, hits = result
                rec.update(digests={str(k): v for k, v in digests.items()},
                           chunks=[int(s) for s, _ in results],
                           hits=[int(h[0]) for h in hits])
                for s, table in results:
                    table.to_npz(str(tables_dir / f"table_{int(s)}.npz"))
            elif name == "search_by_chunks":
                hits, store = result
                rec.update(fname=str(a[0]), chunks=kw.get("chunks"),
                           fence=kw.get("fence"),
                           hits=[int(h[0]) for h in hits],
                           done=store.done_chunks,
                           fenced_rejects=store.fenced_rejects)
            elif name == "multibeam_search":
                rec["fnames"] = [str(f) for f in a[0]]
                rec["beams"] = [{"chunks_done": b["chunks_done"],
                                 "cancelled": b["cancelled"],
                                 "hits": [int(h[0]) for h in b["hits"]]}
                                for b in result["beams"]]
            else:
                rec["complete"] = result["complete"]
                rec["fname"] = str(a[0])
            calls.append(rec)
            return result
        return wrapper

    stream.stream_search = recorded("stream_search", stream.stream_search)
    multibeam.multibeam_search = recorded("multibeam_search",
                                          multibeam.multibeam_search)
    driver.periodicity_search = recorded("periodicity_search",
                                         driver.periodicity_search)
    search_pipeline.search_by_chunks = recorded(
        "search_by_chunks", search_pipeline.search_by_chunks)
    real_push = assembler.ChunkAssembler.push

    def push(self, packet):
        now = time.perf_counter()
        if wire["first"] is None:
            wire["first"] = now
        placed = real_push(self, packet)
        wire["last"] = time.perf_counter()
        wire["packets"] += 1
        wire["bytes"] += len(packet.payload)
        return placed

    assembler.ChunkAssembler.push = push
    t0 = time.perf_counter()
    rc = importlib.import_module(module).main(args)
    doc = {"rc": rc, "wall_s": time.perf_counter() - t0,
           "counts": read_counts(), "probe": read_probe_counts(),
           "calls": calls, "wire": wire}
    Path(out_path).write_text(json.dumps(doc))
    return rc


def _start_child(workdir, label, module, args):
    """Start a CLI child (:func:`cli_child`) with its output in
    ``<label>.log``; returns ``(process, OUT.json path, log path)``."""
    out = workdir / f"{label}.json"
    log = workdir / f"{label}.log"
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", CHILD_CODE, str(out), module, *args],
            cwd=str(REPO), stdout=fh, stderr=subprocess.STDOUT, text=True)
    _CHILDREN.append(proc)
    return proc, out, log


def _wait_for_line(proc, log, pattern, timeout):
    """The first match of ``pattern`` in a child's log, waiting at most
    ``timeout`` seconds; fails if the child exits first."""
    import re

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        m = re.search(pattern, log.read_text())
        if m:
            return m
        check(proc.poll() is None, f"{log.name}: the child exited "
              f"({proc.returncode}) before {pattern!r}: "
              f"{log.read_text()[-3000:]}")
        time.sleep(0.05)
    raise CheckFailed(f"{log.name}: no {pattern!r} in {timeout} s")


def _stop_child(proc, sig=None, timeout=120):
    """End a child: ``sig`` first when given, then wait; kill it if it
    has not ended by ``timeout``.  Returns its exit code."""
    import signal

    if proc.poll() is None and sig is not None:
        proc.send_signal(getattr(signal, sig))
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        raise CheckFailed(f"a child did not end in {timeout} s") from None


def _sha1(np, data):
    import hashlib

    return hashlib.sha1(np.ascontiguousarray(data)).hexdigest()


def _write_2bit_stream_file(torch, np, path, seed, nblocks=4):
    """A 2-bit single-IF file of the end-to-end geometry: ``nblocks``
    blocks of 2^17 samples of ``N(1.5, 0.6)`` codes (2 chunks of 2^18
    at 4 blocks) with a 1.5 impulse a channel mid-block 2 dispersed at
    DM 400, drawn, rounded and packed on the card, descending band."""
    from pulsarutils_tpu_torch.io.sigproc import (FilterbankWriter,
                                                  header_from_simulated)
    from pulsarutils_tpu_torch.ops.plan import dedispersion_shifts

    block = E2E_CHUNK // 2
    sim = {"nchans": NCHAN, "bandwidth": BANDWIDTH, "fbottom": START_FREQ,
           "tsamp": TSAMP}
    shifts = np.rint(dedispersion_shifts(NCHAN, E2E_DM, START_FREQ,
                                         BANDWIDTH, TSAMP)).astype(np.int64)
    idx = ((torch.arange(block, device="cuda")[None, :]
            - torch.from_numpy(shifts).cuda()[:, None]) % block)
    header = {"nchans": NCHAN, "nbits": 2, "nifs": 1, "tstart": 0.0,
              "source_name": "chip_smoke_ingest", "machine_id": 0,
              "telescope_id": 0, "data_type": 1,
              **header_from_simulated(sim, descending=True)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1913)
    with FilterbankWriter(str(path), header) as writer:
        for k in range(nblocks):
            x = torch.randn((NCHAN, block), generator=gen,
                            device="cuda") * 0.6 + 1.5
            if k == 2:
                x[:, block // 2] += 1.5
            x = torch.gather(x, 1, idx)
            writer.write_frames(writer.encode_frames(x.flip(0).T))
            del x
    torch.cuda.empty_cache()


#: ``PUingest listen``'s idle timeout in ``e2e_ingest``: longer than the
#: feeder's start-up (the interpreter, and the 2.7 GB read and packetised)
LISTEN_IDLE_S = 30


def phase_e2e_ingest(torch, np, workdir, path, seed):
    """The live feed (``PUingest``) at the end-to-end file's width.

    ``listen --like FILE --step 262144 --port 0`` (a child process,
    :func:`cli_child`) and ``feed FILE --port P`` (another) send the
    file over TCP as float32 frames: the delivered chunks are the file's
    samples byte for byte, each chunk's table ``stream_search``'s over
    the same chunks read from disk bit for bit, the hits equal (the
    pulse at its DM), B1 and B4 launched, the summary ``unaccounted: 0``
    and shed 0.  Then in this process, on a 2-bit file of 2 chunks
    packed on the wire (``PackedFrames`` to the device unpack): the
    lossless feed (tables the disk stream's of the same file); one
    ``FaultPlan`` per ``ingest`` kind on one packet of chunk 1 (drop,
    reorder, duplicate, corrupt, disconnect, burst) and a drop of most
    of chunk 1 (a ``feed_gap`` quarantine), each held as the JAX
    package's ``test_ingest.py`` holds it; a consumer slower than the
    feed under a queue of one chunk (``shed_overrun``); one chunk over
    UDP.  Each run prints its wall seconds, wire MB/s, packets/s and
    search stage seconds."""
    import threading

    from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec, reasons
    from pulsarutils_tpu_torch.faults.policy import QuarantineManifest
    from pulsarutils_tpu_torch.ingest import (ChunkAssembler, TCPSource,
                                              UDPSource, feed_tcp, feed_udp)
    from pulsarutils_tpu_torch.io import packets
    from pulsarutils_tpu_torch.io.lowbit import PackedFrames
    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader
    from pulsarutils_tpu_torch.obs.health import HealthEngine
    from pulsarutils_tpu_torch.parallel.stream import stream_search
    from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant
    from pulsarutils_tpu_torch.utils.table import ResultTable

    step = E2E_CHUNK
    geom = (DMMIN, DMMAX, START_FREQ, BANDWIDTH, TSAMP)
    dms = e2e_trial_dms()
    spacing = float(dms[1] - dms[0])
    launches = {}
    # the raw (uncleaned) chunks: S/N 8 keeps the noise of 514 trials x
    # 2^18 samples out of the hits
    snr = 8.0

    # the feed sends the file's first 2 chunks (depth cut from 2.5)
    fed = 2 * step
    starts = list(range(0, fed, step))

    # PUingest listen + feed, two processes, float32 frames over TCP.  The
    # listener's idle clock runs from its start (the JAX semantics) and
    # must cover the feeder's start-up (reading and packetising 2 GB),
    # during which this process reads and searches the disk stream; while
    # the clock runs down after the feed, it runs the 2-bit sessions
    # below (the listener is idle by then)
    summary_path = workdir / "ingest_summary.json"
    proc, out, log = _start_child(
        workdir, "ingest_listen", "pulsarutils_tpu_torch.cli.ingest_main",
        ["listen", "--like", str(path), "--step", str(step), "--dmmin",
         str(DMMIN), "--dmmax", str(DMMAX), "--snr-threshold", str(snr),
         "--port", "0", "--idle-timeout", str(LISTEN_IDLE_S), "--device",
         "cuda", "--summary-out", str(summary_path)])
    port = int(_wait_for_line(proc, log, r"listening on tcp://"
                              r"[\d.]+:(\d+)", 180).group(1))
    feed_log = workdir / "ingest_feed.log"
    t_feed = time.perf_counter()
    with open(feed_log, "w") as fh:
        feeder = subprocess.Popen(
            [sys.executable, "-m", "pulsarutils_tpu_torch.cli.ingest_main",
             "feed", str(path), "--port", str(port), "--max-samples",
             str(fed)], cwd=str(REPO), stdout=fh, stderr=subprocess.STDOUT,
            text=True)
    _CHILDREN.append(feeder)

    # the disk stream: the chunks the feed must deliver, read from the file
    reader = FilterbankReader(str(path))
    t0 = time.perf_counter()
    disk = [(s, reader.read_block_tensor(s, step, "cpu").numpy())
            for s in starts]
    read_s = time.perf_counter() - t0
    digests = {str(s): _sha1(np, c) for s, c in disk}
    acc = BudgetAccountant()
    reset_counts()
    ref_res, ref_hits = stream_search(disk, *geom, device="cuda",
                                      snr_threshold=snr, budget=acc)
    ref_counts = read_counts()
    del disk
    pulse_chunk = E2E_NSAMPLES // 2 // step * step
    found = [h[2] for h in ref_hits if h[0] == pulse_chunk]
    check(found and abs(float(found[0]["DM"]) - E2E_DM) <= spacing,
          f"e2e_ingest disk stream: hits {[h[0] for h in ref_hits]}")
    best = found[0]
    emit("e2e_ingest_disk", chunks=starts, read_s=read_s,
         hits=[h[0] for h in ref_hits],
         best={"chunk": pulse_chunk, "dm": float(best["DM"]),
               "snr": float(best["snr"])},
         launches=ref_counts,
         search_s=acc.to_json(max_per_chunk=0)["buckets_s"].get("search"))
    torch.cuda.empty_cache()

    feed_rc = feeder.wait(timeout=600)
    feed_s = time.perf_counter() - t_feed
    check(feed_rc == 0, f"PUingest feed: rc {feed_rc}: "
          f"{feed_log.read_text()[-3000:]}")

    # the 2-bit twin: packed frames on the wire, PackedFrames to the card
    p2 = workdir / "ingest_2bit.fil"
    _write_2bit_stream_file(torch, np, p2, seed)
    r2 = FilterbankReader(str(p2))
    raw = r2.read_block_packed(0, 2 * step)
    packed_disk = [(s, PackedFrames(raw[s:s + step], 2, NCHAN,
                                    band_descending=True))
                   for s in (0, step)]
    reset_counts()
    disk_res, _ = stream_search(packed_disk, *geom, device="cuda",
                                snr_threshold=snr)
    disk_tables = dict(disk_res)
    encoded = packets.packetize_array(raw, samples_per_packet=256, nbits=2,
                                      nchan=NCHAN, band_descending=True)
    per_chunk = step // 256
    hit_seq = per_chunk + per_chunk // 10      # one packet of chunk 1
    gap_rows = slice(hit_seq * 256, hit_seq * 256 + 256)

    def session(label, bufs, *, plan=None, udp=False, shed=8, slow_s=0.0,
                pace_s=0.0):
        manifest = QuarantineManifest(str(workdir / f"ingest_{label}"),
                                      "ingest")
        health = HealthEngine()
        asm = ChunkAssembler(nchan=NCHAN, step=step, nbits=2,
                             band_descending=True, shed=shed,
                             manifest=manifest, health=health,
                             wait_poll_s=0.05)
        src = (UDPSource if udp else TCPSource)(asm, port=0,
                                                 idle_timeout_s=0.5)
        delivered = {}
        sent = {}

        def chunks():
            for s, c in asm.chunks():
                delivered[s] = c
                if slow_s:
                    time.sleep(slow_s)
                yield s, c

        def feed():
            t = time.perf_counter()
            sender = feed_udp if udp else feed_tcp
            try:
                sent["n"] = sender(src.host, src.port, bufs, pace_s=pace_s)
            except Exception as exc:  # noqa: BLE001 — reported below
                sent["error"] = repr(exc)
            sent["s"] = time.perf_counter() - t

        acc = BudgetAccountant()
        feeder = threading.Thread(target=feed, daemon=True)
        with contextlib.ExitStack() as stack:
            if plan is not None:
                stack.enter_context(plan.armed())
            src.start()
            reset_counts()
            t0 = time.perf_counter()
            feeder.start()
            try:
                results, _ = stream_search(chunks(), *geom, device="cuda",
                                           snr_threshold=snr, budget=acc,
                                           health=health)
            finally:
                feeder.join(timeout=300)
                check(src.wait(timeout_s=60), f"{label}: reader not done")
                src.close()
            wall = time.perf_counter() - t0
        check("error" not in sent, f"e2e_ingest {label}: the feed "
              f"failed: {sent.get('error')}")
        counts = read_counts()
        launches[f"ingest {label}, 2-bit packed (e2e_ingest)"] = counts
        summ = asm.summary()
        nbytes = sum(len(b) for b in bufs)
        kinds = {str(i) for i in health.snapshot()["incidents"]}
        emit("e2e_ingest", run=label, session_wall_s=wall,
             wire_s=sent.get("s"), packets_sent=sent.get("n"),
             wire_MB_s=nbytes / sent["s"] / 1e6,
             packets_per_s=sent["n"] / sent["s"],
             search_s=acc.to_json(max_per_chunk=0)["buckets_s"].get(
                 "search"), launches=counts, summary=summ,
             journal=asm.ledger.journal, health=health.verdict,
             fired=plan.fired("ingest") if plan is not None else None)
        check(summ["ledger"]["unaccounted"] == 0,
              f"e2e_ingest {label}: unaccounted {summ}")
        check(all(isinstance(c, PackedFrames) for c in delivered.values()),
              f"e2e_ingest {label}: a delivered chunk is not packed")
        check(counts["B1"] > 0 and counts["B4"] > 0 if results else True,
              f"e2e_ingest {label}: launches {counts}")
        return {"results": dict(results), "delivered": delivered,
                "summary": summ, "asm": asm, "manifest": manifest,
                "incidents": " ".join(kinds), "plan": plan}

    def frames_equal(run, s, zero=None):
        want = np.array(raw[s:s + step])
        if zero is not None:
            want[zero.start - s:zero.stop - s] = 0
        return np.asarray(run["delivered"][s].frames).tobytes() \
            == want.tobytes()

    clean = session("lossless_tcp", encoded)
    check(all(frames_equal(clean, s) for s in (0, step))
          and all(_tables_bitwise(np, clean["results"][s], disk_tables[s])
                  for s in (0, step)),
          "e2e_ingest 2-bit: the feed's tables differ from the disk "
          "stream's of the same file")
    for kind in ("drop", "reorder", "duplicate", "corrupt", "disconnect",
                 "burst"):
        plan = FaultPlan([FaultSpec(site="ingest", kind=kind,
                                    chunks=(hit_seq,), times=1)])
        run = session(f"fault_{kind}", encoded, plan=plan,
                      pace_s=2e-5 if kind == "burst" else 0.0)
        summ, led = run["summary"], run["summary"]["ledger"]
        check(plan.fired("ingest") == 1, f"e2e_ingest {kind}: not fired")
        if kind in ("drop", "corrupt"):
            check(led["gap_filled"] == 256 and led["quarantined"] == 0
                  and frames_equal(run, 0)
                  and frames_equal(run, step, zero=gap_rows)
                  and "feed_gap" in run["incidents"],
                  f"e2e_ingest {kind}: {summ}")
            check(kind != "corrupt" or summ["invalid_packets"] == 1,
                  f"e2e_ingest corrupt: {summ}")
        else:
            check(led["gap_filled"] == 0
                  and all(frames_equal(run, s) for s in (0, step))
                  and all(_tables_bitwise(np, run["results"][s],
                                          disk_tables[s])
                          for s in (0, step)),
                  f"e2e_ingest {kind}: chunks or tables differ: {summ}")
        check(kind != "reorder" or summ["reordered_packets"] >= 1,
              f"e2e_ingest reorder: {summ}")
        check(kind != "duplicate" or summ["duplicate_packets"] == 1,
              f"e2e_ingest duplicate: {summ}")
        check(kind != "disconnect" or (summ["reconnects"] == 1
                                       and "feed_disconnect"
                                       in run["incidents"]),
              f"e2e_ingest disconnect: {summ}, {run['incidents']}")
    many = FaultPlan([FaultSpec(site="ingest", kind="drop", times=None,
                                chunks=tuple(range(
                                    per_chunk + per_chunk // 32,
                                    2 * per_chunk - per_chunk // 32)))])
    run = session("fault_drop_most_of_chunk_1", encoded, plan=many)
    led = run["summary"]["ledger"]
    recs = run["manifest"].records()
    check(led["quarantined"] == step and sorted(run["delivered"]) == [0]
          and [r["reason"] for r in recs] == [reasons.FEED_GAP]
          and recs[0]["chunk"] == step,
          f"e2e_ingest feed_gap quarantine: {run['summary']}, {recs}")

    # a consumer slower than the feed, a queue of one chunk: 8 chunks
    longer = [b for k in range(4) for b in packets.packetize_array(
        raw, samples_per_packet=256, nbits=2, nchan=NCHAN,
        band_descending=True, sample0=2 * step * k, seq0=2 * per_chunk * k)]
    run = session("slow_consumer_shed_1", longer, shed=1, slow_s=1.5)
    led = run["summary"]["ledger"]
    shed = [r for r in run["asm"].ledger.journal
            if r["reason"] == reasons.SHED_OVERRUN]
    check(led["shed"] > 0 and led["delivered"] + led["shed"] == 8 * step
          and [r["chunk"] for r in run["manifest"].records()]
          == [r["chunk"] for r in shed] and "feed_overrun"
          in run["incidents"],
          f"e2e_ingest shed: {run['summary']}, {shed}")

    # one chunk over UDP (32 KB datagrams)
    dgrams = packets.packetize_array(raw[:step], samples_per_packet=128,
                                     nbits=2, nchan=NCHAN,
                                     band_descending=True)
    run = session("udp_one_chunk", dgrams, udp=True, pace_s=5e-5)
    led = run["summary"]["ledger"]
    check(led["arrived"] + led["gap_filled"] == led["observed"] == step,
          f"e2e_ingest udp: {run['summary']}")
    if led["gap_filled"] == 0:
        check(frames_equal(run, 0) and _tables_bitwise(
            np, run["results"][0], disk_tables[0]),
              "e2e_ingest udp: lossless, but the chunk or table differs")
    # the listener ends on its idle timeout after the feed
    try:
        rc = _stop_child(proc, timeout=LISTEN_IDLE_S + 300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    check(rc == 0, f"PUingest listen: rc {rc}: {log.read_text()[-3000:]}")
    child = json.loads(out.read_text())
    summary = json.loads(summary_path.read_text())
    (call,) = [c for c in child["calls"] if c["call"] == "stream_search"]
    led = summary["ledger"]
    check(led["unaccounted"] == 0 and led["shed"] == 0
          and led["delivered"] == fed and led["gap_filled"] == 0
          and summary["invalid_packets"] == 0,
          f"PUingest listen summary: {summary}")
    check(call["digests"] == digests,
          "PUingest listen: the delivered chunks are not the file's "
          f"samples: {call['digests']} vs {digests}")
    tables = Path(str(out)[:-len(".json")])
    for s, table in ref_res:
        ours = ResultTable.from_npz(str(tables / f"table_{s}.npz"))
        check(_tables_bitwise(np, ours, table),
              f"PUingest listen: chunk {s}'s table differs from the disk "
              "stream's")
    check(call["hits"] == [h[0] for h in ref_hits],
          f"PUingest listen: hits {call['hits']}")
    counts = call["launches"]
    check(counts["B1"] == ref_counts["B1"] > 0
          and counts["B4"] == ref_counts["B4"] > 0,
          f"PUingest listen: launches {counts} vs {ref_counts}")
    launches["PUingest listen, float32 over TCP (e2e_ingest)"] = counts
    w = child["wire"]
    wire_s = w["last"] - w["first"]
    emit("e2e_ingest", run="listen_tcp_float32", session_wall_s=
         child["wall_s"], feed_process_s=feed_s, packets=w["packets"],
         wire_bytes=w["bytes"], wire_s=wire_s,
         wire_MB_s=w["bytes"] / wire_s / 1e6,
         packets_per_s=w["packets"] / wire_s,
         search_s=call["buckets_s"].get("search"),
         search_s_per_chunk=call["search_s_per_chunk"],
         buckets_s=call["buckets_s"], launches=counts,
         probe_launches=child["probe"], summary=summary,
         tables_equal=True, chunks_equal=True, hits=call["hits"])
    shutil.rmtree(tables, ignore_errors=True)

    p2.unlink()
    return launches


def _http(method, base, path, body=None, timeout=30.0):
    """``(status, parsed JSON or text)`` of one request."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + path, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            text = resp.read().decode()
            status = resp.status
    except urllib.error.HTTPError as exc:
        text, status = exc.read().decode(), exc.code
    try:
        return status, json.loads(text)
    except ValueError:
        return status, text


def _wait_jobs(base, ids, states=("done", "failed", "cancelled"),
               timeout=900.0):
    """The documents of ``ids`` once each is in one of ``states``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        docs = [_http("GET", base, f"/jobs/{j}")[1] for j in ids]
        if all(isinstance(d, dict) and d["state"] in states for d in docs):
            return docs
        time.sleep(0.05)
    raise CheckFailed(f"jobs {ids} not finished in {timeout} s")


def _sum_counts(*counts):
    return {k: sum(c.get(k, 0) for c in counts) for k in counts[0]}


def phase_e2e_service(torch, np, workdir, path, pulsar, period):
    """The job service: ``python -m pulsarutils_tpu_torch.cli.beams_main
    --serve --http-port 0 --device cuda`` as a child process
    (:func:`cli_child`), driven over HTTP: a bad spec answers 400 with the
    validation error; a ``workload="periodicity"`` job on the pulsar
    file (the ``e2e_puperiod`` job's 5 accelerations) holds the worker
    while two single-pulse jobs on two copies of the end-to-end file
    (``max_chunks`` 2) and a third job queue; the third is cancelled
    while queued and never starts; the two are co-batched into one
    ``multibeam_search`` run (one dispatch and one readback an epoch, B4
    on every 32-trial block), their documents, hits, coincidence groups,
    ledgers and candidate files a direct ``multibeam_search``'s of the
    same files bit for bit; the periodicity job is ``done`` with B6
    launched and the candidates of ``e2e_puperiod`` (outside the canary's
    rows); a job cancelled mid-run and submitted again resumes from its
    ledger: each chunk searched once over the two runs, the ledger an
    uninterrupted run's byte for byte; ``/healthz`` answers as without a
    service.  Prints seconds per job, the co-batch's dispatches and
    readbacks, the launches of each job's run and the per-job
    counters."""
    from pulsarutils_tpu_torch.beams import multibeam_search
    from pulsarutils_tpu_torch.beams.service import validate_spec
    from pulsarutils_tpu_torch.io.candidates import CandidateStore
    from pulsarutils_tpu_torch.pipeline.search_pipeline import plan_survey
    from pulsarutils_tpu_torch.ops.search import auto_chan_block
    from pulsarutils_tpu_torch.periodicity.candidates import load_candidates
    from pulsarutils_tpu_torch.tuning import autotune

    chunk_length = E2E_CHUNK // 2 * TSAMP
    dms = e2e_trial_dms()
    nblocks = -(-len(dms) // 32)
    # the co-batch's second file and the resumed job's: the same bytes
    # under other names (hard links), so their ledgers and candidate files
    # are their own
    copy = workdir / "e2e_copy.fil"
    os.link(path, copy)
    again_path = workdir / "e2e_resume.fil"
    os.link(path, again_path)
    svc = workdir / "service"
    # the batch keys of the co-batch (2 beams) and of the single job
    # resolved here, into the cache the child reads: the service and the
    # direct runs below dispatch the same kernel
    kernels = {b: autotune.resolve_batched_kernel(
        NCHAN, E2E_CHUNK, len(dms), b, START_FREQ, BANDWIDTH, TSAMP, dms,
        dm_block=32, chan_block=auto_chan_block(NCHAN, E2E_CHUNK, 32),
        device="cuda") for b in (1, 2)}
    torch.cuda.empty_cache()
    physics = {"dmmin": DMMIN, "dmmax": DMMAX, "chunk_length": chunk_length}
    pspec = {"fname": str(pulsar), "workload": "periodicity",
             "accel_max": 1000.0, "n_accel": 5, "snr_threshold": 8.0,
             **physics}
    co = {"snr_threshold": 8.0, "max_chunks": 2, **physics}
    resumed = {"fname": str(again_path), "snr_threshold": 7.0, **physics}
    bad = {"fname": str(path), "dmmin": DMMAX, "dmmax": DMMIN}
    try:
        validate_spec(bad)
        raise CheckFailed("e2e_service: the bad spec validates")
    except ValueError as exc:
        bad_error = str(exc)

    proc, out, log = _start_child(
        workdir, "service", "pulsarutils_tpu_torch.cli.beams_main",
        ["--serve", "--http-port", "0", "--device", "cuda",
         "--output-dir", str(svc)])
    try:
        port = int(_wait_for_line(proc, log, r"job service on http://"
                                  r"[\d.]+:(\d+)", 180).group(1))
        base = f"http://127.0.0.1:{port}"
        status, body = _http("POST", base, "/jobs", bad)
        check(status == 400 and body == {"error": bad_error},
              f"e2e_service bad spec: {status} {body}")
        post = {}
        for label, spec in (("periodicity", pspec),):
            status, body = _http("POST", base, "/jobs", spec)
            check(status == 201, f"e2e_service {label}: {status} {body}")
            post[label] = body["job_id"]
        deadline = time.monotonic() + 120
        while _http("GET", base, f"/jobs/{post['periodicity']}")[1][
                "state"] == "queued" and time.monotonic() < deadline:
            time.sleep(0.02)
        for label, spec in (("beam_a", {"fname": str(path), **co}),
                            ("beam_b", {"fname": str(copy), **co}),
                            ("queued_cancel",
                             {"fname": str(path), **co,
                              "snr_threshold": 9.0})):
            status, body = _http("POST", base, "/jobs", spec)
            check(status == 201, f"e2e_service {label}: {status} {body}")
            post[label] = body["job_id"]
        status, doc = _http("POST", base,
                            f"/jobs/{post['queued_cancel']}/cancel")
        check(status == 200 and doc["state"] == "cancelled",
              f"e2e_service cancel while queued: {status} {doc}")
        first = _wait_jobs(base, [post[k] for k in (
            "periodicity", "beam_a", "beam_b", "queued_cancel")])
        # cancelled mid-run, then submitted again
        ledgers_before = {p.name for p in svc.iterdir()
                          if p.name.startswith("progress_")}
        status, body = _http("POST", base, "/jobs", resumed)
        post["cancel_mid_run"] = body["job_id"]
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            doc = _http("GET", base, f"/jobs/{post['cancel_mid_run']}")[1]
            if doc["chunks_done"] >= 1 or doc["state"] != "running" \
                    and doc["state"] != "queued":
                break
            time.sleep(0.02)
        _http("POST", base, f"/jobs/{post['cancel_mid_run']}/cancel")
        (mid,) = _wait_jobs(base, [post["cancel_mid_run"]])
        status, body = _http("POST", base, "/jobs", resumed)
        post["resubmitted"] = body["job_id"]
        (again,) = _wait_jobs(base, [post["resubmitted"]])
        health_status, health_doc = _http("GET", base, "/healthz")
        status, listing = _http("GET", base, "/jobs")
        metrics_text = _http("GET", base, "/metrics")[1]
        rc = _stop_child(proc, sig="SIGINT", timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    check(rc == 0, f"PUmultibeam --serve: rc {rc}: "
          f"{log.read_text()[-3000:]}")
    child = json.loads(out.read_text())
    docs = dict(zip(("periodicity", "beam_a", "beam_b", "queued_cancel"),
                    first))
    docs.update(cancel_mid_run=mid, resubmitted=again)
    check(status == 200 and [d["id"] for d in listing["jobs"]][::-1]
          == [post[k] for k in ("periodicity", "beam_a", "beam_b",
                                "queued_cancel", "cancel_mid_run",
                                "resubmitted")],
          f"e2e_service GET /jobs: {listing}")
    check(health_status == 200 and health_doc["status"] == "OK",
          f"e2e_service /healthz: {health_status} {health_doc}")
    for label in ("periodicity", "beam_a", "beam_b", "resubmitted"):
        check(docs[label]["state"] == "done"
              and docs[label]["error"] is None,
              f"e2e_service {label}: {docs[label]}")
    q = docs["queued_cancel"]
    check(q["state"] == "cancelled" and q["started_at"] is None
          and q["chunks_done"] == 0, f"e2e_service queued cancel: {q}")
    calls = child["calls"]
    check([c["call"] for c in calls] == ["periodicity_search",
                                         "multibeam_search",
                                         "multibeam_search",
                                         "multibeam_search"],
          f"e2e_service runs: {[c['call'] for c in calls]}")
    pcall, cocall, midcall, againcall = calls

    # the co-batch against a direct multibeam_search of the same files
    a, b = docs["beam_a"], docs["beam_b"]
    check(a["batch_group"] == b["batch_group"]
          == [post["beam_a"], post["beam_b"]]
          and cocall["fnames"] == [str(path), str(copy)],
          f"e2e_service: not co-batched: {a['batch_group']}, "
          f"{cocall['fnames']}")
    check(cocall["counters"].get("dispatches") == 2
          and cocall["counters"].get("readbacks") == 2
          and cocall["launches"]["B4"] == 2 * 2 * nblocks
          and cocall["launches"]["B1"] == 0,
          f"e2e_service co-batch: {cocall['counters']}, "
          f"{cocall['launches']}")
    torch.cuda.empty_cache()
    ref_dir = workdir / "service_ref"
    t0 = time.perf_counter()
    ref = multibeam_search([str(path), str(copy)], DMMIN, DMMAX,
                           snr_threshold=8.0, max_chunks=2,
                           chunk_length=chunk_length,
                           output_dir=str(ref_dir), device="cuda")
    ref_s = time.perf_counter() - t0
    groups = ref["coincidence"]["groups"]
    for doc, beam in zip((a, b), ref["beams"]):
        want = [{k: g[k] for k in ("verdict", "beams", "n_beams",
                                   "n_members", "time", "dm", "snr")}
                for g in groups if beam["beam"] in g["beams"]]
        check(doc["hits"] == len(beam["hits"])
              and doc["chunks_done"] == doc["chunks_total"] == 2
              and doc["coincidence"]["stats"] == ref["coincidence"]["stats"]
              and doc["coincidence"]["groups"] == json.loads(
                  json.dumps(want)),
              f"e2e_service: job {doc['id']} differs from the direct run")
    snap, ref_snap = _snapshot(np, svc), _snapshot(np, ref_dir)
    check(ref_snap and all(snap.get(k) == v for k, v in ref_snap.items()),
          "e2e_service: the co-batch's ledgers or candidate files differ "
          "from the direct run's")

    # the periodicity job against e2e_puperiod's
    cands, _ = load_candidates(docs["periodicity"]["period"][
        "candidates_path"])
    job = period["job"]
    c_row = job["canary"]["dm_index"]
    mine = [c for c in cands if abs(c["dm_index"] - c_row) > 2]
    check(pcall["launches"]["B6"] > 0 and pcall["launches"]["B1"] > 0
          and pcall["launches"]["B4"] > 0 and pcall["complete"],
          f"e2e_service periodicity: {pcall}")
    check([(c["dm"], c["accel"], c["freq_bin"], c["nharm"]) for c in mine]
          == [(c["dm"], c["accel"], c["freq_bin"], c["nharm"])
              for c in job["candidates"]]
          and all(abs(c["sigma"] - r["sigma"]) <= 1e-5 * abs(r["sigma"])
                  for c, r in zip(mine, job["candidates"])),
          "e2e_service periodicity: candidates differ from e2e_puperiod's: "
          f"{[(c['dm'], c['freq'], c['sigma']) for c in mine[:5]]}")

    # cancelled mid-run, resumed: every chunk once, the uninterrupted ledger
    done_first = mid["chunks_done"]
    check(mid["state"] == "cancelled" and 1 <= done_first < 4
          and again["chunks_done"] == 4 - done_first
          and again["chunks_total"] == 4,
          f"e2e_service resume: {mid['state']} {done_first}, "
          f"{again['chunks_done']}/{again['chunks_total']}")
    both = _sum_counts(midcall["launches"], againcall["launches"])
    check(both["B4"] == 4 * nblocks, f"e2e_service resume launches {both}")
    # the uninterrupted run's ledger: its store marks every chunk of the
    # plan in order (the bytes a serial run writes)
    (resumed_ledger,) = [p for p in svc.iterdir() if p.name.startswith(
        "progress_") and p.name not in ledgers_before]
    full_dir = workdir / "service_full"
    store = CandidateStore(str(full_dir), resumed_ledger.name[
        len("progress_"):-len(".json")])
    for istart in plan_survey(str(again_path), chunk_length=chunk_length,
                              dmmin=DMMIN, dmmax=DMMAX)["chunk_starts"]:
        store.mark_done(istart)
    check(resumed_ledger.read_bytes()
          == Path(store._ledger_path).read_bytes(),
          "e2e_service resume: the ledger differs from an uninterrupted "
          f"run's: {resumed_ledger.read_text()}")

    metrics = parse_prometheus(metrics_text)

    def counter(name, **labels):
        key = ",".join(f'{k}="{v}"' for k, v in labels.items())
        return metrics.get((name, key))

    per_job = {label: {
        "chunks_done": counter("putpu_job_chunks_done_total",
                               job=post[label]),
        "hits": counter("putpu_job_hits_total", job=post[label])}
        for label in post}
    finished = {s: counter("putpu_jobs_finished_total", status=s)
                for s in ("done", "cancelled", "failed")}
    check(finished["done"] == 4 and finished["cancelled"] == 2
          and not finished["failed"]
          and per_job["beam_a"]["chunks_done"] == 2,
          f"e2e_service counters: {finished}, {per_job}")
    emit("e2e_service", kernels=kernels, child_wall_s=child["wall_s"],
         job_seconds={k: (d["finished_at"] - d["started_at"]
                          if d["started_at"] else None)
                      for k, d in docs.items()},
         cobatch={"dispatches": cocall["counters"].get("dispatches"),
                  "readbacks": cocall["counters"].get("readbacks"),
                  "seconds": cocall["seconds"],
                  "buckets_s": cocall["buckets_s"],
                  "direct_multibeam_s": ref_s},
         periodicity_seconds=pcall["seconds"],
         launches={"periodicity": pcall["launches"],
                   "cobatch": cocall["launches"],
                   "cancelled": midcall["launches"],
                   "resubmitted": againcall["launches"]},
         probe_launches=child["probe"], per_job=per_job,
         finished=finished, cancelled_after_chunks=done_first,
         hits={k: d["hits"] for k, d in docs.items()},
         bad_spec_error=bad_error, cobatch_equal=True,
         resume_ledger_equal=True, periodicity_equal=True)
    copy.unlink()
    again_path.unlink()
    return {"job service co-batch of 2 jobs (e2e_service)":
                cocall["launches"],
            "job service periodicity job (e2e_service)": pcall["launches"],
            "job service job cancelled and resumed (e2e_service)": both}


# ---------------------------------------------------------------------------
# The fleet (A10b): e2e_fleet
# ---------------------------------------------------------------------------

#: the in-process coordinators' lease TTL (run B's victim is stolen by
#: expiry or, sooner, by its failed /healthz probes)
FLEET_LEASE_TTL_S = 4.0

FLEET_MODULE = "pulsarutils_tpu_torch.cli.fleet_main"


def _free_port():
    """A port free now on the loopback (bind 0, read it, close): the
    coordinator's two runs share it, so its workers find the second."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get_doc(base, path):
    """The JSON document at ``base + path``, or None while nothing
    answers there."""
    try:
        status, doc = _http("GET", base, path, timeout=5.0)
    except OSError:
        return None
    return doc if status == 200 else None


def _wait_doc(base, path, cond, timeout, what):
    """Poll ``path`` until ``cond(doc)``; returns the document."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        doc = _get_doc(base, path)
        if doc is not None and cond(doc):
            return doc
        time.sleep(0.05)
    raise CheckFailed(f"e2e_fleet: {what} not seen in {timeout} s")


def _timed_worker(worker):
    """Wrap an in-process worker: the wall of each wire message by name
    (``timing["rtt_ms"]``) and the time each unit started
    (``timing["units"]``, ``(perf_counter, unit, chunks)``)."""
    timing = {"rtt_ms": {}, "units": []}
    post, run_unit = worker._post, worker._run_unit

    def timed_post(path, doc, **kw):
        t0 = time.perf_counter()
        try:
            return post(path, doc, **kw)
        finally:
            timing["rtt_ms"].setdefault(path.rsplit("/", 1)[-1], []).append(
                1e3 * (time.perf_counter() - t0))

    def timed_unit(lease):
        timing["units"].append((time.perf_counter(), lease["unit"],
                                list(lease["chunks"])))
        return run_unit(lease)

    worker._post, worker._run_unit = timed_post, timed_unit
    return timing


def _median_ms(rtt):
    return {k: round(statistics.median(v), 3) for k, v in rtt.items()}


def phase_e2e_fleet(torch, np, workdir, path, pulsar, period, refs=None):
    """The fleet (``fleet/``, ``cli/fleet_main.py``) on the card, the
    e2e file (4 chunks of 2^18, DM 300-635, S/N 8) and the pulsar file:

    * run A, the real CLIs and a coordinator crash: ``fleet_main
      coordinator`` as a process with no card visible
      (``CUDA_VISIBLE_DEVICES=""``: it makes no CUDA call), ``--capacity
      --slo --report-out``, one chunk a unit, and two ``fleet_main worker
      --device cuda`` children (:func:`cli_child`), each with
      ``PUTPU_MEM_LIMIT`` at half the card; once a chunk is done the
      coordinator is SIGKILLed and relaunched with ``--recover`` on its
      port: the journal replayed, both workers re-registered, the survey
      finished, the ledger and candidate files the single-process run's
      byte for byte (member by member), B1 and B4 8 launches each plus 2
      for every chunk searched twice, the report's "Capacity & scaling";
    * run B, a worker killed holding a lease: an in-process coordinator
      with a lease TTL of 4 s, a victim child hung at the ``fleet`` fault
      site and SIGKILLed once it holds a lease, an in-process
      ``FleetWorker(device="cuda")`` finishing the survey; the lease's
      config is ``kernel="hybrid"`` at S/N 8 (B3, B2a, B2b, B1, B4): the
      outputs the single-process hybrid run's byte for byte;
    * run C, a partitioned zombie (host and one store): a lease at epoch
      e expires, the new owner writes at e+1, the zombie's late candidate
      write through ``CandidateStore(fence=e)`` is refused and its
      ``complete`` is stale;
    * run D, a periodicity unit: ``workload="periodicity"`` on the pulsar
      file with ``e2e_puperiod``'s accelerations, an in-process card
      worker: the candidates file of ``e2e_puperiod``'s name (its
      fingerprint), written through the fence, its candidates the job's
      outside the canary's rows, B6 as many launches as the job's.

    ``refs``: the single-process output directories of the same configs
    (``direct``: ``e2e_search``'s, ``hybrid``: ``e2e_hybrid``'s S/N 8
    run), else made here.  Prints the survey wall, seconds per unit, the
    wire's round trips, the seconds from each kill to the rescue, the
    journal's records, the capacity state and advice, each worker's
    budget and the launches of every run."""
    import re
    import signal

    from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec
    from pulsarutils_tpu_torch.faults import inject as fault_inject
    from pulsarutils_tpu_torch.fleet.coordinator import FleetCoordinator
    from pulsarutils_tpu_torch.fleet.worker import FleetWorker
    from pulsarutils_tpu_torch.io.candidates import CandidateStore
    from pulsarutils_tpu_torch.periodicity.candidates import load_candidates
    from pulsarutils_tpu_torch.pipeline.search_pipeline import \
        search_by_chunks

    chunk_length = E2E_CHUNK // 2 * TSAMP
    # spelled as the CLI parses --dmmin 300 --dmmax 635 --snr-threshold 8
    physics = dict(dmmin=DMMIN, dmmax=DMMAX, chunk_length=chunk_length,
                   snr_threshold=8.0)
    nchunks = 4
    refs = dict(refs or {})
    ref_s = {}
    for label, extra in (("direct", {}), ("hybrid", {"kernel": "hybrid"})):
        if refs.get(label) is not None:
            continue
        refs[label] = workdir / f"fleet_ref_{label}"
        summary = {}
        t0 = time.perf_counter()
        search_by_chunks(str(path), output_dir=str(refs[label]),
                         device="cuda", make_plots=False, summary=summary,
                         **extra, **physics)
        ref_s[label] = time.perf_counter() - t0
        check_clean_run(summary, f"e2e_fleet reference {label}")
    # this process's plan is read now, before any child's environment
    fault_inject.active()
    share = int(torch.cuda.mem_get_info()[1]) // 2

    # -- run A: the CLIs, a coordinator SIGKILLed and recovered -------------
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    out_a = workdir / "fleet_a"
    report = workdir / "fleet_report"
    cmd = [sys.executable, "-m", FLEET_MODULE, "coordinator",
           "--output-dir", str(out_a), "--http-port", str(port),
           "--dmmin", "300", "--dmmax", "635",
           "--chunk-length", repr(chunk_length), "--snr-threshold", "8",
           "--chunks-per-unit", "1", "--lease-ttl", "60",
           "--probe-interval", "0.5", "--capacity", "--slo",
           "--report-out", str(report), "--exit-when-done"]
    logs = [workdir / "fleet_coordinator.log",
            workdir / "fleet_coordinator_recovered.log"]
    coord_env = dict(os.environ, CUDA_VISIBLE_DEVICES="")

    def coordinator_child(args, log):
        with open(log, "w") as fh:
            proc = subprocess.Popen(cmd + args, cwd=str(REPO), env=coord_env,
                                    stdout=fh, stderr=subprocess.STDOUT,
                                    text=True)
        _CHILDREN.append(proc)
        return proc

    def tails():
        return "".join(f"\n--- {p.name}:\n{p.read_text()[-2500:]}"
                       for p in [*logs, *(workdir / f"fleet_worker{i}.log"
                                          for i in range(2))]
                       if p.is_file())

    try:
        t_a = time.perf_counter()
        coord = coordinator_child([str(path)], logs[0])
        _wait_for_line(coord, logs[0], r"fleet coordinator on http://", 120)
        workers = []
        # stable worker ids: a recovered coordinator mints its ids
        # afresh, so a worker still on its pre-crash "w1" could alias
        # the first worker that re-registered
        for i in range(2):
            with env_set(PUTPU_MEM_LIMIT=share):
                workers.append(_start_child(
                    workdir, f"fleet_worker{i}", FLEET_MODULE,
                    ["worker", "--coordinator", base, "--device", "cuda",
                     "--worker-id", f"card{i}", "--max-idle", "30"]))
        budgets = {w["worker"]: w["mem_budget_bytes"] for w in _wait_doc(
            base, "/fleet/workers", lambda d: len(d["workers"]) == 2, 180,
            "two registered workers")["workers"]}
        _wait_doc(base, "/fleet/progress", lambda d: d["chunks_done"] >= 1,
                  300, "a chunk done")
        journal = out_a / "fleet_journal.jsonl"
        coord.send_signal(signal.SIGKILL)
        coord.wait(timeout=30)
        t_kill = time.perf_counter()
        written = len(journal.read_text().splitlines())
        coord2 = coordinator_child(["--recover"], logs[1])
        t_relaunch = time.perf_counter()
        _wait_doc(base, "/fleet/progress",
                  lambda d: d["stats"]["granted"] >= 1, 180,
                  "a grant by the recovered coordinator")
        t_grant = time.perf_counter()
        try:
            rc = coord2.wait(timeout=600)
        except subprocess.TimeoutExpired:
            raise CheckFailed("e2e_fleet: the recovered coordinator did not "
                              f"finish: {logs[1].read_text()[-3000:]}") from None
        wall_a = time.perf_counter() - t_a
        check(rc == 0, f"e2e_fleet: recovered coordinator rc {rc}: "
              f"{logs[1].read_text()[-3000:]}")
        for proc, _, log in workers:
            # a worker idle-polling the exited coordinator drains on SIGINT
            try:
                proc.wait(timeout=40)
            except subprocess.TimeoutExpired:
                _stop_child(proc, sig="SIGINT", timeout=60)
            check(proc.returncode == 0, f"{log.name}: rc {proc.returncode}: "
                  f"{log.read_text()[-3000:]}")
        text = logs[1].read_text()
        replayed = re.search(r"recovered from journal — (\d+) record\(s\) "
                             r"replayed", text)
        check(replayed is not None, f"e2e_fleet: no journal replay: {text[-3000:]}")
        summary = json.loads([ln for ln in text.splitlines()
                              if ln.startswith('{"fleet"')][-1])["fleet"]
        check(summary["survey_done"] and summary["chunks_done"] == nchunks,
              f"e2e_fleet run A: {summary}")
        for _, _, log in workers:
            check("re-registering" in log.read_text(),
                  f"e2e_fleet: {log.name} did not re-register")
        snap, ref = _snapshot(np, out_a), _snapshot(np, refs["direct"])
        check(ref and snap == ref, "e2e_fleet run A: ledger or candidates "
              f"differ from the single-process run's: {sorted(snap)} "
              f"vs {sorted(ref)}")
        child = [json.loads(out.read_text()) for _, out, _ in workers]
        calls = [c for doc in child for c in doc["calls"]
                 if c["call"] == "search_by_chunks"]
        searched = {}
        for c in calls:
            if c["launches"]["B1"]:
                for chunk in c["chunks"]:
                    searched[chunk] = searched.get(chunk, 0) + 1
        again = sorted(c for c, n in searched.items() if n > 1)
        counts_a = _sum_counts(*[doc["counts"] for doc in child])
        check(len(searched) == nchunks
              and counts_a["B1"] == 2 * (nchunks + len(again))
              and counts_a["B4"] == counts_a["B1"],
              f"e2e_fleet run A launches {counts_a}, searched {searched}")
        md = Path(str(report) + ".md").read_text()
        check("## Capacity & scaling" in md, "e2e_fleet: no capacity section")
        capacity = summary.get("capacity") or {}
        unit_s = [round(c["seconds"], 3) for c in calls]
        emit("e2e_fleet_run_a", workers=2, units=nchunks,
             survey_wall_s=wall_a, unit_s=unit_s,
             chunks_per_s=nchunks / wall_a, budgets=budgets,
             kill_to_relaunch_s=t_relaunch - t_kill,
             relaunch_to_first_grant_s=t_grant - t_relaunch,
             journal_written=written, journal_replayed=int(replayed.group(1)),
             re_searched=again, launches=counts_a, probe=[d["probe"]
                                                           for d in child],
             capacity={"state": capacity.get("state"),
                       "advice": capacity.get("advice"),
                       "throughput": capacity.get("throughput")},
             stats=summary["stats"], bytes_equal=True,
             reference_s=ref_s.get("direct"))
    except CheckFailed as exc:
        raise CheckFailed(f"{exc}{tails()}") from None

    # -- run B: a worker SIGKILLed while it holds a lease; hybrid -----------
    out_b = workdir / "fleet_b"
    coordinator = FleetCoordinator(str(out_b), lease_ttl_s=FLEET_LEASE_TTL_S,
                                   probe_interval_s=0.25, chunks_per_unit=2)
    server = None
    try:
        from pulsarutils_tpu_torch.obs.server import start_obs_server

        server = start_obs_server(0, fleet=coordinator)
        base_b = f"http://127.0.0.1:{server.port}"
        coordinator.add_survey([str(path)], kernel="hybrid", **physics)
        hang = FaultPlan([FaultSpec(site="fleet", kind="hang",
                                    seconds=600.0, times=1)]).to_json()
        with env_set(PUTPU_FAULT_PLAN=hang, PUTPU_MEM_LIMIT=share):
            victim, _, vlog = _start_child(
                workdir, "fleet_victim", FLEET_MODULE,
                ["worker", "--coordinator", base_b, "--device", "cuda",
                 "--worker-id", "victim", "--max-idle", "60"])
        deadline = time.monotonic() + 180
        while not coordinator.leases_doc()["leases"]:
            check(time.monotonic() < deadline and victim.poll() is None,
                  f"e2e_fleet: the victim held no lease: "
                  f"{vlog.read_text()[-3000:]}")
            time.sleep(0.05)
        (held,) = coordinator.leases_doc()["leases"]
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=30)
        t_kill_b = time.perf_counter()
        rescuer = FleetWorker(base_b, http_port=None, device="cuda")
        timing_b = _timed_worker(rescuer)
        reset_counts()
        rescuer.run(max_idle_s=60.0)
        counts_b = read_counts()
        check(coordinator.survey_done, "e2e_fleet run B: survey not done")
        stats_b = coordinator.progress_doc()["stats"]
    finally:
        if server is not None:
            server.close()
        coordinator.close()
    check(stats_b["expired"] + stats_b["revoked"] >= 1,
          f"e2e_fleet run B: nothing stolen: {stats_b}")
    snap, ref = _snapshot(np, out_b), _snapshot(np, refs["hybrid"])
    check(ref and snap == ref, "e2e_fleet run B: outputs differ from the "
          "single-process hybrid run's")
    check(all(counts_b[k] > 0 for k in ("B1", "B2a", "B2b", "B3", "B4"))
          and counts_b["B3"] == nchunks,
          f"e2e_fleet run B launches {counts_b}")
    stolen = [t for t, unit, _ in timing_b["units"] if unit == held["unit"]]
    emit("e2e_fleet_run_b", kernel="hybrid", lease_ttl_s=FLEET_LEASE_TTL_S,
         victim_unit=held["unit"], stats=stats_b,
         kill_to_first_lease_s=timing_b["units"][0][0] - t_kill_b,
         kill_to_steal_s=stolen[0] - t_kill_b if stolen else None,
         rtt_ms=_median_ms(timing_b["rtt_ms"]), launches=counts_b,
         bytes_equal=True, reference_s=ref_s.get("hybrid"))

    # -- run C: a partitioned zombie, fenced --------------------------------
    out_c = workdir / "fleet_c"
    fenced0 = _counter_value("putpu_fleet_fenced_writes_total")
    stale0 = _counter_value("putpu_fleet_stale_epoch_rejected_total")
    with FleetCoordinator(str(out_c), auto_sweep=False,
                          lease_ttl_s=5.0) as c:
        c.add_survey([str(path)], **physics)
        fp = c.progress_doc()["files"][0]["fingerprint"]
        zombie = c.register({})["worker"]
        owner = c.register({})["worker"]
        zl = c.lease({"worker": zombie, "max_units": 1})["leases"][0]
        c.sweep(now=time.monotonic() + 10.0)
        ol = c.lease({"worker": owner, "max_units": 1})["leases"][0]
        check(ol["unit"] == zl["unit"] and ol["epoch"] == zl["epoch"] + 1,
              f"e2e_fleet run C: {zl} then {ol}")
        root, istart, iend = next(CandidateStore(str(out_a)).candidates())
        info, table = CandidateStore(str(out_a)).load_candidate(
            root, istart, iend)
        CandidateStore(str(out_c), fp, fence=ol["epoch"]).save_candidate(
            root, istart, iend, info, table)
        owned = _snapshot(np, out_c)      # the new owner's npz pair
        late = CandidateStore(str(out_c), fp, fence=zl["epoch"])
        late.save_candidate(root, istart, iend, info, table.__class__(
            {k: np.asarray(table[k])[::-1] for k in table.colnames}))
        store = CandidateStore(str(out_c), fp)
        for chunk in ol["chunks"]:
            store.mark_done(chunk)
        done = c.complete({"worker": owner, "lease": ol["lease"],
                           "unit": ol["unit"], "error": None,
                           "epoch": ol["epoch"]})
        stale = c.complete({"worker": zombie, "lease": zl["lease"],
                            "unit": zl["unit"], "error": None,
                            "epoch": zl["epoch"]})
    fenced = _counter_value("putpu_fleet_fenced_writes_total") - fenced0
    stale_n = _counter_value("putpu_fleet_stale_epoch_rejected_total") \
        - stale0
    npz = {k: v for k, v in _snapshot(np, out_c).items()
           if k.endswith(".npz")}
    check(late.fenced_rejects == 1 and fenced == 1 and npz and npz == owned,
          f"e2e_fleet run C: the zombie's write was not refused "
          f"({late.fenced_rejects}, {fenced})")
    check(done["unit_done"] and stale.get("stale") is True and stale_n == 1,
          f"e2e_fleet run C: {done}, {stale}, {stale_n}")
    emit("e2e_fleet_zombie", epochs=[zl["epoch"], ol["epoch"]],
         fenced_writes=fenced, stale_epochs=stale_n, artifact=f"{root}_"
         f"{istart}-{iend}", owner_bytes_kept=True)

    # -- run D: a periodicity unit ------------------------------------------
    out_d = workdir / "fleet_d"
    job = period["job"]
    coordinator = FleetCoordinator(str(out_d), lease_ttl_s=120.0,
                                   probe_interval_s=0.5)
    server = None
    try:
        server = start_obs_server(0, fleet=coordinator)
        coordinator.add_survey([str(pulsar)], workload="periodicity",
                               accel_max=1000.0, n_accel=5, **physics)
        fp_d = coordinator.progress_doc()["files"][0]["fingerprint"]
        worker = FleetWorker(f"http://127.0.0.1:{server.port}",
                             http_port=None, device="cuda")
        timing_d = _timed_worker(worker)
        reset_counts()
        t0 = time.perf_counter()
        worker.run(max_idle_s=60.0)
        wall_d = time.perf_counter() - t0
        counts_d = read_counts()
        check(coordinator.survey_done and worker.units_done == 1,
              f"e2e_fleet run D: {coordinator.progress_doc()}")
    finally:
        if server is not None:
            server.close()
        coordinator.close()
    name = os.path.basename(job["candidates_path"])
    check(fp_d == job["fingerprint"] and (out_d / name).is_file(),
          f"e2e_fleet run D: {fp_d} vs {job['fingerprint']}, {name}")
    fence = json.loads((out_d / f"fence_{fp_d}.json").read_text())
    check(fence["epochs"].get(name) == 1, f"e2e_fleet run D fence {fence}")
    cands, _ = load_candidates(str(out_d / name))
    c_row = job["canary"]["dm_index"]
    mine = [c for c in cands if abs(c["dm_index"] - c_row) > 2]
    check([(c["dm"], c["accel"], c["freq_bin"], c["nharm"]) for c in mine]
          == [(c["dm"], c["accel"], c["freq_bin"], c["nharm"])
              for c in job["candidates"]]
          and all(abs(c["sigma"] - r["sigma"]) <= 1e-5 * abs(r["sigma"])
                  for c, r in zip(mine, job["candidates"])),
          "e2e_fleet run D: candidates differ from e2e_puperiod's")
    check(counts_d["B6"] == period["periodicity_search"]["B6"]
          and counts_d["B1"] > 0,
          f"e2e_fleet run D launches {counts_d} vs "
          f"{period['periodicity_search']}")
    emit("e2e_fleet_period", wall_s=wall_d, fingerprint=fp_d,
         candidates=len(cands), kept_outside_canary=len(mine),
         rtt_ms=_median_ms(timing_d["rtt_ms"]), launches=counts_d,
         fenced_at_epoch=1, candidates_equal=True)
    for d in ("fleet_a", "fleet_b", "fleet_c", "fleet_d", "fleet_ref_direct",
              "fleet_ref_hybrid"):
        shutil.rmtree(workdir / d, ignore_errors=True)
    return {"fleet: 2 worker processes, coordinator recovered "
            "(e2e_fleet run A)": counts_a,
            "fleet: hybrid, a worker killed holding a lease "
            "(e2e_fleet run B)": counts_b,
            "fleet: periodicity unit (e2e_fleet run D)": counts_d}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true",
                        help="build and check the kernels at small shapes "
                             "only")
    parser.add_argument("--breakdown", action="store_true",
                        help="time the direct sweep, B6, B3 and the "
                             "hybrid phase by phase only")
    parser.add_argument("--overlap", action="store_true",
                        help="build and run e2e_overlap only")
    parser.add_argument("--observe", action="store_true",
                        help="build, write the end-to-end file and run "
                             "e2e_observe only")
    parser.add_argument("--lowbit", action="store_true",
                        help="build and run e2e_lowbit only")
    parser.add_argument("--autotune", action="store_true",
                        help="build, the end-to-end and pulsar files and "
                             "the tuner's phases only")
    parser.add_argument("--mesh", action="store_true",
                        help="build and the mesh phases only (mesh_sweep, "
                             "mesh_fdmt, e2e_mesh, mesh_period, multihost)")
    parser.add_argument("--beams", action="store_true",
                        help="build, the end-to-end file and the streaming "
                             "and beam phases only (e2e_stream, e2e_beams, "
                             "ring)")
    parser.add_argument("--fleet", action="store_true",
                        help="build, the end-to-end and pulsar files, "
                             "e2e_period and e2e_fleet only")
    parser.add_argument("--service", action="store_true",
                        help="build, the end-to-end and pulsar files and "
                             "the live feed and job service phases only "
                             "(e2e_ingest, e2e_period, e2e_service)")
    opts = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        import pulsarutils_tpu_torch
    except ImportError as exc:
        print(f"chip_smoke: the package is not beside this script ({exc})",
              file=sys.stderr)
        return 3
    if not Path(pulsarutils_tpu_torch.__file__).resolve().is_relative_to(
            REPO):
        print("chip_smoke: pulsarutils_tpu_torch was imported from "
              f"{pulsarutils_tpu_torch.__file__}, not from beside this "
              "script", file=sys.stderr)
        return 3

    from pulsarutils_tpu_torch.utils.nvcc import BUILD_DIR

    global TUNE_ROOT
    workdir = BUILD_DIR / "chip_smoke"
    TUNE_ROOT = BUILD_DIR / "chip_smoke_tune"
    shutil.rmtree(TUNE_ROOT, ignore_errors=True)
    # any tuning outside a phase's own cache stays in the checkout too
    os.environ["PUTPU_TUNE_CACHE"] = str(TUNE_ROOT / "outside_phases"
                                         / "tune_cache.json")
    try:
        card = phase_environment(torch)
        phase_build()
        if opts.breakdown:
            phase_sweep_breakdown(torch, np, opts.seed)
            phase_kernel_breakdown(torch, np, opts.seed)
            phase_hybrid_breakdown(torch, np, opts.seed)
            return 0
        if opts.overlap:
            shutil.rmtree(workdir, ignore_errors=True)
            workdir.mkdir(parents=True)
            with cold_tuner("e2e_overlap", warm=True):
                phase_e2e_overlap(torch, np, workdir, opts.seed)
            return 0
        if opts.lowbit:
            shutil.rmtree(workdir, ignore_errors=True)
            workdir.mkdir(parents=True)
            with cold_tuner("e2e_lowbit", warm=True):
                phase_e2e_lowbit(torch, np, workdir, opts.seed)
            return 0
        if opts.observe:
            shutil.rmtree(workdir, ignore_errors=True)
            workdir.mkdir(parents=True)
            path = workdir / "e2e.fil"
            _write_e2e_file(np, path, opts.seed)
            with cold_tuner("e2e_observe", warm=True):
                phase_e2e_observe(torch, np, workdir, path,
                                  E2E_CHUNK // 2 * TSAMP, 4)
            return 0
        if opts.autotune:
            shutil.rmtree(workdir, ignore_errors=True)
            workdir.mkdir(parents=True)
            with cold_tuner("e2e_search"):
                _, hits, path, chunk_length, nchunks = phase_end_to_end(
                    torch, np, opts.seed, workdir)
            phase_autotune_search(torch, np, workdir, path, chunk_length,
                                  nchunks)
            phase_fdmt_knobs(torch, np, opts.seed)
            phase_preflight(torch, np, workdir, path, hits)
            phase_surface(torch, np, path)
            path.unlink()
            with cold_tuner("e2e_period"):
                period = phase_e2e_period(torch, np, workdir, opts.seed)
            phase_autotune_accel(torch, np, workdir, period)
            return 0
        if opts.beams:
            shutil.rmtree(workdir, ignore_errors=True)
            workdir.mkdir(parents=True)
            path = workdir / "e2e.fil"
            _write_e2e_file(np, path, opts.seed)
            with cold_tuner("e2e_stream", warm=True):
                phase_e2e_stream(torch, np, workdir, path,
                                 E2E_CHUNK // 2 * TSAMP, opts.seed)
            path.unlink()
            with cold_tuner("e2e_beams"):
                phase_e2e_beams(torch, np, workdir, opts.seed)
            phase_ring(torch, np, opts.seed)
            return 0
        if opts.service:
            shutil.rmtree(workdir, ignore_errors=True)
            workdir.mkdir(parents=True)
            path = workdir / "e2e.fil"
            _write_e2e_file(np, path, opts.seed)
            with cold_tuner("e2e_ingest", warm=True):
                phase_e2e_ingest(torch, np, workdir, path, opts.seed)
            with cold_tuner("e2e_period", warm=True):
                period = phase_e2e_period(torch, np, workdir, opts.seed)
            with cold_tuner("e2e_service", warm=True):
                phase_e2e_service(torch, np, workdir, path,
                                  workdir / "pulsar.fil", period)
            return 0
        if opts.fleet:
            shutil.rmtree(workdir, ignore_errors=True)
            workdir.mkdir(parents=True)
            written = _join_data_writer(
                _start_data_writer(workdir, opts.seed), workdir)
            path = workdir / "e2e.fil"
            with cold_tuner("e2e_period", warm=True):
                period = phase_e2e_period(torch, np, workdir, opts.seed,
                                          written_s=written["pulsar_s"])
            with cold_tuner("e2e_fleet", warm=True):
                phase_e2e_fleet(torch, np, workdir, path,
                                workdir / "pulsar.fil", period)
            return 0
        if opts.mesh:
            phase_mesh_sweep(torch, np, opts.seed)
            phase_mesh_fdmt(torch, np, opts.seed)
            shutil.rmtree(workdir, ignore_errors=True)
            workdir.mkdir(parents=True)
            path = workdir / "e2e.fil"
            _write_e2e_file(np, path, opts.seed)
            with cold_tuner("e2e_mesh", warm=True):
                phase_e2e_mesh(torch, np, workdir, path,
                               E2E_CHUNK // 2 * TSAMP, 4, None, None)
            path.unlink()
            with cold_tuner("e2e_period", warm=True):
                period = phase_e2e_period(torch, np, workdir, opts.seed)
            with cold_tuner("mesh_period", warm=True):
                phase_mesh_period(torch, np, workdir, period)
            phase_multihost()
            return 0
        if not opts.quick:
            # the two host-simulated files are written by a child while
            # the card's phases run
            shutil.rmtree(workdir, ignore_errors=True)
            workdir.mkdir(parents=True)
            writer = _start_data_writer(workdir, opts.seed)
        head, records, head_data = phase_kernels(torch, np, opts.seed,
                                                 opts.quick)
        fdmt_head, fdmt_records, coarse = phase_fdmt(
            torch, np, opts.seed, opts.quick, head_data)
        del head_data
        score_head, score_records = phase_score(torch, np, opts.seed,
                                                opts.quick, coarse)
        del coarse
        torch.cuda.empty_cache()
        fdd_head, fdd_records = phase_fdd(torch, np, opts.seed, opts.quick)
        harm_head, harm_records, harm_main = phase_harmonic(
            torch, np, opts.seed, opts.quick)
        if opts.quick:
            return 0
        phase_hybrid_headline(torch, np, opts.seed)
        hybrid_split = phase_hybrid_breakdown(torch, np, opts.seed)
        breakdown = phase_sweep_breakdown(torch, np, opts.seed)
        kernel_breakdown = phase_kernel_breakdown(torch, np, opts.seed)
        knobs, knob_paths = phase_fdmt_knobs(torch, np, opts.seed)
        mesh_sweep = phase_mesh_sweep(torch, np, opts.seed)
        mesh_fdmt = phase_mesh_fdmt(torch, np, opts.seed)
        phase_ring(torch, np, opts.seed)
        written = _join_data_writer(writer, workdir)
        with cold_tuner("e2e_search", warm=True):
            direct, hits, path, chunk_length, nchunks = phase_end_to_end(
                torch, np, opts.seed, workdir, written_s=written["e2e_s"])
        tuned = phase_autotune_search(torch, np, workdir, path,
                                      chunk_length, nchunks)
        with cold_tuner("e2e_hybrid", warm=True):
            hybrid = phase_e2e_hybrid(torch, np, workdir, path,
                                      chunk_length, nchunks, hits)
        with cold_tuner("e2e_mesh", warm=True):
            e2e_mesh = phase_e2e_mesh(torch, np, workdir, path,
                                      chunk_length, nchunks, hits,
                                      hybrid["hits"]["snr_8"])
        with cold_tuner("e2e_stream", warm=True):
            stream = phase_e2e_stream(torch, np, workdir, path,
                                      chunk_length, opts.seed)
        with cold_tuner("e2e_fourier"):
            fourier = phase_e2e_fourier(torch, np, workdir, path,
                                        chunk_length, nchunks)
        with cold_tuner("e2e_precision"):
            precision = phase_e2e_precision(torch, np, workdir, path,
                                            chunk_length, nchunks, hits)
        phase_preflight(torch, np, workdir, path, hits)
        phase_surface(torch, np, path)
        with cold_tuner("e2e_faults", warm=True):
            phase_e2e_faults(torch, np, workdir, path, chunk_length,
                             nchunks, opts.seed)
        with cold_tuner("e2e_observe", warm=True):
            observe = phase_e2e_observe(torch, np, workdir, path,
                                        chunk_length, nchunks)
        with cold_tuner("e2e_ingest", warm=True):
            ingest = phase_e2e_ingest(torch, np, workdir, path, opts.seed)
        with cold_tuner("e2e_period", warm=True):
            period = phase_e2e_period(torch, np, workdir, opts.seed,
                                      written_s=written["pulsar_s"])
        with cold_tuner("e2e_fdas"):
            fdas = phase_e2e_fdas(torch, np, workdir, opts.seed, period)
        accel = phase_autotune_accel(torch, np, workdir, period)
        with cold_tuner("mesh_period", warm=True):
            mesh_period = phase_mesh_period(torch, np, workdir, period)
        with cold_tuner("e2e_service", warm=True):
            service = phase_e2e_service(torch, np, workdir, path,
                                        workdir / "pulsar.fil", period)
        with cold_tuner("e2e_fleet", warm=True):
            fleet = phase_e2e_fleet(
                torch, np, workdir, path, workdir / "pulsar.fil", period,
                refs={"direct": workdir / "out",
                      "hybrid": workdir / "out_hybrid_snr_8"})
        path.unlink()
        with cold_tuner("e2e_lowbit", warm=True):
            lowbit = phase_e2e_lowbit(torch, np, workdir, opts.seed,
                                      pulsar=workdir / "pulsar.fil")
        (workdir / "pulsar.fil").unlink()
        with cold_tuner("e2e_overlap", warm=True):
            overlap = phase_e2e_overlap(torch, np, workdir, opts.seed)
        with cold_tuner("e2e_beams"):
            beams = phase_e2e_beams(torch, np, workdir, opts.seed)
        phase_multihost()
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        return 1
    finally:
        for proc in _CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        shutil.rmtree(workdir, ignore_errors=True)
        shutil.rmtree(TUNE_ROOT, ignore_errors=True)

    main_path = hybrid["snr_8"]
    launches = {"direct sweep (e2e_search)": direct,
                "hybrid, fused seed (e2e_hybrid S/N 8)": main_path,
                "hybrid, two-stage after the unfuse rung (e2e_hybrid S/N 8)":
                    hybrid["snr_8_unfused"],
                "hybrid at the certifiable floor (e2e_hybrid)":
                    hybrid["certifiable"],
                "periodicity job, fdas (e2e_fdas)":
                    fdas["periodicity_search"],
                "fourier (e2e_fourier)": fourier,
                "direct sweep with period_search (e2e_period_chunks)":
                    period["period_search"],
                "periodicity job (e2e_puperiod)":
                    period["periodicity_search"],
                "direct sweep, serial loop (e2e_overlap)":
                    overlap[0]["launches"],
                "direct sweep, overlapped loop (e2e_overlap)":
                    overlap[1]["launches"],
                "direct sweep, every observer on (e2e_observe)": observe,
                "direct sweep, kernel=auto tuned (autotune_e2e_on)":
                    tuned["on"],
                "direct sweep, PUTPU_AUTOTUNE=off (autotune_e2e_off)":
                    tuned["off"],
                "periodicity job, the tuner's backend named "
                "(autotune_accel)": accel["named_job"],
                **{f"sharded sweep on a {s[0]}x{s[1]} mesh (mesh_sweep)": v
                   for s, v in mesh_sweep.items()},
                **{f"sharded FDMT on a {s[0]}x{s[1]} mesh (mesh_fdmt)":
                   v["fdmt"] for s, v in mesh_fdmt.items()},
                **{f"mesh hybrid {k} on a {s[0]}x{s[1]} mesh (mesh_fdmt)":
                   v[k] for s, v in mesh_fdmt.items()
                   for k in ("fused", "unfused")},
                **{f"search_by_chunks on a 2x2 mesh, {k} (e2e_mesh)": v
                   for k, v in e2e_mesh.items()},
                "ShardedPlane.spectral_scores (mesh_period)":
                    mesh_period["spectral"],
                "periodicity job on a 2x2 mesh (mesh_period)":
                    mesh_period["job"],
                **{f"autotune probe ({k})": v for k, v in PROBES.items()},
                **knob_paths, **precision["runs"], **lowbit["launches"],
                **stream, **beams, **ingest, **service, **fleet}
    shape = {"nchan": NCHAN, "nsamples": NSAMPLES}

    def levels(kind):
        return [r for r in fdmt_head if r["kernel"] == kind]

    def total(recs, key):
        return sum(r[key] for r in recs)

    sweep_recs = [head, *head["buckets"].values(), *records]
    fused, merge = levels("B3 head"), levels("B2a merge")
    merge4 = levels("B2b merge4")
    fdmt_diff = max(r["max_abs_diff"] for r in fdmt_head + fdmt_records)
    head_chunk, = [r for r in fdmt_records if r["case"] == "e2e_hybrid_chunk"
                   and r["kernel"] == "B3 head"]
    checked = ("max_abs_diff", "per_level_b2a_max_abs_diff", "kernel_ms",
               "plain_ms", "per_level_b2a_ms", "bound_ms", "bound_share")
    kernels = [{
        "name": "dedisperse_direct_sweep",
        "route": "cuda",
        "source": "pulsarutils_tpu_torch/csrc/dedisperse.cu",
        "replaces": "pulsarutils_tpu/ops/pallas_dedisperse.py:208",
        "replaces_also": "pulsarutils_tpu/ops/pallas_dedisperse.py:265",
        "replaces_functions": "ops/pallas_dedisperse.py:_build_kernel_rows,"
                              "_build_kernel",
        "launches": direct["B1"],
        "launches_by_path": {k: v["B1"] for k, v in launches.items()},
        "max_abs_err": max(r["max_abs_diff"] for r in sweep_recs),
        "max_abs_diff": max(r["max_abs_diff"] for r in sweep_recs),
        "ms": head["kernel_ms"],
        "kernel_ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": {**shape, "ndm": head["ndm"],
                  "launches_per_chunk": head["launches_per_call"],
                  "trial_blocks": head["trial_blocks"]},
        "distinct_share": head["distinct_share"],
        "through_entry_points": breakdown,
        "planned_on_card_8_rows": {
            k: v["b1_8_rows"] for k, v in hybrid_split.items()},
        "launches_at": {k: {f: r[f] for f in (
            "ndm", "trial_blocks", "kernel_ms", "plain_ms", "bound_ms",
            "bound_share", "max_abs_diff")}
            for k, r in head["buckets"].items()},
        "card": card,
    }, {
        "name": "fdmt_merge_level",
        "route": "cuda",
        "source": "pulsarutils_tpu_torch/csrc/fdmt_merge.cu",
        "replaces": "pulsarutils_tpu/ops/fdmt.py:480",
        "replaces_functions": "ops/fdmt.py:_build_merge_kernel",
        "launches": main_path["B2a"],
        "launches_by_path": {k: v["B2a"] for k, v in launches.items()},
        "max_abs_err": fdmt_diff,
        "ms": total(merge, "kernel_ms"),
        "plain_ms": total(merge, "plain_ms"),
        "bound_ms": total(merge, "bound_ms"),
        "bound_by": "bytes",
        "library_ms": None,
        "per_level_ms": [r["kernel_ms"] for r in merge],
        "shape": {**shape, "levels": len(merge),
                  "rows_out": [r["rows_out"] for r in merge],
                  "launches_per_chunk": len(merge)},
        "card": card,
    }, {
        "name": "fdmt_head_fused_levels",
        "route": "cuda",
        "source": "pulsarutils_tpu_torch/csrc/fdmt_merge.cu",
        "replaces": "pulsarutils_tpu/ops/fdmt_resident.py:386",
        "replaces_functions": "ops/fdmt_resident.py:_build_head_kernel",
        "launches": main_path["B3"],
        "launches_by_path": {k: v["B3"] for k, v in launches.items()},
        "max_abs_err": fdmt_diff,
        "ms": fused[0]["kernel_ms"],
        "plain_ms": fused[0]["plain_ms"],
        "bound_ms": fused[0]["bound_ms"],
        "bound_by": fused[0]["bound_by"],
        "library_ms": None,
        "per_level_b2a_ms": fused[0]["per_level_b2a_ms"],
        "main_path_shapes": {"e2e_hybrid_chunk": {
            "nsamples": head_chunk["nsamples"],
            **{f: head_chunk[f] for f in checked}}},
        "phases": kernel_breakdown["b3"],
        "shape": {**shape, "levels": fused[0]["levels"],
                  "rows_in": fused[0]["rows_in"],
                  "rows_out": fused[0]["rows_out"],
                  "tile": fused[0]["tile"],
                  "smem_bytes_per_block": fused[0]["smem_bytes_per_block"],
                  "launches_per_chunk": 1},
        "card": card,
    }, {
        "name": "fdmt_merge4_last_two_levels",
        "route": "cuda",
        "source": "pulsarutils_tpu_torch/csrc/fdmt_merge.cu",
        "replaces": "pulsarutils_tpu/ops/fdmt.py:565",
        "replaces_functions": "ops/fdmt.py:_build_merge4_kernel",
        "launches": main_path["B2b"],
        "launches_by_path": {k: v["B2b"] for k, v in launches.items()},
        "max_abs_err": fdmt_diff,
        "ms": total(merge4, "kernel_ms"),
        "plain_ms": total(merge4, "plain_ms"),
        "bound_ms": total(merge4, "bound_ms"),
        "bound_by": merge4[0]["bound_by"],
        "library_ms": None,
        "shape": {**shape, "rows_in": merge4[0]["rows_in"],
                  "rows_out": merge4[0]["rows_out"],
                  "max_shift": merge4[0]["max_shift"],
                  "launches_per_chunk": 1},
        "card": card,
    }, {
        "name": "one_pass_scorer",
        "route": "cuda",
        "source": "pulsarutils_tpu_torch/csrc/score.cu",
        "replaces": "pulsarutils_tpu/ops/score_pallas.py:256",
        "replaces_functions": "ops/score_pallas.py:_build_score_kernel",
        "launches": main_path["B4"],
        "launches_by_path": {k: v["B4"] for k, v in launches.items()},
        "max_abs_err": max(r["max_abs_diff"]
                           for r in [score_head, *score_records]),
        "ms": score_head["kernel_ms"],
        "plain_ms": score_head["plain_ms"],
        "bound_ms": score_head["bound_ms"],
        "bound_by": score_head["bound_by"],
        "library_ms": None,
        "tolerance": score_head["tolerance"],
        "shape": {"rows": score_head["rows"],
                  "nsamples": score_head["nsamples"], "with_cert": True,
                  "launches_per_chunk": 1},
        "card": card,
    }, {
        "name": "fdd_rotate_accumulate",
        "route": "cuda",
        "source": "pulsarutils_tpu_torch/csrc/fdd.cu",
        "replaces": "pulsarutils_tpu/ops/fourier_pallas.py:159",
        "replaces_functions": "ops/fourier_pallas.py:_build_fdd_kernel",
        "launches": fourier["B5"],
        "launches_by_path": {k: v["B5"] for k, v in launches.items()},
        "max_abs_err": max(r["max_abs_diff"] for r in [fdd_head]
                           + [r for r in fdd_records if "max_abs_diff" in r]),
        "ms": fdd_head["kernel_ms"],
        "plain_ms": fdd_head["plain_ms"],
        "bound_ms": fdd_head["bound_ms"],
        "bound_by": fdd_head["bound_by"],
        "bound_with_phasors_ms": fdd_head["bound_with_phasors_ms"],
        "library_ms": None,
        "tolerance": fdd_head["tolerance"],
        "full_sweep": fdd_head["sweep"],
        "shape": {"nchan": fdd_head["nchan"], "nbin": fdd_head["nbin"],
                  "superblock": fdd_head["superblock"],
                  "launches_per_superblock": fdd_head["launches_per_call"]},
        "card": card,
    }]

    def b6_entry(policy):
        """B6's entry under ``policy``: launches on its main path (f32:
        ``period_search``; the other policies: e2e_precision's spectral
        search of the chunk's plane), times at the headline and the main
        shapes."""
        head = harm_head[policy]
        main = {**harm_main[policy], "e2e_precision_plane":
                precision["plane_records"][policy]}
        key = "B6" if policy == "f32" else f"B6[{policy}]"
        entry = {
            "name": ("harmonic_scorer" if policy == "f32"
                     else f"harmonic_scorer[{policy}]"),
            "policy": policy,
            "route": "cuda",
            "source": "pulsarutils_tpu_torch/csrc/harmonic.cu",
            "replaces": "pulsarutils_tpu/ops/harmonic_pallas.py:124",
            "replaces_functions":
                "ops/harmonic_pallas.py:_build_harmonic_kernel",
            "replaces_branch": "ops/harmonic_pallas.py:75-114",
            "launches": (period["period_search"][key] if policy == "f32"
                         else precision["spectral"][policy]["launches"]),
            "launches_by_path": {
                **{k: v[key] for k, v in launches.items()},
                "spectral_search of the e2e chunk (e2e_precision_chunk)":
                    precision["spectral"][policy]["launches"]},
            "max_abs_err": max(r["max_abs_diff"] for r in [
                head, *harm_records[policy], *main.values()]),
            "ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "tolerance": head["tolerance"],
            "shape": {"rows": head["rows"], "nbins": head["nbins"],
                      "depths": head["depths"], "cluster": head["cluster"]},
            "main_path_shapes": {label: {f: r[f] for f in (
                "rows", "nbins", "cluster", "branches_equal",
                "peak_bins_equal", "max_abs_diff", "kernel_ms", "branch_ms",
                "auto_fastest", "plain_ms", "bound_ms", "bound_by",
                "bound_share")} for label, r in main.items()},
            "card": card,
        }
        if policy == "f32":
            entry["phases"] = kernel_breakdown["b6"]
        return entry

    kernels += [b6_entry(policy) for policy in B6_POLICIES]
    check_ok = all(k["launches"] > 0 for k in kernels)
    if not check_ok:
        print(f"chip_smoke: a kernel did not launch on its path: "
              f"{[(k['name'], k['launches']) for k in kernels]}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
