#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pulsarutils_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--quick]

Phases, one JSON line each:

1. environment: the card (``nvidia-smi`` name and power limit, printed
   raw on a line of its own), PyTorch and CUDA versions; TF32 is turned
   off for matmuls and cuDNN;
2. build: every CUDA source of the port's main path, with ``nvcc``, all
   started together;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs — the direct sweep at the headline geometry (1024 channels x
   2^20 samples, the 514-trial DM 300-635 plan, in the search's 512-trial
   superblocks) and on edge cases — requiring max |diff| == 0, timed with
   CUDA events (one warm-up, median of 5);
4. end to end: a simulated 1024-channel 8-bit filterbank with a dispersed
   pulse, searched by the port's ``search_by_chunks`` on the card in
   2^18-sample chunks: the pulse must be found in its chunk at the
   injected DM, through the kernel (its launch count is read around this
   phase alone), with the ledger written; the cleaned chunk and a cut of
   the search are checked against the CPU path;
5. the kernels line, then ``{"ok": true, "device": {...}}`` last.

Any failed check exits non-zero before the last line.  Without a CUDA
device, or without the package beside this script, it exits non-zero
and prints no result.  ``--quick`` stops after the kernel checks at small
shapes (a first run of a new kernel).
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

#: NVIDIA H100 SXM data-sheet peaks (700 W): float32 on the CUDA cores,
#: and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12

#: the headline geometry of the JAX package's benchmark
NCHAN, NSAMPLES = 1024, 1 << 20
START_FREQ, BANDWIDTH, TSAMP = 1200.0, 200.0, 5e-4
DMMIN, DMMAX = 300.0, 635.0

#: end-to-end file: 2.5 chunks of 2^18 samples (4 chunks at 50% overlap)
E2E_CHUNK = 1 << 18
E2E_NSAMPLES = 5 * E2E_CHUNK // 2
E2E_DM = 400.0


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def time_ms(torch, fn, runs=5):
    """Median and all of ``runs`` CUDA-event timings of ``fn`` (ms), after
    one warm-up call."""
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


def sweep_bound_ms(ndm, nchan, nsamples):
    """Least time for the sweep on the card: the larger of its adds over
    the float32 peak and its bytes (input, offsets and plane, each once)
    over the memory rate."""
    ops = ndm * nchan * nsamples
    nbytes = 4 * (nchan * nsamples + ndm * nsamples + ndm * nchan)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
    built = nvcc.build(["dedisperse"])
    for name, (path, seconds, log) in built.items():
        resources = [line.strip() for line in log.splitlines()
                     if "registers" in line or "spill" in line]
        emit("build", source=f"pulsarutils_tpu_torch/csrc/{name}.cu",
             library=path.name, seconds=round(seconds, 3),
             ptxas=resources)
    emit("build_total", seconds=round(time.perf_counter() - t0, 3))


def _sweep_case(torch, name, data, offsets, *, timed=True,
                superblock=None):
    """Kernel vs plain on one input; returns the case's record."""
    from pulsarutils_tpu_torch.ops import dedisperse_cuda as dc
    from pulsarutils_tpu_torch.ops.dedisperse import dedisperse_plane_plain

    ndm, nchan = offsets.shape
    nsamples = data.shape[1]
    superblock = superblock or ndm
    blocks = [offsets[lo:lo + superblock]
              for lo in range(0, ndm, superblock)]
    plans = [dc.launch_plan(b, nsamples) for b in blocks]
    dev_off = [torch.from_numpy(p.offsets).to(data.device) for p in plans]

    def kernel():
        return [dc.dedisperse_plane_cuda(data, o, p.store_shift, p.win,
                                         p.use_smem)
                for o, p in zip(dev_off, plans)]

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
    bound, bound_by = sweep_bound_ms(ndm, nchan, nsamples)
    record = {"case": name, "ndm": ndm, "nchan": nchan,
              "nsamples": nsamples, "launches_per_call": len(blocks),
              "use_smem": [p.use_smem for p in plans],
              "spread": max(p.spread for p in plans),
              "max_abs_diff": diff, "tolerance": "max_abs_diff == 0",
              "bound_ms": bound, "bound_by": bound_by}
    if timed:
        record["kernel_ms"], record["kernel_runs_ms"] = time_ms(torch, kernel)
        record["wrapper_ms"], _ = time_ms(torch, wrapper)
        record["plain_ms"], record["plain_runs_ms"] = time_ms(torch, plain)
        record["bound_share"] = bound / record["kernel_ms"]
    del got, want
    torch.cuda.empty_cache()
    emit("kernel_check", **record)
    return record


def phase_kernels(torch, np, seed, quick):
    from pulsarutils_tpu_torch.ops.dedisperse_cuda import launch_plan
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
    ]
    for name, nchan, nsamples, off in cases:
        plan = launch_plan(off, nsamples)
        if name == "large_spread_global_branch":
            check(not plan.use_smem, f"{name}: took the smem branch")
        if name == "large_max_off_smem":
            check(plan.use_smem and plan.offsets.max() > nsamples // 4,
                  f"{name}: max offset {plan.offsets.max()} / smem "
                  f"{plan.use_smem}")
        records.append(_sweep_case(torch, name, data(nchan, nsamples), off,
                                   timed=timed))
    if quick:
        return None, records
    head = _sweep_case(torch, "headline", data(NCHAN, NSAMPLES),
                       plan_offsets(NCHAN, NSAMPLES), superblock=SUPERBLOCK)
    check(head["ndm"] == 514 and head["launches_per_call"] == 2,
          f"headline plan: {head['ndm']} trials, "
          f"{head['launches_per_call']} launches")
    torch.cuda.empty_cache()
    return head, records


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


def phase_end_to_end(torch, np, seed, workdir):
    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader
    from pulsarutils_tpu_torch.ops import dedisperse_cuda
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan
    from pulsarutils_tpu_torch.pipeline.search_pipeline import (
        clean_chunk, plan_survey, search_by_chunks)
    from pulsarutils_tpu_torch.ops.search import dedispersion_search

    path = workdir / "e2e.fil"
    t0 = time.perf_counter()
    _write_e2e_file(np, path, seed)
    emit("e2e_file", path=path.name, nchan=NCHAN, nsamples=E2E_NSAMPLES,
         nbits=8, dm=E2E_DM, bytes=path.stat().st_size,
         seconds=round(time.perf_counter() - t0, 3))

    chunk_length = E2E_CHUNK // 2 * TSAMP
    sp = plan_survey(str(path), chunk_length=chunk_length, dmmin=DMMIN,
                     dmmax=DMMAX)
    check(sp["plan"].step == E2E_CHUNK, f"chunk of {sp['plan'].step}")
    dms = dedispersion_plan(NCHAN, DMMIN, DMMAX, START_FREQ, BANDWIDTH,
                            TSAMP)
    stages = {}
    torch.cuda.reset_peak_memory_stats()
    dedisperse_cuda.launches = 0
    t0 = time.perf_counter()
    hits, store = search_by_chunks(
        str(path), chunk_length=chunk_length, dmmin=DMMIN, dmmax=DMMAX,
        snr_threshold=8.0, output_dir=str(workdir / "out"), device="cuda",
        stage_seconds=stages)
    wall = time.perf_counter() - t0
    launches = dedisperse_cuda.launches
    nchunks = len(sp["chunk_starts"])
    loop_s = wall - stages.get("badchans", 0.0)
    check(launches == 2 * nchunks,
          f"{launches} kernel launches for {nchunks} chunks")
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
    return launches


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true",
                        help="build and check the kernels at small shapes "
                             "only")
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

    workdir = BUILD_DIR / "chip_smoke"
    try:
        card = phase_environment(torch)
        phase_build()
        head, records = phase_kernels(torch, np, opts.seed, opts.quick)
        if opts.quick:
            return 0
        shutil.rmtree(workdir, ignore_errors=True)
        workdir.mkdir(parents=True)
        launches = phase_end_to_end(torch, np, opts.seed, workdir)
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernel = {
        "name": "dedisperse_direct_sweep",
        "route": "cuda",
        "source": "pulsarutils_tpu_torch/csrc/dedisperse.cu",
        "replaces": "pulsarutils_tpu/ops/pallas_dedisperse.py:208",
        "replaces_also": "pulsarutils_tpu/ops/pallas_dedisperse.py:265",
        "replaces_functions": "ops/pallas_dedisperse.py:_build_kernel_rows,"
                              "_build_kernel",
        "launches": launches,
        "max_abs_err": max(r["max_abs_diff"] for r in [head, *records]),
        "max_abs_diff": max(r["max_abs_diff"] for r in [head, *records]),
        "ms": head["kernel_ms"],
        "kernel_ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": {"nchan": NCHAN, "nsamples": NSAMPLES, "ndm": head["ndm"],
                  "launches_per_chunk": head["launches_per_call"]},
        "card": card,
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
