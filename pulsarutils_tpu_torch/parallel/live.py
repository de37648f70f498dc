"""A live multi-process check of the sharded searches.

``python -m pulsarutils_tpu_torch.parallel.live`` starts ``--nproc``
ranks (two by default) on this host.  Each joins the run over loopback
(:func:`.multihost.initialize`, rank 0's address), builds the
:func:`.multihost.pod_mesh` over ``--local`` shards of ``--device``
(``dm`` across the ranks, ``chan`` within each), makes the same seeded
chunk on its device (``--nchan`` x ``--nsamples``, a pulse at ``--dm``
searched over ``--dmmin``-``--dmmax``), searches it with the sharded
direct sweep, the sharded FDMT and the mesh hybrid (two-stage and
fused), and holds each table to the single-process table on a mesh of
the same global shape, bit for bit, and its argbest row to the
single-device search's.  The orchestrator prints ``MULTIHOST LIVE: OK``
when every rank passed, and exits non-zero otherwise.

The shards are on the card (``cuda:0``) unless ``--device`` names
another device, ``cpu`` included.  Several ranks on one card join with
``--backend gloo`` (NCCL puts one rank on a device); ``--backend nccl
--nproc 1`` brings up NCCL alone.  Every rank has a time limit
(``--timeout``); a rank that overruns it is killed.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

#: the band of the chunk: (lowest frequency MHz, bandwidth MHz, sample s)
BAND = (1200.0, 200.0, 5e-4)
#: the pulse: (signal, noise) of ``|Normal(impulse, noise)|``, and the
#: seed of the noise
PULSE = (2.0, 0.4)
SEED = 77


def _free_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _tables_equal(a, b, cols):
    import numpy as np

    return all(np.array_equal(np.asarray(a[c]), np.asarray(b[c]))
               for c in cols)


def make_chunk(opts, dev):
    """The seeded chunk on ``dev``: ``|Normal(impulse, noise)|`` with the
    impulse at ``nsamples // 2``, each channel rolled forward by its
    delay at ``opts.dm`` (the port's ``simulate_test_data``, made on the
    device; every rank on one kind of device makes the same values)."""
    import numpy as np
    import torch

    from ..ops.plan import dedispersion_shifts

    signal, noise = PULSE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((opts.nchan, opts.nsamples), generator=gen, device=dev)
    x.mul_(noise)
    x[:, opts.nsamples // 2] += signal
    x.abs_()
    shifts = np.rint(np.asarray(dedispersion_shifts(
        opts.nchan, opts.dm, *BAND))).astype(np.int64) % opts.nsamples
    for c, shift in enumerate(shifts):
        x[c] = torch.roll(x[c], int(shift))
    return x


def rank_main(opts):
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..ops.search import dedispersion_search
    from . import multihost
    from .mesh import make_mesh
    from .sharded import sharded_dedispersion_search
    from .sharded_fdmt import sharded_fdmt_search, sharded_hybrid_search

    rank = int(os.environ["PUTPU_LIVE_RANK"])
    os.environ.setdefault("PUTPU_AUTOTUNE", "off")
    dev = torch.device(opts.device)
    multi = multihost.initialize(
        coordinator_address=f"127.0.0.1:{opts.port}",
        num_processes=opts.nproc, process_id=rank, backend=opts.backend,
        timeout_s=opts.timeout)
    assert multi == (opts.nproc > 1), multi
    assert multihost.process_count() == opts.nproc
    mesh = multihost.pod_mesh(chan_per_host=opts.chan,
                              devices=[dev] * opts.local)
    assert mesh.process_count == opts.nproc
    array = make_chunk(opts, dev)
    args = (opts.dmmin, opts.dmmax, *BAND)
    # the same global shape in one process: every shard on this rank's
    # device
    shape = tuple(mesh.shape.values())
    single = make_mesh(shape, devices=[dev] * int(np.prod(shape)))
    cols = ("DM", "max", "std", "snr", "rebin", "peak")
    hybrid = cols + ("exact", "cert")
    runs = (
        ("sweep", sharded_dedispersion_search, {}, cols),
        ("fdmt", sharded_fdmt_search, {}, cols),
        ("hybrid", sharded_hybrid_search, {"fused": False}, hybrid),
        ("hybrid_fused", sharded_hybrid_search, {"fused": True}, hybrid),
    )
    ref = dedispersion_search(array, *args, device=dev)
    for name, search, kw, names in runs:
        got = search(array, *args, mesh=mesh, **kw)
        want = search(array, *args, mesh=single, **kw)
        assert _tables_equal(got, want, names), name
        if name != "fdmt":
            assert got.argbest() == ref.argbest(), (name, got.argbest(),
                                                    ref.argbest())
        print(f"rank {rank}: {name} on {dict(mesh.shape)} over "
              f"{opts.nproc} process(es) == the single-process table, "
              f"argbest DM {float(got['DM'][got.argbest()]):.2f}",
              flush=True)
    if opts.backend == "nccl":
        # the collective itself, on the card, whatever the world size
        x = torch.arange(4, dtype=torch.float32, device=dev) + rank
        parts = [torch.empty_like(x) for _ in range(opts.nproc)]
        dist.all_gather(parts, x)
        assert all(torch.equal(p, torch.arange(4, dtype=torch.float32,
                                               device=dev) + r)
                   for r, p in enumerate(parts))
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: OK", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda:0",
                    help="the device of every shard (cpu: a host run)")
    ap.add_argument("--nchan", type=int, default=32)
    ap.add_argument("--nsamples", type=int, default=2048)
    ap.add_argument("--dmmin", type=float, default=100.0)
    ap.add_argument("--dmmax", type=float, default=200.0)
    ap.add_argument("--dm", type=float, default=150.0,
                    help="the pulse's DM")
    ap.add_argument("--local", type=int, default=4,
                    help="mesh shards each rank drives")
    ap.add_argument("--chan", type=int, default=2,
                    help="channel shards within a rank")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds each rank may take")
    ap.add_argument("--port", type=int, default=None)
    opts = ap.parse_args(argv)
    import torch

    if torch.device(opts.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(f"--device {opts.device}: no CUDA device here "
                           "(--device cpu runs the check on the host)")
    if "PUTPU_LIVE_RANK" in os.environ:
        rank_main(opts)
        return 0
    port = opts.port or _free_port()
    cmd = [sys.executable, "-m", "pulsarutils_tpu_torch.parallel.live",
           *(argv if argv is not None else sys.argv[1:]),
           "--port", str(port)]
    procs = [subprocess.Popen(cmd, env=dict(os.environ,
                                            PUTPU_LIVE_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(opts.nproc)]
    ok = True
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=opts.timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            print(f"--- rank {r}: killed after {opts.timeout} s", flush=True)
        tail = "\n".join(out.strip().splitlines()[-6:])
        print(f"--- rank {r} (rc={p.returncode}) ---\n{tail}", flush=True)
        ok = ok and p.returncode == 0 and f"rank {r}: OK" in out
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    print("MULTIHOST LIVE: OK" if ok else "MULTIHOST LIVE: FAILED",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
