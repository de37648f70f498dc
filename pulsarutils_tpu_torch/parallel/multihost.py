"""Multi-process execution: the sharded searches across processes.

The port of the JAX package's module.  One process per host drives its
own devices (:mod:`.mesh`); ``torch.distributed`` joins the processes.
Only the ``dm`` axis spans processes (:func:`pod_mesh`): trial shards
never communicate, so the only thing that crosses processes is the
small stacked score blocks (and the hybrid's coarse score packs),
gathered with ``all_gather`` (:func:`.mesh.fetch_global`).  The
``chan`` axis, whose partial sums are added in order, stays inside a
process.

Typical use, every process running the same program on the same input::

    from pulsarutils_tpu_torch.parallel import multihost, sharded
    multihost.initialize("10.0.0.1:29500", num_processes=2, process_id=r)
    mesh = multihost.pod_mesh()          # ("dm" over processes, "chan" in)
    table = sharded.sharded_dedispersion_search(array, ..., mesh=mesh)

On one process both functions degrade to the local equivalents.  NCCL
puts one rank on a device, so several processes sharing one card join
with the ``gloo`` backend (host score blocks).  ``python -m
pulsarutils_tpu_torch.parallel.live`` runs a two-rank check.
"""

from __future__ import annotations

import os

import torch

from .mesh import Mesh, _object_grid, default_devices

__all__ = ["initialize", "process_count", "process_index",
           "local_device_count", "pod_mesh", "process_local_slice"]

_STATE = {"done": False, "multi": False}


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None, timeout_s=None):
    """Join the processes of a run (idempotent).

    Explicit arguments (``coordinator_address`` ``"host:port"``,
    ``num_processes``, ``process_id``) start
    ``torch.distributed.init_process_group`` over ``tcp://``; a failure
    propagates and is not cached, so a retry works (one host of a real
    cluster must not run on alone while its peers wait in a
    collective).  With none, the ``torchrun`` environment
    (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``) is used when it is set;
    otherwise the process runs alone.  ``backend`` defaults to NCCL with
    a card and gloo without.  Returns True when more than one process
    takes part, False on a single process.
    """
    import datetime

    import torch.distributed as dist

    if _STATE["done"]:
        return _STATE["multi"]
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    if coordinator_address is not None or num_processes is not None:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError("an explicit cluster needs coordinator_address, "
                             "num_processes and process_id")
        if not dist.is_initialized():
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=int(num_processes), rank=int(process_id), **kw)
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        if not dist.is_initialized():
            dist.init_process_group(backend, init_method="env://", **kw)
    multi = dist.is_initialized() and dist.get_world_size() > 1
    _STATE.update(done=True, multi=multi)
    return multi


def process_count():
    """Processes in the run (1 without ``torch.distributed``)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    """This process's rank (0 without ``torch.distributed``)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def local_device_count(devices=None):
    """Devices this process drives: ``len(devices)``, else its CUDA
    devices."""
    return len(devices) if devices is not None else len(default_devices())


def pod_mesh(axis_names=("dm", "chan"), chan_per_host=None, devices=None):
    """A global (dm, chan) mesh for the sharded sweep across processes.

    Layout rule: the ``chan`` axis (whose partial sums are added in
    order) stays INSIDE a process, while the communication-free ``dm``
    axis spans processes.  With ``L`` local devices (``devices``, default
    every CUDA device) and ``P`` processes the mesh is ``(P * L / chan,
    chan)`` with ``chan = chan_per_host``, else the JAX package's rule: a
    power of two, doubled from 1 while ``chan**2 * 4 <= L``.  On one
    process this is a local mesh, same code path.
    """
    local = local_device_count(devices)
    if chan_per_host is None:
        chan_per_host = 1
        while chan_per_host * chan_per_host * 4 <= local:
            chan_per_host *= 2
    chan_per_host = max(1, min(chan_per_host, local))
    nproc, rank = process_count(), process_index()
    if local % chan_per_host:
        raise ValueError(f"chan_per_host={chan_per_host} must divide the "
                         f"local device count {local}")
    devs = default_devices() if devices is None else [torch.device(d)
                                                      for d in devices]
    # the global device list is process-major, so reshaping to (ndev //
    # chan, chan) keeps each chan group within one process; this process
    # holds rows local // chan of it
    ndev = local * nproc
    if ndev % chan_per_host:
        raise ValueError(f"chan_per_host={chan_per_host} must divide the "
                         f"device count {ndev}")
    rows = local // chan_per_host
    grid = _object_grid(devs[:local], (rows, chan_per_host))
    return Mesh(grid, tuple(axis_names), process_index=rank,
                process_count=nproc)


def process_local_slice(n, axis_size=None, index=None):
    """Host-local [start, stop) share of ``n`` items for data loading.

    For feeding a multi-process run from per-host files/chunks: process
    ``i`` of ``P`` reads rows ``[i*n/P, (i+1)*n/P)``.  Single process: the
    whole range.
    """
    p = axis_size if axis_size is not None else process_count()
    i = index if index is not None else process_index()
    lo = (n * i) // p
    hi = (n * (i + 1)) // p
    return lo, hi
