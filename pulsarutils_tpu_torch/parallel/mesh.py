"""Device meshes for the sharded searches.

The port of the JAX package's module.  A :class:`Mesh` is a grid of
``torch.device`` objects with named axes, ``("dm", "chan")`` by
default:

* ``"dm"``: trial sharding, with no communication (the reference's
  ``prange`` over trials, ``pulsarutils/dedispersion.py:174-181``);
* ``"chan"``: channel sharding of the input, whose partial sums are
  added in ascending channel-shard order on the dm row's first device
  (the JAX package's ``psum``; :mod:`.sharded`).

One process drives every device of its mesh: a sharded search is a
plain Python loop over the shards, each shard's launches queued on its
device's current stream.  Devices may repeat: ``[torch.device("cuda:0")]
* 4`` is a 2 x 2 mesh of virtual shards on one card, and
``[torch.device("cpu")] * 8`` the CPU counterpart of the JAX package's
eight virtual devices.  Across processes only the ``dm`` axis spans
processes (:func:`.multihost.pod_mesh`): ``shape["dm"]`` is then the
global dm size and :attr:`Mesh.devices` this process's own rows.

The JAX package's ``shard_map_compat`` has no counterpart: there is no
compiled SPMD program to build, only the loop.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "balanced_2d_mesh", "pad_to_multiple",
           "fetch_global", "default_devices"]


def default_devices():
    """Every CUDA device of this process; raises without one (a mesh never
    falls back to the CPU on its own)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "make_mesh() with devices=None needs a CUDA device, and "
            "torch.cuda.is_available() is False; pass devices=[torch."
            "device('cpu')] * n for a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _object_grid(items, shape):
    grid = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        grid[i] = item
    return grid.reshape(shape)


class Mesh:
    """A grid of devices with named axes.

    ``devices`` is this process's grid (a numpy object array of
    ``torch.device``); ``axis_names`` its axes.  ``shape`` is an ordered
    ``{axis: size}`` dict, as the JAX ``Mesh.shape``, global across
    processes: with ``process_count`` processes the ``"dm"`` entry is
    ``process_count`` times the local rows, this process driving global
    dm rows ``dm_offset .. dm_offset + local rows``.  ``ids`` holds each
    grid entry's position in the device list the mesh was cut from
    (global across processes, process-major).
    """

    def __init__(self, devices, axis_names=("dm", "chan"), *,
                 process_index=0, process_count=1, ids=None):
        devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"device grid of rank {devices.ndim} does not "
                             f"match axes {self.axis_names}")
        self.devices = devices
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        if self.process_count > 1 and self.axis_names[0] != "dm":
            raise ValueError("only the 'dm' axis may span processes, and it "
                             "must be the mesh's first axis")
        if ids is None:
            ids = (np.arange(devices.size).reshape(devices.shape)
                   + self.process_index * devices.size)
        self.ids = np.asarray(ids)

    @property
    def shape(self):
        """``{axis: global size}`` in axis order."""
        sizes = list(self.devices.shape)
        if self.process_count > 1:
            sizes[0] *= self.process_count
        return collections.OrderedDict(zip(self.axis_names, sizes))

    @property
    def local_shape(self):
        """``{axis: size}`` of this process's grid."""
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def dm_offset(self):
        """The first global ``dm`` row this process drives."""
        if "dm" not in self.axis_names:
            return 0
        return self.process_index * self.local_shape["dm"]

    @property
    def home(self):
        """The grid's first device: where a host input is uploaded and
        where the dm shards' results are assembled."""
        return self.devices.flat[0]

    @property
    def all_cuda(self):
        return all(torch.device(d).type == "cuda" for d in self.devices.flat)

    def axis_devices(self, axis="dm"):
        """One device per index of ``axis`` in this process's grid: the
        first device along the other axes (the dm row's device, where its
        partial sums are added and scored)."""
        pos = self.axis_names.index(axis)
        grid = np.moveaxis(self.devices, pos, 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])

    def grid(self, dm_axis="dm", chan_axis="chan"):
        """This process's devices as a ``(dm, chan)`` grid (a one-axis
        mesh as one channel column)."""
        if chan_axis not in self.axis_names:
            return np.asarray(self.axis_devices(dm_axis),
                              dtype=object).reshape(-1, 1)
        grid = np.moveaxis(self.devices, (self.axis_names.index(dm_axis),
                                          self.axis_names.index(chan_axis)),
                           (0, 1))
        return grid.reshape(grid.shape[0], grid.shape[1], -1)[..., 0]

    def __repr__(self):
        shape = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        procs = (f", process {self.process_index}/{self.process_count}"
                 if self.process_count > 1 else "")
        return f"Mesh({shape}{procs}, devices={sorted({str(d) for d in self.devices.flat})})"


def make_mesh(shape=None, axis_names=("dm", "chan"), devices=None):
    """Build a :class:`Mesh` over ``devices`` (default: every CUDA device;
    raises without one).

    ``shape=None`` puts every device on the first axis.  ``shape``
    entries may include ``-1`` (inferred).  The mesh uses the first
    ``prod(shape)`` devices and raises if it needs more.  Devices may
    repeat (virtual shards of one device).
    """
    devices = default_devices() if devices is None else [
        torch.device(d) for d in devices]
    ndev = len(devices)
    if shape is None:
        shape = (ndev,) + (1,) * (len(axis_names) - 1)
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = ndev // known
    total = int(np.prod(shape))
    if total > ndev:
        raise ValueError(f"mesh shape {tuple(shape)} needs {total} devices, "
                         f"have {ndev}")
    return Mesh(_object_grid(devices[:total], shape), tuple(axis_names))


def balanced_2d_mesh(n_devices=None, devices=None):
    """A (dm, chan) mesh that puts most parallelism on the free ``dm`` axis
    but keeps a non-trivial ``chan`` dimension when enough devices exist
    (so the channel-sum path is actually exercised)."""
    if devices is None and n_devices is None:
        devices = default_devices()
    ndev = n_devices if n_devices is not None else len(devices)
    chan = 2 if ndev % 2 == 0 and ndev >= 4 else 1
    return make_mesh((ndev // chan, chan), ("dm", "chan"), devices=devices)


def pad_to_multiple(array, axis, multiple, mode="edge"):
    """Pad ``array`` along ``axis`` so its length is a multiple.

    Returns ``(padded, original_length)``.  Used to make trial/channel
    counts divisible by the mesh axis sizes (padded trials are duplicates,
    padded channels are zeros — both exact no-ops for the search result
    after slicing back).
    """
    n = array.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return array, n
    widths = [(0, 0)] * array.ndim
    widths[axis] = (0, pad)
    kwargs = {} if mode != "constant" else {"constant_values": 0}
    return np.pad(array, widths, mode=mode, **kwargs), n


def fetch_global(local, mesh=None, axis=-1):
    """This process's share of a dm-sharded result -> the whole result as
    host numpy, on every process.

    ``local`` (a tensor on any device, or an array) holds the rows of
    this process's dm shards along ``axis``.  On a single-process mesh
    (or with ``mesh=None``) it is read back as it is.  Across processes
    the shares are gathered with ``torch.distributed.all_gather`` in the
    list form (host tensors under gloo, device tensors under NCCL),
    padded to the widest share and cut back, and concatenated in process
    order: every process gets the same array.
    """
    from ..utils.device import to_numpy

    if mesh is None or mesh.process_count <= 1:
        return to_numpy(local)
    import torch.distributed as dist

    x = torch.as_tensor(local)
    if dist.get_backend() == "nccl":
        x = x.to(torch.device("cuda", torch.cuda.current_device()))
    else:
        x = x.cpu()
    axis = axis % x.ndim
    widths = [torch.zeros(1, dtype=torch.int64, device=x.device)
              for _ in range(mesh.process_count)]
    dist.all_gather(widths, torch.tensor([x.shape[axis]], dtype=torch.int64,
                                         device=x.device))
    widths = [int(w.item()) for w in widths]
    widest = max(widths)
    if x.shape[axis] < widest:
        pad = list(x.shape)
        pad[axis] = widest - x.shape[axis]
        x = torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)],
                      dim=axis)
    parts = [torch.empty_like(x) for _ in range(mesh.process_count)]
    dist.all_gather(parts, x.contiguous())
    return np.concatenate([to_numpy(p.narrow(axis, 0, w))
                           for p, w in zip(parts, widths)], axis=axis)
