"""The direct-sweep CUDA kernel (``csrc/dedisperse.cu``) bound to PyTorch.

:func:`dedisperse_plane` is the sweep the search calls: on a CUDA tensor it
launches the hand-written kernel (or raises), on a CPU tensor it runs the
plain version :func:`~.dedisperse.dedisperse_plane_plain`.  Both give the
same plane bit for bit.

The host side of a launch (:func:`launch_plan`) rebases the offsets so
that they never straddle the circular wrap, folds the rebase constant
into the kernel's store index, chooses the trial block (8 trials for a
launch of at most 8, else 16), and writes the kernel's per (trial block,
channel) rows: the channel's least offset in the block, a mask of the
trials whose offset differs from the previous trial's (the kernel loads
its window values only there and reuses its registers otherwise), the
largest relative offset (the channel's span beyond the tile, which the
kernel stages), and each trial's offset relative to the least.  The
launch's largest relative offset sizes the shared-memory window or sends
the kernel to its global-memory branch.  :func:`device_plan` adds the
rows' upload; a caller that sweeps one geometry chunk after chunk keeps
its result (the direct search does) and passes it back to
:func:`dedisperse_plane`.

The hybrid sweeps rows that the card picks (its fused seed program)
without a host synchronisation: :func:`row_table` keeps a whole plan's
offsets on the device, rebased once, with a window that bounds every
subset's spread; :func:`table_plan` builds a launch's rows on the device
from the gathered offsets (:func:`plan_rows`), and
:func:`dedisperse_rows` sweeps them.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..obs import roofline
from ..utils import nvcc
from ..utils.device import to_numpy
from .dedisperse import dedisperse_plane_plain

#: trial blocks compiled into csrc/dedisperse.cu: 8 for a launch of at
#: most 8 trials (the hybrid's smallest rescore bucket), else 16 (wider
#: blocks ran slower on an H100 at 512 trials; PERF.md)
TRIAL_BLOCKS = (8, 16)
#: the kernel's samples per block, channels per shared-memory stage and
#: stages in its ring (checked against the library when it is loaded)
TIME_TILE, CHAN_BLOCK, STAGES = 1024, 4, 3

#: dynamic shared memory a block may use for its channel windows; a
#: larger window takes the global-memory branch
SMEM_BUDGET = 192 * 1024

#: kernel launches made so far (the number of calls that reached the card)
launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = nvcc.load("dedisperse")
        lib.dedisperse_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.dedisperse_launch.restype = ctypes.c_int
        lib.dedisperse_error_string.argtypes = [ctypes.c_int]
        lib.dedisperse_error_string.restype = ctypes.c_char_p
        lib.dedisperse_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.dedisperse_geometry.restype = None
        dims = [ctypes.c_int() for _ in range(3)]
        lib.dedisperse_geometry(*[ctypes.byref(d) for d in dims])
        built = tuple(d.value for d in dims)
        if built != (TIME_TILE, CHAN_BLOCK, STAGES):
            raise nvcc.KernelBuildError(
                f"csrc/dedisperse.cu tiling {built} differs from the "
                f"host's {(TIME_TILE, CHAN_BLOCK, STAGES)}")
        _lib = lib
    return _lib


def rebase_offsets(offsets, nsamples):
    """Wrapped ``[0, T)`` offsets -> non-negative offsets without the wrap
    discontinuity, plus the constant ``k`` they were shifted by.

    ``x[c, (t + off) mod T] == x[c, (t + k + rebased) mod T]``, so the
    kernel computes the plane at time ``(t + k) mod T`` and stores it at
    ``t``.  Returns ``(rebased int32, k)``.
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    half = nsamples // 2
    signed = (offsets + half) % nsamples - half
    k = int(signed.min(initial=0))
    return (signed - k).astype(np.int32), k


def choose_trial_block(ndm):
    """The trial block of a launch of ``ndm`` trials."""
    return TRIAL_BLOCKS[0] if ndm <= TRIAL_BLOCKS[0] else TRIAL_BLOCKS[1]


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Host-side arguments of one kernel launch."""
    offsets: np.ndarray   # (ndm, nchan) int32, rebased
    meta: np.ndarray      # (nblocks, nchan, trial_block + 3) int32 rows
    trial_block: int      # trials per block (a compiled template)
    time_tile: int        # samples per block
    chan_block: int       # channels per shared-memory stage
    store_shift: int      # the kernel's value at u is stored at (u + shift) mod T
    spread: int           # largest per-channel offset range in a trial block
    win: int              # shared-memory window length per channel
    use_smem: bool        # False: the kernel's global-memory branch
    distinct_share: float  # window loads per add: marked trials / trials

    @property
    def smem_bytes(self):
        """Dynamic shared memory of one block of this launch."""
        per_chan = self.trial_block + 3 + (self.win if self.use_smem else 0)
        return 4 * STAGES * self.chan_block * per_chan


def _window_bytes(win, chan_block):
    return 4 * STAGES * chan_block * win


def launch_plan(offsets, nsamples, trial_block=None):
    """Plan a launch for ``offsets`` ``(ndm, nchan)`` over ``nsamples``;
    ``trial_block`` overrides :func:`choose_trial_block`."""
    rebased, k = rebase_offsets(offsets, nsamples)
    ndm, nchan = rebased.shape
    block = trial_block or choose_trial_block(ndm)
    if block not in TRIAL_BLOCKS:
        raise ValueError(f"trial block {block} not one of {TRIAL_BLOCKS}")
    tile, chan_block = TIME_TILE, CHAN_BLOCK
    nblocks = -(-ndm // block)
    # the last block's padding repeats the last trial: never a new load
    full = np.concatenate(
        [rebased, np.repeat(rebased[-1:], nblocks * block - ndm, axis=0)])
    blocks = full.reshape(nblocks, block, nchan)
    base = blocks.min(axis=1)
    rel = blocks - base[:, None, :]
    change = np.ones(rel.shape, dtype=bool)
    change[:, 1:] = rel[:, 1:] != rel[:, :-1]
    bits = (change.astype(np.int32)
            << np.arange(block, dtype=np.int32)[None, :, None]).sum(
                axis=1, dtype=np.int32)
    meta = np.concatenate(
        [base[..., None], bits[..., None], rel.max(axis=1)[..., None],
         rel.transpose(0, 2, 1)], axis=2).astype(np.int32)
    spread = int(rel.max(initial=0))
    win = tile + spread
    use_smem = _window_bytes(win, chan_block) <= SMEM_BUDGET
    return LaunchPlan(offsets=rebased, meta=np.ascontiguousarray(meta),
                      trial_block=block, time_tile=tile,
                      chan_block=chan_block, store_shift=(-k) % nsamples,
                      spread=spread, win=win, use_smem=use_smem,
                      distinct_share=float(change.sum()) / max(1, ndm * nchan))


def device_plan(offsets, nsamples, device):
    """``(plan, rows)``: :func:`launch_plan` of ``offsets`` over
    ``nsamples`` and its rows uploaded to ``device``."""
    plan = launch_plan(offsets, nsamples)
    return plan, torch.from_numpy(plan.meta).to(device)


@dataclasses.dataclass(frozen=True)
class RowTable:
    """A plan's whole offset table on the device, for sweeps of any of
    its rows planned there (:func:`table_plan`)."""
    offsets: torch.Tensor  # (ndm, nchan) int32, rebased once, on the device
    nsamples: int
    store_shift: int       # (-k) mod T of the whole table's rebase
    spread: int            # largest per-channel range: bounds any subset's
    win: int               # shared-memory window of every launch
    use_smem: bool


def row_table(offsets, nsamples, device):
    """:class:`RowTable` of the host ``offsets`` ``(ndm, nchan)`` over
    ``nsamples``: one rebase of the whole table (one ``k`` for every
    subset), uploaded to ``device``.  A subset's spread in a channel is
    at most the table's range there, so the table's largest range sizes
    one window for every launch (the global-memory branch where it
    exceeds :data:`SMEM_BUDGET`)."""
    rebased, k = rebase_offsets(offsets, nsamples)
    spread = (int((rebased.max(axis=0) - rebased.min(axis=0)).max())
              if rebased.size else 0)
    win = TIME_TILE + spread
    return RowTable(offsets=torch.from_numpy(rebased).to(device),
                    nsamples=int(nsamples), store_shift=(-k) % nsamples,
                    spread=spread, win=win,
                    use_smem=_window_bytes(win, CHAN_BLOCK) <= SMEM_BUDGET)


def plan_rows(offs, trial_block):
    """:func:`launch_plan`'s per (trial block, channel) rows of rebased
    offsets ``offs`` ``(ndm, nchan)`` (an int tensor), built with tensor
    operations on its device: ``(nblocks, nchan, trial_block + 3)``
    int32, the least offset, the change mask, the largest relative offset
    and the relative offsets."""
    ndm, nchan = offs.shape
    nblocks = -(-ndm // trial_block)
    if nblocks * trial_block > ndm:
        # the last block's padding repeats the last trial: never a load
        offs = torch.cat([offs, offs[-1:].expand(
            nblocks * trial_block - ndm, nchan)])
    blocks = offs.to(torch.int32).reshape(nblocks, trial_block, nchan)
    base = blocks.amin(dim=1)
    rel = blocks - base[:, None, :]
    change = torch.ones_like(rel, dtype=torch.bool)
    change[:, 1:] = rel[:, 1:] != rel[:, :-1]
    weight = 1 << torch.arange(trial_block, dtype=torch.int32,
                               device=offs.device)
    bits = (change.to(torch.int32) * weight[None, :, None]).sum(
        dim=1, dtype=torch.int32)
    return torch.cat([base[..., None], bits[..., None],
                      rel.amax(dim=1)[..., None], rel.transpose(1, 2)],
                     dim=2).contiguous()


def _index(rows, device):
    """``rows`` (a tensor or host indices) as an index tensor on
    ``device``."""
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64))
    return rows.to(device)


def table_plan(table, rows):
    """``(plan, meta)`` of a launch over the :class:`RowTable` rows
    ``rows`` (a device index tensor, or host indices), as
    :func:`device_plan` returns them, planned on the table's device with
    no host synchronisation: ``plan.offsets`` is the gathered device
    tensor, the window the table's, and ``plan.distinct_share`` NaN (it
    would need a readback)."""
    offs = table.offsets[_index(rows, table.offsets.device)]
    block = choose_trial_block(offs.shape[0])
    meta = plan_rows(offs, block)
    return LaunchPlan(offsets=offs, meta=meta, trial_block=block,
                      time_tile=TIME_TILE, chan_block=CHAN_BLOCK,
                      store_shift=table.store_shift, spread=table.spread,
                      win=table.win, use_smem=table.use_smem,
                      distinct_share=float("nan")), meta


def dedisperse_plane_cuda(data, meta, plan):
    """Launch the kernel on ``data`` (nchan, T) float32 with the plan's
    rows ``meta`` (an int32 tensor shaped like ``plan.meta``), both
    contiguous on one CUDA device.

    Returns the ``(ndm, T)`` plane, allocated here; the launch is queued
    on the current stream and not synchronised.
    """
    global launches
    for name, t, dtype in (("data", data, torch.float32),
                           ("meta", meta, torch.int32)):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"{name} must be a {dtype} tensor, got "
                            f"{getattr(t, 'dtype', type(t))}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if data.ndim != 2:
        raise ValueError(f"data must be 2-D, got shape {tuple(data.shape)}")
    nchan, nsamples = data.shape
    ndm = plan.offsets.shape[0]
    block = plan.trial_block
    want = (-(-ndm // block), nchan, block + 3)
    if tuple(meta.shape) != want or plan.offsets.shape[1] != nchan \
            or ndm == 0 or nchan == 0:
        raise ValueError(f"plan rows {tuple(meta.shape)} (offsets "
                         f"{plan.offsets.shape}) does not match data shape "
                         f"{tuple(data.shape)}: expected {want}")
    if block not in TRIAL_BLOCKS:
        raise ValueError(f"trial block {block} not one of {TRIAL_BLOCKS}")
    if nsamples >= 2 ** 29 or not plan.time_tile <= plan.win < 2 ** 29:
        raise ValueError(f"nsamples={nsamples}, win={plan.win} out of range")
    if data.device.type != "cuda" or meta.device != data.device:
        raise ValueError(f"data and meta must be on one CUDA device, got "
                         f"{data.device} and {meta.device}")
    lib = _library()
    out = torch.empty((ndm, nsamples), dtype=torch.float32,
                      device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = lib.dedisperse_launch(
        data.data_ptr(), meta.data_ptr(), out.data_ptr(), nchan, nsamples,
        ndm, int(plan.store_shift), int(plan.win), int(bool(plan.use_smem)),
        block, data.device.index or 0, stream)
    if err != 0:
        raise nvcc.launch_error("dedisperse kernel",
                                lib.dedisperse_error_string(err).decode())
    launches += 1
    return out


def dedisperse_plane(data, offsets, planned=None):
    """Dedispersed plane ``out[d, t] = sum_c data[c, (t + off[d, c]) % T]``.

    ``data`` is a float32 ``(nchan, T)`` tensor; ``offsets`` the host
    ``(ndm, nchan)`` integer table (numpy array or CPU tensor).  A CUDA
    tensor runs the kernel; a CPU tensor runs the plain version.
    ``planned``, the :func:`device_plan` of these offsets on the data's
    device, saves planning them again.
    """
    with roofline.measure(data.device, "dedisperse_direct_sweep",
                          lambda: roofline.sweep_work(len(offsets),
                                                      *data.shape)):
        if data.device.type == "cpu":
            return dedisperse_plane_plain(data, offsets)
        if data.device.type != "cuda":
            raise ValueError(
                f"no dedispersion sweep for device {data.device}")
        plan, meta = planned or device_plan(to_numpy(offsets),
                                            data.shape[1], data.device)
        return dedisperse_plane_cuda(data, meta, plan)


def dedisperse_rows(data, table, rows):
    """The plane of the :class:`RowTable` rows ``rows`` (a device index
    tensor or host indices) of ``data``: on a CUDA tensor the kernel,
    planned on the card (:func:`table_plan`), on a CPU tensor the plain
    version of the same offsets.  Either way each row equals the direct
    sweep's row of that trial bit for bit (the kernel stores the plane
    un-rotated)."""
    with roofline.measure(data.device, "dedisperse_direct_sweep",
                          lambda: roofline.sweep_work(len(rows),
                                                      *data.shape)):
        if data.device.type == "cpu":
            # rebased + k == the offsets mod T, and -k == store_shift
            return dedisperse_plane_plain(
                data, table.offsets[_index(rows, data.device)].to(
                    torch.int64) - table.store_shift)
        if data.device.type != "cuda":
            raise ValueError(
                f"no dedispersion sweep for device {data.device}")
        plan, meta = table_plan(table, rows)
        return dedisperse_plane_cuda(data, meta, plan)
