"""The FDMT kernels (``csrc/fdmt_merge.cu``) bound to PyTorch.

:func:`head` (the first levels fused), :func:`merge` (one tree level) and
:func:`merge4` (the last two deep levels fused) are the passes
:func:`~.fdmt.fdmt_transform` calls: on a CUDA tensor each launches its
hand-written kernel (or raises), on a CPU tensor each runs its plain
version (:func:`~.fdmt.head_plain`, :func:`~.fdmt.merge_plain`,
:func:`~.fdmt.merge4_plain`).  Kernel and plain version agree bit for bit.

The host side of a launch (:func:`merge_table`, :func:`merge4_table`)
packs a level's int32 tables into one array and reduces every shift into
``[0, T)``, so the kernel wraps an index with one subtraction;
:func:`head_table` and :func:`head_params` lay out the head's per-block
tables and tile geometry.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..obs import roofline
from ..utils import nvcc
from .fdmt import (HEAD_CLUSTER, HEAD_GROUP, HEAD_LEVELS, head_plain,
                   merge4_plain, merge_plain)

#: tiling compiled into csrc/fdmt_merge.cu (checked against the library
#: when it is loaded)
TIME_TILE = 1024
MAX_ROW_BLOCKS = 65535

#: length of the head's parameter array (``HeadParams``)
HEAD_PARAMS_LEN = 8 + 3 * HEAD_LEVELS + 3

#: kernel launches made so far, per entry point (B2a: one tree level;
#: B2b: the fused last two levels; B3: the fused head)
merge_launches = 0
merge4_launches = 0
head_launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = nvcc.load("fdmt_merge")
        for fn in (lib.fdmt_merge_launch, lib.fdmt_merge4_launch):
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.fdmt_merge_error_string.argtypes = [ctypes.c_int]
        lib.fdmt_merge_error_string.restype = ctypes.c_char_p
        lib.fdmt_head_launch.argtypes = ([ctypes.c_void_p] * 3
                                         + [ctypes.POINTER(ctypes.c_int),
                                            ctypes.c_int, ctypes.c_void_p])
        lib.fdmt_head_launch.restype = ctypes.c_int
        lib.fdmt_head_params_len.argtypes = []
        lib.fdmt_head_params_len.restype = ctypes.c_int
        for fn, n in ((lib.fdmt_merge_geometry, 2),
                      (lib.fdmt_head_geometry, 3)):
            fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * n
            fn.restype = None
        built = []
        for fn, n in ((lib.fdmt_merge_geometry, 2),
                      (lib.fdmt_head_geometry, 3)):
            dims = [ctypes.c_int() for _ in range(n)]
            fn(*[ctypes.byref(d) for d in dims])
            built += [d.value for d in dims]
        built.append(lib.fdmt_head_params_len())
        host = [TIME_TILE, MAX_ROW_BLOCKS, HEAD_LEVELS, HEAD_GROUP,
                HEAD_CLUSTER, HEAD_PARAMS_LEN]
        if built != host:
            raise nvcc.KernelBuildError(
                f"csrc/fdmt_merge.cu geometry {built} differs from the "
                f"host's {host}")
        _lib = lib
    return _lib


def merge_table(it, nsamples):
    """One level's ``(4, rows_out)`` int32 launch table: ``idx_high,
    idx_low, shift_high, shift_low``, shifts reduced mod ``nsamples``
    (``shift_high`` is 0 in the deep levels)."""
    rows = len(it["idx_low"])
    sh = it["shift_high"]
    sh = np.zeros(rows, np.int64) if sh is None else sh
    return np.stack([
        np.asarray(it["idx_high"], np.int64),
        np.asarray(it["idx_low"], np.int64),
        np.asarray(sh, np.int64) % nsamples,
        np.asarray(it["shift"], np.int64) % nsamples,
    ]).astype(np.int32)


def merge4_table(idx, shift, nsamples):
    """The fused pass's ``(8, rows_out)`` int32 launch table: the four
    parent rows, then their four shifts reduced mod ``nsamples``."""
    return np.concatenate([
        np.stack([np.asarray(i, np.int64) for i in idx]),
        np.stack([np.asarray(s, np.int64) for s in shift]) % nsamples,
    ]).astype(np.int32)


@functools.lru_cache(maxsize=32)
def head_table(head):
    """The head's int32 launch table, flat: per level ``(n_groups,
    HEAD_CLUSTER, 4, rows[l])`` (``ph, pl, sh, sl`` of each block's rows:
    the parents as ``owner << 16 | local``, then their shifts; zero past
    the block's count), then the ``(HEAD_LEVELS, n_groups, HEAD_CLUSTER)``
    row counts, then the head's output row of each block's rows of the
    last level ``(n_groups, HEAD_CLUSTER, rows[-1])``.  Returns ``(table,
    offsets)``, ``offsets`` the level tables' starts, the counts' and the
    output rows'."""
    parts, offsets, at = [], [], 0
    for lev, per_group in enumerate(head.tables):
        block = np.zeros((head.n_groups, HEAD_CLUSTER, 4, head.rows[lev]),
                         np.int32)
        for g, (_, _, sh, sl) in enumerate(per_group):
            owner, local = head.owners[lev][g]
            ph, pl = head.refs[lev][g]
            for k, a in enumerate((ph, pl, sh, sl)):
                block[g, owner, k, local] = a
        parts.append(block.ravel())
        offsets.append(at)
        at += block.size
    # the head's output row of each block's rows of the last level
    outs = np.zeros((head.n_groups, HEAD_CLUSTER, head.rows[-1]), np.int32)
    for g, (owner, local) in enumerate(head.owners[-1]):
        outs[g, owner, local] = head.row_starts[g] + np.arange(len(owner))
    for extra in (head.block_counts, outs):
        parts.append(extra.astype(np.int32).ravel())
        offsets.append(at)
        at += extra.size
    return np.concatenate(parts), offsets


def head_params(head, offsets, nsamples, rows_valid):
    """The kernel's ``HeadParams`` for ``(rows_valid, nsamples)`` data, as
    a list of ints in the struct's order."""
    tile = head.tile(nsamples)
    params = [nsamples, rows_valid, head.n_groups,
              -(-nsamples // tile), tile, head.stride(tile), *head.buf_rows,
              *head.rows, *head.widths(tile), *offsets, head.barriers]
    assert len(params) == HEAD_PARAMS_LEN
    return params


def _check(state, table, nrows):
    if not isinstance(state, torch.Tensor) or state.dtype != torch.float32:
        raise TypeError(f"state must be a torch.float32 tensor, got "
                        f"{getattr(state, 'dtype', type(state))}")
    if state.ndim != 2:
        raise ValueError(f"state must be 2-D, got shape {tuple(state.shape)}")
    if not state.is_contiguous():
        raise ValueError("state must be contiguous")
    if not isinstance(table, torch.Tensor) or table.dtype != torch.int32 \
            or table.ndim != 2 or table.shape[0] != nrows \
            or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous ({nrows}, rows_out) "
                         f"int32 tensor, got {getattr(table, 'shape', None)}")
    rows_in, nsamples = state.shape
    if table.shape[1] == 0 or rows_in == 0 or nsamples == 0:
        raise ValueError(f"empty merge: state {tuple(state.shape)}, table "
                         f"{tuple(table.shape)}")
    if nsamples >= 2 ** 30:
        raise ValueError(f"nsamples={nsamples} out of range")
    if state.device.type != "cuda" or table.device != state.device:
        raise ValueError(f"state and table must be on one CUDA device, got "
                         f"{state.device} and {table.device}")


def _launch(fn, state, table):
    rows_valid, nsamples = state.shape
    rows_out = table.shape[1]
    lib = _library()
    out = torch.empty((rows_out, nsamples), dtype=torch.float32,
                      device=state.device)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = getattr(lib, fn)(state.data_ptr(), table.data_ptr(),
                           out.data_ptr(), rows_valid, rows_out, nsamples,
                           state.device.index or 0, stream)
    if err != 0:
        raise nvcc.launch_error(fn,
                                lib.fdmt_merge_error_string(err).decode())
    return out


def merge_cuda(state, table):
    """Launch one tree level on ``state`` ``(rows_in, T)`` float32 with the
    ``(4, rows_out)`` int32 :func:`merge_table` on the same CUDA device.
    Parent rows at or beyond ``rows_in`` read as zeros.  Returns the
    ``(rows_out, T)`` state, queued on the current stream."""
    global merge_launches
    _check(state, table, 4)
    out = _launch("fdmt_merge_launch", state, table)
    merge_launches += 1
    return out


def merge4_cuda(state, table):
    """Launch the fused last two levels with the ``(8, rows_out)`` int32
    :func:`merge4_table`; otherwise as :func:`merge_cuda`."""
    global merge4_launches
    _check(state, table, 8)
    out = _launch("fdmt_merge4_launch", state, table)
    merge4_launches += 1
    return out


def head_cuda(state, table, params, rows_out):
    """Launch the fused head on ``state`` ``(nchan, T)`` float32 with the
    device int32 :func:`head_table` and the host :func:`head_params`;
    returns the ``(rows_out, T)`` state of the last head level, queued on
    the current stream."""
    global head_launches
    if table.ndim != 1 or table.dtype != torch.int32 \
            or not table.is_contiguous():
        raise ValueError("table must be a contiguous 1-D int32 tensor")
    _check(state, table.view(1, -1), 1)
    rows_valid, nsamples = state.shape
    if len(params) != HEAD_PARAMS_LEN or params[0] != nsamples \
            or params[1] != rows_valid:
        raise ValueError(f"head parameters {params[:2]} do not describe a "
                         f"{tuple(state.shape)} state")
    if rows_valid > params[2] * HEAD_GROUP:
        raise ValueError(f"{rows_valid} rows for {params[2]} head groups")
    lib = _library()
    out = torch.empty((rows_out, nsamples), dtype=torch.float32,
                      device=state.device)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = lib.fdmt_head_launch(
        state.data_ptr(), table.data_ptr(), out.data_ptr(),
        (ctypes.c_int * HEAD_PARAMS_LEN)(*params),
        state.device.index or 0, stream)
    if err != 0:
        raise nvcc.launch_error("fdmt_head_launch",
                                lib.fdmt_merge_error_string(err).decode())
    head_launches += 1
    return out


def _upload(table, device):
    """A host launch table on ``device`` without a host synchronisation:
    copied from page-locked memory, queued on the current stream (a copy
    from pageable memory would wait for the stream, stalling a chain of
    passes between launches)."""
    return torch.from_numpy(table).pin_memory().to(device, non_blocking=True)


def step_work(kind, step, nsamples, rows_in):
    """``((operations, bytes), rows_out)`` of one pass of
    :func:`~.fdmt.transform_schedule` (``kind``, ``step``) on a
    ``(rows_in, nsamples)`` state: the work model of
    :func:`~..obs.roofline.fdmt_pass_work`."""
    if kind == "head":
        rows = step.rows_out
        work = roofline.fdmt_pass_work(int(step.counts.sum()), nsamples,
                                       rows_in, rows,
                                       head_table(step)[0].size)
    elif kind == "merge":
        rows = len(step["idx_low"])
        work = roofline.fdmt_pass_work(rows, nsamples, rows_in, rows,
                                       4 * rows)
    else:
        rows = len(step[0][0])
        work = roofline.fdmt_pass_work(3 * rows, nsamples, rows_in, rows,
                                       8 * rows)
    return work, rows


def transform_work(plan, nsamples):
    """``(operations, bytes)`` of every pass of ``plan``'s transform of a
    ``(plan.nchan, nsamples)`` block, summed."""
    from .fdmt import transform_schedule

    ops = nbytes = 0
    rows = plan.nchan
    for kind, step in transform_schedule(plan):
        (o, b), rows = step_work(kind, step, nsamples, rows)
        ops, nbytes = ops + o, nbytes + b
    return ops, nbytes


def head(state, hp):
    """The fused head (:class:`~.fdmt.HeadPlan` ``hp``) on ``state``: the
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    with roofline.measure(state.device, "fdmt_head_fused_levels",
                          lambda: step_work("head", hp, state.shape[1],
                                            state.shape[0])[0]):
        if state.device.type == "cpu":
            return head_plain(state, hp)
        if state.device.type != "cuda":
            raise ValueError(f"no FDMT merge for device {state.device}")
        table, offsets = head_table(hp)
        params = head_params(hp, offsets, state.shape[1], state.shape[0])
        return head_cuda(state, _upload(table, state.device),
                         params, hp.rows_out)


def merge(state, it):
    """One FDMT level ``it`` (a :class:`~.fdmt.FdmtPlan` iteration) on
    ``state``: the kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    with roofline.measure(state.device, "fdmt_merge_level",
                          lambda: step_work("merge", it, state.shape[1],
                                            state.shape[0])[0]):
        if state.device.type == "cpu":
            return merge_plain(state, it["idx_low"], it["idx_high"],
                               it["shift"], it["shift_high"])
        if state.device.type != "cuda":
            raise ValueError(f"no FDMT merge for device {state.device}")
        return merge_cuda(state, _upload(merge_table(it, state.shape[1]),
                                         state.device))


def merge4(state, idx, shift):
    """The fused last two levels (:func:`~.fdmt.compose_iterations`'s
    ``idx``, ``shift``) on ``state``: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    with roofline.measure(state.device, "fdmt_merge4_last_two_levels",
                          lambda: step_work("merge4", (idx, shift),
                                            state.shape[1],
                                            state.shape[0])[0]):
        if state.device.type == "cpu":
            return merge4_plain(state, idx, shift)
        if state.device.type != "cuda":
            raise ValueError(f"no FDMT merge for device {state.device}")
        return merge4_cuda(state, _upload(merge4_table(idx, shift,
                                                       state.shape[1]),
                                          state.device))
