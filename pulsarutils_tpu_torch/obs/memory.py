"""Device-memory accounting: per-chunk watermarks and headroom.

The port of the JAX package's module, read from PyTorch's caching
allocator on the card: ``torch.cuda.memory_allocated`` (bytes in live
tensors), ``torch.cuda.max_memory_allocated`` (their peak since the last
reset) and the card's total memory as the limit.  :func:`record_watermark`
is called once a chunk by the chunk loop; the gauges it keeps
(``putpu_device_bytes_in_use``, ``putpu_device_bytes_peak``,
``putpu_device_bytes_limit``, ``putpu_device_headroom_bytes``) make the
headroom a tracked series.  A CPU device has no such allocator: nothing
is recorded.
"""

from __future__ import annotations

from . import metrics

__all__ = ["device_memory_snapshot", "record_watermark"]


def device_memory_snapshot(device=None):
    """``{"source", "bytes_in_use", "peak_bytes_in_use", "bytes_limit"}``
    of a CUDA ``device`` (the current card by default), or ``None`` for a
    CPU device or without a card."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    dev = torch.device(device if device is not None else "cuda")
    return {"source": "torch.cuda",
            "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
            "bytes_limit": int(
                torch.cuda.get_device_properties(dev).total_memory)}


def record_watermark(device=None):
    """Snapshot the card's memory into the registry gauges; returns the
    snapshot (or ``None``).  ``putpu_device_bytes_peak`` keeps the most
    seen in this process; the headroom is the limit less the bytes in
    use."""
    snap = device_memory_snapshot(device)
    if snap is None:
        return None
    in_use = snap["bytes_in_use"]
    metrics.gauge("putpu_device_bytes_in_use").set(in_use)
    metrics.gauge("putpu_device_bytes_peak").set_max(
        snap["peak_bytes_in_use"])
    metrics.gauge("putpu_device_bytes_limit").set(snap["bytes_limit"])
    metrics.gauge("putpu_device_headroom_bytes").set(
        snap["bytes_limit"] - in_use)
    return snap
