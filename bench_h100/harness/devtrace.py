"""Reading a ``torch.profiler`` Chrome trace: the card's operations, its
busy time, and what the host was doing while the card sat idle."""

from __future__ import annotations

import json

#: trace categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path):
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def device_ops(events):
    """``[(name, start_us, dur_us)]`` of the card's operations."""
    return [(e.get("name", "?"), float(e["ts"]), float(e.get("dur", 0.0)))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def host_spans(events):
    """``[(name, start_us, dur_us)]`` of the host's annotated ranges."""
    return [(e.get("name", "?"), float(e["ts"]), float(e.get("dur", 0.0)))
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def busy_intervals(ops):
    """The union of the operations' intervals, sorted, in microseconds."""
    out = []
    for _, t0, dur in sorted(ops, key=lambda o: o[1]):
        t1 = t0 + dur
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def kernel_seconds(ops):
    """``{name: seconds}`` summed over the operations."""
    out = {}
    for name, _, dur in ops:
        out[name] = out.get(name, 0.0) + dur * 1e-6
    return out


def short(name, limit=120):
    """A kernel's name for the record: no ``void``, at most ``limit``
    characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= limit else name[:limit - 3] + "..."


def idle_by_host(busy, spans):
    """``{label: seconds}`` of the gaps between busy intervals, each gap
    labelled by the innermost host range covering its middle."""
    out = {}
    spans = sorted(spans, key=lambda s: s[1])
    active, j = [], 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        while j < len(spans) and spans[j][1] <= mid:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[1] + s[2] >= mid]
        label = min(active, key=lambda s: s[2])[0] if active \
            else "no annotated host range"
        out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return out


def summarise(path, top=10):
    """``(busy_s, device_seconds_by_name, breakdown)`` of a trace file."""
    events = load(path)
    ops = device_ops(events)
    busy = busy_intervals(ops)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    by_name = kernel_seconds(ops)
    idle = idle_by_host(busy, host_spans(events))
    breakdown = {
        "device_ops": [[short(n), s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(
            idle.items(), key=lambda kv: -kv[1])[:top]],
    }
    return busy_s, by_name, breakdown
