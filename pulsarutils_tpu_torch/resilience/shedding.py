"""Admission control of the live feed's ready queue.

The chunk assembler (:mod:`..ingest.assembler`) cuts chunks at the
feed's pace and ``stream_search`` takes them at the card's.  When the
feed is faster something must give, and the socket reader must never
block (the kernel's buffers would overflow and the loss would be
silent).  :class:`ShedPolicy` bounds the queue by a depth and byte
budget fixed before the overload; the assembler drops the **oldest**
queued chunk whole (the freshest data matter most for alerts) and
journals it as ``shed_overrun`` with its samples, so the ingest ledger's
``delivered + shed + quarantined == observed`` still holds.
"""

from __future__ import annotations

__all__ = ["ShedPolicy", "resolve_shed_policy"]


class ShedPolicy:
    """Bound the assembler's ready queue by depth and/or host bytes.

    ``max_chunks`` is the hard depth cap; ``max_bytes`` additionally
    shrinks the allowed depth when chunks are large (``max_bytes //
    chunk_nbytes``, floor 1 — a queue that can hold *no* chunk would
    deadlock a healthy feed).  Either may be ``None`` (unbounded on
    that axis); both ``None`` disables shedding entirely.
    """

    def __init__(self, max_chunks=8, max_bytes=None):
        self.max_chunks = None if max_chunks is None else int(max_chunks)
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        if self.max_chunks is not None and self.max_chunks < 1:
            raise ValueError("max_chunks must be >= 1 (or None)")

    def max_queued(self, chunk_nbytes=None):
        """Allowed ready-queue depth for chunks of ``chunk_nbytes``
        host bytes; ``None`` means unbounded."""
        depth = self.max_chunks
        if self.max_bytes is not None and chunk_nbytes:
            by_bytes = max(self.max_bytes // int(chunk_nbytes), 1)
            depth = by_bytes if depth is None else min(depth, by_bytes)
        return depth

    def should_shed(self, queued, chunk_nbytes=None):
        """True when admitting one more chunk over ``queued`` waiting
        ones must first drop the oldest."""
        depth = self.max_queued(chunk_nbytes)
        return depth is not None and int(queued) >= depth

    def to_json(self):
        return {"max_chunks": self.max_chunks,
                "max_bytes": self.max_bytes}


def resolve_shed_policy(policy):
    """Accept the CLI/driver spellings: an int is a depth cap, ``None``
    /``"off"`` disables shedding, a :class:`ShedPolicy` passes
    through."""
    if policy is None or policy == "off":
        return ShedPolicy(max_chunks=None, max_bytes=None)
    if isinstance(policy, ShedPolicy):
        return policy
    return ShedPolicy(max_chunks=int(policy))
