"""The live feed: sockets -> packets -> search chunks.

The loss-tolerant front end between a packetised feed and
:func:`~..parallel.stream.stream_search`, the JAX package's ``ingest``
on host threads and sockets:

* :mod:`~..io.packets` (in ``io/``): the versioned wire format; a 1/2/4-bit
  payload reaches the search as :class:`~..io.lowbit.PackedFrames`,
  unpacked on the card;
* :mod:`.source`: TCP and UDP sources with bounded reconnects, an idle
  timeout and a clean drain, and the local feeders;
* :mod:`.assembler`: the ring buffer (bounded reordering, zero-filled
  gaps accounted as ``feed_gap``, drop-oldest shedding as
  ``shed_overrun``) and the :class:`~.assembler.IngestLedger` with no
  unaccounted sample.

Quickstart::

    asm = ChunkAssembler(nchan=64, step=8192)
    with TCPSource(asm, port=9000):
        results, hits = stream_search(asm.chunks(), ...)

or ``python -m pulsarutils_tpu_torch.cli.ingest_main listen|feed``.
"""

from .assembler import ChunkAssembler, IngestLedger  # noqa: F401
from .source import (  # noqa: F401
    TCPSource,
    UDPSource,
    feed_file,
    feed_packets,
    feed_tcp,
    feed_udp,
)

__all__ = ["ChunkAssembler", "IngestLedger", "TCPSource", "UDPSource",
           "feed_packets", "feed_tcp", "feed_udp", "feed_file"]
