"""Page-locked double buffering of a chunk's raw frames.

The chunk loop reads chunk ``k + 1`` on a reader thread while the card
searches chunk ``k``.  :class:`FrameStaging` holds two host buffers for
the raw frames (page-locked on a CUDA run, so the copy to the card is a
DMA that needs no staging copy and overlaps the search):

* the **reader thread** fills a buffer with a plain copy into its numpy
  view (:meth:`~..io.sigproc.FilterbankReader.read_frames_into`) and
  makes no CUDA call;
* the **main thread** starts the copy to the card on a side stream with
  ``non_blocking=True`` and records an event (:meth:`FrameStaging.upload`);
  the chunk's first use on the main stream waits on that event
  (:meth:`FrameStaging.wait`), and the device frames are marked used on
  that stream (``record_stream``), so the caching allocator cannot hand
  their memory out again before the main stream is done with them;
* chunk ``k`` of the loop goes into buffer ``k % 2``, which is handed to
  the reader only after its last copy's event has completed
  (:meth:`FrameStaging.acquire`, on the main thread): refilling it
  earlier would corrupt the chunk in flight.

On a CPU run the buffers are ordinary memory, the "upload" is a copy and
there are no streams or events.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Upload:
    """A started host-to-device copy: the device ``frames`` and the event
    recorded after the copy on the side stream (None on the CPU)."""

    frames: torch.Tensor
    event: object = None


class FrameStaging:
    """Two host buffers of ``shape`` ``(samples, values per frame)`` in
    numpy ``dtype``, page-locked when ``device`` is a CUDA device."""

    def __init__(self, shape, dtype, device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        tdtype = torch.from_numpy(np.empty(0, dtype=dtype)).dtype
        self._host = [torch.empty(shape, dtype=tdtype, pin_memory=cuda)
                      for _ in range(2)]
        #: numpy views of the buffers, for the reader thread
        self.views = [h.numpy() for h in self._host]
        self._events = [None, None]
        self.stream = torch.cuda.Stream(self.device) if cuda else None

    def acquire(self, slot):
        """The numpy view of ``slot`` for the reader thread, once the
        slot's last upload has landed (main thread)."""
        event = self._events[slot]
        if event is not None:
            event.synchronize()
            self._events[slot] = None
        return self.views[slot]

    def upload(self, slot, nrows):
        """Start copying the first ``nrows`` rows of ``slot`` to the device
        (main thread); returns the :class:`Upload`."""
        host = self._host[slot][:nrows]
        if self.stream is None:
            return Upload(host.clone())
        with torch.cuda.stream(self.stream):
            frames = torch.empty(host.shape, dtype=host.dtype,
                                 device=self.device)
            frames.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._events[slot] = event
        return Upload(frames, event)

    def wait(self, upload):
        """The device frames of ``upload``, ordered after the copy on the
        current stream (main thread).  They are handed over: ``upload``
        holds them no longer, so they are freed with the caller's last
        reference."""
        frames, upload.frames = upload.frames, None
        if upload.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(upload.event)
            frames.record_stream(stream)
        return frames
