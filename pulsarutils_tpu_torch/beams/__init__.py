"""Multi-beam surveys: N same-geometry chunks searched as one batch.

* :mod:`.batcher`: :class:`~.batcher.BeamBatcher`, the batch (the
  per-beam body once a beam, each beam in one reused device slot, one
  readback of the stacked scores), each beam's table bit for bit its
  sequential one;
* :mod:`.multibeam`: :func:`~.multibeam.multibeam_search`, the
  N-filterbank driver (per-beam resume ledgers and canaries, the
  coincidence sift at the end), and ``python -m
  pulsarutils_tpu_torch.cli.beams_main``;
* :mod:`.coincidence`: the cross-beam anti-coincidence sift (a pulse at
  one (DM, time) in all or most beams is RFI, in 1-2 adjacent beams a
  detection).

The JAX package's job service (``beams/service.py``, ``SurveyService``)
belongs to ROADMAP.md queue A, A10; importing
:mod:`.service` raises until then.
"""

from .batcher import BeamBatcher, BeamGeometryError
from .coincidence import coincidence_sift
from .multibeam import multibeam_search

__all__ = ["BeamBatcher", "BeamGeometryError", "coincidence_sift",
           "multibeam_search"]
