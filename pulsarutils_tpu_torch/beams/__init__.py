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
  detection);
* :mod:`.service`: :class:`~.service.SurveyService`, the job queue
  behind the ``/jobs`` HTTP API (:mod:`..obs.server`), which co-batches
  same-geometry jobs as the beams of one batched run.
"""

from .batcher import BeamBatcher, BeamGeometryError
from .coincidence import coincidence_sift
from .multibeam import multibeam_search
from .service import SurveyService

__all__ = ["BeamBatcher", "BeamGeometryError", "coincidence_sift",
           "multibeam_search", "SurveyService"]
