"""Survey-scale periodicity search (the port of the JAX package's
``periodicity`` package).

* :mod:`.accumulate` — chunk planes from ``search_by_chunks``'s
  ``plane_consumer`` seam folded into one rebinned full-observation
  DM–time plane;
* :mod:`.accel` — acceleration (and jerk) trials by time-domain
  resampling, each scored by the spectral search;
* :mod:`.fdas` — the same trials in the Fourier domain: one rfft per DM
  row and a z/w-response correlation per trial;
* :mod:`.candidates` — zap list, DM grouping, harmonic sift, folding of
  the survivors, the candidate npz;
* :mod:`.driver` — the job: accumulate -> trial search -> sift -> fold
  -> persist, resumable through the chunk ledger and the accumulator's
  snapshot.
"""

from .accel import accel_grid, accel_search, fractional_resample  # noqa: F401
from .accumulate import DMTimeAccumulator, choose_rebin  # noqa: F401
from .candidates import (ZapList, fold_candidates,  # noqa: F401
                         sift_candidates)
from .driver import periodicity_search  # noqa: F401
from .fdas import fdas_search  # noqa: F401
