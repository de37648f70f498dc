"""pulsarutils_tpu_torch — the PyTorch/CUDA port of ``pulsarutils_tpu``.

A search for dispersed single pulses (FRBs, pulsar giant pulses) in
SIGPROC filterbank data, running on an NVIDIA GPU: the JAX package's
``PUsearchfrb`` path (read, flag bad channels, clean on the device,
search, boxcar scoring, candidates and a resume ledger) with the exact
direct dedispersion sweep, the hybrid search (an FDMT coarse sweep, the
noise certificate and an exact rescore) or the Fourier-domain
dedispersion, the per-chunk period search, and the survey-scale
periodicity job (``PUperiod``), each device kernel hand-written in
CUDA.  The JAX package stays the reference the port is tested against;
this package imports nothing from it.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``), and raise when no card is present.
"""

from .ops.plan import dedispersion_plan, dedispersion_shifts_batch
from .ops.search import dedispersion_search
from .pipeline.search_pipeline import plan_survey, search_by_chunks
from .utils.table import ResultTable

__all__ = ["ResultTable", "dedispersion_plan", "dedispersion_search",
           "dedispersion_shifts_batch", "plan_survey", "search_by_chunks"]
