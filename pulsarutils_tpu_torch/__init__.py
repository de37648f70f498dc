"""pulsarutils_tpu_torch — the PyTorch/CUDA port of ``pulsarutils_tpu``.

A search for dispersed single pulses (FRBs, pulsar giant pulses) in
SIGPROC filterbank data, running on an NVIDIA GPU: the JAX package's
default ``PUsearchfrb`` path (read, flag bad channels, clean on the
device, exact direct dedispersion sweep through a hand-written CUDA
kernel, boxcar scoring, candidates and a resume ledger).  The JAX
package stays the reference the port is tested against; this package
imports nothing from it.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``), and raise when no card is present.
"""

from .ops.plan import dedispersion_plan, dedispersion_shifts_batch
from .ops.search import dedispersion_search
from .pipeline.search_pipeline import plan_survey, search_by_chunks
from .utils.table import ResultTable

__all__ = ["ResultTable", "dedispersion_plan", "dedispersion_search",
           "dedispersion_shifts_batch", "plan_survey", "search_by_chunks"]
