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

The top level exports the JAX package's public names: the reference's
library surface eagerly, the pipeline, I/O and accounting layers lazily
(:data:`_LAZY`), the multi-device searches, the streaming search and
the time-sharded ring sweep among them.
"""

from .version import __version__

from .models.simulate import simulate_pulsar_data, simulate_test_data
from .ops.clean_ops import (
    fft_zap_time,
    get_noisier_channels,
    measure_channel_variability,
    renormalize_data,
    zero_dm_filter,
)
from .ops.dedisperse import apply_dm_shifts_to_data, dedisperse, roll_and_sum
from .ops.periodicity import (
    epoch_folding_search,
    fold,
    harmonic_sum,
    period_search_plane,
    power_spectrum,
    spectral_search,
)
from .ops.plan import (
    DM_DELAY_CONST,
    DM_SMEARING_CONST,
    dedispersion_plan,
    dedispersion_shifts,
    dedispersion_shifts_batch,
    delta_delay,
    dm_broadening,
    normalize_shifts,
)
from .ops.rebin import quick_chan_rebin, quick_resample
from .ops.robust import digitize, h_test, mad, ref_mad, z_n_test
from .ops.search import dedispersion_search
from .pipeline.search_pipeline import plan_survey, search_by_chunks
from .utils.table import ResultTable


def test(extra_args=None):
    """Run the port's tests (``tests/test_torch_*.py``) and return the
    pytest exit code.

    Runs pytest in a fresh subprocess from the source checkout root, as
    the JAX package's ``test()`` runs its suite; the tests import both
    packages.  ``extra_args`` is a string (``"-k search"``) or an
    iterable of pytest arguments.  Needs a source checkout.
    """
    import glob
    import os
    import shlex
    import subprocess
    import sys

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = sorted(glob.glob(os.path.join(repo_root, "tests",
                                          "test_torch_*.py")))
    if not files:
        raise RuntimeError(
            "pulsarutils_tpu_torch.test() needs a source checkout (no "
            f"tests/test_torch_*.py under {repo_root})")
    if isinstance(extra_args, str):
        extra = shlex.split(extra_args)
    else:
        extra = list(extra_args) if extra_args else []
    proc = subprocess.run([sys.executable, "-m", "pytest", *files, "-q"]
                          + extra, cwd=repo_root)
    return int(proc.returncode)


#: lazy re-exports of the pipeline, I/O and accounting layers (keeps a
#: bare ``import pulsarutils_tpu_torch`` light): the JAX package's table
_LAZY = {
    "cleanup_data": ("pipeline.cleanup", "cleanup_data"),
    "get_bad_chans": ("pipeline.spectral_stats", "get_bad_chans"),
    "get_spectral_stats": ("pipeline.spectral_stats",
                           "get_spectral_stats"),
    "PulseInfo": ("pipeline.pulse_info", "PulseInfo"),
    "plot_diagnostics": ("pipeline.diagnostics", "plot_diagnostics"),
    "sift_hits": ("pipeline.sift", "sift_hits"),
    "sift_candidates": ("pipeline.sift", "sift_candidates"),
    "FilterbankReader": ("io.sigproc", "FilterbankReader"),
    "FilterbankWriter": ("io.sigproc", "FilterbankWriter"),
    "write_filterbank": ("io.sigproc", "write_filterbank"),
    "CandidateStore": ("io.candidates", "CandidateStore"),
    "fdmt_transform": ("ops.fdmt", "fdmt_transform"),
    "fdmt_trial_dms": ("ops.fdmt", "fdmt_trial_dms"),
    "fdmt_tracks": ("ops.fdmt", "fdmt_tracks"),
    "cert_retention": ("ops.certify", "cert_retention"),
    "coarse_retention": ("ops.certify", "coarse_retention"),
    "retention_bound": ("ops.certify", "retention_bound"),
    "certify_noise_only": ("ops.certify", "certify_noise_only"),
    "certifiable_snr_floor": ("ops.certify", "certifiable_snr_floor"),
    "matched_snr_floor": ("ops.certify", "matched_snr_floor"),
    "expected_noise_max_snr": ("ops.certify", "expected_noise_max_snr"),
    "cert_slack_for_miss_p": ("ops.certify", "cert_slack_for_miss_p"),
    "cert_miss_p_at_floor": ("ops.certify", "cert_miss_p_at_floor"),
    "plane_memmap": ("ops.search", "plane_memmap"),
    "BudgetAccountant": ("utils.logging_utils", "BudgetAccountant"),
    "measure_device_rtt": ("utils.logging_utils", "measure_device_rtt"),
    "FaultPlan": ("faults.inject", "FaultPlan"),
    "FaultSpec": ("faults.inject", "FaultSpec"),
    "IntegrityPolicy": ("faults.policy", "IntegrityPolicy"),
    "audit_run": ("faults.audit", "audit_run"),
    "sharded_dedispersion_search": ("parallel.sharded",
                                    "sharded_dedispersion_search"),
    "sharded_fdmt_search": ("parallel.sharded_fdmt", "sharded_fdmt_search"),
    "sharded_hybrid_search": ("parallel.sharded_fdmt",
                              "sharded_hybrid_search"),
    "make_mesh": ("parallel.mesh", "make_mesh"),
    "ShardedPlane": ("parallel.sharded_plane", "ShardedPlane"),
    "initialize_distributed": ("parallel.multihost", "initialize"),
    "pod_mesh": ("parallel.multihost", "pod_mesh"),
    "ring_dedisperse": ("parallel.stream", "ring_dedisperse"),
}

#: the JAX package's top-level names the port does not have yet, with the
#: ROADMAP.md item that holds each (none since the ring sweep, A6)
_NOT_PORTED = {}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(f".{module}", __name__), attr)
    if name in _NOT_PORTED:
        raise AttributeError(f"{name} is not ported yet: ROADMAP.md "
                             f"{_NOT_PORTED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "__version__",
    "DM_DELAY_CONST",
    "DM_SMEARING_CONST",
    "dedispersion_shifts",
    "dedispersion_shifts_batch",
    "delta_delay",
    "dedispersion_plan",
    "dm_broadening",
    "normalize_shifts",
    "quick_chan_rebin",
    "quick_resample",
    "mad",
    "ref_mad",
    "h_test",
    "z_n_test",
    "digitize",
    "renormalize_data",
    "get_noisier_channels",
    "measure_channel_variability",
    "fft_zap_time",
    "zero_dm_filter",
    "dedisperse",
    "roll_and_sum",
    "apply_dm_shifts_to_data",
    "dedispersion_search",
    "power_spectrum",
    "harmonic_sum",
    "spectral_search",
    "fold",
    "epoch_folding_search",
    "period_search_plane",
    "simulate_test_data",
    "simulate_pulsar_data",
    "ResultTable",
    "plan_survey",
    "search_by_chunks",
] + list(_LAZY)
