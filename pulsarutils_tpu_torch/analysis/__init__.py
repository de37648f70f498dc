"""putpu-lint for the port: project-specific static analysis over ``ast``.

The JAX package's checker framework, pointed at
``pulsarutils_tpu_torch/`` (:data:`~.core.PACKAGE_NAME`), with the
device-code checkers translated to torch spellings:

=====================  =====================================================
``device-trip``        device readbacks in ``ops/``, ``parallel/`` and
                       ``tuning/`` (``.item()``, ``.cpu()``, ``.tolist()``,
                       ``np.asarray(<tensor>)``, ``torch.cuda.synchronize()``)
                       happen inside budget buckets or sanctioned seams
``lock-discipline``    classes owning ``self._lock`` mutate shared state
                       only under it
``metric-name-*``      every ``putpu_*`` literal resolves against the
                       ``obs/names.py`` manifest (``METRIC_NAMES`` and
                       ``PORT_METRIC_NAMES``), and the manifest covers
                       ``README.md`` and the committed gate baseline
``broad-except``       broad handlers only in the reviewed containment-seam
                       allowlist
``float64-leak``       no ``torch.float64`` in device code
``bf16-cast``          half precision only through the precision seam
``atomic-write``       state files written through ``io/atomic.py``
``quarantine-reason``  reason vocabulary against ``README.md``'s table
``span-leak``          every ``begin_span()`` handle ends on every path
=====================  =====================================================

The JAX package's ``retrace`` checker (``shard_map`` routing, ``jax.jit``
built in a loop, unhashable static arguments) has no torch counterpart:
the port traces no programs, so it is left out.

Stdlib only: the linter imports neither torch nor the package it scans.
Run it as ``python -m pulsarutils_tpu_torch.cli.lint_main``; the
committed baseline is ``.putpu-torch-lint-baseline.json``.
"""

from .baseline import load as load_baseline
from .baseline import save as save_baseline
from .core import (Finding, FileContext, LintProject, all_finding_ids,
                   lint_paths, lint_source, register,
                   registered_checkers)
from .cli import main as cli_main
from .cli import run_lint

__all__ = [
    "Finding",
    "FileContext",
    "LintProject",
    "all_finding_ids",
    "cli_main",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "register",
    "registered_checkers",
    "run_lint",
    "save_baseline",
]
