"""putpu-lint for the port: ``python -m pulsarutils_tpu_torch.cli.lint_main``.

The twin of the JAX package's ``putpu-lint`` entry point, over
``pulsarutils_tpu_torch/`` by default (see :mod:`..analysis` for the
checkers and :mod:`..analysis.cli` for the flags).  Exit 0 clean, 1 new
findings, 2 usage errors.
"""

from __future__ import annotations

import sys

from ..analysis.cli import main

__all__ = ["main"]

if __name__ == "__main__":
    sys.exit(main())
