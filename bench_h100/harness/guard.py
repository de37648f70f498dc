"""What may not be loaded: JAX and the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "pulsarutils_tpu")


def loaded_forbidden(modules=None):
    """Top-level names in ``modules`` (``sys.modules``) that are
    forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in modules}
                  & set(FORBIDDEN))


def imported_names(source):
    """Top-level module names a Python ``source`` imports."""
    out = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            out.add(node.module.split(".")[0])
    return out


def forbidden_imports(source, forbidden=FORBIDDEN):
    return sorted(imported_names(source) & set(forbidden))
