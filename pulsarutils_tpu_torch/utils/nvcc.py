"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C interface,
compiled for Hopper (``sm_90a``) at first use into ``_build/`` beside
this package, under a name keyed by a hash of the sources and flags: a
changed source builds anew, an unchanged one loads from the cache.
Nothing is built when a module is imported.

A source that does not build, a library that does not load, a library
whose compiled geometry differs from its wrapper's, and a launch the card
refuses all raise :class:`KernelBuildError`: the chunk loop re-raises it
as a configuration error, without a retry.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded = {}

#: kernel libraries built or loaded for the first time in this process,
#: and their seconds: the budget accountant's compile counter
#: (:func:`..utils.logging_utils.compile_snapshot`)
COMPILES = {"count": 0, "secs": 0.0}
COMPILES_LOCK = threading.Lock()

class KernelBuildError(RuntimeError):
    """A kernel could not be built, loaded or launched (no code for the
    card's architecture, too many resources, an invalid configuration, a
    cluster that does not fit): deterministic, so never retried."""


def launch_error(what, message):
    """The :class:`KernelBuildError` for a failed launch of ``what`` with
    the CUDA error string ``message``."""
    return KernelBuildError(f"{what} launch failed: {message}")


def nvcc_path():
    """The ``nvcc`` of ``$CUDA_HOME``, else of ``PATH``, else of the
    toolkit's default install prefix."""
    candidates = [Path(os.environ[k]) / "bin" / "nvcc"
                  for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise KernelBuildError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name):
    """Cache path of ``csrc/<name>.cu``'s library for the current sources."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names):
    """Compile every ``csrc/<name>.cu`` not yet cached, all at once.

    Returns ``{name: (library path, build seconds, compiler output)}``;
    a cached library reports 0 seconds.  Raises :class:`KernelBuildError`
    if any compile fails.
    """
    results = {}
    running = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            results[name] = (out, 0.0, "cached")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True),
                         time.perf_counter(), tmp, out)
    failed = []
    for name, (proc, t0, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = (out, time.perf_counter() - t0, log)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return results


def load(name):
    """The ctypes handle of ``csrc/<name>.cu``'s library, built if needed."""
    if name not in _loaded:
        t0 = time.perf_counter()
        path, _, _ = build([name])[name]
        try:
            _loaded[name] = ctypes.CDLL(str(path))
        except OSError as exc:
            raise KernelBuildError(f"cannot load {path}: {exc}") from exc
        with COMPILES_LOCK:
            COMPILES["count"] += 1
            COMPILES["secs"] += time.perf_counter() - t0
    return _loaded[name]
