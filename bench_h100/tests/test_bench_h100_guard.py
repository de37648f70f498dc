"""Neither the benchmark nor its reference imports JAX or the JAX
package; the reference imports nothing of the port."""

import glob
import os

import pytest

from bench_h100.harness import cells, guard


def test_whole_top_level_names_are_compared():
    assert guard.forbidden_imports("import jax\n") == ["jax"]
    assert guard.forbidden_imports("import jax.numpy as jnp\n") == ["jax"]
    assert guard.forbidden_imports(
        "from pulsarutils_tpu.ops import plan\n") == ["pulsarutils_tpu"]
    assert guard.forbidden_imports(
        "import pulsarutils_tpu_torch\n"
        "from pulsarutils_tpu_torch.ops import plan\n") == []
    assert guard.loaded_forbidden({"pulsarutils_tpu_torch.ops": 1,
                                   "jaxtyping": 1}) == []
    assert guard.loaded_forbidden({"jaxlib.xla_client": 1,
                                   "flax": 1}) == ["flax", "jaxlib"]


SOURCES = sorted(glob.glob(os.path.join(cells.BENCH_DIR, "**", "*.py"),
                           recursive=True))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, cells.BENCH_DIR)
                              for p in SOURCES])
def test_no_source_imports_jax(path):
    with open(path) as f:
        assert guard.forbidden_imports(f.read()) == [], path


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    cells.BENCH_DIR, "reference", "*.py"))))
def test_reference_imports_nothing_of_the_port(path):
    with open(path) as f:
        assert "pulsarutils_tpu_torch" not in guard.imported_names(f.read())
