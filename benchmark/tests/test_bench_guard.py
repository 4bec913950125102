"""The no-JAX check: whole top-level module names, in the result's process
and in every module of the benchmark."""

import ast
from pathlib import Path

import pytest

from benchmark.harness import guard

BENCH = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("mods, bad", [
    (["pldepth_torch", "pldepth_torch.train.trainer", "torch"], []),
    (["pldepth_tpu_extra", "jaxtyping", "flaxen"], []),
    (["jax.numpy"], ["jax"]),
    (["pldepth_tpu.models"], ["pldepth_tpu"]),
    (["jaxlib", "flax.linen", "numpy"], ["flax", "jaxlib"]),
])
def test_whole_top_level_names(mods, bad):
    assert guard.loaded(mods) == bad


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert guard.loaded(list(_imports(f))) == [], f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").glob("*.py")):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert "pldepth_torch" not in tops, f
