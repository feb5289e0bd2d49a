"""Nothing under bench/ imports JAX or the JAX package, and the
reference imports nothing of the port either: top-level module names
compared whole (``repro_torch`` begins with ``repro``)."""

import ast
from pathlib import Path

import _bench_tiny  # noqa: F401  (paths)
import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_and_no_reference_port(path):
    names = set(_imports(path))
    assert not names & NEVER, (path, names & NEVER)
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in names, path


def test_the_walk_sees_the_harness():
    rel = {str(p.relative_to(BENCH)) for p in FILES}
    assert {"run.py", "reference/model.py", "metrics/mfu.py"} <= rel


def test_run_refuses_a_loaded_jax_package():
    from bench import run
    assert run.forbidden_loaded(["repro_torch.serve", "numpy",
                                 "repro_torchx"]) == []
    assert run.forbidden_loaded(["repro.core.ops", "jaxlib.xla",
                                 "flax"]) == ["flax", "jaxlib", "repro"]
