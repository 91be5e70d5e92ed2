"""What the benchmark imports: nothing of JAX or the JAX package anywhere
under portbench/, compared by whole top-level module names (the port's
name begins with the JAX package's), and nothing of the program in the
plain reference and the yardstick."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mafyolo_tpu"}
PROGRAM = "mafyolo_tpu_torch"
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)
# the files that decide what is measured and whether it is correct
YARDSTICK = [p for p in SOURCES if p.parent.name == "reference"
             or p.name in ("yardstick.py", "compare.py", "trace.py")]


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: str(p.relative_to(HERE)))
def test_yardstick_and_reference_import_nothing_of_the_program(path):
    assert PROGRAM not in set(top_level_imports(path))
    assert "importlib" not in set(top_level_imports(path))


def test_whole_name_comparison():
    from portbench import harness
    import sys
    sys.modules.setdefault("mafyolo_tpu_torch_probe", object())
    try:
        assert "mafyolo_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("mafyolo_tpu_torch_probe", None)
    assert "mafyolo_tpu" in harness.FORBIDDEN and "jax" in harness.FORBIDDEN
