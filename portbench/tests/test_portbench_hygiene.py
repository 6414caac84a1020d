"""Nothing the benchmark runs imports JAX, flax or the JAX package (top-
level names compared whole), nor the root's measuring files; the
reference imports nothing of the measured program."""
import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "usot_tpu"}
SOURCES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_anywhere(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert not tops & FORBIDDEN
    assert not {n for n in imported(path)
                if n.startswith("usot_tpu_torch.tools")}, \
        "the yardstick copies the port's tools, it does not import them"
    text = path.read_text()
    for name in ("BENCH_r0", "PERF_NOTES", "tools/bench"):
        assert name not in text


# the mining reference's connected components are SciPy's, as USOT's
# flow_utils takes them from a library (skimage)
LIBRARIES = {"mining.py": {"scipy"}}


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert tops <= {"__future__", "contextlib", "math", "numpy", "torch",
                    "portbench", *LIBRARIES.get(path.name, ())}
    assert all(n.startswith("portbench.reference") for n in imported(path)
               if n.startswith("portbench"))


def test_forbidden_module_check_compares_whole_names(monkeypatch):
    import sys

    from portbench import harness

    monkeypatch.setitem(sys.modules, "usot_tpu_torch_like", sys)
    assert "usot_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax" in harness.forbidden_modules()
