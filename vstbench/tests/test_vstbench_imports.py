"""No file the benchmark runs imports JAX or the JAX package, by whole
top-level names (``vst_torch`` begins with ``vst``), and the references
import nothing of the program."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vst"}


def imported_top_names(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(p for p in PKG.rglob("*.py") if ".cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_jax_package(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")) + sorted(
    (PKG / "counts").glob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "vst_torch" not in imported_top_names(path)


def test_the_check_compares_whole_names():
    src = PKG / "tests" / "_probe_names.py"
    try:
        src.write_text("import vst_torch.eval\nfrom vstx import y\nimport jaxfoo\n")
        names = imported_top_names(src)
    finally:
        src.unlink()
    assert names == {"vst_torch", "vstx", "jaxfoo"} and not names & FORBIDDEN


def test_run_refuses_loaded_jax_modules(monkeypatch):
    import sys
    import types

    from vstbench import run

    monkeypatch.setitem(sys.modules, "vst_torch.fake", types.ModuleType("vst_torch.fake"))
    assert "vst" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vst.models", types.ModuleType("vst.models"))
    assert "vst" in run.forbidden_modules()
