"""The port stands alone: no module of vst_torch, nor chip_smoke.py, imports
jax, flax, the JAX package vst or torchvision (the H100 machine has no
package of finished models), and none imports cv2 or imageio when it is
imported (the H100 machine has neither imageio nor a promise of cv2: the
commands that read or write those formats import them inside). Checked on
the source with ``ast``, since the test process has jax imported already
(tests/conftest.py)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vst", "torchvision"}
NOT_AT_IMPORT = {"cv2", "imageio"}
SOURCES = sorted((ROOT / "vst_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _roots(node):
    if isinstance(node, ast.Import):
        for alias in node.names:
            yield node.lineno, alias.name.split(".")[0]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        yield node.lineno, node.module.split(".")[0]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        yield from _roots(node)


def _module_level_roots(path):
    """Imports that run when the module is imported: outside any function."""
    todo = list(ast.parse(path.read_text(), filename=str(path)).body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield from _roots(node)
        todo.extend(ast.iter_child_nodes(node))


def test_sources_found():
    assert len(SOURCES) > 15 and all(p.exists() for p in SOURCES)


def test_training_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {f"vst_torch/{m}.py" for m in (
        "ops/losses", "perceptual/vgg", "train/faststyle", "train/registry",
        "train/experiments", "data/styles", "data/loader", "data/native_loader",
        "data/device_cache", "core/metrics", "train/parity")} <= names


def test_obst_and_metric_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {f"vst_torch/{m}.py" for m in (
        "ops/lbfgs", "models/gatys", "metrics/__init__", "metrics/inception", "metrics/fid",
        "metrics/lpips", "data/fc2", "eval/fc2", "eval/drivers", "cli/__main__")} <= names


def test_gan_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {f"vst_torch/{m}.py" for m in (
        "train/policy", "models/stargan2", "models/stargan", "train/stargan2", "train/stargan",
        "nn/norm", "convert", "data/device_cache", "data/fc2", "eval/drivers",
        "eval/video")} <= names


def test_cyclegan_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {f"vst_torch/{m}.py" for m in (
        "models/cyclegan", "train/cyclegan", "nn/conv", "data/fc2", "eval/drivers", "convert",
        "train/parity", "cli/__main__")} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_vst_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_cv2_or_imageio_at_import(path):
    bad = [(line, mod) for line, mod in _module_level_roots(path) if mod in NOT_AT_IMPORT]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} at module level"


def test_the_module_level_check_sees_through_classes_and_ifs(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nif os:\n    import cv2\nclass A:\n    import imageio\n"
                   "def f():\n    import cv2\n")
    assert sorted(mod for _, mod in _module_level_roots(src)) == ["cv2", "imageio", "os"]
