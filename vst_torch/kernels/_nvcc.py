"""Build the CUDA sources of ``vst_torch/csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``vst_torch/_build/lib<name>_<tag>.so`` (listed in
``.gitignore``), where ``tag`` hashes the source, the shared headers
``csrc/*.cuh`` and the flags: an edited source or header builds anew, an
unchanged one is loaded as it is. ``build_many``
starts one ``nvcc`` per missing library, all at once, and waits for them;
``load`` builds what is missing, loads the library and declares its entry
points, each returning a ``cudaError_t``. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the vst_torch kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built, tagged by its source, every shared
    header ``csrc/*.cuh`` (a source may include any of them) and the flags."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build_many(names: Iterable[str]) -> Dict[str, str]:
    """Build every library of ``names`` that is not built yet, one ``nvcc``
    each, all started together. Returns nvcc's report (registers, spills)
    per name built here; a name already built maps to an empty string."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs: Dict[str, Tuple[subprocess.Popen, str, Path]] = {}
    logs: Dict[str, str] = {}
    try:
        for name in names:
            so = library_path(name)
            if so.exists():
                logs[name] = ""
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs[name] = (proc, tmp, so)
        failed = []
        for name, (proc, tmp, so) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{out}")
                continue
            os.replace(tmp, so)
            logs[name] = out
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return logs


def load(name: str, entry_points: Dict[str, Sequence]) -> Tuple[ctypes.CDLL, str]:
    """The library of ``csrc/<name>.cu``, built first if needed, with each
    function of ``entry_points`` given its ctypes argument types and an int
    result. Returns (library, nvcc's report from a build made by this call,
    else "")."""
    if name in _libs:
        return _libs[name], ""
    log = build_many([name])[name]
    lib = ctypes.CDLL(str(library_path(name)))
    for fn_name, argtypes in entry_points.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _libs[name] = lib
    return lib, log


def check_aligned(*tensors) -> None:
    """The kernels read and write 16-byte vectors: raise on a tensor whose
    data does not start on a 16-byte boundary (a view at an odd offset)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned tensors; pass a fresh copy")
