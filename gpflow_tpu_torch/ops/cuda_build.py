"""Builds and loads the package's hand-written CUDA kernels.

Each kernel library is compiled with ``nvcc`` from the sources under
``gpflow_tpu_torch/csrc/`` into a shared library with a plain C interface and
loaded with ``ctypes``. The build runs on first use, never at import, into
``gpflow_tpu_torch/_build/`` (listed in ``.gitignore``), and is keyed on a
hash of the sources, the shared headers (``csrc/*.cuh``) and the compiler
flags: a checkout builds its own libraries and reuses them until a source
changes. Libraries may be built from several threads at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "find_nvcc", "load_library"]

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}  # name -> seconds the last build took (0 if cached)


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the toolkit's
    default location; None where none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    return None


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Returns the loaded library ``name`` built from ``sources`` (file names
    under ``csrc/``), compiling it first where no build for these exact
    sources exists. Raises RuntimeError, with nvcc's output, if nvcc is
    missing or the build fails."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    target = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    build_seconds[name] = 0.0
    if not target.exists():
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                f"cannot build CUDA kernel library {name!r}: nvcc not found "
                "(looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin)"
            )
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed to build {name!r} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, target)  # atomic: a concurrent builder sees all or nothing
    lib = ctypes.CDLL(str(target))
    _loaded[name] = lib
    return lib
