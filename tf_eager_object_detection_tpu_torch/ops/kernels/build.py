"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each library is compiled from `csrc/` into `build/kernels/` at the root of
the checkout (or into `$TF_EAGER_OD_TORCH_BUILD_DIR` when set), on first use, under a name keyed by a hash of its sources and
flags: a changed source rebuilds, an unchanged one loads what is there.
Sources have a plain C interface and include no PyTorch header, so a build
takes seconds. Nothing here runs at import time.
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

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build_library"]

_PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = Path(
    os.environ.get("TF_EAGER_OD_TORCH_BUILD_DIR") or _PACKAGE_DIR.parent / "build" / "kernels"
)

# -fmad=false: no multiply-add contraction, so float results round exactly
# like the plain PyTorch versions; --use_fast_math is never passed.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH); the CUDA "
            "kernels of this package are built on a machine with the CUDA toolkit"
        )
    return found


def build_library(name: str, sources: list[str]) -> tuple[ctypes.CDLL, dict]:
    """Compile `csrc/<sources>` into one shared library and load it.

    Returns (library, info) where info has the library path, whether it was
    built in this call, the build seconds and the compiler's output
    (ptxas register and shared-memory report).
    """
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    lib_path = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    info = {"path": str(lib_path), "built": False, "seconds": 0.0, "log": ""}
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{info['log']}")
        os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
        info["built"] = True
    return ctypes.CDLL(str(lib_path)), info
