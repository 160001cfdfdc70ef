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

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "CudaKernel", "build_library", "device_and_stream"]

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


class CudaKernel:
    """A library of `csrc/` with one launch function, its build record and
    its launch count.

    A subclass names the library (`name`), its sources (headers included,
    so that a changed header rebuilds), the C launch
    function (`entry`, returning a cudaError_t as int) and its ctypes
    argument types, and the function that names an error code. `launch`
    calls the entry point, raises if it returns an error, and otherwise
    counts one launch.
    """

    name: str
    sources: tuple[str, ...]
    entry: str
    argtypes: tuple
    error_fn: str

    def __init__(self):
        self._lib = None
        self.build_info: dict | None = None
        self.launches = 0

    @property
    def source(self) -> str:
        """Repository path of the kernel's first source file."""
        return f"{CSRC_DIR.parent.name}/{CSRC_DIR.name}/{self.sources[0]}"

    def load(self) -> dict:
        """Build (if needed) and load the library; returns the build record."""
        if self._lib is None:
            lib, info = build_library(self.name, list(self.sources))
            fn = getattr(lib, self.entry)
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            err = getattr(lib, self.error_fn)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self.build_info = lib, info
        return self.build_info

    def launch(self, *args) -> None:
        self.load()
        err = getattr(self._lib, self.entry)(*args)
        if err != 0:
            msg = getattr(self._lib, self.error_fn)(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg}")
        self.launches += 1


def build_library(name: str, sources: list[str]) -> tuple[ctypes.CDLL, dict]:
    """Compile `csrc/<sources>` into one shared library and load it.

    Headers (`.cuh`) among the sources are hashed with them, not compiled.
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
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(p) for p in paths if p.suffix == ".cu")]
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


def device_and_stream(device) -> tuple[int, int]:
    """(CUDA device index, PyTorch's current stream on it as an int) for a launch."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream
