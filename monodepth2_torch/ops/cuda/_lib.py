"""Build and bind the hand-written CUDA kernels (grid_sample.cu).

The source compiles with plain ``nvcc`` into a shared library with a C
interface, loaded through ``ctypes``: no PyTorch headers, no
``torch.utils.cpp_extension``, no ninja, no lock file. The build happens at
first use, into ``_build/`` beside this file, under a name keyed by the
sha256 of the source and the flags; it is written to a temporary name and
moved into place with ``os.replace``, so a cut build leaves nothing that a
later one would trust.

Nothing here runs at import: the CPU tests import this module on machines
with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).with_name("grid_sample.cu")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)
NVCC_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build grid_sample.cu")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"grid_sample-{digest[:16]}.so"


def build() -> Path:
    """Compile grid_sample.cu unless a library for this source and these flags
    already exists. Raises RuntimeError with nvcc's stderr if it fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f".{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
    return target


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.grid_sample_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
            lib.grid_sample_fwd.restype = i32
            lib.grid_sample_bwd_uv.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
            lib.grid_sample_bwd_uv.restype = i32
            lib.grid_sample_error_string.argtypes = [i32]
            lib.grid_sample_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.grid_sample_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
