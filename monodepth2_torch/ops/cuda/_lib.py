"""Build and bind the hand-written CUDA kernels (grid_sample.cu).

The source compiles with plain ``nvcc`` into a shared library with a C
interface, loaded through ``ctypes``: no PyTorch headers, no
``torch.utils.cpp_extension``, no ninja, no lock file. The build happens at
first use, into ``_build/`` beside this file, under a name keyed by the
sha256 of the source and the flags; it is written to a temporary name and
moved into place with ``os.replace``, so a cut build leaves nothing that a
later one would trust. The build passes `-Xptxas -v` and keeps what ptxas
says (each kernel's registers, shared memory and spills) beside the library;
`ptxas_report` reads it.

Nothing here runs at import: the CPU tests import this module on machines
with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
    "-Xptxas",
    "-v",
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


def library_path(source: Path = SOURCE) -> Path:
    """Where the library for `source` and the flags lives."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def _ptxas_log(target: Path) -> Path:
    return target.with_suffix(".ptxas.txt")


def build(source: Path = SOURCE) -> Path:
    """Compile `source` (grid_sample.cu by default) unless a library for this
    source and these flags already exists. Raises RuntimeError with nvcc's
    stderr if it fails."""
    target = library_path(source)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f".{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        _ptxas_log(target).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
    return target


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_KERNEL = re.compile(r"(grid_sample_(?:fwd|bwd_uv|bwd_img)_kernel)(?:ILi(\d+)EE)?")
_NUMBERS = {
    "registers": re.compile(r"Used (\d+) registers"),
    "smem_bytes": re.compile(r"(\d+) bytes smem"),
    "stack_bytes": re.compile(r"(\d+) bytes stack frame"),
    "spill_store_bytes": re.compile(r"(\d+) bytes spill stores"),
    "spill_load_bytes": re.compile(r"(\d+) bytes spill loads"),
}


def ptxas_report(text: str | None = None, source: Path = SOURCE) -> dict:
    """{kernel: {registers, smem_bytes, stack_bytes, spill_store_bytes,
    spill_load_bytes}} from ptxas's -v output (by default the one kept
    beside the library built from `source`). A template instance is named
    with its C, e.g. "grid_sample_fwd_kernel<1>"; a number ptxas did not
    print is 0."""
    if text is None:
        text = _ptxas_log(library_path(source)).read_text()
    report, name = {}, None
    for line in text.splitlines():
        entry = _ENTRY.search(line)
        if entry:
            kernel = _KERNEL.search(entry.group(1))
            name = entry.group(1) if kernel is None else (
                kernel.group(1) + (f"<{kernel.group(2)}>" if kernel.group(2) else "")
            )
            report[name] = {k: 0 for k in _NUMBERS}
            continue
        if name is not None:
            for key, pattern in _NUMBERS.items():
                found = pattern.search(line)
                if found:
                    report[name][key] = int(found.group(1))
    return report


def _bind(path: Path) -> ctypes.CDLL:
    """Load a built library and declare the C signatures."""
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.grid_sample_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.grid_sample_fwd.restype = i32
    lib.grid_sample_bwd_uv.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.grid_sample_bwd_uv.restype = i32
    lib.grid_sample_bwd_img.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.grid_sample_bwd_img.restype = i32
    lib.grid_sample_error_string.argtypes = [i32]
    lib.grid_sample_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "grid_sample_bwd_img_smem_bytes"):  # absent from sources before K3's band
        lib.grid_sample_bwd_img_smem_bytes.argtypes = [i32, i32, i32]
        lib.grid_sample_bwd_img_smem_bytes.restype = i32
    return lib


def bwd_img_smem_bytes(lib: ctypes.CDLL, h: int, w: int, c: int):
    """The dynamic shared memory of each block of a K3 launch at image size
    (h, w, c), which ptxas's report leaves out; None for a source whose K3
    takes none."""
    if not hasattr(lib, "grid_sample_bwd_img_smem_bytes"):
        return None
    return lib.grid_sample_bwd_img_smem_bytes(h, w, c)


def load() -> ctypes.CDLL:
    """Build if needed and load grid_sample.cu, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(build())
        return _lib


def load_source(source: Path) -> ctypes.CDLL:
    """Build and load another source with grid_sample.cu's C interface (an
    earlier version of it, for a comparison on the card)."""
    return _bind(build(Path(source)))


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.grid_sample_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
