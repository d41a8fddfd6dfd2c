"""ctypes binding of the native decode/resize pipeline (native/mdloader.cpp),
port of monodepth2_tpu/data/native.py: `load_resize`, `load_strip` and
`load_triplet_batch` with the same signatures and errors.

The library is built here from the repo's source, with the flags of
native/Makefile, and without `make`: native/ is only read. It goes to
`_build/` beside this file, under a name keyed by the sha256 of the source,
the compiler and the flags. The build is atomic across processes: under an
exclusive `fcntl` lock on `_build/.lock` the compiler writes a temporary file
in that directory, which `os.replace` then moves to its name. A process that
imports this module while another builds waits for the lock, then loads the
finished library; none can load a half-written one.

A failed build is reported, not hidden: `available()` is False and
`build_error()` holds the compiler's command and stderr. The failure is kept
until `reset()`, so a process does not run the compiler again for every
dataset it makes; the datasets say which decoder they use (`.decoder`).

Each file is checked before the library sees it (`check_image`): a PNG's
chunks must be whole, their CRCs right, up to IEND; anything else must start
as a JPEG does. The library cannot be handed a damaged file: where libpng
fails it retries the file as a JPEG, and libjpeg's default error handler
then ends the process (mdloader.cpp load_image, load_jpeg).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shlex
import struct
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "mdloader.cpp"
BUILD_DIR = Path(__file__).resolve().with_name("_build")
# native/Makefile's CXXFLAGS, -shared and LDLIBS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
LDLIBS = ("-lpng", "-ljpeg", "-lz", "-lpthread")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _cxx() -> list:
    """The C++ compiler: $CXX as make reads it, else g++."""
    return shlex.split(os.environ.get("CXX") or "g++")


def library_path(source: Optional[Path] = None, build_dir: Optional[Path] = None) -> Path:
    """Where the library built from `source` (default SOURCE) with this
    compiler and these flags lives, in `build_dir` (default BUILD_DIR)."""
    source, build_dir = Path(source or SOURCE), Path(build_dir or BUILD_DIR)
    key = source.read_bytes() + " ".join([*_cxx(), *CXXFLAGS, *LDLIBS]).encode()
    return build_dir / f"libmdloader-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build(source: Optional[Path] = None, build_dir: Optional[Path] = None) -> Path:
    """Compile `source` (default SOURCE) into `build_dir` (default
    BUILD_DIR) unless its library is there already; returns the library's
    path. Raises RuntimeError with the compiler's command and stderr when
    the build fails."""
    source = Path(source or SOURCE)
    target = library_path(source, build_dir)
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if target.exists():  # another process built it while this one waited
            return target
        fd, tmp = tempfile.mkstemp(dir=target.parent, prefix=f".{target.stem}.", suffix=".tmp")
        os.close(fd)
        cmd = [*_cxx(), *CXXFLAGS, "-o", tmp, str(source), *LDLIBS]
        try:
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"native build failed: {shlex.join(cmd)}\n{e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"native build failed ({proc.returncode}): {shlex.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return target


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.md_load_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
    ]
    lib.md_load_resize.restype = ctypes.c_int
    lib.md_load_strip.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
    ]
    lib.md_load_strip.restype = ctypes.c_int
    lib.md_load_triplet_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.md_load_triplet_batch.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None after a failed build."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _bind(build())
            except (RuntimeError, OSError) as e:
                _error = str(e)
        return _lib


def available() -> bool:
    """True when the library is built (or builds now) and loads."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable: the compiler's command and stderr, or
    the loader's error; None while it is available or not yet tried."""
    return _error


def reset() -> None:
    """Forget the loaded library and any failure, so that the next use
    builds (or finds) it again."""
    global _lib, _error
    with _lock:
        _lib, _error = None, None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_resize(path: str, width: int, height: int, channels: int) -> np.ndarray:
    """Decode + bilinear-resize one image -> (H, W, C) float32 in [0,1]."""
    lib = _require()
    check_image(path)
    out = np.empty((height, width, channels), np.float32)
    rc = lib.md_load_resize(path.encode(), width, height, channels, _ptr(out))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return out


_PNG = b"\x89PNG\r\n\x1a\n"


def check_image(path: str) -> int:
    """The image's height, once the file is known to be safe to decode: a
    PNG whose chunks are whole and whose CRCs are right up to IEND, or a
    file that starts as a JPEG does with a frame header. Raises IOError
    otherwise (a missing file included)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise IOError(f"native decode failed (unreadable: {e}): {path}") from e
    if data[:8] == _PNG:
        i, height = 8, None
        while i + 12 <= len(data):
            (length,) = struct.unpack(">I", data[i : i + 4])
            kind, end = data[i + 4 : i + 8], i + 12 + length
            if end > len(data) or zlib.crc32(data[i + 4 : i + 8 + length]) != struct.unpack(">I", data[end - 4 : end])[0]:
                break
            if kind == b"IHDR":
                height = struct.unpack(">I", data[i + 12 : i + 16])[0]
            if kind == b"IEND" and height is not None:
                return height
            i = end
        raise IOError(f"native decode failed (a damaged PNG): {path}")
    i = 2 if data[:3] == b"\xff\xd8\xff" else len(data)
    while i + 9 <= len(data) and data[i] == 0xFF:
        marker, length = data[i + 1], int.from_bytes(data[i + 2 : i + 4], "big")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return int.from_bytes(data[i + 5 : i + 7], "big")
        i += 2 + length
    raise IOError(f"native decode failed (neither a PNG nor a JPEG): {path}")


def load_strip(path: str, frame_w: int, height: int, n_frames: int = 3, channels: int = 3) -> np.ndarray:
    """Depth10k strip -> (n_frames, H, frame_w, C) float32.

    md_load_strip writes as many rows as the strip has, so the buffer is
    sized from the file's header, not from `height` (the JAX binding sizes
    it from `height` and a taller strip overruns it); a strip of another
    height then raises IOError, as there."""
    lib = _require()
    out = np.empty((n_frames, check_image(path), frame_w, channels), np.float32)
    got_h = ctypes.c_int(0)
    rc = lib.md_load_strip(path.encode(), frame_w, n_frames, channels, _ptr(out), ctypes.byref(got_h))
    if rc != 0:
        raise IOError(f"native strip decode failed ({rc}): {path}")
    if got_h.value != height:
        raise IOError(f"strip height {got_h.value} != expected {height}: {path}")
    return out


def load_triplet_batch(
    paths: Sequence[str], width: int, height: int, channels: int, n_threads: int = 2
) -> np.ndarray:
    """Flat list of n*3 frame paths -> (n, 3, H, W, C) float32, threaded."""
    lib = _require()
    bad = []
    for p in paths:
        try:
            check_image(p)
        except IOError:
            bad.append(p)
    if bad:
        raise IOError(f"native batch decode: {len(bad)} frames failed: {bad[:3]}")
    n = len(paths) // 3
    out = np.empty((n, 3, height, width, channels), np.float32)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    failures = lib.md_load_triplet_batch(arr, n, width, height, channels, n_threads, _ptr(out))
    if failures:
        raise IOError(f"native batch decode: {failures} frames failed")
    return out
