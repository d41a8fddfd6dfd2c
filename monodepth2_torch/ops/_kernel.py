"""The wrappers' base class: one hand-written CUDA kernel's entry point, its
launch on the current stream and its launch counter."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch import Tensor

from .cuda import _lib


class Kernel:
    """A kernel's wrapper: `launches` counts the kernel launches it made.
    `source` is the file under ops/cuda/ that holds its C entry point `name`."""

    name = ""
    source: Path = _lib.SOURCE

    def __init__(self):
        self.launches = 0

    def lib(self) -> ctypes.CDLL:
        """The library built from `source` (built at first use)."""
        return _lib.load(self.source)

    def _launch(self, fn, *args) -> None:
        lib = self.lib()
        device = args[0].device
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            ptrs = [t.data_ptr() for t in args if isinstance(t, Tensor)]
            sizes = [a for a in args if not isinstance(a, Tensor)]
            code = getattr(lib, fn)(*ptrs, *sizes, stream)
        _lib.check(code, fn)
        self.launches += 1
