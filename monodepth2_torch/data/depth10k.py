"""CommaAI Depth10k triplet dataset + static-scene curation, copied from
monodepth2_tpu/data/depth10k.py (reference: src/dtk.jl). Strips decode
through the native decoder (data/native.py) when it builds, else through
PIL, imported where a strip is read; `decoder` says which.

Each file is a 1248-wide strip of 3 horizontally-concatenated 416×128 frames.
Fixed intrinsics: focal 2648/4.63461538462, principal point at center
(reference src/dtk.jl:16-22). `find_static` flags triplets whose identity
automasking loss exceeds α — stationary-camera scenes that would teach the
network infinite depth (reference src/dtk.jl:51-69).
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.losses import automasking_loss
from .augment import resize_bilinear
from .kitti import native_decoder

DTK_WIDTH, DTK_HEIGHT = 416, 128
DTK_FOCAL = 2648.0 / 4.63461538462


class Depth10k:
    def __init__(
        self,
        image_dir: str,
        image_files: Sequence[str],
        augmentations=None,
        grayscale: bool = False,
        target_size: Optional[Tuple[int, int]] = None,
        use_native: bool = True,
        cache_decoded: bool = False,
    ):
        """target_size (width, height) resizes each frame AFTER the strip
        split; the focal is rescaled by the mean target/native ratio with the
        principal point recentered (same convention as KittiDataset /
        src/kitty.jl:27-29). None keeps the native 416×128 (the reference's
        only mode, src/dtk.jl:16-22)."""
        self.dir = image_dir
        self.files = list(image_files)
        self.augmentations = augmentations
        self.grayscale = grayscale
        self.width, self.height = target_size or (DTK_WIDTH, DTK_HEIGHT)
        self._native = native_decoder(use_native)
        self.decoder = "pil" if self._native is None else "native"
        ratio = float(np.mean([self.width / DTK_WIDTH, self.height / DTK_HEIGHT]))
        f = DTK_FOCAL * ratio
        self.K = np.asarray(
            [[f, 0, self.width / 2.0], [0, f, self.height / 2.0], [0, 0, 1.0]], np.float64
        )
        self.invK = np.linalg.inv(self.K)
        self.target_id = 1
        self.source_ids = (0, 2)
        # RAM cache of decoded+resized uint8 triplets, u8-quantized on the
        # fill pass too so all epochs see identical pixels
        self._cache = {} if cache_decoded else None
        self._cache_lock = threading.Lock() if cache_decoded else None

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int, rng: Optional[np.random.Generator] = None):
        cached = self._decode_cached(i)
        if self.augmentations is not None:
            rng = rng or np.random.default_rng()
            cached = np.stack(self.augmentations(list(cached), rng), axis=0)
        return cached

    def _decode_cached(self, i: int) -> np.ndarray:
        if self._cache is not None:
            with self._cache_lock:
                hit = self._cache.get(i)
            if hit is not None:
                return hit.astype(np.float32) / 255.0
        out = np.stack(self._decode(i), axis=0)  # (3,H,W,C)
        if self._cache is not None:
            u8 = np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)
            with self._cache_lock:
                self._cache[i] = u8
            return u8.astype(np.float32) / 255.0
        return out

    def _decode(self, i: int):
        from PIL import Image

        path = os.path.join(self.dir, self.files[i])
        if self._native is not None:
            stacked = self._native.load_strip(path, DTK_WIDTH, DTK_HEIGHT, 3, 1 if self.grayscale else 3)
            frames = [stacked[j] for j in range(3)]
        else:
            with Image.open(path) as im:
                im = im.convert("L" if self.grayscale else "RGB")
                strip = np.asarray(im, np.float32) / 255.0
            if strip.ndim == 2:
                strip = strip[..., None]
            frames = [strip[:, j * DTK_WIDTH : (j + 1) * DTK_WIDTH] for j in range(3)]
        if (self.width, self.height) != (DTK_WIDTH, DTK_HEIGHT):
            frames = [resize_bilinear(f, self.width, self.height) for f in frames]
        return frames


@torch.no_grad()
def find_static(
    dataset, alpha: float, progress: bool = False, batch_size: int = 64,
    device: str | torch.device = "cuda",
) -> List[str]:
    """Return the filenames of NON-static triplets (identity automasking loss
    above `alpha`) — reference find_static, src/dtk.jl:51-69.

    Triplets are scored `batch_size` at a time on `device`, one batch per
    call of the loss, as the JAX package's batched pass does."""
    device = resolve_device(device)
    target_id = dataset.target_id
    source_ids = tuple(dataset.source_ids)
    n = len(dataset)
    non_static = []
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        x = torch.from_numpy(np.stack([np.asarray(dataset[i]) for i in idx])).to(device)
        loss = automasking_loss(x, x[:, target_id], source_ids)
        losses = loss.mean(dim=tuple(range(1, loss.dim()))).cpu().numpy()
        for j, i in enumerate(idx):
            if float(losses[j]) > alpha:
                non_static.append(dataset.files[i])
        if progress:
            print(f"find_static {idx[-1] + 1}/{n}: kept {len(non_static)}")
    return non_static
