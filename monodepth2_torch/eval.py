"""Inference + evaluation harness, port of monodepth2_tpu/eval.py.

Batched disparity inference from a checkpoint — the port's own
(training/checkpoint.py, arrays `model/…`) or one the JAX package wrote
(arrays `leaf_00000…`, read without jax by `bridge.load_jax_checkpoint`) —
disparity PNGs from a directory of frames or a video, and the median-scaled
AbsRel/δ accuracy against ground-truth depth maps. Everything runs on the
card unless the caller passes device="cpu".
"""

from __future__ import annotations

import copy
import json
import os
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .bridge import load_jax_checkpoint
from .device import resolve_device
from .models import create_model
from .ops.geometry import disparity_to_depth
from .training.config import TrainConfig
from .utils.metrics import depth_metrics
from .utils.viz import save_disparity


def sidecar_config(checkpoint_path: str) -> Optional[TrainConfig]:
    """The training config recorded in the checkpoint's JSON sidecar, or
    None where there is none. Consumers (export, inference) take the
    architecture from it rather than from the caller's defaults, so that an
    omitted --in-channels or --encoder-depth cannot build another network
    than the one trained."""
    meta_path = checkpoint_path + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if "config" in meta:
            return TrainConfig.from_json(meta["config"])
    return None


def _checkpoint_state_dict(checkpoint_path: str, model: torch.nn.Module) -> dict:
    """The model's weights from either checkpoint format, told apart by the
    array names: the port's `model/<state_dict key>`, the JAX package's
    `leaf_00000…`."""
    with np.load(checkpoint_path + ".npz") as data:
        names = data.files
        if any(n.startswith("model/") for n in names):
            return {n[len("model/"):]: torch.from_numpy(data[n]) for n in names if n.startswith("model/")}
    if any(n.startswith("leaf_") for n in names):
        return load_jax_checkpoint(checkpoint_path, model)
    raise ValueError(f"{checkpoint_path}.npz holds neither the port's nor the JAX package's checkpoint")


def load_model(cfg: TrainConfig, checkpoint_path: str, device: str | torch.device = "cuda") -> torch.nn.Module:
    """Rebuild the model and restore its checkpointed weights, in eval mode
    on `device`.

    The architecture (network, encoder depth, input channels, scale levels) comes from
    the checkpoint's sidecar where it records the training config, and from
    `cfg` only where it does not; the caller's cfg stays in charge of the
    inference-side settings (size, compute dtype, depth range). The state
    dict loads strictly, so a checkpoint of another network raises."""
    device = resolve_device(device)
    arch = sidecar_config(checkpoint_path) or cfg
    model = create_model(arch, device="cpu")
    model.load_state_dict(_checkpoint_state_dict(checkpoint_path, model))
    return model.to(device).eval()


def make_infer_fn(model: torch.nn.Module, compute_dtype: str = "float32") -> Callable:
    """Batched disparity inference: x (N,H,W,C) in [0,1], a tensor or an
    array -> fp32 disparity (N,H,W) at the finest scale, on the model's
    device.

    compute_dtype "bfloat16" runs a bf16 copy of the network — params and BN
    running stats cast as the JAX package's `cast_tree` casts them, the input
    cast too — and returns fp32 disparity. Each call enters
    `torch.inference_mode()` in the calling thread (grad mode is
    thread-local)."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    net = copy.deepcopy(model.depth_network()).eval().to(dtype)
    device = next(net.parameters()).device

    def infer(x) -> torch.Tensor:
        with torch.inference_mode():
            x = torch.as_tensor(x).to(device=device, dtype=dtype)
            return net(x.permute(0, 3, 1, 2))[-1][:, 0].float()

    return infer


def _load_image(path, width: int, height: int, grayscale: bool) -> np.ndarray:
    """Decode + preprocess one image exactly as the training pipeline does
    (data/kitti.py): convert, BILINEAR resize to (W, H), [0,1] float32.
    `path` is a filesystem path or a file-like object (server.py feeds
    request bodies through here, so the served path cannot diverge from
    this preprocessing)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("L" if grayscale else "RGB")
        im = im.resize((width, height), Image.BILINEAR)
        arr = np.asarray(im, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def _batched(frames: Iterable[np.ndarray], batch_size: int) -> Iterator[np.ndarray]:
    buf: List[np.ndarray] = []
    for f in frames:
        buf.append(f)
        if len(buf) == batch_size:
            yield np.stack(buf)
            buf = []
    if buf:
        yield np.stack(buf)


def _save_batches(infer, frames: Iterable[np.ndarray], batch_size: int, out_dir: str) -> int:
    """Disparity PNGs d-<i>.png of `frames`, batched; returns their count."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for batch in _batched(frames, batch_size):
        disp = infer(batch).cpu().numpy()
        for j in range(disp.shape[0]):
            save_disparity(disp[j], os.path.join(out_dir, f"d-{n + j}.png"))
        n += disp.shape[0]
    return n


def eval_images(
    cfg: TrainConfig,
    checkpoint_path: str,
    image_dir: str,
    out_dir: str,
    batch_size: int = 8,
    limit: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> int:
    """Directory of frames -> disparity heatmap PNGs (reference eval_image).

    Returns the number of frames processed."""
    infer = make_infer_fn(load_model(cfg, checkpoint_path, device), cfg.compute_dtype)
    files = sorted(f for f in os.listdir(image_dir) if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if limit:
        files = files[:limit]
    frames = (
        _load_image(os.path.join(image_dir, f), cfg.width, cfg.height, cfg.in_channels == 1) for f in files
    )
    return _save_batches(infer, frames, batch_size, out_dir)


def eval_video(
    cfg: TrainConfig,
    checkpoint_path: str,
    video_path: str,
    out_dir: str,
    batch_size: int = 8,
    limit: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> int:
    """Video stream -> disparity heatmap PNGs (reference eval_video,
    src/Monodepth.jl:229-248), batched; decodes through OpenCV, else
    imageio (each optional, imported here)."""
    from PIL import Image

    infer = make_infer_fn(load_model(cfg, checkpoint_path, device), cfg.compute_dtype)

    def raw_frames():
        try:
            import cv2

            cap = cv2.VideoCapture(video_path)
            try:
                while True:
                    ok, bgr = cap.read()
                    if not ok:
                        return
                    yield bgr[..., ::-1]  # BGR -> RGB
            finally:
                cap.release()
        except ImportError:
            import imageio.v3 as iio

            yield from iio.imiter(video_path)

    def frames():
        for i, frame in enumerate(raw_frames()):
            if limit and i >= limit:
                return
            im = Image.fromarray(np.ascontiguousarray(frame)).convert("L" if cfg.in_channels == 1 else "RGB")
            im = im.resize((cfg.width, cfg.height), Image.BILINEAR)
            arr = np.asarray(im, np.float32) / 255.0
            yield arr[..., None] if arr.ndim == 2 else arr

    return _save_batches(infer, frames(), batch_size, out_dir)


def eval_depth_accuracy(
    cfg: TrainConfig,
    checkpoint_path: str,
    images: Sequence[np.ndarray],
    gt_depths: Sequence[np.ndarray],
    batch_size: int = 8,
    min_depth: float = 1e-3,
    max_depth: float = 80.0,
    device: str | torch.device = "cuda",
):
    """AbsRel/δ<1.25 etc. against ground-truth depth maps, median-scaled.

    images: (H,W,C) float frames at model resolution; gt_depths at any
    resolution (the predicted depth is resized to each gt map, BILINEAR in
    PIL's float mode, as the JAX package does).
    """
    from PIL import Image

    infer = make_infer_fn(load_model(cfg, checkpoint_path, device), cfg.compute_dtype)
    per_image = []
    idx = 0
    for batch in _batched(iter(images), batch_size):
        depth = disparity_to_depth(infer(batch), cfg.min_depth, cfg.max_depth).cpu().numpy()
        for j in range(depth.shape[0]):
            gt = np.asarray(gt_depths[idx])
            pred = np.asarray(Image.fromarray(depth[j]).resize((gt.shape[1], gt.shape[0]), Image.BILINEAR))
            per_image.append(depth_metrics(pred, gt, min_depth=min_depth, max_depth=max_depth))
            idx += 1
    keys = per_image[0].keys()
    return {k: float(np.mean([m[k] for m in per_image])) for k in keys}
