"""Exported serving artifacts (torch.export), port of
monodepth2_tpu/serving.py.

`export_inference` traces the disparity+depth inference of a model with
`torch.export` into an `ExportedProgram` with the weights inside and a
dynamic batch dimension, and saves it as one self-contained file that any
PyTorch process can `load_inference` and call without the port's model code
or a checkpoint. The JAX package's artifact is StableHLO for the platforms
it names; this one is a graph of ATen operators whose weights and device
arguments are those of the device it was traced on, so it runs on that
device type only: its meta names it under `platforms`, and `load_inference`
refuses any other.

Format: `<path>` is `torch.export.save`'s archive, with `meta.json` (input
spec, outputs, depth range, architecture, compute dtype, platforms) among
its extra files.
"""

from __future__ import annotations

import copy
import json
import os
import zipfile
from typing import Optional

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .ops.geometry import disparity_to_depth

_META = "meta.json"
# the dynamic batch dimension's upper end: above the server's largest bucket
MAX_BATCH = 1024


class InferenceModule(nn.Module):
    """x (N, H, W, C) float32 in [0, 1] -> {"disparity": (N, H, W, 1) sigmoid
    output at the finest scale, "depth": disparity_to_depth of it}, both fp32.

    Holds an eval-mode copy of the model's depth network, in
    bf16 when `compute_dtype` is "bfloat16" (params and BN running stats
    cast, as the JAX package's cast_tree does; the geometry stays fp32).
    Callers enter `torch.inference_mode()` themselves."""

    def __init__(self, model: nn.Module, min_depth: float, max_depth: float, compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
        self.dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
        self.depth_net = copy.deepcopy(model.depth_network()).to(self.dtype)
        self.min_depth, self.max_depth = float(min_depth), float(max_depth)
        self.eval()

    def forward(self, x: torch.Tensor) -> dict:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        disp = self.depth_net(x)[-1].permute(0, 2, 3, 1).float()
        return {"disparity": disp, "depth": disparity_to_depth(disp, self.min_depth, self.max_depth)}


def make_inference_fn(model: nn.Module, cfg) -> InferenceModule:
    """The live counterpart of an artifact: (x) -> {"disparity", "depth"} on
    a copy of `model`'s weights, in cfg.compute_dtype, with cfg's depth
    range."""
    return InferenceModule(model, cfg.min_depth, cfg.max_depth, cfg.compute_dtype)


def export_inference(model: nn.Module, cfg, path: str, batch_size: Optional[int] = None) -> None:
    """Trace the inference of `model` (on the device its weights are on) and
    save it to `path`, atomically.

    `batch_size=None` exports a dynamic batch dimension (1 … MAX_BATCH),
    traced from an example of batch 2: an example of batch 1 would make
    torch.export specialize the dimension to 1. An int pins it."""
    live = make_inference_fn(model, cfg)
    device = next(live.parameters()).device
    h, w, c = cfg.height, cfg.width, cfg.in_channels
    example = torch.zeros((batch_size or 2, h, w, c), dtype=torch.float32, device=device)
    dynamic = None
    if batch_size is None:
        dynamic = {"x": {0: torch.export.Dim("batch", min=1, max=MAX_BATCH)}}
    with torch.no_grad():
        program = torch.export.export(live, (example,), dynamic_shapes=dynamic)
    meta = {
        "input_shape": [batch_size, h, w, c],
        "input_dtype": "float32",
        "outputs": ["disparity", "depth"],
        "min_depth": cfg.min_depth,
        "max_depth": cfg.max_depth,
        "platforms": [device.type],
        "architecture": cfg.architecture,
        "encoder_depth": cfg.encoder_depth,
        "compute_dtype": cfg.compute_dtype,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.export.save(program, f, extra_files={_META: json.dumps(meta, indent=2)})
    os.replace(tmp, path)


class ServedModel:
    """A loaded artifact: callable, no model code or checkpoint needed.

    Safe to call from several threads: the program is used for inference
    only, and each call enters inference mode in its own thread."""

    def __init__(self, module: nn.Module, meta: dict, device: torch.device):
        self._module = module
        self.meta = meta
        self.device = device

    def __call__(self, x) -> dict:
        """x: (N, H, W, C) float32 in [0,1], an array or a tensor -> dict of
        tensors on the artifact's device (nothing is copied back)."""
        # validate on the host, before the copy to the card: a batch of the
        # wrong resolution must not pay a transfer for an input about to raise
        shape = tuple(x.shape)
        want = self.meta["input_shape"]
        if len(shape) != 4 or list(shape[1:]) != want[1:]:
            raise ValueError(
                f"input {shape} incompatible with exported spec (N, {want[1]}, {want[2]}, {want[3]})"
            )
        if want[0] is not None and shape[0] != want[0]:
            raise ValueError(f"artifact was exported with fixed batch {want[0]}, got {shape[0]}")
        if not isinstance(x, torch.Tensor):
            # writable and contiguous (a request body read by np.frombuffer is not)
            x = torch.from_numpy(np.require(x, np.float32, ("C", "W")))
        x = x.to(device=self.device, dtype=torch.float32)
        with torch.inference_mode():
            return self._module(x)


def read_meta(path: str) -> dict:
    """The meta.json of an artifact, read from its archive without loading
    the program (whose tensors may live on a device this process lacks)."""
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist() if n.endswith(f"/extra/{_META}")]
        if len(names) != 1:
            raise ValueError(f"{path} is not an export_inference artifact (no {_META})")
        return json.loads(z.read(names[0]))


def load_inference(path: str, device: str | torch.device = "cuda") -> ServedModel:
    """Deserialize an `export_inference` artifact onto `device` (the card
    unless the caller passes "cpu").

    Raises RuntimeError without a card when one is asked for, and ValueError
    when the artifact was exported on another device type: its weights and
    the device arguments inside its graph belong to that one."""
    device = resolve_device(device)
    meta = read_meta(path)
    if device.type not in meta["platforms"]:
        raise ValueError(
            f"{path} was exported on {meta['platforms']} and runs there only; asked for {device.type}"
        )
    return ServedModel(torch.export.load(path).module(), meta, device)
