"""Configuration and the device-resident training context, port of
monodepth2_tpu/training/config.py. `TrainConfig` keeps the same fields and
JSON schema, so configs/*.json load unchanged. `steps_per_call` selects the
scanned step (a CUDA graph replayed that many times a call on the card),
`remat` recomputes the network's activations in the backward
(torch.utils.checkpoint), and `debug_nans` runs the steps eagerly and checks
each loss on the host (training/state.py, training/loop.py).

`architecture` is the port's own field: "monodepth2" (the default, the JAX
package's only network) or "packnet01" (models/packnet.py). `to_json`
leaves it out at its default, so a ResNet configuration's JSON, and a
checkpoint's sidecar, stay in the JAX package's schema.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.geometry import pixel_grid


ARCHITECTURES = ("monodepth2", "packnet01")


@dataclass(frozen=True)
class TrainConfig:
    # geometry / loss (reference defaults, src/Monodepth.jl:33-42,103-107)
    min_depth: float = 0.1
    max_depth: float = 100.0
    disparity_smoothness: float = 1e-3
    automasking: bool = False

    # frames: 3-frame triplets, middle frame is the target
    frame_ids: Tuple[int, ...] = (0, 1, 2)
    target_id: int = 1
    source_ids: Tuple[int, ...] = (0, 2)

    # resolution (width, height) and model; `architecture` picks the network
    # (models.create_model), `encoder_depth` the ResNet of "monodepth2"
    target_size: Tuple[int, int] = (416, 128)
    in_channels: int = 1
    encoder_depth: int = 18
    architecture: str = "monodepth2"
    scale_levels: Tuple[int, ...] = (2, 3, 4, 5)

    # optimization (reference: ADAM 1e-4, batch 4, 20 epochs)
    batch_size: int = 4
    lr: float = 1e-4
    epochs: int = 20
    seed: int = 42
    # stabilizers the reference lacks: global-norm gradient clipping (0 =
    # off) and linear lr warmup steps — both guard the pose head against
    # overshooting its narrow photometric basin early in training (see
    # VALIDATION.md)
    grad_clip: float = 0.0
    lr_warmup_steps: int = 0
    # one-time step decay: multiply lr by `lr_decay_factor` once the global
    # step reaches `lr_decay_steps` (0 = off). The monodepth2 paper decays
    # x0.1 for the last 5 of 20 epochs; the Julia reference keeps ADAM(1e-4)
    # constant (src/Monodepth.jl:126) and its long-run loss plateaus — the
    # same plateau shows in docs/runs/ssl_driving_c_20k_history.json.
    lr_decay_steps: int = 0
    lr_decay_factor: float = 0.1
    # anti-collapse stabilizer (the known from-scratch SSL failure mode:
    # disparity saturates to 0/1 before pose-depth co-adaptation starts —
    # VALIDATION.md): L2 penalty on the pre-sigmoid disparity logit,
    # weight `disp_reg` decaying linearly to zero over `disp_reg_steps`.
    # The logit (recovered as log(d/(1-d))) is penalized rather than the
    # disparity itself because the sigmoid's vanishing gradient would
    # otherwise disarm the penalty exactly where it is needed. 0 = off.
    disp_reg: float = 0.0
    disp_reg_steps: int = 0
    # forward-motion prior for driving data: initial tz of the predicted
    # (earlier→later) pose (negative = later camera ahead; see
    # models/pose_decoder.py). 0 = the reference's zero-motion init.
    pose_tz_init: float = 0.0

    # precision: params fp32; "bfloat16" computes the network in bf16
    compute_dtype: str = "float32"

    # warp implementation: None = auto (the hand-written CUDA kernels on the
    # card, their plain versions on the CPU); "gather" = the plain versions
    # of the warp and of the projection (ops/geometry.py), on any device;
    # "pallas" = the kernels (see ops/grid_sample.py). "onehot" is TPU-only.
    warp_method: Optional[str] = None

    # per-item camera intrinsics: batches become {"frames", "K" (N,3,3)} and
    # each item backprojects/projects with its own calibration. Beats the
    # reference, which trains a whole DChain with the FIRST sequence's K
    # (src/Monodepth.jl:99) even though KITTI calibrations differ per
    # sequence. ctx.K still seeds compile-time shapes; the warp uses the
    # batch's K.
    per_item_K: bool = False

    # debug tripwire (SURVEY.md §5: the analog of CUDA.allowscalar(false)):
    # abort the step on any NaN in the computation
    debug_nans: bool = False

    # rematerialize the network in the backward pass (memory for FLOPs)
    remat: bool = False

    # train steps per call of the step function: on the card one captured
    # CUDA graph replayed this many times, which takes the eager step's
    # per-kernel host launches out of the step time; logging/checkpoint
    # cadences still fire on every crossed multiple. 1 = the reference's
    # step-per-call behavior.
    steps_per_call: int = 1

    # cadence (reference: log 50, save 500 — src/Monodepth.jl:149)
    log_every: int = 50
    save_every: int = 500

    # io
    log_dir: str = "logs"
    save_dir: str = "models"

    def __post_init__(self):
        if self.architecture not in ARCHITECTURES:
            raise ValueError(f"architecture {self.architecture!r} is none of {ARCHITECTURES}")
        w, h = self.target_size
        if w % 32 or h % 32:
            raise ValueError(
                f"target_size {self.target_size} must be divisible by 32 "
                "(the encoder downsamples 5x by 2 and the decoder upsamples "
                "back; odd intermediate sizes break the skip concatenation)"
            )

    @property
    def scales(self) -> Tuple[float, ...]:
        """Per-scale loss weights [1/2^(5-l)] (reference src/Monodepth.jl:107)."""
        return tuple(1.0 / 2.0 ** (5 - l) for l in self.scale_levels)

    @property
    def width(self) -> int:
        return self.target_size[0]

    @property
    def height(self) -> int:
        return self.target_size[1]

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if d["architecture"] == ARCHITECTURES[0]:
            del d["architecture"]
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "TrainConfig":
        d = json.loads(s)
        for k in ("frame_ids", "source_ids", "target_size", "scale_levels"):
            if k in d:
                d[k] = tuple(d[k])
        return TrainConfig(**d)


@dataclass(frozen=True)
class TrainContext:
    """Device-resident constants for the loss: intrinsics + pixel grid."""

    K: torch.Tensor
    invK: torch.Tensor
    grid: torch.Tensor  # (H*W, 3) homogeneous pixel coordinates

    @staticmethod
    def create(
        K: np.ndarray,
        width: int,
        height: int,
        dtype=torch.float32,
        device: str | torch.device = "cuda",
    ) -> "TrainContext":
        device = resolve_device(device)
        K = torch.as_tensor(np.asarray(K), dtype=dtype)
        return TrainContext(
            K=K.to(device),
            invK=torch.as_tensor(
                np.linalg.inv(K.double().numpy()), dtype=dtype, device=device
            ),
            grid=pixel_grid(width, height, dtype, device),
        )
