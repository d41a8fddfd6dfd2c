"""The yardstick's bytes bounds and FLOP counts at both configurations'
shapes."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import costs

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_warp_shapes():
    assert costs.warp_shape(config("kitti416_r18_b4")) == (32, 128, 416, 1)
    assert costs.warp_shape(config("depth10k640_r18_b32")) == (256, 192, 640, 1)


def test_grid_sample_bytes_bounds():
    # image, uv and samples of 32 images of 128x416: each read or written once
    b = costs.grid_sample_bytes(32, 128, 416, 1)
    px = 32 * 128 * 416
    assert b == {"fwd": 4 * (px + 2 * px + px), "bwd_uv": 4 * (px + 2 * px + px + 2 * px)}
    assert costs.bound_seconds(b["fwd"]) * 1e6 == pytest.approx(8.138, abs=1e-3)
    assert costs.bound_seconds(b["bwd_uv"]) * 1e6 == pytest.approx(12.207, abs=1e-3)
    wide = costs.grid_sample_bytes(256, 192, 640, 1)
    assert wide["fwd"] == b["fwd"] * 8 * (192 * 640) // (128 * 416)


def test_step_flops_at_both_shapes():
    small = costs.step_flops(config("kitti416_r18_b4"))
    wide = costs.step_flops(config("depth10k640_r18_b32"))
    assert small == pytest.approx(173.94e9, rel=1e-4)
    # every convolution and per-pixel product scales with the pixels and the
    # batch; the 3x3 products of the geometry do not
    assert wide == pytest.approx(small * 8 * (640 * 192) / (416 * 128), rel=1e-5)


def test_step_flops_equal_the_programs_at_a_small_shape():
    from monodepth2_torch.models import Model
    from monodepth2_torch.training import TrainConfig, TrainContext, train_loss

    cfg = {**config("kitti416_r18_b4"), "target_size": [128, 64], "batch_size": 2, "compute_dtype": "float32"}
    names = set(TrainConfig.__dataclass_fields__)
    tcfg = TrainConfig.from_json(json.dumps({k: v for k, v in cfg.items() if k in names}))
    model = Model.create(depth=18, in_channels=1, device="cpu")
    ctx = TrainContext.create(torch.eye(3).numpy() * 50 + [[0, 0, 64], [0, 0, 32], [0, 0, -49]], 128, 64,
                              device="cpu")
    frames = torch.rand(2, 3, 64, 128, 1)
    with FlopCounterMode(display=False) as counter:
        loss, _ = train_loss(model, frames, ctx, tcfg, disp_reg_weight=torch.tensor(0.01))
        loss.backward()
    # the same work, up to the 3x3 products that build the rays and rotations
    assert costs.step_flops(cfg) == pytest.approx(counter.get_total_flops(), rel=1e-6)
