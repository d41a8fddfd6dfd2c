"""A run driven on the CPU at a tiny size, past the look for a card: the
last line's keys, the per-layer readers over a traced run, and `correct`
coming out false when the timed path is broken underneath it (a step that
leaves its state unchanged; half of every batch left out, its rows
dropped or kept), under the cells' own limits."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import faults, run
from benchmark.spec import Cell

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _config(**over):
    cfg = json.loads((ROOT / "benchmark" / "configs" / "kitti416_r18_b4.json").read_text())
    cfg.update(target_size=[128, 64], intrinsics={"fx": 100.0, "fy": 100.0, "cx": 64.0, "cy": 32.0}, **over)
    return cfg


def train_cell(name="kitti416_b4_train_mem"):
    # float32, so that a sound run at this size sits far inside the limits
    # of cell `name`
    cfg = _config(batch_size=2, steps_per_call=5, compute_dtype="float32")
    traffic = {"kind": "train", "sequence_frames": 14, "shift_px": 2, "trace_calls": 1}
    per_layer = [{"name": n, "unit": "x"} for n in ("input_wait_ms", "step_mfu_pct", "step_device_ms",
                                                    "warp_fwd_gbps", "device_idle_pct.train")]
    return Cell(name, 1, "tiny", cfg, "tiny", traffic,
                [{"name": "train_img_per_s", "unit": "img/s"}, {"name": "setup_s", "unit": "s"}], per_layer)


def drive(cell, trace=False, plant=None, seconds=1.0):
    code, text = run.execute(cell, 2**31 + 17, seconds, trace, torch.device("cpu"), plant=plant)
    assert code == 0 and text is not None
    return json.loads(text)


def test_train_line():
    out = drive(train_cell())
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_img_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


def test_train_traced_line_reads_host_metrics():
    out = drive(train_cell(), trace=True)
    assert set(out["metrics"]) == {"input_wait_ms", "step_mfu_pct"}  # no device activity on the CPU
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])


# a half batch that keeps its rows is compared at batch 32 only; a sign
# flipped in the replays climbs the loss too little in a few steps at this
# size, and is read on the card (test_bench_gpu.py; PERF.md)
FAULTS = [(cell, fault) for cell in ("kitti416_b4_train_mem", "depth10k640_b32_train_mem")
          for fault in ("unchanged", "half_batch", "half_rows")
          if (cell, fault) != ("kitti416_b4_train_mem", "half_rows")]


def test_sound_run_is_correct_under_each_cell_s_limits():
    for cell in ("kitti416_b4_train_mem", "depth10k640_b32_train_mem"):
        out = drive(train_cell(cell))
        assert out["correct"] is True, (cell, out["checks"])


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_train_fault_is_not_correct(cell, fault):
    out = drive(train_cell(cell), plant=faults.PLANTS[fault])
    assert out["correct"] is False, out["checks"]


def test_the_sequence_pans_and_no_two_triplets_are_alike():
    from benchmark import inputs
    from benchmark.kinds.train import PanningSequence

    gen = inputs.generator(2**31 + 5, torch.device("cpu"))
    scene = inputs.panorama(40, 16, 24, 1, 2, gen, torch.device("cpu"))
    assert scene.shape == (16, 24 + 2 * 39, 1)
    seq = PanningSequence(scene.numpy(), 24, 2, None)
    assert len(seq) == 38
    made = inputs.triplets(scene, 38, 24, 2).numpy()
    for i in (0, 17, 37):
        item = seq[i]
        assert item.shape == (3, 16, 24, 1) and (item == made[i]).all()
        assert (item[1] == seq[i + 1][0]).all() if i + 1 < len(seq) else True
    with pytest.raises(IndexError):
        seq[38]
    flat = made.reshape(38, -1)
    assert len({row.tobytes() for row in flat}) == 38
