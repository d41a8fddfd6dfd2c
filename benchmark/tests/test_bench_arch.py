"""Traffic kind `train_arch` (the PackNet cell): a run driven on the CPU
at 64×32, past the look for a card, is correct under the cell's limits, and
comes out not correct when the timed path leaves its state unchanged or
drops half of every batch; on the card (marker `gpu`), at the cell's own
size, the program's readings keep inside the limits and the control and
the faults that the limits catch fail them.

    python -m pytest --noconftest -m gpu benchmark/tests/test_bench_arch.py -q
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import calibrate, faults, run, spec
from benchmark.kinds import train_arch
from benchmark.spec import Cell

ROOT = Path(__file__).resolve().parents[2]
CELL = "kitti640_packnet_b4_train_mem"


def small_cell():
    """The cell at 64×32, batch 2, float32 (the CPU's bf16 convolutions give
    NaN weight gradients on the PoseNet's last 1×1 map at this size)."""
    cell = spec.cell(CELL)
    cfg = dict(cell.config, target_size=[64, 32], batch_size=2, steps_per_call=5, compute_dtype="float32",
               intrinsics={"fx": 40.0, "fy": 38.0, "cx": 32.0, "cy": 16.0})
    traffic = dict(cell.traffic, sequence_frames=14, trace_calls=1)
    return Cell(cell.name, 1, cell.config_name, cfg, cell.traffic_name, traffic, cell.end_to_end, cell.per_layer)


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_a_cpu_run_is_correct_unless_the_path_is_broken(fault):
    code, text = run.execute(small_cell(), 2**31 + 23, 1.0, False, torch.device("cpu"),
                             plant=faults.PLANTS[fault] if fault else None)
    assert code == 0 and text is not None
    out = json.loads(text)
    assert out["correct"] is (fault is None), out["checks"]
    assert set(out["checks"]) == set(json.loads((ROOT / "benchmark" / "limits" / f"{CELL}.json").read_text()))
    assert set(out["metrics"]) == {"train_img_per_s", "setup_s"}


def test_replay_loss_climb_reads_the_median_gap_after_update_4():
    reference = [1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4]
    same = list(reference)
    assert train_arch.replay_loss_climb(same, reference) == 0.0
    # climbing at every replay reads as the least climb; one replay at or
    # below the reference's loss reads as that replay's gap
    climbing = [1.0, 0.9, 0.8, 0.7, 0.66, 0.6, 0.5]
    assert abs(train_arch.replay_loss_climb(climbing, reference) - 0.1) < 1e-12
    assert abs(train_arch.replay_loss_climb([*climbing[:5], 0.45, 0.5], reference) + 0.1) < 1e-12
    # update 4's loss is at the state the reference starts from: not read
    assert train_arch.replay_loss_climb([1.0, 0.9, 0.8, 9.0, 0.6, 0.5, 0.4], reference) == 0.0
    assert train_arch.replay_loss_climb(climbing[:-1], reference) == float("inf")  # counts differ
    assert train_arch.replay_loss_climb([*climbing[:-1], float("nan")], reference) == float("inf")
    assert train_arch.replay_loss_climb(reference[:4], reference[:4]) == float("inf")  # no replay to read


def test_the_kinds_session_stands_in_only_inside():
    from benchmark.kinds import train

    original = train.Session
    with train_arch.sessions():
        assert train.Session is train_arch.Session
    assert train.Session is original


# bf16 at batch 4 moves a row's gradient as far as a half batch that keeps
# its rows does, so that fault is not compared (PERF.md); a sign flipped in
# the replays climbs the loss (`replay_loss_climb`)
UPPER = ("control", "half_batch", "unchanged", "flipped_replays")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [201, 202])
def test_control_and_faults_fail_where_the_program_passes(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", 0)
    cell = spec.cell(CELL)
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{CELL}.json").read_text())
    with train_arch.sessions():
        reading = calibrate.reading(cell, seed, device, "program")
        assert all(reading[k] <= limits[k] for k in limits), reading
        for what in UPPER:
            reading = calibrate.reading(cell, seed, device, what)
            assert any(not reading[k] <= limits[k] for k in limits), what
