"""On the card (marker `gpu`; skipped without one): at the cells' own
sizes, the program's readings keep inside each cell's limits, and the
control (the reference computing in float8, put in the program's place)
and each planted fault fail at least one of them.

    python -m pytest --noconftest -m gpu benchmark/tests/test_bench_gpu.py -q
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import calibrate, spec

ROOT = Path(__file__).resolve().parents[2]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _fails(reading: dict, limits: dict) -> bool:
    return any(not reading[k] <= limits[k] for k in limits)


# a half batch that keeps its rows, and a sign flipped in the replays, read
# within bf16's noise at batch 4 (PERF.md)
UPPER = {"kitti416_b4_train_mem": ("control", "half_batch", "unchanged"),
         "depth10k640_b32_train_mem": ("control", "half_batch", "half_rows", "flipped_replays", "unchanged")}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(UPPER))
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_train_control_and_faults_fail_where_the_program_passes(name, seed):
    device = _card()
    cell = spec.cell(name)
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{cell.name}.json").read_text())
    assert not _fails(calibrate.reading(cell, seed, device, "program"), limits)
    for what in UPPER[name]:
        assert _fails(calibrate.reading(cell, seed, device, what), limits), what
