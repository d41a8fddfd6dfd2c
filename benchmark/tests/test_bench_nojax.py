"""No module of JAX or of the JAX package in a run of the benchmark, and no
module of the program in its reference: top-level module names compared
whole (the port's name begins with the JAX package's)."""

import subprocess
import sys
from pathlib import Path

from benchmark.result import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_names_are_compared_whole():
    assert forbidden_modules(["jax.numpy", "monodepth2_torch.ops", "monodepth2_tpu_extra", "jaxtyping"]) == ["jax"]
    assert forbidden_modules(["monodepth2_tpu.ops.geometry", "optax", "flax.linen", "jaxlib.xla"]) == \
        ["flax", "jaxlib", "monodepth2_tpu", "optax"]
    assert FORBIDDEN == {"jax", "jaxlib", "optax", "flax", "monodepth2_tpu"}


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    code = """
import json, torch
from benchmark import run, spec
from benchmark.spec import Cell
cfg = json.load(open("benchmark/configs/kitti416_r18_b4.json"))
cfg.update(target_size=[128, 64], batch_size=2, steps_per_call=4, compute_dtype="float32",
           intrinsics={"fx": 100.0, "fy": 100.0, "cx": 64.0, "cy": 32.0})
cell = Cell("tiny", 1, "tiny", cfg, "tiny", {"kind": "train", "sequence_frames": 12, "shift_px": 2, "trace_calls": 1},
            [{"name": "train_img_per_s", "unit": "img/s"}, {"name": "setup_s", "unit": "s"}], [])
run.limits_of = lambda name: json.load(open("benchmark/limits/kitti416_b4_train_mem.json"))
import benchmark.calibrate, benchmark.faults
code, text = run.execute(cell, 2**31 + 1, 1.0, False, torch.device("cpu"))
assert code == 0 and text
from benchmark.result import forbidden_modules
import sys
print(sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0].startswith(("jax", "monodepth2", "optax", "flax"))}), forbidden_modules())
"""
    assert _run(code) == "['monodepth2_torch'] []"


def test_the_reference_loads_nothing_of_the_program():
    code = """
import sys
import benchmark.reference.model, benchmark.reference.train
print(sorted({m.split(".")[0] for m in sys.modules} & {"monodepth2_torch", "monodepth2_tpu", "jax"}))
"""
    assert _run(code) == "[]"
