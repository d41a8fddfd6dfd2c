"""monodepth2_torch and chip_smoke.py import neither jax, optax nor the JAX
package; the port's entry points refuse a CUDA device they do not have; and
chip_smoke.py fails without a card or without the repository beside it."""

import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "optax", "monodepth2_tpu")


def _run(code, cwd=ROOT, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(cwd))
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout,
    )


def test_port_imports_without_jax():
    proc = _run(f"""
        import importlib, pkgutil, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None  # any import of it now raises ImportError
        import monodepth2_torch
        names = [m.name for m in pkgutil.walk_packages(monodepth2_torch.__path__, "monodepth2_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        loaded = [n for n in sys.modules if n.split(".")[0] in {BLOCKED!r} and sys.modules[n] is not None]
        assert not loaded, loaded
        print(len(names), "modules")
    """)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 15


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from monodepth2_torch.device import resolve_device
    from monodepth2_torch.models import Model
    from monodepth2_torch.training import TrainContext

    for call in (
        lambda: resolve_device(),
        lambda: Model.create(),
        lambda: TrainContext.create([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], 64, 32),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
