"""monodepth2_torch and chip_smoke.py import neither jax, optax nor the JAX
package; the port's entry points (the trainer's and the serving path's)
refuse a CUDA device they do not have; and chip_smoke.py fails without a
card or without the repository beside it."""

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
        measuring = {{"monodepth2_torch.bench", "monodepth2_torch.utils", "monodepth2_torch.utils.profiler",
                     "monodepth2_torch.tools", "monodepth2_torch.tools.warp_kernel_bench",
                     "monodepth2_torch.tools.profile_breakdown", "monodepth2_torch.tools.kernel_ab",
                     "monodepth2_torch.tools.k3_sweep"}}
        assert measuring <= set(names), measuring - set(names)
        trainer = {{"monodepth2_torch.training.checkpoint", "monodepth2_torch.training.loop",
                   "monodepth2_torch.utils.viz", "monodepth2_torch.data", "monodepth2_torch.data.loader",
                   "monodepth2_torch.data.dchain", "monodepth2_torch.data.augment",
                   "monodepth2_torch.data.synthetic", "monodepth2_torch.data.kitti",
                   "monodepth2_torch.data.depth10k"}}
        assert trainer <= set(names), trainer - set(names)
        serving = {{"monodepth2_torch.eval", "monodepth2_torch.serving", "monodepth2_torch.server",
                   "monodepth2_torch.utils.metrics", "monodepth2_torch.tools.serving_bench",
                   "monodepth2_torch.tools.http_serving_bench", "monodepth2_torch.tools.model_block_bench",
                   "monodepth2_torch.tools.ssl_driving_experiment", "monodepth2_torch.tools.serving_warmup_check"}}
        assert serving <= set(names), serving - set(names)
        parallel = {{"monodepth2_torch.parallel", "monodepth2_torch.parallel.mesh", "monodepth2_torch.parallel.dp",
                    "monodepth2_torch.parallel.distributed", "monodepth2_torch.parallel.comm",
                    "monodepth2_torch.data.native", "monodepth2_torch.tools.loader_bench",
                    "monodepth2_torch.tools.batch_scaling_bench", "monodepth2_torch.tools.dp_worker"}}
        assert parallel <= set(names), parallel - set(names)
        command_line = {{"monodepth2_torch.cli", "monodepth2_torch.tools.make_demo",
                        "monodepth2_torch.tools.per_item_k_experiment"}}
        assert command_line <= set(names), command_line - set(names)
        # importing the native binding builds nothing; a process group is set
        # up only when asked for
        from monodepth2_torch.data import native
        import torch.distributed
        assert native._lib is None and native._error is None
        assert not torch.distributed.is_initialized()
        # PIL is imported only where a dataset decodes a file: the trainer
        # writes its PNGs without it
        assert "PIL" not in sys.modules
        print(len(names), "modules")
    """)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 40


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from monodepth2_torch.device import resolve_device
    from monodepth2_torch.eval import eval_depth_accuracy, eval_images, eval_video, load_model
    from monodepth2_torch.models import Model
    from monodepth2_torch.parallel import make_mesh
    from monodepth2_torch.server import build_server
    from monodepth2_torch.serving import load_inference
    from monodepth2_torch.training import TrainConfig, TrainContext

    cfg = TrainConfig(target_size=(64, 32))
    for call in (
        lambda: resolve_device(),
        lambda: Model.create(),
        lambda: TrainContext.create([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], 64, 32),
        lambda: load_model(cfg, "no-checkpoint"),
        lambda: eval_images(cfg, "no-checkpoint", ".", "out"),
        lambda: eval_video(cfg, "no-checkpoint", "v.mp4", "out"),
        lambda: eval_depth_accuracy(cfg, "no-checkpoint", [], []),
        lambda: load_inference("no-artifact.pt2"),
        lambda: build_server("no-artifact.pt2", port=0, warmup=False),
        lambda: make_mesh(),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()


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
