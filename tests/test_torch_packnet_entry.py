"""PackNet through the port's entry points on the CPU, at 64×32 RGB:
`cli train --config configs/kitti_packnet01_640.json` trains and resumes,
`eval.load_model` rebuilds the network from the checkpoint's sidecar, and
`serving.export_inference` exports and serves its depth network. The
configuration is bf16; the CPU runs it in float32 (--fp32), since the
CPU's bf16 convolutions give NaN weight gradients where a map is 1×1 (the
PoseNet's last at this size). One run of the command line for the module:
130 M parameters make a 1.5 GB checkpoint with Adam's moments."""

import json

import numpy as np
import pytest
import torch

from monodepth2_torch import cli
from monodepth2_torch.models import PackNetModel

W, H = 64, 32


def _train(tmp, max_steps):
    cli.main(["train", "--config", "configs/kitti_packnet01_640.json", "--device", "cpu", "--fp32",
              "--width", str(W), "--height", str(H), "--batch-size", "2", "--steps-per-call", "1",
              "--synthetic-n", "4", "--max-steps", str(max_steps),
              "--log-dir", str(tmp / "logs"), "--save-dir", str(tmp / "models")])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two steps, then a resumed run to four: (directory, output)."""
    tmp = tmp_path_factory.mktemp("packnet")
    _train(tmp, 2)
    first = sorted(p.name for p in (tmp / "models").iterdir())
    _train(tmp, 4)
    yield tmp, first
    for p in (tmp / "models").iterdir():
        p.unlink()


def test_cli_trains_and_resumes(trained):
    tmp, first = trained
    assert first == ["ckpt-2.json", "ckpt-2.npz"]
    meta = json.loads((tmp / "models" / "ckpt-4.json").read_text())
    assert meta["step"] == 4
    cfg = json.loads(meta["config"])
    assert cfg["architecture"] == "packnet01" and cfg["in_channels"] == 3 and cfg["target_size"] == [W, H]
    with np.load(tmp / "models" / "ckpt-4.npz") as data:
        assert int(data["train_step"]) == 4
        assert "model/depth_net.pack1.conv3d.weight" in data.files


def test_load_model_rebuilds_packnet_from_the_sidecar(trained):
    from monodepth2_torch.eval import load_model
    from monodepth2_torch.training import TrainConfig

    tmp, _ = trained
    path = str(tmp / "models" / "ckpt-4")
    # the caller's configuration names the ResNet; the sidecar's architecture wins
    model = load_model(TrainConfig(target_size=(W, H)), path, device="cpu")
    assert isinstance(model, PackNetModel) and not model.training
    with np.load(path + ".npz") as data:
        for k, v in model.state_dict().items():
            assert np.array_equal(v.numpy(), data[f"model/{k}"]), k


def test_export_serves_the_depth_network(trained, tmp_path):
    from monodepth2_torch.eval import load_model, make_infer_fn, sidecar_config
    from monodepth2_torch.serving import export_inference, load_inference

    tmp, _ = trained
    path = str(tmp / "models" / "ckpt-4")
    cfg = sidecar_config(path)
    model = load_model(cfg, path, device="cpu")
    assert cfg.target_size == (W, H) and cfg.compute_dtype == "float32"
    artifact = str(tmp_path / "packnet.pt2")
    export_inference(model, cfg, artifact)
    served = load_inference(artifact, device="cpu")
    assert served.meta["architecture"] == "packnet01" and served.meta["input_shape"] == [None, H, W, 3]
    x = torch.rand(3, H, W, 3, generator=torch.Generator().manual_seed(4))
    out = served(x)
    live = make_infer_fn(model)(x)
    assert out["disparity"].shape == (3, H, W, 1)
    torch.testing.assert_close(out["disparity"][..., 0], live, rtol=1e-5, atol=1e-6)
