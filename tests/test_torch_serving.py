"""monodepth2_torch's serving artifacts (serving.py) on the CPU: export ->
load -> call against live inference at batch 1, 3 and 5 (1e-5 abs, as
tests/test_serving.py); the shape and fixed-batch refusals; the bf16
artifact against fp32 live (3e-2 abs, depth 0.1 relative); the port's
artifact against the JAX package's on the same weights carried over by
bridge.py (1e-4 abs); a process that serves the artifact with neither jax
nor the port's model code imported; and the refusals of a device the
artifact was not exported on, or a card that is not there."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monodepth2_torch.bridge import params_to_jax
from monodepth2_torch.models import Model
from monodepth2_torch.serving import export_inference, load_inference, make_inference_fn, read_meta
from monodepth2_torch.training import TrainConfig
from monodepth2_tpu.models import Model as JModel
from monodepth2_tpu.serving import export_inference as jax_export_inference
from monodepth2_tpu.serving import load_inference as jax_load_inference
from monodepth2_tpu.training import TrainConfig as JTrainConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
W, H = 64, 32


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """One fp32 export of a tiny-size model (weights from seed 3, BN stats
    away from their init), shared by the module."""
    cfg = TrainConfig(target_size=(W, H), in_channels=1)
    model = Model.create(depth=18, in_channels=1, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.randn(buf.shape, generator=gen) * 0.1)
        elif name.endswith("running_var"):
            buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    path = str(tmp_path_factory.mktemp("serving") / "depth.pt2")
    export_inference(model, cfg, path)
    return cfg, model, path


def _x(n, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, H, W, 1)).astype(np.float32)


def _live(model, cfg, x):
    with torch.inference_mode():
        return make_inference_fn(model, cfg)(torch.from_numpy(x))


def test_export_load_roundtrip_dynamic_batch(artifact):
    """One artifact (dynamic batch) serves any N; outputs match live."""
    cfg, model, path = artifact
    assert os.path.getsize(path) > 1_000_000  # the weights are inside
    served = load_inference(path, device="cpu")
    assert served.meta["outputs"] == ["disparity", "depth"]
    assert served.meta["input_shape"] == [None, H, W, 1]
    assert served.meta["platforms"] == ["cpu"]
    for n in (1, 3, 5):
        x = _x(n, seed=n)
        out, ref = served(x), _live(model, cfg, x)
        assert out["disparity"].shape == (n, H, W, 1) and out["disparity"].dtype == torch.float32
        for k in ("disparity", "depth"):
            np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-5)
    # a tensor input serves as an array does
    np.testing.assert_array_equal(served(torch.from_numpy(x))["depth"].numpy(), out["depth"].numpy())


def test_served_model_rejects_wrong_shape(artifact):
    cfg, _, path = artifact
    served = load_inference(path, device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        served(np.zeros((1, H * 2, W, 1), np.float32))
    with pytest.raises(ValueError, match="incompatible"):
        served(np.zeros((H, W, 1), np.float32))


def test_fixed_batch_artifact_refuses_other_batches(artifact, tmp_path):
    cfg, model, _ = artifact
    path = str(tmp_path / "fixed.pt2")
    export_inference(model, cfg, path, batch_size=2)
    served = load_inference(path, device="cpu")
    assert served.meta["input_shape"] == [2, H, W, 1]
    assert served(_x(2))["disparity"].shape == (2, H, W, 1)
    with pytest.raises(ValueError, match="fixed batch 2"):
        served(_x(3))


def test_export_bf16_artifact_parity(artifact, tmp_path):
    """compute_dtype "bfloat16" bakes a bf16 network into the artifact;
    outputs stay fp32 and track fp32 live within the bf16 bound."""
    cfg, model, _ = artifact
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    path = str(tmp_path / "depth-bf16.pt2")
    export_inference(model, cfg16, path, batch_size=2)
    served16 = load_inference(path, device="cpu")
    assert served16.meta["compute_dtype"] == "bfloat16"
    x = _x(2, seed=1)
    out, ref = served16(x), _live(model, cfg, x)
    assert out["disparity"].dtype == torch.float32
    np.testing.assert_allclose(out["disparity"].numpy(), ref["disparity"].numpy(), rtol=0, atol=3e-2)
    assert float((out["disparity"] - ref["disparity"]).abs().mean()) < 5e-3
    np.testing.assert_allclose(out["depth"].numpy(), ref["depth"].numpy(), rtol=0.1, atol=0)


def test_artifact_matches_the_jax_artifact(artifact, tmp_path):
    """The port's artifact and the JAX package's StableHLO artifact, exported
    from the same weights (bridge.params_to_jax), agree."""
    cfg, model, path = artifact
    params, stats = params_to_jax(model)
    for key in params:  # the decoders hold no BN: their stats are empty trees
        stats.setdefault(key, {})
    jcfg = JTrainConfig(target_size=(W, H), in_channels=1)
    jpath = str(tmp_path / "depth.mdtpu")
    jax_export_inference(JModel.create(depth=18, in_channels=1), params, stats, jcfg, jpath, platforms=("cpu",))
    x = _x(3, seed=2)
    got = load_inference(path, device="cpu")(x)
    want = jax_load_inference(jpath)(jnp.asarray(x))
    assert read_meta(path)["outputs"] == jax_load_inference(jpath).meta["outputs"]
    for k in ("disparity", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-4)


def test_artifact_serves_without_jax_or_model_code(artifact):
    """A fresh process loads the artifact and calls it with jax and the JAX
    package blocked, and never imports the port's model code."""
    cfg, model, path = artifact
    x = _x(2, seed=5)
    ref = _live(model, cfg, x)["disparity"].numpy()
    np.save(os.path.join(os.path.dirname(path), "x.npy"), x)
    np.save(os.path.join(os.path.dirname(path), "ref.npy"), ref)
    code = f"""
        import sys
        for name in ("jax", "jaxlib", "optax", "monodepth2_tpu"):
            sys.modules[name] = None  # any import of it now raises ImportError
        import numpy as np
        from monodepth2_torch.serving import load_inference
        served = load_inference({path!r}, device="cpu")
        d = served(np.load({os.path.dirname(path) + '/x.npy'!r}))["disparity"].numpy()
        np.testing.assert_allclose(d, np.load({os.path.dirname(path) + '/ref.npy'!r}), rtol=0, atol=1e-5)
        loaded = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "monodepth2_tpu")
                        and sys.modules[n] is not None)
        assert not loaded, loaded
        assert "monodepth2_torch.models" not in sys.modules
        print("served", d.shape)
    """
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "served (2, 32, 64, 1)" in proc.stdout


def test_load_inference_refuses_another_device_type(artifact, tmp_path):
    """An artifact whose meta names only the card is refused on the CPU
    before its program is read, and a missing card is refused."""
    _, _, path = artifact
    other = str(tmp_path / "cuda-only.pt2")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(other, "w") as dst:
        for item in src.infolist():
            data = src.read(item.filename)
            if item.filename.endswith("/extra/meta.json"):
                meta = json.loads(data)
                meta["platforms"] = ["cuda"]
                data = json.dumps(meta).encode()
            dst.writestr(item, data)
    assert read_meta(other)["platforms"] == ["cuda"]
    with pytest.raises(ValueError, match="exported on"):
        load_inference(other, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_inference(path)
        with pytest.raises(RuntimeError, match="CUDA"):
            load_inference(path, device="cuda")


def test_read_meta_refuses_other_files(tmp_path):
    path = str(tmp_path / "not-an-artifact.zip")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("archive/data.pkl", b"")
    with pytest.raises(ValueError, match="not an export_inference artifact"):
        read_meta(path)
