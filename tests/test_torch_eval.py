"""monodepth2_torch's eval harness against the JAX package's (monodepth2_tpu
/eval.py, utils/metrics.py), on the CPU: the depth metrics on the same
arrays; checkpoints the JAX package writes read without jax
(bridge.load_jax_checkpoint) into params and stats bit-equal to the JAX
package's own load_model, for two optax chains and for the trained
ResNet-18 under runs/; inference on those weights against the JAX
package's; and eval_images / eval_depth_accuracy / eval_video on the same
checkpoint. Tolerances: the models tests' forward tolerance (1e-4 rel,
1e-5 abs) for fp32 inference, 3e-2 abs for bf16 (the JAX package's own
bf16 bound), 1 level for PNG pixels, 1e-4 relative for the metrics."""

import dataclasses
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from monodepth2_torch import eval as teval
from monodepth2_torch.bridge import load_jax_checkpoint, params_to_jax
from monodepth2_torch.models import Model
from monodepth2_torch.training import TrainConfig as TConfig
from monodepth2_torch.training import create_train_state as t_create_train_state
from monodepth2_torch.training import save_checkpoint as t_save_checkpoint
from monodepth2_torch.utils.metrics import depth_metrics
from monodepth2_torch.utils.viz import _LUT
from monodepth2_tpu import eval as jeval
from monodepth2_tpu.models import Model as JModel
from monodepth2_tpu.training import TrainConfig, create_train_state
from monodepth2_tpu.training.checkpoint import save_checkpoint
from monodepth2_tpu.utils.metrics import depth_metrics as jax_depth_metrics

ROOT = pathlib.Path(__file__).resolve().parent.parent
TRAINED = ROOT / "runs" / "per_item_k" / "per_item_K" / "ckpts" / "ckpt-5002"
W, H = 64, 32
TOL = dict(rtol=1e-4, atol=1e-5)
CHAINS = {
    "adam": {},
    "warmup_decay_clip": dict(lr_warmup_steps=10, lr_decay_steps=20, grad_clip=1.0),
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def assert_trees_equal(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _perturbed(state, seed):
    """The state with noise from numpy on every param (the BN scales and
    biases are ones and zeros at init) and BN statistics redrawn (positive
    variances): bit-equality then tests the layout of distinct values."""
    rng = np.random.default_rng(seed)

    def noisy(x):
        x = np.asarray(x)
        return jax.numpy.asarray((x + rng.normal(0.0, 0.01, x.shape)).astype(np.float32))

    def stat(path, x):
        var = path[-1].key == "var"
        return jax.numpy.asarray(
            (rng.uniform(0.5, 1.5, np.shape(x)) if var else rng.normal(0.0, 0.1, np.shape(x))).astype(np.float32)
        )

    return state._replace(
        step=jax.numpy.asarray(7, jax.numpy.int32),
        params=jax.tree_util.tree_map(noisy, state.params),
        stats=jax.tree_util.tree_map_with_path(stat, state.stats),
    )


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """{chain: (cfg, path)}: a JAX checkpoint at 64×32 per optax chain, the
    way the JAX trainer writes it (sidecar with the config)."""
    out = {}
    model = JModel.create(in_channels=1)
    for i, (name, kw) in enumerate(CHAINS.items()):
        cfg = TrainConfig(target_size=(W, H), batch_size=2, **kw)
        state, _ = create_train_state(model, cfg)
        path = str(tmp_path_factory.mktemp(name) / "ckpt-7")
        save_checkpoint(path, _perturbed(state, i), metadata={"step": 7, "config": cfg.to_json()})
        out[name] = (cfg, path)
    return out


# ---------------------------------------------------------------- metrics


def _metric_cases():
    gt = np.random.default_rng(0).uniform(1.0, 50.0, (32, 32))
    gt1 = np.random.default_rng(1).uniform(1.0, 50.0, (32, 32))
    sparse = np.zeros((8, 8))
    sparse[0, 0] = 10.0
    return {
        "perfect": (gt, gt, {}),
        "median_scaling": (gt1 * 0.1, gt1, {}),
        "no_median_scaling": (gt1 * 0.1, gt1, {"median_scaling": False}),
        "invalid_gt_masked": (np.full((8, 8), 10.0), sparse, {}),
        "mask_and_range": (gt1 * 1.3, gt, {"mask": gt > 20, "min_depth": 2.0, "max_depth": 40.0}),
    }


@pytest.mark.parametrize("case", list(_metric_cases()))
def test_depth_metrics_match_jax(case):
    pred, gt, kw = _metric_cases()[case]
    got, want = depth_metrics(pred, gt, **kw), jax_depth_metrics(pred, gt, **kw)
    assert got == want
    if case == "perfect":
        assert got["abs_rel"] == pytest.approx(0.0, abs=1e-12) and got["a1"] == 1.0
    if case == "median_scaling":
        assert got["scale"] == pytest.approx(10.0, rel=1e-6) and got["abs_rel"] == pytest.approx(0.0, abs=1e-9)
    if case == "invalid_gt_masked":
        assert got["a1"] == 1.0


# ------------------------------------------------- JAX checkpoints, no jax


@pytest.mark.parametrize("chain", list(CHAINS))
def test_load_jax_checkpoint_bit_equal(jax_checkpoints, chain):
    """Params and stats bit-equal to the JAX package's load_model, for a
    plain Adam chain and for warmup + decay (a schedule count leaf) + clip."""
    cfg, path = jax_checkpoints[chain]
    _, params, stats = jeval.load_model(cfg, path)
    model = Model.create(device="cpu")
    model.load_state_dict(load_jax_checkpoint(path, model))
    got_params, got_stats = params_to_jax(model)
    assert_trees_equal(got_params, params)
    assert_trees_equal(got_stats, stats)


def _rewrite(src, dst, drop_last=False, config=None):
    with np.load(src + ".npz") as data:
        arrays = {k: data[k] for k in data.files}
    if drop_last:
        arrays.pop(sorted(arrays)[-1])
    np.savez(dst + ".npz", **arrays)
    with open(src + ".json") as f:
        meta = json.load(f)
    if config is not None:
        meta["config"] = config
    with open(dst + ".json", "w") as f:
        json.dump(meta, f)


@pytest.mark.parametrize("fault", ["leaf_missing", "chain_mismatch", "sidecar_count", "shape"])
def test_load_jax_checkpoint_refuses(jax_checkpoints, tmp_path, fault):
    """A leaf count that fits no optax chain (or not the sidecar's config),
    a count other than the sidecar's, or a param of another shape raises."""
    cfg, path = jax_checkpoints["warmup_decay_clip"]
    bad = str(tmp_path / "bad")
    model = Model.create(device="cpu")
    if fault == "leaf_missing":
        # one leaf fewer, the sidecar's n_leaves in step with it
        _rewrite(path, bad, drop_last=True)
        with open(bad + ".json") as f:
            meta = json.load(f)
        meta["n_leaves"] -= 1
        with open(bad + ".json", "w") as f:
            json.dump(meta, f)
        match = "no optax chain"
    elif fault == "chain_mismatch":
        # a schedule count in the file, none in the sidecar's config
        _rewrite(path, bad, config=dataclasses.replace(cfg, lr_warmup_steps=0, lr_decay_steps=0).to_json())
        match = "no optax chain"
    elif fault == "sidecar_count":
        _rewrite(path, bad, drop_last=True)
        match = "sidecar says"
    else:
        _rewrite(path, bad)
        model = Model.create(device="cpu", in_channels=3)  # conv1 takes 3 channels
        match = "param encoder"
    with pytest.raises(ValueError, match=match):
        load_jax_checkpoint(bad, model)


@pytest.fixture(scope="module")
def trained():
    """The trained ResNet-18 (416×128, bf16 training, fp32 masters) as the
    JAX package loads it, and 2 frames."""
    cfg = TrainConfig(target_size=(416, 128))
    jmodel, params, stats = jeval.load_model(cfg, str(TRAINED))
    x = np.random.default_rng(3).uniform(size=(2, 128, 416, 1)).astype(np.float32)
    return cfg, jmodel, params, stats, x


def test_trained_checkpoint_bit_equal_and_inference(trained):
    """runs/…/ckpt-5002: the port reads it without jax into the JAX
    package's params and stats bit for bit, and its fp32 inference on those
    weights matches the JAX package's; its bf16 inference stays within the
    bf16 bound of JAX's fp32."""
    cfg, jmodel, params, stats, x = trained
    model = teval.load_model(cfg, str(TRAINED), device="cpu")
    got_params, got_stats = params_to_jax(model)
    assert_trees_equal(got_params, params)
    assert_trees_equal(got_stats, stats)
    ref = np.asarray(jeval.make_infer_fn(jmodel, params, stats)(x))
    d32 = teval.make_infer_fn(model)(x)
    assert d32.dtype == torch.float32 and tuple(d32.shape) == (2, 128, 416)
    np.testing.assert_allclose(d32.numpy(), ref, **TOL)
    d16 = teval.make_infer_fn(model, "bfloat16")(x).numpy()
    assert d16.dtype == np.float32
    np.testing.assert_allclose(d16, ref, rtol=0, atol=3e-2)
    assert np.mean(np.abs(d16 - ref)) < 5e-3


def test_load_model_takes_the_architecture_from_the_sidecar(tmp_path):
    """A port checkpoint of ResNet-18 with 3 input channels loads as such
    whatever the caller's cfg says (the sidecar guard)."""
    cfg = TConfig(target_size=(W, H), in_channels=3)
    state = t_create_train_state(Model.create(in_channels=3, seed=5, device="cpu"), cfg)
    path = str(tmp_path / "ckpt-0")
    t_save_checkpoint(path, state, metadata={"step": 0, "config": cfg.to_json()})
    caller = TConfig(target_size=(W, H), in_channels=1, encoder_depth=50)
    model = teval.load_model(caller, path, device="cpu")
    assert model.encoder.depth == 18 and not model.training
    for (k, a), b in zip(model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(a, b), k


# ------------------------------------------------------ the eval harness


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(4)
    for i in range(3):
        Image.fromarray((rng.uniform(size=(H * 2, W * 2)) * 255).astype(np.uint8), "L").save(d / f"{i:06d}.png")
    return str(d)


def _pngs(d):
    """The names of the PNGs in d and, for each, its pixels' levels: the
    index of each pixel's colour in the heatmap's 256-entry LUT."""
    level = {tuple(int(c) for c in rgb): i for i, rgb in reversed(list(enumerate(_LUT)))}
    names = sorted(os.listdir(d))
    maps = []
    for n in names:
        rgb = np.asarray(Image.open(os.path.join(d, n)))
        assert rgb.shape == (H, W, 3)
        maps.append(np.asarray([level[tuple(int(c) for c in px)] for px in rgb.reshape(-1, 3)]))
    return names, maps


def test_eval_images_matches_jax(jax_checkpoints, frames_dir, tmp_path):
    cfg, path = jax_checkpoints["adam"]
    n = teval.eval_images(TConfig.from_json(cfg.to_json()), path, frames_dir, str(tmp_path / "t"), batch_size=2,
                          device="cpu")
    assert n == jeval.eval_images(cfg, path, frames_dir, str(tmp_path / "j"), batch_size=2) == 3
    (tn, tp), (jn, jp) = _pngs(tmp_path / "t"), _pngs(tmp_path / "j")
    assert tn == jn == ["d-0.png", "d-1.png", "d-2.png"]
    for a, b in zip(tp, jp):
        # each map is min-max normalized to 256 levels: fp32 rounding can move
        # a pixel across one
        assert np.abs(a - b).max() <= 1


def test_eval_depth_accuracy_matches_jax(jax_checkpoints):
    cfg, path = jax_checkpoints["adam"]
    rng = np.random.default_rng(5)
    images = [rng.uniform(size=(H, W, 1)).astype(np.float32) for _ in range(3)]
    gts = [rng.uniform(1.0, 60.0, (48, 96)) for _ in range(3)]
    got = teval.eval_depth_accuracy(TConfig.from_json(cfg.to_json()), path, images, gts, batch_size=2,
                                    device="cpu")
    want = jeval.eval_depth_accuracy(cfg, path, images, gts, batch_size=2)
    assert got.keys() == want.keys()
    for k in want:
        assert np.isfinite(got[k])
        assert got[k] == pytest.approx(want[k], rel=1e-4), k


def test_eval_video_matches_jax(jax_checkpoints, tmp_path):
    cv2 = pytest.importorskip("cv2")
    vid = str(tmp_path / "v.mp4")
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 5, (W, H))
    rng = np.random.default_rng(6)
    for _ in range(5):
        writer.write((rng.uniform(size=(H, W, 3)) * 255).astype(np.uint8))
    writer.release()
    cfg, path = jax_checkpoints["adam"]
    n = teval.eval_video(TConfig.from_json(cfg.to_json()), path, vid, str(tmp_path / "t"), batch_size=2, limit=4,
                         device="cpu")
    assert n == jeval.eval_video(cfg, path, vid, str(tmp_path / "j"), batch_size=2, limit=4) == 4
    (tn, tp), (jn, jp) = _pngs(tmp_path / "t"), _pngs(tmp_path / "j")
    assert tn == jn and len(tn) == 4
    for a, b in zip(tp, jp):
        assert np.abs(a - b).max() <= 1


def test_make_infer_fn_bf16_parity():
    """The port's bf16 inference tracks its fp32 inference within the JAX
    package's bf16 bound (tests/test_eval_utils.py)."""
    model = Model.create(device="cpu")
    x = np.random.default_rng(6).uniform(size=(2, H, W, 1)).astype(np.float32)
    d32 = teval.make_infer_fn(model)(x).numpy()
    d16 = teval.make_infer_fn(model, "bfloat16")(x).numpy()
    assert d16.dtype == np.float32 and d16.shape == (2, H, W)
    np.testing.assert_allclose(d16, d32, rtol=0, atol=3e-2)
    assert np.mean(np.abs(d16 - d32)) < 5e-3
    assert model.training  # the caller's model is left as it was
