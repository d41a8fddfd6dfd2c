"""monodepth2_torch's command line (python -m monodepth2_torch.cli) against
the JAX package's (monodepth2_tpu/cli.py), on the CPU with --device cpu at
64×32: the same subcommands and flags; the same TrainConfig JSON from the
same argv; eval-depth's metrics on one JAX-package checkpoint within the
eval tests' tolerance (1e-4 rel, 1e-5 abs); the per-item-K auto-enable;
counterparts of tests/test_cli.py's four tests; the refusals the port adds
(--mesh N in a group of another size, an export to a list of platforms, a
card it does not have); and simple-depth and profile writing their
outputs."""

import json
import os
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

import monodepth2_tpu.cli as jcli
from monodepth2_torch import cli
from monodepth2_torch.data import DChain, SyntheticTriplets
from monodepth2_torch.models import Model
from monodepth2_torch.serving import read_meta
from monodepth2_torch.training import TrainConfig
from monodepth2_torch.training import create_train_state, save_checkpoint
from test_cli import kitti_root  # noqa: F401  (fixture: the same miniature KITTI tree)

W, H = 64, 32
TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(main, argv, capsys) -> str:
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def _help(main, argv, capsys) -> str:
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        main([*argv, "--help"])
    assert e.value.code == 0
    return capsys.readouterr().out


SUBCOMMANDS = ("train", "export", "serve", "eval-image", "eval-video", "simple-depth", "eval-depth", "profile",
               "refine-dtk")


def test_help_lists_the_same_subcommands(capsys):
    listed = [re.search(r"\{([a-z,-]+)\}", _help(m, [], capsys)).group(1).split(",") for m in (jcli.main, cli.main)]
    assert listed[0] == listed[1] == list(SUBCOMMANDS)


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_each_subcommand_takes_the_jax_flags_and_device(cmd, capsys):
    flags = [set(re.findall(r"(?<![\w-])(--[a-z0-9][a-z0-9-]*)", _help(m, [cmd], capsys))) for m in (jcli.main, cli.main)]
    assert flags[1] - flags[0] == {"--device"}
    assert flags[0] <= flags[1]


# ------------------------------------------------------------ config parity


def _jax_args(argv, monkeypatch):
    """The argparse namespace monodepth2_tpu.cli.main builds for argv."""
    seen = []
    for name in ("cmd_train", "cmd_export", "cmd_eval_depth", "cmd_profile"):
        monkeypatch.setattr(jcli, name, seen.append)
    jcli.main(argv)
    return seen[0]


CONFIG_FILE = {"lr": 3e-4, "target_size": [128, 64], "scale_levels": [3, 4, 5], "compute_dtype": "bfloat16",
               "disp_reg": 0.01, "log_every": 7, "per_item_K": True}
CONFIG_ARGV = {
    "defaults": ["train"],
    "config_file": ["train", "--config", "{cfg}"],
    "flags_over_file": ["train", "--config", "{cfg}", "--lr", "1e-3", "--width", "64", "--height", "32",
                        "--no-per-item-k"],
    "repo_config": ["train", "--config", os.path.join(ROOT, "configs", "kitti_ssl.json")],
    "bf16": ["train", "--bf16"],
    "fp32": ["train", "--fp32"],
    "fp32_over_bf16": ["profile", "--bf16", "--fp32"],
    "width_with_height": ["train", "--width", "640", "--height", "192"],
    "width_alone": ["train", "--width", "640"],
    "per_item_k": ["train", "--per-item-k"],
    "no_per_item_k": ["train", "--no-per-item-k"],
    "every_field": ["train", "--batch-size", "2", "--lr", "2e-4", "--epochs", "3", "--encoder-depth", "34",
                    "--in-channels", "3", "--automasking", "--min-depth", "1", "--max-depth", "80",
                    "--grad-clip", "1.5", "--lr-warmup-steps", "10", "--lr-decay-steps", "20",
                    "--lr-decay-factor", "0.5", "--disp-reg", "0.02", "--disp-reg-steps", "100",
                    "--pose-tz-init", "-0.1", "--steps-per-call", "4", "--debug-nans", "--log-dir", "l",
                    "--save-dir", "s", "--seed", "3"],
    "eval_depth": ["eval-depth", "--checkpoint", "c", "--synthetic", "--in-channels", "3", "--max-depth", "50"],
    "export": ["export", "--checkpoint", "c", "--config", "{cfg}", "--batch", "4"],
}


@pytest.mark.parametrize("case", list(CONFIG_ARGV))
def test_build_config_matches_jax(case, tmp_path, monkeypatch):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(CONFIG_FILE))
    argv = [a.format(cfg=cfg_path) for a in CONFIG_ARGV[case]]
    want = jcli._build_config(_jax_args(argv, monkeypatch))
    args = cli.build_parser().parse_args(argv)
    got = cli._build_config(args)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert cli._explicit_config(args) == jcli._explicit_config(_jax_args(argv, monkeypatch))


# --------------------------------------------------- per-item K auto-enable


def _K(f, w, h):
    return np.asarray([[f, 0, w / 2], [0, f * 1.1, h / 2], [0, 0, 1.0]])


class _TaggedDS:
    target_id, source_ids = 1, (0, 2)

    def __init__(self, K):
        self.K = K

    def __len__(self):
        return 3

    def __getitem__(self, i, rng=None):
        return np.zeros((3, H, W, 1), np.float32)


class _NoK:
    target_id, source_ids = 1, (0, 2)

    def __len__(self):
        return 2

    def __getitem__(self, i, rng=None):
        return np.zeros((3, H, W, 1), np.float32)


def test_auto_per_item_k_enabling():
    """The cases of tests/test_per_item_k.py::test_auto_per_item_k_enabling
    on the port's datasets: a heterogeneous chain turns per_item_K on,
    explicit settings either way win, homogeneous data and a chain with a
    K-less child leave it off."""
    a = SyntheticTriplets(n=2, target_size=(W, H), seed=0)
    b = SyntheticTriplets(n=2, target_size=(W, H), seed=7)
    b.K = _K(float(a.K[0, 0]) * 0.8, W, H)
    b.invK = np.linalg.inv(b.K)
    chain = DChain([a, b])
    homo = SyntheticTriplets(n=2, target_size=(W, H))
    cfg = TrainConfig(target_size=(W, H))
    assert not cfg.per_item_K

    assert cli._auto_per_item_k(cfg, chain, {}).per_item_K is True
    assert cli._auto_per_item_k(cfg, homo, {}).per_item_K is False
    assert cli._auto_per_item_k(cfg, chain, {"per_item_K": False}).per_item_K is False
    cfg_on = TrainConfig(target_size=(W, H), per_item_K=True)
    assert cli._auto_per_item_k(cfg_on, homo, {"per_item_K": True}).per_item_K is True

    mixed = DChain([DChain([_TaggedDS(_K(100.0, W, H)), _TaggedDS(_K(200.0, W, H))]), _NoK()])
    assert mixed.heterogeneous_K and not mixed.supports_item_K
    assert cli._auto_per_item_k(cfg, mixed, {}).per_item_K is False


# ------------------------------------------- tests/test_cli.py counterparts


def test_cli_train_kitti(kitti_root, tmp_path, capsys):  # noqa: F811
    save_dir = str(tmp_path / "ckpts")
    out = _run(cli.main, ["train", "--data", "kitti", "--root", kitti_root, "--width", "64", "--height", "32",
                          "--batch-size", "2", "--max-steps", "2", "--no-resume", "--save-dir", save_dir,
                          "--log-dir", str(tmp_path / "logs"), "--device", "cpu"], capsys)
    assert "done at step 2" in out
    assert os.path.exists(os.path.join(save_dir, "ckpt-2.npz"))


def test_cli_train_synthetic_and_eval_depth(tmp_path, capsys):
    save_dir = str(tmp_path / "ckpts")
    out = _run(cli.main, ["train", "--data", "synthetic", "--synthetic-n", "4", "--width", "64", "--height", "32",
                          "--batch-size", "2", "--max-steps", "1", "--no-resume", "--save-dir", save_dir,
                          "--log-dir", str(tmp_path / "logs"), "--device", "cpu"], capsys)
    assert "done at step 1" in out
    metrics = json.loads(_run(cli.main, ["eval-depth", "--checkpoint", os.path.join(save_dir, "ckpt-1"),
                                         "--synthetic", "--limit", "2", "--width", "64", "--height", "32",
                                         "--device", "cpu"], capsys))
    assert "abs_rel" in metrics and np.isfinite(metrics["abs_rel"])


def _port_checkpoint(path, **kw):
    cfg = TrainConfig(target_size=(W, H), in_channels=1, **kw)
    state = create_train_state(Model.create(in_channels=1, device="cpu"), cfg)
    save_checkpoint(path, state, metadata={"config": cfg.to_json()})


def test_cli_export_derives_spec_from_checkpoint_sidecar(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt-1")
    _port_checkpoint(ckpt)
    out = str(tmp_path / "depth.pt2")
    _run(cli.main, ["export", "--checkpoint", ckpt, "--out", out, "--platforms", "cpu", "--device", "cpu"], capsys)
    meta = read_meta(out)
    assert meta["input_shape"] == [None, H, W, 1]  # the sidecar's H/W/C
    assert meta["encoder_depth"] == 18 and meta["platforms"] == ["cpu"]


def test_cli_export_respects_config_file_over_sidecar(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt-1")
    _port_checkpoint(ckpt, max_depth=100.0)
    cfg_file = tmp_path / "serve.json"
    cfg_file.write_text(json.dumps({"max_depth": 80.0}))
    out = str(tmp_path / "depth.pt2")
    _run(cli.main, ["export", "--checkpoint", ckpt, "--out", out, "--config", str(cfg_file), "--device", "cpu"],
         capsys)
    meta = read_meta(out)
    assert meta["max_depth"] == 80.0  # the config file won
    assert meta["input_shape"] == [None, H, W, 1]  # the sidecar kept the rest


# --------------------------------------------------- eval-depth against JAX


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX-package checkpoint at 64×32, gray, batch 2, written as the JAX
    trainer writes one (sidecar with the config), with no training step."""
    from monodepth2_tpu.models import Model as JModel
    from monodepth2_tpu.training import TrainConfig as JConfig
    from monodepth2_tpu.training import create_train_state as j_create_train_state
    from monodepth2_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint

    cfg = JConfig(target_size=(W, H), in_channels=1, batch_size=2)
    state, _ = j_create_train_state(JModel.create(in_channels=1), cfg)
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "ckpt-0")
    j_save_checkpoint(path, state, metadata={"config": cfg.to_json()})
    return path


def test_eval_depth_matches_jax_cli(jax_checkpoint, capsys, monkeypatch):
    argv = ["eval-depth", "--checkpoint", jax_checkpoint, "--synthetic", "--limit", "2"]
    want = json.loads(_run(jcli.main, argv, capsys))
    got = json.loads(_run(cli.main, [*argv, "--device", "cpu"], capsys))
    assert got.keys() == want.keys()
    for k in want:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    # the checkpoint's sidecar and an explicit flag resolve alike
    argv = ["eval-depth", "--checkpoint", jax_checkpoint, "--max-depth", "50"]
    port = cli._resolve_checkpoint_config(cli.build_parser().parse_args(argv))
    assert json.loads(port.to_json()) == json.loads(jcli._resolve_checkpoint_config(_jax_args(argv, monkeypatch)).to_json())


# ------------------------------------------------------------- refusals


def test_mesh_in_one_process_refuses_with_the_torchrun_line(tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["train", "--mesh", "2", "--width", "64", "--height", "32", "--save-dir", str(tmp_path / "c"),
                  "--device", "cpu"])
    assert "torchrun --nproc-per-node 2 -m monodepth2_torch.cli train" in str(e.value.code)
    assert not (tmp_path / "c").exists() and not dist.is_initialized()


def test_mesh_of_another_size_than_the_group_refuses(tmp_path, monkeypatch):
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": "1", "RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        cli.main(["train", "--distributed", "--mesh", "2", "--width", "64", "--height", "32", "--synthetic-n", "2",
                  "--save-dir", str(tmp_path / "c"), "--device", "cpu"])
    assert "the process group has 1" in str(e.value.code) and "torchrun --nproc-per-node 2" in str(e.value.code)
    assert not (tmp_path / "c").exists() and not dist.is_initialized()


def test_export_to_a_list_of_platforms_refuses(tmp_path):
    ckpt = str(tmp_path / "ckpt-1")
    _port_checkpoint(ckpt)
    for platforms, why in (("tpu,cpu", "runs only on the device type it was traced on"),
                           ("cuda", "pass --device cuda")):
        with pytest.raises(SystemExit) as e:
            cli.main(["export", "--checkpoint", ckpt, "--out", str(tmp_path / "a.pt2"), "--platforms", platforms,
                      "--device", "cpu"])
        assert why in str(e.value.code)
    assert not (tmp_path / "a.pt2").exists()


@pytest.mark.parametrize("argv", [
    ["train", "--max-steps", "1"],
    ["export", "--checkpoint", "c"],
    ["serve", "--artifact", "a.pt2"],
    ["eval-image", "--checkpoint", "c", "--images", "."],
    ["eval-video", "--checkpoint", "c", "--video", "v.mp4"],
    ["simple-depth"],
    ["eval-depth", "--checkpoint", "c", "--synthetic"],
    ["profile"],
    ["refine-dtk", "--root", ".", "--files", "f"],
], ids=lambda a: a[0])
def test_missing_card_refuses(argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert "--device cuda" in str(e.value.code) and "CUDA" in str(e.value.code)
    assert os.listdir(tmp_path) == []


# ------------------------------------------------- simple-depth and profile


def test_simple_depth_writes_its_pngs(tmp_path, capsys):
    out = _run(cli.main, ["simple-depth", "--iters", "3", "--out", str(tmp_path / "sd"), "--device", "cpu"], capsys)
    assert "iter 1: loss" in out and "final loss:" in out
    assert sorted(os.listdir(tmp_path / "sd")) == ["d-1.png"]


def test_profile_writes_a_host_trace(tmp_path, capsys):
    out = _run(cli.main, ["profile", "--steps", "1", "--width", "64", "--height", "32", "--batch-size", "2",
                          "--out", str(tmp_path / "prof"), "--device", "cpu"], capsys)
    assert "trace written" in out
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert events and not [e for e in events if e.get("cat") == "kernel"]  # host events only
