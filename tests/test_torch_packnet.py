"""PackNet-SfM's networks in the port (models/packnet.py) against the
benchmark's plain float32 reference (benchmark/reference/packnet.py) on the
CPU: the published widths at 64×32 RGB frames, batch 2, on seeded random
weights. The parameter counts, the packing's channel order, the forward,
the loss and its gradients, a scanned step's Adam updates, the weights'
draw, the configuration field, the benchmark cell's work and the spans.
One model and one reference for the module: 130 M parameters take half a
gigabyte a copy."""

import copy
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import inputs, spec
from benchmark.reference import packnet as ref_packnet
from benchmark.reference import train as ref_train
from monodepth2_torch.models import PackNetModel, create_model
from monodepth2_torch.models.packnet import Pack, Unpack
from monodepth2_torch.training import TrainConfig, TrainContext, make_scanned_train_step, train_loss
from monodepth2_torch.training.state import create_train_state
from monodepth2_torch.utils import profiler

CELL = "kitti640_packnet_b4_train_mem"
W, H, N = 64, 32, 2
K = np.array([[40.0, 0, W / 2], [0, 38.0, H / 2], [0, 0, 1]])


@pytest.fixture(scope="module")
def pair():
    """(benchmark config, TrainConfig, context, reference, program, frames):
    the cell's configuration at 64×32, batch 2, float32; the program holds
    the reference's weights."""
    cfg = dict(spec.cell(CELL).config, target_size=[W, H], batch_size=N, compute_dtype="float32")
    names = set(TrainConfig.__dataclass_fields__)
    tcfg = TrainConfig.from_json(json.dumps({k: v for k, v in cfg.items() if k in names}))
    gen = inputs.generator(2**31 + 11, torch.device("cpu"))
    ref = ref_packnet.Model(3)
    ref_packnet.fill_weights(ref, gen)
    prog = create_model(tcfg, device="cpu")
    prog.load_state_dict(ref.state_dict(), strict=True)
    frames = inputs.triplets(inputs.panorama(8, H, W, 3, 2, gen, torch.device("cpu")), N, W, 2, start=2)
    return cfg, tcfg, TrainContext.create(K, W, H, device="cpu"), ref, prog, frames


def test_parameter_counts_are_the_published(pair):
    prog = pair[4]
    assert isinstance(prog, PackNetModel)
    assert sum(p.numel() for p in prog.depth_net.parameters()) == 128_294_020
    assert sum(p.numel() for p in prog.pose_net.parameters()) == 1_588_790


def test_packing_is_the_sources_view_permute():
    x = torch.arange(2 * 3 * 6 * 10, dtype=torch.float32).reshape(2, 3, 6, 10)
    packed = F.pixel_unshuffle(x, 2)
    assert torch.equal(packed, ref_packnet.packing(x))
    # channel c·4 + i·2 + j holds the pixels (2y + i, 2x + j) of channel c
    for c, i, j in ((0, 0, 1), (2, 1, 0), (1, 1, 1)):
        assert torch.equal(packed[:, c * 4 + i * 2 + j], x[:, c, i::2, j::2])


def test_forward_matches_the_reference(pair):
    _, _, _, ref, prog, frames = pair
    with torch.no_grad():
        d_ref, p_ref = ref.train()(frames)
        d_prog, p_prog = prog.train()(frames)
    assert [d.shape for d in d_prog] == [(N, H // 8, W // 8, 1), (N, H // 4, W // 4, 1), (N, H // 2, W // 2, 1),
                                         (N, H, W, 1)]
    # float32 on both sides; the two convolution paths sum in other orders
    for a, b in zip(d_ref, d_prog):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
    for (ra, ta), (rb, tb) in zip(p_ref, p_prog):
        torch.testing.assert_close(rb, ra, rtol=1e-4, atol=1e-7)
        torch.testing.assert_close(tb, ta, rtol=1e-4, atol=1e-7)


def test_loss_and_gradients_match_the_reference(pair):
    cfg, tcfg, ctx, ref, prog, frames = pair
    ref.zero_grad()
    prog.zero_grad()
    l_ref = ref_train.loss(ref, frames, torch.tensor(K, dtype=torch.float32), cfg, 0)
    l_prog, _ = train_loss(prog, frames, ctx, tcfg)
    l_ref.backward()
    l_prog.backward()
    assert abs(l_ref.item() - l_prog.item()) <= 1e-5 * abs(l_ref.item())
    grads = dict(prog.named_parameters())
    norms = {n: float(p.grad.norm()) for n, p in ref.named_parameters()}
    median = float(np.median(list(norms.values())))
    # each leaf's error over the larger of its norm and the median leaf's: a
    # bias that GroupNorm cancels (the pose network's first, one channel a
    # group) has a gradient of round-off alone. float32 on both sides, the
    # convolutions summed in other orders: errors of ~2e-5
    worst = max(float((p.grad - grads[n].grad).norm()) / max(norms[n], median) for n, p in ref.named_parameters())
    assert worst < 1e-4


def test_a_scanned_step_makes_the_references_updates(pair):
    """Two micro-steps of the scanned step (the CPU's eager path) against
    two of the reference's Adam updates from the same weights."""
    cfg, tcfg, ctx, ref, prog, frames = pair
    start = {n: p.detach().clone() for n, p in ref.named_parameters()}
    batches = torch.stack([frames, frames.flip(0)])
    state = create_train_state(copy.deepcopy(prog), tcfg)
    state.model.load_state_dict(ref.state_dict())
    state, metrics, _ = make_scanned_train_step(ctx, tcfg)(state, batches)
    twin = copy.deepcopy(ref)
    first = {}

    def record(i, model, adam, seen):
        if i == 1:
            first.update((n, float(m.norm())) for (n, _), m in zip(model.named_parameters(), adam.m))

    losses, _ = ref_train.follow(twin, batches, torch.tensor(K, dtype=torch.float32), cfg, 0, 2,
                                 ref_train.Adam(twin.parameters()), record)
    np.testing.assert_allclose(metrics["loss"].numpy(), losses, rtol=1e-5)
    got = dict(state.model.named_parameters())
    # leaves whose gradient is under 1e-3 of the median leaf's (a bias that
    # GroupNorm cancels) move by round-off that Adam scales up to lr, as the
    # benchmark's comparison leaves them out
    floor = 1e-3 * float(np.median(list(first.values())))
    changes = [abs(float((got[n].detach() - start[n]).norm() / (p.detach() - start[n]).norm()) - 1)
               for n, p in twin.named_parameters() if first[n] >= floor]
    assert len(changes) >= len(first) - 2
    # Adam's update is about lr·sign(g) wherever |g| ≫ ε, so its norm takes
    # little of the gradients' round-off: ~1e-4 at the median leaf
    assert np.median(changes) < 1e-3
    assert max(changes) < 1e-2


def test_weights_are_drawn_from_the_seed():
    from monodepth2_torch.nn.core import reset_parameters

    a, b = Pack(16, 3), Unpack(32, 32)
    for m in (a, b):
        with torch.no_grad():
            for p in m.parameters():
                p.fill_(7.0)
    reset_parameters(a, torch.Generator().manual_seed(5))
    reset_parameters(b, torch.Generator().manual_seed(5))
    limit = (6.0 / (27 * (1 + 8))) ** 0.5
    for m in (a, b):
        w = m.conv3d.weight.detach()
        assert w.abs().max() <= limit and w.abs().max() > 0.9 * limit and float(w.std()) > 0.4 * limit
        assert not m.conv3d.bias.any()
        assert torch.equal(m.conv.norm.weight, torch.ones_like(m.conv.norm.weight))
        assert not m.conv.norm.bias.any()
    again = Pack(16, 3)
    reset_parameters(again, torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), again.state_dict().values()))


@pytest.mark.gpu
def test_a_seed_draws_the_same_weights_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from monodepth2_torch.nn.core import reset_parameters

    cpu, card = Pack(16, 3), Pack(16, 3).cuda()
    reset_parameters(cpu, torch.Generator().manual_seed(9))
    reset_parameters(card, torch.Generator().manual_seed(9))
    for (name, x), y in zip(cpu.state_dict().items(), card.state_dict().values()):
        assert torch.equal(x, y.cpu()), name


def test_architecture_round_trips_and_an_unknown_one_is_refused():
    cfg = TrainConfig(architecture="packnet01", in_channels=3, target_size=(640, 192))
    assert json.loads(cfg.to_json())["architecture"] == "packnet01"
    assert TrainConfig.from_json(cfg.to_json()) == cfg
    assert "architecture" not in json.loads(TrainConfig().to_json())
    assert TrainConfig.from_json(TrainConfig().to_json()).architecture == "monodepth2"
    with pytest.raises(ValueError, match="architecture"):
        TrainConfig(architecture="packnet02")
    with pytest.raises(ValueError, match="scale levels"):
        create_model(TrainConfig(architecture="packnet01", scale_levels=(3, 4, 5)), device="cpu")


def test_the_cell_loads_and_counts_its_work():
    cell = spec.cell(CELL)
    assert cell.config["architecture"] == "packnet01" and cell.traffic["kind"] == "train_arch"
    assert spec.kind(cell.traffic).Session
    assert ref_packnet.step_flops(cell.config) == pytest.approx(4.9e12, abs=0.1e12)
    # 13.0 M elements of 3-D convolution input an image, 27 passes of 2 bytes
    assert sum(ref_packnet.pack3d_volumes({**cell.config, "batch_size": 1})) == 12_994_560
    assert ref_packnet.pack3d_bytes(cell.config) == 27 * 2 * 4 * 12_994_560


def test_the_spans_mark_the_forward(pair):
    prog = pair[4]
    profiler.reset()
    profiler.record(True)
    try:
        with torch.no_grad():
            prog.eval_disparity(torch.rand(1, H, W, 3))
            prog(torch.rand(1, 3, H, W, 3))
    finally:
        profiler.record(False)
    spans = profiler.snapshot()["spans"]
    profiler.reset()
    assert {k: spans[k]["count"] for k in ("depth_net", "depth_net.pack", "depth_net.unpack", "pose_net")} == {
        "depth_net": 2, "depth_net.pack": 10, "depth_net.unpack": 10, "pose_net": 1}


def test_a_jax_checkpoint_cannot_load_into_packnet(pair, tmp_path):
    from monodepth2_torch.bridge import load_jax_checkpoint

    with pytest.raises(ValueError, match="ResNet Monodepth2 model only"):
        load_jax_checkpoint(str(tmp_path / "ckpt-1"), pair[4])
