"""The reference against monodepth2_torch at a tiny size on the CPU: the
same weights give the same disparities, poses, loss, gradients and Adam
update in float32. This test imports both; the reference imports neither
the program nor JAX."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import train as ref_train
from benchmark.reference.model import Model as RefModel

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "kitti416_r18_b4.json"
W, H = 128, 64


@pytest.fixture(scope="module")
def pair():
    from monodepth2_torch.models import Model
    from monodepth2_torch.training import TrainConfig, TrainContext

    cfg = json.loads(CONFIG.read_text())
    cfg.update(target_size=[W, H], batch_size=2, compute_dtype="float32")
    gen = inputs.generator(2**31 + 3, torch.device("cpu"))
    ref = RefModel(1, tuple(cfg["scale_levels"]))
    inputs.fill_weights(ref, gen)
    prog = Model.create(depth=18, in_channels=1, device="cpu")
    prog.load_state_dict(ref.state_dict(), strict=True)
    frames = inputs.triplets(inputs.panorama(8, H, W, 1, 2, gen, torch.device("cpu")), 2, W, 2, start=3)
    K = np.array([[90.0, 0, W / 2], [0, 88.0, H / 2], [0, 0, 1]])
    names = {f for f in TrainConfig.__dataclass_fields__}
    tcfg = TrainConfig.from_json(json.dumps({k: v for k, v in cfg.items() if k in names}))
    ctx = TrainContext.create(K, W, H, device="cpu")
    return cfg, tcfg, ctx, ref, prog, frames, K


def test_forward_matches_the_program(pair):
    _, _, _, ref, prog, frames, _ = pair
    ref.train()
    prog.train()
    with torch.no_grad():
        d_ref, p_ref = ref(frames)
        d_prog, p_prog = prog(frames)
    for a, b in zip(d_ref, d_prog):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for (ra, ta), (rb, tb) in zip(p_ref, p_prog):
        torch.testing.assert_close(ra, rb, rtol=1e-4, atol=1e-8)
        torch.testing.assert_close(ta, tb, rtol=1e-4, atol=1e-8)


def test_loss_and_gradients_match_the_program(pair):
    from monodepth2_torch.training import train_loss
    from monodepth2_torch.training.state import disp_reg_schedule

    cfg, tcfg, ctx, ref, prog, frames, K = pair
    ref.zero_grad()
    prog.zero_grad()
    l_ref = ref_train.loss(ref, frames, torch.tensor(K, dtype=torch.float32), cfg, 7)
    l_prog, _ = train_loss(prog, frames, ctx, tcfg, disp_reg_weight=disp_reg_schedule(tcfg, torch.tensor(7)))
    l_ref.backward()
    l_prog.backward()
    assert abs(l_ref.item() - l_prog.item()) <= 1e-6 * abs(l_ref.item())
    grads = dict(prog.named_parameters())
    for name, p in ref.named_parameters():
        err = float((p.grad - grads[name].grad).norm() / p.grad.norm().clamp(min=1e-20))
        assert err < 1e-3, (name, err)


def test_group_gradients_add_up_to_the_gradient(pair):
    cfg, _, _, ref, _, frames, K = pair
    params = list(ref.parameters())
    ref.zero_grad()
    K = torch.tensor(K, dtype=torch.float32)
    ref_train.loss(ref, frames, K, cfg, 7).backward()
    full = [p.grad.clone() for p in params]
    groups = ref_train.group_gradients(params, ref_train.row_losses(ref, frames, K, cfg, 7), 2)
    assert len(groups) == 2
    for f, a, b in zip(full, *groups):
        assert float(((a + b) / 2 - f).norm()) <= 1e-4 * float(a.norm() + b.norm() + 1e-12)
    # the rows differ, so their gradients do
    assert sum(float((a - b).norm()) for a, b in zip(*groups)) > 1e-3 * sum(float(f.norm()) for f in full)


def test_adam_matches_torch():
    gen = torch.Generator().manual_seed(0)
    a = [torch.randn(5, 3, generator=gen, requires_grad=True), torch.randn(7, generator=gen, requires_grad=True)]
    b = [x.detach().clone().requires_grad_() for x in a]
    mine = ref_train.Adam(a)
    theirs = torch.optim.Adam(b, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(4):
        grads = [torch.randn(x.shape, generator=gen) for x in a]
        for x, y, g in zip(a, b, grads):
            x.grad, y.grad = g.clone(), g.clone()
        mine.step(1e-3)
        theirs.step()
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)


def test_schedules_match_the_program():
    from monodepth2_torch.training import TrainConfig
    from monodepth2_torch.training.state import disp_reg_schedule, lr_at

    cfg = json.loads(CONFIG.read_text())
    names = {f for f in TrainConfig.__dataclass_fields__}
    tcfg = TrainConfig.from_json(json.dumps({k: v for k, v in cfg.items() if k in names}))
    for step in (0, 1, 2499, 2500, 28499, 28500):
        assert ref_train.learning_rate(cfg, step) == pytest.approx(lr_at(tcfg, step))
        assert ref_train.disp_reg_weight(cfg, step) == pytest.approx(float(disp_reg_schedule(tcfg, torch.tensor(step))), rel=1e-4, abs=1e-9)
