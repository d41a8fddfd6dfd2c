"""Train state + train step, port of monodepth2_tpu/training/state.py.

The JAX TrainState carries (step, params, stats, opt_state, rng) and the step
returns a new one. Here the model holds the params and the BN statistics, the
optimizer holds the Adam moments, and the step updates both in place. The
step draws no random numbers, so the JAX state's PRNG key has no counterpart.
`make_scanned_train_step` (K steps per dispatch) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch
from torch import Tensor

from ..ops.losses import automasking_loss
from .config import TrainConfig, TrainContext
from .loss import train_loss


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module  # params + BatchNorm running statistics
    optimizer: torch.optim.Optimizer


def lr_at(cfg: TrainConfig, step: int) -> float:
    """Learning rate of update number `step` (0-based): linear warmup over
    `lr_warmup_steps`, then a one-time ×`lr_decay_factor` at `lr_decay_steps`
    (state.py:32-53; optax evaluates the schedule at its update count, which
    equals the train step for a state made by create_train_state)."""
    lr = cfg.lr
    if cfg.lr_warmup_steps > 0:
        lr *= min(step / cfg.lr_warmup_steps, 1.0)
    if cfg.lr_decay_steps > 0 and step >= cfg.lr_decay_steps:
        lr *= cfg.lr_decay_factor
    return lr


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g ← g / ‖g‖ · max_norm when the
    global norm ‖g‖ reaches max_norm."""
    grads = list(grads)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def create_train_state(
    model: torch.nn.Module, cfg: TrainConfig, generator: Optional[torch.Generator] = None
) -> TrainState:
    """Draw the model's weights from `generator` (default: seeded with
    cfg.seed), reset its BN statistics and pair it with Adam (optax.adam's
    defaults: b1 0.9, b2 0.999, eps 1e-8 added outside the square root)."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model.reset_parameters(generator)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(step=0, model=model, optimizer=optimizer)


def make_train_step(ctx: TrainContext, cfg: TrainConfig) -> Callable:
    """Build the train step: step_fn(state, batch) -> (state, metrics, aux).

    batch is frames (N,L,H,W,C), or {"frames": ..., "K": (N,3,3)} with
    per-item intrinsics. metrics hold `loss` and `mean_disparity` as device
    tensors; reading them synchronizes, so a loop reads them only to log.
    """

    def step_fn(state: TrainState, batch):
        if isinstance(batch, dict):
            frames, Ks = batch["frames"], batch["K"]
        else:
            frames, Ks = batch, None
        auto_loss = None
        if cfg.automasking:
            auto_loss = automasking_loss(frames, frames[:, cfg.target_id], cfg.source_ids)

        disp_reg_weight = None
        if cfg.disp_reg > 0 and cfg.disp_reg_steps > 0:
            # linear decay to 0 over disp_reg_steps (state.py:105-112)
            frac = min(max(1.0 - state.step / cfg.disp_reg_steps, 0.0), 1.0)
            disp_reg_weight = cfg.disp_reg * frac

        model, optimizer = state.model, state.optimizer
        optimizer.zero_grad(set_to_none=True)
        loss, aux = train_loss(
            model, frames, ctx, cfg, auto_loss=auto_loss, train=True,
            disp_reg_weight=disp_reg_weight, Ks=Ks,
        )
        loss.backward()
        if cfg.grad_clip > 0:
            clip_by_global_norm_(
                (p.grad for p in model.parameters() if p.grad is not None), cfg.grad_clip
            )
        for group in optimizer.param_groups:
            group["lr"] = lr_at(cfg, state.step)
        optimizer.step()
        state.step += 1
        # mean disparity is the saturation tripwire (pinned near 0 or 1 means
        # the sigmoid head collapsed)
        metrics = {"loss": loss.detach(), "mean_disparity": aux["disparity"].detach().mean()}
        return state, metrics, aux

    return step_fn
