"""Train state, train step and scanned train step, port of
monodepth2_tpu/training/state.py.

The JAX TrainState carries (step, params, stats, opt_state, rng) and the step
returns a new one. Here the model holds the params and the BN statistics, the
optimizer holds the Adam moments, and the steps update both in place; the
state's `step` is the host's count of the updates taken. The step draws no
random numbers, so the JAX state's PRNG key has no counterpart.

The learning rate and the disp_reg weight are tensors computed from a
step-count tensor on the state's device, by the same code on the CPU and on
the card: a captured CUDA graph replays that arithmetic, where values read
on the host at capture would be frozen into it.

`make_scanned_train_step` is the counterpart of the JAX package's K steps in
one dispatch (`lax.scan` inside one `jit`, state.py:145-183): on the card it
captures one step as a CUDA graph and replays it K times a call.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch
from torch import Tensor

from ..ops.losses import automasking_loss
from ..utils.profiler import count, span
from .config import TrainConfig, TrainContext
from .loss import train_loss

# per-micro-step metrics, in the order of the scanned step's rows: the loss,
# the mean disparity (the saturation tripwire: pinned near 0 or 1 means the
# sigmoid head collapsed), and the learning rate and disp_reg weight the
# update used
METRICS = ("loss", "mean_disparity", "lr", "disp_reg_weight")

# eager micro-steps before the capture: they build the kernels, let cuDNN
# choose its algorithms and create Adam's state, none of which a graph can
# capture (PyTorch's CUDA-graph notes warm up with 3)
WARMUP_STEPS = 3


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module  # params + BatchNorm running statistics
    optimizer: torch.optim.Optimizer


def lr_at(cfg: TrainConfig, step: int) -> float:
    """Learning rate of update number `step` (0-based) as a Python float:
    linear warmup over `lr_warmup_steps`, then a one-time ×`lr_decay_factor`
    at `lr_decay_steps` (state.py:32-53; optax evaluates the schedule at its
    update count, which equals the train step for a state made by
    create_train_state). `lr_schedule` is what the steps use."""
    lr = cfg.lr
    if cfg.lr_warmup_steps > 0:
        lr *= min(step / cfg.lr_warmup_steps, 1.0)
    if cfg.lr_decay_steps > 0 and step >= cfg.lr_decay_steps:
        lr *= cfg.lr_decay_factor
    return lr


def _scheduled(cfg: TrainConfig) -> bool:
    return cfg.lr_warmup_steps > 0 or cfg.lr_decay_steps > 0


def lr_schedule(cfg: TrainConfig, step: Tensor) -> Optional[Tensor]:
    """The learning rate of update `step` (an integer tensor) as a float32
    tensor on its device, in the arithmetic of the JAX `_lr_schedule`
    (state.py:32-53); None when warmup and decay are both off and the lr is
    the constant cfg.lr."""
    if not _scheduled(cfg):
        return None
    lr = torch.full((), cfg.lr, dtype=torch.float32, device=step.device)
    if cfg.lr_warmup_steps > 0:
        lr = lr * torch.clamp(step.float() / cfg.lr_warmup_steps, max=1.0)
    if cfg.lr_decay_steps > 0:
        lr = torch.where(step >= cfg.lr_decay_steps, lr * cfg.lr_decay_factor, lr)
    return lr


def disp_reg_schedule(cfg: TrainConfig, step: Tensor) -> Optional[Tensor]:
    """The anti-collapse weight at `step` as a float32 tensor: cfg.disp_reg
    decaying linearly to 0 over disp_reg_steps (state.py:105-112); None when
    the regularizer is off."""
    if not (cfg.disp_reg > 0 and cfg.disp_reg_steps > 0):
        return None
    frac = torch.clamp(1.0 - step.float() / cfg.disp_reg_steps, 0.0, 1.0)
    return cfg.disp_reg * frac


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g ← g / ‖g‖ · max_norm when the
    global norm ‖g‖ reaches max_norm. No host sync, so a graph captures it."""
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
    defaults: b1 0.9, b2 0.999, eps 1e-8 added outside the square root).

    With a warmup or decay the lr is a float32 tensor on the params' device,
    which each step overwrites from `lr_schedule`. On the card Adam is built
    `capturable` (its step counts and bias corrections stay on the card), so
    that a CUDA graph can capture the update; capturable Adam refuses CPU
    params, so on the CPU it is built without."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model.reset_parameters(generator)
    device = next(model.parameters()).device
    lr = torch.full((), cfg.lr, dtype=torch.float32, device=device) if _scheduled(cfg) else cfg.lr
    optimizer = torch.optim.Adam(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=device.type == "cuda"
    )
    return TrainState(step=0, model=model, optimizer=optimizer)


def _split(batch):
    """frames and per-item intrinsics (or None) of an array-or-dict batch."""
    if isinstance(batch, dict):
        return batch["frames"], batch["K"]
    return batch, None


def _tree_map(fn, tree):
    """fn over the tensors of nested dicts, lists and tuples."""
    if isinstance(tree, Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(_tree_map(fn, v) for v in tree)


def _update(ctx: TrainContext, cfg: TrainConfig, state: TrainState, step: Tensor, frames: Tensor, Ks, dp=None):
    """One update of `state` in place at the step count held by the tensor
    `step`, which it then advances: the schedules, the loss, its backward
    into the grads (None, or a captured step's own buffers), the clip, Adam.
    Returns the METRICS row (in the loss's dtype) and the loss's aux. A host
    sync happens only under cfg.debug_nans, which checks the loss.

    `dp` (a parallel.dp.DataParallel) makes it one rank's update of a
    data-parallel step: the forward and backward run inside its
    `batch_stats` (the global batch's BatchNorm moments under GSPMD
    semantics), the grads are averaged over the ranks before the clip and
    Adam (the running statistics too under shard_map semantics), and the
    loss and mean disparity are reduced as its semantics say."""
    model, optimizer = state.model, state.optimizer
    auto_loss = None
    if cfg.automasking:
        auto_loss = automasking_loss(frames, frames[:, cfg.target_id], cfg.source_ids)
    lr = lr_schedule(cfg, step)
    if lr is not None:
        for group in optimizer.param_groups:
            group["lr"].copy_(lr)
    reg = disp_reg_schedule(cfg, step)
    with dp.batch_stats(model) if dp is not None else contextlib.nullcontext():
        loss, aux = train_loss(
            model, frames, ctx, cfg, auto_loss=auto_loss, train=True, disp_reg_weight=reg, Ks=Ks,
        )
        if cfg.debug_nans and not bool(torch.isfinite(loss)):
            # the counterpart of jax_debug_nans (loop.py:308-316); anomaly mode,
            # which fit turns on with it, catches a NaN born in the backward
            raise FloatingPointError(f"non-finite loss {loss.item()} at step {int(step)}")
        loss.backward()
    if dp is not None:
        dp.after_backward(model)
    if cfg.grad_clip > 0:
        clip_by_global_norm_((p.grad for p in model.parameters() if p.grad is not None), cfg.grad_clip)
    optimizer.step()
    step.add_(1)
    dtype, device = loss.dtype, loss.device
    # detached, so that no autograd graph outlives the step: a graph kept
    # alive keeps its grad accumulators on the stream of their creation
    loss, aux = loss.detach(), _tree_map(Tensor.detach, aux)
    mean_disparity = aux["disparity"].mean()
    if dp is not None:
        loss, mean_disparity = dp.reduce_metrics(loss, mean_disparity)
    row = torch.stack([
        loss,
        mean_disparity,
        (lr if lr is not None else torch.full((), cfg.lr, device=device)).to(dtype),
        (reg if reg is not None else torch.zeros((), device=device)).to(dtype),
    ])
    return row, aux


def make_train_step(ctx: TrainContext, cfg: TrainConfig, dp=None) -> Callable:
    """Build the train step: step_fn(state, batch) -> (state, metrics, aux).

    batch is frames (N,L,H,W,C), or {"frames": ..., "K": (N,3,3)} with
    per-item intrinsics. metrics hold the METRICS as device tensors; reading
    them synchronizes, so a loop reads them only to log. `dp`: one rank of a
    data-parallel step (parallel/dp.py builds these), batch being its rows.
    """

    def step_fn(state: TrainState, batch):
        frames, Ks = _split(batch)
        step = torch.full((), state.step, dtype=torch.int64, device=frames.device)
        state.optimizer.zero_grad(set_to_none=True)
        row, aux = _update(ctx, cfg, state, step, frames, Ks, dp)
        state.step += 1
        return state, dict(zip(METRICS, row.unbind())), aux

    return step_fn


class _CapturedStep:
    """The scanned step on the card, bound to the state of its first call.

    Its first WARMUP_STEPS micro-steps run eagerly on a side stream. The next
    one first captures a micro-step as a CUDA graph, with the grads set to
    None just before: the captured backward allocates them, and each replay
    writes them anew. Each micro-step from then on copies its batch into the
    graph's input buffers and replays it; the graph advances its own step
    tensor, set from the host's count once a call. The warp kernels K1/K2
    run inside the graph, where their wrappers' launch counters do not see
    them (a replay runs no Python). A data-parallel step's collectives (`dp`,
    over NCCL) run in the warm-up steps, which create NCCL's communicator,
    and are then captured with the rest."""

    def __init__(self, ctx: TrainContext, cfg: TrainConfig, dp=None):
        self.ctx, self.cfg, self.dp = ctx, cfg, dp
        self.state: Optional[TrainState] = None
        self.warm = 0
        self.side = None
        self.graph = None

    def _eager(self, state: TrainState, frames: Tensor, Ks, row_out: Tensor):
        if self.side is None:
            self.side = torch.cuda.Stream(frames.device)
        main = torch.cuda.current_stream(frames.device)
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            step = torch.full((), state.step, dtype=torch.int64, device=frames.device)
            state.optimizer.zero_grad(set_to_none=True)
            row, aux = _update(self.ctx, self.cfg, state, step, frames, Ks, self.dp)
            row_out.copy_(row)
        main.wait_stream(self.side)
        self.warm += 1
        return aux

    def _capture(self, state: TrainState, frames: Tensor, Ks) -> None:
        self.frames = frames.clone()
        self.Ks = None if Ks is None else Ks.clone()
        self.step = torch.zeros((), dtype=torch.int64, device=frames.device)
        state.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.row, self.aux = _update(self.ctx, self.cfg, state, self.step, self.frames, self.Ks, self.dp)
        self.graph = graph
        count("step.captures")

    def __call__(self, state: TrainState, frames: Tensor, Ks):
        if self.state is None:
            self.state = state
        elif state is not self.state:
            raise ValueError("a scanned train step on the card is bound to the state of its first call")
        k = frames.shape[0]
        rows = torch.empty((k, len(METRICS)), dtype=frames.dtype, device=frames.device)
        aux, replayed = None, 0
        for i in range(k):
            Ki = None if Ks is None else Ks[i]
            if self.graph is None and self.warm < WARMUP_STEPS:
                aux = self._eager(state, frames[i], Ki, rows[i])
            else:
                if self.graph is None:
                    self._capture(state, frames[i], Ki)
                if not replayed:
                    self.step.fill_(state.step)
                self.frames.copy_(frames[i])
                if Ki is not None:
                    self.Ks.copy_(Ki)
                self.graph.replay()
                rows[i].copy_(self.row)
                replayed += 1
                aux = None
            state.step += 1
        count("step.replays", replayed)
        if aux is None:
            # the graph's outputs are overwritten by the next replay
            aux = _tree_map(Tensor.clone, self.aux)
        return state, {key: rows[:, j] for j, key in enumerate(METRICS)}, aux


def make_scanned_train_step(ctx: TrainContext, cfg: TrainConfig, dp=None) -> Callable:
    """K train steps per call (state.py:145-183).

    Takes frames stacked (K, N, L, H, W, C), or a dict of (K, ...)-stacked
    `frames` and `K` leaves (per-item intrinsics); returns (state, metrics,
    aux) where metrics are (K,)-stacked (metrics["loss"][-1] is the last
    micro-step) and aux (disparity/warped, for viz) is the last micro-step's,
    a copy that later calls leave alone.

    On the card the micro-steps replay one captured CUDA graph
    (`_CapturedStep`), the step function being bound to the state of its
    first call. On the CPU, under cfg.debug_nans (which reads the loss on
    the host each micro-step) and for a data-parallel step (`dp`) whose
    collectives a graph cannot capture (gloo's), it runs K eager steps.
    """
    step = make_train_step(ctx, cfg, dp)
    captured = _CapturedStep(ctx, cfg, dp)

    def scanned(state: TrainState, batch):
        frames, Ks = _split(batch)
        with span("step.call", frames.device):
            if frames.is_cuda and not cfg.debug_nans and (dp is None or dp.capturable):
                return captured(state, frames, Ks)
            outs = []
            for i in range(frames.shape[0]):
                outs.append(step(state, frames[i] if Ks is None else {"frames": frames[i], "K": Ks[i]}))
            metrics = {key: torch.stack([m[key] for _, m, _ in outs]) for key in METRICS}
            return state, metrics, outs[-1][2]

    return scanned
