"""Traffic kind `train_arch`: kind `train`'s path (benchmark/kinds/train.py)
for a configuration whose `architecture` names another network than kind
`train`'s ResNet Monodepth2.

The program's model is built by `monodepth2_torch.models.create_model`
from the configuration, as `fit` builds it. The start weights and the
float32 reference come from the architecture's reference module,
`benchmark/reference/<REFERENCES[architecture]>.py`: its `Model` (the
reference network, with the program's state-dict names and `set_fp8`) and
its `fill_weights` (which draws the weights of its own layers from the
seed). The feed, the window, the traced segment and the comparison with
the reference are kind `train`'s, with one number more where the cell's
limits file lists it: `replay_loss_climb`.
"""

from __future__ import annotations

import contextlib
import importlib
import math

import numpy as np
import torch

from .. import inputs
from ..reference import train as ref_train
from ..result import Check
from . import train

REFERENCES = {"packnet01": "packnet"}
# the first update whose loss `replay_loss_climb` reads (0-based): update 4's
# loss is taken at the program's state after update 3, from which the
# reference follows, so update 5's is the first to see a replayed update
CLIMB_FROM = 4


def replay_loss_climb(program: list, reference: list) -> float:
    """The least, over updates 5 to the call's last, of the program's loss
    less the reference's, over the reference's, the reference following the
    call from the program's state after update 3 (kind `train`'s
    `Session.reference`). Sound bf16 replays drift from float32's either
    way, by as much as a flipped sign climbs, so some update reads at or
    below zero; replays that climb the loss (a flipped sign) read above
    zero at every update. Infinite where a loss is not finite or the two
    sides count different updates."""
    gaps = [(p - r) / abs(r) for p, r in zip(program[CLIMB_FROM:], reference[CLIMB_FROM:])]
    if len(program) != len(reference) or not gaps or not all(map(math.isfinite, gaps)):
        return float("inf")
    return min(gaps)


def reference_module(config: dict):
    """The reference module of the configuration's architecture."""
    return importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.reference.{REFERENCES[config['architecture']]}")


class Session(train.Session):
    """Kind `train`'s session, with the configuration's network."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        super().__init__(config, traffic, seed, device)
        self.ref = reference_module(config)

    def setup(self) -> None:
        from monodepth2_torch.data import DataLoader
        from monodepth2_torch.models import create_model
        from monodepth2_torch.training import TrainContext, create_train_state, make_scanned_train_step

        cfg, device = self.cfg, self.device
        gen = inputs.generator(self.seed, device)
        start = self.ref.Model(cfg.in_channels, cfg.scale_levels).to(device)
        self.ref.fill_weights(start, gen)
        self.start = {k: v.detach().clone() for k, v in start.state_dict().items()}
        del start
        dataset = self._dataset(gen)
        self.K = np.asarray(dataset.K, np.float64)
        self.state = create_train_state(create_model(cfg, device=device), cfg)
        self.state.model.load_state_dict(self.start)
        ctx = TrainContext.create(self.K, cfg.width, cfg.height, device=device)
        self.loader = DataLoader(dataset, cfg.batch_size, shuffle=True, seed=cfg.seed, with_K=cfg.per_item_K)
        self.step = make_scanned_train_step(ctx, cfg)
        self.feed = self._feed()

    def first_call(self) -> None:
        """Kind `train`'s first call. Its hook reads the finest disparity as
        the output of the model's `depth_decoder`; here that is the depth
        network the forward calls, put under that name on the instance alone
        (no submodule is registered, the state dict is unchanged)."""
        model = self.state.model
        model.__dict__["depth_decoder"] = model.depth_network()
        try:
            super().first_call()
        finally:
            del model.__dict__["depth_decoder"]

    def _reference(self, fp8: bool = False, params=None):
        ref_train.tf32_off()
        model = self.ref.Model(self.cfg.in_channels, self.cfg.scale_levels).to(self.device)
        model.load_state_dict(self.start)
        if params is not None:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(params[n])
        return model.set_fp8(fp8)

    def compare(self, side: dict, ref: dict) -> dict:
        """Kind `train`'s numbers and `replay_loss_climb`."""
        out = super().compare(side, ref)
        out["replay_loss_climb"] = replay_loss_climb(side["losses"], ref["losses"])
        return out


@contextlib.contextmanager
def sessions():
    """While inside, what builds `train.Session` (kind `train`'s `run`,
    `benchmark.calibrate`'s readings) builds this kind's."""
    original, train.Session = train.Session, Session
    try:
        yield
    finally:
        train.Session = original


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, started: float, limits: dict,
        plant=None):
    """Kind `train`'s run (`train.run`) with this kind's session, and
    `replay_loss_climb` checked where the limits list it."""
    with sessions():
        outcome = train.run(cell, seed, seconds, trace, device, started, limits, plant=plant)
    if "replay_loss_climb" in limits:
        climb = replay_loss_climb(outcome.notes["losses_program"], outcome.notes["losses_reference"])
        outcome.checks.append(Check("replay_loss_climb", climb, float(limits["replay_loss_climb"])))
    return outcome
