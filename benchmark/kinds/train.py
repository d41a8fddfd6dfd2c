"""Traffic kind `train`: `fit`'s path, timed.

Set-up builds what `monodepth2_torch.training.loop.fit` builds for one
process on one card: the model (its weights then replaced by the
benchmark's, made from the seed), `create_train_state`, the port's
`DataLoader` with fit's defaults (shuffle from the seed, 2 worker threads)
over the traffic's dataset, `_group_batches` into `steps_per_call` groups,
`device_prefetch` once an epoch, and `make_scanned_train_step`, which on
the card replays one captured CUDA graph. Its first call takes the feed's
first group: three eager micro-steps, the capture, then replays. That call
is what the reference follows; one more call ends set-up.

The window runs calls back to back for `--seconds`; it ends at the
`synchronize()` after the last call started inside it, and
`train_img_per_s` is the target frames of all its steps over its length.

The dataset is a sequence of the traffic's `sequence_frames` gray frames,
a camera panning `shift_px` pixels a frame along one scene made on the
card from the seed (`inputs.panorama`) and held on the host; triplet i is
frames i, i+1, i+2, as a KITTI sequence's are, so an epoch is
`sequence_frames` - 2 triplets and no two rows are alike.

Correctness: the program's per-step losses of the first call, its first
gradient (Adam's first moment after update 1, over 1 - β1) and its
parameters and moments after update 3, read by a post-step hook on its
optimizer, and its parameters after the call, against the float32 reference
(`benchmark.reference`) run from the same weights on the same batches once
the program is freed (see `compare`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import statistics
import time

import numpy as np
import torch

from .. import inputs
from ..reference import train as ref_train
from ..reference.model import Model as RefModel
from ..result import Check, Outcome, Reading
from ..trace import WINDOW, profiled, reduce

BETA1 = 0.9
# the numbers a cell compares are those its limits file lists
CHECKS = ("disparity_error", "disparity_gap", "change_median_gap", "replay_change_median_gap", "rows_short",
          "row_weight_error", "replay_loss_gap")
# read and printed, not compared: no control or fault reads far enough above
# a sound run's reading to set a limit between them (PERF.md)
UNCOMPARED = ("loss_gap", "grad_gap", "grad_leaf_error", "grad_error", "change_gap", "replay_change_gap")


def train_config(config: dict, seed: int):
    """The program's TrainConfig from the configuration's file, with the
    run's seed (which seeds the loader's shuffle)."""
    from monodepth2_torch.training import TrainConfig

    names = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig.from_json(json.dumps({**{k: v for k, v in config.items() if k in names}, "seed": int(seed)}))


def intrinsics(config: dict) -> np.ndarray:
    k = config["intrinsics"]
    return np.asarray([[k["fx"], 0, k["cx"]], [0, k["fy"], k["cy"]], [0, 0, 1.0]])


class PanningSequence:
    """The triplets of a camera panning along a scene (H, W', C) held on the
    host: item i, (3, H, width, C) float32, holds frames i, i+1, i+2, frame
    j being columns j·shift … j·shift + width - 1 (a view; the loader's
    stack copies it)."""

    target_id, source_ids = 1, (0, 2)

    def __init__(self, scene: np.ndarray, width: int, shift: int, K: np.ndarray):
        self.scene, self.width, self.shift, self.K = np.ascontiguousarray(scene, np.float32), width, shift, K
        self.frames = (self.scene.shape[1] - width) // shift + 1

    def __len__(self) -> int:
        return self.frames - 2

    def __getitem__(self, i: int) -> np.ndarray:
        if not 0 <= i < len(self):
            raise IndexError(i)
        h, w, c = self.scene.shape
        s = self.scene.strides
        return np.lib.stride_tricks.as_strided(self.scene[:, i * self.shift:], shape=(3, h, self.width, c),
                                               strides=(self.shift * s[1], *s), writeable=False)


def groups_of(rows: int) -> int:
    """How many runs of consecutive rows the row weights are read in: the
    largest of 4, 3, 2, 1 that divides the batch."""
    return max(g for g in (1, 2, 3, 4) if rows % g == 0)


def _row_weight_error(side: dict, groups: list, keep: set) -> float:
    """How far the side's gradient is from weighing the batch's rows as the
    loss does: with `groups` the reference's gradients of G equal runs of
    the rows at the same state (their mean is the batch's gradient) and c
    the least-squares coefficients of the side's on them, over the leaves
    in `keep`, each scaled by one over its norm in that mean so that every
    leaf counts alike, the largest |G·c_k - 1|. A run left out reads 1, a
    flipped sign 2."""
    names = [n for n in groups[0] if n in keep]
    scale = {n: 1.0 / max(float(sum(g[n] for g in groups).norm()) / len(groups), 1e-30) for n in names}

    def flat(tree):
        return torch.cat([(tree[n] * scale[n]).reshape(-1).double() for n in names])

    ys, x = torch.stack([flat(g) for g in groups]), flat(side)
    if not bool(torch.isfinite(x).all()):
        return float("inf")
    c = torch.linalg.lstsq(ys @ ys.T, ys @ x[:, None]).solution[:, 0]
    return float((len(groups) * c - 1).abs().max())


def _leaf_gaps(prog: dict, ref: dict, keep=None) -> list:
    """Each leaf's |‖prog‖ - ‖ref‖| over the larger of its reference norm
    and the median leaf's."""
    names = [n for n in ref if keep is None or n in keep]
    ref_norms = {n: float(ref[n].norm()) for n in names}
    median = statistics.median(ref_norms.values())
    return [abs(float(prog[n].norm()) - ref_norms[n]) / max(ref_norms[n], median, 1e-30) for n in names]


def _leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap (`_leaf_gaps`)."""
    return max(_leaf_gaps(prog, ref, keep))


def _relative_error(prog: dict, ref: dict) -> float:
    """‖prog - ref‖ / ‖ref‖ over all leaves together."""
    num = sum(float((prog[n] - ref[n]).square().sum()) for n in ref)
    den = sum(float(ref[n].square().sum()) for n in ref)
    return (num / max(den, 1e-300)) ** 0.5


class Session:
    """One cell's program, from the seed to its freed state, and the
    comparison of what its first call made with the reference."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.cfg = train_config(config, seed)
        self.spc = max(1, int(self.cfg.steps_per_call))

    # -- set-up --------------------------------------------------------
    def _dataset(self, gen: torch.Generator) -> PanningSequence:
        cfg, shift = self.cfg, int(self.traffic["shift_px"])
        scene = inputs.panorama(int(self.traffic["sequence_frames"]), cfg.height, cfg.width, cfg.in_channels,
                                shift, gen, self.device)
        return PanningSequence(scene.cpu().numpy(), cfg.width, shift, intrinsics(self.config))

    def setup(self) -> None:
        from monodepth2_torch.data import DataLoader
        from monodepth2_torch.models import Model
        from monodepth2_torch.training import TrainContext, create_train_state, make_scanned_train_step

        cfg, device = self.cfg, self.device
        gen = inputs.generator(self.seed, device)
        start = RefModel(cfg.in_channels, cfg.scale_levels).to(device)
        inputs.fill_weights(start, gen)
        self.start = {k: v.detach().clone() for k, v in start.state_dict().items()}
        del start
        dataset = self._dataset(gen)
        self.K = np.asarray(dataset.K, np.float64)
        model = Model.create(depth=cfg.encoder_depth, in_channels=cfg.in_channels, scale_levels=cfg.scale_levels,
                             pose_tz_init=cfg.pose_tz_init, device=device)
        self.state = create_train_state(model, cfg)
        model.load_state_dict(self.start)
        ctx = TrainContext.create(self.K, cfg.width, cfg.height, device=device)
        self.loader = DataLoader(dataset, cfg.batch_size, shuffle=True, seed=cfg.seed, with_K=cfg.per_item_K)
        self.step = make_scanned_train_step(ctx, cfg)
        self.feed = self._feed()

    def _feed(self):
        """fit's feed: each epoch a fresh pass of the loader, grouped, and
        copied to the card ahead of use."""
        from monodepth2_torch.data import device_prefetch
        from monodepth2_torch.training.loop import _group_batches

        while True:
            groups = _group_batches(iter(self.loader), self.spc)
            yield from device_prefetch(groups, size=2, device=self.device, dtype=np.float32)

    def _call(self, batch) -> int:
        self.state, metrics, self.aux = self.step(self.state, batch)
        self.metrics = metrics
        frames = batch["frames"] if isinstance(batch, dict) else batch
        return int(frames.shape[0])

    def first_call(self) -> None:
        """The feed's first group through the step, with the program's state
        read after updates 1, 2 and 3 (eager micro-steps, where a hook on its
        optimizer runs) and after the call (the graph's replays), and the
        finest disparity of updates 1-3 (a hook on its depth decoder)."""
        named = dict(self.state.model.named_parameters())
        self.records = {}

        def read_state(optimizer, args, kwargs):
            n = self.records["updates"] = self.records.get("updates", 0) + 1
            moments = {k: optimizer.state[p] for k, p in named.items()}
            if n <= 2:
                self.records[f"params{n}"] = {k: p.detach().clone() for k, p in named.items()}
            if n == 1:
                self.records["grad"] = {k: s["exp_avg"].detach() / (1 - BETA1) for k, s in moments.items()}
            elif n == 3:
                self.records["params3"] = {k: p.detach().clone() for k, p in named.items()}
                self.records["m3"] = {k: s["exp_avg"].detach().clone() for k, s in moments.items()}
                self.records["v3"] = {k: s["exp_avg_sq"].detach().clone() for k, s in moments.items()}

        maps = self.records["disparity"] = []

        def read_disparity(module, args, output):
            if len(maps) < 3:  # the eager micro-steps; nothing while the graph is captured
                maps.append(output[-1].detach().float().permute(0, 2, 3, 1).clone())

        hooks = [self.state.optimizer.register_step_post_hook(read_state),
                 self.state.model.depth_decoder.register_forward_hook(read_disparity)]
        try:
            self.first_batch = next(self.feed)
            self._call(self.first_batch)
        finally:
            for hook in hooks:
                hook.remove()
        self.records["losses"] = self.metrics["loss"].detach().clone()
        self.records["mean_disparity"] = self.metrics["mean_disparity"].detach().clone()
        self.records["params_end"] = {k: p.detach().clone() for k, p in named.items()}
        self.records["rows"] = int(self.aux["disparity"].shape[0])

    def warm(self) -> None:
        self._call(next(self.feed))
        sync(self.device)

    # -- timed ---------------------------------------------------------
    def window(self, seconds: float) -> Reading:
        sync(self.device)
        wait, steps = 0.0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            with torch.profiler.record_function("bench.input_wait"):
                batch = next(self.feed)
            wait += time.perf_counter() - t
            with torch.profiler.record_function("bench.step_call"):
                steps += self._call(batch)
        sync(self.device)
        window_s = time.perf_counter() - t0
        return Reading(self.config, window_s=window_s, steps=steps, spans={"input_wait": wait})

    def traced(self, calls: int) -> tuple:
        """`calls` calls under the profiler: (trace, steps)."""
        sync(self.device)
        steps = 0
        with profiled() as prof:
            with torch.profiler.record_function(WINDOW):
                for _ in range(calls):
                    with torch.profiler.record_function("bench.input_wait"):
                        batch = next(self.feed)
                    with torch.profiler.record_function("bench.step_call"):
                        steps += self._call(batch)
                sync(self.device)
        return reduce(prof), steps

    def release(self) -> None:
        """Free the program: its state, graph, loader and feed."""
        self.feed.close()
        for name in ("state", "step", "loader", "feed", "metrics", "aux"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness ---------------------------------------------------
    def _reference(self, fp8: bool = False, params=None) -> RefModel:
        ref_train.tf32_off()
        model = RefModel(self.cfg.in_channels, self.cfg.scale_levels).to(self.device)
        model.load_state_dict(self.start)
        if params is not None:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(params[n])
        return model.set_fp8(fp8)

    def _batches(self):
        frames = self.first_batch["frames"] if isinstance(self.first_batch, dict) else self.first_batch
        K = torch.as_tensor(self.K, dtype=torch.float32, device=self.device)
        return frames, K, {**self.config, "batch_size": self.cfg.batch_size}

    def program_side(self) -> dict:
        """The program's readings: every loss of the first call, the first
        gradient, the state after update 3 and the parameters after the
        call."""
        r = self.records
        out = {"losses": [float(x) for x in r["losses"]], "mean_disparity": [float(x) for x in r["mean_disparity"]],
               "params_end": r["params_end"], "rows": r["rows"]}
        out.update({k: r[k] for k in ("grad", "params1", "params2", "params3", "m3", "v3",
                                      "disparity") if k in r})
        return out

    def control_side(self) -> dict:
        """The same readings of the reference computing its network in
        float8 (the control), put in the program's place."""
        model = self._reference(fp8=True)
        names = [n for n, _ in model.named_parameters()]
        adam = ref_train.Adam(model.parameters())
        side = {}

        side["disparity"] = []

        frames, K, cfg = self._batches()

        def record(i, m, a, seen):
            if i <= 3:
                side[f"params{i}"] = {n: p.detach().clone() for n, p in m.named_parameters()}
                side["disparity"].append(seen["disparity"])
            if i == 1:
                side["grad"] = {n: x / (1 - BETA1) for n, x in zip(names, a.m)}
            elif i == 3:
                side["m3"] = {n: x.clone() for n, x in zip(names, a.m)}
                side["v3"] = {n: x.clone() for n, x in zip(names, a.v)}

        side["losses"], side["mean_disparity"] = ref_train.follow(model, frames, K, cfg, 0, len(frames), adam, record)
        side["params_end"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        side["rows"] = int(frames.shape[1])
        return side

    def reference(self, side: dict) -> dict:
        """The float32 reference: from the run's weights over updates 1-3
        (the eager micro-steps), and from `side`'s state after update 3 over
        the rest of the first call (the graph's capture and replays), which
        the program runs where no Python can read its state. Then the
        gradients of the runs of the first batch's rows (`groups_of`) at the
        run's weights."""
        frames, K, cfg = self._batches()
        model = self._reference()
        names = [n for n, _ in model.named_parameters()]
        adam = ref_train.Adam(model.parameters())
        groups = groups_of(int(frames.shape[1]))
        ref = {}

        def record(i, m, a, seen):
            if i == 1:
                ref["grad"] = {n: x / (1 - BETA1) for n, x in zip(names, a.m)}
            elif i == 3:
                ref["params3"] = {n: p.detach().clone() for n, p in m.named_parameters()}

        ref["losses"], ref["mean_disparity"] = ref_train.follow(model, frames, K, cfg, 0, 3, adam, record)
        ref["one_step"] = []  # (loss, mean disparity, disparity) of update k+1 at the side's state after k
        for k in range(4):
            if k and f"params{k}" not in side:
                break
            at = self._reference(params=side[f"params{k}"] if k else None)
            seen = {}
            with torch.no_grad():
                value = ref_train.loss(at.train(), frames[k], K, cfg, k, seen)
            ref["one_step"].append((float(value), seen["mean_disparity"], seen["disparity"]))
        if "params3" in side:
            model = self._reference(params=side["params3"])
            adam = ref_train.Adam(model.parameters(), m=[side["m3"][n] for n in names],
                                  v=[side["v3"][n] for n in names], t=3)
            losses, means = ref_train.follow(model, frames, K, cfg, 3, len(frames), adam)
            ref["losses"] += losses
            ref["mean_disparity"] += means
            ref["params_end"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        model = self._reference().train()
        rows = ref_train.row_losses(model, frames[0], K, cfg, 0)
        ref["group_grads"] = [dict(zip(names, g))
                              for g in ref_train.group_gradients(list(model.parameters()), rows, groups)]
        return ref

    def compare(self, side: dict, ref: dict) -> dict:
        """The numbers of `side` (the program's readings, or the control's)
        against the reference's. A leaf gap is |‖side‖ - ‖reference‖| over
        the larger of the leaf's reference norm and the median leaf's; the
        change gaps leave out leaves whose reference gradient is under 1e-3
        of the median leaf's (they move by round-off).

          disparity_gap      the finest disparity's mean in updates 1-4, each
                             against the reference's forward at the side's
                             own state before it (the run's weights, then
                             after updates 1, 2, 3; update 4 is the graph's
                             first replay): the mean of the four
                             |side - reference| / |reference|
          disparity_error    the finest disparity map of updates 1-3 (the
                             eager micro-steps) against the reference's
                             forward at the side's state before each: the
                             mean of the three ‖side - reference‖ /
                             ‖reference‖
          change_median_gap  the median leaf gap of the change over
                             updates 1-3 (the eager micro-steps)
          replay_change_median_gap  the same over the rest of the call (the
                             graph's replays), from the side's state
          rows_short         rows of the batch missing from the disparity
                             the call returns (exact: 0)
          row_weight_error   how far the first gradient is from weighing
                             each run of the batch's rows alike, as the
                             reference's gradients of those runs read it
                             (`_row_weight_error`): a run left out reads 1,
                             a flipped sign 2
          replay_loss_gap    the loss of the call's last update (the
                             graph's last replay) against the reference's
                             after the same updates from the side's state
                             after update 3: |side - reference| /
                             |reference|; replays that climb the loss
                             (a flipped sign) read far above sound ones

        Also read, not compared (UNCOMPARED; PERF.md gives why): the loss's
        gap as disparity_gap's (loss_gap), the worst leaf's gap of the first gradient
        (grad_gap) and of each change (change_gap, replay_change_gap), and
        the first gradient's ‖side - reference‖ / ‖reference‖ over all
        leaves (grad_error) and of the median leaf (grad_leaf_error).
        """
        inf = float("inf")
        names = list(ref["grad"])
        lp, lr = side["losses"], ref["losses"]
        out = dict.fromkeys(CHECKS + UNCOMPARED, inf)
        mp, one = side["mean_disparity"], ref["one_step"]
        if all(map(np.isfinite, lp + mp)) and len(one) == 4:
            out["loss_gap"] = statistics.mean(abs(lp[k] - one[k][0]) / abs(one[k][0]) for k in range(4))
            out["disparity_gap"] = statistics.mean(abs(mp[k] - one[k][1]) / abs(one[k][1]) for k in range(4))
        maps = side.get("disparity", [])
        if (len(maps) == 3 and len(one) >= 3 and all(m.shape == o[2].shape for m, o in zip(maps, one))
                and all(bool(torch.isfinite(m).all()) for m in maps)):
            out["disparity_error"] = statistics.mean(
                float((maps[k] - one[k][2]).norm() / one[k][2].norm()) for k in range(3))
        grad_norms = {n: float(g.norm()) for n, g in ref["grad"].items()}
        floor = 1e-3 * statistics.median(grad_norms.values())
        moving = {n for n, v in grad_norms.items() if v >= floor}
        if "grad" in side:
            out["grad_gap"] = _leaf_gap(side["grad"], ref["grad"])
            out["grad_error"] = _relative_error(side["grad"], ref["grad"])
            out["grad_leaf_error"] = statistics.median(
                float((side["grad"][n] - ref["grad"][n]).norm()) / max(grad_norms[n], 1e-30) for n in names)
        if "params3" in side:
            gaps = _leaf_gaps({n: side["params3"][n] - self.start[n] for n in names},
                              {n: ref["params3"][n] - self.start[n] for n in names}, moving)
            out["change_gap"], out["change_median_gap"] = max(gaps), statistics.median(gaps)
        if "params_end" in ref:
            gaps = _leaf_gaps({n: side["params_end"][n] - side["params3"][n] for n in names},
                              {n: ref["params_end"][n] - side["params3"][n] for n in names}, moving)
            out["replay_change_gap"], out["replay_change_median_gap"] = max(gaps), statistics.median(gaps)
        if "grad" in side:
            out["row_weight_error"] = _row_weight_error(side["grad"], ref["group_grads"], moving)
        if len(lp) == len(lr) and all(map(np.isfinite, lp)):
            out["replay_loss_gap"] = abs(lp[-1] - lr[-1]) / abs(lr[-1])
        out["rows_short"] = float(self.cfg.batch_size - side["rows"])
        out["leaves_left_out"] = len(names) - len(moving)
        out["loss_gaps"] = [abs(p - r) / abs(r) for p, r in zip(lp, lr)]
        return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, started: float, limits: dict,
        plant=None) -> Outcome:
    """One run of a train cell (see the module's docstring); `started` is
    the process's start on the monotonic clock; `plant`, a fault from
    `benchmark.faults`, is entered around the program (tests only)."""
    session = Session(cell.config, cell.traffic, seed, device)
    with plant() if plant is not None else contextlib.nullcontext():
        session.setup()
        session.first_call()
        session.warm()
        setup_s = time.monotonic() - started
        reading = session.window(seconds)
        if trace:
            reading.trace, reading.trace_steps = session.traced(int(cell.traffic["trace_calls"]))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    session.release()
    program = session.program_side()
    reference = session.reference(program)
    numbers = session.compare(program, reference)
    images = reading.steps * session.cfg.batch_size
    checks = [Check(name, numbers[name], float(limits[name])) for name in CHECKS if name in limits]
    notes = {"losses_program": program["losses"], "losses_reference": reference["losses"],
             "loss_gaps": numbers["loss_gaps"], "leaves_left_out": numbers["leaves_left_out"],
             "uncompared": {k: numbers[k] for k in CHECKS + UNCOMPARED if k not in limits}, "window_s": reading.window_s,
             "steps": reading.steps, "input_wait_s": reading.spans["input_wait"]}
    return Outcome(
        attempted=images, failed=0,
        end_to_end={"train_img_per_s": images / reading.window_s, "setup_s": setup_s},
        reading=reading, checks=checks, memory_peak_bytes=int(peak), notes=notes,
    )
