"""Where PackNet's train step spends the card's time, and which kernels are
its 3-D convolutions': the step of a benchmark cell's configuration
(`make_train_step`, eager, so that the profiler sees each operator and the
model's spans) at the cell's shapes on random frames, profiled over
`--steps` steps after three outside the profile.

    python experiments/packnet_kernels.py --workload kitti640_packnet_b4_train_mem --steps 3 \\
        --out runs/packnet_kernels.json

Prints and writes one JSON object: the card's name and power limit; the
device time a step of each kernel (top 40); the kernels launched by the 3-D
convolutions' operators (a convolution or its backward whose input has
five dimensions) and, of those, the ones that no other operator launches
(`pack3d_only`), with their time a step beside the bytes the 3-D
convolutions must move (`benchmark/reference/packnet.py` `pack3d_bytes`);
the kernels of GroupNorm's operators (forward and backward) and their time
a step; the device time a step under each of the
model's spans (`depth_net`, `depth_net.pack`, `depth_net.unpack`,
`pose_net`, forward only); and the peak memory. Needs a CUDA device; with
`--device cpu --width 64 --height 32` it runs through on the CPU, for a
rehearsal only. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


SPANS = ("depth_net", "depth_net.pack", "depth_net.unpack", "pose_net")


def _children_kernels(event) -> list:
    """(name, seconds) of the device kernels an operator launched, its
    descendants' included."""
    out = [(k.name, k.duration * 1e-6) for k in getattr(event, "kernels", [])]
    for child in event.cpu_children:
        out += _children_kernels(child)
    return out


def _by_operator(events, is_target, per_step: float) -> tuple:
    """Device seconds a step of each kernel, split by the operator that
    launched it: (the kernels of the outermost operators for which
    `is_target(op)` holds, the kernels of every other operator)."""
    import torch

    target, other = defaultdict(float), defaultdict(float)
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or e.cpu_parent is not None:
            continue
        stack = [e]
        while stack:
            op = stack.pop()
            if is_target(op):
                for name, s in _children_kernels(op):
                    target[name] += s * per_step
                continue
            for k in getattr(op, "kernels", []):
                other[k.name] += k.duration * 1e-6 * per_step
            stack.extend(op.cpu_children)
    return target, other


def _is_conv3d(op) -> bool:
    """A convolution or its backward whose first input has five dimensions."""
    shapes = op.input_shapes or []
    return "convolution" in op.name and bool(shapes) and len(shapes[0]) == 5


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="kitti640_packnet_b4_train_mem")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from benchmark import spec
    from benchmark.kinds.train import intrinsics, train_config
    from benchmark.reference import packnet as ref
    from monodepth2_torch.device import nvidia_smi, synchronize
    from monodepth2_torch.models import create_model
    from monodepth2_torch.training import TrainContext, create_train_state, make_train_step

    cell = spec.cell(args.workload)
    config = dict(cell.config)
    if args.width and args.height:
        config["target_size"] = [args.width, args.height]
    cfg = train_config(config, 1)
    device = torch.device(args.device)
    state = create_train_state(create_model(cfg, device=device), cfg)
    ctx = TrainContext.create(intrinsics(config), cfg.width, cfg.height, device=device)
    step = make_train_step(ctx, cfg)
    gen = torch.Generator(device=device).manual_seed(1)
    frames = torch.rand((cfg.batch_size, 3, cfg.height, cfg.width, cfg.in_channels), generator=gen, device=device)
    for _ in range(3):
        state, metrics, _ = step(state, frames)
    synchronize(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
        for _ in range(args.steps):
            state, metrics, _ = step(state, frames)
        synchronize(device)
    events = prof.events()
    per_step = 1.0 / args.steps

    totals = defaultdict(float)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            totals[e.name] += (e.time_range.end - e.time_range.start) * 1e-6 * per_step
    conv3d, other = _by_operator(events, _is_conv3d, per_step)
    only = {k: v for k, v in conv3d.items() if k not in other}
    group_norm, _ = _by_operator(events, lambda op: "group_norm" in op.name, per_step)
    spans = defaultdict(float)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in SPANS:
            spans[e.name] += sum(s for _, s in _children_kernels(e)) * per_step
    nbytes = ref.pack3d_bytes(config)
    out = {
        "card": nvidia_smi() if device.type == "cuda" else "cpu",
        "workload": args.workload, "target_size": config["target_size"], "steps": args.steps,
        "loss": float(metrics["loss"]),
        "device_s_per_step": sum(totals.values()),
        "top_kernels": sorted(([k[:200], v] for k, v in totals.items()), key=lambda kv: -kv[1])[:40],
        "pack3d_kernels": sorted(([k[:200], v] for k, v in conv3d.items()), key=lambda kv: -kv[1]),
        "pack3d_only": sorted(([k[:200], v] for k, v in only.items()), key=lambda kv: -kv[1]),
        "pack3d_s_per_step": sum(conv3d.values()),
        "pack3d_bytes": nbytes,
        "pack3d_bound_s": nbytes / 3.35e12,
        "group_norm_s_per_step": sum(group_norm.values()),
        "group_norm_kernels": sorted(([k[:200], v] for k, v in group_norm.items()), key=lambda kv: -kv[1]),
        "span_device_s_per_step": dict(spans),
        "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0,
    }
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return out


if __name__ == "__main__":
    main()
