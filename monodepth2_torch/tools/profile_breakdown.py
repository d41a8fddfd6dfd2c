"""Block-level time breakdown of the train step on the card, port of
tools/profile_breakdown.py.

    python -m monodepth2_torch.tools.profile_breakdown [--iters 30] [--device cpu]

Times nested parts of the bench's step (ResNet-18, 416×128 gray, batch 4,
bf16 network, fp32 geometry and loss; `bench.setup`), each on its own with
CUDA events around `--iters` back-to-back calls after warm-up, from a
drained card to a drained card (the better of two windows), so that the time
is what a caller waits, host time included, and differences attribute it to
blocks:

  model_fwd      the model's forward in training mode (BN statistics update)
  model_fwd_bwd  the same plus the backward of the sum of its outputs
  loss_fwd       train_loss: the model, the geometry, the warp, SSIM + L1
  loss_fwd_bwd   the same plus its backward
  adam_only      one Adam update of all parameters (grads set beforehand)
  full_step      make_train_step's step: loss, backward, Adam

The forward blocks run with autograd on and drop the graph, so a difference
of two blocks is the backward alone. Each block also reports its matmul and
convolution FLOPs from FlopCounterMode (which, unlike XLA's cost analysis,
counts nothing else) and the share of the H100 SXM bf16 peak they reach.
Prints one JSON line per block, then one line with the `derived`
differences of the JAX tool (:155-166), the share of a `full_step` window in
which the card runs no kernel, the kernels and the operators that take the
most device time in a step, and the card's name and power limit.

The idle share tests the hypothesis that eager PyTorch at batch 4 is bound
by launches. One torch.profiler window of `--idle-steps` full steps, which
starts and ends with the card drained and records the card's activity only,
gives the busy time: the union of the intervals in which any kernel, copy or
fill ran. `idle_window.idle_share` is 1 − busy / (the window from the first
activity to the last). The profiler still slows the host, so the window is
longer than an unprofiled step (`window_ms_per_step` against `full_step`'s
time shows by how much); `full_step_idle_share` is 1 − busy / `full_step`'s
time, the idle share of an unprofiled step. `--trace-dir` also writes that
window's Chrome trace.

Without a card it raises unless `--device cpu` is given; a CPU run (for
tests) reports host-clock times, no peak share and no idle share.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from ..bench import count_flops, setup
from ..device import H100_BF16_FLOPS, describe, resolve_device, synchronize
from ..training import train_loss
from ..utils.profiler import trace, wall_ms


def busy_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, reach = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            total += end - start
            reach = end
    return total


def profile_window(
    step, state, frames, device: torch.device, steps: int, trace_dir: Optional[str], top_k: int = 12
) -> dict:
    """Over one profiler window of `steps` full steps, recording the card's
    activity only (see utils.profiler.trace): the idle share in the window,
    1 − busy time / window, where the window runs from the first device
    activity to the last (the card is drained before and after); the busy
    time, the window and the number of device activities per step; and the
    `top_k` device kernels by time."""
    synchronize(device)
    with trace(trace_dir, host=False) as prof:
        for _ in range(steps):
            step(state, frames)
        synchronize(device)
    device_events = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
    ]
    if not device_events:
        raise RuntimeError("torch.profiler recorded no device activity in the window")
    spans = [(e.time_range.start, e.time_range.end) for e in device_events]
    lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
    by_name: dict = {}
    for e in device_events:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.end - e.time_range.start, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_k]
    busy = busy_us(spans, lo, hi)
    return {
        "idle_share": 1.0 - busy / (hi - lo),
        "busy_ms_per_step": busy / 1e3 / steps,
        "window_ms_per_step": (hi - lo) / 1e3 / steps,
        "device_activities_per_step": len(device_events) / steps,
        "top_device_ms_per_step": [
            {"name": name[:120], "ms": total / 1e3 / steps, "calls": count / steps}
            for name, (total, count) in top
        ],
    }


def top_ops(step, state, frames, device: torch.device, steps: int, top_k: int = 12) -> list:
    """The `top_k` host operators, told apart by their input shapes, by the
    device time of their own kernels, per step, over `steps` full steps
    traced with the host's operators (which slows the host, but not the
    kernels)."""
    synchronize(device)
    with trace(host=True) as prof:
        for _ in range(steps):
            step(state, frames)
        synchronize(device)
    ops = [
        e for e in prof.key_averages(group_by_input_shape=True)
        if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0
        and not e.is_user_annotation
    ]
    ops.sort(key=lambda e: -e.self_device_time_total)
    return [
        {"op": e.key, "shapes": str(e.input_shapes)[:160],
         "self_device_ms": e.self_device_time_total / 1e3 / steps, "calls": e.count / steps}
        for e in ops[:top_k]
    ]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--fp32", action="store_true", help="float32 network (default bf16, as the bench)")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--idle-steps", type=int, default=10)
    ap.add_argument("--trace-dir", default=None, help="write the idle window's Chrome trace here")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        torch.backends.cudnn.benchmark = True
    compute_dtype = "float32" if args.fp32 else "bfloat16"
    cfg, ctx, state, step, frames = setup(args.width, args.height, args.batch_size, device, compute_dtype)
    model, optimizer = state.model, state.optimizer

    def model_fwd():
        model.train(True)
        with torch.autocast(device_type=device.type, dtype=torch.bfloat16, enabled=not args.fp32):
            disparities, poses = model(frames, cfg.source_ids, cfg.target_id)
        return sum(d.float().sum() for d in disparities) + sum(
            r.float().sum() + t.float().sum() for r, t in poses
        )

    def model_fwd_bwd():
        model.zero_grad(set_to_none=True)
        model_fwd().backward()

    def loss_fwd():
        return train_loss(model, frames, ctx, cfg)[0]

    def loss_fwd_bwd():
        model.zero_grad(set_to_none=True)
        loss_fwd().backward()

    def set_fake_grads():
        for p in model.parameters():
            p.grad = p.detach() * 1e-6

    def full_step():
        step(state, frames)

    blocks = [
        ("model_fwd", model_fwd, None),
        ("model_fwd_bwd", model_fwd_bwd, None),
        ("loss_fwd", loss_fwd, None),
        ("loss_fwd_bwd", loss_fwd_bwd, None),
        ("adam_only", optimizer.step, set_fake_grads),
        ("full_step", full_step, None),
    ]
    results = {}
    for name, fn, before in blocks:
        if before is not None:
            before()
        ms = min(wall_ms(fn, device, args.iters))
        gflops = count_flops(fn) / 1e9
        results[name] = {
            "block": name,
            "ms": ms,
            "gflops": gflops,
            "tflops_per_s": gflops / ms,
            "bf16_peak_pct": 100 * gflops / ms / (H100_BF16_FLOPS / 1e12) if on_card else None,
        }
        print(json.dumps(results[name]), flush=True)

    d = {k: v["ms"] for k, v in results.items()}
    derived = {
        "model_bwd_ms": d["model_fwd_bwd"] - d["model_fwd"],
        "warp_loss_fwd_ms": d["loss_fwd"] - d["model_fwd"],
        "warp_loss_bwd_extra_ms": d["loss_fwd_bwd"] - d["model_fwd_bwd"],
        "adam_ms": d["adam_only"],
        "step_overhead_ms": d["full_step"] - d["loss_fwd_bwd"] - d["adam_only"],
    }
    window = profile_window(step, state, frames, device, args.idle_steps, args.trace_dir) if on_card else {}
    summary = {
        "derived": derived,
        # the kernels' busy time is the same with the profiler on; the host,
        # and so the window, is slower: the step time without the profiler
        # gives the idle share of an unprofiled step
        "full_step_idle_share": 1.0 - window["busy_ms_per_step"] / d["full_step"] if on_card else None,
        "idle_window": window or None,
        "top_ops": top_ops(step, state, frames, device, args.idle_steps) if on_card else None,
        "config": f"ResNet-18 {cfg.width}x{cfg.height} gray batch {cfg.batch_size}, {compute_dtype} network",
        **describe(device),
    }
    print(json.dumps(summary), flush=True)
    return {"blocks": results, **summary}


if __name__ == "__main__":
    main()
