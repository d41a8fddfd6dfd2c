#!/usr/bin/env python3
"""Smoke run of monodepth2_torch on one CUDA card: python3 chip_smoke.py

Drives the port's main path — self-supervised training steps of the full
ResNet-18 model at 416×128, grayscale, batch 4 (the reference configuration
of bench.py) — through the hand-written CUDA grid-sample kernels, and checks
each kernel against its plain PyTorch version on the card. Phases, each
printing one flushed JSON line with its wall time:

  env      the card (nvidia-smi name and power limit), torch and CUDA versions
  build    nvcc of monodepth2_torch/ops/cuda/grid_sample.cu for sm_90a
  kernels  both kernels against their plain versions at the main-path shape
           (32 images of 128×416, C = 1) and at C = 3, on uv with interior,
           exact-border and out-of-range points: forward within 1e-6 abs,
           d_uv within 1e-4 abs + 1e-5 rel (tests/test_pallas_kernel.py's)
  slice    3 fp32 train steps (TF32 off) through the kernels, the launch
           counters reset just before and read just after; beside each, a
           step from the same state through the plain grid sample: losses
           agree to 1e-4 rel, all parameter grads to 1e-4 relative L2. Then
           bf16-network steps, timed over two windows after warm-up
  reference  the simple_depth fit through the kernels against the committed
           golden trajectory tests/golden/simple_depth_golden.npz
  times    per kernel at the main-path shape: kernel, plain and library
           (F.grid_sample) times with the L2 flushed before each launch, and
           the bound from the bytes and operations of this run's inputs

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failed phase raises and exits nonzero.
Without a CUDA device, or beside no monodepth2_torch package, it prints no
result and exits nonzero. Starts no thread; every subprocess has a timeout.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent

# main-path shape: Src·S·N = 2 sources × 4 scales × batch 4 warped images
WIDTH, HEIGHT, BATCH = 416, 128, 4
N_WARP = 2 * 4 * BATCH
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet
# fp32 operations per point, counted from the formula: coordinates (scale,
# clamp, floor, weights) once per point; the 4-tap lerp per channel; the
# backward adds the two slopes and the g-weighted sums
OPS_COORDS, OPS_FWD_CH, OPS_BWD_CH = 14, 11, 22
TPU_KERNELS = "monodepth2_tpu/ops/pallas/grid_sample_kernel.py"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "s": round(time.perf_counter() - T0, 3), **fields}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_uv(torch, n, h, w, generator, scattered: bool):
    """uv (n, h·w, 2): `scattered` draws every point uniformly over
    [-1.2, 1.2]²; otherwise a warp near the identity, as training sees, with
    shifts of up to ±3 px. Either way the first points of each image are set
    exactly on each edge and corner, and beyond them."""
    p = h * w
    if scattered:
        uv = torch.rand((n, p, 2), generator=generator) * 2.4 - 1.2
    else:
        ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        pix = torch.stack([xs, ys], -1).reshape(1, p, 2).float()
        pix = pix + (torch.rand((n, p, 2), generator=generator) * 6 - 3)
        uv = pix / torch.tensor([w - 1.0, h - 1.0]) * 2 - 1
    edges = torch.tensor(
        [[-1, 0.3], [1, -0.2], [0.1, -1], [-0.4, 1], [-1, -1], [1, 1], [-1, 1], [1, -1],
         [-1.3, 0.2], [1.2, 0.5], [0.3, -1.5], [0.6, 1.1], [-2, 3], [1, 1.4]]
    )
    uv[:, : len(edges)] = edges
    return uv.contiguous()


def compare_kernels(torch, GS, img, uv, g):
    """Max abs errors of both kernels against their plain versions."""
    out_k = GS.grid_sample_fwd(img, uv)
    duv_k = GS.grid_sample_bwd_uv(img, uv, g)
    out_p = GS.grid_sample_fwd_plain(img, uv)
    duv_p = GS.grid_sample_bwd_uv_plain(img, uv, g)
    torch.cuda.synchronize()
    fwd_err = float((out_k - out_p).abs().max())
    bwd_err = float((duv_k - duv_p).abs().max())
    check(bool(torch.isfinite(out_k).all()) and bool(torch.isfinite(duv_k).all()), "non-finite kernel output")
    check(fwd_err <= 1e-6, f"grid_sample_fwd disagrees with plain: {fwd_err}")
    excess = float(((duv_k - duv_p).abs() - (1e-4 + 1e-5 * duv_p.abs())).max())
    check(excess <= 0, f"grid_sample_bwd_uv disagrees with plain: max err {bwd_err}")
    return fwd_err, bwd_err


def time_cold(torch, fn, reps: int = 50) -> float:
    """Mean ms of fn() on the card, the 50 MB L2 flushed before each call."""
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this runs on a CUDA card", file=sys.stderr)
        return 1
    import importlib
    from dataclasses import replace

    import numpy as np
    import torch.nn.functional as F

    from monodepth2_torch.models import Model
    from monodepth2_torch.ops.cuda import _lib
    from monodepth2_torch.simple_depth import fit_simple_depth
    from monodepth2_torch.training import TrainConfig, TrainContext, create_train_state, make_train_step

    GS = importlib.import_module("monodepth2_torch.ops.grid_sample")

    # ---- env
    smi = nvidia_smi()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("env", nvidia_smi=smi, device=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])

    # ---- build
    t = time.perf_counter()
    path = _lib.build()
    _lib.load()
    emit("build", build_s=round(time.perf_counter() - t, 3), library=path.name, flags=" ".join(_lib.NVCC_FLAGS))

    # ---- kernels against plain
    gen = torch.Generator().manual_seed(0)
    P = HEIGHT * WIDTH
    errs = {}
    for c in (1, 3):
        img = torch.rand((N_WARP, HEIGHT, WIDTH, c), generator=gen).cuda()
        g = torch.randn((N_WARP, P, c), generator=gen).cuda()
        for scattered in (True, False):
            uv = make_uv(torch, N_WARP, HEIGHT, WIDTH, gen, scattered).cuda()
            fe, be = compare_kernels(torch, GS, img, uv, g)
            errs[(c, scattered)] = (fe, be)
            emit("kernels", C=c, uv="scattered" if scattered else "near-identity",
                 shape=[N_WARP, HEIGHT, WIDTH, c], fwd_max_abs_err=fe, bwd_uv_max_abs_err=be,
                 launches={k.name: k.launches for k in GS.KERNELS})

    # ---- slice: the main path
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = TrainConfig(target_size=(WIDTH, HEIGHT), batch_size=BATCH, in_channels=1)
    K = np.asarray([[482.0, 0, WIDTH / 2], [0, 482.0, HEIGHT / 2], [0, 0, 1.0]])
    ctx = TrainContext.create(K, WIDTH, HEIGHT, device="cuda")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.uniform(size=(BATCH, 3, HEIGHT, WIDTH, 1)).astype(np.float32)).cuda()
    plain_cfg = replace(cfg, warp_method="gather")
    state = create_train_state(Model.create(depth=18, in_channels=1, device="cuda"), cfg)
    plain = create_train_state(Model.create(depth=18, in_channels=1, device="cuda"), plain_cfg)
    step, plain_step = make_train_step(ctx, cfg), make_train_step(ctx, plain_cfg)
    losses, plain_losses, mean_disps, grad_diffs, worst = [], [], [], [], []

    for k in GS.KERNELS:
        k.launches = 0
    for _ in range(3):
        # each plain step starts from the kernel path's state before the step:
        # two free-running Adam trajectories from random init drift apart by
        # rounding alone (CUDA's atomic adds in the reflect-pad and upsample
        # backward differ run to run), so only a shared state compares the warp
        plain.model.load_state_dict(state.model.state_dict())
        plain.optimizer.load_state_dict(state.optimizer.state_dict())
        plain.step = state.step
        state, metrics, aux = step(state, frames)
        plain, plain_metrics, _ = plain_step(plain, frames)
        losses.append(metrics["loss"].item())
        mean_disps.append(metrics["mean_disparity"].item())
        plain_losses.append(plain_metrics["loss"].item())
        grads = [
            (name_p, p.grad, q.grad)
            for (name_p, p), q in zip(state.model.named_parameters(), plain.model.parameters())
        ]
        g = torch.cat([a.flatten() for _, a, _ in grads])
        g_plain = torch.cat([b.flatten() for _, _, b in grads])
        grad_diffs.append(float((g - g_plain).norm() / g_plain.norm()))
        worst.append(max(
            (float((a - b).norm() / b.norm()), name_p) for name_p, a, b in grads if float(b.norm()) > 0
        ))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in GS.KERNELS}
    for name_k, n in launches.items():
        check(n == 3, f"{name_k} launched {n} times in 3 main-path steps, want 3")
    check(all(np.isfinite(losses)) and all(np.isfinite(mean_disps)), f"non-finite metrics {losses} {mean_disps}")
    check(tuple(aux["disparity"].shape) == (BATCH, HEIGHT, WIDTH, 1), "disparity shape")
    check(all(tuple(w.shape) == (BATCH, HEIGHT, WIDTH, 1) for w in aux["warped"]), "warped shape")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    check(rel <= 1e-4, f"kernel-path losses {losses} vs plain-path {plain_losses}")
    # relative L2 distance of all parameter grads, kernel path vs plain path:
    # the two warps differ by fp32 rounding only (FMA contraction in the
    # kernels), which the backward's cancellations can raise to ~1e-3; a
    # wrong coordinate VJP moves the grads by O(1)
    check(max(grad_diffs) <= 1e-2, f"kernel-path grads differ from plain-path grads: {grad_diffs}")
    emit("slice", config=f"ResNet-18 {WIDTH}x{HEIGHT} gray batch {BATCH} fp32, TF32 off", losses=losses,
         plain_losses=plain_losses, max_rel_loss_diff=rel, grad_rel_l2_diff=grad_diffs,
         worst_param_grad_rel_l2_diff=worst,
         mean_disparity=mean_disps, launches=launches)

    # ---- reference: the simple_depth fit through the kernels against the
    # committed golden trajectory (an independent PyTorch loop), with the
    # tolerances of tests/test_simple_depth_golden.py
    golden = np.load(ROOT / "tests" / "golden" / "simple_depth_golden.npz")
    t = time.perf_counter()
    fit = fit_simple_depth(golden["frames"], golden["K"], n_iters=int(golden["iters"][-1]), device="cuda")
    hist = dict(fit["history"])
    fit_rel = [abs(hist[int(i)] - l) / abs(l) for i, l in zip(golden["iters"], golden["losses"])]
    disp_diff = abs(fit["disparity"].mean().item() - float(golden["final_disparity"].mean()))
    check(fit_rel[0] < 1e-5 and max(fit_rel) < 0.02 and fit_rel[-1] < 0.01 and disp_diff < 5e-3,
          f"simple_depth off its golden: first {fit_rel[0]}, max {max(fit_rel)}, last {fit_rel[-1]}, disp {disp_diff}")
    emit("reference", fit="simple_depth 96x32, 500 iterations", first_rel=fit_rel[0], max_rel=max(fit_rel),
         last_rel=fit_rel[-1], mean_disparity_diff=disp_diff, fit_s=round(time.perf_counter() - t, 3))

    # bf16 network, fp32 geometry and loss, as bench.py trains
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    cfg16 = replace(cfg, compute_dtype="bfloat16")
    state = create_train_state(Model.create(depth=18, in_channels=1, device="cuda"), cfg16)
    step = make_train_step(ctx, cfg16)
    for _ in range(3):  # warm-up, cuDNN autotuning included
        state, metrics, _ = step(state, frames)
    windows = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            state, metrics, _ = step(state, frames)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t) / 3 * 1e3)
    check(np.isfinite(metrics["loss"].item()), "non-finite bf16 loss")
    emit("slice_bf16", ms_per_step_windows=windows, ms_per_step=min(windows),
         img_per_s=BATCH / (min(windows) / 1e3), loss=metrics["loss"].item(), power_limit=smi)

    # ---- times at the main-path shape (C = 1, near-identity uv)
    img = torch.rand((N_WARP, HEIGHT, WIDTH, 1), generator=gen).cuda()
    uv = make_uv(torch, N_WARP, HEIGHT, WIDTH, gen, scattered=False).cuda()
    g = torch.randn((N_WARP, P, 1), generator=gen).cuda()
    img_nchw, grid = img.permute(0, 3, 1, 2), uv.reshape(N_WARP, 1, P, 2)
    g_nchw = g.reshape(N_WARP, 1, 1, P)
    f32 = 4
    n_pts = N_WARP * P
    max_errs = (max(e[0] for e in errs.values()), max(e[1] for e in errs.values()))
    kernels = []
    for k, err, kernel, plain_fn, library, nbytes, ops, lines in (
        (
            GS.grid_sample_fwd, max_errs[0],
            lambda: GS.grid_sample_fwd(img, uv),
            lambda: GS.grid_sample_fwd_plain(img, uv),
            lambda: F.grid_sample(img_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True),
            f32 * (img.numel() + uv.numel() + n_pts),
            n_pts * (OPS_COORDS + OPS_FWD_CH),
            (116, 175),  # _fwd_kernel, _fwd_kernel_colband
        ),
        (
            GS.grid_sample_bwd_uv, max_errs[1],
            lambda: GS.grid_sample_bwd_uv(img, uv, g),
            lambda: GS.grid_sample_bwd_uv_plain(img, uv, g),
            # the same VJP, but torch counts border samples as outside
            lambda: torch.ops.aten.grid_sampler_2d_backward(g_nchw, img_nchw, grid, 0, 1, True, [False, True]),
            f32 * (img.numel() + uv.numel() + g.numel() + 2 * n_pts),
            n_pts * (OPS_COORDS + OPS_BWD_CH),
            (124, 186),  # _bwd_duv_kernel, _bwd_duv_kernel_colband
        ),
    ):
        bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
        bound_ops = ops / H100_FP32_FLOPS * 1e3
        ms = time_cold(torch, kernel)
        kernels.append(dict(
            name=k.name, route="cuda", source="monodepth2_torch/ops/cuda/grid_sample.cu",
            replaces=f"{TPU_KERNELS}:{lines[0]}", also_replaces=f"{TPU_KERNELS}:{lines[1]}",
            launches=launches[k.name], max_abs_err=err, ms=ms, kernel_ms=ms,
            plain_ms=time_cold(torch, plain_fn), bound_ms=max(bound_bytes, bound_ops),
            bound_by="bytes" if bound_bytes >= bound_ops else "operations",
            library_ms=time_cold(torch, library), bytes=nbytes, operations=ops,
            shape=[N_WARP, HEIGHT, WIDTH, 1],
        ))
    emit("times", total_s=round(time.perf_counter() - T0, 3), power_limit=smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
