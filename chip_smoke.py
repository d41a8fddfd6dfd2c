#!/usr/bin/env python3
"""Smoke run of monodepth2_torch on one CUDA card: python3 chip_smoke.py

Drives the port's main path — self-supervised training steps of the full
ResNet-18 model at 416×128, grayscale, batch 4 (the reference configuration
of bench.py) — through the hand-written CUDA grid-sample kernels, and the
port's measurement entry points, one of which (the warp-kernel bench) is the
path that runs the image VJP. Checks each kernel against its plain PyTorch
version on the card. Phases, each printing one flushed JSON line with its
wall time:

  env      the card (nvidia-smi name and power limit), torch and CUDA versions
  build    nvcc of monodepth2_torch/ops/cuda/grid_sample.cu for sm_90a, and
           what ptxas says of each kernel: registers, shared memory, spills;
           beside it the dynamic shared memory of K3's blocks at 128×416
  kernels  the three kernels against their plain versions at the main-path
           shape (32 images of 128×416) for C = 1 and 3, on scattered and
           near-identity uv with exact-border and out-of-range points, and
           on K1/K2's ragged and unaligned cases, for C = 1, 2 and 3: an odd
           P that is not a multiple of the 64 points a warp takes, a tiny
           3×37×53 image, and uv and g as contiguous views one point into a
           larger buffer (not 16-B aligned) and one float into it (uv not
           8-B aligned: K1/K2 read it a float at a time); then K3 alone on
           the cases of warp_kernel_bench.BWD_IMG_CASES for C = 1, 2 and 3,
           which reach both paths of its design (a band of rows summed in
           shared memory; direct adds with a shared copy of the border) and
           their edges. Forward within 1e-6 abs, d_uv within 1e-4 abs +
           1e-5 rel (tests/test_pallas_kernel.py's), d_img per pixel within
           1e-5·Σ_p|g·w| + 1e-6 (atomics add in no fixed order), and d_img
           conserving Σ_p g over each image and channel (float64 sums,
           within that tolerance summed over the pixels)
  autograd grid_sample with image and uv requiring grad, through K1, K2, K3,
           against the plain op; each kernel launched exactly once
  slice    3 fp32 train steps (TF32 off) through the kernels, the launch
           counters reset just before and read just after: 3 × K1, 3 × K2,
           0 × K3 (source frames are data). Beside each, a step from the same
           state through the plain grid sample: losses agree to 1e-4 rel, all
           parameter grads to 1e-2 relative L2
  reference  the simple_depth fit through the kernels against the committed
           golden trajectories tests/golden/simple_depth_golden.npz (96×32,
           500 iterations) and simple_depth_golden_416x128.npz (the
           reference shape, 200 iterations), with the tolerances of
           tests/test_simple_depth_golden.py
  warp_bench  python -m monodepth2_torch.tools.warp_kernel_bench, in process
           and shortened; its counts must show K1, K2 and K3 launched
  bench    python -m monodepth2_torch.bench (bf16 network), shortened; K1 and
           K2 launched, K3 not
  breakdown  python -m monodepth2_torch.tools.profile_breakdown, shortened
  times    per kernel at the main-path shape, C = 1 and (under "C3") C = 3:
           kernel and library (F.grid_sample, aten.grid_sampler_2d_backward
           with the one output the kernel computes) times with the L2
           flushed clean before each launch (`ms`, `library_ms`), flushed by
           a write alone as before (`*_dirty_l2`: the call also writes back
           the flush's dirty lines) and warm (`*_warm`); the plain version's
           clean cold time; the bound from the bytes and operations of this
           run's inputs. K3 and its library call also clean cold on the
           warp bench's smooth warp (`*_smooth`) and on scattered uv
           (`*_scattered`), and K3's bound also with the wrapper's zero fill
           of d_img that its times include (`bound_ms_with_fill`)

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failed phase raises and exits nonzero.
Without a CUDA device, or beside no monodepth2_torch package, it prints no
result and exits nonzero. Starts no thread; every subprocess has a timeout.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent

# main-path shape: Src·S·N = 2 sources × 4 scales × batch 4 warped images
WIDTH, HEIGHT, BATCH = 416, 128, 4
N_WARP = 2 * 4 * BATCH
# fp32 operations per point, counted from the formula: coordinates (scale,
# clamp, floor, weights) once per point; the 4-tap lerp per channel; the
# coordinate VJP adds the two slopes and the g-weighted sums; the image VJP
# forms the 4 tap weights once (6) and per channel 4 products and 4 adds
OPS_COORDS, OPS_FWD_CH, OPS_BWD_CH = 14, 11, 22
OPS_IMG_WEIGHTS, OPS_BWD_IMG_CH = 6, 8
TPU_KERNELS = "monodepth2_tpu/ops/pallas/grid_sample_kernel.py"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "s": round(time.perf_counter() - T0, 3), **fields}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def check_dimg(img, uv, g, d_img, what: str) -> dict:
    """K3's checks (tools.kernel_ab.dimg_checks): per pixel within
    1e-5·Σ_p|g·w| + 1e-6 of the plain version, and Σ_p g conserved over each
    image and channel; raises if either fails, else returns them. Atomics add
    in no fixed order, and a border pixel can collect thousands of terms, so
    a bare absolute tolerance would not do."""
    from monodepth2_torch.tools.kernel_ab import dimg_checks

    checks = dimg_checks(img, uv, g, d_img)
    check(checks["excess"] <= 0, f"{what} disagrees with plain: {checks}")
    check(checks["sum_excess"] <= 0, f"{what} does not conserve the sum of g: {checks}")
    return checks


def compare_kernels(torch, GS, img, uv, g):
    """Max abs errors of the three kernels against their plain versions."""
    out_k = GS.grid_sample_fwd(img, uv)
    duv_k = GS.grid_sample_bwd_uv(img, uv, g)
    dimg_k = GS.grid_sample_bwd_img(img, uv, g)
    out_p = GS.grid_sample_fwd_plain(img, uv)
    duv_p = GS.grid_sample_bwd_uv_plain(img, uv, g)
    torch.cuda.synchronize()
    fwd_err = float((out_k - out_p).abs().max())
    bwd_err = float((duv_k - duv_p).abs().max())
    check(all(bool(torch.isfinite(t).all()) for t in (out_k, duv_k, dimg_k)), "non-finite kernel output")
    check(fwd_err <= 1e-6, f"grid_sample_fwd disagrees with plain: {fwd_err}")
    excess = float(((duv_k - duv_p).abs() - (1e-4 + 1e-5 * duv_p.abs())).max())
    check(excess <= 0, f"grid_sample_bwd_uv disagrees with plain: max err {bwd_err}")
    img_err = check_dimg(img, uv, g, dimg_k, GS.grid_sample_bwd_img.name)["max_abs_err"]
    return fwd_err, bwd_err, img_err


def reset(GS):
    for k in GS.KERNELS:
        k.launches = 0


def counts(GS):
    return {k.name: k.launches for k in GS.KERNELS}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this runs on a CUDA card", file=sys.stderr)
        return 1
    import importlib
    from dataclasses import replace

    import numpy as np
    import torch.nn.functional as F

    from monodepth2_torch import bench
    from monodepth2_torch.device import H100_BYTES_PER_S, H100_FP32_FLOPS, nvidia_smi
    from monodepth2_torch.models import Model
    from monodepth2_torch.ops.cuda import _lib
    from monodepth2_torch.simple_depth import fit_simple_depth
    from monodepth2_torch.tools import profile_breakdown, warp_kernel_bench
    from monodepth2_torch.training import TrainConfig, TrainContext, create_train_state, make_train_step
    from monodepth2_torch.utils.profiler import time_ms

    GS = importlib.import_module("monodepth2_torch.ops.grid_sample")
    dev = torch.device("cuda")

    # ---- env
    smi = nvidia_smi()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("env", nvidia_smi=smi, device=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])

    # ---- build
    t = time.perf_counter()
    path = _lib.build()
    lib = _lib.load()
    ptxas = _lib.ptxas_report()
    check(all(r["spill_store_bytes"] == 0 for r in ptxas.values()), f"a kernel spills: {ptxas}")
    # ptxas counts only static shared memory; K3's launch adds dynamic
    emit("build", build_s=round(time.perf_counter() - t, 3), library=path.name, flags=" ".join(_lib.NVCC_FLAGS),
         ptxas=ptxas, bwd_img_dynamic_smem_bytes={c: _lib.bwd_img_smem_bytes(lib, HEIGHT, WIDTH, c) for c in (1, 2, 3)})

    # ---- kernels against plain
    gen = torch.Generator().manual_seed(0)
    P = HEIGHT * WIDTH
    errs = {}
    for c in (1, 3):
        img = torch.rand((N_WARP, HEIGHT, WIDTH, c), generator=gen).cuda()
        g = torch.randn((N_WARP, P, c), generator=gen).cuda()
        for scattered in (True, False):
            uv = warp_kernel_bench.make_uv(N_WARP, HEIGHT, WIDTH, gen, scattered).cuda()
            errs[(c, scattered)] = compare_kernels(torch, GS, img, uv, g)
            fe, be, ie = errs[(c, scattered)]
            emit("kernels", C=c, uv="scattered" if scattered else "near-identity",
                 shape=[N_WARP, HEIGHT, WIDTH, c], fwd_max_abs_err=fe, bwd_uv_max_abs_err=be,
                 bwd_img_max_abs_err=ie, launches=counts(GS))
    # the cases K1/K2 take their scalar path for, all in the same launch
    for c in (1, 2, 3):
        for case, (n, h, w, p, offset) in {
            "odd P": (N_WARP, HEIGHT, WIDTH, HEIGHT * WIDTH - 1, None),
            "tiny image": (3, 37, 53, 37 * 53, None),
            "views one point in": (4, HEIGHT, WIDTH, HEIGHT * WIDTH, "point"),
            "views one float in": (4, HEIGHT, WIDTH, HEIGHT * WIDTH - 3, "float"),
        }.items():
            img = torch.rand((n, h, w, c), generator=gen).cuda()
            uv = warp_kernel_bench.make_uv(n, h, w, gen, True, p=p).cuda()
            g = torch.randn((n, p, c), generator=gen).cuda()
            if offset == "point":
                uv, g = warp_kernel_bench.offset_view(uv, 2), warp_kernel_bench.offset_view(g, c)
            elif offset == "float":
                uv, g = warp_kernel_bench.offset_view(uv, 1), warp_kernel_bench.offset_view(g, 1)
            errs[(c, case)] = compare_kernels(torch, GS, img, uv, g)
            fe, be, ie = errs[(c, case)]
            emit("kernels", C=c, case=case, shape=[n, h, w, c], points=p,
                 uv_offset_bytes=uv.data_ptr() % 16, g_offset_bytes=g.data_ptr() % 16,
                 fwd_max_abs_err=fe, bwd_uv_max_abs_err=be, bwd_img_max_abs_err=ie)
    # K3 alone on the cases that reach both paths of its design
    img_errs = []
    for c in (1, 2, 3):
        for case in warp_kernel_bench.BWD_IMG_CASES:
            img, uv, g = warp_kernel_bench.bwd_img_case(case, c, gen, dev)
            d_img = GS.grid_sample_bwd_img(img, uv, g)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(d_img).all()), f"non-finite d_img ({case}, C = {c})")
            checks = check_dimg(img, uv, g, d_img, f"{GS.grid_sample_bwd_img.name} ({case}, C = {c})")
            img_errs.append(checks["max_abs_err"])
            emit("kernels", kernel=GS.grid_sample_bwd_img.name, C=c, case=case, shape=list(img.shape),
                 points=uv.shape[1], **{f"bwd_img_{k}": v for k, v in checks.items()})

    # ---- autograd: the op with both gradients, through all three kernels
    img = torch.rand((N_WARP, HEIGHT, WIDTH, 1), generator=gen).cuda()
    uv = warp_kernel_bench.make_uv(N_WARP, HEIGHT, WIDTH, gen, scattered=False).cuda()
    g = torch.randn((N_WARP, P, 1), generator=gen).cuda()
    grads = {}
    reset(GS)
    for method in (None, "gather"):
        i, u = img.clone().requires_grad_(), uv.clone().requires_grad_()
        GS.grid_sample(i, u, method=method).backward(g)
        grads[method] = (i.grad, u.grad)
    torch.cuda.synchronize()
    launches = counts(GS)
    check(all(n == 1 for n in launches.values()), f"autograd launches {launches}, want 1 of each kernel")
    img_err = check_dimg(img, uv, g, grads[None][0], "autograd d_img")["max_abs_err"]
    duv_k, duv_p = grads[None][1], grads["gather"][1]
    uv_err = float((duv_k - duv_p).abs().max())
    check(float(((duv_k - duv_p).abs() - (1e-4 + 1e-5 * duv_p.abs())).max()) <= 0,
          f"autograd d_uv disagrees with the plain op: max err {uv_err}")
    emit("autograd", shape=[N_WARP, HEIGHT, WIDTH, 1], d_img_max_abs_err=img_err, d_uv_max_abs_err=uv_err,
         launches=launches)

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

    reset(GS)
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
    slice_launches = counts(GS)
    # training launches the forward and the coordinate VJP once a step, and
    # never the image VJP: source frames are data, not parameters
    want = {GS.grid_sample_fwd.name: 3, GS.grid_sample_bwd_uv.name: 3, GS.grid_sample_bwd_img.name: 0}
    check(slice_launches == want, f"launches in 3 main-path steps {slice_launches}, want {want}")
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
         mean_disparity=mean_disps, launches=slice_launches)

    # ---- reference: the simple_depth fit through the kernels against the
    # committed golden trajectory (an independent PyTorch loop), with the
    # tolerances of tests/test_simple_depth_golden.py
    for golden_file in ("simple_depth_golden.npz", "simple_depth_golden_416x128.npz"):
        golden = np.load(ROOT / "tests" / "golden" / golden_file)
        t = time.perf_counter()
        iters = int(golden["iters"][-1])
        fit = fit_simple_depth(golden["frames"], golden["K"], n_iters=iters, device="cuda")
        hist = dict(fit["history"])
        fit_rel = [abs(hist[int(i)] - l) / abs(l) for i, l in zip(golden["iters"], golden["losses"])]
        disp_diff = abs(fit["disparity"].mean().item() - float(golden["final_disparity"].mean()))
        check(fit_rel[0] < 1e-5 and max(fit_rel) < 0.02 and fit_rel[-1] < 0.01 and disp_diff < 5e-3,
              f"simple_depth off {golden_file}: first {fit_rel[0]}, max {max(fit_rel)}, last {fit_rel[-1]}, "
              f"disp {disp_diff}")
        _, _, h, w, _ = golden["frames"].shape
        emit("reference", fit=f"simple_depth {w}x{h}, {iters} iterations", golden=golden_file,
             first_rel=fit_rel[0], max_rel=max(fit_rel), last_rel=fit_rel[-1], mean_disparity_diff=disp_diff,
             fit_s=round(time.perf_counter() - t, 3))

    # ---- the measurement entry points, in process and shortened, with the
    # settings a user's run has (cuDNN free to choose, TF32 convs)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False

    # warp_bench: the path that runs the image VJP
    reset(GS)
    warp = warp_kernel_bench.main(["--iters", "10"])
    torch.cuda.synchronize()
    warp_launches = counts(GS)
    check(all(n > 0 for n in warp_launches.values()), f"warp bench launches {warp_launches}: a kernel never ran")
    check(all(np.isfinite(r["fwd_bwd_ms"]) for r in warp["rows"]), "non-finite warp bench times")
    emit("warp_bench", launches=warp_launches, **{r["method"]: {k: v for k, v in r.items() if k != "method"}
                                                    for r in warp["rows"]})

    # bench: the bf16 training step, as users train
    reset(GS)
    result = bench.main(["--warmup", "3", "--steps", "10"])
    bench_launches = counts(GS)
    check(bench_launches[GS.grid_sample_bwd_img.name] == 0 and
          bench_launches[GS.grid_sample_fwd.name] > 0 and bench_launches[GS.grid_sample_bwd_uv.name] > 0,
          f"bench launches {bench_launches}: want K1 and K2, and no K3")
    check(np.isfinite(result["value"]) and np.isfinite(result["loss"]), f"bench result {result}")
    emit("bench", launches=bench_launches, img_per_s=result["value"], ms_per_step=result["ms_per_step"],
         ms_per_step_windows=result["ms_per_step_windows"], mfu_pct=result["mfu_pct"],
         step_gflops=result["step_gflops"], power_limit=smi)

    # breakdown: per-block times and the device's idle share in a step
    breakdown = profile_breakdown.main(["--iters", "10", "--idle-steps", "5"])
    check(0 <= breakdown["full_step_idle_share"] < 1, f"idle share {breakdown['full_step_idle_share']}")
    emit("breakdown", blocks={k: v["ms"] for k, v in breakdown["blocks"].items()},
         derived=breakdown["derived"], full_step_idle_share=breakdown["full_step_idle_share"],
         **{k: breakdown["idle_window"][k] for k in
            ("idle_share", "busy_ms_per_step", "window_ms_per_step", "device_activities_per_step")})

    # ---- times at the main-path shape (near-identity uv; the image VJP also
    # on the warp bench's smooth warp and on scattered uv, whose clamped
    # points pile onto border pixels), C = 1 and C = 3
    def timings(fn, prefix=""):
        """Clean-L2 cold, dirty-L2 cold and warm times of fn, in ms."""
        return {
            f"{prefix}ms": time_ms(fn, dev, 50, flush_l2=True),
            f"{prefix}ms_dirty_l2": time_ms(fn, dev, 50, flush_l2="dirty"),
            f"{prefix}ms_warm": time_ms(fn, dev, 50),
        }

    def time_rows(c):
        """{kernel name: its times, the plain version's and the library's,
        and its bound} at (N_WARP, HEIGHT, WIDTH, c)."""
        img = torch.rand((N_WARP, HEIGHT, WIDTH, c), generator=gen).cuda()
        uv = warp_kernel_bench.make_uv(N_WARP, HEIGHT, WIDTH, gen, scattered=False).cuda()
        g = torch.randn((N_WARP, P, c), generator=gen).cuda()
        img_nchw, grid = img.permute(0, 3, 1, 2), uv.reshape(N_WARP, 1, P, 2)
        g_nchw = g.permute(0, 2, 1).reshape(N_WARP, c, 1, P).contiguous()

        def library_bwd(grid, mask):
            # interpolation 0 = bilinear, padding 1 = border, align_corners
            # True; mask [True, False]: d_img only, [False, True]: d_uv only
            return torch.ops.aten.grid_sampler_2d_backward(g_nchw, img_nchw, grid, 0, 1, True, mask)

        # the library's d_img has the port's weights and clamped taps: hold it
        # to K3's tolerance, so that its time is a yardstick of the same
        # function (its d_uv counts border samples as outside, where the port
        # follows Pallas)
        lib_d_img = library_bwd(grid, [True, False])[0].permute(0, 2, 3, 1)
        lib_err = check_dimg(img, uv, g, lib_d_img, f"library d_img at C = {c}")["max_abs_err"]
        n_pts = N_WARP * P
        nbytes = warp_kernel_bench.kernel_bytes(N_WARP, HEIGHT, WIDTH, c)
        rows = {}
        for k, kernel, plain_fn, library, ops in (
            (
                GS.grid_sample_fwd,
                lambda: GS.grid_sample_fwd(img, uv),
                lambda: GS.grid_sample_fwd_plain(img, uv),
                lambda: F.grid_sample(img_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True),
                n_pts * (OPS_COORDS + c * OPS_FWD_CH),
            ),
            (
                GS.grid_sample_bwd_uv,
                lambda: GS.grid_sample_bwd_uv(img, uv, g),
                lambda: GS.grid_sample_bwd_uv_plain(img, uv, g),
                lambda: library_bwd(grid, [False, True]),
                n_pts * (OPS_COORDS + c * OPS_BWD_CH),
            ),
            (
                GS.grid_sample_bwd_img,
                # timed with the wrapper's zero fill of d_img, as callers get it
                lambda: GS.grid_sample_bwd_img(img, uv, g),
                lambda: GS.grid_sample_bwd_img_plain(img, uv, g),
                lambda: library_bwd(grid, [True, False]),
                n_pts * (OPS_COORDS + OPS_IMG_WEIGHTS + c * OPS_BWD_IMG_CH),
            ),
        ):
            bound_bytes = nbytes[k.name] / H100_BYTES_PER_S * 1e3
            bound_ops = ops / H100_FP32_FLOPS * 1e3
            rows[k.name] = dict(
                **timings(kernel), plain_ms=time_ms(plain_fn, dev, 20, flush_l2=True), **timings(library, "library_"),
                bound_ms=max(bound_bytes, bound_ops), bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                bytes=nbytes[k.name], operations=ops, shape=[N_WARP, HEIGHT, WIDTH, c], uv="near-identity",
            )
        name = GS.grid_sample_bwd_img.name
        fill_bytes = 4 * img.numel()
        rows[name].update(
            library_max_abs_err=lib_err, zero_fill_bytes=fill_bytes,
            bound_ms_with_fill=(nbytes[name] + fill_bytes) / H100_BYTES_PER_S * 1e3,
        )
        for kind, other in (
            ("smooth", warp_kernel_bench.make_inputs(N_WARP, HEIGHT, WIDTH, c, dev)[1]),
            ("scattered", warp_kernel_bench.make_uv(N_WARP, HEIGHT, WIDTH, gen, scattered=True).cuda()),
        ):
            rows[name].update({
                f"ms_{kind}": time_ms(lambda: GS.grid_sample_bwd_img(img, other, g), dev, 50, flush_l2=True),
                f"library_ms_{kind}": time_ms(
                    lambda: library_bwd(other.reshape(N_WARP, 1, P, 2), [True, False]), dev, 50, flush_l2=True
                ),
            })
        return rows

    rows, rows_c3 = time_rows(1), time_rows(3)
    max_errs = [max(e[i] for e in errs.values()) for i in range(3)]
    max_errs[2] = max(max_errs[2], *img_errs)
    kernels = []
    for k, err, lines, launches in (
        (GS.grid_sample_fwd, max_errs[0], (116, 175), slice_launches),  # _fwd_kernel, _fwd_kernel_colband
        (GS.grid_sample_bwd_uv, max_errs[1], (124, 186), slice_launches),  # _bwd_duv_kernel, _colband
        # K3's path is the warp bench's forward + VJP; training runs it 0 times
        (GS.grid_sample_bwd_img, max_errs[2], (154, 214), warp_launches),  # _bwd_dimg_kernel, _colband
    ):
        kernels.append(dict(
            name=k.name, route="cuda", source="monodepth2_torch/ops/cuda/grid_sample.cu",
            replaces=f"{TPU_KERNELS}:{lines[0]}", also_replaces=f"{TPU_KERNELS}:{lines[1]}",
            launches=launches[k.name], launches_per_train_step=slice_launches[k.name] // 3,
            max_abs_err=err, **rows[k.name], C3=rows_c3[k.name],
        ))
    emit("times", total_s=round(time.perf_counter() - T0, 3), power_limit=smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
