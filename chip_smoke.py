#!/usr/bin/env python3
"""Smoke run of monodepth2_torch on one CUDA card: python3 chip_smoke.py

Drives the port's main path — self-supervised training steps of the full
ResNet-18 model at 416×128, grayscale, batch 4 (the reference configuration
of bench.py) — through the hand-written CUDA grid-sample kernels, its
serving path (eval, export, the HTTP server), which runs no warp, and the
port's measurement entry points, one of which (the warp-kernel bench) is the
path that runs the image VJP. Checks each kernel against its plain PyTorch
version on the card. Phases, each printing one flushed JSON line with its
wall time:

  env      the card (nvidia-smi name and power limit), torch and CUDA versions
  build    nvcc of monodepth2_torch/ops/cuda/grid_sample.cu and project.cu
           for sm_90a, and what ptxas says of each kernel: registers, shared
           memory, spills; beside it the dynamic shared memory of K3's
           blocks at 128×416
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
  project  the projection's kernels (project_fwd; project_bwd, whose launch
           enqueues project_bwd_kernel and project_bwd_reduce_kernel)
           against their plain twins at the main path's shape for one
           source (16 items of 128×416 points, tools.project_bench's
           inputs: a point behind the camera and one at c_z = 1e-2 in every
           item), K shared and per item: uv within 1e-6 abs, d_points
           within 1e-5 rel + 1e-6 abs, dR and dt within 1e-5 relative
           Frobenius (tests/test_torch_cuda.py's), a second backward the
           same bits, one launch of each wrapper a call
  autograd grid_sample with image and uv requiring grad, through K1, K2, K3,
           against the plain op; each kernel launched exactly once
  slice    3 fp32 train steps (TF32 off) through the kernels, the launch
           counters reset just before and read just after: 3 × K1, 3 × K2,
           0 × K3 (source frames are data), and the projection's wrappers 3 ×
           2 (once a source a step). Beside each, a step from the same
           state through the plain grid sample: losses agree to 1e-4 rel, all
           parameter grads to 1e-2 relative L2
  graph    the scanned train step (training.make_scanned_train_step) in
           fp32, TF32 off, cuDNN deterministic, at the slice's size with
           disp_reg and a warmup and decay that all change while it replays:
           3 eager warm-up micro-steps, then 10 calls of one micro-step, the
           first of which captures the CUDA graph. Before each, an eager twin
           is loaded from the graph's state (a copy, not an alias); the
           replay's loss agrees with the twin's to 1e-4 rel, the lr Adam
           read (its param group's lr tensor) and the disp_reg weight equal
           lr_at and the float formula, the params after the update are
           within 1e-6 relative L2 of the twin's (one update moves them by
           ~5e-5 or more), Adam's moments within 1e-4 and its step counts
           equal. Then one call of 10 replays in a profiler window: by
           kernel name, K1 and K2 once a step and K3 never (a replay runs no
           Python, so the wrappers' counters cannot see it), and each of the
           projection's three kernels once a source a step
  reference  the simple_depth fit through the kernels against the committed
           golden trajectories tests/golden/simple_depth_golden.npz (96×32,
           500 iterations) and simple_depth_golden_416x128.npz (the
           reference shape, 200 iterations), with the tolerances of
           tests/test_simple_depth_golden.py
  graph_bf16  the same configuration in bf16 (the network under autocast):
           30 replayed micro-steps, all finite, and their ms/step
  fit      training.loop.fit, the trainer's entry point (this slice's main
           path), on SyntheticDriving(n=48, 416×128), batch 4, the config of
           configs/kitti_ssl.json (bf16, steps_per_call 10) with log_every 5,
           save_every 10: to max_steps 20, then a second fit to 30 that
           resumes. The first fit runs in a profiler window, its launch
           counters reset just before and read just after: the wrappers run
           (eager warm-up steps and the capture) for K1 and K2, not K3, and
           by kernel name K1 and K2 are launched once a step, replays
           included, K3 never, and the projection's three kernels once a
           source a step. Checks the checkpoint files, the
           metrics.jsonl steps (those _crossed gives), the resumed step and
           data cursor, and a bitwise round-trip of params, stats and Adam
           state through save and load
  eval     the serving path, which runs no warp (launch counters reset
           before it and read after serve: K1 = K2 = K3 = 0): eval.load_model
           on the first fit's last checkpoint (the architecture from its
           sidecar, not from the caller's config), the infer fn's output on
           the card, eval_images on 8 PNGs of held-out SyntheticDriving
           frames (8 disparity PNGs), eval_depth_accuracy on them against
           gt_depth_for (finite metrics)
  export   fp32 and bf16 artifacts (serving.export_inference) exported and
           loaded (load_inference) on the card; with TF32 off, the fp32
           artifact within 1e-5 abs of live inference at batch 1, 3 and 64
           for disparity and depth, and the bf16 one within 3e-2 abs of the
           fp32 live disparity (mean under 5e-3) and 0.1 relative in depth;
           outputs on the card; one artifact call in a profiler window has
           device kernels and no host/card copy, and its graph names no
           device but the card
  serve    server.build_server over the fp32 artifact on 127.0.0.1 (port 0),
           buckets 1, 4, 16, 64, warmed, TF32 off: 16 concurrent requests
           (float32 and uint8 octet-stream of 1-3 rows, one PNG), each
           response within 1e-6 of the artifact on its rows; /healthz counts
           fewer device batches than requests; shut down with timeouts
  serve_bench  tools.serving_bench (live and artifact, fp32 and bf16, batch
           1, 4, 16, 64, input on the card and numpy round trip),
           tools.http_serving_bench (concurrency 1, 8, 32) and
           tools.model_block_bench, in process and shortened
  ssl      tools.ssl_driving_experiment (recipe C: depth 1-80, disp_reg
           0.01 over 2,500 steps, bf16), shortened to 100 steps on 20 scenes
           with val on 4: history.json written, rows at 50 and 100, finite
           losses, val metrics, mean disparity inside (0, 1)
  warp_bench  python -m monodepth2_torch.tools.warp_kernel_bench, in process
           and shortened; its counts must show K1, K2 and K3 launched
  bench    python -m monodepth2_torch.bench (configs/kitti_ssl.json, bf16
           network), shortened: eager and graph windows in turns; K1 and K2
           launched, K3 not
  breakdown  python -m monodepth2_torch.tools.profile_breakdown, shortened,
           with its graph_step block: by kernel name K1 = K2 = 1 and K3 = 0
           a replayed step
  native   the native decoder (monodepth2_torch/data/native.py): whether the
           compiler finds png.h and jpeglib.h, the library built from a
           clean build directory; where it builds, its frames against PIL's
           on 1241×376 PNGs (gray within 1/255, an RGB resize within a mean
           3/255); where it does not, available() False with the missing
           header named in build_error() and a dataset that asked for it
           decoding through PIL, with a warning. Then tools.loader_bench
           (48 triplets of 1241×376 PNGs to 416×128, 1/2/4 workers, native
           and PIL) beside the replayed bf16 step's img/s from a shortened
           bench, and the host's CPU and cores
  dp       data parallelism: (a) one rank in this process, on the world-1
           NCCL mesh that parallel.make_mesh() sets up alone: fit over it
           (ResNet-18 416×128 gray batch 4, steps_per_call 2, fp32, TF32
           off, 10 steps) in a profiler window against fit without a mesh
           from the same seed on the same data order: the step-1 loss
           within 1e-6 rel, steps 2-3 within 2e-3, the replayed steps 4-10
           within 0.25 as a sanity bound (fp32 trajectories part: up to
           0.12 measured on the H100; the plain fit through the plain warp
           is reported beside as a yardstick); the collectives the
           all-reduce wrapper saw while the graph was captured (4 a
           BatchNorm + grads + metrics = 82); K1 = K2 = 10 and K3 = 0 by
           name. What holds the semantics over the trajectory: the same
           two fits in float64 through the plain warp at 64×32, 10 steps,
           each step's loss and the final params within 1e-12 relative
           (1.9e-14 measured). Then 5 replayed data-parallel micro-steps,
           each against two eager twins loaded from its state: the eager
           data-parallel step (loss within 1e-4 rel, params 1e-6 and
           Adam's moments 1e-4 relative L2, as the graph phase) and the
           plain step (loss within 1e-6 rel, grads 1.6e-2 relative L2);
           and from each state a float64 plain step, TF32 off, against
           which the plain fp32 step (cuDNN's BatchNorm) and the
           data-parallel fp32 step (the hand-written one), all three
           through the plain warp, are each within 1.6e-2 relative L2 (2×
           the larger error measured, 7.75e-3). Then the world-1
           data-parallel scanned step against the plain one
           (configs/kitti_ssl.json, bf16), windows in turns.
           (b) tools.dp_worker as 2 processes on this one card over gloo
           with CUDA tensors (NCCL refuses two ranks on one device), fit at
           64×32 in float64 with the plain warp, beside a 1-process run:
           the ranks' states equal bitwise, and within 1e-9 of each leaf's
           largest entry of the 1-process run's
  cli      the command line, python -m monodepth2_torch.cli, each subcommand
           a process with a timeout in a temporary directory, concurrent
           where none reads another's output (any nonzero exit fails the
           phase): train --data driving (16 scenes, 416×128, ResNet-18,
           batch 4, bf16) to step 12 ("done at step 12", ckpt-12,
           metrics.jsonl with finite losses, params unlike the seed's) and
           the same command resumed to 16; train --distributed under
           torchrun, one process over NCCL, to step 4; --mesh 2 in one
           process refused with the torchrun line; eval-depth --synthetic
           --limit 4 (finite abs_rel); export --fp32 --platforms cuda
           (meta: the sidecar's 416×128×1) and --platforms tpu,cpu refused;
           serve on a free port, --no-warmup, one POST within 1e-6 of
           serving.load_inference on the same input, TF32 off in both;
           eval-image on 4 PNGs (4 disparity PNGs); simple-depth --iters 20
           (the loss falls); profile --steps 2 (its trace.json names K1 and
           K2 twice each, K3 never, the projection's kernels 4 times each)
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
           of d_img that its times include (`bound_ms_with_fill`); and
           project_fwd and project_bwd for one source at the main path's
           shape, K shared (`per_item_K` beside): the same three times, the
           plain twin's, the library's (autograd of project_plain: the
           forward with grad recording, the backward alone on a kept graph)
           and the bound from the bytes each must move

The line before the last is {"kernels": [...]}, where the `launches` of K1
and K2 are the first fit's, counted by kernel name, and K3's the warp
bench's (training never runs it), `launches_serving` those of the
eval, export and serve phases (0) and `launches_cli_profile` those in the
trace of the cli phase's `profile --steps 2`; the projection's two rows
give theirs by kernel name (project_bwd's for both of its kernels), every
count reset to 0 just before its phase; the last line is
{"ok": true, "device": {...}}. Any failed phase raises and exits nonzero.
Without a CUDA device, or beside no monodepth2_torch package, it prints no
result and exits nonzero. Every subprocess has a timeout; the threads are
fit's data loader's, daemon threads that stop once fit drops its iterator,
and the servers' and their clients', each shut down or joined with a
timeout; the dp phase's worker processes and the cli phase's are waited
for with a timeout and killed after (the server is terminated).
"""

from __future__ import annotations

import copy
import json
import pathlib
import sys
import tempfile
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
# the projection (ops/cuda/project.cu); project_bwd's launch enqueues the
# last two
PROJECT_KERNELS = ("project_fwd_kernel", "project_bwd_kernel", "project_bwd_reduce_kernel")


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
    """Zero the launch counters of the warp's and the projection's wrappers."""
    from monodepth2_torch.ops import geometry

    for k in (*GS.KERNELS, *geometry.KERNELS):
        k.launches = 0


def counts(GS):
    return {k.name: k.launches for k in GS.KERNELS}


def project_counts() -> dict:
    """The projection wrappers' launches since the last reset."""
    from monodepth2_torch.ops import geometry

    return {k.name: k.launches for k in geometry.KERNELS}


def project_by_name(names) -> dict:
    """Launches of each projection kernel among device activity names."""
    names = list(names)
    return {k: sum(1 for n in names if k in n) for k in PROJECT_KERNELS}


def compare_project(torch, PG, points, K, R, t, g, w, h) -> dict:
    """project_fwd and project_bwd against their plain twins, at the limits
    of tests/test_torch_cuda.py: uv within 1e-6 abs; d_points within 1e-5
    rel + 1e-6 abs; dR and dt within 1e-5 relative Frobenius; a second
    backward the same bits; one launch of each wrapper. Raises if any fails."""
    before = project_counts()
    uv = PG.project_fwd(points, K, R, t, w, h)
    d_points, dR, dt = PG.project_bwd(points, K, R, t, g, w, h)
    again = PG.project_bwd(points, K, R, t, g, w, h)
    uv_p = PG.project_plain(points, K, R, t, w, h)
    d_points_p, dR_p, dt_p = PG.project_bwd_plain(points, K, R, t, g, w, h)
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in project_counts().items()}

    def rel_fro(x, ref):
        return float((x.double() - ref.double()).norm() / ref.double().norm())

    errs = dict(
        uv_max_abs_err=float((uv - uv_p).abs().max()),
        d_points_max_abs_err=float((d_points - d_points_p).abs().max()),
        d_points_excess=float(((d_points - d_points_p).abs() - (1e-6 + 1e-5 * d_points_p.abs())).max()),
        dR_rel_fro=rel_fro(dR, dR_p), dt_rel_fro=rel_fro(dt, dt_p),
        bwd_bitwise_repeat=all(torch.equal(a, b) for a, b in zip(again, (d_points, dR, dt))),
        launches=launched,
    )
    check(all(bool(torch.isfinite(x).all()) for x in (uv, d_points, dR, dt)), "non-finite projection output")
    check(errs["uv_max_abs_err"] <= 1e-6, f"project_fwd disagrees with plain: {errs}")
    check(errs["d_points_excess"] <= 0, f"project_bwd's d_points disagree with plain: {errs}")
    check(errs["dR_rel_fro"] <= 1e-5 and errs["dt_rel_fro"] <= 1e-5, f"project_bwd's dR, dt disagree: {errs}")
    check(errs["bwd_bitwise_repeat"], f"project_bwd's repeat differs: {errs}")
    check(launched == {PG.project_fwd.name: 1, PG.project_bwd.name: 2}, f"projection launches {launched}")
    return errs


def load_twin(twin, state) -> None:
    """Make `twin` a copy of `state`: a deepcopy of the optimizer's state,
    since Optimizer.load_state_dict keeps the very tensors it is given (the
    twin's Adam would otherwise update the state's moments too)."""
    twin.model.load_state_dict(state.model.state_dict())
    twin.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    twin.step = state.step


def rel_l2(xs, ys) -> float:
    """Relative L2 distance of two lists of tensors, taken as one vector."""
    import torch

    x = torch.cat([t.detach().flatten().double() for t in xs])
    y = torch.cat([t.detach().flatten().double() for t in ys])
    return float((x - y).norm() / y.norm())


def adam_state(state, key) -> list:
    return [state.optimizer.state[p][key] for p in state.model.parameters()]


def graph_config(TrainConfig, **kw):
    """The graph phases' config: the slice's size, disp_reg on, and a warmup
    and decay that change the lr while the graph replays steps 3-12."""
    return TrainConfig(
        target_size=(WIDTH, HEIGHT), batch_size=BATCH, in_channels=1, steps_per_call=10,
        disp_reg=0.01, disp_reg_steps=12, lr_warmup_steps=5, lr_decay_steps=9, lr_decay_factor=0.1, **kw,
    )


def graph_phase(torch, np, GS, ctx, device="cuda") -> dict:
    """Replayed fp32 micro-steps against an eager twin from the same state,
    and the warp and projection kernels counted by name in a window of
    replays."""
    from monodepth2_torch.device import synchronize
    from monodepth2_torch.models import Model
    from monodepth2_torch.tools.profile_breakdown import kernel_counts
    from monodepth2_torch.training import TrainConfig, create_train_state, make_scanned_train_step, make_train_step
    from monodepth2_torch.training.state import WARMUP_STEPS, lr_at
    from monodepth2_torch.utils.profiler import trace

    cfg = graph_config(TrainConfig)
    state = create_train_state(Model.create(depth=18, in_channels=1, device=device), cfg)
    twin = create_train_state(Model.create(depth=18, in_channels=1, device=device), cfg)
    scanned, eager = make_scanned_train_step(ctx, cfg), make_train_step(ctx, cfg)
    n_replays = 10
    rng = np.random.default_rng(1)
    stack = torch.from_numpy(
        rng.uniform(size=(WARMUP_STEPS + 2 * n_replays, BATCH, 3, HEIGHT, WIDTH, 1)).astype(np.float32)
    ).to(device)
    reset(GS)
    scanned(state, stack[:WARMUP_STEPS])  # eager warm-up micro-steps
    rows = []
    for i in range(WARMUP_STEPS, WARMUP_STEPS + n_replays):
        load_twin(twin, state)
        step = state.step
        before = [p.detach().clone() for p in state.model.parameters()]
        _, m, aux = scanned(state, stack[i : i + 1])  # the first of these captures
        _, tm, _ = eager(twin, stack[i])
        reg_want = cfg.disp_reg * min(max(1.0 - step / cfg.disp_reg_steps, 0.0), 1.0)
        rows.append(dict(
            step=step, loss=m["loss"].item(), twin_loss=tm["loss"].item(),
            lr_adam=state.optimizer.param_groups[0]["lr"].item(), lr_at=lr_at(cfg, step),
            disp_reg_weight=m["disp_reg_weight"].item(), disp_reg_formula=reg_want,
            param_rel_l2=rel_l2(state.model.parameters(), twin.model.parameters()),
            update_rel_l2=rel_l2(before, twin.model.parameters()),
            **{f"{key}_rel_l2": rel_l2(adam_state(state, key), adam_state(twin, key))
               for key in ("exp_avg", "exp_avg_sq")},
            adam_steps_equal=all(torch.equal(a, b) for a, b in zip(adam_state(state, "step"),
                                                                   adam_state(twin, "step"))),
        ))
    for r in rows:
        check(abs(r["loss"] - r["twin_loss"]) <= 1e-4 * abs(r["twin_loss"]), f"replayed loss vs eager twin: {r}")
        check(abs(r["lr_adam"] - r["lr_at"]) <= 1e-6 * r["lr_at"], f"lr Adam read vs lr_at: {r}")
        check(abs(r["disp_reg_weight"] - r["disp_reg_formula"]) <= 1e-6 * cfg.disp_reg, f"disp_reg weight: {r}")
        # one update moves the params by update_rel_l2 (~5e-5 at the decayed
        # lr): a skipped or mis-scaled Adam step shows far above 1e-6
        check(r["param_rel_l2"] <= 1e-6, f"params after the replayed update vs the eager twin's: {r}")
        check(r["exp_avg_rel_l2"] <= 1e-4 and r["exp_avg_sq_rel_l2"] <= 1e-4 and r["adam_steps_equal"],
              f"Adam's state after the replayed update vs the eager twin's: {r}")
    lrs = {r["lr_at"] for r in rows}
    regs = {r["disp_reg_formula"] for r in rows}
    check(len(lrs) >= 3 and len(regs) >= 3, f"the schedules did not change while replaying: {lrs} {regs}")
    check(tuple(aux["disparity"].shape) == (BATCH, HEIGHT, WIDTH, 1), "graph aux disparity shape")
    wrapper_counts = counts(GS)
    # the warp kernels inside replays, counted by name
    synchronize(torch.device(device))
    with trace(host=False) as prof:
        _, m, _ = scanned(state, stack[WARMUP_STEPS + n_replays :])
        synchronize(torch.device(device))
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = kernel_counts(names)
    check(bool(torch.isfinite(m["loss"]).all()), f"non-finite replayed losses {m['loss']}")
    want = {"grid_sample_fwd_kernel": n_replays, "grid_sample_bwd_uv_kernel": n_replays,
            "grid_sample_bwd_img_kernel": 0}
    check(by_name == want, f"warp kernels in {n_replays} replayed steps by name {by_name}, want {want}")
    # the projection kernels (ops/cuda/project.cu): one of each a source
    projected = project_by_name(names)
    want = dict.fromkeys(projected, len(cfg.source_ids) * n_replays)
    check(projected == want, f"projection kernels in {n_replays} replayed steps by name {projected}, want {want}")
    return dict(rows=rows, replayed_kernels_by_name=by_name, replayed_projection_by_name=projected,
                device_activities=len(names), wrapper_launches=wrapper_counts, steps=state.step)


def graph_bf16_phase(torch, np, ctx, device="cuda") -> dict:
    """The graph phase's configuration with the network in bf16: 3 calls of
    10 micro-steps (3 eager, 27 replayed), all finite, then the replayed
    ms/step over 3 more calls."""
    from monodepth2_torch.models import Model
    from monodepth2_torch.training import TrainConfig, create_train_state, make_scanned_train_step
    from monodepth2_torch.utils.profiler import wall_ms

    cfg = graph_config(TrainConfig, compute_dtype="bfloat16")
    state = create_train_state(Model.create(depth=18, in_channels=1, device=device), cfg)
    scanned = make_scanned_train_step(ctx, cfg)
    rng = np.random.default_rng(2)
    stack = torch.from_numpy(rng.uniform(size=(10, BATCH, 3, HEIGHT, WIDTH, 1)).astype(np.float32)).to(device)
    losses = []
    for _ in range(3):
        _, m, _ = scanned(state, stack)
        losses += m["loss"].tolist()
    check(all(np.isfinite(losses)), f"non-finite bf16 graph losses {losses}")
    ms = [t / 10 for t in wall_ms(lambda: scanned(state, stack), torch.device(device), 3, warmup=0, windows=2)]
    return dict(losses=losses, replayed_ms_per_step=ms, steps=state.step)


class _Recording:
    """A dataset that records the indices asked of it (from worker threads)."""

    def __init__(self, dataset):
        import threading

        self.dataset, self.requested, self.lock = dataset, [], threading.Lock()
        for attr in ("K", "target_id", "source_ids"):
            setattr(self, attr, getattr(dataset, attr))

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        with self.lock:
            self.requested.append(int(i))
        return self.dataset[i]


def fit_phase(torch, np, GS, tmp, device="cuda") -> tuple:
    """fit to step 20, then a fit to 30 that resumes, in the directory `tmp`;
    see the docstring. Returns the phase's record and the first fit's last
    checkpoint."""
    from monodepth2_torch.bench import load_config
    from monodepth2_torch.data import SyntheticDriving
    from monodepth2_torch.device import synchronize
    from monodepth2_torch.models import Model
    from monodepth2_torch.tools.profile_breakdown import kernel_counts
    from monodepth2_torch.training import create_train_state, load_checkpoint, save_checkpoint
    from monodepth2_torch.training.loop import _crossed, fit
    from monodepth2_torch.utils.profiler import trace

    out = {}
    cfg = load_config(
        target_size=(WIDTH, HEIGHT), batch_size=BATCH, log_every=5, save_every=10,
        log_dir=f"{tmp}/logs", save_dir=f"{tmp}/ckpts",
    )
    check(cfg.compute_dtype == "bfloat16" and cfg.steps_per_call == 10 and cfg.disp_reg > 0,
          f"configs/kitti_ssl.json changed: {cfg}")
    t = time.perf_counter()
    driving = SyntheticDriving(n=48, target_size=(WIDTH, HEIGHT))  # renders each item once
    ds = _Recording(driving)
    per_epoch = len(ds) // BATCH
    reset(GS)
    synchronize(torch.device(device))
    with trace(host=False) as prof:
        state, _ = fit(cfg, ds, max_steps=20, verbose=False, device=device)
        synchronize(torch.device(device))
    calls, projection_calls = counts(GS), project_counts()
    # the wrappers run in the eager warm-up steps and in the capture,
    # which records the kernels without launching them; the replays run
    # no Python, so the launches are counted by kernel name
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, projected = kernel_counts(names), project_by_name(names)
    out["first_fit"] = dict(step=state.step, s=round(time.perf_counter() - t, 3), wrapper_calls=calls,
                            launches_by_name=by_name, projection_wrapper_calls=projection_calls,
                            projection_launches_by_name=projected)
    check(calls[GS.grid_sample_fwd.name] > 0 and calls[GS.grid_sample_bwd_uv.name] > 0
          and calls[GS.grid_sample_bwd_img.name] == 0, f"fit's wrapper calls {calls}: want K1, K2 and no K3")
    want = {"grid_sample_fwd_kernel": state.step, "grid_sample_bwd_uv_kernel": state.step,
            "grid_sample_bwd_img_kernel": 0}
    check(by_name == want, f"fit's launches by kernel name {by_name}, want one K1 and K2 a step: {want}")
    want = dict.fromkeys(PROJECT_KERNELS, len(cfg.source_ids) * state.step)
    check(projected == want, f"fit's projection launches by kernel name {projected}, want one a source: {want}")
    check(all(n > 0 for n in projection_calls.values()), f"fit's projection wrapper calls {projection_calls}")
    first = state.step

    # a new recorder: the first fit's loader thread may still be loading
    ds = _Recording(driving)
    t = time.perf_counter()
    state, _ = fit(cfg, ds, max_steps=30, verbose=False, device=device)
    out["second_fit"] = dict(step=state.step, s=round(time.perf_counter() - t, 3))
    # the resumed run starts at the first fit's step, at its data cursor:
    # the rest of that epoch in its shuffle order (loader.py)
    epoch, cursor = divmod(first, per_epoch)
    order = np.arange(len(ds))
    np.random.default_rng(cfg.seed + 1000003 * (epoch + 1)).shuffle(order)
    rest = order[cursor * BATCH : per_epoch * BATCH]
    check(sorted(ds.requested[: len(rest)]) == sorted(rest.tolist()),
          f"resumed data order {ds.requested[:len(rest)]}, want {rest.tolist()}")

    # the calls of both fits as fit groups the batches: steps_per_call a
    # call, a short tail at each epoch's end, until max_steps is reached
    calls = []
    for start, max_steps in ((0, 20), (first, 30)):
        step = start
        while step < max_steps:
            k = min(cfg.steps_per_call, per_epoch - step % per_epoch)
            step += k
            calls.append((step, k))
    log_want = [(e // cfg.log_every) * cfg.log_every for e, k in calls if _crossed(cfg.log_every, e, k)]
    save_want = {f"ckpt-{e}" for e, k in calls if _crossed(cfg.save_every, e, k)}
    save_want |= {f"ckpt-{first}", f"ckpt-{state.step}"}  # each fit's final checkpoint
    logged = [json.loads(line)["step"] for line in open(f"{tmp}/logs/metrics.jsonl")]
    ckpts = {f.name[: -len(".npz")] for f in pathlib.Path(cfg.save_dir).glob("*.npz")}
    check(logged == log_want, f"metrics.jsonl steps {logged}, want {log_want}")
    check(ckpts == save_want, f"checkpoints {sorted(ckpts)}, want {sorted(save_want)}")
    check(all(np.isfinite(json.loads(line)["loss"]) for line in open(f"{tmp}/logs/metrics.jsonl")),
          "non-finite logged loss")

    # bitwise round-trip of the trained state through save and load
    save_checkpoint(f"{tmp}/roundtrip", state)
    back = load_checkpoint(f"{tmp}/roundtrip", create_train_state(
        Model.create(depth=cfg.encoder_depth, in_channels=cfg.in_channels, device=device), cfg))
    same = all(torch.equal(a, b) for a, b in zip(state.model.state_dict().values(),
                                                 back.model.state_dict().values()))
    for p, q in zip(state.model.parameters(), back.model.parameters()):
        same &= all(torch.equal(state.optimizer.state[p][k], back.optimizer.state[q][k])
                    for k in ("exp_avg", "exp_avg_sq", "step"))
    check(same and back.step == state.step, "checkpoint round-trip is not bitwise")
    out.update(metrics_steps=logged, checkpoints=sorted(ckpts), resumed_at=first, data_cursor=[epoch, cursor],
               final_step=state.step)
    return out, f"{cfg.save_dir}/ckpt-{first}"


def held_out(np, n: int):
    """n held-out SyntheticDriving target frames (H,W,1) and their depth."""
    from monodepth2_torch.data import SyntheticDriving

    held = SyntheticDriving(n=n, target_size=(WIDTH, HEIGHT), seed=9999)
    return [held[i][held.target_id] for i in range(n)], [held.gt_depth_for(i) for i in range(n)]


def eval_phase(torch, np, GS, ckpt, tmp, device="cuda") -> tuple:
    """eval.load_model, eval_images and eval_depth_accuracy on the first
    fit's last checkpoint; returns the record and the loaded model."""
    from PIL import Image

    from monodepth2_torch.device import synchronize
    from monodepth2_torch.eval import eval_depth_accuracy, eval_images, load_model, make_infer_fn, sidecar_config
    from monodepth2_torch.training import TrainConfig

    t = time.perf_counter()
    kind = torch.device(device).type
    cfg = sidecar_config(ckpt)
    check(cfg is not None and cfg.compute_dtype == "bfloat16", f"{ckpt}: sidecar config {cfg}")
    # the caller's cfg names another encoder: the sidecar's architecture wins
    caller = TrainConfig(target_size=(WIDTH, HEIGHT), encoder_depth=34, compute_dtype=cfg.compute_dtype)
    frames, gts = held_out(np, 8)
    frame_dir, out_dir = pathlib.Path(tmp, "frames"), pathlib.Path(tmp, "disparity")
    frame_dir.mkdir()
    for i, f in enumerate(frames):
        Image.fromarray((f[..., 0] * 255).round().astype(np.uint8), "L").save(frame_dir / f"{i:06d}.png")
    reset(GS)
    model = load_model(caller, ckpt, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    check(model.encoder.depth == 18, f"load_model built a ResNet-{model.encoder.depth}, not the sidecar's 18")
    out = make_infer_fn(model, cfg.compute_dtype)(np.stack(frames[:2]))
    check(out.device.type == kind and out.dtype == torch.float32 and tuple(out.shape) == (2, HEIGHT, WIDTH),
          f"infer fn output {out.device} {out.dtype} {tuple(out.shape)}")
    n = eval_images(cfg, ckpt, str(frame_dir), str(out_dir), batch_size=4, device=device)
    pngs = sorted(p.name for p in out_dir.glob("*.png"))
    check(n == 8 and pngs == [f"d-{i}.png" for i in range(8)], f"eval_images wrote {n}: {pngs}")
    check(all(Image.open(out_dir / p).size == (WIDTH, HEIGHT) for p in pngs), "disparity PNG size")
    metrics = eval_depth_accuracy(cfg, ckpt, frames, gts, batch_size=4, device=device)
    check(all(np.isfinite(v) for v in metrics.values()), f"non-finite depth metrics {metrics}")
    synchronize(torch.device(device))
    launches = counts(GS)
    check(all(v == 0 for v in launches.values()), f"inference launched a warp kernel: {launches}")
    return dict(wall_s=round(time.perf_counter() - t, 3), checkpoint=pathlib.Path(ckpt).name, params=n_params,
                images=n, depth_metrics=metrics, infer_device=str(out.device), launches=launches), model, cfg


def export_phase(torch, np, GS, model, cfg, tmp, device="cuda") -> tuple:
    """fp32 and bf16 artifacts exported and loaded on the card, against live
    inference; a profiled artifact call. Returns the record and the fp32
    artifact's path."""
    from dataclasses import replace

    from monodepth2_torch.device import synchronize
    from monodepth2_torch.serving import export_inference, load_inference, make_inference_fn
    from monodepth2_torch.tools.profile_breakdown import kernel_counts
    from monodepth2_torch.utils.profiler import trace

    t = time.perf_counter()
    kind = torch.device(device).type
    cfg32, cfg16 = replace(cfg, compute_dtype="float32"), replace(cfg, compute_dtype="bfloat16")
    paths = {tag: f"{tmp}/depth.{tag}.pt2" for tag in ("fp32", "bf16")}
    t_export = {}
    for tag, c in (("fp32", cfg32), ("bf16", cfg16)):
        t0 = time.perf_counter()
        export_inference(model, c, paths[tag])
        t_export[tag] = round(time.perf_counter() - t0, 3)
    served32 = load_inference(paths["fp32"], device=device)
    served16 = load_inference(paths["bf16"], device=device)
    check(served32.meta["platforms"] == [kind] and served32.meta["input_shape"] == [None, HEIGHT, WIDTH, 1],
          f"artifact meta {served32.meta}")
    live32 = make_inference_fn(model, cfg32)
    rng = np.random.default_rng(3)
    errs, bf16 = {}, {}
    # TF32 off, as the slice phase: the fp32 comparison is of fp32 arithmetic
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for n in (1, 3, 64):
            x = rng.uniform(size=(n, HEIGHT, WIDTH, 1)).astype(np.float32)
            out = served32(x)
            with torch.inference_mode():
                ref = live32(torch.from_numpy(x).to(device))
            check(all(v.device.type == kind and v.dtype == torch.float32 for v in out.values()),
                  f"artifact outputs {[(v.device, v.dtype) for v in out.values()]}")
            check(tuple(out["disparity"].shape) == (n, HEIGHT, WIDTH, 1), f"disparity {tuple(out['disparity'].shape)}")
            errs[n] = {k: float((out[k] - ref[k]).abs().max()) for k in ("disparity", "depth")}
            check(max(errs[n].values()) <= 1e-5, f"fp32 artifact vs live at batch {n}: {errs[n]}")
        out16 = served16(x)
        d16, d32 = out16["disparity"], ref["disparity"]
        rel_depth = float(((out16["depth"] - ref["depth"]).abs() / ref["depth"].abs()).max())
        bf16 = dict(batch=64, disparity_max_abs=float((d16 - d32).abs().max()),
                    disparity_mean_abs=float((d16 - d32).abs().mean()), depth_max_rel=rel_depth)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    check(out16["disparity"].dtype == torch.float32 and out16["disparity"].device.type == kind, "bf16 artifact output")
    check(bf16["disparity_max_abs"] <= 3e-2 and bf16["disparity_mean_abs"] < 5e-3 and rel_depth <= 0.1,
          f"bf16 artifact vs fp32 live: {bf16}")
    # one artifact call in a profiler window, its input already on the card:
    # CUDA kernels, and no copy between host and card (a CPU fallback needs one)
    x_dev = torch.from_numpy(x).to(device)
    graph_devices = {str(n.kwargs["device"]) for n in served32._module.graph.nodes if "device" in n.kwargs}
    tensors = list(served32._module.parameters()) + list(served32._module.buffers())
    check(all(t.device.type == kind for t in tensors), "an artifact tensor is not on the card")
    check(all(d.startswith(kind) for d in graph_devices), f"the artifact's graph names devices {graph_devices}")
    synchronize(torch.device(device))
    with trace(host=True) as prof:
        served32(x_dev)
        synchronize(torch.device(device))
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [n for n in names if "memcpy" in n.lower()]
    check(len(names) > 0 and not copies, f"profiled artifact call: {len(names)} device events, copies {copies}")
    by_name = kernel_counts(names)
    check(sum(by_name.values()) == 0, f"the artifact launched a warp kernel: {by_name}")
    return dict(wall_s=round(time.perf_counter() - t, 3), export_s=t_export, fp32_vs_live_max_abs=errs,
                bf16_vs_fp32_live=bf16, artifact_bytes={k: pathlib.Path(p).stat().st_size for k, p in paths.items()},
                profiled_device_events=len(names), graph_devices=sorted(graph_devices)), paths["fp32"]


def serve_phase(torch, np, GS, artifact, device="cuda") -> dict:
    """build_server over the fp32 artifact on the card, 16 concurrent requests
    of three encodings, each response against the artifact on its rows."""
    import io
    import threading
    import urllib.request

    from PIL import Image

    from monodepth2_torch.eval import _load_image
    from monodepth2_torch.server import build_server
    from monodepth2_torch.serving import load_inference

    t = time.perf_counter()
    served = load_inference(artifact, device=device)
    server, batcher = build_server(artifact, host="127.0.0.1", port=0, buckets=(1, 4, 16, 64), warmup=True,
                                   device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(4)
    requests = []  # (body, headers, rows the artifact sees)
    for i in range(16):
        n = 1 + i % 3
        if i == 15:
            img = (rng.uniform(size=(HEIGHT * 2, WIDTH * 2)) * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img, "L").save(buf, format="PNG")
            body = buf.getvalue()
            rows = _load_image(io.BytesIO(body), WIDTH, HEIGHT, True)[None]
            requests.append((body, {"Content-Type": "image/png"}, rows))
        elif i % 2:
            x8 = (rng.uniform(size=(n, HEIGHT, WIDTH, 1)) * 255).astype(np.uint8)
            requests.append((x8.tobytes(), {"Content-Type": "application/octet-stream", "X-Input-Dtype": "uint8",
                                            "X-Shape": f"{n},{HEIGHT},{WIDTH},1"}, x8.astype(np.float32) / 255.0))
        else:
            x = rng.uniform(size=(n, HEIGHT, WIDTH, 1)).astype(np.float32)
            requests.append((x.tobytes(), {"Content-Type": "application/octet-stream",
                                           "X-Shape": f"{n},{HEIGHT},{WIDTH},1"}, x))
    results, errors = [None] * len(requests), []
    start = threading.Barrier(len(requests))

    def post(i):
        body, headers, _ = requests[i]
        req = urllib.request.Request(base + "/v1/depth", data=body, method="POST", headers=headers)
        try:
            start.wait(timeout=60)
            with urllib.request.urlopen(req, timeout=120) as r:
                out = np.load(io.BytesIO(r.read()))
                results[i] = {k: out[k] for k in out.files}
        except Exception as e:  # noqa: BLE001 — reported below, and the phase fails on it
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    try:
        threads = [threading.Thread(target=post, args=(i,), daemon=True) for i in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        check(not any(th.is_alive() for th in threads) and not errors, f"requests failed: {errors}")
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        batcher.close(timeout=30)
        thread.join(timeout=30)
    check(not thread.is_alive(), "the server thread did not stop")
    worst = {}
    for i, (_, _, rows) in enumerate(requests):
        want = {k: v.cpu().numpy() for k, v in served(rows).items()}
        for k in ("disparity", "depth"):
            worst[k] = max(worst.get(k, 0.0), float(np.abs(results[i][k] - want[k]).max()))
    check(max(worst.values()) <= 1e-6, f"HTTP responses vs the artifact on their rows: {worst}")
    check(health["requests"] == len(requests) and health["batches"] < health["requests"],
          f"no coalescing: {health}")
    launches = counts(GS)
    check(all(v == 0 for v in launches.values()), f"serving launched a warp kernel: {launches}")
    return dict(wall_s=round(time.perf_counter() - t, 3), requests=len(requests), max_abs_vs_artifact=worst,
                healthz=health, launches=launches)


def native_phase(torch, np, device="cuda") -> dict:
    """The native decoder: the compiler asked for its headers, the library
    built from a clean build directory; where it builds, its frames held
    against PIL's on a tree of 1241×376 frames (grayscale within 1/255, an
    RGB resize within tests/test_native_loader.py's mean 3/255); where it
    does not, unavailable with the missing header named, and a dataset that
    asks for it decoding through PIL. Then tools.loader_bench at its
    defaults (48 triplets of 1241×376 PNGs, 1, 2 and 4 workers) with a
    shortened bench: triplets/s beside the replayed step's img/s."""
    import shutil
    import subprocess
    import warnings

    from PIL import Image

    from monodepth2_torch.data import KittiDataset, native
    from monodepth2_torch.tools import loader_bench

    headers = {}
    for h in ("png.h", "jpeglib.h"):
        try:
            proc = subprocess.run([*native._cxx(), "-E", "-x", "c++", "-"], input=f"#include <{h}>\n",
                                  capture_output=True, text=True, timeout=60)
            headers[h] = proc.returncode == 0
        except OSError:  # no compiler: no header either
            headers[h] = False
    shutil.rmtree(native.BUILD_DIR, ignore_errors=True)
    native.reset()
    t = time.perf_counter()
    built = native.available()
    out = dict(headers=headers, built=built, build_s=round(time.perf_counter() - t, 3))
    with tempfile.TemporaryDirectory() as root:
        loader_bench.build_tree(root, 1, *loader_bench.KITTI_ODOMETRY_SIZE)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ds = KittiDataset(root, "00", target_size=(WIDTH, HEIGHT), use_native=True)
        if built:
            check(all(headers.values()) and ds.decoder == "native", f"native built, headers {headers}, {ds.decoder}")
            frame = f"{root}/sequences/00/image_0/000000.png"
            w, h = loader_bench.KITTI_ODOMETRY_SIZE
            gray = native.load_resize(frame, w, h, 1)[..., 0]
            pil = np.asarray(Image.open(frame).convert("L"), np.float32) / 255.0
            rgb = np.stack([np.asarray(Image.open(frame))] * 3, axis=-1)
            rgb[..., 1] = 255 - rgb[..., 1]
            Image.fromarray(rgb, "RGB").save(f"{root}/rgb.png")
            small = native.load_resize(f"{root}/rgb.png", WIDTH, HEIGHT, 3)
            pil_small = np.asarray(Image.open(f"{root}/rgb.png").resize((WIDTH, HEIGHT), Image.BILINEAR),
                                   np.float32) / 255.0
            out.update(gray_max_abs_err=float(np.abs(gray - pil).max()),
                       rgb_resize_mean_abs_err=float(np.abs(small - pil_small).mean()))
            check(out["gray_max_abs_err"] <= 1 / 255 and out["rgb_resize_mean_abs_err"] < 3 / 255,
                  f"native frames vs PIL: {out}")
        else:
            err = native.build_error() or ""
            missing = [h for h in headers if not headers[h]]
            check(bool(missing) and any(h in err for h in missing) and ds.decoder == "pil"
                  and any("native decoder unavailable" in str(w.message) for w in caught),
                  f"the native decoder did not build, headers {headers}: {err[-2000:]}")
            out["build_error_tail"] = err.strip().splitlines()[-3:]
    bench = loader_bench.main(["--device", device, "--step-steps", "10"])
    rows = [r for r in bench["rows"] if "triplets_per_s" in r]
    check(len(rows) == (6 if built else 3) and all(np.isfinite(r["triplets_per_s"]) for r in rows),
          f"loader bench rows {bench['rows']}")
    out.update(rows=bench["rows"], step=bench["step"], frames=bench["frames"],
               host=[bench["host_cpu"], bench["host_cores"], bench["host_load"]])
    return out


class _Reordered:
    """`dataset` seen through a permutation of its indices."""

    def __init__(self, dataset, perm):
        self.dataset, self.perm = dataset, perm
        for attr in ("K", "target_id", "source_ids"):
            setattr(self, attr, getattr(dataset, attr))

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        return self.dataset[int(self.perm[i])]


def sampler_order(np, n: int, seed: int) -> tuple:
    """(order, perm): the mesh sampler's epoch-0 order of n items, and the
    permutation through which fit without a mesh, whose loader shuffles on
    its own, reads the items in that order (loader.py, distributed.py)."""
    order_s = np.arange(n)
    np.random.default_rng([seed, 0]).shuffle(order_s)  # the sampler's epoch 0
    order_l = np.arange(n)
    np.random.default_rng(seed + 1000003).shuffle(order_l)  # the loader's first epoch
    perm = np.empty_like(order_s)
    perm[order_l] = order_s
    return order_s, perm


def recorded_fit(loop, *args, **kw) -> tuple:
    """loop.fit(*args, **kw) and the loss of each of its steps: the scanned
    step builders fit calls are wrapped so that every call records its
    losses. Returns (state, losses)."""
    losses = []
    patched = (loop.make_parallel_scanned_train_step, loop.make_scanned_train_step)

    def recording(make):
        def build(*a, **k):
            step = make(*a, **k)

            def call(state, batch):
                state, m, aux = step(state, batch)
                losses.extend(m["loss"].tolist())
                return state, m, aux
            return call
        return build

    loop.make_parallel_scanned_train_step, loop.make_scanned_train_step = map(recording, patched)
    try:
        state, _ = loop.fit(*args, **kw)
    finally:
        loop.make_parallel_scanned_train_step, loop.make_scanned_train_step = patched
    return state, losses


def float64_fits(torch, np, mesh, tmp, device="cuda") -> dict:
    """The data-parallel semantics over a trajectory: fit over the world-1
    mesh against fit without one, both in float64 (torch's default dtype
    while they run) through the plain warp (the kernels take fp32), at 64×32
    (ResNet-18, gray, batch 4, steps_per_call 2), 10 steps from the same
    seed on the same data order. In float64 the hand-written BatchNorm and
    cuDNN's, and the two paths' sums, part by rounding that Adam cannot raise
    to lr-sized steps, so the trajectories stay together where fp32 ones
    part (float64 on the CPU: 1e-14)."""
    import dataclasses

    from monodepth2_torch.data import SyntheticDriving
    from monodepth2_torch.training import TrainConfig
    from monodepth2_torch.training import loop

    w, h = 64, 32
    cfg = TrainConfig(target_size=(w, h), batch_size=BATCH, in_channels=1, steps_per_call=2, warp_method="gather",
                      log_every=0, save_every=0, log_dir=f"{tmp}/f64/logs", save_dir=f"{tmp}/f64/ckpts")
    driving = SyntheticDriving(n=48, target_size=(w, h))
    _, perm = sampler_order(np, len(driving), cfg.seed)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        t = time.perf_counter()
        state, losses = recorded_fit(loop, cfg, driving, mesh=mesh, max_steps=10, verbose=False, device=device)
        plain_cfg = dataclasses.replace(cfg, log_dir=f"{tmp}/f64p/logs", save_dir=f"{tmp}/f64p/ckpts")
        plain, plain_losses = recorded_fit(loop, plain_cfg, _Reordered(driving, perm), max_steps=10, verbose=False,
                                           device=device)
        s = time.perf_counter() - t
    finally:
        torch.set_default_dtype(prev)
    check(all(p.dtype == torch.float64 for p in state.model.parameters()), "the float64 fit's params are not float64")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    out = dict(config=f"ResNet-18 {w}x{h} gray batch {BATCH}, float64, plain warp, steps_per_call 2", s=round(s, 3),
               steps=[state.step, plain.step], losses=losses, loss_rel_diff=rel,
               param_rel_l2=rel_l2(state.model.parameters(), plain.model.parameters()),
               stats_rel_l2=rel_l2(state.model.buffers(), plain.model.buffers()))
    check(len(rel) == 10 and state.step == plain.step == 10, f"float64 fits {out}")
    # measured on the H100: losses 1.7e-14 relative at most, params 1.9e-14
    # relative L2 (the CPU: 1.4e-14, 2.9e-14); the bound 1e-12 leaves 50× for
    # the card's run-to-run rounding (atomic adds in the upsample backward),
    # and a wrong reduction or BatchNorm moves a float64 trajectory by O(lr)
    # from the first step
    check(max(rel) <= 1e-12 and out["param_rel_l2"] <= 1e-12, f"float64 fit over the mesh vs without: {out}")
    return out


def grads_vs_float64(torch, state, frames, K, cfg, mesh, device="cuda") -> dict:
    """Which BatchNorm is the inexact one: from `state` and one batch, the
    grads of the plain fp32 step (cuDNN's BatchNorm), of the world-1
    data-parallel fp32 step (the hand-written global-batch BatchNorm,
    nn/core.py `_global_forward`) and of a float64 plain step, TF32 off, all
    three through the plain warp (the kernels take fp32 only); each fp32
    step's relative L2 distance from the float64 grads."""
    from dataclasses import replace

    from monodepth2_torch.models import Model
    from monodepth2_torch.parallel import make_parallel_train_step
    from monodepth2_torch.training import TrainContext, create_train_state, make_train_step

    cfg = replace(cfg, warp_method="gather")
    grads = {}
    for key, dtype in (("plain", torch.float32), ("dp", torch.float32), ("float64", torch.float64)):
        prev = torch.get_default_dtype()
        torch.set_default_dtype(dtype)
        try:
            ctx = TrainContext.create(K, cfg.width, cfg.height, dtype=dtype, device=device)
            twin = create_train_state(Model.create(depth=cfg.encoder_depth, in_channels=cfg.in_channels,
                                                   device=device), cfg)
            twin.model.load_state_dict(state.model.state_dict())  # cast to dtype
            step = make_parallel_train_step(ctx, cfg, mesh) if key == "dp" else make_train_step(ctx, cfg)
            step(twin, frames.to(dtype))
        finally:
            torch.set_default_dtype(prev)
        grads[key] = [p.grad for p in twin.model.parameters()]
    errs = {f"{k}_vs_float64_rel_l2": rel_l2(grads[k], grads["float64"]) for k in ("plain", "dp")}
    return dict(errs, dp_over_plain=errs["dp_vs_float64_rel_l2"] / errs["plain_vs_float64_rel_l2"])


def dp_phase(torch, np, GS, tmp, device="cuda") -> dict:
    """Data parallelism: (a) one rank in this process, on the mesh that
    make_mesh() sets up alone (a world-size-1 NCCL group): fit over it at
    the slice's width (ResNet-18, 416×128 gray, batch 4, steps_per_call 2,
    fp32, TF32 off, 10 steps) against fit without a mesh from the same seed
    on the same data order (the mesh's sampler owns the shuffle, so the
    plain fit reads the dataset through the permutation that maps its
    loader's order onto the sampler's); the collectives captured into the
    graph, counted by the all-reduce wrapper; K1 and K2 once a step and K3
    never, by name in a profile; replayed micro-steps against eager twins;
    then the world-1 data-parallel scanned step against the plain one in
    bf16 (configs/kitti_ssl.json), windows in turns. (b) tools.dp_worker as 2 processes on this one card over gloo
    with CUDA tensors (NCCL refuses two ranks on one device), fit at 64×32
    in float64 through the plain warp (the kernels take fp32, whose rounding
    Adam would raise to lr-sized steps and hide a wrong reduction), beside a
    1-process run over gloo: both ranks' final states the same, bitwise, and
    params and BN statistics within 1e-9 of each leaf's largest entry of the
    1-process run's (float64 on the CPU: ~1e-11)."""
    import dataclasses
    import os
    import subprocess

    import torch.distributed as dist

    from monodepth2_torch.bench import load_config, setup
    from monodepth2_torch.data import SyntheticDriving
    from monodepth2_torch.device import synchronize
    from monodepth2_torch.models import Model
    from monodepth2_torch.nn.core import BatchNorm
    from monodepth2_torch.parallel import (
        COUNTS,
        make_mesh,
        make_parallel_scanned_train_step,
        make_parallel_train_step,
        reset_counts,
    )
    from monodepth2_torch.tools.profile_breakdown import kernel_counts
    from monodepth2_torch.training import (
        TrainConfig,
        TrainContext,
        create_train_state,
        make_scanned_train_step,
        make_train_step,
    )
    from monodepth2_torch.training.state import WARMUP_STEPS
    from monodepth2_torch.training import loop
    from monodepth2_torch.utils.profiler import trace, wall_ms

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    out = {}
    mesh = make_mesh(device=device)
    check((mesh.size, mesh.rank, mesh.backend, mesh.capturable) == (1, 0, "nccl" if on_card else "gloo", on_card),
          f"mesh {mesh}")
    n_bn = sum(isinstance(m, BatchNorm) for m in Model.create(depth=18, in_channels=1, device=device).modules())
    try:
        # (a) fit over the world-1 mesh against fit without one
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark)
        cudnn.allow_tf32 = matmul.allow_tf32 = False
        cudnn.deterministic, cudnn.benchmark = True, False
        cfg = TrainConfig(target_size=(WIDTH, HEIGHT), batch_size=BATCH, in_channels=1, steps_per_call=2,
                          log_every=0, save_every=0, log_dir=f"{tmp}/dp/logs", save_dir=f"{tmp}/dp/ckpts")
        driving = SyntheticDriving(n=48, target_size=(WIDTH, HEIGHT))
        losses, plains = {}, {}
        reset(GS)
        reset_counts()
        synchronize(dev)
        t = time.perf_counter()
        with trace(host=False) as prof:
            state, losses["mesh"] = recorded_fit(loop, cfg, driving, mesh=mesh, max_steps=10, verbose=False,
                                                 device=device)
            synchronize(dev)
        mesh_s = time.perf_counter() - t
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        mesh_counts, wrapper = dict(COUNTS), counts(GS)
        order_s, perm = sampler_order(np, len(driving), cfg.seed)
        # the plain fit, and as a yardstick of what fp32 rounding alone does
        # to a trajectory, the plain fit through the plain warp
        for key, method in (("plain", None), ("plain_gather", "gather")):
            plain_cfg = dataclasses.replace(cfg, log_dir=f"{tmp}/{key}/logs", save_dir=f"{tmp}/{key}/ckpts",
                                            warp_method=method)
            plains[key], losses[key] = recorded_fit(loop, plain_cfg, _Reordered(driving, perm), max_steps=10,
                                                    verbose=False, device=device)
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["mesh"], losses["plain"])]
        yardstick = [abs(a - b) / abs(b) for a, b in zip(losses["plain_gather"], losses["plain"])]
        by_name = kernel_counts(names)
        want = {"grid_sample_fwd_kernel": 10, "grid_sample_bwd_uv_kernel": 10, "grid_sample_bwd_img_kernel": 0}
        out["fit"] = dict(
            steps=state.step, s=round(mesh_s, 3), losses=losses["mesh"], plain_losses=losses["plain"],
            loss_rel_diff=rel, gather_vs_kernel_loss_rel_diff=yardstick,
            param_rel_l2=rel_l2(state.model.parameters(), plains["plain"].model.parameters()),
            collectives=mesh_counts, collectives_per_step=4 * n_bn + 2, launches_by_name=by_name,
            nccl_device_activities=sum("nccl" in n.lower() for n in names), wrapper_launches=wrapper,
        )
        check(len(rel) == 10 and state.step == plains["plain"].step == 10 and all(np.isfinite(losses["mesh"])),
              f"dp fit steps {out['fit']}")
        # step 1: the same weights and batch, so the same loss up to the
        # hand-written BatchNorm's fp32 rounding (1.7e-7 on the H100); steps
        # 2-3 (eager) within 2e-3 (1.5e-4 measured). From step 4 on, fp32
        # trajectories part (Adam turns rounding in near-zero grads into
        # lr-sized steps): up to 0.12 by step 10 in the H100 runs, where
        # the plain fit through the plain warp parts from the kernel one by
        # up to 6.1e-2. The 0.25 there is a sanity bound only: the float64
        # fits below hold the data-parallel semantics over the trajectory,
        # and the twins below hold each replayed step
        check(rel[0] <= 1e-6 and max(rel[1:3]) <= 2e-3 and max(rel) <= 0.25, f"dp fit losses vs plain fit: {rel}")
        # one capture: 2 sums a BatchNorm forward, 2 in its backward, the
        # grads and the metrics; the warm-up steps issue as many each
        check(mesh_counts["captured"] == (4 * n_bn + 2) * on_card, f"collectives captured {mesh_counts}, n_bn {n_bn}")
        check(by_name == want, f"dp fit launches by kernel name {by_name}, want {want}")

        out["float64_fit"] = float64_fits(torch, np, mesh, tmp, device)

        # each replayed data-parallel micro-step against two eager twins from
        # its state: the eager data-parallel step (the capture) and the
        # plain step (the semantics at world size 1)
        ctx = TrainContext.create(driving.K, WIDTH, HEIGHT, device=device)
        state = create_train_state(Model.create(depth=18, in_channels=1, device=device), cfg)
        twins = {k: create_train_state(Model.create(depth=18, in_channels=1, device=device), cfg)
                 for k in ("dp", "plain")}
        scanned = make_parallel_scanned_train_step(ctx, cfg, mesh)
        eager = {"dp": make_parallel_train_step(ctx, cfg, mesh), "plain": make_train_step(ctx, cfg)}
        stack = torch.from_numpy(np.stack([np.stack([driving[int(j)] for j in order_s[4 * i: 4 * i + 4]])
                                           for i in range(8)])).to(dev)
        scanned(state, stack[:WARMUP_STEPS])
        rows = []
        for i in range(WARMUP_STEPS, 8):
            for twin in twins.values():
                load_twin(twin, state)
            # each fp32 BatchNorm's grads against float64 from this state
            vs64 = grads_vs_float64(torch, state, stack[i], driving.K, cfg, mesh, device)
            reset_counts()
            _, m, _ = scanned(state, stack[i: i + 1])  # the first of these captures
            captured = COUNTS["captured"]
            tm = {k: eager[k](twins[k], stack[i])[1] for k in twins}
            grads = {k: [p.grad for p in twins[k].model.parameters()] for k in twins}
            rows.append(dict(
                loss=m["loss"].item(), **{f"{k}_twin_loss": tm[k]["loss"].item() for k in twins},
                param_rel_l2=rel_l2(state.model.parameters(), twins["dp"].model.parameters()),
                **{f"{key}_rel_l2": rel_l2(adam_state(state, key), adam_state(twins["dp"], key))
                   for key in ("exp_avg", "exp_avg_sq")},
                dp_vs_plain_grad_rel_l2=rel_l2(grads["dp"], grads["plain"]),
                dp_vs_plain_param_rel_l2=rel_l2(twins["dp"].model.parameters(), twins["plain"].model.parameters()),
                collectives_captured=captured, **vs64,
            ))
        for r in rows:
            check(abs(r["loss"] - r["dp_twin_loss"]) <= 1e-4 * abs(r["dp_twin_loss"]) and r["param_rel_l2"] <= 1e-6
                  and r["exp_avg_rel_l2"] <= 1e-4 and r["exp_avg_sq_rel_l2"] <= 1e-4,
                  f"replayed data-parallel step vs its eager twin: {r}")
            # at world size 1 the two differ only by the hand-written
            # BatchNorm's fp32 rounding against cuDNN's. Against a float64
            # step from the same state, each fp32 step's grads are off by
            # 1.2e-3-7.8e-3 on the H100, neither BatchNorm the worse one in
            # every state (the fp32 gradient moves that much under rounding
            # of one BatchNorm's output: experiments/bn_vs_float64.py), and
            # the two steps 1.0e-3-7.6e-3 apart. So each is held within
            # 1.6e-2 of float64 and of each other, 2× the larger error
            # measured (7.75e-3); a wrong BatchNorm backward moves the
            # grads by O(1)
            check(abs(r["dp_twin_loss"] - r["plain_twin_loss"]) <= 1e-6 * abs(r["plain_twin_loss"])
                  and r["dp_vs_plain_grad_rel_l2"] <= 1.6e-2 and r["plain_vs_float64_rel_l2"] <= 1.6e-2
                  and r["dp_vs_float64_rel_l2"] <= 1.6e-2, f"world-1 data-parallel step vs the plain step: {r}")
        check(rows[0]["collectives_captured"] == (4 * n_bn + 2) * on_card, f"captured {rows[0]}")
        out["twins"] = rows
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved

        # the world-1 data-parallel step against the plain one, bf16
        cfg_b = load_config(target_size=(WIDTH, HEIGHT), batch_size=BATCH, in_channels=1)
        spc = cfg_b.steps_per_call
        ctx, plain_state, _, frames = setup(cfg_b, dev)
        states = {"plain": plain_state, "dp": create_train_state(
            Model.create(depth=18, in_channels=1, device=device), cfg_b)}
        steps = {"plain": make_scanned_train_step(ctx, cfg_b), "dp": make_parallel_scanned_train_step(ctx, cfg_b, mesh)}
        stack = frames.unsqueeze(0).expand(spc, *frames.shape)
        last = {}
        reset_counts()
        for m in ("plain", "dp"):
            for _ in range(2):
                _, last[m], _ = steps[m](states[m], stack)
        captured = COUNTS["captured"]
        windows = {"plain": [], "dp": []}
        for m in ("plain", "dp", "dp", "plain"):
            windows[m] += [ms / spc for ms in wall_ms(lambda: steps[m](states[m], stack), dev, 3, warmup=0, windows=1)]
        synchronize(dev)
        with trace(host=False) as prof:
            steps["dp"](states["dp"], stack)
            synchronize(dev)
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        check(all(np.isfinite(last[m]["loss"].tolist()).all() for m in last), f"bf16 losses {last}")
        out["step"] = dict(
            config="configs/kitti_ssl.json (bf16, steps_per_call 10), world-1 NCCL mesh",
            plain_ms=min(windows["plain"]), dp_ms=min(windows["dp"]), windows=windows,
            collectives_captured=captured, nccl_device_activities_per_step=sum("nccl" in n.lower() for n in names) / spc,
            device_activities_per_step=len(names) / spc,
        )
        check(captured == (4 * n_bn + 2) * on_card, f"bf16 collectives captured {captured}")
    finally:
        dist.destroy_process_group()

    # (b) 2 ranks on this card over gloo with CUDA tensors, beside 1
    port = free_port()
    base = [sys.executable, "-m", "monodepth2_torch.tools.dp_worker", "fit", "--device", device, "--backend", "gloo",
            "--dtype", "float64", "--warp-method", "gather"]
    runs = {"sp": [base + ["--out", f"{tmp}/sp", "--save-reference", f"{tmp}/sp/ref-p{{rank}}.npz"]]}
    runs["mp"] = [base + ["--out", f"{tmp}/mp", "--save-reference", f"{tmp}/mp/ref-p{{rank}}.npz",
                          "--world-size", "2", "--rank", str(r), "--port", str(port)] for r in range(2)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t = time.perf_counter()
    procs = {k: [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds] for k, cmds in runs.items()}
    logs = {}
    try:
        for k, ps in procs.items():
            logs[k] = [q.communicate(timeout=600)[0] for q in ps]
    finally:
        for ps in procs.values():
            for q in ps:
                q.kill()
    for k, ps in procs.items():
        for q, log in zip(ps, logs[k]):
            check(q.returncode == 0, f"dp_worker {k} failed: {log[-3000:]}")
    reports = {k: [json.loads(log.strip().splitlines()[-1]) for log in logs[k]] for k in logs}
    refs = {k: [np.load(f"{tmp}/{k}/ref-p{r}.npz") for r in range(len(logs[k]))] for k in logs}
    mp, sp = refs["mp"][0], refs["sp"][0]
    same = all(np.array_equal(mp[k], refs["mp"][1][k]) for k in mp.files)
    errs = {k: float(np.abs(mp[k] - sp[k]).max() / max(np.abs(sp[k]).max(), 1e-300))
            for k in sp.files if sp[k].dtype.kind == "f"}
    worst = max(errs, key=errs.get)
    out["two_ranks"] = dict(
        s=round(time.perf_counter() - t, 3), backend=[r["backend"] for r in reports["mp"]],
        devices=[r["device"] for r in reports["mp"]], steps=[r["step"] for r in reports["mp"] + reports["sp"]],
        state_sha256_equal=reports["mp"][0]["state_sha256"] == reports["mp"][1]["state_sha256"],
        params_stats_equal=same, vs_one_process_worst=[worst, errs[worst]],
    )
    check(out["two_ranks"]["state_sha256_equal"] and same, f"the two ranks' states differ: {out['two_ranks']}")
    check(errs[worst] <= 1e-9 and out["two_ranks"]["steps"] == [4, 4, 4], f"2 ranks vs 1: {out['two_ranks']}")
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_all(commands: dict, cwd, env, timeout: float = 600) -> dict:
    """Run the commands {name: argv} as concurrent processes; returns {name:
    (returncode, stdout, stderr, seconds)}. Each is killed at `timeout`."""
    import subprocess
    import threading

    t, out = time.perf_counter(), {}

    def run(name, proc):
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
            stderr += f"\n(killed after {timeout} s)"
        out[name] = (proc.returncode, stdout, stderr, round(time.perf_counter() - t, 3))

    procs = {name: subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, argv in commands.items()}
    threads = [threading.Thread(target=run, args=item, daemon=True) for item in procs.items()]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout + 60)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(len(out) == len(commands), f"processes not reaped: {set(commands) - set(out)}")
    return out


def cli_phase(torch, np, tmp, width=WIDTH, height=HEIGHT, device="cuda") -> dict:
    """The command line (python -m monodepth2_torch.cli) as a user runs it,
    each subcommand a process in `tmp`, concurrent where one does not need
    another's output; any failure fails the phase. train on SyntheticDriving
    (16 scenes, ResNet-18, batch 4, bf16, --config with log_every 4) to step
    12: "done at step 12", ckpt-12, metrics.jsonl with finite losses, params
    unlike the seed's; the same command resumed to 16; train through torchrun
    (one process, --distributed, NCCL on the card) to step 4; --mesh 2 in one
    process refused with the torchrun line; eval-depth --synthetic --limit 4
    (finite abs_rel); export --fp32 --platforms <device> (meta: the sidecar's
    width, height, channels) and export --platforms tpu,cpu refused; serve
    on a free port with --no-warmup, one POST held within 1e-6 of
    serving.load_inference on the same input, TF32 off in both processes
    (NVIDIA_TF32_OVERRIDE=0 for the server), then terminated; eval-image on
    4 PNGs (4 disparity PNGs); simple-depth --iters 20 (the loss falls);
    profile --steps 2 (trace.json naming K1 and K2, launched once a step,
    and the projection's kernels once a source)."""
    import io
    import os
    import subprocess
    import urllib.request

    from PIL import Image

    from monodepth2_torch.eval import load_model, sidecar_config
    from monodepth2_torch.models import Model
    from monodepth2_torch.serving import load_inference, read_meta
    from monodepth2_torch.tools.profile_breakdown import kernel_counts

    t0 = time.perf_counter()
    tmp = pathlib.Path(tmp)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cli = [sys.executable, "-m", "monodepth2_torch.cli"]
    (tmp / "cli.json").write_text(json.dumps({"log_every": 4, "save_every": 0}))
    size = ["--width", str(width), "--height", str(height), "--device", device]
    train = [*cli, "train", "--data", "driving", "--synthetic-n", "16", *size, "--batch-size", str(BATCH), "--bf16",
             "--config", "cli.json", "--save-dir", "ck", "--log-dir", "lg"]
    ckpt = "ck/ckpt-12"
    out, seconds = {}, {}

    def ran(commands, refused=()):
        results = run_all(commands, tmp, env)
        for name, (rc, stdout, stderr, s) in results.items():
            seconds[name] = s
            ok = name not in refused
            check((rc == 0) == ok, f"cli {name} exited {rc} (want {'0' if ok else 'nonzero'}): {stderr[-3000:]}")
        return results

    # first: train to 12, torchrun, and the subcommands that need no checkpoint
    port = free_port()
    first = ran({
        "train": [*train, "--max-steps", "12", "--no-resume"],
        "torchrun_train": [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1", "--nnodes", "1",
                           "--master-addr", "127.0.0.1", "--master-port", str(port), "-m", "monodepth2_torch.cli",
                           "train", "--distributed", "--data", "driving", "--synthetic-n", "16", *size, "--batch-size",
                           str(BATCH), "--max-steps", "4", "--no-resume", "--save-dir", "ck_dist", "--log-dir",
                           "lg_dist"],
        "simple_depth": [*cli, "simple-depth", "--iters", "20", "--out", "sd", "--device", device],
        "profile": [*cli, "profile", "--steps", "2", "--out", "prof", *size],
        "mesh2": [*train, "--max-steps", "4", "--mesh", "2", "--save-dir", "ck_mesh"],
    }, refused={"mesh2"})
    check("done at step 12" in first["train"][1], f"train: {first['train'][1][-2000:]}")
    check((tmp / f"{ckpt}.npz").exists() and (tmp / f"{ckpt}.json").exists(), "train wrote no ckpt-12")
    logged = [json.loads(line) for line in (tmp / "lg" / "metrics.jsonl").read_text().splitlines()]
    check([r["step"] for r in logged] == [4, 8, 12] and all(np.isfinite(r["loss"]) for r in logged),
          f"metrics.jsonl {logged}")
    trained = load_model(sidecar_config(str(tmp / ckpt)), str(tmp / ckpt), device=device)
    seed = Model.create(depth=18, in_channels=1, device=device)
    moved = rel_l2(trained.parameters(), seed.parameters())
    check(moved > 1e-6, f"ckpt-12's params are the seed's: relative L2 {moved}")
    check("done at step 4" in first["torchrun_train"][1] and (tmp / "ck_dist" / "ckpt-4.npz").exists(),
          f"torchrun train: {first['torchrun_train'][1][-2000:]} {first['torchrun_train'][2][-2000:]}")
    check("torchrun --nproc-per-node 2 -m monodepth2_torch.cli train" in first["mesh2"][2]
          and not (tmp / "ck_mesh").exists(), f"--mesh 2 in one process: {first['mesh2'][2][-2000:]}")
    iters = [(int(l.split()[1][:-1]), float(l.split()[3])) for l in first["simple_depth"][1].splitlines()
             if l.startswith("iter ")]
    check([i for i, _ in iters] == [1, 5, 10, 15, 20] and iters[-1][1] < iters[0][1], f"simple-depth losses {iters}")
    check(len(list((tmp / "sd").glob("d-*.png"))) == 5, "simple-depth PNGs")
    trace = json.loads((tmp / "prof" / "trace.json").read_text())
    names = [e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    profiled = {**kernel_counts(names), **project_by_name(names)}
    if device == "cuda":
        want = {"grid_sample_fwd_kernel": 2, "grid_sample_bwd_uv_kernel": 2, "grid_sample_bwd_img_kernel": 0,
                **dict.fromkeys(PROJECT_KERNELS, 2 * 2)}  # two sources a step
        check(profiled == want, f"profile's trace: launches by kernel name {profiled}, want {want}")
    out.update(train=dict(metrics=logged, params_moved_rel_l2=moved), simple_depth=iters, profile=profiled)

    # then: what reads ckpt-12 (the resume writes ckpt-16 beside it)
    frames, _ = held_out(np, 4)
    (tmp / "imgs").mkdir()
    for i, f in enumerate(frames):
        img = Image.fromarray((f[..., 0] * 255).round().astype(np.uint8), "L")
        img.resize((width, height)).save(tmp / "imgs" / f"{i:06d}.png")
    second = ran({
        "resume": [*train, "--max-steps", "16"],
        "eval_depth": [*cli, "eval-depth", "--checkpoint", ckpt, "--synthetic", "--limit", "4", "--device", device],
        "export": [*cli, "export", "--checkpoint", ckpt, "--fp32", "--platforms", device, "--out", "art.pt2",
                   "--device", device],
        "eval_image": [*cli, "eval-image", "--checkpoint", ckpt, "--images", "imgs", "--out", "disp",
                       "--device", device],
        "export_list": [*cli, "export", "--checkpoint", ckpt, "--platforms", "tpu,cpu", "--out", "no.pt2",
                        "--device", device],
    }, refused={"export_list"})
    check("at step 12" in second["resume"][1] and "done at step 16" in second["resume"][1],
          f"resume: {second['resume'][1][-2000:]}")
    metrics = json.loads(second["eval_depth"][1][second["eval_depth"][1].index("{"):])
    check(np.isfinite(metrics["abs_rel"]), f"eval-depth {metrics}")
    meta = read_meta(str(tmp / "art.pt2"))
    check(meta["input_shape"] == [None, height, width, 1] and meta["platforms"] == [device]
          and meta["compute_dtype"] == "float32", f"exported meta {meta}")
    check("runs only on the device type" in second["export_list"][2] and not (tmp / "no.pt2").exists(),
          f"export --platforms tpu,cpu: {second['export_list'][2][-2000:]}")
    pngs = sorted(p.name for p in (tmp / "disp").glob("*.png"))
    check(pngs == [f"d-{i}.png" for i in range(4)], f"eval-image wrote {pngs}")
    out.update(eval_depth=metrics, export_meta=meta)

    # serve: one request against the artifact in this process, TF32 off
    port = free_port()
    t = time.perf_counter()
    server = subprocess.Popen([*cli, "serve", "--artifact", "art.pt2", "--port", str(port), "--no-warmup",
                               "--device", device], cwd=tmp, env=dict(env, NVIDIA_TF32_OVERRIDE="0"),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        while True:
            if server.poll() is not None:
                raise RuntimeError(f"serve exited {server.returncode}: {server.stdout.read()[-3000:]}")
            check(time.perf_counter() - t < 300, "serve did not answer /healthz in 300 s")
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5):
                    break
            except OSError:
                time.sleep(0.5)
        x = np.random.default_rng(6).uniform(size=(1, height, width, 1)).astype(np.float32)
        req = urllib.request.Request(base + "/v1/depth", data=x.tobytes(), method="POST", headers={
            "Content-Type": "application/octet-stream", "X-Shape": f"1,{height},{width},1"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.load(io.BytesIO(r.read()))
            got = {k: got[k] for k in got.files}
    finally:
        server.terminate()
        try:
            server.wait(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
    seconds["serve"] = round(time.perf_counter() - t, 3)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = {k: v.cpu().numpy() for k, v in load_inference(str(tmp / "art.pt2"), device=device)(x).items()}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    served = {k: float(np.abs(got[k] - want[k]).max()) for k in ("disparity", "depth")}
    check(max(served.values()) <= 1e-6, f"serve's reply vs the artifact: {served}")
    refused = {"mesh2": first["mesh2"][2], "export_list": second["export_list"][2]}
    out.update(serve_vs_artifact_max_abs=served, refused={k: v.strip().splitlines()[-1] for k, v in refused.items()},
               seconds=seconds, wall_s=round(time.perf_counter() - t0, 3))
    return out


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
    from monodepth2_torch.tools import (
        http_serving_bench,
        model_block_bench,
        profile_breakdown,
        serving_bench,
        ssl_driving_experiment,
        warp_kernel_bench,
    )
    from monodepth2_torch.training import TrainConfig, TrainContext, create_train_state, make_train_step
    from monodepth2_torch.utils.profiler import time_ms

    GS = importlib.import_module("monodepth2_torch.ops.grid_sample")
    from monodepth2_torch.ops import geometry as PG
    from monodepth2_torch.tools import project_bench

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
    _lib.load(_lib.PROJECT_SOURCE)
    ptxas = {**_lib.ptxas_report(), **_lib.ptxas_report(source=_lib.PROJECT_SOURCE)}
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

    # ---- project: the projection's kernels against their plain twins at
    # the main path's shape for one source (S·batch = 16 items of 128×416)
    n_proj = N_WARP // 2
    project_errs = []
    for per_item_K in (False, True):
        points, K, R, t, g = project_bench.make_inputs(n_proj, HEIGHT, WIDTH, dev, per_item_K)
        errs_p = compare_project(torch, PG, points, K, R, t, g, WIDTH, HEIGHT)
        project_errs.append(errs_p)
        emit("project", K="per item" if per_item_K else "shared", shape=[n_proj, P], **errs_p)

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
        load_twin(plain, state)
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
    slice_launches, slice_projection = counts(GS), project_counts()
    # training launches the forward and the coordinate VJP once a step, and
    # never the image VJP: source frames are data, not parameters
    want = {GS.grid_sample_fwd.name: 3, GS.grid_sample_bwd_uv.name: 3, GS.grid_sample_bwd_img.name: 0}
    check(slice_launches == want, f"launches in 3 main-path steps {slice_launches}, want {want}")
    # the projection once a source a step (the plain twin's steps project
    # through project_plain)
    want = dict.fromkeys(slice_projection, 3 * len(cfg.source_ids))
    check(slice_projection == want, f"projection launches in 3 main-path steps {slice_projection}, want {want}")
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
         mean_disparity=mean_disps, launches=slice_launches, projection_launches=slice_projection)

    # ---- graph: the scanned step, replayed, against eager twins
    graph = graph_phase(torch, np, GS, ctx)
    emit("graph", config="ResNet-18 416x128 gray batch 4 fp32, TF32 off, disp_reg 0.01/12 steps, "
         "lr warmup 5 and decay x0.1 at 9", **graph)

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

    # graph_bf16: the scanned step with the network in bf16
    emit("graph_bf16", **graph_bf16_phase(torch, np, ctx))

    # fit: the trainer's entry point, with its checkpoints and resume; then
    # the serving path on the first fit's checkpoint, which runs no warp
    with tempfile.TemporaryDirectory() as work:
        fitted, ckpt = fit_phase(torch, np, GS, work)
        emit("fit", **fitted)
        reset(GS)
        record, model, eval_cfg = eval_phase(torch, np, GS, ckpt, work)
        emit("eval", **record)
        record, artifact = export_phase(torch, np, GS, model, eval_cfg, work)
        emit("export", **record)
        # TF32 off, as in the export phase: responses are held to 1e-6
        torch.backends.cudnn.allow_tf32 = False
        emit("serve", **serve_phase(torch, np, GS, artifact))
        torch.backends.cudnn.allow_tf32 = True
    serving_launches, serving_projection = counts(GS), project_counts()

    # serve_bench: the serving tools in process, shortened
    t = time.perf_counter()
    served = serving_bench.main(["--iters", "10"])
    check(len(served["rows"]) == 4 * 2 * 4 and all(np.isfinite(r["ms_per_batch"]) for r in served["rows"]),
          f"serving bench rows {served['rows']}")
    http = http_serving_bench.main(["--concurrency", "1,8,32", "--requests", "96"])
    check(all(np.isfinite(lv["img_per_s"]) for lv in http["levels"]), f"http bench {http['levels']}")
    check(http["levels"][-1]["device_batches"] < http["levels"][-1]["requests"], f"no coalescing at 32: {http}")
    blocks = model_block_bench.main(["--iters", "10"])
    check(all(np.isfinite(v) for v in blocks["blocks"]["ms"].values()), f"block times {blocks}")
    emit("serve_bench", wall_s=round(time.perf_counter() - t, 3),
         serving={f"{r['variant']}/{r['io']}/{r['batch']}": [r["ms_per_batch"], r["img_per_s"]]
                  for r in served["rows"]},
         http=[{k: lv[k] for k in ("concurrency", "img_per_s", "p50_ms", "p95_ms", "rows_per_device_call")}
               for lv in http["levels"]],
         blocks_ms=blocks["blocks"]["ms"], inference_b64_bf16=blocks["inference"], power_limit=smi)

    # ssl: the convergence experiment (recipe C), shortened
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        ssl = ssl_driving_experiment.main([
            "--steps", "100", "--n-scenes", "20", "--n-val", "4", "--eval-every", "50", "--min-depth", "1",
            "--max-depth", "80", "--disp-reg", "0.01", "--disp-reg-steps", "2500", "--out", work,
        ])
        check(pathlib.Path(ssl["history_path"]).exists(), "history.json not written")
    hist = ssl["history"]
    check([r["step"] for r in hist] == [50, 100], f"ssl history steps {[r['step'] for r in hist]}")
    check(all(np.isfinite(r["loss"]) and 0 < r["mean_disparity"] < 1 for r in hist), f"ssl history {hist}")
    check(all(np.isfinite(r[k]) for r in hist for k in ("val_abs_rel", "val_a1", "val_rmse")), f"ssl val {hist}")
    emit("ssl", wall_s=round(time.perf_counter() - t, 3), history=hist, baseline=ssl["baseline"])

    # warp_bench: the path that runs the image VJP
    reset(GS)
    warp = warp_kernel_bench.main(["--iters", "10"])
    torch.cuda.synchronize()
    warp_launches = counts(GS)
    check(all(n > 0 for n in warp_launches.values()), f"warp bench launches {warp_launches}: a kernel never ran")
    check(all(np.isfinite(r["fwd_bwd_ms"]) for r in warp["rows"]), "non-finite warp bench times")
    emit("warp_bench", launches=warp_launches, **{r["method"]: {k: v for k, v in r.items() if k != "method"}
                                                    for r in warp["rows"]})

    # bench: the bf16 training step as users train (configs/kitti_ssl.json),
    # eager and graph windows in turns
    reset(GS)
    result = bench.main(["--warmup", "5", "--steps", "20"])
    bench_launches = counts(GS)
    check(bench_launches[GS.grid_sample_bwd_img.name] == 0 and
          bench_launches[GS.grid_sample_fwd.name] > 0 and bench_launches[GS.grid_sample_bwd_uv.name] > 0,
          f"bench launches {bench_launches}: want K1 and K2, and no K3")
    check(all(np.isfinite(result[m]["ms_per_step"]) and np.isfinite(result[m]["loss"]) for m in bench.MODES),
          f"bench result {result}")
    emit("bench", launches=bench_launches, img_per_s=result["value"], mode=result["mode"],
         steps_per_call=result["steps_per_call"], window_order=result["window_order"],
         **{m: result[m] for m in bench.MODES}, step_gflops=result["step_gflops"],
         host=[result["host_cpu"], result["host_cores"], result["host_load"]], power_limit=smi)

    # breakdown: per-block times and the device's idle share in a step,
    # eager and replayed
    breakdown = profile_breakdown.main(["--iters", "10", "--idle-steps", "10"])
    check(0 <= breakdown["full_step_idle_share"] < 1, f"idle share {breakdown['full_step_idle_share']}")
    per_step = breakdown["graph_window"]["kernels_per_step"]
    want = {"grid_sample_fwd_kernel": 1, "grid_sample_bwd_uv_kernel": 1, "grid_sample_bwd_img_kernel": 0}
    check(per_step == want, f"graph_step warp kernels a step by name {per_step}, want {want}")
    window_keys = ("idle_share", "busy_ms_per_step", "window_ms_per_step", "device_activities_per_step",
                   "kernels_per_step")
    emit("breakdown", blocks={k: v["ms"] for k, v in breakdown["blocks"].items()},
         derived=breakdown["derived"], full_step_idle_share=breakdown["full_step_idle_share"],
         graph_step_idle_share=breakdown["graph_step_idle_share"],
         **{k: breakdown["idle_window"][k] for k in window_keys},
         graph_window={k: breakdown["graph_window"][k] for k in window_keys},
         top_device_ms_per_step=breakdown["idle_window"]["top_device_ms_per_step"][:6],
         graph_top_device_ms_per_step=breakdown["graph_window"]["top_device_ms_per_step"][:6])

    # native: the host decoder, built here or reported, and the loader's
    # triplets/s beside the replayed step's img/s
    t = time.perf_counter()
    native = native_phase(torch, np)
    emit("native", wall_s=round(time.perf_counter() - t, 3), **native, power_limit=smi)

    # dp: the data-parallel paths, one rank in process and two on this card
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        dp = dp_phase(torch, np, GS, work)
    emit("dp", wall_s=round(time.perf_counter() - t, 3), **dp, power_limit=smi)

    # cli: the command line as a user runs it, each subcommand a process
    with tempfile.TemporaryDirectory() as work:
        cli = cli_phase(torch, np, work)
    emit("cli", **cli, power_limit=smi)

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

    def project_rows(per_item_K):
        """{wrapper name: the kernel's times, the plain twin's and the
        library's (autograd of project_plain: its forward with grad
        recording, its backward alone on a kept graph), and the bound from
        this run's bytes} for one source at the main path's shape."""
        points, K, R, t, g = project_bench.make_inputs(n_proj, HEIGHT, WIDTH, dev, per_item_K, seed=1)
        xs = [x.detach().clone().requires_grad_() for x in (points, R, t)]
        uv = PG.project_plain(xs[0], K, xs[1], xs[2], WIDTH, HEIGHT)
        nbytes = project_bench.project_bytes(n_proj, P)
        rows = {}
        for k, key, kernel, plain_fn, library in (
            (
                PG.project_fwd, "fwd",
                lambda: PG.project_fwd(points, K, R, t, WIDTH, HEIGHT),
                lambda: PG.project_plain(points, K, R, t, WIDTH, HEIGHT),
                lambda: PG.project_plain(xs[0], K, xs[1], xs[2], WIDTH, HEIGHT),
            ),
            (
                PG.project_bwd, "bwd",
                lambda: PG.project_bwd(points, K, R, t, g, WIDTH, HEIGHT),
                lambda: PG.project_bwd_plain(points, K, R, t, g, WIDTH, HEIGHT),
                lambda: torch.autograd.grad(uv, xs, g, retain_graph=True),
            ),
        ):
            rows[k.name] = dict(
                **timings(kernel), plain_ms=time_ms(plain_fn, dev, 20, flush_l2=True), **timings(library, "library_"),
                bound_ms=nbytes[key] / H100_BYTES_PER_S * 1e3, bound_by="bytes", bytes=nbytes[key],
                shape=[n_proj, P], K="per item" if per_item_K else "shared",
            )
        return rows

    rows, rows_c3 = time_rows(1), time_rows(3)
    rows_project, rows_project_k = project_rows(False), project_rows(True)
    max_errs = [max(e[i] for e in errs.values()) for i in range(3)]
    max_errs[2] = max(max_errs[2], *img_errs)
    kernels = []
    fit_launches = {k[: -len("_kernel")]: n for k, n in fitted["first_fit"]["launches_by_name"].items()}
    for k, err, lines, launches in (
        (GS.grid_sample_fwd, max_errs[0], (116, 175), fit_launches),  # _fwd_kernel, _fwd_kernel_colband
        (GS.grid_sample_bwd_uv, max_errs[1], (124, 186), fit_launches),  # _bwd_duv_kernel, _colband
        # K3's path is the warp bench's forward + VJP; training runs it 0 times
        (GS.grid_sample_bwd_img, max_errs[2], (154, 214), warp_launches),  # _bwd_dimg_kernel, _colband
    ):
        kernels.append(dict(
            name=k.name, route="cuda", source="monodepth2_torch/ops/cuda/grid_sample.cu",
            replaces=f"{TPU_KERNELS}:{lines[0]}", also_replaces=f"{TPU_KERNELS}:{lines[1]}",
            # K1/K2: the first fit's launches, counted by kernel name in a
            # profile (the wrappers' counters see its eager steps and the
            # capture, not the replays); K3: the warp bench's
            launches=launches[k.name], fit_wrapper_calls=fitted["first_fit"]["wrapper_calls"][k.name],
            launches_fit_by_name=fit_launches[k.name], launches_per_train_step=slice_launches[k.name] // 3,
            launches_in_10_replays=graph["replayed_kernels_by_name"][f"{k.name}_kernel"],
            launches_serving=serving_launches[k.name],
            # the cli phase's `profile --steps 2`, counted by name in its trace
            launches_cli_profile=cli["profile"][f"{k.name}_kernel"],
            max_abs_err=err, **rows[k.name], C3=rows_c3[k.name],
        ))
    fit_projection = fitted["first_fit"]["projection_launches_by_name"]
    replayed_projection = graph["replayed_projection_by_name"]
    for k, err, names in (
        (PG.project_fwd, {"max_abs_err": max(e["uv_max_abs_err"] for e in project_errs)}, PROJECT_KERNELS[:1]),
        (PG.project_bwd, {"max_abs_err": max(e["d_points_max_abs_err"] for e in project_errs),
                          "dR_rel_fro": max(e["dR_rel_fro"] for e in project_errs),
                          "dt_rel_fro": max(e["dt_rel_fro"] for e in project_errs)}, PROJECT_KERNELS[1:]),
    ):
        kernels.append(dict(
            name=k.name, route="cuda", source="monodepth2_torch/ops/cuda/project.cu",
            replaces="none: project (monodepth2_tpu/ops/geometry.py), left to XLA", kernel_names=list(names),
            # by kernel name in the first fit's profile, the wrappers' calls
            # beside (its eager steps and the capture)
            launches={n: fit_projection[n] for n in names}, fit_wrapper_calls=fitted["first_fit"][
                "projection_wrapper_calls"][k.name],
            launches_per_train_step=slice_projection[k.name] // 3,
            launches_in_10_replays={n: replayed_projection[n] for n in names},
            launches_serving=serving_projection[k.name],
            launches_cli_profile={n: cli["profile"][n] for n in names},
            **err, **rows_project[k.name], per_item_K=rows_project_k[k.name],
        ))
    emit("times", total_s=round(time.perf_counter() - T0, 3), power_limit=smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
