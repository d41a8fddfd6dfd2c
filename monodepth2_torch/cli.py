"""Command-line entry points, port of monodepth2_tpu/cli.py: the same nine
subcommands, flags, defaults and config JSON.

    python -m monodepth2_torch.cli train --data synthetic --max-steps 20
    python -m monodepth2_torch.cli train --data kitti --root /path/kitti
    torchrun --nproc-per-node 8 -m monodepth2_torch.cli train --distributed --mesh 8 ...
    python -m monodepth2_torch.cli export --checkpoint models/ckpt-100 --out depth.pt2
    python -m monodepth2_torch.cli serve --artifact depth.pt2
    python -m monodepth2_torch.cli eval-image --checkpoint models/ckpt-100 --images dir/
    python -m monodepth2_torch.cli eval-video --checkpoint models/ckpt-100 --video v.mp4
    python -m monodepth2_torch.cli eval-depth --checkpoint models/ckpt-100 --synthetic
    python -m monodepth2_torch.cli simple-depth --dtk-dir imgs/ --files list.txt
    python -m monodepth2_torch.cli profile --steps 5 --out profile_trace
    python -m monodepth2_torch.cli refine-dtk --root imgs/ --files list.txt

Every subcommand runs on the card; `--device cpu` runs it on the CPU, and
without a card `--device cuda` (the default) exits nonzero, never falling
back. Where the JAX package differs by design (docs/MIGRATING_TORCH.md):

- `train --mesh N` is N processes, one card each (`torchrun
  --nproc-per-node N ... train --distributed --mesh N`), not one process over
  N devices; `--mesh N` in a process group of another size exits nonzero.
  `--distributed`, `--coordinator`, `--num-processes`, `--process-id` or
  torchrun's environment (MASTER_ADDR, WORLD_SIZE, RANK) set up the group.
- `export --platforms` names one device type, the one the artifact is traced
  on (default: `--device`'s); a list exits nonzero, since a torch.export
  artifact runs only where it was traced.
- `profile` writes torch.profiler's Chrome trace, `<out>/trace.json`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def _add_config_args(p: argparse.ArgumentParser):
    p.add_argument("--config", help="JSON config file (TrainConfig fields)")
    p.add_argument("--batch-size", type=int)
    p.add_argument("--lr", type=float)
    p.add_argument("--epochs", type=int)
    p.add_argument("--width", type=int)
    p.add_argument("--encoder-depth", type=int, choices=[18, 34, 50],
                   help="ResNet encoder variant")
    p.add_argument("--in-channels", type=int,
                   help="input channels (1=grayscale, 3=RGB)")
    p.add_argument("--height", type=int)
    p.add_argument("--automasking", action="store_true", default=None)
    p.add_argument("--min-depth", type=float)
    p.add_argument("--max-depth", type=float)
    p.add_argument("--grad-clip", type=float)
    p.add_argument("--lr-warmup-steps", type=int)
    p.add_argument("--lr-decay-steps", type=int,
                   help="one-time x lr-decay-factor step decay at this step")
    p.add_argument("--lr-decay-factor", type=float)
    p.add_argument("--disp-reg", type=float,
                   help="anti-collapse logit regularizer weight (see config)")
    p.add_argument("--disp-reg-steps", type=int)
    p.add_argument("--pose-tz-init", type=float,
                   help="forward-motion prior: initial tz of the pose head")
    p.add_argument("--per-item-k", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="train each item with its own camera intrinsics "
                        "(per-sequence KITTI calibration; the reference uses "
                        "the first sequence's K for the whole chain). "
                        "Auto-enabled when the chain's calibrations differ; "
                        "--no-per-item-k forces the reference behavior")
    p.add_argument("--steps-per-call", type=int,
                   help="train steps per call of the step (on the card one "
                        "captured CUDA graph, replayed that many times)")
    p.add_argument("--bf16", action="store_true", default=None,
                   help="bfloat16 network compute (fp32 master params)")
    p.add_argument("--fp32", action="store_true", default=None,
                   help="force float32 compute (overrides a bf16-trained "
                        "checkpoint's recorded compute_dtype at export/eval)")
    p.add_argument("--debug-nans", action="store_true", default=None)
    p.add_argument("--log-dir")
    p.add_argument("--save-dir")
    p.add_argument("--seed", type=int)


def _add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="cuda (default; exits nonzero without a card) or cpu")


def _cli_overrides(args) -> dict:
    """TrainConfig fields the user EXPLICITLY set on the command line
    (argparse defaults are None, so absence is distinguishable)."""
    overrides = {}
    for field, attr in [
        ("batch_size", "batch_size"),
        ("lr", "lr"),
        ("epochs", "epochs"),
        ("automasking", "automasking"),
        ("log_dir", "log_dir"),
        ("save_dir", "save_dir"),
        ("seed", "seed"),
        ("debug_nans", "debug_nans"),
        ("min_depth", "min_depth"),
        ("max_depth", "max_depth"),
        ("grad_clip", "grad_clip"),
        ("lr_warmup_steps", "lr_warmup_steps"),
        ("encoder_depth", "encoder_depth"),
        ("in_channels", "in_channels"),
        ("lr_decay_steps", "lr_decay_steps"),
        ("lr_decay_factor", "lr_decay_factor"),
        ("disp_reg", "disp_reg"),
        ("disp_reg_steps", "disp_reg_steps"),
        ("pose_tz_init", "pose_tz_init"),
        ("steps_per_call", "steps_per_call"),
        ("per_item_K", "per_item_k"),
    ]:
        v = getattr(args, attr, None)
        if v is not None:
            overrides[field] = v
    if getattr(args, "bf16", None):
        overrides["compute_dtype"] = "bfloat16"
    if getattr(args, "fp32", None):
        overrides["compute_dtype"] = "float32"
    if getattr(args, "width", None) and getattr(args, "height", None):
        overrides["target_size"] = (args.width, args.height)
    return overrides


def _explicit_config(args) -> dict:
    """Every field the user EXPLICITLY set: --config file entries first,
    individual CLI flags on top."""
    base = {}
    if getattr(args, "config", None):
        with open(args.config) as f:
            base = json.loads(f.read())
        for k in ("frame_ids", "source_ids", "target_size", "scale_levels"):
            if k in base:
                base[k] = tuple(base[k])
    base.update(_cli_overrides(args))
    return base


def _build_config(args) -> "TrainConfig":
    from .training import TrainConfig

    explicit = _explicit_config(args)
    return dataclasses.replace(TrainConfig(), **explicit) if explicit else TrainConfig()


def _resolve_checkpoint_config(args) -> "TrainConfig":
    """Config for commands that consume a checkpoint: the checkpoint
    sidecar's recorded training config is the base truth (architecture,
    resolution, compute_dtype), and ONLY user-explicit settings — --config
    file entries and CLI flags — override it, so that CLI defaults cannot
    export or evaluate another architecture than the one trained, and a
    --config file is not dropped when a sidecar exists."""
    from .eval import sidecar_config

    cfg = _build_config(args)
    side = sidecar_config(args.checkpoint)
    if side is not None:
        explicit = _explicit_config(args)
        cfg = dataclasses.replace(side, **explicit) if explicit else side
    return cfg


def _auto_per_item_k(cfg, dataset, explicit: dict):
    """Default per_item_K ON when the chain's children carry genuinely
    different calibrations: the reference would miscalibrate all but the
    first sequence (src/Monodepth.jl:99); per-item intrinsics recover the
    lost accuracy at ~zero step cost. User-explicit settings
    (--per-item-k/--no-per-item-k or a config-file entry) always win."""
    if cfg.per_item_K or "per_item_K" in explicit:
        return cfg
    # supports_item_K must gate too: a chain can be heterogeneous (per the
    # recursion) while containing a K-less child — auto-enabling there
    # would crash DataLoader(with_K=True) where first-child-K trains fine
    if getattr(dataset, "heterogeneous_K", False) and getattr(
        dataset, "supports_item_K", False
    ):
        cfg = dataclasses.replace(cfg, per_item_K=True)
        print(
            "chain has heterogeneous calibrations: enabling per-item "
            "intrinsics (--no-per-item-k restores first-child-K)",
            flush=True,
        )
    return cfg


def _build_dataset(args, cfg):
    from .data import (
        DChain,
        Depth10k,
        FlipX,
        KittiDataset,
        SyntheticDriving,
        SyntheticTriplets,
    )

    aug = FlipX(0.5) if not args.no_augment else None
    if args.data == "synthetic":
        return SyntheticTriplets(
            n=args.synthetic_n, target_size=cfg.target_size, channels=cfg.in_channels
        )
    if args.data == "driving":
        return SyntheticDriving(
            n=args.synthetic_n, target_size=cfg.target_size,
            channels=cfg.in_channels, seed=cfg.seed,
        )
    if args.data == "kitti":
        seqs = args.sequences.split(",") if args.sequences else [
            f"{i:02d}" for i in range(22)
        ]
        sets = []
        for s in seqs:
            try:
                sets.append(
                    KittiDataset(
                        args.root, s, target_size=cfg.target_size,
                        augmentations=aug,
                        grayscale=cfg.in_channels == 1,
                        cache_decoded=getattr(args, "cache_decoded", False),
                    )
                )
            except FileNotFoundError:
                pass
        if not sets:
            sys.exit(f"no KITTI sequences found under {args.root}")
        return DChain(sets)
    if args.data == "dtk":
        with open(args.files) as f:
            files = [l.strip() for l in f if l.strip()]
        return Depth10k(
            args.root, files, augmentations=aug,
            grayscale=cfg.in_channels == 1,
            cache_decoded=getattr(args, "cache_decoded", False),
        )
    sys.exit(f"unknown --data {args.data}")


def _device(args):
    """The device the subcommand runs on; without a card, `--device cuda`
    exits nonzero with the reason instead of running on the CPU."""
    from .device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"--device {args.device}: {e}")


def _mesh_refusal(n: int, why: str) -> str:
    return (f"--mesh {n}: {why}. The port runs one process per card: launch "
            f"torchrun --nproc-per-node {n} -m monodepth2_torch.cli train --distributed --mesh {n} ...")


def cmd_train(args):
    # the process group is set up before any other distributed call, from
    # the flags or from torchrun's environment (MASTER_ADDR, WORLD_SIZE,
    # RANK); see parallel/distributed.py
    import torch.distributed as dist

    from .parallel import initialize_distributed, make_mesh
    from .training.loop import fit

    device = _device(args)
    env_configured = any(v in os.environ for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK"))
    flags = (args.distributed or args.coordinator or args.num_processes is not None
             or args.process_id is not None)
    multi = initialize_distributed(
        coordinator_address=args.coordinator or None,
        num_processes=args.num_processes,
        process_id=args.process_id,
        auto=args.distributed,
        device=device,
    ) if (flags or env_configured) else False
    if args.mesh > 1 and not multi:
        sys.exit(_mesh_refusal(args.mesh, "this is one process and no process group was configured"))
    try:
        cfg = _build_config(args)
        dataset = _build_dataset(args, cfg)
        cfg = _auto_per_item_k(cfg, dataset, _explicit_config(args))
        mesh = None
        if multi:
            try:
                mesh = make_mesh(args.mesh if args.mesh > 1 else None, device=device)
            except ValueError as e:
                sys.exit(_mesh_refusal(args.mesh, str(e)))
        state, _ = fit(cfg, dataset, mesh=mesh, resume=not args.no_resume,
                       max_steps=args.max_steps, progress=args.progress, device=device)
    finally:
        if multi:
            dist.destroy_process_group()
    print(f"done at step {int(state.step)}")


def cmd_export(args):
    from .eval import load_model
    from .serving import export_inference

    platforms = args.platforms.split(",") if args.platforms else None
    if platforms is not None and len(platforms) != 1:
        sys.exit(f"--platforms {args.platforms}: a torch.export artifact runs only on the device type it was "
                 "traced on (serving.load_inference); export one artifact per device type, each with "
                 "--device TYPE --platforms TYPE")
    device = _device(args)
    if platforms is not None and platforms[0] != device.type:
        sys.exit(f"--platforms {args.platforms}: this export traces on {device.type} (--device "
                 f"{args.device}), and the artifact runs only there; pass --device {platforms[0]}")
    cfg = _resolve_checkpoint_config(args)
    model = load_model(cfg, args.checkpoint, device=device)
    export_inference(model, cfg, args.out, batch_size=args.batch if args.batch and args.batch > 0 else None)
    print(f"exported {args.out} ({os.path.getsize(args.out)} bytes, "
          f"platforms={device.type}, "
          f"batch={'symbolic' if not args.batch else args.batch})")


def cmd_serve(args):
    from .server import serve

    device = _device(args)
    serve(
        args.artifact,
        host=args.host,
        port=args.port,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        linger_s=args.linger_ms / 1e3,
        warmup=not args.no_warmup,
        max_pending_rows=args.max_pending_rows or None,
        workers=args.workers,
        device=device,
    )


def cmd_eval_image(args):
    from .eval import eval_images

    device = _device(args)
    cfg = _resolve_checkpoint_config(args)
    n = eval_images(cfg, args.checkpoint, args.images, args.out, limit=args.limit, device=device)
    print(f"wrote {n} disparity maps to {args.out}")


def cmd_eval_video(args):
    from .eval import eval_video

    device = _device(args)
    cfg = _resolve_checkpoint_config(args)
    n = eval_video(cfg, args.checkpoint, args.video, args.out, limit=args.limit, device=device)
    print(f"wrote {n} disparity maps to {args.out}")


def cmd_simple_depth(args):
    import torch

    from .data import Depth10k, SyntheticTriplets
    from .simple_depth import fit_simple_depth
    from .utils.viz import save_disparity

    device = _device(args)
    os.makedirs(args.out, exist_ok=True)
    if args.dtk_dir:
        with open(args.files) as f:
            files = [l.strip() for l in f if l.strip()]
        ds = Depth10k(args.dtk_dir, files)
    else:
        ds = SyntheticTriplets(n=max(args.index + 1, 1), target_size=(416, 128))
    frames = torch.as_tensor(ds[args.index][None], device=device)
    K = ds.K

    def cb(it, params, loss, warped):
        save_disparity(
            params["disp"][0, ..., 0].cpu().numpy(),
            os.path.join(args.out, f"d-{it}.png"),
        )
        print(f"iter {it}: loss {loss:.5f} mean disp {float(params['disp'].mean()):.4f}")

    res = fit_simple_depth(frames, K, n_iters=args.iters, callback=cb, device=device)
    print("final loss:", res["history"][-1][1])


def cmd_eval_depth(args):
    """AbsRel/delta accuracy against ground-truth depth maps.

    --gt is a .npz with arrays `images` (N,H,W[,C]) float in [0,1] and
    `depths` (N,h,w) metric; or pass --synthetic to score against the
    built-in ground-plane scenes (no external data needed)."""
    from .eval import eval_depth_accuracy

    device = _device(args)
    cfg = _resolve_checkpoint_config(args)
    if args.synthetic:
        from .data.synthetic import SyntheticGroundPlane

        ds = SyntheticGroundPlane(n=args.limit or 8, target_size=cfg.target_size)
        images = [ds[i][1] for i in range(len(ds))]
        gts = [ds.gt_depth] * len(ds)
    else:
        data = np.load(args.gt)
        images = [
            x if x.ndim == 3 else x[..., None] for x in data["images"]
        ]
        gts = list(data["depths"])
        if args.limit:
            images, gts = images[: args.limit], gts[: args.limit]
    m = eval_depth_accuracy(cfg, args.checkpoint, images, gts, device=device)
    print(json.dumps(m, indent=2))


def cmd_profile(args):
    """Capture a torch.profiler trace of the train step (Perfetto,
    chrome://tracing): one step outside the trace, then --steps steps inside
    it, written to <out>/trace.json (tools/profile_breakdown.py analyses
    such traces). On the CPU it records host events only."""
    import torch

    from .device import synchronize
    from .models import create_model
    from .training import TrainContext, create_train_state, make_train_step
    from .utils.profiler import trace

    device = _device(args)
    cfg = _build_config(args)
    state = create_train_state(create_model(cfg, device=device), cfg)
    K = np.asarray(
        [[482.0, 0, cfg.width / 2], [0, 482.0, cfg.height / 2], [0, 0, 1.0]]
    )
    ctx = TrainContext.create(K, cfg.width, cfg.height, device=device)
    step = make_train_step(ctx, cfg)
    batch = torch.from_numpy(
        np.random.default_rng(0).uniform(
            size=(cfg.batch_size, 3, cfg.height, cfg.width, cfg.in_channels)
        ).astype(np.float32)
    ).to(device)
    state, m, _ = step(state, batch)  # cuDNN's first choices outside the trace
    _ = float(m["loss"])
    with trace(args.out):
        for _i in range(args.steps):
            state, m, _ = step(state, batch)
        _ = float(m["loss"])
        synchronize(device)
    print(f"trace written to {os.path.join(args.out, 'trace.json')}")


def cmd_refine_dtk(args):
    from .data import Depth10k, find_static

    device = _device(args)
    with open(args.files) as f:
        files = [l.strip() for l in f if l.strip()]
    ds = Depth10k(args.root, files, grayscale=True)
    non_static = find_static(ds, args.alpha, progress=True, device=device)
    with open(args.out, "w") as f:
        for name in non_static:
            f.write(name + "\n")
    print(f"kept {len(non_static)}/{len(files)} non-static triplets -> {args.out}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="monodepth2_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="self-supervised training")
    _add_config_args(p)
    _add_device_arg(p)
    p.add_argument(
        "--data",
        choices=["kitti", "dtk", "synthetic", "driving"],
        default="synthetic",
    )
    p.add_argument("--root", help="dataset root dir")
    p.add_argument("--sequences", help="comma-separated KITTI sequences (default all 22)")
    p.add_argument("--files", help="Depth10k file-list path")
    p.add_argument("--synthetic-n", type=int, default=64)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--cache-decoded", action="store_true",
                   help="cache resized uint8 frames in RAM after first epoch "
                        "(~53 KB/frame at 416x128; decode-free epochs)")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--mesh", type=int, default=1,
                   help="data-parallel devices: one process per card, so N > 1 "
                        "needs N processes (launched by torchrun)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process init (torch.distributed); the group "
                        "from --coordinator/--num-processes/--process-id or "
                        "torchrun's environment")
    p.add_argument("--coordinator", help="coordinator host:port (rank 0's store)")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)
    p.add_argument("--max-steps", type=int)
    p.add_argument("--progress", action="store_true", help="live tqdm bar")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser(
        "export",
        help="export a serving artifact (torch.export program, weights baked in)")
    _add_config_args(p)
    _add_device_arg(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", default="depth.pt2")
    p.add_argument("--platforms", default=None,
                   help="the one device type the artifact runs on, which is "
                        "the one it is traced on (default: --device's)")
    p.add_argument("--batch", type=int, default=0,
                   help="fixed batch size (0 = symbolic, any N at serve time)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser(
        "serve",
        help="HTTP inference server over an exported artifact "
             "(micro-batching + bucket padding; see server.py)")
    _add_device_arg(p)
    p.add_argument("--artifact", required=True,
                   help="path from `cli export`")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--buckets", default="1,4,16,64",
                   help="comma-separated batch buckets; requests are padded "
                        "to the smallest bucket that fits (each bucket warmed "
                        "on every dispatch worker at startup)")
    p.add_argument("--linger-ms", type=float, default=2.0,
                   help="micro-batching window: how long a request waits "
                        "for others to share its device call")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the per-bucket warmup calls at startup")
    p.add_argument("--max-pending-rows", type=int, default=0,
                   help="backpressure bound: reject (503) when this many "
                        "rows are already queued (0 = 8x largest bucket)")
    p.add_argument("--workers", type=int, default=2,
                   help="pipelined dispatch depth: batcher threads packing "
                        "the next micro-batch while a device call is in "
                        "flight (1 = strictly serial device calls)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("eval-image", help="directory inference")
    _add_config_args(p)
    _add_device_arg(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--out", default="eval_out")
    p.add_argument("--limit", type=int)
    p.set_defaults(fn=cmd_eval_image)

    p = sub.add_parser("eval-video", help="video inference")
    _add_config_args(p)
    _add_device_arg(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--video", required=True)
    p.add_argument("--out", default="eval_out")
    p.add_argument("--limit", type=int)
    p.set_defaults(fn=cmd_eval_video)

    p = sub.add_parser("simple-depth", help="single-triplet disparity fit demo")
    _add_device_arg(p)
    p.add_argument("--dtk-dir")
    p.add_argument("--files")
    p.add_argument("--index", type=int, default=8)
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--out", default="simple_depth_out")
    p.set_defaults(fn=cmd_simple_depth)

    p = sub.add_parser("eval-depth", help="AbsRel/delta accuracy evaluation")
    _add_config_args(p)
    _add_device_arg(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--gt", help=".npz with images + depths arrays")
    p.add_argument("--synthetic", action="store_true",
                   help="score against built-in ground-plane scenes")
    p.add_argument("--limit", type=int)
    p.set_defaults(fn=cmd_eval_depth)

    p = sub.add_parser("profile", help="capture a torch.profiler trace of the train step")
    _add_config_args(p)
    _add_device_arg(p)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--out", default="profile_trace")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("refine-dtk", help="filter static Depth10k triplets")
    _add_device_arg(p)
    p.add_argument("--root", required=True)
    p.add_argument("--files", required=True)
    p.add_argument("--alpha", type=float, default=0.03)
    p.add_argument("--out", default="trainable-nonstatic")
    p.set_defaults(fn=cmd_refine_dtk)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
