"""HTTP serving-path benchmark: requests/s through the port's server stack,
port of tools/http_serving_bench.py.

    python -m monodepth2_torch.tools.http_serving_bench [--concurrency 1,8,32] [--requests 256] [--device cpu]

Exports ResNet-18 inference at 416×128 gray (weights drawn from seed 0, or
from `--checkpoint`, either checkpoint format) in `--compute-dtype`, stands
up `server.build_server` over it on 127.0.0.1 (an ephemeral port) and sends
`--requests` POSTs of `--rows-per-request` rows from `--concurrency` client
threads at a time: HTTP parse → micro-batch coalescing → bucket padding →
device call → npz response. The point of the sweep is that micro-batching
recovers the card's batch efficiency under concurrency: N concurrent
single-image clients should share device calls (batches ≪ requests).

Prints one JSON line per concurrency level (img/s, ms per request, p50/p95
latency, device batches, rows per device call, padded share), then one
with the card's name and power limit; returns them as a dict. Host-clock
times throughout: the clients wait on HTTP responses, each of which ends
with the copy back from the card. Without a card it raises unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import describe, resolve_device
from ..server import build_server


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint", default=None, help="serve these weights (default: drawn from seed 0)")
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--buckets", default="1,4,16,64")
    ap.add_argument("--linger-ms", type=float, default=2.0)
    ap.add_argument("--concurrency", default="1,8,32")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--rows-per-request", type=int, default=1)
    ap.add_argument("--workers", type=int, default=2, help="batcher dispatch pipeline depth")
    ap.add_argument("--fields", default=None, help="X-Fields response subset, e.g. 'disparity'")
    ap.add_argument("--dtype", default=None, help="X-Dtype response precision: float16|float32")
    ap.add_argument("--input-dtype", default=None, help="X-Input-Dtype request encoding: uint8|float16")
    ap.add_argument("--artifact", default=None, help="serve an existing export instead of exporting one")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    with tempfile.TemporaryDirectory() as tmp:
        artifact = args.artifact
        if artifact is None:
            from ..eval import load_model, sidecar_config
            from ..models import Model
            from ..serving import export_inference
            from ..training.config import TrainConfig

            cfg = TrainConfig(target_size=(args.width, args.height), in_channels=1, compute_dtype=args.compute_dtype)
            if args.checkpoint:
                side = sidecar_config(args.checkpoint)
                if side is not None:
                    cfg = dataclasses.replace(side, compute_dtype=args.compute_dtype)
                model = load_model(cfg, args.checkpoint, device)
            else:
                model = Model.create(depth=18, in_channels=1, scale_levels=cfg.scale_levels, device=device)
            artifact = os.path.join(tmp, "http_bench.pt2")
            export_inference(model, cfg, artifact)
        return _sweep(args, artifact, device)


def request_body(meta: dict, n: int, input_dtype: Optional[str], seed: int = 0) -> bytes:
    """n rows of the artifact's input shape, uniform from `seed`, encoded as
    X-Input-Dtype `input_dtype` (None: float32)."""
    h, w, c = meta["input_shape"][1:]
    rows = np.random.default_rng(seed).uniform(size=(n, h, w, c))
    if input_dtype == "uint8":
        return (rows * 255).astype(np.uint8).tobytes()
    if input_dtype == "float16":
        return rows.astype(np.float16).tobytes()
    return rows.astype(np.float32).tobytes()


def post(base: str, body: bytes, shape, headers: Optional[dict] = None) -> float:
    """POST one octet-stream request to /v1/depth, read one returned field
    in full, and return the seconds it took."""
    t0 = time.perf_counter()
    req = urllib.request.Request(base + "/v1/depth", data=body, method="POST")
    req.add_header("Content-Type", "application/octet-stream")
    req.add_header("X-Shape", ",".join(str(d) for d in shape))
    for header, value in (headers or {}).items():
        if value:
            req.add_header(header, value)
    with urllib.request.urlopen(req, timeout=300) as r:
        out = np.load(io.BytesIO(r.read()))
        # one returned field (X-Fields may exclude disparity)
        _ = float(out[out.files[0]].astype(np.float32).mean())
    return time.perf_counter() - t0


def level(batcher, one_request, concurrency: int, requests: int, rows_per_request: int) -> dict:
    """`requests` calls of one_request() from `concurrency` client threads:
    img/s, ms per request, p50/p95/max latency, device batches, rows per
    device call and the padded share, from the batcher's counters."""
    before = dict(batcher.stats)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        lats = list(pool.map(lambda _: one_request(), range(requests)))
    dt = time.perf_counter() - t0
    batches = batcher.stats["batches"] - before["batches"]
    padded = batcher.stats["padded_rows"] - before["padded_rows"]
    total_rows = requests * rows_per_request
    return dict(
        concurrency=concurrency, requests=requests, rows_per_request=rows_per_request,
        img_per_s=total_rows / dt, ms_per_request=dt / requests * 1e3,
        p50_ms=float(np.percentile(lats, 50)) * 1e3, p95_ms=float(np.percentile(lats, 95)) * 1e3,
        max_ms=max(lats) * 1e3, device_batches=batches, rows_per_device_call=total_rows / max(batches, 1),
        padded_fraction=padded / max(total_rows + padded, 1),
    )


def _sweep(args, artifact: str, device: torch.device) -> dict:
    buckets = tuple(int(b) for b in args.buckets.split(","))
    server, batcher = build_server(
        artifact, port=0, buckets=buckets, linger_s=args.linger_ms / 1e3, warmup=True, workers=args.workers,
        device=str(device),
    )
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    with urllib.request.urlopen(base + "/meta", timeout=30) as r:
        meta = json.loads(r.read())
    n = args.rows_per_request
    body = request_body(meta, n, args.input_dtype)
    shape = (n, *meta["input_shape"][1:])
    headers = {"X-Fields": args.fields, "X-Dtype": args.dtype, "X-Input-Dtype": args.input_dtype}
    levels = []
    try:
        post(base, body, shape, headers)  # connection and response-path warm-up
        for conc in (int(x) for x in args.concurrency.split(",")):
            lv = level(batcher, lambda: post(base, body, shape, headers), conc, args.requests, n)
            lv.update(
                workers=args.workers, buckets=list(batcher.buckets), compute_dtype=meta["compute_dtype"],
                fields=args.fields or "all", dtype=args.dtype or "float32",
                input_dtype=args.input_dtype or "float32",
            )
            levels.append(lv)
            print(json.dumps(lv), flush=True)
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    summary = describe(device)
    print(json.dumps(summary), flush=True)
    return dict(levels=levels, **summary)


if __name__ == "__main__":
    main()
