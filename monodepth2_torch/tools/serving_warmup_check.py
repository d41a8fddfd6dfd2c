"""Where the server's warm-up must run on the card: in the caller's thread,
as the JAX package's server warms its compile cache, or on each dispatch
worker, as `server.BucketBatcher.warmup_with_shape` does.

    python -m monodepth2_torch.tools.serving_warmup_check [--requests 96] [--device cpu]

CUDA libraries keep per-thread state: each thread gets its own cuDNN handle,
and PyTorch keeps cuDNN's execution plans (and, with
`torch.backends.cudnn.benchmark`, the autotuned choices) per thread. A bucket
warmed in one thread is then still cold in a worker, and the first request
of that bucket on that worker waits for the plans to be built. For cuDNN
benchmark on and off, and the warm-up in the caller's thread and on the
workers, this stands up a fresh server (`server.build_server`, buckets 1, 4,
16, 64, 2 workers) over one bf16 artifact of ResNet-18 at 416×128 gray
(weights from seed 0), times every device call by worker thread and bucket,
and runs the HTTP sweep of `tools.http_serving_bench` twice (passes A and
B). Prints one JSON line per (benchmark, warm-up, pass, concurrency): img/s,
p50/p95/max latency in ms, device calls, the slowest device calls as (ms,
worker, bucket), and the first call of each (worker, bucket) pair the pass
made; then the card's name and power limit. Returns them as a dict. Without
a card it raises unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import describe, resolve_device
from ..models import Model
from ..server import build_server
from ..serving import export_inference, load_inference
from ..training.config import TrainConfig
from .http_serving_bench import level, post, request_body


def _server_run(served, bench: bool, on_workers: bool, args) -> list:
    """One fresh server: both passes of the sweep; a row per level."""
    torch.backends.cudnn.benchmark = bench
    calls, lock = [], threading.Lock()

    def infer(rows, fields=None):
        t0 = time.perf_counter()
        out = served(rows)
        res = {k: out[k].cpu().numpy() for k in (fields if fields is not None else list(out))}
        with lock:
            calls.append((threading.current_thread().name, int(rows.shape[0]), (time.perf_counter() - t0) * 1e3))
        return res

    server, batcher = build_server("", port=0, warmup=on_workers, _infer=infer, _meta=served.meta)
    if not on_workers:  # as the JAX server warms: each bucket once, in this thread
        for b in batcher.buckets:
            infer(np.zeros((b, *served.meta["input_shape"][1:]), np.float32))
    calls.clear()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    body = request_body(served.meta, 1, None)
    shape = (1, *served.meta["input_shape"][1:])
    rows, seen = [], set()
    try:
        for p in ("A", "B"):
            for conc in (int(c) for c in args.concurrency.split(",")):
                first = len(calls)
                lv = level(batcher, lambda: post(base, body, shape), conc, args.requests, 1)
                new = calls[first:]
                firsts = []
                for worker, b, ms in new:
                    if (worker, b) not in seen:
                        seen.add((worker, b))
                        firsts.append([ms, worker, b])
                row = dict(
                    cudnn_benchmark=bench, warmup="workers" if on_workers else "caller", pass_=p, **lv,
                    device_calls=len(new), slowest_calls=sorted([ms, w, b] for w, b, ms in new)[-3:],
                    first_calls=firsts,
                )
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--concurrency", default="1,8,32")
    ap.add_argument("--requests", type=int, default=96)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = TrainConfig(target_size=(args.width, args.height), in_channels=1, compute_dtype="bfloat16")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "warmup_check.pt2")
        export_inference(Model.create(depth=18, in_channels=1, device=device), cfg, path)
        served = load_inference(path, device=device)
    benchmark = torch.backends.cudnn.benchmark
    rows = []
    try:
        for bench in (True, False):
            for on_workers in (False, True):
                rows += _server_run(served, bench, on_workers, args)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    summary = describe(device)
    print(json.dumps(summary), flush=True)
    return dict(rows=rows, **summary)


if __name__ == "__main__":
    main()
