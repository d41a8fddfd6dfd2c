"""HTTP inference server over an exported serving artifact, port of
monodepth2_tpu/server.py (stdlib and numpy only, as there).

Serving the card needs three things the reference's one-caller,
frame-at-a-time BSON.load (src/Monodepth.jl:207-208) never had:

- **one process owns the card, many clients speak HTTP** — stdlib
  `ThreadingHTTPServer`, no framework dependency;
- **micro-batching** — concurrent requests are coalesced into a single
  device call (`BucketBatcher`): the card's throughput comes from batch
  size, so per-request dispatch would waste most of it;
- **batch bucketing** — requests are padded to a small fixed set of bucket
  sizes and sliced back, so the card sees a few batch shapes only, each run
  once at warm-up (cuDNN picks its algorithms per shape) before the first
  client arrives, and device memory stays bounded by the largest bucket.
  Padding is exact for this model: every output row depends only on its
  input row (pure CNN, eval-mode BN), verified by tests/test_torch_server.py.

Endpoints:
  GET  /healthz       -> {"ok": true, ...batcher stats}
  GET  /meta          -> the artifact's meta.json
  POST /v1/depth      -> disparity + depth for a batch of images
      Content-Type: application/octet-stream — raw little-endian rows in
          [0,1], header `X-Shape: N,H,W,C` (H,W,C must match the artifact;
          values outside [0,1] are rejected, not clamped);
          X-Input-Dtype: float32 (default) | float16 | uint8 (scaled by
          1/255 — what cameras produce; quarter the request bytes)
      Content-Type: image/png | image/jpeg — one encoded image; decoded,
          resized to the artifact's (W,H) and grayscaled exactly like the
          training pipeline (eval.py _load_image)
      Accept: application/json — base64-encoded arrays + shapes
      otherwise -> application/octet-stream .npz (disparity, depth)
      X-Fields: disparity — subset of output fields to return (default all;
          depth is recomputable client-side from disparity); only the asked
          fields are copied back from the card
      X-Dtype: float16|float32 — response precision (default float32)
"""

from __future__ import annotations

import base64
import inspect
import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS = (1, 4, 16, 64)


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog sized for bursty clients.

    The stdlib default (socketserver.TCPServer.request_queue_size = 5) drops
    SYNs with a connection reset when more than ~5 clients connect in the
    same instant. Micro-batching exists precisely to absorb such bursts, so
    the backlog must be at least the intended concurrency."""

    request_queue_size = 128
    daemon_threads = True


class _Warmup(NamedTuple):
    """A queue item that makes the worker taking it warm itself up."""

    row_shape: Tuple[int, int, int]
    barrier: threading.Barrier
    future: Future
    verbose: bool


class Overloaded(RuntimeError):
    """Raised by submit() when the pending queue is full (backpressure).

    The HTTP layer maps this to 503 + Retry-After so clients shed load
    instead of piling onto the 120 s future timeout."""


class BucketBatcher:
    """Coalesce concurrent requests into bucket-padded device calls.

    `infer` maps a float32 (N, H, W, C) array to a dict of (N, ...) arrays.
    Requests (`submit`) enqueue their rows with a Future; one worker thread
    drains the queue, packs rows in arrival order up to the largest bucket,
    waits up to `linger_s` for stragglers to fill the batch, pads to the
    smallest bucket that fits, runs ONE `infer` call, and splits the result
    rows back onto the futures.

    A request larger than the biggest bucket is rejected at submit (the
    client should chunk); this keeps worst-case latency and device memory
    bounded by max(buckets).

    Backpressure: at most `max_pending_rows` rows may sit in the queue
    (default 8× the largest bucket ≈ 8 device calls of runway). A submit
    that would exceed it raises `Overloaded` immediately — bounded memory
    and fast 503s under flood instead of every client timing out at 120 s.

    Pipelined dispatch: `workers` threads share the queue, so the next
    micro-batch is packed, copied to the card and enqueued while a device
    call is in flight; with one worker the card idles while the host packs
    and copies. Each worker calls `infer` from its own thread (a loaded
    artifact is used for inference only, and each call enters inference
    mode in its thread); the copy of the result back to the host is where
    a worker waits for the card.
    """

    def __init__(
        self,
        infer: Callable[[np.ndarray], Dict[str, np.ndarray]],
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        linger_s: float = 0.002,
        row_shape: Optional[Tuple[int, int, int]] = None,
        max_pending_rows: Optional[int] = None,
        workers: int = 2,
        output_fields: Optional[Sequence[str]] = None,
    ):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self._infer = infer
        # does infer support fetch-side field selection? (build_server's
        # does; test fakes and older callables may be single-argument)
        try:
            sig = inspect.signature(infer)
            positional = [
                p for p in sig.parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            ]
            self._infer_takes_fields = len(positional) >= 2 or any(
                p.kind == p.VAR_POSITIONAL for p in sig.parameters.values()
            )
        except (TypeError, ValueError):
            self._infer_takes_fields = False
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.linger_s = float(linger_s)
        if max_pending_rows is None:
            max_pending_rows = 8 * self.buckets[-1]
        if max_pending_rows < self.buckets[-1]:
            # must admit at least one full bucket or large valid requests
            # would be unconditionally rejected
            raise ValueError(
                f"max_pending_rows {max_pending_rows} < largest bucket "
                f"{self.buckets[-1]}"
            )
        self.max_pending_rows = int(max_pending_rows)
        # per-row shape contract: requests in one group are concatenated, so
        # a mismatched submit must fail AT SUBMIT, not inside the worker
        # (where it would poison an innocent coalesced group)
        self._row_shape = tuple(row_shape) if row_shape is not None else None
        # known output names: lets submit() reject a bogus `fields` BEFORE
        # it coalesces with innocent requests (same poisoning argument as
        # row_shape above); None = unknown, validated at the HTTP layer
        self._output_fields = (
            tuple(output_fields) if output_fields is not None else None
        )
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self.stats = {
            "requests": 0,
            "rows": 0,
            "batches": 0,
            "padded_rows": 0,
            "errors": 0,
            "rejected": 0,
        }
        # backpressure accounting (all under _lock): rows enqueued but not
        # yet picked up by the worker, and their enqueue times (FIFO, so
        # [0] is the oldest waiter — surfaced in /healthz for operators)
        self._pending_rows = 0
        self._waiters: "list[float]" = []
        self._lock = threading.Lock()
        self._threads = [
            threading.Thread(
                target=self._run, name=f"bucket-batcher-{i}", daemon=True
            )
            for i in range(max(1, int(workers)))
        ]
        for t in self._threads:
            t.start()

    # -- client side -----------------------------------------------------
    def submit(
        self, rows: np.ndarray, fields: Optional[Sequence[str]] = None
    ) -> "Future":
        """rows: float32 (n, H, W, C). Resolves to a dict of (n, ...) arrays.

        `fields`: output names this request needs (None = all). When every
        request in a coalesced group restricts its fields, only the union
        is copied back from the card: the selection is pushed down to the
        fetch, not only applied to the HTTP bytes."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 4:
            raise ValueError(f"rows must be (n, H, W, C), got shape {rows.shape}")
        if self._row_shape is not None and rows.shape[1:] != self._row_shape:
            raise ValueError(
                f"rows {rows.shape[1:]} incompatible with {self._row_shape}"
            )
        n = int(rows.shape[0])
        if n == 0:
            raise ValueError("empty request")
        if fields is not None and self._output_fields is not None:
            unknown = [f for f in fields if f not in self._output_fields]
            if unknown:
                raise ValueError(
                    f"unknown fields {unknown}; available "
                    f"{list(self._output_fields)}"
                )
        if n > self.buckets[-1]:
            raise ValueError(
                f"request of {n} rows exceeds the largest bucket "
                f"{self.buckets[-1]}; split it client-side"
            )
        fut: Future = Future()
        with self._lock:
            if self._pending_rows + n > self.max_pending_rows:
                self.stats["rejected"] += 1
                raise Overloaded(
                    f"queue full ({self._pending_rows}/{self.max_pending_rows}"
                    f" rows pending); retry later"
                )
            self._pending_rows += n
            self._waiters.append(time.monotonic())
            self.stats["requests"] += 1
            self.stats["rows"] += n
        self._queue.put((rows, fut, tuple(fields) if fields else None))
        if self._closed:
            # lost race with close(): the worker may already have consumed
            # the sentinel and exited; close() drains stragglers, but a
            # submit that lands after that drain would hang its Future
            self._fail_pending()
        return fut

    def infer_now(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        """Synchronous convenience: submit and wait."""
        return self.submit(rows).result()

    def snapshot(self) -> Dict[str, object]:
        """Stats + live saturation signals (for /healthz): rows waiting in
        the queue, the bound, and how long the oldest waiter has queued."""
        now = time.monotonic()
        with self._lock:
            snap: Dict[str, object] = dict(self.stats)
            snap["queue_rows"] = self._pending_rows
            snap["max_pending_rows"] = self.max_pending_rows
            snap["oldest_wait_s"] = (
                round(now - self._waiters[0], 4) if self._waiters else 0.0
            )
        return snap

    def _dequeued(self, n: int) -> None:
        """Worker picked up an n-row item: release its queue budget."""
        with self._lock:
            self._pending_rows -= n
            if self._waiters:
                self._waiters.pop(0)

    def close(self, timeout: float = 5.0) -> None:
        self._closed = True
        for _ in self._threads:  # one wake-up sentinel per worker
            self._queue.put(None)
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        self._fail_pending()

    def _fail_pending(self) -> None:
        """Fail any futures still enqueued after the workers exited (items
        raced past the close sentinels) instead of leaving them hanging."""
        if any(t.is_alive() for t in self._threads):
            return
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if isinstance(item, _Warmup):
                item.future.set_exception(RuntimeError("batcher is closed"))
            elif item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("batcher is closed"))

    def warmup_with_shape(self, h: int, w: int, c: int, verbose: bool = False) -> None:
        """Run one dummy batch per bucket on every dispatch worker, so every
        serve-time shape has run once on each thread that will serve it
        before the first client arrives. Warming in the caller's thread
        would not do: CUDA libraries keep per-thread state (cuDNN's handle
        and its cache of execution plans), so a shape run on one thread is
        still cold on another. Each worker takes one warm-up item and then
        waits for the others at a barrier, so no worker takes two. `verbose`
        narrates each bucket. Raises what a warm-up call raised."""
        barrier = threading.Barrier(len(self._threads))
        items = [_Warmup((h, w, c), barrier, Future(), verbose) for _ in self._threads]
        for item in items:
            self._queue.put(item)
        for item in items:
            item.future.result()

    def _warm(self, item: "_Warmup") -> None:
        """A worker's warm-up: one zero batch per bucket, then the barrier."""
        name = threading.current_thread().name
        try:
            for i, b in enumerate(self.buckets):
                t0 = time.monotonic()
                self._infer(np.zeros((b, *item.row_shape), np.float32))
                if item.verbose:
                    print(
                        f"warmup: {name} bucket {b} ({i + 1}/{len(self.buckets)}) "
                        f"ready in {time.monotonic() - t0:.1f} s",
                        flush=True,
                    )
        except Exception as e:  # reported to warmup_with_shape's caller
            item.future.set_exception(e)
        else:
            item.future.set_result(None)
        finally:
            try:
                item.barrier.wait(timeout=600)
            except threading.BrokenBarrierError:
                pass

    # -- worker side -----------------------------------------------------
    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                if self._closed:
                    return
                continue
            if isinstance(item, _Warmup):
                self._warm(item)
                continue
            self._dequeued(item[0].shape[0])
            group = [item]
            total = item[0].shape[0]
            deadline = time.monotonic() + self.linger_s
            # drain whatever fits in the largest bucket, lingering briefly
            # so a burst of concurrent requests shares one device call
            while total < self.buckets[-1]:
                remaining = deadline - time.monotonic()
                try:
                    nxt = self._queue.get(
                        timeout=max(remaining, 0) if remaining > 0 else None,
                        block=remaining > 0,
                    )
                except queue.Empty:
                    break
                if nxt is None:
                    if self._closed:
                        self._flush(group, total)
                        return
                    continue
                if isinstance(nxt, _Warmup):
                    self._flush(group, total)
                    group, total = [], 0
                    self._warm(nxt)
                    break
                self._dequeued(nxt[0].shape[0])
                if total + nxt[0].shape[0] > self.buckets[-1]:
                    # doesn't fit: run the current group, start a new one
                    self._flush(group, total)
                    group, total = [nxt], nxt[0].shape[0]
                    deadline = time.monotonic() + self.linger_s
                else:
                    group.append(nxt)
                    total += nxt[0].shape[0]
            self._flush(group, total)

    def _flush(self, group, total: int) -> None:
        if not group:
            return
        # EVERYTHING that can raise stays inside the try: an escaped
        # exception here would kill a worker thread and hang futures
        # enqueued afterwards (submit() pre-validates shapes, but the
        # worker must survive even a contract violation)
        try:
            bucket = next(b for b in self.buckets if b >= total)
            rows = np.concatenate([g[0] for g in group], axis=0)
            if bucket > total:
                pad = np.zeros((bucket - total,) + rows.shape[1:], rows.dtype)
                rows = np.concatenate([rows, pad], axis=0)
            # fetch-side field selection: only if EVERY request in the
            # group restricted its fields does the union shrink the fetch
            fields: Optional[Tuple[str, ...]] = None
            if all(g[2] is not None for g in group):
                seen: list = []
                for g in group:
                    seen.extend(f for f in g[2] if f not in seen)
                fields = tuple(seen)
            if self._infer_takes_fields:
                out = self._infer(rows, fields)
            else:
                out = self._infer(rows)
                if fields is not None:
                    # tolerate a stray unknown name (possible only when no
                    # output_fields contract was given): the offending
                    # request 400s at the HTTP layer's post-result check
                    # instead of a KeyError poisoning the whole group
                    out = {k: out[k] for k in fields if k in out}
            out = {k: np.asarray(v) for k, v in out.items()}
        except Exception as e:  # propagate to every waiting request
            with self._lock:
                self.stats["errors"] += 1
            for g in group:
                if not g[1].cancelled():
                    g[1].set_exception(e)
            return
        with self._lock:
            self.stats["batches"] += 1
            self.stats["padded_rows"] += bucket - total
        off = 0
        for g_rows, fut, _ in group:
            n = g_rows.shape[0]
            if not fut.cancelled():
                fut.set_result({k: v[off : off + n] for k, v in out.items()})
            off += n


def _decode_image(body: bytes, width: int, height: int, channels: int) -> np.ndarray:
    """Decode one PNG/JPEG request body through the SAME preprocessing as
    the eval/training pipeline (eval.py _load_image), so the served path
    cannot silently diverge from it."""
    from .eval import _load_image

    return _load_image(io.BytesIO(body), width, height, channels == 1)[None]


class _Handler(BaseHTTPRequestHandler):
    # set by build_server:
    batcher: BucketBatcher = None  # type: ignore[assignment]
    meta: dict = {}
    quiet: bool = True

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # stdlib default spams stderr
        if not self.quiet:
            super().log_message(fmt, *args)

    # -- helpers ---------------------------------------------------------
    def _send(
        self, code: int, body: bytes, ctype: str, headers: Optional[dict] = None
    ) -> None:
        if code >= 400:
            # error paths may not have drained the request body; leftover
            # bytes would be parsed as the next request line on this
            # keep-alive connection (HTTP/1.1), so close it instead
            self.close_connection = True
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        if code >= 400:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _error(self, code: int, msg: str) -> None:
        self._send_json(code, {"error": msg})

    # -- routes ----------------------------------------------------------
    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.path == "/healthz":
            self._send_json(200, {"ok": True, **self.batcher.snapshot()})
        elif self.path == "/meta":
            self._send_json(200, self.meta)
        else:
            self._error(404, f"no route {self.path}")

    def do_POST(self):  # noqa: N802
        if self.path != "/v1/depth":
            return self._error(404, f"no route {self.path}")
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length <= 0:
                return self._error(400, "empty body")
            body = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
            shape = self.meta["input_shape"]  # [None|N, H, W, C]
            h, w, c = int(shape[1]), int(shape[2]), int(shape[3])
            if ctype in ("image/png", "image/jpeg"):
                try:
                    rows = _decode_image(body, w, h, c)
                except Exception as e:  # undecodable body is a client error
                    return self._error(400, f"cannot decode image: {e}")
            elif ctype == "application/octet-stream":
                hdr = self.headers.get("X-Shape")
                if not hdr:
                    return self._error(400, "X-Shape header required (N,H,W,C)")
                try:
                    dims = tuple(int(d) for d in hdr.split(","))
                except ValueError:
                    return self._error(400, f"bad X-Shape {hdr!r}")
                if len(dims) != 4 or dims[1:] != (h, w, c):
                    return self._error(
                        400, f"X-Shape {dims} incompatible with (N, {h}, {w}, {c})"
                    )
                # compact request encodings: uint8 (what cameras produce —
                # scaled by 1/255, identical to the PNG path's quantization)
                # and float16 quarter/halve the request bytes
                in_name = (self.headers.get("X-Input-Dtype") or "float32").strip()
                wire = {"float32": "<f4", "float16": "<f2", "uint8": "u1"}.get(
                    in_name
                )
                if wire is None:
                    return self._error(
                        400,
                        f"X-Input-Dtype must be float32|float16|uint8, "
                        f"got {in_name!r}",
                    )
                expect = dims[0] * h * w * c * np.dtype(wire).itemsize
                if len(body) != expect:
                    return self._error(
                        400, f"body is {len(body)} bytes, shape needs {expect}"
                    )
                rows = np.frombuffer(body, wire).reshape(dims)
                if in_name == "uint8":
                    # /255 of uint8 is always finite and in [0,1] — no scan
                    rows = rows.astype(np.float32) / 255.0
                else:
                    # asarray keeps the already-float32 wire body zero-copy
                    # (frombuffer view); astype would duplicate the whole
                    # request on the hot path
                    rows = np.asarray(rows, np.float32)
                    if not np.isfinite(rows).all():
                        return self._error(400, "non-finite values in input")
                    lo, hi = float(rows.min()), float(rows.max())
                    if lo < 0.0 or hi > 1.0:
                        return self._error(
                            400,
                            f"inputs must be in [0,1], got [{lo:.3g},{hi:.3g}]",
                        )
            else:
                return self._error(415, f"unsupported Content-Type {ctype!r}")
            # parse + validate the response field subset BEFORE submit so
            # the selection can be pushed down to the device fetch
            fields = None
            fields_hdr = self.headers.get("X-Fields")
            if fields_hdr:
                fields = [f.strip() for f in fields_hdr.split(",") if f.strip()]
                known = self.meta.get("outputs")
                if known:
                    unknown = [f for f in fields if f not in known]
                    if unknown:
                        return self._error(
                            400,
                            f"unknown fields {unknown}; available {known}",
                        )
                if not fields:
                    fields = None
            # validate the response dtype BEFORE submit too: a bad X-Dtype
            # must not consume a device call / queue budget before its 400
            dt_name = (self.headers.get("X-Dtype") or "float32").strip()
            if dt_name not in ("float32", "float16"):
                return self._error(
                    400, f"X-Dtype must be float32|float16, got {dt_name!r}"
                )
            try:
                out = self.batcher.submit(rows, fields=fields).result(timeout=120)
            except Overloaded as e:
                # backpressure: shed load NOW with a retry hint instead of
                # letting floods accumulate toward the 120 s future timeout
                return self._send(
                    503,
                    json.dumps({"error": str(e)}).encode(),
                    "application/json",
                    headers={"Retry-After": "1"},
                )
            except ValueError as e:
                return self._error(400, str(e))
            if fields is not None:
                # the future resolves to the coalesced group's field UNION;
                # subset to what this request actually asked for
                unknown = [f for f in fields if f not in out]
                if unknown:
                    return self._error(
                        400,
                        f"unknown fields {unknown}; available {sorted(out)}",
                    )
                out = {k: out[k] for k in fields}
            # X-Dtype float16 halves the response bytes (lossless for
            # disparity in (0,1), ~1e-3-relative for depth <= 100; depth is
            # also recomputable client-side from disparity via X-Fields);
            # validated before submit, above
            rdtype = np.dtype(dt_name)
            accept = self.headers.get("Accept", "")
            if "application/json" in accept:
                payload = {
                    k: {
                        "shape": list(v.shape),
                        "dtype": dt_name,
                        "b64": base64.b64encode(
                            np.ascontiguousarray(v, rdtype).tobytes()
                        ).decode(),
                    }
                    for k, v in out.items()
                }
                return self._send_json(200, payload)
            buf = io.BytesIO()
            np.savez(buf, **{k: np.asarray(v, rdtype) for k, v in out.items()})
            return self._send(200, buf.getvalue(), "application/octet-stream")
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 — serving must not die per-request
            try:
                self._error(500, f"{type(e).__name__}: {e}")
            except Exception:
                pass


def build_server(
    artifact_path: str,
    host: str = "127.0.0.1",
    port: int = 8000,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    linger_s: float = 0.002,
    warmup: bool = True,
    max_pending_rows: Optional[int] = None,
    workers: int = 2,
    verbose: bool = False,
    device: str = "cuda",
    _infer: Optional[Callable] = None,
    _meta: Optional[dict] = None,
) -> Tuple[ThreadingHTTPServer, BucketBatcher]:
    """Load the artifact onto `device` (the card unless the caller passes
    "cpu"), stand up batcher + HTTP server (not yet serving).

    Returns (server, batcher); call server.serve_forever() (or use `serve`).
    `_infer`/`_meta` inject a fake model for tests.
    """
    if _infer is None:
        from .serving import load_inference

        served = load_inference(artifact_path, device=device)
        meta = served.meta

        def _infer(
            rows: np.ndarray, fields: Optional[Sequence[str]] = None
        ) -> Dict[str, np.ndarray]:
            out = served(rows)  # device tensors: nothing fetched yet
            keys = fields if fields is not None else list(out.keys())
            # .cpu() is the device->host copy, where this worker waits for
            # the card; unwanted outputs are never copied
            return {k: out[k].cpu().numpy() for k in keys}

    else:
        meta = _meta or {"input_shape": [None, 1, 1, 1]}
    shape = meta["input_shape"]
    if shape[0] is not None:
        # fixed-batch artifact (export_inference batch_size=N): the program
        # only accepts N, so the only valid bucket IS N — pad every group to it
        fixed = int(shape[0])
        if tuple(buckets) != (fixed,):
            print(
                f"artifact has fixed batch {fixed}; overriding buckets "
                f"{list(buckets)} -> [{fixed}]",
                flush=True,
            )
        buckets = (fixed,)
    row_shape = (int(shape[1]), int(shape[2]), int(shape[3]))
    batcher = BucketBatcher(
        _infer,
        buckets=buckets,
        linger_s=linger_s,
        row_shape=row_shape,
        max_pending_rows=max_pending_rows,
        workers=workers,
        output_fields=meta.get("outputs"),
    )
    if warmup:
        batcher.warmup_with_shape(*row_shape, verbose=verbose)

    handler = type(
        "BoundHandler", (_Handler,), {"batcher": batcher, "meta": meta}
    )
    server = _Server((host, port), handler)
    return server, batcher


def serve(
    artifact_path: str,
    host: str = "127.0.0.1",
    port: int = 8000,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    linger_s: float = 0.002,
    warmup: bool = True,
    max_pending_rows: Optional[int] = None,
    workers: int = 2,
    device: str = "cuda",
) -> None:
    """Blocking entry point: serve until interrupted."""
    print(f"loading {artifact_path}...", flush=True)
    server, batcher = build_server(
        artifact_path,
        host,
        port,
        buckets,
        linger_s,
        warmup,
        max_pending_rows=max_pending_rows,
        workers=workers,
        verbose=True,
        device=device,
    )
    print(
        f"serving {artifact_path} on http://{host}:{port} "
        f"(buckets {list(batcher.buckets)}, linger {linger_s * 1e3:.1f} ms, "
        f"max pending {batcher.max_pending_rows} rows, "
        f"{len(batcher._threads)} dispatch workers)",
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        batcher.close()
