"""monodepth2_torch's HTTP serving layer (server.py) on the CPU: a
counterpart of every test of tests/test_server.py (micro-batching, bucket
padding, backpressure, pipelined dispatch and the wire protocol, against an
injected row-pure fake model), the same requests answered alike by the
JAX package's server and the port's, and the port's server in front of a
real exported artifact at 64×32 (1e-5 abs against live inference)."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from monodepth2_torch.server import BucketBatcher, Overloaded, build_server
from monodepth2_tpu import server as jax_server

H, W, C = 8, 12, 1


def fake_infer(rows: np.ndarray):
    """Row-pure fake model with real output shapes: each output row is a
    function of its input row only — exactly the property that makes
    bucket padding lossless for the real CNN."""
    assert rows.dtype == np.float32
    disp = rows.mean(axis=-1, keepdims=True) * 0.5 + 0.1  # (N, H, W, 1)
    return {"disparity": disp, "depth": 1.0 / (disp + 0.01)}


def rand_rows(n, seed=0):
    return np.random.RandomState(seed).rand(n, H, W, C).astype(np.float32)


# ---------------------------------------------------------------- batcher


def test_batcher_pads_to_bucket_and_slices_back():
    b = BucketBatcher(fake_infer, buckets=(1, 4, 16), linger_s=0.0)
    try:
        x = rand_rows(3)
        out = b.infer_now(x)
        np.testing.assert_allclose(out["disparity"], fake_infer(x)["disparity"])
        assert out["disparity"].shape == (3, H, W, 1)
        assert b.stats["batches"] == 1
        assert b.stats["padded_rows"] == 1  # 3 -> bucket 4
    finally:
        b.close()


def test_batcher_coalesces_concurrent_requests():
    b = BucketBatcher(fake_infer, buckets=(1, 4, 16), linger_s=0.25)
    try:
        xs = [rand_rows(1, seed=i) for i in range(3)]
        futs = [b.submit(x) for x in xs]  # all enqueued inside one linger
        outs = [f.result(timeout=10) for f in futs]
        for x, o in zip(xs, outs):
            np.testing.assert_allclose(o["disparity"], fake_infer(x)["disparity"])
        assert b.stats["batches"] == 1  # ONE device call for 3 requests
        assert b.stats["requests"] == 3
        assert b.stats["padded_rows"] == 1  # 3 rows -> bucket 4
    finally:
        b.close()


def test_batcher_splits_oversized_group():
    # group that would exceed the largest bucket is flushed and restarted
    b = BucketBatcher(fake_infer, buckets=(4,), linger_s=0.25)
    try:
        futs = [b.submit(rand_rows(3, seed=i)) for i in range(2)]  # 3+3 > 4
        for f in futs:
            assert f.result(timeout=10)["disparity"].shape == (3, H, W, 1)
        assert b.stats["batches"] == 2
    finally:
        b.close()


def test_batcher_rejects_oversized_request():
    b = BucketBatcher(fake_infer, buckets=(1, 2), linger_s=0.0)
    try:
        with pytest.raises(ValueError, match="largest bucket"):
            b.submit(rand_rows(3))
    finally:
        b.close()


def test_batcher_backpressure_rejects_when_full():
    gate, entered = threading.Event(), threading.Event()

    def slow_infer(rows):
        entered.set()
        assert gate.wait(10)
        return fake_infer(rows)

    # workers=1: the bound is on rows *queued behind* in-flight calls, so the
    # test needs exactly one call in flight to fill the queue deterministically
    b = BucketBatcher(slow_infer, buckets=(2,), linger_s=0.0,
                      max_pending_rows=2, workers=1)
    try:
        f0 = b.submit(rand_rows(2, seed=0))  # worker picks this up...
        assert entered.wait(10)              # ...and blocks inside infer
        f1 = b.submit(rand_rows(2, seed=1))  # queued: pending = 2/2
        snap = b.snapshot()
        assert snap["queue_rows"] == 2
        assert snap["oldest_wait_s"] >= 0.0
        with pytest.raises(Overloaded, match="queue full"):
            b.submit(rand_rows(1, seed=2))   # 2 + 1 > 2 -> shed
        assert b.stats["rejected"] == 1
        gate.set()                           # drain; queued work unaffected
        assert f0.result(timeout=10)["disparity"].shape == (2, H, W, 1)
        assert f1.result(timeout=10)["disparity"].shape == (2, H, W, 1)
        assert b.snapshot()["queue_rows"] == 0
    finally:
        gate.set()
        b.close()


def test_batcher_pipelined_dispatch_overlaps_device_calls():
    """With workers=2, a second micro-batch is dispatched while the first
    call is still in flight (the whole point of pipelined dispatch: the
    remote-TPU round-trip must overlap with packing the next batch)."""
    first, second, release = threading.Event(), threading.Event(), threading.Event()
    calls = []
    lock = threading.Lock()

    def slow_infer(rows):
        with lock:
            calls.append(rows.shape[0])
            k = len(calls)
        (first if k == 1 else second).set()
        assert release.wait(10)  # both calls must get here CONCURRENTLY
        return fake_infer(rows)

    b = BucketBatcher(slow_infer, buckets=(2,), linger_s=0.0, workers=2)
    try:
        f0 = b.submit(rand_rows(2, seed=0))
        assert first.wait(10)
        f1 = b.submit(rand_rows(2, seed=1))
        # if dispatch were serial, the second infer could never start while
        # the first blocks — this wait would time out
        assert second.wait(10), "second device call did not overlap the first"
        release.set()
        assert f0.result(timeout=10)["disparity"].shape == (2, H, W, 1)
        assert f1.result(timeout=10)["disparity"].shape == (2, H, W, 1)
        assert b.stats["batches"] == 2
    finally:
        release.set()
        b.close()


def test_batcher_rejects_bound_below_largest_bucket():
    with pytest.raises(ValueError, match="max_pending_rows"):
        BucketBatcher(fake_infer, buckets=(1, 4), max_pending_rows=2)


def test_batcher_propagates_infer_errors():
    def broken(rows):
        raise RuntimeError("device on fire")

    b = BucketBatcher(broken, buckets=(4,), linger_s=0.0)
    try:
        with pytest.raises(RuntimeError, match="device on fire"):
            b.infer_now(rand_rows(2))
        assert b.stats["errors"] == 1
    finally:
        b.close()


# ------------------------------------------------------------------ HTTP


@pytest.fixture()
def http_server():
    meta = {
        "input_shape": [None, H, W, C],
        "outputs": ["disparity", "depth"],
        "min_depth": 0.1,
        "max_depth": 100.0,
    }
    server, batcher = build_server(
        "unused", port=0, buckets=(1, 4), linger_s=0.0,
        warmup=False, _infer=fake_infer, _meta=meta,
    )
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        yield base, batcher
    finally:
        server.shutdown()
        batcher.close()


def _post(base, path, body, ctype, headers=None):
    req = urllib.request.Request(base + path, data=body, method="POST")
    req.add_header("Content-Type", ctype)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    return urllib.request.urlopen(req, timeout=30)


def test_http_healthz_and_meta(http_server):
    base, _ = http_server
    with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
        assert json.loads(r.read())["ok"] is True
    with urllib.request.urlopen(base + "/meta", timeout=10) as r:
        assert json.loads(r.read())["input_shape"] == [None, H, W, C]


def test_http_octet_stream_roundtrip(http_server):
    base, _ = http_server
    x = rand_rows(2)
    with _post(
        base, "/v1/depth", x.tobytes(), "application/octet-stream",
        {"X-Shape": f"2,{H},{W},{C}"},
    ) as r:
        assert r.headers["Content-Type"] == "application/octet-stream"
        out = np.load(io.BytesIO(r.read()))
        np.testing.assert_allclose(
            out["disparity"], fake_infer(x)["disparity"], rtol=1e-6
        )
        assert out["depth"].shape == (2, H, W, 1)


def test_http_json_response(http_server):
    base, _ = http_server
    x = rand_rows(1)
    with _post(
        base, "/v1/depth", x.tobytes(), "application/octet-stream",
        {"X-Shape": f"1,{H},{W},{C}", "Accept": "application/json"},
    ) as r:
        payload = json.loads(r.read())
        disp = np.frombuffer(
            base64.b64decode(payload["disparity"]["b64"]), "<f4"
        ).reshape(payload["disparity"]["shape"])
        np.testing.assert_allclose(disp, fake_infer(x)["disparity"], rtol=1e-6)


def test_http_fields_and_dtype_response_controls(http_server):
    """X-Fields subsets the reply; X-Dtype: float16 halves its bytes —
    the knobs a transport-bound deployment uses to buy requests/s."""
    base, _ = http_server
    x = rand_rows(2)
    hdrs = {"X-Shape": f"2,{H},{W},{C}",
            "X-Fields": "disparity", "X-Dtype": "float16"}
    with _post(base, "/v1/depth", x.tobytes(),
               "application/octet-stream", hdrs) as r:
        out = np.load(io.BytesIO(r.read()))
        assert set(out.files) == {"disparity"}
        assert out["disparity"].dtype == np.float16
        np.testing.assert_allclose(
            out["disparity"].astype(np.float32),
            fake_infer(x)["disparity"], rtol=1e-3, atol=1e-4,
        )
    # JSON path honors them too and labels the dtype
    hdrs["Accept"] = "application/json"
    with _post(base, "/v1/depth", x.tobytes(),
               "application/octet-stream", hdrs) as r:
        payload = json.loads(r.read())
        assert set(payload) == {"disparity"}
        assert payload["disparity"]["dtype"] == "float16"
        disp = np.frombuffer(
            base64.b64decode(payload["disparity"]["b64"]), "<f2"
        ).reshape(payload["disparity"]["shape"])
        np.testing.assert_allclose(
            disp.astype(np.float32), fake_infer(x)["disparity"],
            rtol=1e-3, atol=1e-4,
        )
    # unknown field / bad dtype are client errors, not 500s
    for bad in ({"X-Fields": "nope"}, {"X-Dtype": "int8"}):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/v1/depth", x.tobytes(), "application/octet-stream",
                  {"X-Shape": f"2,{H},{W},{C}", **bad})
        assert ei.value.code == 400


def test_http_uint8_input(http_server):
    """uint8 request bodies are scaled by 1/255 — byte-identical inputs to
    the fp32 path after quantization, at 1/4 the request bytes."""
    base, _ = http_server
    x8 = (np.random.RandomState(7).rand(1, H, W, C) * 255).astype(np.uint8)
    with _post(base, "/v1/depth", x8.tobytes(), "application/octet-stream",
               {"X-Shape": f"1,{H},{W},{C}", "X-Input-Dtype": "uint8"}) as r:
        out = np.load(io.BytesIO(r.read()))
        expect = fake_infer(x8.astype(np.float32) / 255.0)["disparity"]
        np.testing.assert_allclose(out["disparity"], expect, rtol=1e-6)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base, "/v1/depth", x8.tobytes(), "application/octet-stream",
              {"X-Shape": f"1,{H},{W},{C}", "X-Input-Dtype": "int32"})
    assert ei.value.code == 400


def test_batcher_field_selection_pushed_to_fetch():
    """When every request in a group restricts fields, infer receives the
    union (the fetch shrinks); a None-fields request forces a full fetch."""
    seen = []

    def recording_infer(rows, fields=None):
        seen.append(fields)
        out = fake_infer(rows)
        return {k: out[k] for k in (fields or out)}

    b = BucketBatcher(recording_infer, buckets=(4,), linger_s=0.05, workers=1)
    try:
        f0 = b.submit(rand_rows(1, seed=0), fields=("disparity",))
        f1 = b.submit(rand_rows(1, seed=1), fields=("disparity", "depth"))
        assert set(f0.result(timeout=10)) == {"disparity", "depth"}  # union
        assert set(f1.result(timeout=10)) == {"disparity", "depth"}
        assert seen[-1] == ("disparity", "depth")
        f2 = b.submit(rand_rows(1, seed=2), fields=("disparity",))
        assert set(f2.result(timeout=10)) == {"disparity"}
        assert seen[-1] == ("disparity",)
        f3 = b.submit(rand_rows(1, seed=3))  # unrestricted -> full fetch
        assert set(f3.result(timeout=10)) == {"disparity", "depth"}
        assert seen[-1] is None
    finally:
        b.close()


def test_batcher_single_arg_infer_still_works():
    """Legacy single-argument infer callables get field subsetting applied
    after the call instead of pushed down."""
    b = BucketBatcher(fake_infer, buckets=(2,), linger_s=0.0, workers=1)
    try:
        out = b.submit(rand_rows(1), fields=("depth",)).result(timeout=10)
        assert set(out) == {"depth"}
    finally:
        b.close()


def test_http_png_request(http_server):
    from PIL import Image

    base, _ = http_server
    img = (np.random.RandomState(3).rand(H * 2, W * 2) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, "L").save(buf, format="PNG")
    with _post(base, "/v1/depth", buf.getvalue(), "image/png") as r:
        out = np.load(io.BytesIO(r.read()))
        # decoded + resized to the artifact's (H, W) like eval.py
        assert out["disparity"].shape == (1, H, W, 1)


@pytest.mark.parametrize(
    "body,ctype,headers,code,msg",
    [
        (b"", "application/octet-stream", {"X-Shape": "1,8,12,1"}, 400, "empty"),
        (b"\0" * 16, "application/octet-stream", {}, 400, "X-Shape"),
        (b"\0" * 16, "application/octet-stream",
         {"X-Shape": "1,9,9,9"}, 400, "incompatible"),
        (b"\0" * 16, "application/octet-stream",
         {"X-Shape": f"1,{H},{W},{C}"}, 400, "bytes"),
        (b"\0" * 16, "text/plain", {}, 415, "Content-Type"),
    ],
)
def test_http_rejects_bad_requests(http_server, body, ctype, headers, code, msg):
    base, _ = http_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/v1/depth", body, ctype, headers)
    assert e.value.code == code
    assert msg in json.loads(e.value.read())["error"]


def test_http_overload_returns_503_with_retry_after():
    """Flood behavior: when the queue bound is hit, requests get an
    immediate 503 + Retry-After (bounded memory), and the requests already
    admitted still complete once the device frees up."""
    gate, entered = threading.Event(), threading.Event()

    def slow_infer(rows):
        entered.set()
        assert gate.wait(10)
        return fake_infer(rows)

    meta = {"input_shape": [None, H, W, C]}
    server, batcher = build_server(
        "unused", port=0, buckets=(1,), linger_s=0.0, warmup=False,
        max_pending_rows=1, workers=1, _infer=slow_infer, _meta=meta,
    )
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    hdrs = {"X-Shape": f"1,{H},{W},{C}"}
    results = {}

    def post_async(key):
        def run():
            try:
                with _post(base, "/v1/depth", rand_rows(1).tobytes(),
                           "application/octet-stream", hdrs) as r:
                    results[key] = r.status
            except urllib.error.HTTPError as e:
                results[key] = e.code
        th = threading.Thread(target=run, daemon=True)
        th.start()
        return th

    try:
        ta = post_async("a")              # dequeued, blocks inside infer
        assert entered.wait(10)
        tb = post_async("b")              # admitted: queue 1/1
        for _ in range(100):              # wait until b is actually queued
            if batcher.snapshot()["queue_rows"] >= 1:
                break
            import time as _t
            _t.sleep(0.02)
        assert batcher.snapshot()["queue_rows"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:  # c: queue full
            _post(base, "/v1/depth", rand_rows(1).tobytes(),
                  "application/octet-stream", hdrs)
        assert e.value.code == 503
        assert e.value.headers["Retry-After"] == "1"
        assert "queue full" in json.loads(e.value.read())["error"]
        gate.set()
        ta.join(10), tb.join(10)
        assert results == {"a": 200, "b": 200}
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["rejected"] == 1
        assert health["max_pending_rows"] == 1
    finally:
        gate.set()
        server.shutdown()
        batcher.close()


def test_http_rejects_out_of_range_values(http_server):
    base, _ = http_server
    x = rand_rows(1) + 5.0  # outside [0,1]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(
            base, "/v1/depth", x.tobytes(), "application/octet-stream",
            {"X-Shape": f"1,{H},{W},{C}"},
        )
    assert e.value.code == 400
    assert "[0,1]" in json.loads(e.value.read())["error"]


def test_batcher_submit_rejects_unknown_fields():
    """With an output contract, a bogus field must fail AT SUBMIT (same
    poisoning argument as row_shape): otherwise it coalesces with innocent
    requests and the whole group 500s."""
    b = BucketBatcher(
        fake_infer, buckets=(2,), linger_s=0.0,
        output_fields=("disparity", "depth"),
    )
    try:
        with pytest.raises(ValueError, match="unknown fields"):
            b.submit(rand_rows(1), fields=("nope",))
        assert b.stats["requests"] == 0  # rejected before admission
    finally:
        b.close()


def test_batcher_unknown_field_does_not_poison_group():
    """Without an output contract the worker cannot pre-validate; a stray
    unknown name must degrade to a missing key for the offender, never a
    KeyError that set_exception()s every innocent future in the group."""
    b = BucketBatcher(fake_infer, buckets=(4,), linger_s=0.25, workers=1)
    try:
        good = b.submit(rand_rows(1), fields=("disparity",))
        bad = b.submit(rand_rows(1, seed=1), fields=("nope",))
        out = good.result(timeout=10)
        assert "disparity" in out  # innocent request unharmed
        assert "nope" not in bad.result(timeout=10)
    finally:
        b.close()


def test_http_bad_dtype_rejected_before_submit(http_server):
    """A bad X-Dtype must 400 BEFORE consuming a device call or queue
    budget (X-Fields got this treatment; X-Dtype was validated after the
    result arrived)."""
    base, batcher = http_server
    before = batcher.stats["requests"]
    body = rand_rows(1).tobytes()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/v1/depth", body, "application/octet-stream",
              {"X-Shape": f"1,{H},{W},{C}", "X-Dtype": "int8"})
    assert e.value.code == 400
    assert "X-Dtype" in json.loads(e.value.read())["error"]
    assert batcher.stats["requests"] == before  # never submitted


# ------------------------------------------- the JAX package's server alike


def _both_servers(meta):
    """The JAX package's server and the port's, each over fake_infer."""
    servers = []
    for build in (jax_server.build_server, build_server):
        server, batcher = build("unused", port=0, buckets=(1, 4), linger_s=0.0, warmup=False,
                                _infer=fake_infer, _meta=meta)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append((server, batcher, f"http://127.0.0.1:{server.server_address[1]}"))
    return servers


def _png_body():
    from PIL import Image

    img = (np.random.RandomState(3).rand(H * 2, W * 2) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, "L").save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["float32", "uint8", "json_fields_float16", "png", "bad_shape"])
def test_same_requests_same_responses_as_jax_server(kind):
    """Byte-identical bodies and status codes from both servers."""
    meta = {"input_shape": [None, H, W, C], "outputs": ["disparity", "depth"]}
    x = rand_rows(3, seed=11)
    shape = {"X-Shape": f"3,{H},{W},{C}"}
    body, ctype, headers = {
        "float32": (x.tobytes(), "application/octet-stream", shape),
        "uint8": ((x * 255).astype(np.uint8).tobytes(), "application/octet-stream",
                  {**shape, "X-Input-Dtype": "uint8"}),
        "json_fields_float16": (x.tobytes(), "application/octet-stream",
                                {**shape, "Accept": "application/json", "X-Fields": "depth", "X-Dtype": "float16"}),
        "png": (_png_body(), "image/png", {}),
        "bad_shape": (x.tobytes(), "application/octet-stream", {"X-Shape": f"3,{H + 1},{W},{C}"}),
    }[kind]
    replies = []
    servers = _both_servers(meta)
    try:
        for _, _, base in servers:
            try:
                with _post(base, "/v1/depth", body, ctype, headers) as r:
                    replies.append((r.status, r.headers["Content-Type"], r.read()))
            except urllib.error.HTTPError as e:
                replies.append((e.code, e.headers["Content-Type"], e.read()))
    finally:
        for server, batcher, _ in servers:
            server.shutdown()
            server.server_close()
            batcher.close()
    (jcode, jtype, jbody), (code, ctype_out, got) = replies
    assert (code, ctype_out) == (jcode, jtype)
    assert code == (400 if kind == "bad_shape" else 200)
    if ctype_out == "application/octet-stream":
        jout, out = np.load(io.BytesIO(jbody)), np.load(io.BytesIO(got))
        assert out.files == jout.files
        for k in out.files:
            np.testing.assert_array_equal(out[k], jout[k])
    else:
        assert json.loads(got) == json.loads(jbody)


# ------------------------------------------------ over a real artifact


@pytest.fixture(scope="module")
def real_artifact(tmp_path_factory):
    from monodepth2_torch.models import Model
    from monodepth2_torch.serving import export_inference, make_inference_fn
    from monodepth2_torch.training import TrainConfig

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg = TrainConfig(target_size=(64, 32), in_channels=1)
        model = Model.create(depth=18, in_channels=1, seed=7, device="cpu")
        path = str(tmp_path_factory.mktemp("server") / "depth.pt2")
        export_inference(model, cfg, path)
        live = make_inference_fn(model, cfg)
        yield cfg, live, path
    finally:
        torch.set_num_threads(n)


def test_http_server_over_real_artifact(real_artifact):
    """The port's server in front of a real exported artifact: requests
    through HTTP match live inference, bucket padding included (2 rows are
    padded to bucket 4 and sliced back), a PNG included, and 8 concurrent
    clients, whose requests 2 dispatch workers send to the artifact from
    two threads, each get their own rows back."""
    from monodepth2_torch.eval import _load_image

    cfg, live, path = real_artifact
    server, batcher = build_server(path, port=0, buckets=(4, 16), linger_s=0.01, warmup=True, device="cpu")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    hdr = lambda n: {"X-Shape": f"{n},{cfg.height},{cfg.width},1"}  # noqa: E731

    def expected(rows):
        with torch.inference_mode():
            return {k: v.numpy() for k, v in live(torch.from_numpy(rows)).items()}

    try:
        with urllib.request.urlopen(base + "/meta", timeout=30) as r:
            meta = json.loads(r.read())
        assert meta["outputs"] == ["disparity", "depth"] and meta["platforms"] == ["cpu"]
        x = np.random.default_rng(2).uniform(size=(2, cfg.height, cfg.width, 1)).astype(np.float32)
        with _post(base, "/v1/depth", x.tobytes(), "application/octet-stream", hdr(2)) as r:
            out = np.load(io.BytesIO(r.read()))
        for k in ("disparity", "depth"):
            np.testing.assert_allclose(out[k], expected(x)[k], rtol=0, atol=1e-5)
        assert batcher.stats["padded_rows"] == 2  # 2 rows -> bucket 4

        png = _png_body()
        with _post(base, "/v1/depth", png, "image/png") as r:
            out = np.load(io.BytesIO(r.read()))
        rows = _load_image(io.BytesIO(png), cfg.width, cfg.height, True)[None]
        np.testing.assert_allclose(out["disparity"], expected(rows)["disparity"], rtol=0, atol=1e-5)

        xs = [np.random.default_rng(10 + i).uniform(size=(1 + i % 3, cfg.height, cfg.width, 1)).astype(np.float32)
              for i in range(8)]
        outs, errors = [None] * 8, []

        def client(i):
            try:
                with _post(base, "/v1/depth", xs[i].tobytes(), "application/octet-stream",
                           {**hdr(len(xs[i])), "X-Fields": "disparity"}) as r:
                    outs[i] = np.load(io.BytesIO(r.read()))["disparity"]
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        before = batcher.stats["batches"]
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not errors and not any(th.is_alive() for th in threads)
        for xi, oi in zip(xs, outs):
            np.testing.assert_allclose(oi, expected(xi)["disparity"], rtol=0, atol=1e-5)
        assert batcher.stats["batches"] - before < 8  # coalesced
        assert batcher.stats["errors"] == 0
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()


def test_build_server_refuses_missing_cuda(real_artifact):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, path = real_artifact
    with pytest.raises(RuntimeError, match="CUDA"):
        build_server(path, port=0, warmup=False)


def test_warmup_runs_every_bucket_on_every_worker():
    """CUDA libraries keep per-thread state, so the warm-up runs each bucket
    on each dispatch worker, and none on the caller's thread; a failing
    warm-up call raises to the caller."""
    seen, lock = [], threading.Lock()

    def recording_infer(rows):
        with lock:
            seen.append((threading.current_thread().name, rows.shape[0]))
        return fake_infer(rows)

    b = BucketBatcher(recording_infer, buckets=(1, 4, 16), workers=3)
    try:
        b.warmup_with_shape(H, W, C)
        names = {t.name for t in b._threads}
        assert sorted(seen) == sorted((n, k) for n in names for k in (1, 4, 16))
        out = b.infer_now(rand_rows(2))  # serving goes on after the warm-up
        assert out["disparity"].shape == (2, H, W, 1)
    finally:
        b.close()

    def broken(rows):
        raise RuntimeError("no card")

    b = BucketBatcher(broken, buckets=(2,), workers=2)
    try:
        with pytest.raises(RuntimeError, match="no card"):
            b.warmup_with_shape(H, W, C)
    finally:
        b.close()
