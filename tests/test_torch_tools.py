"""The port's measurement entry points — monodepth2_torch.bench,
tools.warp_kernel_bench and tools.profile_breakdown — at a tiny size on the
CPU (64×32 frames, batch 1, 2 warped images, 1-2 iterations); the serving
tools (tools.serving_bench, http_serving_bench, model_block_bench,
serving_warmup_check) and the
convergence experiment (tools.ssl_driving_experiment, 4 steps, then
resumed) at 64×32; and
monodepth2_torch.utils.profiler against the JAX package's. On the CPU the
entry points report host-clock times and no device metric (roofline, MFU,
idle share are None); on a machine with no card they refuse to run unless
asked for the CPU."""

import json
import math
import time

import pytest
import torch

from monodepth2_torch import bench
from monodepth2_torch.tools import (
    http_serving_bench,
    k3_sweep,
    kernel_ab,
    model_block_bench,
    profile_breakdown,
    serving_bench,
    serving_warmup_check,
    ssl_driving_experiment,
    warp_kernel_bench,
)
from monodepth2_torch.utils import profiler
from monodepth2_tpu.utils import profiler as jax_profiler

TINY = ["--device", "cpu", "--width", "64", "--height", "32", "--batch-size", "1"]
KERNEL_NAMES = ("grid_sample_fwd", "grid_sample_bwd_uv", "grid_sample_bwd_img")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    host's cores, which torch's default of one thread a core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _printed(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def _assert_finite(record, keys):
    for key in keys:
        assert isinstance(record[key], (int, float)) and math.isfinite(record[key]), (key, record[key])


def test_bench_on_cpu(capsys):
    """Both modes, their windows in turns; the headline keeps its name on
    the eager mode, and the graph mode (which on the CPU runs its steps
    eagerly) reports under a name of its own."""
    out = bench.main(TINY + ["--warmup", "1", "--steps", "2", "--steps-per-call", "2"])
    assert _printed(capsys) == [out]
    _assert_finite(out, ("value", "ms_per_step", "step_gflops", "loss"))
    assert out["metric"] == out["eager"]["metric"] == "kitti_64x32_train_images_per_sec_per_chip"
    assert out["graph"]["metric"] == "kitti_64x32_graph_train_images_per_sec_per_chip"
    assert out["unit"] == "img/s" and out["steps_per_call"] == 2 and out["mode"] == "eager"
    assert out["window_order"] == ["eager", "graph", "graph", "eager"]
    for mode in bench.MODES:
        _assert_finite(out[mode], ("ms_per_step", "img_per_s", "loss"))
        assert out[mode]["ms_per_step"] == min(out[mode]["ms_per_step_windows"])
        assert len(out[mode]["ms_per_step_windows"]) == 2 and out[mode]["mfu_pct"] is None
    assert out["value"] == pytest.approx(1 / (out["ms_per_step"] / 1e3)) == out["eager"]["img_per_s"]
    assert out["ms_per_step_windows"] == out["eager"]["ms_per_step_windows"]
    assert out["step_gflops"] > 0
    assert (out["device"], out["nvidia_smi"], out["mfu_pct"]) == ("cpu", None, None)
    assert out["host_cores"] >= 1 and len(out["host_load"]) == 3
    assert "kitti_ssl.json" in out["config"] and "disp_reg 0.01" in out["config"]


def test_warp_kernel_bench_on_cpu(capsys):
    GS = warp_kernel_bench.GS
    before = [k.launches for k in GS.KERNELS]
    out = warp_kernel_bench.main(["--device", "cpu", "--n", "2", "--height", "32", "--width", "64", "--iters", "2"])
    printed = _printed(capsys)
    assert printed[:-1] == out["rows"]
    assert [r["method"] for r in out["rows"]] == ["cuda", "plain", "library"]
    for row in out["rows"]:
        _assert_finite(row, ("fwd_ms", "fwd_bwd_ms", "fwd_ms_warm", "fwd_bwd_ms_warm"))
        assert row["fwd_pct_hbm_roofline"] is None and row["fwd_bwd_pct_hbm_roofline"] is None
    assert set(out["rows"][0]["kernel_ms"]) == set(KERNEL_NAMES)
    for times in out["rows"][0]["kernel_ms"].values():
        _assert_finite(times, ("cold", "warm"))
    summary = printed[-1]
    assert summary["shape"] == {"N": 2, "H": 32, "W": 64, "C": 1, "P": 2048}
    assert summary["bytes"] == warp_kernel_bench.kernel_bytes(2, 32, 64, 1)
    assert (summary["device"], summary["nvidia_smi"]) == ("cpu", None)
    # CPU tensors take the plain versions: no kernel was launched
    assert [k.launches for k in GS.KERNELS] == before


def test_warp_kernel_bench_bytes_at_training_shape():
    """fp32 bytes each function must move at N = 32 images of 128×416, one
    point a pixel: uv 13.6 MB, image / out / g / d_img 6.8 MB each."""
    img, uv, val = 32 * 128 * 416, 32 * 53_248 * 2, 32 * 53_248
    b = warp_kernel_bench.kernel_bytes(32, 128, 416, 1)
    assert b["grid_sample_fwd"] == 4 * (img + uv + val) == 27_262_976
    assert b["grid_sample_bwd_uv"] == 4 * (img + uv + val + uv) == 40_894_464
    assert b["grid_sample_bwd_img"] == 4 * (uv + val + img) == 27_262_976
    assert b["fwd"] == b["grid_sample_fwd"]
    assert b["fwd_bwd"] == 4 * (2 * img + 2 * uv + 2 * val) == 54_525_952
    b3 = warp_kernel_bench.kernel_bytes(32, 128, 416, 3)
    assert b3["grid_sample_bwd_img"] == 4 * (uv + 3 * val + 3 * img)
    # the bound K3's row in PERF.md states: 8.1 µs at 3.35 TB/s
    assert b["grid_sample_bwd_img"] / 3.35e12 * 1e6 == pytest.approx(8.138, abs=1e-3)


def test_profile_breakdown_on_cpu(capsys):
    out = profile_breakdown.main(TINY + ["--iters", "1", "--steps-per-call", "2"])
    printed = _printed(capsys)
    names = ["model_fwd", "model_fwd_bwd", "loss_fwd", "loss_fwd_bwd", "adam_only", "full_step", "graph_step"]
    assert [line["block"] for line in printed[:-1]] == names
    for line in printed[:-1]:
        _assert_finite(line, ("ms", "gflops", "tflops_per_s"))
        assert line["bf16_peak_pct"] is None
    blocks = out["blocks"]
    assert blocks["adam_only"]["gflops"] == 0
    assert blocks["model_fwd_bwd"]["gflops"] > blocks["model_fwd"]["gflops"] > 0
    ms = {k: v["ms"] for k, v in blocks.items()}
    derived = printed[-1]["derived"]
    assert derived == pytest.approx({
        "model_bwd_ms": ms["model_fwd_bwd"] - ms["model_fwd"],
        "warp_loss_fwd_ms": ms["loss_fwd"] - ms["model_fwd"],
        "warp_loss_bwd_extra_ms": ms["loss_fwd_bwd"] - ms["model_fwd_bwd"],
        "adam_ms": ms["adam_only"],
        "step_overhead_ms": ms["full_step"] - ms["loss_fwd_bwd"] - ms["adam_only"],
    })
    assert printed[-1]["full_step_idle_share"] is None and printed[-1]["device"] == "cpu"
    assert printed[-1]["graph_step_idle_share"] is None and printed[-1]["graph_window"] is None
    assert printed[-1]["steps_per_call"] == 2
    assert blocks["graph_step"]["gflops"] == blocks["full_step"]["gflops"]


def test_kernel_counts_by_name():
    """The warp kernels counted among device activity names, demangled or
    not; a library's grid sampler is not one of them."""
    names = [
        "void (anonymous namespace)::grid_sample_fwd_kernel<1>(float const*, float const*, float*, int)",
        "_ZN40_GLOBAL__N__grid_sample_cu_66088be2_25grid_sample_bwd_uv_kernelILi1EEEvPKfS2_S2_Pfiiiiii",
        "void (anonymous namespace)::grid_sample_fwd_kernel<3>(float const*, float const*, float*, int)",
        "void at::native::grid_sampler_2d_kernel<float, int>(...)",
    ]
    assert profile_breakdown.kernel_counts(names) == {
        "grid_sample_fwd_kernel": 2, "grid_sample_bwd_uv_kernel": 1, "grid_sample_bwd_img_kernel": 0,
    }


@pytest.mark.parametrize("entry", [
    bench.main, warp_kernel_bench.main, profile_breakdown.main, serving_bench.main, http_serving_bench.main,
    model_block_bench.main, ssl_driving_experiment.main, serving_warmup_check.main,
])
def test_entry_points_refuse_missing_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry([])


def test_busy_union_of_intervals():
    busy = profile_breakdown.busy_us
    assert busy([(0, 2), (1, 3), (5, 6), (5.5, 5.7)], 0, 10) == 4
    assert busy([(-1, 1), (9, 12), (2, 2)], 0, 10) == 2
    assert busy([], 0, 10) == 0


def test_step_timer_matches_jax(monkeypatch):
    """Both timers under the same patched clock: same window, mean and rate."""
    clock = [0.0, 0.5, 0.75, 1.5, 1.625, 3.0]
    results = []
    for module in (jax_profiler, profiler):
        ticks = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timer = module.StepTimer(window=3)
        seen = []
        for _ in clock:
            seen.append((timer.mean_step_s, timer.images_per_sec(4)))
            timer.tick()
        seen.append((timer.mean_step_s, timer.images_per_sec(4), list(timer.times)))
        results.append(seen)
    assert math.isnan(results[1][0][0]) and math.isnan(results[1][1][0])
    assert repr(results[0]) == repr(results[1])
    assert results[1][-1][2] == [0.75, 0.125, 1.375]


def test_time_ms_on_cpu_calls_warmup_then_iters():
    calls = []
    ms = profiler.time_ms(lambda: calls.append(1), torch.device("cpu"), iters=3, warmup=2)
    assert len(calls) == 5 and math.isfinite(ms) and ms >= 0


@pytest.mark.parametrize("flush_l2", [False, True, "dirty"])
def test_time_ms_takes_each_flush_mode(flush_l2):
    """Warm, and the two cold yardsticks: True leaves the L2 clean (a write,
    then a read of a second buffer), "dirty" is the write alone. On the CPU
    there is no L2, and each mode times the calls the same way."""
    calls = []
    ms = profiler.time_ms(lambda: calls.append(1), torch.device("cpu"), iters=2, warmup=1, flush_l2=flush_l2)
    assert len(calls) == 3 and math.isfinite(ms) and ms >= 0


def test_time_ms_refuses_an_unknown_flush_mode():
    with pytest.raises(ValueError):
        profiler.time_ms(lambda: None, torch.device("cpu"), iters=1, flush_l2="warm")


def test_ptxas_report_reads_each_kernel():
    from monodepth2_torch.ops.cuda import _lib

    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__grid_sample_cu_66088be2_22grid_sample_fwd_kernelILi1EEEvPKfS2_Pfiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__grid_sample_cu_66088be2_22grid_sample_fwd_kernelILi1EEEvPKfS2_Pfiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 404 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__grid_sample_cu_66088be2_26grid_sample_bwd_img_kernelEPKfS1_Pfiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__grid_sample_cu_66088be2_26grid_sample_bwd_img_kernelEPKfS1_Pfiiiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 16 bytes smem, 400 bytes cmem[0]
"""
    assert _lib.ptxas_report(text) == {
        "grid_sample_fwd_kernel<1>": dict(
            registers=32, smem_bytes=0, stack_bytes=0, spill_store_bytes=0, spill_load_bytes=0
        ),
        "grid_sample_bwd_img_kernel": dict(
            registers=40, smem_bytes=16, stack_bytes=8, spill_store_bytes=4, spill_load_bytes=4
        ),
    }


def test_kernel_ab_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for device in ("cuda", "cpu"):
        with pytest.raises(RuntimeError):
            kernel_ab.main(["--baseline", "old.cu", "--device", device])


@pytest.mark.parametrize("scattered", [False, True])
def test_make_uv(scattered):
    """The kernel checks' and timings' uv: edge and corner points first, then
    uniform over [-1.2, 1.2]² or the identity ±3 px."""
    n, h, w = 2, 8, 12
    uv = warp_kernel_bench.make_uv(n, h, w, torch.Generator().manual_seed(0), scattered)
    assert uv.shape == (n, h * w, 2) and uv.is_contiguous()
    assert torch.equal(uv[:, 0], torch.tensor([[-1.0, 0.3]] * n)) and torch.equal(uv[:, 5], torch.ones(n, 2))
    rest = uv[:, 14:]
    if scattered:
        assert float(rest.abs().max()) <= 1.2
    else:
        ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        pix = (uv + 1) / 2 * torch.tensor([w - 1.0, h - 1.0])
        shift = pix - torch.stack([xs, ys], -1).reshape(1, h * w, 2)
        assert float(shift[:, 14:].abs().max()) <= 3 + 1e-4
    odd = warp_kernel_bench.make_uv(n, h, w, torch.Generator().manual_seed(0), True, p=37)
    assert odd.shape == (n, 37, 2)


def test_make_uv_near_identity_takes_the_first_points_of_the_raster():
    """With p < h·w points a near-identity warp keeps pixel i's point i (the
    cases with P not a multiple of W); more points than pixels is refused."""
    n, h, w = 2, 8, 12
    uv = warp_kernel_bench.make_uv(n, h, w, torch.Generator().manual_seed(0), False, p=41)
    assert uv.shape == (n, 41, 2) and uv.is_contiguous()
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    pix = (uv + 1) / 2 * torch.tensor([w - 1.0, h - 1.0])
    shift = pix - torch.stack([xs, ys], -1).reshape(1, h * w, 2)[:, :41]
    assert float(shift[:, 14:].abs().max()) <= 3 + 1e-4
    with pytest.raises(ValueError):
        warp_kernel_bench.make_uv(n, h, w, torch.Generator().manual_seed(0), False, p=h * w + 1)


def test_offset_view_is_a_misaligned_copy():
    t = torch.arange(24.0).reshape(2, 4, 3)
    for floats in (1, 2, 3):
        view = warp_kernel_bench.offset_view(t, floats)
        assert torch.equal(view, t) and view.is_contiguous()
        assert view.data_ptr() - view.untyped_storage().data_ptr() == 4 * floats


@pytest.mark.parametrize("case", warp_kernel_bench.BWD_IMG_CASES)
def test_bwd_img_case_builds_what_it_names(case):
    """The K3 cases of the card's tests and chip_smoke.py, at a small image:
    shapes, alignment, and the band heights and corners they are built for."""
    c, h, w = 3, 40, 64
    img, uv, g = warp_kernel_bench.bwd_img_case(case, c, torch.Generator().manual_seed(0), "cpu", h=h, w=w)
    n, p = uv.shape[:2]
    assert img.shape == (n, *((20, 30) if case == "odd P" else (h, w)), c)
    assert g.shape == (n, p, c) and uv.shape == (n, p, 2)
    assert uv.is_contiguous() and g.is_contiguous()
    expected_p = {"odd P": 599, "P not a multiple of W": h * w - 37, "views one float in": h * w - 3}
    assert p == expected_p.get(case, h * w)
    if case == "views one point in":
        assert uv.data_ptr() % 16 == 8 and g.data_ptr() % 16 == 12
    elif case == "views one float in":
        assert uv.data_ptr() % 8 == 4 and g.data_ptr() % 8 == 4
    else:
        assert uv.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    if case == "band heights":
        # image i's every 512th point sits i rows (clamped) below its pixel
        rows = (uv[:, ::512, 1] + 1) / 2 * (h - 1) - (torch.arange(0, p, 512) // w).float()
        assert float(rows[0].abs().max()) <= 3 + 1e-4
        assert float(rows[5].min()) >= 5 - 3 - 1e-4
    if case == "corners":
        assert bool((uv.abs() == 2).all())
    if case == "exact identity":
        pix = (uv + 1) / 2 * torch.tensor([w - 1.0, h - 1.0])
        assert float((pix - pix.round()).abs().max()) < 1e-4
    with pytest.raises(ValueError):
        warp_kernel_bench.bwd_img_case("no such case", c, torch.Generator(), "cpu")


def test_kernel_ab_bounds_and_shares():
    """K3's two bounds at the main-path shape (PERF.md's 8.14 / 10.17 µs at
    C = 1, 16.28 / 22.38 µs at C = 3), and each share in the summary as the
    bound over the mean clean time of the version's turns."""
    b1, b3 = kernel_ab.bounds_us(32, 128, 416, 1), kernel_ab.bounds_us(32, 128, 416, 3)
    k3 = kernel_ab.K3
    assert b1[k3] == pytest.approx(8.138, abs=1e-3) and b1[f"{k3}_with_fill"] == pytest.approx(10.173, abs=1e-3)
    assert b3[k3] == pytest.approx(16.276, abs=1e-3) and b3[f"{k3}_with_fill"] == pytest.approx(22.380, abs=1e-3)
    assert b1["grid_sample_bwd_uv"] == pytest.approx(12.207, abs=1e-3)

    def times(ms):  # clean ms; dirty 1 µs more, warm half
        return {"clean": ms, "dirty": ms + 0.001, "warm": ms / 2}

    turns = []
    for version, ms in (("old", 0.040), ("new", 0.020), ("new", 0.030), ("old", 0.060)):
        turn = {"C": 1, "version": version}
        for k in kernel_ab.KERNELS:
            if k == k3:
                turn[k] = {kind: times(ms) for kind in kernel_ab.UV_KINDS}
                turn[f"library_{k}"] = {kind: times(0.080) for kind in kernel_ab.UV_KINDS}
            else:
                turn[k], turn[f"library_{k}"] = times(ms), times(0.080)
        turns.append(turn)
    summary = kernel_ab.summarize(1, turns, ["old", "new"], b1, "card, 700.00 W")
    assert summary[f"{k3}_bound_us"] == b1[k3] and summary[f"{k3}_bound_with_fill_us"] == b1[f"{k3}_with_fill"]
    for kind in kernel_ab.UV_KINDS:
        tag = f"{k3}_{kind}"
        assert summary[f"{tag}_new_clean_us"] == pytest.approx([20.0, 30.0])
        assert summary[f"{tag}_old_warm_us"] == pytest.approx([20.0, 30.0])
        assert summary[f"{tag}_library_dirty_us"] == pytest.approx([81.0] * 4)
        assert summary[f"{tag}_new_clean_share_of_bound"] == pytest.approx(b1[k3] / 25.0)
        assert summary[f"{tag}_old_clean_share_of_bound_with_fill"] == pytest.approx(b1[f"{k3}_with_fill"] / 50.0)
        assert summary[f"{tag}_library_clean_share_of_bound"] == pytest.approx(b1[k3] / 80.0)
    assert summary["grid_sample_fwd_new_clean_share_of_bound"] == pytest.approx(b1["grid_sample_fwd"] / 25.0)
    assert "grid_sample_fwd_bound_with_fill_us" not in summary


def test_bwd_img_smem_bytes_reads_the_source_or_none():
    from types import SimpleNamespace

    from monodepth2_torch.ops.cuda import _lib

    assert _lib.bwd_img_smem_bytes(SimpleNamespace(), 128, 416, 3) is None
    lib = SimpleNamespace(grid_sample_bwd_img_smem_bytes=lambda h, w, c: 4 * h * w * c)
    assert _lib.bwd_img_smem_bytes(lib, 2, 3, 1) == 24


@pytest.mark.parametrize("name", sorted(k3_sweep.VARIANTS))
def test_k3_sweep_variant_edits_the_current_source(name):
    """Each variant's edits match the current grid_sample.cu once and change
    it; an edit that no longer matches raises rather than timing the current
    kernel under the variant's name."""
    from monodepth2_torch.ops.cuda import _lib

    source = _lib.SOURCE.read_text()
    changed = k3_sweep.variant_source(name, source)
    assert changed != source
    with pytest.raises(ValueError):
        k3_sweep.variant_source(name, source.replace("constexpr int k", "constexpr int q").replace("  ", " "))


def test_k3_sweep_needs_a_card():
    assert set(k3_sweep.PROBES) <= set(k3_sweep.VARIANTS)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for device in ("cuda", "cpu"):
        with pytest.raises(RuntimeError):
            k3_sweep.main(["--device", device])


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiler.trace(str(tmp_path)) as prof:
        torch.ones(4) + 1
    assert any(e.name == "aten::add" for e in prof.events())
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::add" for e in events)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            with profiler.trace(host=False):
                pass


SMALL = ["--device", "cpu", "--width", "64", "--height", "32"]


def test_serving_bench_on_cpu(capsys):
    """Live and artifact, fp32 and bf16, each batch, both I/O modes."""
    out = serving_bench.main(SMALL + ["--batches", "1,3", "--iters", "1"])
    printed = _printed(capsys)
    assert printed[:-1] == out["rows"]
    assert [(r["variant"], r["io"], r["batch"]) for r in out["rows"]] == [
        (f"{kind}_{tag}", io, b) for tag in ("fp32", "bf16") for kind in ("live", "artifact")
        for b in (1, 3) for io in ("device", "host")
    ]
    for row in out["rows"]:
        _assert_finite(row, ("ms_per_batch", "img_per_s"))
        assert row["img_per_s"] == pytest.approx(row["batch"] / row["ms_per_batch"] * 1e3)
    assert out["artifact_bytes"]["bf16"] < out["artifact_bytes"]["fp32"]
    assert (out["device"], out["nvidia_smi"]) == ("cpu", None)


def test_http_serving_bench_on_cpu(capsys):
    out = http_serving_bench.main(SMALL + ["--concurrency", "1,4", "--requests", "8", "--buckets", "1,4",
                                           "--fields", "disparity", "--input-dtype", "uint8"])
    printed = _printed(capsys)
    assert printed[:-1] == out["levels"]
    assert [lv["concurrency"] for lv in out["levels"]] == [1, 4]
    for lv in out["levels"]:
        _assert_finite(lv, ("img_per_s", "ms_per_request", "p50_ms", "p95_ms", "rows_per_device_call"))
        assert 1 <= lv["device_batches"] <= 8 and lv["fields"] == "disparity" and lv["input_dtype"] == "uint8"
    assert out["levels"][0]["device_batches"] == 8  # one client: one call a request
    assert (out["device"], out["nvidia_smi"]) == ("cpu", None)


def test_serving_warmup_check_on_cpu(capsys):
    """Each cuDNN benchmark setting × warm-up place × pass × level, with the
    device calls that served it, timed by worker and bucket."""
    out = serving_warmup_check.main(SMALL + ["--concurrency", "1,2", "--requests", "4"])
    assert _printed(capsys)[:-1] == out["rows"]
    assert [(r["cudnn_benchmark"], r["warmup"], r["pass_"], r["concurrency"]) for r in out["rows"]] == [
        (bench, warm, p, c) for bench in (True, False) for warm in ("caller", "workers") for p in "AB" for c in (1, 2)
    ]
    for r in out["rows"]:
        _assert_finite(r, ("img_per_s", "p50_ms", "p95_ms", "max_ms"))
        assert 1 <= r["device_calls"] == r["device_batches"] <= 4
        assert all(b in (1, 4, 16, 64) and w.startswith("bucket-batcher-") for _, w, b in r["slowest_calls"])
    assert torch.backends.cudnn.benchmark is False  # restored


def test_model_block_bench_on_cpu(capsys):
    out = model_block_bench.main(SMALL + ["--batch", "2", "--infer-batch", "2", "--iters", "1"])
    assert _printed(capsys) == [out["blocks"], out["inference"]]
    assert set(out["blocks"]["ms"]) == {"encoder_fwd", "depth_decoder_fwd", "pose_decoder_fwd",
                                        "depth_decoder_fwd_zeropad"}
    _assert_finite(out["blocks"]["ms"], out["blocks"]["ms"])
    _assert_finite(out["inference"], ("ms_per_batch", "img_per_s"))
    assert out["inference"]["device"] == "cpu"


def test_zero_padded_changes_only_the_padding():
    from monodepth2_torch.models import Model
    from monodepth2_torch.nn.core import Conv

    decoder = Model.create(device="cpu").depth_decoder
    zero = model_block_bench.zero_padded(decoder)
    pads = [(a.padding, b.padding) for a, b in zip(decoder.modules(), zero.modules()) if isinstance(a, Conv)]
    assert any(a == "reflect" for a, _ in pads)
    assert all(b == (1 if a == "reflect" else a) for a, b in pads)  # 3×3 convs: pad 1
    for a, b in zip(decoder.state_dict().values(), zero.state_dict().values()):
        assert torch.equal(a, b)


def test_ssl_driving_experiment_on_cpu_resumes(tmp_path, capsys):
    """4 steps with a val row every 2, then a run to 6 that resumes from the
    newest checkpoint and appends its row; the newest two checkpoints kept."""
    args = SMALL + ["--n-scenes", "8", "--n-val", "2", "--eval-every", "2",
                    "--min-depth", "1", "--max-depth", "80", "--disp-reg", "0.01", "--disp-reg-steps", "4",
                    "--out", str(tmp_path)]
    out = ssl_driving_experiment.main(args + ["--steps", "4"])
    assert out["resumed_at"] == 0 and out["step"] == 4
    assert [r["step"] for r in out["history"]] == [2, 4]
    for r in out["history"]:
        _assert_finite(r, ("loss", "mean_disparity", "val_abs_rel", "val_a1", "val_rmse", "rot_err_deg"))
        assert 0 < r["mean_disparity"] < 1 and r["loss_step"] == r["step"]
    _assert_finite(out["baseline"], ("abs_rel", "a1", "rmse"))
    again = ssl_driving_experiment.main(args + ["--steps", "6"])
    assert again["resumed_at"] == 4 and [r["step"] for r in again["history"]] == [2, 4, 6]
    assert again["history"][:2] == out["history"]
    with open(tmp_path / "history.json") as f:
        assert json.load(f) == again["history"]
    assert sorted(p.name for p in (tmp_path / "ckpts").glob("*.npz")) == ["ckpt-4.npz", "ckpt-6.npz"]
    assert "resuming from" in capsys.readouterr().out
