"""monodepth2_torch.data.native: the port's build and binding of
native/mdloader.cpp, against PIL at tests/test_native_loader.py's
tolerances, and the port's KITTI items against the JAX package's native
items, bitwise; the build's atomicity (six processes building into one empty
directory at once all load a whole library) and its reported failures.

The decode tests need the library: they skip, with the compiler's error,
where it does not build. Whether the JAX package's library loads is asked
in a test's body, never at collection."""

import json
import os
import subprocess
import sys
import textwrap
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from monodepth2_torch.data import Depth10k, KittiDataset, native

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip(f"the native decoder does not build here: {native.build_error()}")
    return native


@pytest.fixture(scope="module")
def png_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    arr = (np.random.default_rng(0).uniform(size=(64, 96, 3)) * 255).astype(np.uint8)
    p = str(d / "test.png")
    Image.fromarray(arr, "RGB").save(p)
    return p, arr


def _kitti_tree(root: Path, n_frames: int = 6, size=(64, 32)) -> str:
    img_dir = root / "sequences" / "00" / "image_0"
    img_dir.mkdir(parents=True)
    (root / "sequences" / "00" / "calib.txt").write_text(
        "P0: 700.0 0.0 32.0 0.0 0.0 700.0 16.0 0.0 0.0 0.0 1.0 0.0\n"
    )
    rng = np.random.default_rng(3)
    for i in range(n_frames):
        arr = (rng.uniform(size=(size[1], size[0])) * 255).astype(np.uint8)
        Image.fromarray(arr, "L").save(img_dir / f"{i:06d}.png")
    return str(root)


def test_decode_rgb_identity_size(lib, png_file):
    p, arr = png_file
    np.testing.assert_allclose(lib.load_resize(p, 96, 64, 3), arr.astype(np.float32) / 255.0, atol=1e-6)


def test_decode_grayscale_matches_pil(lib, png_file):
    p, _ = png_file
    out = lib.load_resize(p, 96, 64, 1)
    pil = np.asarray(Image.open(p).convert("L"), np.float32) / 255.0
    # ITU-R 601 luma: PIL rounds to uint8, native keeps float
    np.testing.assert_allclose(out[..., 0], pil, atol=1.5 / 255)


def test_resize_matches_pil(lib, png_file):
    p, _ = png_file
    out = lib.load_resize(p, 48, 32, 3)
    pil = np.asarray(Image.open(p).resize((48, 32), Image.BILINEAR), np.float32) / 255.0
    # PIL: half-pixel centers and uint8 rounding; native: align-corners float
    assert np.mean(np.abs(out - pil)) < 3.0 / 255


def test_strip_loader(lib, tmp_path):
    strip = (np.random.default_rng(1).uniform(size=(128, 1248, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "strip.png")
    Image.fromarray(strip, "RGB").save(p)
    out = lib.load_strip(p, 416, 128, 3, 3)
    assert out.shape == (3, 128, 416, 3)
    np.testing.assert_allclose(out[1], strip[:, 416:832].astype(np.float32) / 255.0, atol=1e-6)
    with pytest.raises(IOError, match="strip height"):
        lib.load_strip(p, 416, 64, 3, 3)


def test_triplet_batch(lib, tmp_path):
    rng = np.random.default_rng(2)
    paths = []
    for i in range(6):
        p = str(tmp_path / f"{i}.png")
        Image.fromarray((rng.uniform(size=(32, 48)) * 255).astype(np.uint8), "L").save(p)
        paths.append(p)
    out = lib.load_triplet_batch(paths, 48, 32, 1, n_threads=2)
    assert out.shape == (2, 3, 32, 48, 1)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(out[i // 3, i % 3], lib.load_resize(p, 48, 32, 1))


def test_decode_failure_reported(lib, tmp_path):
    """Missing and damaged files raise IOError. The damaged ones never reach
    the library, which would end the process on them (libjpeg's error
    handler, after libpng fails)."""
    with pytest.raises(IOError, match="3 frames failed"):
        lib.load_triplet_batch([str(tmp_path / "missing.png")] * 3, 8, 8, 1)
    good = tmp_path / "good.png"
    Image.fromarray((np.random.default_rng(6).uniform(size=(16, 16)) * 255).astype(np.uint8), "L").save(good)
    data = good.read_bytes()
    (tmp_path / "truncated.png").write_bytes(data[:-20])
    flipped = bytearray(data)
    flipped[data.index(b"IDAT") + 10] ^= 0xFF
    (tmp_path / "flipped.png").write_bytes(bytes(flipped))
    (tmp_path / "text.png").write_text("not an image")
    for name in ("truncated.png", "flipped.png", "text.png", "missing.png"):
        with pytest.raises(IOError, match="native decode failed"):
            lib.load_resize(str(tmp_path / name), 8, 8, 1)
        with pytest.raises(IOError, match="native strip decode failed|native decode failed"):
            lib.load_strip(str(tmp_path / name), 4, 16, 3, 1)
    with pytest.raises(IOError, match="1 frames failed"):
        lib.load_triplet_batch([str(good), str(tmp_path / "truncated.png"), str(good)], 8, 8, 1)
    assert lib.load_resize(str(good), 8, 8, 1).shape == (8, 8, 1)


def test_datasets_use_native_and_say_so(lib, tmp_path):
    root = _kitti_tree(tmp_path / "kitti")
    ds_native = KittiDataset(root, "00", target_size=(48, 24), use_native=True)
    ds_pil = KittiDataset(root, "00", target_size=(48, 24), use_native=False)
    assert (ds_native.decoder, ds_pil.decoder) == ("native", "pil")
    a, b = ds_native[0], ds_pil[0]
    assert a.shape == b.shape == (3, 24, 48, 1)
    assert np.mean(np.abs(a - b)) < 3.0 / 255
    strip = (np.random.default_rng(4).uniform(size=(128, 1248, 3)) * 255).astype(np.uint8)
    Image.fromarray(strip, "RGB").save(tmp_path / "s.png")
    d_native, d_pil = (Depth10k(str(tmp_path), ["s.png"], use_native=u) for u in (True, False))
    assert (d_native.decoder, d_pil.decoder) == ("native", "pil")
    np.testing.assert_allclose(d_native[0], d_pil[0], atol=1e-6)


def test_kitti_items_equal_the_jax_packages_native_items(lib, tmp_path):
    from monodepth2_tpu.data import KittiDataset as JKitti
    from monodepth2_tpu.data import native as jnative

    if not jnative.available():  # asked here, not at collection
        pytest.skip("the JAX package's native library does not load")
    root = _kitti_tree(tmp_path / "kitti", n_frames=9, size=(97, 41))
    for size, cache in (((48, 24), False), ((64, 32), True)):
        t = KittiDataset(root, "00", target_size=size, use_native=True, cache_decoded=cache)
        j = JKitti(root, "00", target_size=size, use_native=True, cache_decoded=cache)
        assert t.decoder == "native" and j._native is not None
        for i in range(len(t)):
            np.testing.assert_array_equal(t[i], j[i])


_BUILDER = """
import json, sys, time
from pathlib import Path
from monodepth2_torch.data import native
native.BUILD_DIR = Path(sys.argv[1])
start = float(sys.argv[2])
while time.time() < start:
    time.sleep(0.001)
ok = native.available()
out = native.load_resize(sys.argv[3], 16, 8, 1) if ok else None
print(json.dumps({"ok": ok, "error": native.build_error(),
                  "library": str(native.library_path()), "sum": None if out is None else float(out.sum())}))
"""


def test_six_processes_build_into_an_empty_directory_at_once(lib, tmp_path):
    """Six importers start the build at the same moment into an empty
    directory: one compiles under the lock, the others wait and load the
    finished library; every one decodes, and nothing half-written is left."""
    build_dir = tmp_path / "_build"
    img = tmp_path / "x.png"
    Image.fromarray((np.random.default_rng(5).uniform(size=(8, 16)) * 255).astype(np.uint8), "L").save(img)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    start = time.time() + 2.0
    procs = [
        subprocess.Popen([sys.executable, "-c", textwrap.dedent(_BUILDER), str(build_dir), str(start), str(img)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert all(r["ok"] for r in results), [r["error"] for r in results]
    assert len({r["library"] for r in results}) == 1 and len({r["sum"] for r in results}) == 1
    assert sorted(f.name for f in build_dir.iterdir()) == [".lock", Path(results[0]["library"]).name]
    want = lib.load_resize(str(img), 16, 8, 1).sum()
    assert results[0]["sum"] == float(want)


@pytest.fixture
def isolated_native(monkeypatch, tmp_path):
    """The module's state for one test: its build directory in tmp_path and
    no library loaded; restored afterwards."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.reset()
    yield native
    native.reset()


def test_build_error_on_a_compiler_failure(isolated_native, tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("#include <no_such_header_for_this_test.h>\nint x;\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    assert not native.available()
    err = native.build_error()
    assert "no_such_header_for_this_test.h" in err and str(broken) in err
    with pytest.raises(RuntimeError, match="no_such_header_for_this_test.h"):
        native.load_resize("x.png", 8, 8, 1)
    # the failure is kept (no second compile) and leaves no file behind
    assert not native.available()
    assert [f.name for f in (tmp_path / "_build").iterdir()] == [".lock"]
    # a dataset that asked for the native decoder says it uses PIL, and warns
    root = _kitti_tree(tmp_path / "kitti")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ds = KittiDataset(root, "00", target_size=(48, 24), use_native=True)
    assert ds.decoder == "pil" and ds[0].shape == (3, 24, 48, 1)
    assert any("no_such_header_for_this_test.h" in str(w.message) for w in caught)
    # no compiler at all is reported the same way
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    native.reset()
    assert not native.available() and "no-such-compiler" in native.build_error()


def test_reset_rebuilds_after_a_repaired_failure(isolated_native, tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native.available()
    monkeypatch.delenv("CXX")
    assert not native.available()  # kept until reset
    native.reset()
    assert native.available() and native.build_error() is None
