"""monodepth2_torch.data (copied datasets, the loader, the pinned device
prefetch) and utils.viz against the JAX package's: the same numpy batches
on tests/test_data.py's KITTI and Depth10k fixture trees, the synthetic
datasets, DChain with per-item K and FlipX, bitwise. Both packages'
datasets decode through PIL here (use_native=False); the native decoder is
held in tests/test_torch_native.py."""

import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import monodepth2_tpu.data as J
import monodepth2_torch.data as T
from monodepth2_tpu.data.augment import resize_bilinear as j_resize
from monodepth2_tpu.data.loader import accepts_rng as j_accepts_rng
from monodepth2_tpu.data.synthetic import SyntheticGroundPlane as JGroundPlane
from monodepth2_tpu.utils import viz as jviz
from monodepth2_torch.utils import viz as tviz
from test_data import dtk_root, kitti_root  # noqa: F401  (fixtures: the same trees)


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [(48, 24), (64, 32)])
@pytest.mark.parametrize("cache", [False, True])
def test_kitti_matches_jax(kitti_root, size, cache):  # noqa: F811
    t = T.KittiDataset(kitti_root, "00", target_size=size, use_native=False, cache_decoded=cache)
    j = J.KittiDataset(kitti_root, "00", target_size=size, use_native=False, cache_decoded=cache)
    assert len(t) == len(j) == 3
    np.testing.assert_array_equal(t.K, j.K)
    assert (t.target_id, tuple(t.source_ids)) == (j.target_id, tuple(j.source_ids))
    for i in range(len(t)):
        _equal(t[i], j[i])
        _equal(t[i], j[i])  # the second read, from the cache where there is one


@pytest.mark.parametrize("kw", [dict(), dict(grayscale=True), dict(target_size=(640, 192)), dict(cache_decoded=True)])
def test_depth10k_matches_jax(dtk_root, kw):  # noqa: F811
    root, files = dtk_root
    t, j = T.Depth10k(root, files, use_native=False, **kw), J.Depth10k(root, files, use_native=False, **kw)
    np.testing.assert_array_equal(t.K, j.K)
    for i in range(len(t)):
        _equal(t[i], j[i])


def test_find_static_matches_jax(dtk_root):  # noqa: F811
    root, files = dtk_root
    t = T.Depth10k(root, files, grayscale=True, use_native=False)
    j = J.Depth10k(root, files, grayscale=True, use_native=False)
    for alpha in (0.001, 0.03, 10.0):
        assert T.find_static(t, alpha, batch_size=2, device="cpu") == J.find_static(j, alpha, batch_size=2)


def test_synthetic_matches_jax():
    pairs = [
        (T.SyntheticTriplets(n=3, target_size=(32, 16)), J.SyntheticTriplets(n=3, target_size=(32, 16))),
        (T.SyntheticGroundPlane(n=2, target_size=(48, 32), tx=0.15), JGroundPlane(n=2, target_size=(48, 32), tx=0.15)),
        (T.SyntheticDriving(n=2, target_size=(64, 32), seed=3), J.SyntheticDriving(n=2, target_size=(64, 32), seed=3)),
    ]
    for t, j in pairs:
        np.testing.assert_array_equal(t.K, j.K)
        for i in range(len(t)):
            _equal(t[i], j[i])
    t, j = pairs[2]
    _equal(t.gt_depth_for(1), j.gt_depth_for(1))
    for (Rt, tt), (Rj, tj) in zip(t.gt_poses_for(1), j.gt_poses_for(1)):
        _equal(Rt, Rj)
        _equal(tt, tj)


def _chains():
    """Two SyntheticDriving children with different cameras, each side."""
    kw = [dict(n=3, target_size=(64, 32), seed=s, focal_scale=f) for s, f in ((0, 1.0), (1, 1.3))]
    return T.DChain([T.SyntheticDriving(**k) for k in kw]), J.DChain([J.SyntheticDriving(**k) for k in kw])


def test_dchain_per_item_K_matches_jax():
    t, j = _chains()
    assert len(t) == len(j) == 6
    assert t.heterogeneous_K and j.heterogeneous_K
    assert T.resolves_item_K(t) and t.supports_item_K
    for i in range(len(t)):
        _equal(t.K_of(i), j.K_of(i))
        _equal(t[i], j[i])
    with pytest.raises(IndexError):
        t[6]


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_matches_jax(kitti_root, workers):  # noqa: F811
    """Two shuffled epochs with FlipX (randomness keyed per seed, epoch and
    item) give the JAX loader's batches, whatever the worker count."""
    t = T.DataLoader(T.KittiDataset(kitti_root, "00", target_size=(48, 32), augmentations=T.FlipX(0.5),
                                    use_native=False),
                     batch_size=2, seed=7, num_workers=workers)
    j = J.DataLoader(J.KittiDataset(kitti_root, "00", target_size=(48, 32), augmentations=J.FlipX(0.5),
                                    use_native=False), batch_size=2, seed=7, num_workers=1)
    assert len(t) == len(j) == 1
    for _ in range(2):
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb) == 1
        _equal(tb[0], jb[0])


def test_loader_with_K_matches_jax():
    t, j = _chains()
    tl = T.DataLoader(t, batch_size=2, seed=3, with_K=True)
    jl = J.DataLoader(j, batch_size=2, seed=3, with_K=True)
    for _ in range(2):
        for tb, jb in zip(tl, jl):
            assert tb["frames"].shape == (2, 3, 32, 64, 1) and tb["K"].shape == (2, 3, 3)
            _equal(tb, jb)
    with pytest.raises(ValueError, match="with_K"):
        T.DataLoader(T.DChain([T.SyntheticDriving(n=2, target_size=(64, 32)), [np.zeros((3, 32, 64, 1))]]),
                     batch_size=2, with_K=True)


def test_loader_shuffle_per_epoch_and_skip_next():
    ds = T.SyntheticTriplets(n=8, target_size=(16, 8))
    jds = J.SyntheticTriplets(n=8, target_size=(16, 8))
    t, j = T.DataLoader(ds, batch_size=2, seed=0), J.DataLoader(jds, batch_size=2, seed=0)
    e1, e2 = list(t), list(t)
    assert not np.allclose(np.stack(e1), np.stack(e2))  # another epoch, another order
    for a, b in zip(e1 + e2, list(j) + list(j)):
        _equal(a, b)
    # a resume at batch 3 of epoch 2 sees the rest of that epoch's order
    t2, j2 = T.DataLoader(ds, batch_size=2, seed=0), J.DataLoader(jds, batch_size=2, seed=0)
    t2.epoch, t2.skip_next, j2.epoch, j2.skip_next = 1, 3, 1, 3
    rest, jrest = list(t2), list(j2)
    assert len(rest) == 1
    _equal(rest[0], e2[3])
    _equal(rest[0], jrest[0])
    assert t2.skip_next == 0 and len(list(t2)) == 4  # one-shot


def test_loader_abandoned_iterator_no_thread_leak():
    ds = [np.zeros((3, 8, 8, 1), np.float32)] * 64
    dl = T.DataLoader(ds, batch_size=2, shuffle=False, prefetch=1, num_workers=1)
    before = threading.active_count()
    it = iter(dl)
    next(it)
    it.close()
    deadline = time.time() + 10.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer thread leaked"


def test_loader_propagates_dataset_errors():
    class Buggy:
        def __len__(self):
            return 4

        def __getitem__(self, i, rng):
            raise TypeError("genuine dataset bug")

    with pytest.raises(TypeError, match="genuine dataset bug"):
        next(iter(T.DataLoader(Buggy(), batch_size=2, shuffle=False, num_workers=1)))


def test_accepts_rng_matches_jax():
    class OneArg:
        def __getitem__(self, i):
            return i

    class TwoArg:
        def __getitem__(self, i, rng):
            return i

    class KwOnlyRng:
        def __getitem__(self, i, *, rng=None):
            return i

    for ds in (OneArg(), TwoArg(), KwOnlyRng(), [1, 2], T.SyntheticDriving(n=1)):
        assert T.accepts_rng(ds) == j_accepts_rng(ds)


def test_flipx_and_resize_match_jax():
    rng = np.random.default_rng(2)
    frames = [rng.uniform(size=(8, 12, 1)).astype(np.float32) for _ in range(3)]
    for p in (0.0, 1.0, 0.5):
        _equal(T.FlipX(p)(frames, np.random.default_rng(5)), J.FlipX(p)(frames, np.random.default_rng(5)))
    img = rng.uniform(size=(16, 52, 3)).astype(np.float32)
    _equal(T.resize_bilinear(img, 640, 192), j_resize(img, 640, 192))


def test_device_prefetch_on_cpu():
    """On the CPU the batches become tensors that share the arrays' memory,
    arrays and {"frames", "K"} dicts alike, in order, with no thread."""
    batches = [np.full((2, 3), i, np.float32) for i in range(3)]
    threads = threading.active_count()
    out = list(T.device_prefetch(iter(batches), size=2, device="cpu"))
    assert threading.active_count() == threads
    assert [int(b[0, 0]) for b in out] == [0, 1, 2]
    assert all(isinstance(b, torch.Tensor) and b.dtype == torch.float32 for b in out)
    assert np.shares_memory(out[1].numpy(), batches[1])
    d = next(T.device_prefetch(iter([{"frames": np.ones((1, 2), np.float64), "K": np.eye(3)}]), device="cpu"))
    assert d["frames"].dtype == torch.float32 and d["K"].shape == (3, 3)
    with pytest.raises(RuntimeError if not torch.cuda.is_available() else StopIteration):
        next(T.device_prefetch(iter([]), device="cuda"))


def test_placement_prefetch_keeps_size_ahead():
    placed = []

    def put(b):
        placed.append(b)
        return b * 10

    it = T.placement_prefetch(iter([1, 2, 3, 4]), put, size=2)
    assert placed == []
    assert next(it) == 10 and placed == [1, 2, 3]
    assert list(it) == [20, 30, 40]


@pytest.mark.parametrize("shape", [(24, 40), (24, 40, 1), (24, 40, 3)])
def test_viz_pngs_decode_as_the_jax_packages(tmp_path, shape):
    """The port's PNGs decode to the pixels and mode of the JAX package's."""
    img = np.random.default_rng(0).uniform(-0.1, 1.1, size=shape).astype(np.float32)
    if shape[-1] == 3:
        tviz.save_warped(img, tmp_path / "t.png")
        jviz.save_warped(img, tmp_path / "j.png")
    else:
        tviz.save_disparity(img, tmp_path / "t.png")
        jviz.save_disparity(img, tmp_path / "j.png")
    a, b = Image.open(tmp_path / "t.png"), Image.open(tmp_path / "j.png")
    assert a.mode == b.mode
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    one = img.reshape(24, 40, -1)[..., :1]
    gray = np.clip(one[..., 0] * 255.0, 0, 255).astype(np.uint8)
    tviz.save_warped(one, tmp_path / "g.png")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "g.png")), gray)
