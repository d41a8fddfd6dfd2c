"""monodepth2_torch.simple_depth against the JAX fit and the committed golden.

The golden (tests/golden/simple_depth_golden.npz, 96×32, 500 iterations) was
written by tools/simple_depth_torch_oracle.py, an independent PyTorch loop;
it is held with the tolerances of tests/test_simple_depth_golden.py. The JAX
fit is compared over 20 iterations from the same frames with the same
tolerances: iteration-1 loss 1e-5 rel (forward math), the trajectory 2e-2 rel,
the mean fitted disparity 5e-3 abs. The start has t = 0, where the warp does
not depend on depth: the disparity gradient of the first step is rounding
noise, which Adam scales to ±lr a pixel, so the trajectories part at the
1e-3 level from the second iteration on.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from monodepth2_tpu.simple_depth import fit_simple_depth as j_fit
from monodepth2_torch.simple_depth import fit_simple_depth

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "simple_depth_golden.npz")


def test_matches_jax_fit():
    g = np.load(GOLDEN)
    frames = g["frames"].astype(np.float32)
    ref = j_fit(jnp.asarray(frames), g["K"], n_iters=20, log_every=1)
    got = fit_simple_depth(frames, g["K"], n_iters=20, log_every=1, device="cpu")
    j_loss = np.asarray([l for _, l in ref["history"]])
    t_loss = np.asarray([l for _, l in got["history"]])
    np.testing.assert_allclose(t_loss[0], j_loss[0], rtol=1e-5)
    np.testing.assert_allclose(t_loss, j_loss, rtol=2e-2)
    mean_diff = abs(float(got["disparity"].mean()) - float(np.asarray(ref["disparity"]).mean()))
    assert mean_diff < 5e-3, mean_diff


def test_matches_torch_golden():
    g = np.load(GOLDEN)
    res = fit_simple_depth(g["frames"], g["K"], n_iters=int(g["iters"][-1]), log_every=5, device="cpu")
    hist = dict(res["history"])
    losses = np.asarray([hist[int(i)] for i in g["iters"]])
    rel = np.abs(losses - g["losses"]) / np.abs(g["losses"])
    assert rel[0] < 1e-5, (losses[0], g["losses"][0])
    assert rel.max() < 0.02, rel.max()
    assert rel[-1] < 0.01, rel[-1]
    mean_diff = abs(float(res["disparity"].mean()) - float(g["final_disparity"].mean()))
    assert mean_diff < 5e-3, mean_diff
