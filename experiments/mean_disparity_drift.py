"""The mean disparity of the JAX package's training and the port's, step by
step, from the same weights on the same batches, on the CPU.

    python experiments/mean_disparity_drift.py --steps 300 --out runs/mean_disparity_drift

Recipe C (depth 1-80, disp_reg 0.01 over a disp_reg_steps cut in proportion
to the run: 2,500 of 6,000 steps), ResNet-18, gray, batch 4, Adam 1e-4, at
64×32 (or --width/--height), in float32 and then with the network in
bfloat16 (and, with --dtypes float64, all in float64: there rounding
cannot part the two runs within a few hundred steps, so what parts them
is a difference of semantics). Both packages start from the JAX package's initial weights (the
port's through bridge.params_from_jax) and take the same batches of
SyntheticDriving scenes (seed 0), drawn in one shuffled order per epoch.
Each step's loss and mean disparity (the mean of the training forward's
finest-scale disparity, `aux["disparity"]`, in both) go to
<out>/curves.json. A check of the port against the reference over a few
hundred steps, which the tests (3 steps) do not reach; it imports jax, so
it is not part of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--n-scenes", type=int, default=256)
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--out", default="runs/mean_disparity_drift")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", "float64" in args.dtypes.split(","))
    import jax.numpy as jnp
    import torch

    from monodepth2_torch.bridge import params_from_jax
    from monodepth2_torch.models import Model
    from monodepth2_torch.training import TrainConfig, TrainContext, create_train_state, make_train_step
    from monodepth2_tpu.data import SyntheticDriving
    from monodepth2_tpu.models import Model as JModel
    from monodepth2_tpu.training import TrainConfig as JConfig
    from monodepth2_tpu.training import TrainContext as JContext
    from monodepth2_tpu.training import create_train_state as j_create_train_state
    from monodepth2_tpu.training import make_train_step as j_make_train_step

    size = (args.width, args.height)
    ds = SyntheticDriving(n=args.n_scenes, target_size=size, seed=0)
    items = np.stack([ds[i] for i in range(len(ds))]).astype(np.float32)
    batch_size = 4
    per_epoch = len(ds) // batch_size
    order = np.concatenate([np.random.default_rng(42 + e).permutation(len(ds))[: per_epoch * batch_size]
                            for e in range(-(-args.steps // per_epoch))])
    batches = [items[order[i * batch_size:(i + 1) * batch_size]] for i in range(args.steps)]
    out = {"config": vars(args), "curves": {}}
    os.makedirs(args.out, exist_ok=True)
    for dtype in args.dtypes.split(","):
        # float64: the network in the params' dtype ("float32" compute casts
        # nothing), params, statistics, Adam and the geometry in float64
        wide = dtype == "float64"
        kw = dict(target_size=size, batch_size=batch_size, lr=1e-4, seed=42, min_depth=1.0, max_depth=80.0,
                  disp_reg=0.01, disp_reg_steps=round(2500 * args.steps / 6000),
                  compute_dtype="float32" if wide else dtype)
        jdt, tdt = (jnp.float64, torch.float64) if wide else (jnp.float32, torch.float32)
        jm = JModel.create(depth=18, in_channels=1)
        jstate, tx = j_create_train_state(jm, JConfig(**kw))
        init = (jax.device_get(jstate.params), jax.device_get(jstate.stats))
        cast = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), t)  # noqa: E731
        jstate = jstate._replace(params=cast(jstate.params), stats=cast(jstate.stats),
                                 opt_state=tx.init(cast(jstate.params)))
        jstep = jax.jit(j_make_train_step(jm, tx, JContext.create(ds.K, *size, dtype=jdt), JConfig(**kw)))
        torch.set_default_dtype(tdt)
        tstate = create_train_state(Model.create(depth=18, in_channels=1, device="cpu").to(tdt), TrainConfig(**kw))
        tstate.model.load_state_dict(params_from_jax(*init))
        tstep = make_train_step(TrainContext.create(ds.K, *size, dtype=tdt, device="cpu"), TrainConfig(**kw))
        curves = {"jax": {"loss": [], "mean_disparity": []}, "torch": {"loss": [], "mean_disparity": []}}
        t = time.time()
        for i, b in enumerate(batches):
            jstate, jm_metrics, _ = jstep(jstate, jnp.asarray(b, jdt))
            tstate, tm, _ = tstep(tstate, torch.from_numpy(b).to(tdt))
            for key, m in (("jax", jm_metrics), ("torch", tm)):
                for name in ("loss", "mean_disparity"):
                    curves[key][name].append(float(m[name]))
            if (i + 1) % 50 == 0:
                print(json.dumps({"dtype": dtype, "step": i + 1, "s": round(time.time() - t, 1),
                                  **{f"{k}_mean_disparity": curves[k]["mean_disparity"][-1] for k in curves},
                                  **{f"{k}_loss": curves[k]["loss"][-1] for k in curves}}), flush=True)
        torch.set_default_dtype(torch.float32)
        out["curves"][dtype] = curves
        with open(os.path.join(args.out, "curves.json"), "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
