"""Which fp32 BatchNorm is the inexact one, on the CPU: the grads of one
train step in fp32 through torch's BatchNorm (the plain step), through the
port's hand-written global-batch BatchNorm (the world-1 data-parallel step,
nn/core.py `_global_forward`) and through two variants of it, each held to
the grads of a float64 step from the same state and batch; and how far the
grads move when one BatchNorm's output is scaled by 1 + 1e-7 in every other
batch row.

    python experiments/bn_vs_float64.py --out runs/bn_vs_float64

ResNet-18, gray, batch 4, the plain warp in every step, SyntheticDriving
frames, at four states: 64×32 after 0, 3 and 8 steps, 128×64 after 3.
Variants: "f64_stats", the count, sums and squared deviations in float64
(cast back to fp32 for the normalization); "scale_shift", y = x·scale +
shift with per-channel scale and shift from the global moments, the form
torch's BatchNorm computes. Imports the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="runs/bn_vs_float64")
    args = ap.parse_args(argv)

    import torch

    from monodepth2_torch.data import SyntheticDriving
    from monodepth2_torch.models import Model
    from monodepth2_torch.nn.core import BatchNorm
    from monodepth2_torch.parallel import make_mesh, make_parallel_train_step
    from monodepth2_torch.training import TrainConfig, TrainContext, create_train_state, make_train_step

    hand = BatchNorm._global_forward

    def f64_stats(self, x, global_sum):
        c, shape = x.shape[1], (1, x.shape[1], 1, 1)
        totals = global_sum(torch.cat([x.sum(dim=(0, 2, 3), dtype=torch.float64),
                                       x.new_full((1,), x.numel() // c, dtype=torch.float64)]))
        n = totals[c]
        mean = totals[:c] / n
        d = x - mean.to(x.dtype).view(shape)
        var = global_sum((d * d).sum(dim=(0, 2, 3), dtype=torch.float64)) / n
        return d * torch.rsqrt(var + self.eps).to(x.dtype).view(shape) * self.weight.view(shape) + self.bias.view(shape)

    def scale_shift(self, x, global_sum):
        c, shape = x.shape[1], (1, x.shape[1], 1, 1)
        totals = global_sum(torch.cat([x.sum(dim=(0, 2, 3)), x.new_full((1,), x.numel() // c)]))
        n = totals[c]
        mean = totals[:c] / n
        d = x - mean.view(shape)
        var = global_sum((d * d).sum(dim=(0, 2, 3))) / n
        scale = torch.rsqrt(var + self.eps) * self.weight
        return x * scale.view(shape) + (self.bias - mean * scale).view(shape)

    mesh = make_mesh(device="cpu")
    results = {"states": []}
    for (w, h), n_steps in (((64, 32), 0), ((64, 32), 3), ((64, 32), 8), ((128, 64), 3)):
        cfg = TrainConfig(target_size=(w, h), batch_size=4, in_channels=1, warp_method="gather")
        ds = SyntheticDriving(n=8, target_size=(w, h))
        batch = torch.from_numpy(np.stack([ds[i] for i in range(4)]))
        state = create_train_state(Model.create(depth=18, in_channels=1, device="cpu"), cfg)
        step = make_train_step(TrainContext.create(ds.K, w, h, device="cpu"), cfg)
        for _ in range(n_steps):
            state, _, _ = step(state, batch)

        def grads(dtype, make, hook=None):
            prev = torch.get_default_dtype()
            torch.set_default_dtype(dtype)
            try:
                ctx = TrainContext.create(ds.K, w, h, dtype=dtype, device="cpu")
                twin = create_train_state(Model.create(depth=18, in_channels=1, device="cpu"), cfg)
                twin.model.load_state_dict(state.model.state_dict())
                if hook is not None:
                    dict(twin.model.named_modules())["encoder.layer1_1.bn2"].register_forward_hook(hook)
                make(ctx, twin)(twin, batch.to(dtype))
            finally:
                torch.set_default_dtype(prev)
            return torch.cat([p.grad.double().flatten() for p in twin.model.parameters()])

        plain = lambda ctx, twin: make_train_step(ctx, cfg)  # noqa: E731
        dp = lambda ctx, twin: make_parallel_train_step(ctx, cfg, mesh)  # noqa: E731
        ref = grads(torch.float64, plain)
        rel = lambda g: float((g - ref).norm() / ref.norm())  # noqa: E731
        row = {"size": [w, h], "steps": n_steps, "torch_batchnorm": rel(grads(torch.float32, plain))}
        for name, forward in (("hand_written", hand), ("f64_stats", f64_stats), ("scale_shift", scale_shift)):
            BatchNorm._global_forward = forward
            try:
                row[name] = rel(grads(torch.float32, dp))
            finally:
                BatchNorm._global_forward = hand
        # one BatchNorm's output scaled by 1 + 1e-7 in every other batch row
        odd_rows = lambda m, i, y: y * (1 + 1e-7 * (torch.arange(y.shape[0]) % 2).to(y.dtype).view(-1, 1, 1, 1))  # noqa: E731
        row["fp32_moved_by_1e-7_per_row"] = float(
            (grads(torch.float32, plain, odd_rows) - grads(torch.float32, plain)).norm() / ref.norm())
        row["float64_moved_by_1e-7_per_row"] = rel(grads(torch.float64, plain, odd_rows))
        print(json.dumps(row), flush=True)
        results["states"].append(row)
    torch.distributed.destroy_process_group()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
