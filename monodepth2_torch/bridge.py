"""Weights between the JAX package's pytrees and the port's modules.

The JAX model keeps nested dicts of numpy-convertible arrays: `params`
(conv "w" in HWIO and "b"; BatchNorm "scale" and "bias") and `stats`
(BatchNorm "mean" and "var"), keyed by the same names the port's submodules
carry (encoder/layer1_0/conv1/w ↔ encoder.layer1_0.conv1.weight).

`load_jax_checkpoint` reads a checkpoint the JAX package wrote
(monodepth2_tpu/training/checkpoint.py) without jax: its leaves in flatten
order, laid out against the port's own module.
"""

from __future__ import annotations

from typing import Mapping, Optional

import json
import os

import numpy as np
import torch
from torch import nn

from .nn.core import BatchNorm, Conv


def _put(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split(".")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def params_from_jax(params: Mapping, stats: Mapping) -> dict:
    """JAX (params, stats) trees, numpy leaves -> a state_dict for the port's
    module of the same structure (load it with `load_state_dict`). The keys
    come from the trees, so a tree that does not match the module fails
    there, in strict mode."""
    state = {}

    def walk(p: Mapping, s: Mapping, prefix: str) -> None:
        if "w" in p:  # Conv: HWIO -> OIHW
            state[prefix + "weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1))
            )
            if "b" in p:
                state[prefix + "bias"] = torch.tensor(np.asarray(p["b"], np.float32))
        elif "scale" in p:  # BatchNorm
            state[prefix + "weight"] = torch.tensor(np.asarray(p["scale"], np.float32))
            state[prefix + "bias"] = torch.tensor(np.asarray(p["bias"], np.float32))
            state[prefix + "running_mean"] = torch.tensor(np.asarray(s["mean"], np.float32))
            state[prefix + "running_var"] = torch.tensor(np.asarray(s["var"], np.float32))
            state[prefix + "num_batches_tracked"] = torch.tensor(0)
        else:
            for key in p:
                walk(p[key], s.get(key, {}), f"{prefix}{key}.")

    walk(params, stats, "")
    return state


def params_to_jax(model: nn.Module, tensors: Optional[Mapping[str, torch.Tensor]] = None):
    """The inverse: the port's module -> JAX-layout (params, stats) trees of
    numpy arrays. `tensors`, keyed by parameter name, replaces the parameters
    (pass the gradients or the Adam moments to lay those out the JAX way)."""
    params, stats = {}, {}
    named = dict(model.named_parameters())
    if tensors is not None:
        named = {k: tensors[k] for k in named}

    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float32).numpy().copy()

    for name, m in model.named_modules():
        if isinstance(m, Conv):
            _put(params, f"{name}.w", arr(named[f"{name}.weight"]).transpose(2, 3, 1, 0))
            if m.bias is not None:
                _put(params, f"{name}.b", arr(named[f"{name}.bias"]))
        elif isinstance(m, BatchNorm):
            _put(params, f"{name}.scale", arr(named[f"{name}.weight"]))
            _put(params, f"{name}.bias", arr(named[f"{name}.bias"]))
            _put(stats, f"{name}.mean", arr(m.running_mean))
            _put(stats, f"{name}.var", arr(m.running_var))
    return params, stats


def _flatten_sorted(tree: Mapping, prefix: tuple = ()) -> list:
    """(key path, leaf) pairs of a nested dict in JAX's flatten order: the
    keys sorted at every level."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            out += _flatten_sorted(value, prefix + (key,))
        else:
            out.append((prefix + (key,), value))
    return out


def _unflatten(pairs) -> dict:
    tree: dict = {}
    for (*parents, key), value in pairs:
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[key] = value
    return tree


def load_jax_checkpoint(path: str, model: nn.Module) -> dict:
    """A checkpoint of the JAX package (`<path>.npz`, leaves `leaf_00000…`,
    and its `<path>.json` sidecar) -> a state_dict for `model`.

    The `.npz` holds the leaves of the JAX TrainState in flatten order:
    `step`, `params`, `stats`, `opt_state`, `rng` (training/state.py), the
    dict keys sorted at every level. The params and stats are laid out
    against `model`'s own trees (`params_to_jax`), so leaves 1…P are the
    params and P+1…P+S the stats, each checked against the template's shape.
    The rest is checked as far as it can be without jax: leaf 0 is an integer
    scalar; Adam's state is its count, then the moments mu and nu (each of its
    parameter's shape); an lr schedule adds one count leaf, gradient clipping
    none; the PRNG key comes last. A count that fits no such optax chain, or
    that differs from the sidecar's `n_leaves`, raises ValueError. Where the
    sidecar records the config, its lr schedule fixes which count it must be.

    The sidecar's `treedef_sha` hashes the string form of the JAX treedef,
    which only jax can build, so it is not checked here. The JAX package
    has one network, the ResNet Monodepth2 `Model`; any other `model` (a
    PackNet) raises ValueError.
    """
    architecture = getattr(model, "architecture", None)
    if architecture != "monodepth2":
        raise ValueError(
            f"{path}: a JAX-package checkpoint holds the ResNet Monodepth2 model only, and cannot load into "
            f"a {type(model).__name__} (architecture {architecture!r})"
        )
    params_t, stats_t = params_to_jax(model)
    p_pairs, s_pairs = _flatten_sorted(params_t), _flatten_sorted(stats_t)
    n_p, n_s = len(p_pairs), len(s_pairs)
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    with np.load(path + ".npz") as data:
        keys = sorted(data.files)
        if keys != [f"leaf_{i:05d}" for i in range(len(keys))]:
            raise ValueError(f"{path}.npz is not a JAX-package checkpoint (arrays {keys[:3]}…)")
        n = len(keys)
        if "n_leaves" in meta and int(meta["n_leaves"]) != n:
            raise ValueError(f"{path}: {n} leaves, its sidecar says {meta['n_leaves']}")
        # step, params, stats, adam count, mu, nu, [schedule count], rng
        extra = n - (1 + n_p + n_s + 1 + 2 * n_p + 1)
        if "config" in meta:
            cfg = json.loads(meta["config"])
            want = int(cfg.get("lr_warmup_steps", 0) > 0 or cfg.get("lr_decay_steps", 0) > 0)
            allowed = (want,)
        else:
            allowed = (0, 1)
        if extra not in allowed:
            raise ValueError(
                f"{path}: {n} leaves fit no optax chain of this model ({n_p} params, {n_s} stats): "
                f"want {[1 + 3 * n_p + n_s + 2 + e for e in allowed]}"
            )

        def leaf(i: int) -> np.ndarray:
            return data[f"leaf_{i:05d}"]

        step = leaf(0)
        if step.shape != () or not np.issubdtype(step.dtype, np.integer):
            raise ValueError(f"{path}: leaf 0 is {step.dtype}{step.shape}, not the integer step")
        count = leaf(1 + n_p + n_s)
        if count.shape != () or not np.issubdtype(count.dtype, np.integer):
            raise ValueError(f"{path}: leaf {1 + n_p + n_s} is {count.dtype}{count.shape}, not Adam's count")

        def read(pairs, first: int, what: str) -> list:
            out = []
            for j, (name, tmpl) in enumerate(pairs):
                arr = leaf(first + j)
                if arr.shape != tmpl.shape:
                    raise ValueError(
                        f"{path}: {what} {'/'.join(name)} (leaf {first + j}) is {arr.shape}, model has {tmpl.shape}"
                    )
                out.append((name, arr))
            return out

        params = read(p_pairs, 1, "param")
        stats = read(s_pairs, 1 + n_p, "stat")
        for k, what in ((2 + n_p + n_s, "mu"), (2 + 2 * n_p + n_s, "nu")):
            read(p_pairs, k, f"Adam {what} of")
    return params_from_jax(_unflatten(params), _unflatten(stats))
