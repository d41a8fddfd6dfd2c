"""Weights between the JAX package's pytrees and the port's modules.

The JAX model keeps nested dicts of numpy-convertible arrays: `params`
(conv "w" in HWIO and "b"; BatchNorm "scale" and "bias") and `stats`
(BatchNorm "mean" and "var"), keyed by the same names the port's submodules
carry (encoder/layer1_0/conv1/w ↔ encoder.layer1_0.conv1.weight).
"""

from __future__ import annotations

from typing import Mapping, Optional

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
