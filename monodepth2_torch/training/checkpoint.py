"""Checkpoint / resume, port of monodepth2_tpu/training/checkpoint.py.

The full train state round-trips, so a crash loses at most `save_every`
steps (the reference saves only the model and cannot resume,
src/Monodepth.jl:191-193): the model's state_dict (params, BN running stats
and batch counts), Adam's moments and step counts, and the train step.

Format: `<path>.npz` with one array per entry, named `model/<state_dict
key>`, `optim/<parameter name>/<exp_avg | exp_avg_sq | step>` and
`train_step`, and a `<path>.json` sidecar with the step, the caller's
metadata and a fingerprint of the structure. Both are written through a
temporary file and os.replace, the sidecar first, so a `.npz` that
`latest_checkpoint` finds is whole and has its sidecar. Loading copies into
the state's own tensors, so a CUDA graph captured on them stays valid.

This is not the JAX package's format (its pytree leaves in flatten order).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from .state import TrainState

ADAM_KEYS = ("exp_avg", "exp_avg_sq")


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def structure(state: TrainState) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, dtype) of every array a checkpoint of `state` holds, in
    order. Adam's entries come from the params (each moment has its
    parameter's shape and dtype), not from Adam's state, which Adam creates
    at its first step; step counts are "count", whatever their dtype."""
    entries = [(f"model/{k}", tuple(v.shape), _dtype(v)) for k, v in state.model.state_dict().items()]
    for name, p in state.model.named_parameters():
        entries += [(f"optim/{name}/{key}", tuple(p.shape), _dtype(p)) for key in ADAM_KEYS]
        entries.append((f"optim/{name}/step", (), "count"))
    entries.append(("train_step", (), "count"))
    return entries


def fingerprint(state: TrainState) -> str:
    """Hash of the structure and the optimizer's class: a checkpoint of
    another model or optimizer differs, where equal array counts alone would
    not show it."""
    s = json.dumps([type(state.optimizer).__name__, structure(state)])
    return hashlib.sha256(s.encode()).hexdigest()[:16]


def _replace_atomically(path: str, write) -> None:
    tmp = path + ".tmp" + os.path.splitext(path)[1]
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState, metadata: Optional[dict] = None) -> None:
    """Write `<path>.json` then `<path>.npz`."""
    arrays = {f"model/{k}": v.detach().cpu().numpy() for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        st = state.optimizer.state.get(p, {})
        for key in ADAM_KEYS:
            arrays[f"optim/{name}/{key}"] = (
                st[key].detach().cpu().numpy() if key in st else np.zeros(tuple(p.shape), _dtype(p))
            )
        # Adam has no state before its first step: its count is 0 then
        arrays[f"optim/{name}/step"] = st["step"].cpu().numpy() if "step" in st else np.zeros((), np.float32)
    arrays["train_step"] = np.asarray(state.step, np.int64)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = dict(metadata or {})
    meta.setdefault("step", state.step)
    meta["n_arrays"] = len(arrays)
    meta["fingerprint"] = fingerprint(state)

    def write_json(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)

    _replace_atomically(path + ".json", write_json)
    _replace_atomically(path + ".npz", lambda tmp: np.savez(tmp, **arrays))


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore `<path>` into `state` in place and return it.

    Refuses (ValueError, before anything is copied) when the sidecar's
    fingerprint differs from the state's — another model, config or
    optimizer wrote it — or when an array is missing, extra, or of another
    shape than the state's."""
    with open(path + ".json") as f:
        meta = json.load(f)
    want, have = meta.get("fingerprint"), fingerprint(state)
    if want != have:
        raise ValueError(
            f"checkpoint {path} was saved from a state of another structure (fingerprint {want} != {have}): "
            "the model or optimizer this run builds does not match the one that wrote it"
        )
    entries = structure(state)
    with np.load(path + ".npz") as data:
        names = {name for name, _, _ in entries}
        if set(data.files) != names:
            raise ValueError(
                f"checkpoint {path}: arrays {sorted(set(data.files) ^ names)[:5]} are not those of the state"
            )
        arrays = {name: data[name] for name in data.files}
    for name, shape, _ in entries:
        if tuple(arrays[name].shape) != shape:
            raise ValueError(f"{name}: checkpoint shape {arrays[name].shape} != state shape {shape}")

    model, optimizer = state.model, state.optimizer
    model.load_state_dict({k[len("model/"):]: torch.from_numpy(v) for k, v in arrays.items() if k.startswith("model/")})
    group_of = {p: g for g in optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        st = optimizer.state[p]
        saved = {key: torch.from_numpy(arrays[f"optim/{name}/{key}"]) for key in (*ADAM_KEYS, "step")}
        if st:
            for key, value in saved.items():
                st[key].copy_(value)
        else:
            group = group_of[p]
            on_device = group.get("capturable", False) or group.get("fused", False)
            st["step"] = saved["step"].to(p.device if on_device else "cpu")
            for key in ADAM_KEYS:
                st[key] = saved[key].to(device=p.device, dtype=p.dtype, memory_format=torch.preserve_format)
    state.step = int(arrays["train_step"])
    return state


def latest_checkpoint(save_dir: str, prefix: str = "ckpt") -> Optional[str]:
    """Find the highest-step `<prefix>-<step>` in save_dir, or None."""
    if not os.path.isdir(save_dir):
        return None
    pat = re.compile(rf"^{re.escape(prefix)}-(\d+)\.npz$")
    best, best_step = None, -1
    for f in os.listdir(save_dir):
        m = pat.match(f)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(save_dir, f[: -len(".npz")])
    return best
