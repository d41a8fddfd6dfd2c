"""Faults planted in the program under the timed path, for the tests that
show `correct` comes out false and for the readings that set a limit's
upper end (`calibrate.py`). The benchmark's runs plant nothing.

Each is a context manager that patches the program's module while inside:

  unchanged        every train step leaves the parameters as they were
  half_batch       every train step sees the first half of the batch only,
                   the mean taken over it, and returns its rows only
  half_rows        every train step's loss is the mean over the first half
                   of the batch; the network still runs every row, and every
                   row's disparity is returned
  flipped_replays  from the fourth update of the first call on (on the card:
                   in the captured graph, which every replay runs), the
                   gradient's sign is flipped
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name: str, replacement):
    original = getattr(module, name)
    setattr(module, name, replacement(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def unchanged():
    from monodepth2_torch.training import state

    def wrap(update):
        def frozen(ctx, cfg, train_state, step, frames, Ks, dp=None):
            params = list(train_state.model.parameters())
            keep = [p.detach().clone() for p in params]
            out = update(ctx, cfg, train_state, step, frames, Ks, dp)
            with torch.no_grad():
                torch._foreach_copy_(params, keep)
            return out

        return frozen

    return _patched(state, "_update", wrap)


def half_batch():
    from monodepth2_torch.training import state

    def wrap(train_loss):
        def half(model, frames, ctx, cfg, **kw):
            n = max(1, frames.shape[0] // 2)
            if kw.get("Ks") is not None:
                kw["Ks"] = kw["Ks"][:n]
            return train_loss(model, frames[:n], ctx, cfg, **kw)

        return half

    return _patched(state, "train_loss", wrap)


class _ScaleRowsGrad(torch.autograd.Function):
    """Identity forward; the backward scales each row's gradient."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        (scale,) = ctx.saved_tensors
        return grad * scale.view(-1, *([1] * (grad.dim() - 1))).to(grad.dtype), None


def _scaled_outputs(run_model, scale_of):
    """`run_model` (the loss's model call) with every output's gradient
    scaled row by row by `scale_of(rows)`, or untouched where it returns
    None. Every term of the loss is a mean over rows of a term that reads
    only its row's outputs, so this scales each row's term of the loss."""

    def scaled(model, frames, cfg):
        disparities, poses = run_model(model, frames, cfg)
        scale = scale_of(frames.shape[0], frames.device)
        if scale is None:
            return disparities, poses
        return ([_ScaleRowsGrad.apply(d, scale) for d in disparities],
                [(_ScaleRowsGrad.apply(r, scale), _ScaleRowsGrad.apply(t, scale)) for r, t in poses])

    return scaled


def half_rows():
    from monodepth2_torch.training import loss

    def scale_of(n, device):
        # the loss's mean over rows 0 … n/2-1: those rows' terms twice, the rest nought
        return (torch.arange(n, device=device) < max(1, n // 2)).float() * (n / max(1, n // 2))

    return _patched(loss, "_run_model", lambda run: _scaled_outputs(run, scale_of))


def flipped_replays():
    from monodepth2_torch.training import loss

    calls = [0]

    def scale_of(n, device):
        calls[0] += 1
        return -torch.ones(n, device=device) if calls[0] >= 4 else None

    return _patched(loss, "_run_model", lambda run: _scaled_outputs(run, scale_of))


PLANTS = {"unchanged": unchanged, "half_batch": half_batch, "half_rows": half_rows,
          "flipped_replays": flipped_replays}
