"""What the benchmark makes from `--seed` and hands to both sides: the
weights and a sequence of gray frames.

Both are drawn on the run's device by one `torch.Generator` seeded with the
seed, in a few large calls.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .reference.model import Conv


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


@torch.no_grad()
def fill_weights(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Every convolution's weight Glorot-uniform from one draw for the whole
    model, biases zero; BatchNorm scale 1, shift 0, running mean 0 and
    variance 1."""
    convs = [m for m in model.modules() if isinstance(m, Conv)]
    total = sum(m.weight.numel() for m in convs)
    device = convs[0].weight.device
    flat = torch.rand(total, generator=gen, device=device) * 2 - 1
    at = 0
    for m in convs:
        cout, cin, kh, kw = m.weight.shape
        limit = math.sqrt(6.0 / (kh * kw * (cin + cout)))
        m.weight.copy_(flat[at:at + m.weight.numel()].view_as(m.weight) * limit)
        at += m.weight.numel()
        if m.bias is not None:
            m.bias.zero_()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_parameters()


def panorama(frames: int, height: int, width: int, channels: int, shift: int, gen: torch.Generator,
             device: torch.device) -> torch.Tensor:
    """(H, width + shift·(frames - 1), C) in [0, 1]: one long smooth random
    scene (noise at 1/8 of the size, upsampled) plus fine noise, which a
    camera panning `shift` pixels a frame sees as `frames` frames of
    width `width`."""
    total = width + shift * (frames - 1)
    coarse = torch.rand((1, channels, height // 8 + 2, total // 8 + 2), generator=gen, device=device)
    scene = F.interpolate(coarse, size=(height, total), mode="bilinear", align_corners=False)[0]
    scene = scene + 0.05 * torch.randn(scene.shape, generator=gen, device=device)
    return scene.clamp(0, 1).permute(1, 2, 0).contiguous()


def triplets(scene: torch.Tensor, n: int, width: int, shift: int, start: int = 0) -> torch.Tensor:
    """Triplets start … start+n-1 of a panorama's sequence, (n, 3, H, W, C):
    triplet i holds frames i, i+1, i+2."""
    return torch.stack([torch.stack([scene[:, (i + j) * shift:(i + j) * shift + width] for j in range(3)])
                        for i in range(start, start + n)])
