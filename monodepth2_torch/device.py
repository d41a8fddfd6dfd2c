"""Device selection and the card's published peaks, shared by the port's
entry points."""

from __future__ import annotations

import os
import subprocess

import torch

# One H100 SXM at its full 700 W power limit (NVIDIA H100 data sheet, dense
# rates without sparsity). A card set to a lower limit runs slower under load,
# so every time is reported beside nvidia-smi's power limit.
H100_BYTES_PER_S = 3.35e12  # HBM3
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
H100_BF16_FLOPS = 989e12  # bf16 tensor cores, dense


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks for
    the CPU. Raises RuntimeError when a CUDA device is asked for and there is
    none — the port never drops to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def nvidia_smi() -> str:
    """The first card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"). Raises if nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def host_cpu() -> str | None:
    """The host CPU's model name (/proc/cpuinfo), or None where there is none."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


def describe(device: torch.device) -> dict:
    """What a result ran on: the device type, and on a card its torch name
    and nvidia-smi's name and power limit; and the host, which sets the time
    of a step bound by its launches: the CPU model, the cores this process
    may use and the 1/5/15-minute load averages."""
    host = {"host_cpu": host_cpu(), "host_cores": len(os.sched_getaffinity(0)), "host_load": list(os.getloadavg())}
    if device.type != "cuda":
        return {"device": device.type, "nvidia_smi": None, **host}
    return {"device": torch.cuda.get_device_name(device), "nvidia_smi": nvidia_smi(), **host}


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
