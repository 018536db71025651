"""Device resolution and the card's identity.

Every entry point of the port takes ``device=`` and defaults to
``"cuda"``. Asking for CUDA where there is none raises: nothing falls
back to the CPU. The CPU path exists for the tests, which ask for it by
name.
"""

from __future__ import annotations

import shutil
import subprocess

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is false; pass device='cpu' to run on the CPU")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: cuda or cpu")
    return d


def nvidia_smi_line() -> str | None:
    """The card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (first card), or None where nvidia-smi is missing."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def device_report(device: str | torch.device = "cuda") -> dict:
    """Platform, card name, card count and power limit of `device`."""
    d = resolve_device(device)
    if d.type == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "nvidia_smi": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(d),
            "count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi_line()}
