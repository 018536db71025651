"""Device resolution and the card's identity.

Every entry point of the port takes ``device=`` and defaults to
``"cuda"``. Asking for CUDA where there is none raises: nothing falls
back to the CPU. The CPU path exists for the tests, which ask for it by
name.
"""

from __future__ import annotations

import shutil
import statistics
import subprocess

import torch

SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's ~2 GHz SM clock


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


def time_cuda(fn, rounds: int = 21, per_round: int = 10, warm: int = 3) -> float:
    """Device milliseconds per call of `fn`: the median over `rounds` of
    CUDA-event time across `per_round` back-to-back calls, divided by
    `per_round`. Each round first parks the stream in a 20 ms device
    sleep, so the host has queued every call before the first starts and
    the events time the device's work, not the host's launch pace (a
    call whose host side is slower than its device side is timed at the
    host's pace all the same)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(per_round):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_round)
    return statistics.median(times)
