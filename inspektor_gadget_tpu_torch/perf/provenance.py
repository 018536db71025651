"""Provenance stamping: who/where/what produced a perf number or a
journal (the port's copy of ``inspektor_gadget_tpu/perf/provenance.py``).

Every PerfRecord carries the git sha (+dirty flag), a host fingerprint,
the acquired platform with its degraded flag, and the full probe trail,
so a record read months later still answers "was this a run on the
card?" without trusting surrounding prose. The port's probe raises where
the reference's degrades (`utils/platform_probe.py`), so a record made
here always says ``degraded: false``.
"""

from __future__ import annotations

import os
import platform as _platform
import socket
import subprocess
import sys

_GIT_TIMEOUT = 10.0


def git_provenance(cwd: str | None = None) -> tuple[str, bool]:
    """(sha, dirty). 'unknown' when not in a git checkout — recorded as
    such rather than guessed."""
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=_GIT_TIMEOUT).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        sha = ""
    if not sha:
        return "unknown", False
    try:
        dirty = bool(subprocess.run(
            ["git", "status", "--porcelain"], cwd=cwd, capture_output=True,
            text=True, timeout=_GIT_TIMEOUT).stdout.strip())
    except (OSError, subprocess.TimeoutExpired):
        dirty = False
    return sha, dirty


def host_fingerprint() -> dict:
    return {
        "hostname": socket.gethostname() or "unknown",
        "machine": _platform.machine() or "unknown",
        "python": sys.version.split()[0],
        "cpu_count": os.cpu_count() or 0,
    }


def build_provenance(platform: str, degraded: bool,
                     probe: dict | None = None,
                     cwd: str | None = None) -> dict:
    """Assemble the provenance block from an acquire_platform-style
    outcome dict (utils/platform_probe) plus repo + host facts."""
    sha, dirty = git_provenance(cwd)
    probe = dict(probe or {})
    probe.setdefault("outcome", "unprobed")
    probe.setdefault("attempts", [])
    return {
        "git_sha": sha,
        "git_dirty": dirty,
        "host": host_fingerprint(),
        "platform": platform if platform in ("tpu", "cpu", "gpu", "none")
        else "unknown",
        "degraded": bool(degraded),
        "probe": probe,
    }


def probe_block(acquired: dict | None) -> dict:
    """Normalize an acquire_platform(+retry) outcome into the record's
    provenance.probe block."""
    if not acquired:
        return {"outcome": "unprobed", "attempts": []}
    outcome = "degraded" if acquired.get("degraded") else "ok"
    return {
        "outcome": outcome,
        "requested": acquired.get("requested", ""),
        "detail": acquired.get("detail", ""),
        "elapsed_s": round(float(acquired.get("elapsed", 0.0)), 3),
        "attempts": list(acquired.get("attempts", [])),
    }


def acquire_device(device="cuda", *, timeout: float | None = None,
                   attempts: int | None = None, horizon: float | None = None):
    """Resolve `device` (cuda without a card raises at once, with
    `resolve_device`'s message), then acquire its platform through the
    bounded, retrying probe. Returns (torch.device, the probe's outcome)."""
    from ..device import resolve_device
    from ..utils.platform_probe import acquire_platform_with_retry
    dev = resolve_device(device)
    kw = {} if timeout is None else {"timeout": timeout}
    acquired = acquire_platform_with_retry(dev.type, attempts=attempts, horizon=horizon, **kw)
    return dev, acquired


def device_provenance(dev, acquired: dict | None) -> dict:
    """The provenance block of a record measured on `dev`: platform
    ``gpu`` on a CUDA device, ``cpu`` on the CPU, with the probe trail."""
    return build_provenance("gpu" if dev.type == "cuda" else "cpu",
                            bool((acquired or {}).get("degraded")), probe=probe_block(acquired))
