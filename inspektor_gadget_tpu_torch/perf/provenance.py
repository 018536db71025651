"""Provenance stamping: who/where/what produced a journal (the port's copy
of `git_provenance` and `host_fingerprint` from
``inspektor_gadget_tpu/perf/provenance.py``)."""

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
