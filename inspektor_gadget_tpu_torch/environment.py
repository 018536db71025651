"""Runtime environment flag (ref: pkg/environment/env.go:30 — the global
Local vs Kubernetes toggle that drives column visibility: kubernetes-tagged
columns hide in local mode).

The port's copy of ``inspektor_gadget_tpu/environment.py``.
"""

from __future__ import annotations

import enum


class Environment(str, enum.Enum):
    LOCAL = "local"
    KUBERNETES = "kubernetes"


_current = Environment.LOCAL


def set_environment(env: Environment) -> None:
    global _current
    _current = env


def current() -> Environment:
    return _current


K8S_TAG = "kubernetes"
