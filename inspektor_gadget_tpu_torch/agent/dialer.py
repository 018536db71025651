"""Dialers: how an AgentClient reaches its agent.

Reference contract: pkg/runtime/grpc/k8s-exec-dialer.go:1-132 — a Dialer
turns a target into a grpc.Channel. The port's copy of
``inspektor_gadget_tpu/agent/dialer.py`` holds the plain path,
`DirectDialer`; the exec-tunnel dialer rides with the fan-out (ROADMAP
item 18b).
"""

from __future__ import annotations

import grpc


class DirectDialer:
    """Plain target: host:port or unix:///path."""

    def dial(self, target: str) -> grpc.Channel:
        return grpc.insecure_channel(target)

    def close(self) -> None:
        pass
