"""Per-node agent: the gRPC service, its client, the hook client and the
daemon entry point.

Reference architecture (SURVEY §2.3/§2.5): a per-node daemon
(pkg/gadgettracermanager) exposes gRPC services over unix sockets — the
legacy container hooks API (AddContainer/RemoveContainer) and the modern
GadgetManager (GetInfo + RunGadget bidirectional stream,
gadgettracermanager/api proto:121-140); the client runtime fans out one
stream per node and merges client-side.

The port's copy of ``inspektor_gadget_tpu/agent``: the same module paths,
class names, RPC names and wire bytes (`ig.proto`, `wire.py`), so a port
node and a reference node answer one client alike. Every run the agent
starts takes the agent's ``device`` (``cuda`` by default, no fallback).
The client half, the fan-out over a fleet of agents, is
`runtime/grpc_runtime.py` (with `dialer.ExecTunnelDialer` for agents no
address routes to).

The exports load on first use: the capture journal and the history
store import `agent.wire`, and the hook client and `liveness` need no
gadget registry (nor torch).
"""

import importlib

_EXPORTS = {"AgentClient": ".client", "AgentServer": ".service",
            "GadgetStream": ".stream", "serve": ".service"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name], __name__), name)
