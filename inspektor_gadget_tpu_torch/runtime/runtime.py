"""Runtime interface + combined results + catalog.

Reference contract: pkg/runtime/runtime.go (Runtime interface :83-92,
GadgetResult/CombinedGadgetResult :42-79 with per-node error isolation) and
pkg/runtime/catalog.go (serializable catalog of gadgets+operators+params so
remote clients can render flags for server-known gadgets).

The port's copy of ``inspektor_gadget_tpu/runtime/runtime.py``, the
stream accounting and fleet-health fields its gRPC runtime fills
included.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..gadgets import registry
from ..gadgets.context import GadgetContext
from ..operators import operators as op_registry
from ..params import ParamDescs, Params


@dataclasses.dataclass
class GadgetResult:
    result: Any = None
    error: str | None = None
    # stream accounting (filled by the supervised gRPC fan-out; the
    # local runtime leaves the defaults): seq gaps observed in transit,
    # reconnect attempts, records received, highest seq seen, events
    # recovered from sealed-window backfill, and the sealed windows
    # themselves so harvest merges can fold the healed state in.
    gaps: int = 0
    reconnects: int = 0
    records: int = 0
    last_seq: int = 0
    backfilled: int = 0
    backfill: list = dataclasses.field(default_factory=list)
    health: str = ""
    # shared-run subscriber accounting (next to the health fields so a
    # degraded answer is LABELED): records this node's subscriber queue
    # dropped under overload, whether it was evicted for stalling, a
    # typed admission-refusal reason (empty = admitted), and whether the
    # stream attached to an already-running shared gadget
    sub_drops: int = 0
    evicted: bool = False
    attach_refused: str = ""
    shared: bool = False


class CombinedGadgetResult(dict):
    """node → GadgetResult; partial failures stay per-node
    (ref: runtime.go:42-79). `health` carries each node's final fleet
    state (supervisor.FleetHealth) so a degraded answer is LABELED
    degraded instead of silently looking whole."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.health: dict[str, str] = {}

    def first(self) -> Any:
        for r in self.values():
            if r.error is None:
                return r.result
        return None

    def errors(self) -> dict[str, str]:
        return {k: r.error for k, r in self.items() if r.error}

    def contributing(self) -> list[str]:
        """Nodes whose stream ended cleanly — the ones a harvest merge
        actually contains."""
        return [k for k, r in self.items() if r.error is None]

    @property
    def partial(self) -> bool:
        """True when any node failed or ended unhealthy: the merged
        answer does not cover the whole fleet."""
        if any(r.error for r in self.values()):
            return True
        return any(s not in ("", "healthy") for s in self.health.values())

    def overloaded(self) -> dict[str, str]:
        """node → overload label for nodes whose subscriber stream was
        degraded under fan-out (own-queue drops, eviction, or a refused
        admission) — a thinned answer is LABELED thinned, never silently
        complete-looking."""
        out: dict[str, str] = {}
        for node, r in self.items():
            if r.attach_refused:
                out[node] = f"refused ({r.attach_refused})"
            elif r.evicted:
                out[node] = f"evicted after {r.sub_drops} drop(s)"
            elif r.sub_drops:
                out[node] = f"{r.sub_drops} subscriber drop(s)"
        return out


class Runtime:
    name = ""

    def params(self) -> ParamDescs:
        return ParamDescs()

    def init(self, runtime_params: Params) -> None:
        pass

    def close(self) -> None:
        pass

    def run_gadget(self, ctx: GadgetContext) -> CombinedGadgetResult:
        raise NotImplementedError

    def get_catalog(self) -> dict:
        return build_catalog()


def build_catalog() -> dict:
    """Catalog from the live registries (ref: runtime/local/local.go:38-51
    builds its catalog from the gadget registry; serialization mirrors
    pkg/runtime/catalog.go)."""
    gadgets = []
    for desc in registry.get_all():
        cols = desc.columns()
        gadgets.append({
            "category": desc.category,
            "name": desc.name,
            "type": desc.gadget_type.value,
            "description": desc.description,
            "params": desc.params().to_params().to_descs_json(),
            "columns": [
                {"name": c.name, "width": c.width, "align": c.align,
                 "visible": c.visible, "description": c.description}
                for c in (cols.all() if cols else [])
            ],
        })
    ops = []
    for op in op_registry.get_all():
        ops.append({
            "name": op.name,
            "dependencies": op.dependencies(),
            "globalParams": op.global_params().to_params().to_descs_json(),
            "instanceParams": op.instance_params().to_params().to_descs_json(),
        })
    return {"gadgets": gadgets, "operators": ops}
