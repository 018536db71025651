"""Runtime interface + combined results + catalog.

Reference contract: pkg/runtime/runtime.go (Runtime interface :83-92,
GadgetResult/CombinedGadgetResult :42-79 with per-node error isolation) and
pkg/runtime/catalog.go (serializable catalog of gadgets+operators+params so
remote clients can render flags for server-known gadgets).

The port's copy of ``inspektor_gadget_tpu/runtime/runtime.py`` (its
results without the gRPC runtime's stream accounting).
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


class CombinedGadgetResult(dict):
    """node → GadgetResult; partial failures stay per-node
    (ref: runtime.go:42-79). The reference's stream accounting and fleet
    health fields come with its gRPC runtime (ROADMAP item 18b)."""

    def first(self) -> Any:
        for r in self.values():
            if r.error is None:
                return r.result
        return None

    def errors(self) -> dict[str, str]:
        return {k: r.error for k, r in self.items() if r.error}


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
