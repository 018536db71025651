"""Fleet aggregation tier (ref: ``inspektor_gadget_tpu/fleet``).

The port holds only what the flat fleet fold needs: `canonical_order`,
the window order `GrpcRuntime.query_history` folds in. The tier itself
(`AggregatorNode`, `fold_tree`, `flat_summary`, the topology grammar,
the collective merge and the fleet simulator) is ROADMAP item 11; asking
for one of its names raises ImportError naming it.
"""

from .aggregator import canonical_order

_ITEM_11 = ("AggregatorNode", "Topology", "TopologyError", "TreeFold", "TreeNode",
            "auto_topology", "flat_summary", "fleet_collective_merge", "fold_tree",
            "make_fleet_merge", "parse_topology")


def __getattr__(name: str):
    if name in _ITEM_11:
        raise ImportError(f"fleet.{name} is not ported to ig-tpu-torch yet (ROADMAP item 11)")
    raise AttributeError(name)


__all__ = ["canonical_order"]
