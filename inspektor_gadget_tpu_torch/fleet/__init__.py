"""Fleet aggregation tier (the port of ``inspektor_gadget_tpu/fleet``):
aggregation as topology, not a client loop.

The merge algebra is associative and commutative on every plane
(count-min, entropy, DDSketch and invertible lanes add, HLL registers
max, top-k candidates union and re-rank: history/window.py), so the fold
can move onto the topology itself:

- `topology.py`: the tree spec (node, zone, fleet), declared through a
  compact grammar or balanced to O(log N) fan-in, with typed validation:
  every agent exactly once, no empty zones, no id reuse.
- `aggregator.py`: the `AggregatorNode` role and `fold_tree`: each
  aggregator folds its children's summary windows through the same merge
  (`merge_windows` then `merged_to_sealed`) and republishes one sealed
  window upward. `flat_summary` and `canonical_order` pin the
  byte-identity anchor: any fold shape over the same leaf windows seals
  the same bytes.
- `collective.py`: the path for GPU hosts of one job: each host's lanes
  merge on the card, then one reduction a plane over a
  `torch.distributed` group (`parallel.cluster.cluster_merge`).
- `sim.py`: the in-process ~100-agent harness (churn, partition, skew)
  of the scale tests.
"""

from .aggregator import AggregatorNode, TreeFold, canonical_order, flat_summary, fold_tree
from .collective import fleet_collective_merge, make_fleet_merge
from .topology import Topology, TopologyError, TreeNode, auto_topology, parse_topology

__all__ = [
    "AggregatorNode", "Topology", "TopologyError", "TreeFold", "TreeNode",
    "auto_topology", "canonical_order", "flat_summary",
    "fleet_collective_merge", "fold_tree", "make_fleet_merge",
    "parse_topology",
]
