"""The parallel plane: lane meshes (`mesh`), process groups
(`distributed`), the cluster step and merge (`cluster`), ring
all-reduces (`ring`), the sequence plane's attention (`flash_attention`,
K3; `ring_attention`), expert parallelism (`moe`) and pipeline
parallelism (`pipeline`). A mesh is an ordered list of lane devices (a
list of rows of them for a (node, model) mesh); every collective is a
copy or a sum between lane tensors, in lane order.

The package exports what the reference's does but for
``flash_attention``: here that name stays the K3 module (its kernel
library, launch count and plain version live there), and the function
is ``parallel.flash_attention.flash_attention``."""

from .cluster import (ClusterState, cluster_init, cluster_merge, cluster_sketch_step,
                      make_cluster_step)
from .mesh import MeshSpec, make_mesh, node_axis
from .moe import make_ep_moe, moe_apply, moe_init, moe_pspecs
from .pipeline import make_pp_forward, make_pp_train_step, pp_block_init, pp_pspecs, pp_reference
from .ring import ring_psum, ring_psum_chunked

__all__ = [
    "make_mesh", "node_axis", "MeshSpec",
    "cluster_sketch_step", "cluster_merge", "make_cluster_step",
    "ClusterState", "cluster_init",
    "ring_psum", "ring_psum_chunked",
    "make_ep_moe", "moe_apply", "moe_init", "moe_pspecs",
    "make_pp_forward", "make_pp_train_step", "pp_block_init", "pp_pspecs",
    "pp_reference",
]
