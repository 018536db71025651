"""Lane meshes of the sharded ingest and the cluster merge (PyTorch port
of ``inspektor_gadget_tpu/parallel/mesh.py``).

The reference lays its chips out on a ``(node, model)`` device mesh.
Here a mesh is an ordered list of lane devices: lane k runs on
``mesh[k]``, ``cuda:k`` by default. Per-node state lives one bundle a
lane and merges over the lanes (the node axis). A caller may list one
device more than once: lanes sharing a device are a check of the lane
algebra (on the CPU in the tests, on a one-card host in ``chip_smoke.py``),
never a deployment, since they only take turns on the device.

A two-dimensional (node, model) mesh, for tensor parallelism, is a list
of node rows, each a list of ``n_model`` lane devices: the reference's
device grid with its axes in the same order.
"""

from __future__ import annotations

import dataclasses

import torch

NODE_AXIS = "node"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    n_nodes: int
    n_model: int = 1


def local_devices() -> list[torch.device]:
    """This process's CUDA devices, ``cuda:0`` first (none without a card)."""
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def lane_device(d) -> torch.device:
    """`d` as a lane device: ``cuda`` without an index is the current card,
    so that a lane compares equal to the device of its tensors."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _as_devices(devices) -> list[torch.device]:
    return [lane_device(d) for d in (devices if devices is not None else local_devices())]


def grid(devs: list[torch.device], n_model: int, n_nodes: int | None = None) -> list:
    """`devs` as a mesh: the first `n_nodes` node lanes when ``n_model``
    is 1, else `n_nodes` rows of `n_model` lanes, row-major as the
    reference reshapes its devices (default: as many rows as fit)."""
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    n = len(devs) // n_model if n_nodes is None else n_nodes
    if not 1 <= n * n_model <= len(devs):
        raise ValueError(f"n_nodes={n} x n_model={n_model} for {len(devs)} device(s)")
    if n_model == 1:
        return devs[:n]
    return [devs[i * n_model:(i + 1) * n_model] for i in range(n)]


def make_mesh(n_nodes: int | None = None, n_model: int = 1, devices=None) -> list:
    """The node lanes of `devices` (default: every local card): a list of
    the first `n_nodes`, or with ``n_model > 1`` a (node, model) grid of
    `n_nodes` rows of `n_model` lanes."""
    return grid(_as_devices(devices), n_model, n_nodes)


def mesh_shape(mesh: list) -> dict[str, int]:
    """{"node": rows, "model": lanes a row} of a flat or (node, model) mesh."""
    if mesh and isinstance(mesh[0], (list, tuple)):
        return {NODE_AXIS: len(mesh), MODEL_AXIS: len(mesh[0])}
    return {NODE_AXIS: len(mesh), MODEL_AXIS: 1}


def ingest_mesh(chips: int, devices=None) -> list[torch.device]:
    """The lanes the sharded ingest plane runs on: the first `chips` of
    `devices` (default: every local card), one bundle each, collectives
    only at harvest. A 1-lane mesh is legal; the operator takes chips=1
    to be the unsharded path."""
    devs = _as_devices(devices)
    if chips < 1:
        raise ValueError(f"chips must be >= 1, got {chips}")
    if chips > len(devs):
        raise ValueError(f"chips={chips} exceeds the {len(devs)} local device(s)")
    return devs[:chips]


def node_axis() -> str:
    return NODE_AXIS


__all__ = ["MODEL_AXIS", "NODE_AXIS", "MeshSpec", "grid", "ingest_mesh", "lane_device",
           "local_devices", "make_mesh", "mesh_shape", "node_axis"]
