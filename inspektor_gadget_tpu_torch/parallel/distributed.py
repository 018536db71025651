"""Several processes, one merge (PyTorch port of
``inspektor_gadget_tpu/parallel/distributed.py``).

The reference joins every host's chips into one JAX device set, and its
merges are collectives over a mesh that spans the hosts. Here each
process keeps its own lanes (`parallel.mesh`) and joins a
`torch.distributed` process group; a merge folds the process's lanes and
then crosses the group once (`ops/lanes.py`): NCCL when the port's device
is CUDA, gloo on the CPU. Global lane order is rank-major: rank r's
lanes come after those of ranks 0 to r-1, which is the order the top-k
gather keeps.

gRPC stays the control plane (agent/); these collectives are a data
plane for hosts that share one job.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .mesh import _as_devices, grid


def backend_for(device: str | torch.device = "cuda") -> str:
    """NCCL for CUDA, gloo on the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device: str | torch.device = "cuda",
                     timeout_s: float = 300.0) -> None:
    """Join the process group at ``tcp://<coordinator_address>`` as rank
    `process_id` of `num_processes` (a one-process group too, where the
    reference does nothing: the collective path is then the same code on
    one host). No-op without `num_processes` or when the group already
    exists. The backend follows `device` with no fallback: a CUDA run
    that cannot form an NCCL group raises."""
    import datetime

    import torch.distributed as dist
    if num_processes is None or dist.is_initialized():
        return
    backend = backend_for(device)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("init_distributed: this torch has no NCCL; a CUDA run needs it")
    addr = coordinator_address or "127.0.0.1:29500"
    dist.init_process_group(backend, init_method=f"tcp://{addr.removeprefix('tcp://')}",
                            world_size=num_processes, rank=process_id or 0,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_multihost_mesh(n_model: int = 1, devices=None) -> list:
    """This process's lanes of the global mesh (default: its cards; pass
    ``["cpu"]`` lanes on a gloo group): a list of node lanes, or with
    ``n_model > 1`` rows of `n_model` model lanes (`mesh.grid`). Every
    rank must hold as many lanes: the top-k gather takes equal shares."""
    import torch.distributed as dist
    lanes = _as_devices(devices)
    if dist.is_initialized():
        counts = [None] * dist.get_world_size()
        dist.all_gather_object(counts, len(lanes))
        if len(set(counts)) != 1:
            raise ValueError(f"ranks hold unequal lane counts {counts}")
    return grid(lanes, n_model)


def local_node_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1
