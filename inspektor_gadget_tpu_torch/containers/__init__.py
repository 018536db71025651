"""Container tracking (ref: pkg/container-collection, pkg/tracer-collection,
pkg/container-utils, pkg/runcfanotify).

ContainerCollection is the authoritative in-memory container set with a
pubsub fan-out and an enricher chain; TracerCollection keeps per-tracer
mntns filter sets in sync with matching containers — the BPF-map analogue
that gates event sources by container.

The port's copy of ``inspektor_gadget_tpu/containers/__init__.py``.
"""

from .container import Container, ContainerSelector
from .collection import ContainerCollection, EventType, PubSubEvent
from .tracer_collection import TracerCollection
from .options import (
    with_fake_containers,
    with_fallback_pod_informer,
    with_fanotify_discovery,
    with_host,
    with_oci_config_enrichment,
    with_pod_informer,
    with_procfs_discovery,
    with_node_name,
    with_cgroup_enrichment,
    with_linux_namespace_enrichment,
)
from .podinformer import PodInformer, file_pod_source, kube_api_pod_source
from .runtime_client import (
    ContainerdClient,
    CriClient,
    CriGrpcClient,
    DockerClient,
    detect_runtime_client,
    with_runtime_enrichment,
)

__all__ = [
    "Container", "ContainerSelector",
    "ContainerCollection", "EventType", "PubSubEvent",
    "TracerCollection",
    "with_fake_containers", "with_procfs_discovery",
    "with_fanotify_discovery", "with_node_name",
    "with_cgroup_enrichment", "with_linux_namespace_enrichment",
    "with_pod_informer", "with_fallback_pod_informer",
    "with_host", "with_oci_config_enrichment", "with_runtime_enrichment",
    "PodInformer", "file_pod_source", "kube_api_pod_source",
    "ContainerdClient", "CriClient", "CriGrpcClient", "DockerClient",
    "detect_runtime_client",
]
