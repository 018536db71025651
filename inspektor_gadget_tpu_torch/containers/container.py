"""Container model + selector matching.

Reference contract: pkg/container-collection/containers.go:30 (Container:
runtime ids, pid, mntns/netns, cgroup paths, OCI config, k8s metadata,
labels) and match.go:25 (ContainerSelectorMatches: namespace, podname,
container name, labels — empty fields match everything).

The port's copy of ``inspektor_gadget_tpu/containers/container.py``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Container:
    id: str = ""
    name: str = ""
    pid: int = 0
    mntns: int = 0
    netns: int = 0
    cgroup_path: str = ""
    cgroup_id: int = 0
    # k8s metadata
    namespace: str = ""
    pod: str = ""
    pod_uid: str = ""
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    runtime: str = ""
    host_network: bool = False
    # OCI extras (filled by with_oci_config_enrichment from the bundle's
    # config.json — ref options.go:628 WithOCIConfigEnrichment)
    oci_image: str = ""
    seccomp_profile: str = ""
    mounts: list = dataclasses.field(default_factory=list)
    env: list = dataclasses.field(default_factory=list)
    bundle: str = ""


@dataclasses.dataclass
class ContainerSelector:
    """Empty fields match everything (ref: match.go:25-60)."""

    namespace: str = ""
    pod: str = ""
    name: str = ""
    labels: dict[str, str] = dataclasses.field(default_factory=dict)

    def matches(self, c: Container) -> bool:
        if self.namespace and c.namespace != self.namespace:
            return False
        if self.pod and c.pod != self.pod:
            return False
        if self.name and c.name != self.name:
            return False
        for k, v in self.labels.items():
            if c.labels.get(k) != v:
                return False
        return True
