"""OCI annotation-dialect resolvers: runtime-specific annotation keys →
pod/namespace/container identity.

Each container runtime writes k8s identity into the OCI bundle's
annotations under its own key dialect; resolving them lets enrichment
attach pod/namespace/container names without reaching the k8s API
(ref: pkg/container-utils/oci-annotations/types.go:24-60,
resolver_containerd.go:17-28, resolver_crio.go:17-27 — the key strings
themselves are containerd/cri-o ABI, not reference design).

Dialect detection mirrors the reference's NewResolverFromAnnotations:
cri-o stamps `io.container.manager`; containerd stamps
`io.kubernetes.cri.container-type`.

The port's copy of ``inspektor_gadget_tpu/containers/oci_annotations.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

# containerd dialect (containerd pkg/cri/annotations)
_CONTAINERD = {
    "pod": "io.kubernetes.cri.sandbox-name",
    "namespace": "io.kubernetes.cri.sandbox-namespace",
    "pod_uid": "io.kubernetes.cri.sandbox-uid",
    "name": "io.kubernetes.cri.container-name",
    "type": "io.kubernetes.cri.container-type",
}

# cri-o / podman dialect (kubelet label keys + cri-o ContainerType)
_CRIO = {
    "pod": "io.kubernetes.pod.name",
    "namespace": "io.kubernetes.pod.namespace",
    "pod_uid": "io.kubernetes.pod.uid",
    "name": "io.kubernetes.container.name",
    "type": "io.kubernetes.cri-o.ContainerType",
}

_CRIO_MANAGER_KEY = "io.container.manager"


@dataclass(frozen=True)
class ResolvedIdentity:
    runtime: str
    name: str = ""
    pod: str = ""
    namespace: str = ""
    pod_uid: str = ""
    container_type: str = ""  # "container" | "sandbox"


class AnnotationResolver:
    """One dialect's key table bound to accessor methods."""

    def __init__(self, runtime: str, keys: dict[str, str]):
        self.runtime = runtime
        self._keys = keys

    def resolve(self, annotations: dict[str, str]) -> ResolvedIdentity:
        return ResolvedIdentity(
            runtime=self.runtime,
            name=annotations.get(self._keys["name"], ""),
            pod=annotations.get(self._keys["pod"], ""),
            namespace=annotations.get(self._keys["namespace"], ""),
            pod_uid=annotations.get(self._keys["pod_uid"], ""),
            container_type=annotations.get(self._keys["type"], ""),
        )


_RESOLVERS = {
    "containerd": AnnotationResolver("containerd", _CONTAINERD),
    "cri-o": AnnotationResolver("cri-o", _CRIO),
}


def resolver_for(runtime: str) -> AnnotationResolver | None:
    """Resolver by runtime name, None when the dialect is unknown
    (ref: NewResolver's ErrUnsupportedContainerRuntime)."""
    return _RESOLVERS.get(runtime)


def resolver_from_annotations(
        annotations: dict[str, str]) -> AnnotationResolver | None:
    """Detect the dialect from the annotations themselves
    (ref: NewResolverFromAnnotations)."""
    if annotations.get(_CRIO_MANAGER_KEY):
        return _RESOLVERS["cri-o"]
    if _CONTAINERD["type"] in annotations:
        return _RESOLVERS["containerd"]
    # a bundle can carry identity keys without the container-type stamp
    # (older containerd, partial annotation sets): any io.kubernetes.cri.*
    # key is containerd's prefix
    if any(k.startswith("io.kubernetes.cri.") for k in annotations):
        return _RESOLVERS["containerd"]
    # kubelet-label dialect without the cri-o manager stamp
    if any(k.startswith("io.kubernetes.pod.")
           or k == _CRIO["name"] for k in annotations):
        return _RESOLVERS["cri-o"]
    return None


def resolve_identity(
        annotations: dict[str, str]) -> ResolvedIdentity | None:
    """One-shot: detect dialect and resolve, None if neither dialect.

    Falls back per-field to the other dialect: real bundles mix key sets
    (containerd-prefixed sandbox keys alongside kubelet container-name
    labels), so locking every field to the detected dialect would drop
    identity the annotations actually carry.
    """
    r = resolver_from_annotations(annotations)
    if r is None:
        return None
    primary = r.resolve(annotations)
    other = _RESOLVERS["cri-o" if r.runtime == "containerd" else "containerd"]
    fallback = other.resolve(annotations)
    return ResolvedIdentity(
        runtime=primary.runtime,
        name=primary.name or fallback.name,
        pod=primary.pod or fallback.pod,
        namespace=primary.namespace or fallback.namespace,
        pod_uid=primary.pod_uid or fallback.pod_uid,
        container_type=primary.container_type or fallback.container_type,
    )
