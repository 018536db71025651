"""TracerCollection: per-tracer container filters kept live via pubsub.

Reference contract: pkg/tracer-collection/tracer-collection.go —
AddTracer(id, selector) creates a per-tracer mntns BPF hash map :100-134;
TracerMapsUpdater keeps it in sync on container add/remove :64-98;
TracerMountNsMap :193 hands the map to the gadget. Max 1024 traced
containers (:29). Here the "map" is a set of mntns ids handed to sources
via MountNsFilterSetter — same gating, applied at the capture rim.

The port's copy of ``inspektor_gadget_tpu/containers/tracer_collection.py``.
"""

from __future__ import annotations

import threading

from .collection import ContainerCollection, EventType, PubSubEvent
from .container import ContainerSelector

MAX_CONTAINERS_PER_TRACER = 1024  # ref: tracer-collection.go:29


class TracerCollection:
    def __init__(self, cc: ContainerCollection, test_only: bool = False):
        """test_only mirrors NewTracerCollectionTest (tracer-collection.go:
        56-62): skip live wiring, filters still computable."""
        self._cc = cc
        self._mu = threading.Lock()
        self._tracers: dict[str, dict] = {}
        self._test_only = test_only
        if not test_only:
            cc.subscribe(self, self._on_event)

    def close(self) -> None:
        if not self._test_only:
            self._cc.unsubscribe(self)

    def add_tracer(self, tracer_id: str, selector: ContainerSelector) -> None:
        with self._mu:
            if tracer_id in self._tracers:
                raise ValueError(f"tracer {tracer_id!r} already exists")
            mntns: set[int] = set()
            for c in self._cc.get_all(selector):
                if c.mntns and len(mntns) < MAX_CONTAINERS_PER_TRACER:
                    mntns.add(c.mntns)
            self._tracers[tracer_id] = {"selector": selector, "mntns": mntns}

    def remove_tracer(self, tracer_id: str) -> None:
        with self._mu:
            self._tracers.pop(tracer_id, None)

    def tracer_mntns_set(self, tracer_id: str) -> set[int]:
        """The filter handed to sources (ref: TracerMountNsMap :193)."""
        with self._mu:
            t = self._tracers.get(tracer_id)
            if t is None:
                raise KeyError(f"unknown tracer {tracer_id!r}")
            return set(t["mntns"])

    def tracer_count(self) -> int:
        with self._mu:
            return len(self._tracers)

    def _on_event(self, ev: PubSubEvent) -> None:
        """ref: TracerMapsUpdater :64-98."""
        with self._mu:
            for t in self._tracers.values():
                if not t["selector"].matches(ev.container):
                    continue
                if ev.type == EventType.ADD and ev.container.mntns:
                    if len(t["mntns"]) < MAX_CONTAINERS_PER_TRACER:
                        t["mntns"].add(ev.container.mntns)
                elif ev.type == EventType.REMOVE:
                    t["mntns"].discard(ev.container.mntns)
