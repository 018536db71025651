"""ContainerCollection: authoritative container set + pubsub + enrichment.

Reference contract: pkg/container-collection/container-collection.go —
struct :39-72 (containers map, pubsub, enrichers, cleanedUpContainers cache,
initial-detection flag), Initialize(options...) :81-116, the 2s removal
cache absorbing late events :147, EnrichByMntNs :351. Pubsub fan-out:
pubsub.go (subscribe returns current set atomically with the subscription).

The port's copy of ``inspektor_gadget_tpu/containers/collection.py``.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Callable

from .container import Container, ContainerSelector


class EventType(str, enum.Enum):
    ADD = "add"
    REMOVE = "remove"


@dataclasses.dataclass
class PubSubEvent:
    type: EventType
    container: Container


REMOVED_CACHE_TTL = 2.0  # s — ref: options.go:689 enrichment grace window


class ContainerCollection:
    def __init__(self):
        self._mu = threading.RLock()
        self._containers: dict[str, Container] = {}
        self._by_mntns: dict[int, Container] = {}
        self._by_netns: dict[int, list[Container]] = {}
        self._removed: dict[int, tuple[float, Container]] = {}  # mntns → (t, c)
        self._last_gc = 0.0
        self._subs: dict[object, Callable[[PubSubEvent], None]] = {}
        self._enrichers: list[Callable[[Container], bool]] = []
        self._initialized = False
        self.node_name = ""

    # -- initialization (ref: Initialize + functional options :81-116) ------

    def initialize(self, *options: Callable[["ContainerCollection"], None]) -> None:
        """Apply options in order. An option may return a callable: those
        run after ALL options are applied — discovery/seeding phases use
        this so every enricher is installed before the first add_container
        (ref: options are pure setup in options.go; initial-container
        seeding happens once the collection is fully assembled)."""
        post: list[Callable[[], None]] = []
        with self._mu:
            if self._initialized:
                raise RuntimeError("ContainerCollection already initialized")
            for opt in options:
                r = opt(self)
                if callable(r):
                    post.append(r)
            self._initialized = True
        for fn in post:
            fn()

    def add_enricher(self, fn: Callable[[Container], bool]) -> None:
        """Enrichers run on every added container; returning False drops it
        (ref: container-collection.go enrichers chain)."""
        self._enrichers.append(fn)

    # -- mutation -----------------------------------------------------------

    def add_container(self, c: Container) -> None:
        with self._mu:
            for enrich in self._enrichers:
                if not enrich(c):
                    return
            if c.id in self._containers:
                return
            self._containers[c.id] = c
            if c.mntns:
                self._by_mntns[c.mntns] = c
            if c.netns:
                self._by_netns.setdefault(c.netns, []).append(c)
            subs = list(self._subs.values())
        ev = PubSubEvent(EventType.ADD, c)
        for fn in subs:
            fn(ev)

    def remove_container(self, container_id: str) -> None:
        with self._mu:
            c = self._containers.pop(container_id, None)
            if c is None:
                return
            if c.mntns:
                self._by_mntns.pop(c.mntns, None)
                # keep for late enrichment (ref: 2s cleanup cache :147)
                self._removed[c.mntns] = (time.monotonic(), c)
            if c.netns and c.netns in self._by_netns:
                self._by_netns[c.netns] = [
                    x for x in self._by_netns[c.netns] if x.id != c.id
                ]
            subs = list(self._subs.values())
        ev = PubSubEvent(EventType.REMOVE, c)
        for fn in subs:
            fn(ev)

    def _gc_removed(self) -> None:
        # amortized: this runs on EVERY lookup miss (the display hot loop
        # when no container matches) — a full sweep per event would cost
        # more than the lookup itself
        now = time.monotonic()
        if now - self._last_gc < 0.5:
            return
        self._last_gc = now
        stale = [k for k, (t, _) in self._removed.items() if now - t > REMOVED_CACHE_TTL]
        for k in stale:
            del self._removed[k]

    # -- lookup -------------------------------------------------------------

    def get(self, container_id: str) -> Container | None:
        with self._mu:
            return self._containers.get(container_id)

    def get_all(self, selector: ContainerSelector | None = None) -> list[Container]:
        with self._mu:
            cs = list(self._containers.values())
        if selector is None:
            return cs
        return [c for c in cs if selector.matches(c)]

    def lookup_by_mntns(self, mntns: int) -> Container | None:
        with self._mu:
            c = self._by_mntns.get(mntns)
            if c is not None:
                return c
            self._gc_removed()
            entry = self._removed.get(mntns)
            # TTL checked at hit time: the sweep above is amortized, so an
            # entry can outlive its window on disk but must not be served
            if entry and time.monotonic() - entry[0] <= REMOVED_CACHE_TTL:
                return entry[1]
            return None

    def lookup_by_netns(self, netns: int) -> list[Container]:
        with self._mu:
            return list(self._by_netns.get(netns, ()))

    def __len__(self) -> int:
        with self._mu:
            return len(self._containers)

    # -- pubsub (ref: pubsub.go; Subscribe returns the current set) ---------

    def subscribe(
        self, key: object, fn: Callable[[PubSubEvent], None]
    ) -> list[Container]:
        with self._mu:
            self._subs[key] = fn
            return list(self._containers.values())

    def unsubscribe(self, key: object) -> None:
        with self._mu:
            self._subs.pop(key, None)

    # -- event enrichment (ref: EnrichByMntNs :351, EnrichByNetNs :366) -----

    def enrich_event_by_mntns(self, event) -> None:
        mntns = getattr(event, "mountnsid", 0)
        if not mntns:
            return
        c = self.lookup_by_mntns(mntns)
        if c is not None:
            event.container = c.name
            event.pod = c.pod
            event.namespace = c.namespace
        if self.node_name and not event.node:
            event.node = self.node_name
