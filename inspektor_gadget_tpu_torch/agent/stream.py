"""GadgetStream: pubsub with replay history and loss markers.

Reference contract: pkg/gadgettracermanager/stream/stream.go — 100-line
replay history for late subscribers (:22), 250-cap subscriber channels
(:23), an EventLost marker when a subscriber overruns, publish never
blocks.

The port's copy of ``inspektor_gadget_tpu/agent/stream.py``.
"""

from __future__ import annotations

import collections
import threading
from typing import Any

HISTORY_SIZE = 100      # ref: stream.go:22
SUBSCRIBER_CAP = 250    # ref: stream.go:23

LOST_MARKER = {"__lost__": True}


class _Subscriber:
    def __init__(self):
        self.queue: collections.deque = collections.deque()
        self.cond = threading.Condition()
        self.lost = False
        self.closed = False


class GadgetStream:
    def __init__(self):
        self._mu = threading.Lock()
        self._history: collections.deque = collections.deque(maxlen=HISTORY_SIZE)
        self._subs: dict[object, _Subscriber] = {}

    def publish(self, item: Any) -> None:
        with self._mu:
            self._history.append(item)
            subs = list(self._subs.values())
        for s in subs:
            with s.cond:
                if len(s.queue) >= SUBSCRIBER_CAP:
                    if not s.lost:
                        s.lost = True
                        s.queue.append(LOST_MARKER)
                    continue
                s.lost = False
                s.queue.append(item)
                s.cond.notify()

    def subscribe(self, key: object, replay: bool = True) -> _Subscriber:
        s = _Subscriber()
        with self._mu:
            if replay:
                s.queue.extend(self._history)
            self._subs[key] = s
        return s

    def unsubscribe(self, key: object) -> None:
        with self._mu:
            s = self._subs.pop(key, None)
        if s is not None:
            with s.cond:
                s.closed = True
                s.cond.notify()

    @staticmethod
    def next_item(sub: _Subscriber, timeout: float = 1.0):
        """Blocking pop; returns (item, ok)."""
        with sub.cond:
            if not sub.queue and not sub.closed:
                sub.cond.wait(timeout)
            if sub.queue:
                return sub.queue.popleft(), True
            return None, not sub.closed
