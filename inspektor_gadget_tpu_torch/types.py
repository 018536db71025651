"""Core event model (ref: pkg/types/types.go:73-231).

CommonData carries node/namespace/pod/container identity on every event;
Event adds timestamp/type/message. Mixins mirror WithMountNsID/WithNetNsID.
All fields are declared as columns so every event type tensorizes to a
struct-of-arrays batch for the sketch plane (the port's copy of
``inspektor_gadget_tpu/types.py``).
"""

from __future__ import annotations

import dataclasses
import enum
import time

import numpy as np

from .columns import col


class EventType(str, enum.Enum):
    # ref: pkg/types/types.go EventType consts
    NORMAL = "normal"
    ERR = "err"
    WARN = "warn"
    DEBUG = "debug"
    INFO = "info"


@dataclasses.dataclass
class CommonData:
    """Node/workload identity (ref: types.go:73-110). The kubernetes tag
    hides these columns in local mode (ref: pkg/environment + column tags)."""

    node: str = col("", template="node", tags=("kubernetes",))
    namespace: str = col("", template="namespace", tags=("kubernetes",))
    pod: str = col("", template="pod", tags=("kubernetes",))
    container: str = col("", template="container", tags=("runtime",))
    host_network: bool = col(False, hide=True, dtype=np.bool_)


@dataclasses.dataclass
class Event(CommonData):
    """Base streaming event (ref: types.go:112-153)."""

    timestamp: int = col(0, template="timestamp", dtype=np.int64)
    type: str = col(EventType.NORMAL.value, hide=True)
    message: str = col("", hide=True)

    @classmethod
    def err(cls, msg: str, **kw) -> "Event":
        return cls(type=EventType.ERR.value, message=msg, **kw)

    @classmethod
    def warn(cls, msg: str, **kw) -> "Event":
        return cls(type=EventType.WARN.value, message=msg, **kw)


@dataclasses.dataclass
class WithMountNsID:
    """ref: types.go WithMountNsID — mntns id for container filtering."""

    mountnsid: int = col(0, template="ns", dtype=np.uint64)


@dataclasses.dataclass
class WithNetNsID:
    """ref: types.go WithNetNsID."""

    netnsid: int = col(0, template="ns", dtype=np.uint64)


def now_ns() -> int:
    return time.time_ns()
