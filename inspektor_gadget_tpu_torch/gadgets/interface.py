"""Gadget descriptor + capability protocols.

Reference contract: pkg/gadgets/interface.go:22-166 — GadgetDesc (Name,
Category, Type, Description, ParamDescs, Parser, EventPrototype) plus
optional capability interfaces discovered via type assertion
(EventHandlerSetter, EventHandlerArraySetter, EventEnricherSetter,
MountNsMapSetter via operators, Attacher, RunGadget/RunWithResultGadget).
Python analogue: runtime-checkable Protocols + isinstance checks, exactly
the role Go's implicit interface satisfaction plays there.

Beyond the reference's interfaces, gadgets may implement `emit_batches` (struct-of-arrays
EventBatch stream) instead of/in addition to per-event emission; the sketch
operator and the agent transport consume batches, the formatter path
consumes rows.

The port's copy of ``inspektor_gadget_tpu/gadgets/interface.py``.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Protocol, runtime_checkable

from ..columns import Columns
from ..params import ParamDescs


class GadgetType(str, enum.Enum):
    # ref: interface.go GadgetType consts {trace, traceIntervals, oneShot, profile}
    TRACE = "trace"
    TRACE_INTERVALS = "traceIntervals"
    ONE_SHOT = "oneShot"
    PROFILE = "profile"
    # legacy CRD-path gadgets (advise/traceloop) run start..stop then generate
    START_STOP = "startStop"


class GadgetDesc:
    """Base descriptor; subclasses override the class attributes."""

    name: str = ""
    category: str = ""
    gadget_type: GadgetType = GadgetType.TRACE
    description: str = ""
    event_cls: type | None = None

    def params(self) -> ParamDescs:
        return ParamDescs()

    def columns(self) -> Columns | None:
        return Columns(self.event_cls) if self.event_cls is not None else None

    def output_formats(self) -> tuple[str, ...]:
        return ("columns", "json")

    def new_instance(self, ctx: "GadgetContext") -> "Gadget":  # noqa: F821
        raise NotImplementedError

    @property
    def full_name(self) -> str:
        return f"{self.category}/{self.name}"


@runtime_checkable
class Gadget(Protocol):
    """A live gadget instance. run() blocks until ctx is done."""

    def run(self, ctx: "GadgetContext") -> None: ...  # noqa: F821


@runtime_checkable
class EventHandlerSetter(Protocol):
    """ref: interface.go EventHandlerSetter — streaming per-event callback."""

    def set_event_handler(self, handler: Callable[[Any], None]) -> None: ...


@runtime_checkable
class EventHandlerArraySetter(Protocol):
    """ref: interface.go EventHandlerArraySetter — interval array callback."""

    def set_event_handler_array(
        self, handler: Callable[[list[Any]], None]
    ) -> None: ...


@runtime_checkable
class BatchHandlerSetter(Protocol):
    """The device path: struct-of-arrays batch callback (EventBatch)."""

    def set_batch_handler(self, handler: Callable[[Any], None]) -> None: ...


@runtime_checkable
class MountNsFilterSetter(Protocol):
    """ref: tracer SetMountNsMap (pkg/gadgets/trace/exec/tracer/tracer.go:
    SetMountNsMap) — the container-filter injection point. Here a set of
    mntns ids (the BPF-map analogue) applied source-side."""

    def set_mntns_filter(self, mntns_ids: set[int] | None) -> None: ...


@runtime_checkable
class Attacher(Protocol):
    """ref: operators/localmanager.go:46 Attacher — per-container attach
    for netns-scoped gadgets (dns/sni/network)."""

    def attach_container(self, container: Any) -> None: ...

    def detach_container(self, container: Any) -> None: ...


@runtime_checkable
class RunWithResult(Protocol):
    """ref: interface.go RunWithResultGadget — profile-style gadgets return
    a final rendered result instead of streaming."""

    def run_with_result(self, ctx: "GadgetContext") -> bytes: ...  # noqa: F821
