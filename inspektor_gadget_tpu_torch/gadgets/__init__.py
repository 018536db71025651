"""Gadget framework core (ref: pkg/gadgets, pkg/gadget-registry,
pkg/gadget-context).

A gadget is a typed event source + its descriptor. Capability protocols
mirror the reference's optional interfaces (pkg/gadgets/interface.go:41-166):
event handlers, enricher injection, mount-ns filtering, per-container
attach, run-with-result. The registry is the global catalog the CLI and
agents build their command trees from (pkg/gadget-registry).

The port's copy of ``inspektor_gadget_tpu/gadgets``: the framework core,
`interval_gadget`, `source_gadget`, ``trace/exec`` and ``top/sketch``.
"""

from .interface import (
    GadgetType,
    GadgetDesc,
    Gadget,
    EventHandlerSetter,
    EventHandlerArraySetter,
    MountNsFilterSetter,
    Attacher,
    RunWithResult,
)
from .registry import register, get, get_all, categories, clear as registry_clear
from .context import GadgetContext

__all__ = [
    "GadgetType", "GadgetDesc", "Gadget",
    "EventHandlerSetter", "EventHandlerArraySetter", "MountNsFilterSetter",
    "Attacher", "RunWithResult",
    "register", "get", "get_all", "categories", "registry_clear",
    "GadgetContext",
]
