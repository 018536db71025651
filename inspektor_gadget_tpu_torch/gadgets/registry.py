"""Global gadget registry (ref: pkg/gadget-registry/gadget-registry.go).

category/name → GadgetDesc. The CLI command tree, agent catalogs, and
runtimes all read from here.

The port's copy of ``inspektor_gadget_tpu/gadgets/registry.py``.
"""

from __future__ import annotations

from .interface import GadgetDesc

_REGISTRY: dict[tuple[str, str], GadgetDesc] = {}


def register(desc: GadgetDesc | type) -> GadgetDesc | type:
    """Register a descriptor; usable as a class decorator (returns the
    argument unchanged, stores an instance)."""
    inst = desc() if isinstance(desc, type) else desc
    key = (inst.category, inst.name)
    if key in _REGISTRY:
        raise ValueError(f"gadget {inst.category}/{inst.name} already registered")
    _REGISTRY[key] = inst
    return desc


def get(category: str, name: str) -> GadgetDesc:
    try:
        return _REGISTRY[(category, name)]
    except KeyError:
        raise KeyError(f"unknown gadget {category}/{name}") from None


def get_all() -> list[GadgetDesc]:
    return sorted(_REGISTRY.values(), key=lambda d: (d.category, d.name))


def categories() -> dict[str, list[GadgetDesc]]:
    out: dict[str, list[GadgetDesc]] = {}
    for d in get_all():
        out.setdefault(d.category, []).append(d)
    return out


def clear() -> None:
    """Test helper."""
    _REGISTRY.clear()
