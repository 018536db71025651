"""Column registry built from dataclass field metadata.

Reference contract: pkg/columns/columninfo.go:43-66 (per-column attributes:
name, width, alignment, visible, ellipsis, fixed, precision, group verb,
template, order) and pkg/columns/columns.go:40-79 (MustCreateColumns builds
the registry via struct-tag reflection). Templates mirror
pkg/columns/templates.go + their use in pkg/types/types.go:31-50.

The port's copy of ``inspektor_gadget_tpu/columns/columns.py``. Every
column carries a numpy dtype so a batch of events lowers to a
struct-of-arrays dict ready for the device's ingest; strings lower to
FNV-1a uint64 hashes (with an optional host-side vocab for un-hashing heavy
hitters back to names).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Templates (ref: pkg/columns/templates.go; registered in pkg/types/types.go)
# ---------------------------------------------------------------------------

_TEMPLATES: dict[str, dict[str, Any]] = {}


def register_template(name: str, **attrs: Any) -> None:
    """Register a reusable column attribute template (ref: MustRegisterTemplate)."""
    if name in _TEMPLATES:
        raise ValueError(f"column template {name!r} already registered")
    _TEMPLATES[name] = dict(attrs)


def get_template(name: str) -> dict[str, Any]:
    return dict(_TEMPLATES[name])


def _register_builtin_templates() -> None:
    # ref: pkg/types/types.go:31-50 registers timestamp/node/pod/container/
    # comm/pid widths as templates shared by every gadget.
    for name, attrs in {
        "timestamp": dict(width=35, align="left", ellipsis="end", hide=True),
        "node": dict(width=30, align="left", ellipsis="middle"),
        "namespace": dict(width=30, align="left"),
        "pod": dict(width=30, align="left", ellipsis="middle"),
        "container": dict(width=30, align="left"),
        "comm": dict(width=16, align="left"),
        "pid": dict(width=7, align="right", dtype=np.int32),
        "uid": dict(width=8, align="right", dtype=np.int32),
        "ns": dict(width=12, align="right", hide=True, dtype=np.uint64),
        "ipaddr": dict(width=40, align="left"),
        "ipport": dict(width=7, align="right", dtype=np.int32),
        "ipversion": dict(width=2, align="right", dtype=np.int8),
        "syscall": dict(width=18, align="left"),
    }.items():
        register_template(name, **attrs)


_VALID_ALIGN = ("left", "right")
_VALID_ELLIPSIS = ("none", "start", "middle", "end")
_VALID_GROUP = (None, "sum", "max", "min")


@dataclasses.dataclass
class Column:
    """Metadata for one typed column (ref: columninfo.go:43-66)."""

    name: str
    field: str
    dtype: np.dtype
    is_string: bool = False
    width: int = 16
    min_width: int = 1
    align: str = "left"
    visible: bool = True
    ellipsis: str = "end"
    fixed: bool = False
    precision: int = 2
    group: str | None = None
    order: int = 0
    template: str | None = None
    description: str = ""
    extractor: Callable[[Any], Any] | None = None
    tags: tuple[str, ...] = ()

    def value(self, event: Any) -> Any:
        if self.extractor is not None:
            return self.extractor(event)
        obj = event
        for part in self.field.split("."):
            obj = getattr(obj, part) if not isinstance(obj, Mapping) else obj[part]
        return obj

    def format_value(self, v: Any) -> str:
        if v is None:
            return ""
        if isinstance(v, float):
            return f"{v:.{self.precision}f}"
        if isinstance(v, bool):
            return "true" if v else "false"
        return str(v)


def col(
    default: Any = dataclasses.MISSING,
    *,
    name: str | None = None,
    width: int | None = None,
    align: str | None = None,
    visible: bool | None = None,
    hide: bool | None = None,
    ellipsis: str | None = None,
    fixed: bool | None = None,
    precision: int | None = None,
    group: str | None = None,
    order: int | None = None,
    template: str | None = None,
    description: str | None = None,
    dtype: Any = None,
    extractor: Callable[[Any], Any] | None = None,
    tags: Sequence[str] = (),
    default_factory: Any = dataclasses.MISSING,
) -> Any:
    """Declare a dataclass field as a column (the struct-tag analogue,
    ref: columns.go:40-79 parses `column:"name,width:16,align:right"` tags)."""
    meta: dict[str, Any] = {}
    for key, val in (
        ("name", name),
        ("width", width),
        ("align", align),
        ("visible", visible),
        ("hide", hide),
        ("ellipsis", ellipsis),
        ("fixed", fixed),
        ("precision", precision),
        ("group", group),
        ("order", order),
        ("template", template),
        ("description", description),
        ("dtype", dtype),
        ("extractor", extractor),
    ):
        if val is not None:
            meta[key] = val
    if tags:
        meta["tags"] = tuple(tags)
    kwargs: dict[str, Any] = {"metadata": {"column": meta}}
    if default_factory is not dataclasses.MISSING:
        kwargs["default_factory"] = default_factory
    elif default is not dataclasses.MISSING:
        kwargs["default"] = default
    return dataclasses.field(**kwargs)


_PY_DTYPES: dict[type, np.dtype] = {
    int: np.dtype(np.int64),
    float: np.dtype(np.float32),
    bool: np.dtype(np.bool_),
}

FNV_OFFSET = np.uint64(0xCBF29CE484222325)
FNV_PRIME = np.uint64(0x100000001B3)


def fnv1a64(s: str | bytes) -> int:
    """FNV-1a 64-bit hash — the canonical string→uint64 key lowering."""
    if isinstance(s, str):
        s = s.encode("utf-8", "replace")
    h = 0xCBF29CE484222325
    for b in s:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class Columns:
    """Registry of columns for one event type (ref: pkg/columns/columns.go)."""

    def __init__(self, event_cls: type):
        if not dataclasses.is_dataclass(event_cls):
            raise TypeError(f"{event_cls!r} is not a dataclass")
        self.event_cls = event_cls
        self._columns: dict[str, Column] = {}
        # bumped on every visibility/order change so consumers caching a
        # compiled per-column layout (TextFormatter._fast) can invalidate
        # with one int compare per row
        self.layout_version = 0
        order = 0
        for f in dataclasses.fields(event_cls):
            meta = f.metadata.get("column")
            if meta is None:
                continue
            attrs: dict[str, Any] = {}
            template = meta.get("template")
            if template is not None:
                attrs.update(get_template(template))
            attrs.update(meta)
            name = attrs.pop("name", f.name).lower()
            if name in self._columns:
                raise ValueError(f"duplicate column {name!r}")
            hide = attrs.pop("hide", False)
            visible = attrs.pop("visible", not hide)
            # PEP 563 makes f.type a string; resolve the common scalars
            py_type = f.type if isinstance(f.type, type) else {
                "int": int, "float": float, "bool": bool, "str": str,
            }.get(f.type)
            dtype = attrs.pop("dtype", None)
            is_string = False
            if dtype is None:
                if py_type in _PY_DTYPES:
                    dtype = _PY_DTYPES[py_type]
                else:
                    # str fields and unresolved annotations lower to hashes
                    is_string = True
                    dtype = np.dtype(np.uint64)
            else:
                dtype = np.dtype(dtype)
            if py_type is str:
                is_string = True
                dtype = np.dtype(np.uint64)
            align = attrs.pop("align", "right" if not is_string else "left")
            if align not in _VALID_ALIGN:
                raise ValueError(f"column {name!r}: bad align {align!r}")
            ellipsis = attrs.pop("ellipsis", "end")
            if ellipsis not in _VALID_ELLIPSIS:
                raise ValueError(f"column {name!r}: bad ellipsis {ellipsis!r}")
            group = attrs.pop("group", None)
            if group not in _VALID_GROUP:
                raise ValueError(f"column {name!r}: bad group verb {group!r}")
            order = attrs.pop("order", order + 10)
            self._columns[name] = Column(
                name=name,
                field=f.name,
                dtype=dtype,
                is_string=is_string,
                width=attrs.pop("width", 16),
                align=align,
                visible=visible,
                ellipsis=ellipsis,
                fixed=attrs.pop("fixed", False),
                precision=attrs.pop("precision", 2),
                group=group,
                order=order,
                template=template,
                description=attrs.pop("description", ""),
                extractor=attrs.pop("extractor", None),
                tags=tuple(attrs.pop("tags", ())),
            )

    # -- lookup ------------------------------------------------------------

    def get(self, name: str) -> Column:
        try:
            return self._columns[name.lower()]
        except KeyError:
            raise KeyError(f"unknown column {name!r}") from None

    def has(self, name: str) -> bool:
        return name.lower() in self._columns

    def all(self) -> list[Column]:
        return sorted(self._columns.values(), key=lambda c: c.order)

    def visible(self) -> list[Column]:
        return [c for c in self.all() if c.visible]

    def names(self, visible_only: bool = True) -> list[str]:
        cols = self.visible() if visible_only else self.all()
        return [c.name for c in cols]

    def hide_tagged(self, tags: Sequence[str]) -> None:
        """Hide columns carrying any of `tags` (ref: pkg/environment-driven
        visibility of kubernetes columns in local mode)."""
        tagset = set(tags)
        for c in self._columns.values():
            if tagset & set(c.tags):
                c.visible = False
        self.layout_version += 1

    def set_visible(self, names: Sequence[str]) -> None:
        """Show exactly `names`, in that order (ref: -o columns=... handling
        in pkg/columns/formatter/textcolumns/textcolumns.go)."""
        wanted = [n.lower() for n in names]
        for c in self._columns.values():
            c.visible = c.name in wanted
        for i, n in enumerate(wanted):
            self.get(n).order = i
        self.layout_version += 1

    # -- row access --------------------------------------------------------

    def row_values(self, event: Any, visible_only: bool = True) -> list[Any]:
        cols = self.visible() if visible_only else self.all()
        return [c.value(event) for c in cols]

    def to_dict(self, event: Any) -> dict[str, Any]:
        return {c.name: c.value(event) for c in self.all()}

    def to_json(self, event: Any) -> str:
        return json.dumps(self.to_dict(event), default=str, separators=(",", ":"))

    def from_dict(self, d: Mapping[str, Any]) -> Any:
        """Rebuild an event from a JSON dict (the remote-event decode path,
        ref: pkg/parser/parser.go JSON handlers)."""
        field_names = {f.name for f in dataclasses.fields(self.event_cls)}
        kwargs = {k: v for k, v in d.items() if k in field_names}
        return self.event_cls(**kwargs)

    # -- tensorization (the device ingest contract) -------------------------------

    def tensorize(
        self,
        events: Iterable[Any],
        vocab: dict[int, str] | None = None,
    ) -> dict[str, np.ndarray]:
        """Lower events to a struct-of-arrays batch: one 1-D numpy array per
        column. String columns become FNV-1a uint64 hashes; pass `vocab` to
        collect hash→string reverse mappings for heavy-hitter display."""
        rows = list(events)
        out: dict[str, np.ndarray] = {}
        for c in self.all():
            if c.is_string:
                vals = np.empty(len(rows), dtype=np.uint64)
                for i, ev in enumerate(rows):
                    s = c.value(ev)
                    s = "" if s is None else str(s)
                    h = fnv1a64(s)
                    vals[i] = h
                    if vocab is not None:
                        vocab[h] = s
                out[c.name] = vals
            else:
                out[c.name] = np.asarray(
                    [c.value(ev) for ev in rows], dtype=c.dtype
                )
        return out

    def batch_dtype(self) -> dict[str, np.dtype]:
        return {c.name: c.dtype for c in self.all()}


_register_builtin_templates()
