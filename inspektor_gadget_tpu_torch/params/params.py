"""Param descriptors, live params, and prefixed collections.

Reference contract (pkg/params/params.go:42-96):
  ParamDesc{Key, Alias, Title, DefaultValue, Description, IsMandatory,
            Tags, Validator, TypeHint, ValueHint, PossibleValues}
  ParamDescs.ToParams() → Params; Params.CopyFromMap/CopyToMap(prefix);
  Collection keyed by prefix. Values travel as strings and are parsed at the
  typed getters, so the same descriptor drives CLI flags, catalogs, and the
  wire format.

The port's copy of ``inspektor_gadget_tpu/params/params.py``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Iterable, Iterator, Mapping

from .validators import parse_duration


class ParamError(ValueError):
    pass


class TypeHint(str, enum.Enum):
    STRING = "string"
    BOOL = "bool"
    INT = "int"
    UINT = "uint"
    FLOAT = "float"
    DURATION = "duration"
    IP = "ip"


class ValueHint(str, enum.Enum):
    """Frontend hints so clients can inject environment defaults
    (ref: ValueHint usage in cmd/kubectl-gadget/main.go:64-65)."""

    NODE_NAME = "node-name"
    K8S_NAMESPACE = "k8s-namespace"
    K8S_PODNAME = "k8s-podname"
    K8S_CONTAINERNAME = "k8s-containername"
    CONTAINER_NAME = "container-name"
    FILE_PATH = "file-path"
    MESH_AXIS = "mesh-axis"


_TRUE = {"true", "1", "yes", "on"}
_FALSE = {"false", "0", "no", "off", ""}


@dataclasses.dataclass
class ParamDesc:
    key: str
    default: str = ""
    description: str = ""
    alias: str = ""
    title: str = ""
    is_mandatory: bool = False
    tags: tuple[str, ...] = ()
    validator: Callable[[str], None] | None = None
    type_hint: TypeHint = TypeHint.STRING
    value_hint: ValueHint | None = None
    possible_values: tuple[str, ...] = ()

    def to_param(self) -> "Param":
        return Param(desc=self, value=self.default)


class Param:
    def __init__(self, desc: ParamDesc, value: str):
        self.desc = desc
        self._value = value

    @property
    def key(self) -> str:
        return self.desc.key

    @property
    def value(self) -> str:
        return self._value

    def set(self, value: str) -> None:
        if not isinstance(value, str):
            value = _to_wire(value)
        self.validate(value)
        self._value = value

    def validate(self, value: str | None = None) -> None:
        v = self._value if value is None else value
        if self.desc.is_mandatory and v == "":
            raise ParamError(f"param {self.key!r} is mandatory")
        if self.desc.possible_values and v not in self.desc.possible_values:
            raise ParamError(
                f"param {self.key!r}: {v!r} not in {list(self.desc.possible_values)}"
            )
        if self.desc.validator is not None and v != "":
            try:
                self.desc.validator(v)
            except ValueError as e:
                raise ParamError(f"param {self.key!r}: {e}") from None
        if v != "":
            try:
                _parse_typed(v, self.desc.type_hint)
            except ValueError as e:
                raise ParamError(f"param {self.key!r}: {e}") from None

    # typed getters -------------------------------------------------------

    def as_string(self) -> str:
        return self._value

    def as_bool(self) -> bool:
        v = self._value.lower()
        if v in _TRUE:
            return True
        if v in _FALSE:
            return False
        raise ParamError(f"param {self.key!r}: {self._value!r} is not a bool")

    def as_int(self) -> int:
        return int(self._value or "0")

    def as_uint(self) -> int:
        v = int(self._value or "0")
        if v < 0:
            raise ParamError(f"param {self.key!r}: {v} is negative")
        return v

    def as_float(self) -> float:
        return float(self._value or "0")

    def as_duration(self) -> float:
        return parse_duration(self._value) if self._value else 0.0

    def get(self) -> Any:
        return _parse_typed(self._value, self.desc.type_hint)


def _parse_typed(value: str, hint: TypeHint) -> Any:
    if hint == TypeHint.BOOL:
        v = value.lower()
        if v in _TRUE:
            return True
        if v in _FALSE:
            return False
        raise ValueError(f"{value!r} is not a bool")
    if hint == TypeHint.INT:
        return int(value or "0")
    if hint == TypeHint.UINT:
        v = int(value or "0")
        if v < 0:
            raise ValueError(f"{v} is negative")
        return v
    if hint == TypeHint.FLOAT:
        return float(value or "0")
    if hint == TypeHint.DURATION:
        return parse_duration(value) if value else 0.0
    return value


def _to_wire(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


class ParamDescs(list):
    """Ordered list of ParamDesc (ref: params.go ParamDescs)."""

    def to_params(self) -> "Params":
        return Params(self)

    def get(self, key: str) -> ParamDesc:
        for d in self:
            if d.key == key:
                return d
        raise KeyError(key)


class Params:
    def __init__(self, descs: Iterable[ParamDesc] = ()):  # noqa: D107
        self._params: dict[str, Param] = {}
        for d in descs:
            self.add(d.to_param())

    def add(self, param: Param) -> None:
        self._params[param.key] = param

    def get(self, key: str) -> Param:
        try:
            return self._params[key]
        except KeyError:
            raise KeyError(f"unknown param {key!r}") from None

    def __contains__(self, key: str) -> bool:
        return key in self._params

    def __iter__(self) -> Iterator[Param]:
        return iter(self._params.values())

    def __len__(self) -> int:
        return len(self._params)

    def set(self, key: str, value: Any) -> None:
        self.get(key).set(value)

    def validate(self) -> None:
        for p in self._params.values():
            p.validate()

    # wire format ---------------------------------------------------------

    def copy_from_map(self, m: Mapping[str, str], prefix: str = "") -> None:
        """Apply values whose keys carry `prefix` (ref: params.go CopyFromMap;
        used server-side in gadget-service/service.go:112-131)."""
        for k, v in m.items():
            if k.startswith(prefix):
                key = k[len(prefix):]
                if key in self._params:
                    self._params[key].set(v)

    def copy_to_map(self, m: dict[str, str] | None = None, prefix: str = "") -> dict[str, str]:
        if m is None:
            m = {}
        for p in self._params.values():
            m[prefix + p.key] = p.value
        return m

    def to_descs_json(self) -> list[dict]:
        """Catalog serialization so remote clients can render flags
        (ref: pkg/runtime/catalog.go)."""
        return [
            {
                "key": p.desc.key,
                "default": p.desc.default,
                "description": p.desc.description,
                "alias": p.desc.alias,
                "isMandatory": p.desc.is_mandatory,
                "typeHint": p.desc.type_hint.value,
                "valueHint": p.desc.value_hint.value if p.desc.value_hint else "",
                "possibleValues": list(p.desc.possible_values),
                "tags": list(p.desc.tags),
            }
            for p in self._params.values()
        ]


def descs_from_json(items: list[dict]) -> ParamDescs:
    descs = ParamDescs()
    for it in items:
        descs.append(
            ParamDesc(
                key=it["key"],
                default=it.get("default", ""),
                description=it.get("description", ""),
                alias=it.get("alias", ""),
                is_mandatory=it.get("isMandatory", False),
                type_hint=TypeHint(it.get("typeHint", "string")),
                value_hint=ValueHint(it["valueHint"]) if it.get("valueHint") else None,
                possible_values=tuple(it.get("possibleValues", ())),
                tags=tuple(it.get("tags", ())),
            )
        )
    return descs


class Collection(dict):
    """prefix → Params (ref: params.go Collection; prefixes like
    "operator.localmanager.", "runtime.", "gadget.")."""

    def copy_from_map(self, m: Mapping[str, str]) -> None:
        for prefix, params in self.items():
            params.copy_from_map(m, prefix)

    def copy_to_map(self) -> dict[str, str]:
        out: dict[str, str] = {}
        for prefix, params in self.items():
            params.copy_to_map(out, prefix)
        return out

    def validate(self) -> None:
        for params in self.values():
            params.validate()
