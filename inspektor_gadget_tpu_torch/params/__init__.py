"""Self-describing param system (ref: pkg/params, ~1295 LoC).

One typed flag/config system shared by gadgets, operators, and runtimes:
ParamDesc describes a parameter (key, alias, default, validator, type hint,
value hint); ParamDescs materialize into Params holding live values; a
Collection maps prefixes ("operator.<name>.", "runtime.") to Params and
round-trips through a flat string map over the wire — the exact catalog/gRPC
contract of the reference (params.go:42-96; serialization in
pkg/gadget-service/service.go:112-131).

The port's copy of ``inspektor_gadget_tpu/params``.
"""

from .params import (
    Param,
    ParamDesc,
    ParamDescs,
    Params,
    Collection,
    TypeHint,
    ValueHint,
    ParamError,
)
from .validators import (
    validate_int_range,
    validate_one_of,
    validate_duration,
    parse_duration,
)

__all__ = [
    "Param",
    "ParamDesc",
    "ParamDescs",
    "Params",
    "Collection",
    "TypeHint",
    "ValueHint",
    "ParamError",
    "validate_int_range",
    "validate_one_of",
    "validate_duration",
    "parse_duration",
]
