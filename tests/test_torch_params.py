"""The port's params layer (`inspektor_gadget_tpu_torch.params` and the
tpusketch operator's instance params) against the reference's.

One table of param descriptors and values goes through both packages:
defaults, typed conversions, flat wire maps and error messages must be
the same. The two tpusketch operators must have the same 38 instance
params, and accept and reject the same values with the same message;
`SketchConfig.validate` (the route that builds an instance without the
framework) must give that message too.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
from inspektor_gadget_tpu import params as RP
from inspektor_gadget_tpu.operators.operators import get as ref_get_op
from inspektor_gadget_tpu_torch import params as PP
from inspektor_gadget_tpu_torch.operators import tpusketch as P

torch.set_num_threads(2)


def _descs(mod):
    """One ParamDescs of every type hint, validator and possible-value set."""
    return mod.ParamDescs([
        mod.ParamDesc(key="name", default="x", description="a string"),
        mod.ParamDesc(key="flag", default="false", type_hint=mod.TypeHint.BOOL),
        mod.ParamDesc(key="count", default="8", type_hint=mod.TypeHint.INT,
                      validator=mod.validate_int_range(1, 64)),
        mod.ParamDesc(key="size", default="3", type_hint=mod.TypeHint.UINT),
        mod.ParamDesc(key="ratio", default="0.5", type_hint=mod.TypeHint.FLOAT),
        mod.ParamDesc(key="every", default="1m30s", type_hint=mod.TypeHint.DURATION),
        mod.ParamDesc(key="mode", default="a", possible_values=("a", "b")),
        mod.ParamDesc(key="must", default="y", is_mandatory=True),
        mod.ParamDesc(key="pick", default="p", validator=mod.validate_one_of(("p", "q"))),
        mod.ParamDesc(key="wait", default="", validator=mod.validate_duration),
    ])


def _answer(mod, key, value):
    """(error message or None, the typed getters after the set)."""
    params = _descs(mod).to_params()
    try:
        params.set(key, value)
    except mod.ParamError as e:
        return str(e), None
    p = params.get(key)
    conv = {}
    for getter in ("as_string", "as_bool", "as_int", "as_uint", "as_float", "as_duration",
                   "get"):
        try:
            conv[getter] = getattr(p, getter)()
        except (ValueError, mod.ParamError) as e:
            conv[getter] = f"{type(e).__name__}: {e}"
    return None, conv


CASES = [
    ("name", "hello"), ("name", 7), ("flag", "true"), ("flag", "on"), ("flag", True),
    ("flag", "maybe"), ("count", "12"), ("count", "0"), ("count", "65"), ("count", "x"),
    ("size", "-1"), ("size", "5"), ("ratio", "2.5e-3"), ("ratio", "inf"), ("ratio", "y"),
    ("every", "500ms"), ("every", "1h2m3.5s"), ("every", "7"), ("every", "1q"),
    ("every", "µs"), ("mode", "b"), ("mode", "c"), ("must", ""), ("pick", "q"),
    ("pick", "r"), ("wait", "250us"), ("wait", "soon"), ("wait", ""),
]


@pytest.mark.parametrize("key, value", CASES)
def test_params_answer_as_the_reference(key, value):
    assert _answer(PP, key, value) == _answer(RP, key, value)


def test_defaults_wire_maps_and_catalog_json_match():
    rp, pp = _descs(RP).to_params(), _descs(PP).to_params()
    assert pp.copy_to_map(prefix="g.") == rp.copy_to_map(prefix="g.")
    assert pp.to_descs_json() == rp.to_descs_json()
    wire = {"g.count": "32", "g.flag": "yes", "other.count": "2", "g.every": "2s"}
    rp.copy_from_map(wire, "g.")
    pp.copy_from_map(wire, "g.")
    assert pp.copy_to_map() == rp.copy_to_map()
    rc = RP.Collection({"operator.a.": _descs(RP).to_params(), "runtime.": rp})
    pc = PP.Collection({"operator.a.": _descs(PP).to_params(), "runtime.": pp})
    flat = {"operator.a.mode": "b", "runtime.ratio": "0.25"}
    rc.copy_from_map(flat)
    pc.copy_from_map(flat)
    assert pc.copy_to_map() == rc.copy_to_map()
    back = PP.params.descs_from_json(pp.to_descs_json())
    assert [d.key for d in back] == [d.key for d in _descs(PP)]
    with pytest.raises(RP.ParamError) as want:
        rp.copy_from_map({"g.count": "99"}, "g.")
    with pytest.raises(PP.ParamError) as got:
        pp.copy_from_map({"g.count": "99"}, "g.")
    assert str(got.value) == str(want.value)


def test_tpusketch_instance_params_match_the_reference():
    ref = ref_get_op("tpusketch").instance_params()
    port = P.TpuSketch().instance_params()
    assert len(port) == len(ref) == 38
    assert [d.key for d in port] == [d.key for d in ref]
    for r, p in zip(ref, port):
        assert (p.default, p.type_hint.value, p.possible_values, p.is_mandatory) == \
            (r.default, r.type_hint.value, r.possible_values, r.is_mandatory), r.key
        assert (p.validator is None) == (r.validator is None), r.key


SKETCH_CASES = [
    ("quantile-alpha", "0.3"), ("quantile-alpha", "0.31"), ("quantile-alpha", "0"),
    ("quantile-alpha", "x"), ("priority-classes", "hot=12:101|102,rest=10:*"),
    ("priority-classes", "gibberish"), ("priority-classes", "a=12:*,b=10:*"),
    ("priority-classes", "hot=12:101|x,rest=10:*"), ("chips", "auto"), ("chips", "1"),
    ("chips", "4"), ("chips", "0"), ("chips", "x"), ("history-schedule", "1m@24h,10m@7d,1h@inf"),
    ("history-schedule", "1s@2s,60s@inf"), ("history-schedule", "1m@24h"),
    ("history-schedule", "10m@1h,1m@inf"), ("history-schedule", "bogus"),
    ("history-schedule", "2d@inf"), ("inv-rows", "1"), ("inv-rows", "2"), ("inv-rows", "9"),
    ("inv-log2-buckets", "5"), ("inv-log2-buckets", "20"), ("inv-log2-buckets", "21"),
    ("audit-sample", "-1"), ("audit-sample", "1024"), ("anomaly-model", "lstm"),
    ("anomaly-model", "seq"), ("enable", "maybe"), ("depth", "x"), ("depth", "3"),
    ("harvest-interval", "500ms"), ("harvest-interval", "1q"), ("query-cache-bytes", "1023"),
    ("query-refresh", "0"), ("history-archive-cache-bytes", "65535"), ("seq-window", "1.5"),
]


def _sketch_answer(params, mod, key, value):
    try:
        params.set(key, value)
    except mod.ParamError as e:
        return str(e)
    return None


@pytest.mark.parametrize("key, value", SKETCH_CASES)
def test_tpusketch_accepts_and_rejects_as_the_reference(key, value):
    ref = _sketch_answer(ref_get_op("tpusketch").instance_params().to_params(), RP, key, value)
    port = _sketch_answer(P.TpuSketch().instance_params().to_params(), PP, key, value)
    assert port == ref
    field = key.replace("-", "_")
    if field in {f.name for f in dataclasses.fields(P.SketchConfig)}:
        cfg = P.SketchConfig(**{field: value})
        if ref is None:
            cfg.validate()
        else:
            with pytest.raises(P.ParamError) as err:
                cfg.validate()
            assert str(err.value) == ref


def test_sketch_config_round_trips_through_the_params():
    params = P.TpuSketch().instance_params().to_params()
    for k, v in {"depth": "3", "harvest-interval": "250ms", "quantiles": "true",
                 "quantile-alpha": "0.02", "chips": "1", "invertible": "true",
                 "history-interval": "0"}.items():
        params.set(k, v)
    cfg = P.SketchConfig.from_params(params)
    assert (cfg.depth, cfg.harvest_interval, cfg.quantiles, cfg.quantile_alpha, cfg.chips,
            cfg.invertible, cfg.history_interval) == (3, 0.25, True, 0.02, "1", True, 0.0)
    assert P.SketchConfig.from_params(P.TpuSketch().instance_params().to_params()) == \
        P.SketchConfig()
    cfg.validate()
