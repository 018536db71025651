"""The port's span tree (`inspektor_gadget_tpu_torch.telemetry.tracing`)
against the reference's.

One scripted span tree, recorded by a fresh tracer of each package, must
export the same names, parent links, attributes and errors, and the same
Chrome trace events, with the random ids aside. Traceparent values
minted by either package parse in the other.
"""

from __future__ import annotations

import json

import pytest
import torch

from inspektor_gadget_tpu.telemetry import tracing as R
from inspektor_gadget_tpu_torch.telemetry import tracing as P

torch.set_num_threads(2)


def _script(mod) -> "object":
    """A run span with an operator chain, device-plane children, an
    explicitly parented span, a non-ambient span and a failing one."""
    tr = mod.Tracer(capacity=64, node="n0")
    with tr.span("run/trace/exec", attrs={"run_id": "r1", "node": "n0"}) as run:
        for i in range(2):
            with tr.span("op/tpusketch", attrs={"events": 4096 + i}):
                with tr.span("tpusketch/h2d", attrs={"events": 4096 + i, "pad": 8192}):
                    pass
                with tr.span("tpusketch/update", attrs={"events": 4096 + i}) as sp:
                    sp.set_attr("late", True)
        with tr.span("tpusketch/harvest", parent=run.context, attrs={"epoch": 1},
                     ambient=False):
            pass
        with pytest.raises(ValueError):
            with tr.span("tpusketch/seal-window", attrs={"window": 1}):
                raise ValueError("disk full")
    with tr.start_trace("other/root", attrs={"k": "v"}):
        with tr.span("other/child"):
            pass
    return tr


def _shape(records: list[dict]) -> list[tuple]:
    """Each span as (name, parent's name, attrs, error, node, thread, same
    trace as its parent), ids aside."""
    by_id = {r["span_id"]: r for r in records}
    out = []
    for r in records:
        parent = by_id.get(r["parent_id"])
        out.append((r["name"], parent["name"] if parent else "", r["attrs"], r["error"],
                    r["node"], r["thread"],
                    parent is None or parent["trace_id"] == r["trace_id"]))
    return out


def test_span_tree_exports_match_the_reference():
    ref, port = _script(R), _script(P)
    got, want = port.export(), ref.export()
    assert _shape(got) == _shape(want)
    assert len({r["trace_id"] for r in got}) == 2
    assert all(r["duration"] >= 0.0 for r in got)
    assert [r["name"] for r in port.export(got[0]["trace_id"])] == \
        [r["name"] for r in ref.export(want[0]["trace_id"])]


def test_chrome_export_matches_the_reference():
    ref, port = _script(R), _script(P)

    def strip(doc: dict) -> list[dict]:
        out = []
        for ev in doc["traceEvents"]:
            ev = dict(ev, args={k: v for k, v in ev["args"].items()
                                if k not in ("trace_id", "span_id", "parent_id")})
            ev.pop("ts", None)
            ev.pop("dur", None)
            out.append(ev)
        return out

    got, want = P.export_chrome(port.records()), R.export_chrome(ref.records())
    assert strip(got) == strip(want)
    assert got["displayTimeUnit"] == want["displayTimeUnit"]
    json.dumps(got)
    # one trace only, and the fetched dict form of the same records
    tid = port.records()[0].trace_id
    assert strip(P.export_chrome(port.export(), trace_id=tid)) == \
        strip(R.export_chrome(ref.export(), trace_id=ref.records()[0].trace_id))


def test_traceparent_round_trips_between_the_packages():
    for mod_a, mod_b in ((P, R), (R, P)):
        tr = mod_a.Tracer()
        with tr.span("x") as sp:
            tp = sp.context.to_traceparent()
        back = mod_b.parse_traceparent(tp)
        assert (back.trace_id, back.span_id, back.sampled) == \
            (sp.context.trace_id, sp.context.span_id, True)
        assert back.to_traceparent() == tp
    unsampled = P.SpanContext("a" * 32, "b" * 16, sampled=False).to_traceparent()
    assert R.parse_traceparent(unsampled).sampled is False
    for bad in ("", "00-xyz", "00-" + "g" * 32 + "-" + "b" * 16 + "-01", 7,
                "00-" + "a" * 31 + "-" + "b" * 16 + "-01"):
        assert P.parse_traceparent(bad) == R.parse_traceparent(bad) is None


def test_unsampled_traces_record_nothing_and_the_recorder_snapshots():
    for mod in (P, R):
        tr = mod.Tracer(sample_rate=0.0)
        with tr.span("a"):
            with tr.span("b") as sp:
                assert not sp.context.sampled
        assert tr.records() == []
    rec_p = P.FlightRecorder(_script(P))
    rec_r = R.FlightRecorder(_script(R))
    for rec in (rec_p, rec_r):
        rec.set_fact("platform", "cpu")
        rec.record_error("log", "boom")
    sp, sr = rec_p.snapshot(), rec_r.snapshot()
    assert sorted(sp) == sorted(sr)
    assert _shape(sp["spans"]) == _shape(sr["spans"])
    assert sp["facts"] == sr["facts"]


def test_device_annotation_is_a_profiler_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.device_annotation("ig:tpusketch_update"):
            torch.ones(4).sum()
    assert any(e.name == "ig:tpusketch_update" for e in prof.events())
