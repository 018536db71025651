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


def _tree(tr) -> None:
    with tr.span("run/trace/exec"):
        with tr.span("op/tpusketch"):
            with tr.span("tpusketch/h2d"):
                with tr.span("tpusketch/fold"):
                    torch.ones(4).sum()
                with tr.span("tpusketch/copy"):
                    pass
            with tr.span("tpusketch/update", label="ig:tpusketch_update"):
                torch.ones(4).sum()


def test_spans_are_profiler_ranges_while_a_profiler_records():
    """Each ambient span is a profiler range of its name (or label),
    nested as the spans are; a held-open span is not."""
    tr = P.Tracer(capacity=64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert P.profiling()
        _tree(tr)
        with tr.span("agent/run/held", ambient=False):
            pass
    assert not P.profiling()
    want = {"run/trace/exec": None, "op/tpusketch": "run/trace/exec",
            "tpusketch/h2d": "op/tpusketch", "tpusketch/fold": "tpusketch/h2d",
            "tpusketch/copy": "tpusketch/h2d", "ig:tpusketch_update": "op/tpusketch"}
    got = {e.name: e for e in prof.events() if e.name in want or e.name.startswith("agent/")}
    assert set(got) == set(want)
    for name, parent in want.items():
        if parent is None:
            continue
        inner, outer = got[name].time_range, got[parent].time_range
        assert outer.start <= inner.start <= inner.end <= outer.end, name
    # the ring holds the same tree, by span name
    assert [r.name for r in tr.records()] == [
        "tpusketch/fold", "tpusketch/copy", "tpusketch/h2d", "tpusketch/update",
        "op/tpusketch", "run/trace/exec", "agent/run/held"]
    assert all(r.duration >= 0.0 for r in tr.records())


def test_no_profiler_range_without_a_profiler(monkeypatch):
    """With no profiler running, neither spans nor `device_annotation`
    enter `record_function`; under a profiler the same calls do."""
    import torch.autograd.profiler as tap
    calls = []
    real = tap.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(tap, "record_function", counting)
    tr = P.Tracer(capacity=64)
    _tree(tr)
    with P.device_annotation("ig:x"):
        pass
    assert calls == [] and len(tr.records()) == 6
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _tree(tr)
        with P.device_annotation("ig:x"):
            pass
    assert calls == ["run/trace/exec", "op/tpusketch", "tpusketch/h2d", "tpusketch/fold",
                     "tpusketch/copy", "ig:tpusketch_update", "ig:x"]


def test_ids_keep_their_lengths_and_ignore_the_global_seed():
    import random
    tr = P.Tracer()
    ids = []
    for _ in range(2):
        random.seed(1234)
        with tr.span("a") as a:
            with tr.span("b") as b:
                ids.append((a.context.trace_id, a.context.span_id, b.context.span_id))
    for trace_id, *spans in ids:
        assert len(trace_id) == 32 and all(len(s) == 16 for s in spans)
        int(trace_id, 16)
        assert R.parse_traceparent(P.SpanContext(trace_id, spans[0]).to_traceparent())
    assert ids[0] != ids[1]
    assert len({s for row in ids for s in row[1:]}) == 4
