"""The port's perf records, ledger and comparator against the JAX
package's (`inspektor_gadget_tpu/perf/schema.py`, `ledger.py`,
`compare.py`): the same verdicts on the same records, ledgers that
either package writes and the other reads record for record, and the
same comparisons and reports on the same seeded ledgers.

One deliberate departure: the port refuses a ``gpu`` candidate whose
only history is another platform's (exit 3), as the reference refuses a
``tpu`` one; the reference reports no baseline for ``gpu``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import threading
from pathlib import Path

import numpy as np
import pytest

from inspektor_gadget_tpu.perf import compare as RC
from inspektor_gadget_tpu.perf import ledger as RL
from inspektor_gadget_tpu.perf import schema as RS
from inspektor_gadget_tpu_torch.perf import compare as PC
from inspektor_gadget_tpu_torch.perf import ledger as PL
from inspektor_gadget_tpu_torch.perf import schema as PS

from _torch_perf import rec


# -- schema -------------------------------------------------------------------

def _mutations() -> dict:
    """name -> a function turning a valid record into the case."""
    def setp(path, value):
        def f(r):
            d = r
            for k in path[:-1]:
                d = d[k]
            d[path[-1]] = value
            return r
        return f

    def delp(path):
        def f(r):
            d = r
            for k in path[:-1]:
                d = d[k]
            del d[path[-1]]
            return r
        return f

    return {
        "valid tpu": lambda r: r,
        "cpu": setp(("provenance", "platform"), "cpu"),
        "gpu": setp(("provenance", "platform"), "gpu"),
        "degraded": setp(("provenance", "degraded"), True),
        "no provenance": delp(("provenance",)),
        "degraded not a bool": setp(("provenance", "degraded"), "no"),
        "unknown platform": setp(("provenance", "platform"), "quantum"),
        "stage value not numeric": setp(("stages", "pop", "ev_per_s"), "fast"),
        "stage value a bool": setp(("stages", "pop", "seconds"), True),
        "empty stage": setp(("stages", "pop"), {}),
        "stages not an object": setp(("stages",), []),
        "value a string": setp(("value",), "big"),
        "wrong schema id": setp(("schema",), "ig-tpu/perf-record/v0"),
        "no ts": delp(("ts",)),
        "empty config": setp(("config",), ""),
        "bad direction": setp(("direction",), "sideways"),
        "no host": delp(("provenance", "host")),
        "host without python": delp(("provenance", "host", "python")),
        "no probe": delp(("provenance", "probe")),
        "attempts not a list": setp(("provenance", "probe", "attempts"), "3"),
        "extra not an object": setp(("extra",), [1]),
        "trace_file not a string": setp(("trace_file",), 3),
        "argv not a list": setp(("argv",), "run"),
        "git_dirty missing": delp(("provenance", "git_dirty")),
    }


@pytest.mark.parametrize("case", sorted(_mutations()))
def test_both_validators_give_the_same_verdict(case):
    base = rec(RS, 100e6, extra={"batch": 1}, trace_file="t.json")
    r = _mutations()[case](copy.deepcopy(base))
    got, want = PS.validate_record(r), RS.validate_record(r)
    assert got == want
    assert (got == []) == (case in ("valid tpu", "cpu", "gpu", "degraded"))


@pytest.mark.parametrize("doc", [None, [], "{", 3, {"schema": "ig-tpu/perf-record/v1", "trunc": 1}],
                         ids=["none", "list", "truncated text", "number", "truncated object"])
def test_truncated_and_foreign_documents_fail_alike(doc):
    assert PS.validate_record(doc) == RS.validate_record(doc) != []


def test_schema_tables_are_the_references():
    for name in ("SCHEMA_ID", "STAGES", "HOST_STAGES", "DIRECTIONS", "PLATFORMS", "STAGE_KEYS"):
        assert getattr(PS, name) == getattr(RS, name), name
    for unit in ("events/sec/chip", "ev/s", "merges/sec", "keys_per_s", "ms", "pct",
                 "fraction", "seconds", "windows/s"):
        assert PS.direction_for_unit(unit) == RS.direction_for_unit(unit), unit


@pytest.mark.parametrize("maker,checker", [(PS, RS), (RS, PS)], ids=["port-made", "ref-made"])
def test_a_record_one_package_makes_the_other_validates(maker, checker):
    for platform in ("gpu", "cpu", "tpu"):
        r = rec(maker, 2.5e6, platform=platform, extra={"pipeline": "x"})
        assert checker.validate_record(r) == []
    with pytest.raises(ValueError, match="provenance"):
        maker.make_record(config="c", metric="m", unit="ev/s", value=1.0, stages={},
                          provenance={"git_sha": "x"})


# -- ledger -------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(PL, RL), (RL, PL)], ids=["port-writes", "ref-writes"])
def test_a_ledger_one_package_writes_the_other_reads(tmp_path, writer, reader):
    p = str(tmp_path / "PERF.jsonl")
    made = [rec(PS, v, platform=plat) for v, plat in ((1e6, "gpu"), (2e6, "cpu"), (3e6, "tpu"))]
    for r in made:
        writer.append_record(r, p)
    got, want = reader.read_ledger(p), writer.read_ledger(p)
    assert got.records == want.records == made
    assert got.skipped == want.skipped == []
    bad = copy.deepcopy(made[0])
    bad["provenance"]["degraded"] = "maybe"
    with pytest.raises(ValueError, match="refusing to append"):
        writer.append_record(bad, p)


def test_a_crash_truncated_tail_reads_alike(tmp_path):
    p = tmp_path / "PERF.jsonl"
    PL.append_record(rec(PS, 1e6), str(p))
    RL.append_record(rec(RS, 2e6), str(p))
    with open(p, "a") as f:
        f.write('{"not": "a record"}\n')
        f.write('{"schema": "ig-tpu/perf-record/v1", "trunc')  # the crash tail
    got, want = PL.read_ledger(str(p)), RL.read_ledger(str(p))
    assert got.records == want.records and len(got.records) == 2
    assert got.skipped == want.skipped and len(got.skipped) == 2


def test_concurrent_appends_of_both_packages_never_interleave(tmp_path):
    p = str(tmp_path / "PERF.jsonl")
    n_threads, per_thread = 8, 25

    def writer(i):
        ledger, schema = (PL, PS) if i % 2 else (RL, RS)
        for j in range(per_thread):
            ledger.append_record(rec(schema, 1e6 + i * 1000 + j), p)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    got, want = PL.read_ledger(p), RL.read_ledger(p)
    assert got.skipped == want.skipped == []
    assert got.records == want.records and len(got.records) == n_threads * per_thread


def test_the_ledger_path_never_defaults_into_the_working_directory(tmp_path, monkeypatch):
    monkeypatch.delenv(PL.LEDGER_ENV, raising=False)
    monkeypatch.setenv("XDG_STATE_HOME", str(tmp_path / "state"))
    assert PL.ledger_path() == str(tmp_path / "state" / "ig-tpu-torch" / "PERF.jsonl")
    monkeypatch.delenv("XDG_STATE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert PL.ledger_path() == str(tmp_path / "home" / ".local" / "state" / "ig-tpu-torch"
                                   / "PERF.jsonl")
    monkeypatch.setenv(PL.LEDGER_ENV, str(tmp_path / "env.jsonl"))
    assert PL.ledger_path() == str(tmp_path / "env.jsonl")
    assert PL.ledger_path("given.jsonl") == "given.jsonl"


def _without_ts(r: dict) -> dict:
    return {k: v for k, v in r.items() if k != "ts"}


REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", [f"BENCH_r0{i}.json" for i in range(1, 6)])
def test_bench_json_imports_as_the_references(name):
    path = str(REPO / name)
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    try:
        want = RL.bench_json_to_record(doc, path)
    except ValueError as e:
        with pytest.raises(ValueError, match="no parsed benchmark result"):
            PL.bench_json_to_record(doc, path)
        assert "no parsed benchmark result" in str(e)
        return
    got = PL.bench_json_to_record(doc, path)
    assert _without_ts(got) == _without_ts(want)
    assert got["provenance"]["platform"] == want["provenance"]["platform"]


def test_bench_json_marks_degraded_as_the_reference():
    doc = {"parsed": {"metric": "m", "value": 2062450.8, "unit": "events/sec/chip",
                      "extra": {"platform": "cpu", "degraded": True,
                                "error": {"tpu_probe": "timeout"}}}}
    got, want = PL.bench_json_to_record(doc, "BENCH_r05.json"), RL.bench_json_to_record(
        doc, "BENCH_r05.json")
    assert _without_ts(got) == _without_ts(want)
    assert got["provenance"]["degraded"] is True and "timeout" in got["provenance"]["probe"][
        "detail"]


def test_import_is_idempotent_in_both_and_across(tmp_path):
    docs = [tmp_path / "BENCH_r04.json", tmp_path / "BENCH_r05.json", tmp_path / "BENCH_r06.json"]
    docs[0].write_text(json.dumps({"n": 4, "parsed": {
        "metric": "sketch_ingest_throughput_e2e", "value": 76359636.5,
        "unit": "events/sec/chip", "extra": {"platform": "tpu", "degraded": False,
                                             "host_plane_ev_per_s": 130455732.5,
                                             "device_plane_ev_per_s": 2646607627.7,
                                             "merge_ms_p50": 0.08}}}))
    docs[1].write_text(json.dumps({"n": 5, "rc": 1, "tail": "boom"}))  # nothing parsed
    docs[2].write_text("{not json")
    paths = [str(d) for d in docs]
    lp, lr = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    got, want = PL.import_bench_files(paths, lp), RL.import_bench_files(paths, lr)
    assert got[0] == want[0] == 1
    assert [s.split(":")[0] for s in got[1]] == [s.split(":")[0] for s in want[1]]
    again = PL.import_bench_files(paths, lp), RL.import_bench_files(paths, lr)
    assert again[0][0] == again[1][0] == 0
    assert any("already imported" in s for s in again[0][1])
    assert [_without_ts(r) for r in PL.read_ledger(lp).records] == \
        [_without_ts(r) for r in RL.read_ledger(lr).records]
    # across: the port skips what the reference imported
    assert PL.import_bench_files(paths[:1], lr)[0] == 0


# -- compare and report ---------------------------------------------------------

def _history(schema, values, **kw):
    return [rec(schema, v, ts=f"2026-07-{i + 1:02d}T00:00:00+00:00", **kw)
            for i, v in enumerate(values)]


def _seeded(schema, seed: int = 7):
    """A ledger of several series, values drawn from a seeded rng: a
    stable series with a 20% regression at its end, a jittery one in its
    band, degraded CPU junk beside an honest series, a lower-better
    series that improves and one that regresses."""
    rng = np.random.default_rng(seed)
    out = []
    stable = 100e6 * (1 + 0.01 * rng.standard_normal(5))
    out += _history(schema, stable.tolist(), config="stable")
    out.append(rec(schema, 80e6, config="stable", ts="2026-08-01T00:00:00+00:00"))
    jitter = 50e6 * (1 + 0.08 * rng.standard_normal(6))
    out += _history(schema, jitter.tolist(), config="jittery")
    out += _history(schema, [50e6, 51e6], config="mixed", platform="cpu", degraded=True)
    out += _history(schema, (100e6 * (1 + 0.01 * rng.standard_normal(4))).tolist(),
                    config="mixed")
    out.append(rec(schema, 79e6, config="mixed", ts="2026-08-02T00:00:00+00:00"))
    lat = dict(metric="merge", unit="ms", stages={"merge": {"ms_p50": 1.0}})
    out += [rec(schema, v, config="latency", ts=f"2026-07-{i + 1:02d}T00:00:00+00:00", **lat)
            for i, v in enumerate((1.0 + 0.05 * rng.standard_normal(4)).tolist())]
    out.append(rec(schema, 0.5, config="latency", ts="2026-08-03T00:00:00+00:00", **lat))
    out += [rec(schema, v, config="latency2", ts=f"2026-07-{i + 1:02d}T00:00:00+00:00", **lat)
            for i, v in enumerate((1.0 + 0.05 * rng.standard_normal(4)).tolist())]
    out.append(rec(schema, 2.0, config="latency2", ts="2026-08-03T00:00:00+00:00", **lat))
    out += _history(schema, [2.0e6, 2.1e6, 1.9e6], config="cpu-series", platform="cpu")
    out.append(rec(schema, 2.05e6, config="cpu-series", platform="cpu",
                   ts="2026-08-04T00:00:00+00:00"))
    out += _history(schema, [50e6, 51e6, 52e6], config="refused", platform="cpu",
                    degraded=True)
    out.append(rec(schema, 77.9e6, config="refused", platform="tpu",
                   ts="2026-08-05T00:00:00+00:00"))
    return out


def test_compare_ledger_and_its_text_equal_the_references():
    records = _seeded(PS)
    got, want = PC.compare_ledger(records), RC.compare_ledger(records)
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    assert {r.config: r.status for r in got} == {
        "stable": "regression", "jittery": "ok", "mixed": "regression",
        "latency": "improved", "latency2": "regression", "cpu-series": "ok",
        "refused": "refused"}
    assert [r.rc for r in got] == [r.rc for r in want]
    assert PC.render_compare(got) == RC.render_compare(want)
    for k, band in ((3, 0.15), (5, 0.05), (2, 0.3)):
        assert [dataclasses.asdict(r) for r in PC.compare_ledger(records, ["stable"], k, band)] \
            == [dataclasses.asdict(r) for r in RC.compare_ledger(records, ["stable"], k, band)]


def test_degraded_records_never_baseline_in_either():
    hist = (_history(PS, [100e6, 101e6, 99e6, 100.5e6, 99.5e6])
            + _history(PS, [50e6, 51e6], platform="cpu", degraded=True))
    got, want = PC.compare_record(rec(PS, 80e6), hist), RC.compare_record(rec(PS, 80e6), hist)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.status == "regression" and got.pool_n == 5


def test_same_second_records_still_baseline_in_either():
    ts = "2026-08-03T00:00:00+00:00"
    older, cand = rec(PS, 100e6, ts=ts), rec(PS, 78e6, ts=ts)
    got, want = PC.compare_record(cand, [older, cand]), RC.compare_record(cand, [older, cand])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.pool_n == 1 and got.status == "regression"


def test_a_gpu_claim_with_only_cpu_history_is_refused_as_a_tpu_claim_is():
    hist = (_history(PS, [50e6, 51e6, 52e6], platform="cpu")
            + _history(PS, [40e6], platform="cpu", degraded=True))
    gpu = PC.compare_record(rec(PS, 77.9e6, platform="gpu"), hist)
    tpu = RC.compare_record(rec(PS, 77.9e6, platform="tpu"), hist)
    assert gpu.status == tpu.status == "refused" and gpu.rc == tpu.rc == PC.RC_REFUSED == 3
    assert gpu.detail == tpu.detail.replace("TPU", "GPU")
    assert "refusing to baseline a GPU claim" in gpu.detail
    # the departure: the reference reports no baseline for a gpu claim
    assert RC.compare_record(rec(PS, 77.9e6, platform="gpu"), hist).status == "no-baseline"
    # a gpu claim with gpu history compares as any series does
    hist += _history(PS, [100e6, 101e6, 99e6], platform="gpu")
    got = PC.compare_record(rec(PS, 78e6, platform="gpu"), hist)
    assert got.status == "regression" and got.pool_n == 3


def test_render_report_equals_the_references():
    records = _seeded(PS)
    for last, configs in ((10, None), (0, None), (5, ["stable", "mixed"]), (3, ["latency"])):
        assert PC.render_report(records, last, configs) == RC.render_report(records, last,
                                                                             configs)
    assert [dataclasses.asdict(r) for r in PC.report_rows(records, 0)] == \
        [dataclasses.asdict(r) for r in RC.report_rows(records, 0)]
    assert "empty" in PC.render_report([]) and "ig-tpu-torch bench run" in PC.render_report([])


def test_a_ledger_of_gpu_records_reports_and_compares():
    records = _history(PS, [100e6, 101e6, 99e6, 100.5e6], platform="gpu")
    records.append(rec(PS, 75e6, platform="gpu", ts="2026-08-01T00:00:00+00:00"))
    (res,) = PC.compare_ledger(records)
    assert res.status == "regression"
    text = PC.render_report(records)
    assert "gpu" in text and "-25.4%" in text  # against the previous record
    assert text == RC.render_report(records)


def test_bench_compare_exit_codes_equal_the_references(tmp_path):
    from inspektor_gadget_tpu.cli.bench import main as ref_bench
    from inspektor_gadget_tpu_torch.cli.bench import main as port_bench
    p = str(tmp_path / "PERF.jsonl")
    for r in _history(PS, [100e6, 101e6, 99e6, 100.5e6]):
        PL.append_record(r, p)
    PL.append_record(rec(PS, 99.5e6, ts="2026-08-01T00:00:00+00:00"), p)
    assert port_bench(["compare", "--ledger", p]) == ref_bench(["compare", "--ledger", p]) == 0
    PL.append_record(rec(PS, 75e6, ts="2026-08-02T00:00:00+00:00"), p)
    assert port_bench(["compare", "--ledger", p]) == ref_bench(["compare", "--ledger", p]) \
        == RC.RC_REGRESSION
    q = str(tmp_path / "refused.jsonl")
    for r in _history(PS, [50e6, 51e6], platform="cpu", degraded=True):
        PL.append_record(r, q)
    PL.append_record(rec(PS, 77.9e6, platform="tpu", ts="2026-08-03T00:00:00+00:00"), q)
    assert port_bench(["compare", "--ledger", q]) == ref_bench(["compare", "--ledger", q]) \
        == RC.RC_REFUSED
    PL.append_record(rec(PS, 77.9e6, platform="gpu", config="gpu-only",
                         ts="2026-08-04T00:00:00+00:00"), q)
    assert port_bench(["compare", "--ledger", q, "--config", "gpu-only"]) == 0  # no history
    empty = str(tmp_path / "empty.jsonl")
    assert port_bench(["compare", "--ledger", empty]) == ref_bench(
        ["compare", "--ledger", empty]) == 0
    cand = tmp_path / "cand.json"
    cand.write_text(json.dumps(rec(PS, 40e6)))
    assert port_bench(["compare", "--ledger", p, "--candidate-file", str(cand)]) == \
        ref_bench(["compare", "--ledger", p, "--candidate-file", str(cand)]) == RC.RC_REGRESSION
    cand.write_text("{")
    assert port_bench(["compare", "--ledger", p, "--candidate-file", str(cand)]) == \
        ref_bench(["compare", "--ledger", p, "--candidate-file", str(cand)]) == RC.RC_USAGE
