"""The port's alerting plane (`inspektor_gadget_tpu_torch.alerts`) against
the reference's, case for case, on the same inputs: the rule loader's
messages on the reference's bad documents (``tests/test_alerts.py``), with
PyYAML and without it; the engine's transitions for a seeded summary
sequence over every rule kind that reads sketch fields; debounce,
hysteresis, cooldown, vanished keys and close under an injected clock;
the sinks; the process-wide table; and the cluster dedup aggregator.
"""

from __future__ import annotations

import json
import logging
import sys

import numpy as np
import pytest
import torch

import inspektor_gadget_tpu.alerts as RA
import inspektor_gadget_tpu_torch.alerts as PA
from inspektor_gadget_tpu.operators.tpusketch import SketchSummary as RSummary
from inspektor_gadget_tpu_torch.alerts.store import ActiveAlerts as PActive
from inspektor_gadget_tpu.alerts.store import ActiveAlerts as RActive
from inspektor_gadget_tpu_torch.operators.tpusketch import SketchSummary as PSummary

torch.set_num_threads(2)

PKGS = {"reference": (RA, RSummary), "port": (PA, PSummary)}


def _summary(pkg: str, entropy=0.0, events=1000, drops=0, distinct=10.0,
             hh=((1, 500), (2, 100)), anomaly=None, epoch=1, decoded=(), quantiles=None):
    cls = PKGS[pkg][1]
    return cls(events=events, drops=drops, distinct=distinct, entropy_bits=entropy,
               heavy_hitters=[tuple(x) for x in hh], anomaly=anomaly, epoch=epoch,
               decoded=[tuple(x) for x in decoded], quantiles=quantiles)


def _events(evs) -> list[dict]:
    """Transitions as wire dicts, the wall clock aside."""
    out = []
    for ev in evs:
        d = ev.to_dict() if not isinstance(ev, dict) else dict(ev)
        d.pop("ts", None)
        out.append(d)
    return out


# -- rule loading: the same verdict and the same message ----------------------------

BAD_DOCS = {
    "empty": "",
    "empty_list": "rules: []",
    "empty_map": "{}",
    "unknown_field": json.dumps([{"id": "x", "kind": "threshold", "field": "entropy_bitz",
                                  "threshold": 1}]),
    "unknown_denom": json.dumps([{"id": "x", "kind": "ratio", "field": "drops",
                                  "denom": "nope", "threshold": 1}]),
    "string_threshold": json.dumps([{"id": "x", "kind": "threshold", "field": "events",
                                     "threshold": "very high"}]),
    "bool_threshold": json.dumps([{"id": "x", "kind": "threshold", "field": "events",
                                   "threshold": True}]),
    "duplicate_ids": json.dumps([{"id": "dup", "kind": "threshold", "field": "events",
                                  "threshold": 1},
                                 {"id": "dup", "kind": "threshold", "field": "drops",
                                  "threshold": 2}]),
    "unknown_key": json.dumps([{"id": "x", "kind": "threshold", "field": "events",
                                "threshold": 1, "treshold": 2}]),
    "unknown_kind": json.dumps([{"id": "x", "kind": "entropy_bump", "threshold": 1}]),
    "unknown_op": json.dumps([{"id": "x", "kind": "threshold", "field": "events", "op": "=>",
                               "threshold": 1}]),
    "unknown_severity": json.dumps([{"id": "x", "kind": "threshold", "field": "events",
                                     "threshold": 1, "severity": "apocalyptic"}]),
    "missing_threshold": json.dumps([{"id": "x", "kind": "threshold", "field": "events"}]),
    "missing_id": json.dumps([{"kind": "threshold", "field": "events", "threshold": 1}]),
    "not_a_mapping": json.dumps([3]),
    "top_level_extra": json.dumps({"rules": [{"id": "x", "kind": "threshold",
                                              "field": "events", "threshold": 1}],
                                   "extra": 1}),
    "not_a_list": json.dumps({"rules": "x"}),
    "implied_field": json.dumps([{"id": "x", "kind": "entropy_jump", "field": "drops",
                                  "threshold": 1}]),
    "threshold_needs_field": json.dumps([{"id": "x", "kind": "threshold", "threshold": 1}]),
    "heavy_flow_field": json.dumps([{"id": "x", "kind": "heavy_flow", "field": "events",
                                     "threshold": 1}]),
    "quantile_field": json.dumps([{"id": "x", "kind": "quantile_shift", "field": "events"}]),
    "pipeline_field": json.dumps([{"id": "x", "kind": "pipeline_lag", "field": "p99"}]),
    "accuracy_field": json.dumps([{"id": "x", "kind": "accuracy_drift", "field": "events"}]),
    "ratio_needs_denom": json.dumps([{"id": "x", "kind": "ratio", "field": "drops",
                                      "threshold": 1}]),
    "denom_outside_ratio": json.dumps([{"id": "x", "kind": "threshold", "field": "drops",
                                        "denom": "events", "threshold": 1}]),
    "bad_window": json.dumps([{"id": "x", "kind": "entropy_jump", "threshold": 1,
                               "window": 0}]),
    "bad_factor": json.dumps([{"id": "x", "kind": "cardinality_spike", "factor": 0}]),
    "churn_range": json.dumps([{"id": "x", "kind": "heavy_hitter_churn", "threshold": 2}]),
    "bad_duration": json.dumps([{"id": "x", "kind": "threshold", "field": "events",
                                 "threshold": 1, "for": "soon"}]),
    "negative_duration": json.dumps([{"id": "x", "kind": "threshold", "field": "events",
                                      "threshold": 1, "cooldown": -1}]),
    "list_duration": json.dumps([{"id": "x", "kind": "threshold", "field": "events",
                                  "threshold": 1, "for": [1]}]),
    "unparseable": "[{",
}


def _load_both(doc: str) -> dict[str, object]:
    out = {}
    for name, (mod, _) in PKGS.items():
        try:
            out[name] = [r.__dict__ for r in mod.load_rules(doc)]
        except mod.RuleError as e:
            out[name] = ("RuleError", str(e))
    return out


@pytest.mark.parametrize("yaml_present", [True, False], ids=["yaml", "json-only"])
@pytest.mark.parametrize("case", sorted(BAD_DOCS))
def test_bad_documents_fail_with_the_reference_message(case, yaml_present, monkeypatch):
    if not yaml_present:
        monkeypatch.setitem(sys.modules, "yaml", None)  # the import raises ImportError
    got = _load_both(BAD_DOCS[case])
    assert got["port"] == got["reference"]
    assert got["port"][0] == "RuleError", got


RULES = [
    {"id": "busy", "kind": "threshold", "field": "events", "op": ">", "threshold": 1500,
     "clear": 1200, "for": "1s", "severity": "info"},
    {"id": "drop-ratio", "kind": "ratio", "field": "drops", "denom": "events",
     "threshold": 0.01, "cooldown": 2},
    {"id": "ej", "kind": "entropy_jump", "threshold": 0.5, "window": 3},
    {"id": "card", "kind": "cardinality_spike", "factor": 1.5, "window": 2, "threshold": 5},
    {"id": "churn", "kind": "heavy_hitter_churn", "threshold": 0.4},
    {"id": "hot", "kind": "anomaly_score", "op": ">=", "threshold": 0.7, "severity": "critical"},
    {"id": "flow", "kind": "heavy_flow", "threshold": 40},
    {"id": "lat", "kind": "quantile_shift", "field": "p99", "factor": 1.5, "window": 2},
    {"id": "share", "kind": "threshold", "field": "hh_top_share", "op": "<", "threshold": 0.2},
]


def test_good_documents_load_alike():
    """A JSON document of every kind, and the same rules as YAML, load to
    the same rules in both packages."""
    got = _load_both(json.dumps({"rules": RULES}))
    assert got["port"] == got["reference"] and len(got["port"]) == len(RULES)
    yaml_doc = "rules:\n  - id: e1\n    kind: entropy_jump\n    threshold: 1.5\n" \
               "    for: 250ms\n    cooldown: 2s\n"
    got = _load_both(yaml_doc)
    assert got["port"] == got["reference"]
    assert [r.describe() for r in PA.load_rules(json.dumps(RULES))] == \
        [r.describe() for r in RA.load_rules(json.dumps(RULES))]


def test_rule_files_read_alike(tmp_path):
    (tmp_path / "empty.json").write_text("")
    for path in (tmp_path / "absent.json", tmp_path / "empty.json"):
        msgs = []
        for mod, _ in PKGS.values():
            with pytest.raises(mod.RuleError) as e:
                mod.load_rules_file(str(path))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    good = tmp_path / "rules.json"
    good.write_text(json.dumps(RULES))
    assert [r.__dict__ for r in PA.load_rules_file(str(good))] == \
        [r.__dict__ for r in RA.load_rules_file(str(good))]


def _seeded_stream(seed: int, n: int) -> list[dict]:
    """A summary sequence that crosses every rule of RULES now and then."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        events = int(rng.integers(800, 2000))
        hh_keys = rng.choice(12, size=4, replace=False) + 1
        hh = [(int(k), int(c)) for k, c in zip(hh_keys, sorted(rng.integers(10, 600, 4))[::-1])]
        anomaly = {int(ns): float(rng.random()) for ns in rng.choice([11, 22, 33], 2, False)}
        decoded = [(int(k), int(rng.integers(1, 80))) for k in rng.choice(40, 5, False)]
        out.append({"entropy": float(rng.normal(4.0, 0.4)), "events": events,
                    "drops": int(rng.integers(0, 30)), "distinct": float(rng.integers(5, 40)),
                    "hh": hh, "anomaly": anomaly, "epoch": i + 1, "decoded": decoded,
                    "quantiles": {"p50": 10.0, "p90": 20.0, "p99": float(rng.integers(0, 90)),
                                  "p999": 120.0}})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_summaries_give_the_reference_transitions(seed):
    stream = _seeded_stream(seed, 60)
    got = {}
    for name, (mod, _) in PKGS.items():
        eng = mod.AlertEngine(mod.load_rules(json.dumps(RULES)), node="n0", gadget="trace/exec",
                              run_id="r", dry_run=True)
        evs = []
        for i, kw in enumerate(stream):
            evs += eng.observe(_summary(name, **kw), now=0.4 * i)
        evs += eng.close(now=0.4 * len(stream))
        got[name] = (_events(evs), eng.firing())
    assert got["port"] == got["reference"]
    kinds = {e["kind"] for e in got["port"][0]}
    assert {"threshold", "ratio", "entropy_jump", "cardinality_spike", "heavy_hitter_churn",
            "anomaly_score", "heavy_flow", "quantile_shift"} <= kinds
    assert got["port"][1] == []  # close resolved everything


def test_wire_dict_summaries_evaluate_as_objects():
    """The wire-decoded dict shape (journals, `alerts test`) and the
    summary object give the same fields in both packages."""
    for kw in _seeded_stream(7, 5):
        s = _summary("port", **kw)
        d = {"events": s.events, "drops": s.drops, "distinct": s.distinct,
             "entropy": s.entropy_bits, "heavy_hitters": s.heavy_hitters,
             "anomaly": s.anomaly, "decoded": s.decoded, "quantiles": s.quantiles}
        assert PA.summary_fields(s) == PA.summary_fields(d) == RA.summary_fields(d) \
            == RA.summary_fields(_summary("reference", **kw))


# -- the state machine under an injected clock, beside the reference's --------------

SCENARIOS = {
    # (rules, [(summary kwargs, now)], close-at or None)
    "debounce": ([{"id": "d", "kind": "threshold", "field": "drops", "threshold": 10,
                   "for": 1.0}],
                 [({"drops": 3}, 0.0), ({"drops": 50}, 1.0), ({"drops": 60}, 1.5),
                  ({"drops": 60}, 2.1), ({"drops": 0}, 3.0)], None),
    "debounce_retracts": ([{"id": "d", "kind": "threshold", "field": "drops", "threshold": 10,
                            "for": 1.0}],
                          [({"drops": 50}, 0.0), ({"drops": 0}, 0.5), ({"drops": 50}, 1.0),
                           ({"drops": 50}, 1.5)], None),
    "hysteresis": ([{"id": "h", "kind": "threshold", "field": "drops", "threshold": 10,
                     "clear": 5}],
                   [({"drops": 20}, 0.0), ({"drops": 7}, 1.0), ({"drops": 2}, 2.0)], None),
    "hysteresis_below": ([{"id": "h", "kind": "threshold", "field": "events", "op": "<",
                           "threshold": 100, "clear": 150}],
                         [({"events": 50}, 0.0), ({"events": 120}, 1.0),
                          ({"events": 200}, 2.0)], None),
    "cooldown": ([{"id": "c", "kind": "threshold", "field": "drops", "threshold": 10,
                   "cooldown": 10.0}],
                 [({"drops": 20}, 0.0), ({"drops": 0}, 1.0), ({"drops": 20}, 5.0),
                  ({"drops": 20}, 12.0)], None),
    "vanished_pending": ([{"id": "a", "kind": "anomaly_score", "threshold": 0.5, "for": 30.0}],
                         [({"anomaly": {1: 0.9}}, 0.0), ({"anomaly": {}}, 5.0),
                          ({"anomaly": {1: 0.9}}, 3600.0), ({"anomaly": {1: 0.9}}, 3605.0)],
                         None),
    "per_container": ([{"id": "a", "kind": "anomaly_score", "threshold": 0.5}],
                      [({"anomaly": {111: 0.9, 222: 0.1}}, 0.0),
                       ({"anomaly": {111: 0.9, 222: 0.8}}, 1.0),
                       ({"anomaly": {222: 0.8}}, 2.0)], None),
    "ratio_no_data": ([{"id": "r", "kind": "ratio", "field": "hh_top_count", "denom": "events",
                        "op": "<", "threshold": 0.1}],
                      [({"events": 0, "hh": ()}, 0.0)], None),
    "churn_empty_baseline": ([{"id": "hh", "kind": "heavy_hitter_churn", "threshold": 0.5}],
                             [({"hh": ()}, 0.0), ({"hh": ((1, 9), (2, 8))}, 1.0),
                              ({"hh": ((8, 9), (9, 8))}, 2.0)], None),
    "close": ([{"id": "c1", "kind": "threshold", "field": "drops", "threshold": 1},
               {"id": "c2", "kind": "threshold", "field": "events", "threshold": 10,
                "for": 60.0}],
              [({"drops": 5, "events": 100}, 0.0)], 1.0),
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_state_machine_matches_the_reference(case):
    rules, steps, close_at = SCENARIOS[case]
    got = {}
    for name, (mod, _) in PKGS.items():
        eng = mod.AlertEngine(mod.load_rules(json.dumps(rules)), node="n0", dry_run=True)
        trace = [_events(eng.observe(_summary(name, **kw), now=now)) for kw, now in steps]
        if close_at is not None:
            trace.append(_events(eng.close(now=close_at)))
            trace.append(_events(eng.close(now=close_at + 1)))  # idempotent
        got[name] = (trace, eng.firing())
    assert got["port"] == got["reference"]
    assert any(got["port"][0]) or case == "ratio_no_data"


def test_delivery_reaches_table_sinks_and_stream(tmp_path, caplog):
    """Real delivery (not a dry run): the process-wide table, the webhook
    file, the log sink's levels and the stream callback see what the
    reference's do."""
    rules = json.dumps([{"id": "deliver-w", "kind": "threshold", "field": "drops",
                         "threshold": 1, "severity": "critical", "for": 0.5}])
    got = {}
    for name, (mod, _) in PKGS.items():
        hook = tmp_path / f"{name}.jsonl"
        streamed = []
        logger = logging.getLogger(f"ig-tpu.alerts.test.{name}")
        eng = mod.AlertEngine(mod.load_rules(rules), node="n0",
                              sinks=[mod.WebhookFileSink(str(hook)), mod.LogSink(logger)],
                              on_event=streamed.append)
        with caplog.at_level(logging.INFO, logger=logger.name):
            eng.observe(_summary(name, drops=5), now=0.0)
            (entry,) = [a for a in mod.ACTIVE.all() if a["rule"] == "deliver-w"]
            assert entry["state"] == "pending"
            eng.observe(_summary(name, drops=5), now=1.0)
            eng.observe(_summary(name, drops=0), now=2.0)
        (entry,) = [a for a in mod.ACTIVE.all() if a["rule"] == "deliver-w"]
        with open(hook, "a") as f:
            f.write('{"transition": "fir')  # a torn tail
        levels = [(r.levelno, r.getMessage()) for r in caplog.records if r.name == logger.name]
        caplog.clear()
        got[name] = ([e["transition"] for e in mod.WebhookFileSink.read(str(hook))],
                     [e["transition"] for e in streamed], entry["state"], levels)
        mod.ACTIVE.clear()
    assert got["port"] == got["reference"]
    assert got["port"][0] == ["pending", "firing", "resolved"]
    assert [lv for lv, _ in got["port"][3]] == [logging.ERROR] * 3


# -- the table and the cluster dedup ---------------------------------------------------

def _alert(node, transition, rule="r1", key=""):
    return {"rule": rule, "key": key, "transition": transition, "node": node,
            "severity": "warning", "kind": "threshold", "value": 1.0, "threshold": 0.5,
            "ts": 123.0}


DEDUP = {
    "n_nodes_fire_once": [("n0", "pending"), ("n1", "pending"), ("n0", "firing"),
                          ("n1", "firing"), ("n0", "resolved"), ("n1", "resolved")],
    "distinct_keys": [("n0", "firing", "mntns:1"), ("n1", "firing", "mntns:2"),
                      ("n0", "resolved", "mntns:1")],
    "node_done": [("n0", "firing"), ("n1", "firing"), ("done", "n0"), ("done", "n1")],
    "refire_new_episode": [("nA", "firing"), ("nA", "resolved"), ("nB", "firing")],
}


@pytest.mark.parametrize("case", sorted(DEDUP))
def test_cluster_dedup_matches_the_reference(case):
    got = {}
    for name, store_cls, mod in (("reference", RActive, RA), ("port", PActive, PA)):
        surfaced, returned = [], []
        store = store_cls()
        agg = mod.ClusterAlertAggregator(surfaced.append, store=store)
        for step in DEDUP[case]:
            if step[0] == "done":
                ret = agg.node_done(step[1])
                returned.append([{k: v for k, v in d.items() if k != "ts"} for d in ret])
                continue
            node, transition, *key = step
            ret = agg.observe(node, _alert(node, transition, key=key[0] if key else ""))
            returned.append(None if ret is None else ret["transition"])
        table = [{k: v for k, v in a.items() if k not in ("ts", "since")} for a in store.all()]
        got[name] = (returned, [s["transition"] for s in surfaced],
                     [sorted(s.get("nodes") or []) for s in surfaced], table, agg.active())
    assert got["port"] == got["reference"]
    assert got["port"][1]  # something surfaced


def test_active_table_trims_resolved_entries_like_the_reference():
    got = {}
    for name, store_cls in (("reference", RActive), ("port", PActive)):
        store = store_cls()
        for i in range(300):
            store.update({**_alert("n0", "firing", rule=f"r{i}"), "nodes": ["n0"]})
            store.update({**_alert("n0", "resolved", rule=f"r{i}"), "nodes": ["n0"]})
        store.update({**_alert("n0", "pending", rule="live")})
        got[name] = ([a["rule"] for a in store.all()], [a["rule"] for a in store.active()])
    assert got["port"] == got["reference"]
    assert len(got["port"][0]) == 257 and got["port"][1] == ["live"]
