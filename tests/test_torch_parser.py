"""The port's `Parser` and `SnapshotCombiner` against the JAX package's:
the cases of ``tests/test_aux.py``'s parser tests (filters, sort,
callbacks, the JSON handlers, snapshot merge, one-shot accumulation), each
run through both packages on the same events, whose answers must agree
and be the expected ones.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from inspektor_gadget_tpu import columns as RC
from inspektor_gadget_tpu import parser as RP
from inspektor_gadget_tpu import snapshotcombiner as RS
from inspektor_gadget_tpu import types as RT
from inspektor_gadget_tpu_torch import columns as PC
from inspektor_gadget_tpu_torch import parser as PP
from inspektor_gadget_tpu_torch import snapshotcombiner as PS
from inspektor_gadget_tpu_torch import types as PT


def _event_cls(C, T):
    @dataclasses.dataclass
    class Ev(T.Event):
        comm: str = C.col("", width=16)
        pid: int = C.col(0, width=7, dtype=np.int32)
        reads: int = C.col(0, width=8, group="sum", dtype=np.int64)
    return Ev


PACKAGES = {"reference": (RC, RP, RT), "port": (PC, PP, PT)}
EVENTS = [("bash", 1, 5), ("curl", 2, 9), ("bash", 3, 1), ("zsh", 4, 3), ("bash", 5, 7)]


def _both(fn):
    """fn(Parser, Ev) for each package -> (port's answer, reference's)."""
    got = {}
    for name, (C, P, T) in PACKAGES.items():
        Ev = _event_cls(C, T)
        got[name] = fn(lambda: P.Parser(C.Columns(Ev)), Ev)
    return got["port"], got["reference"]


@pytest.mark.parametrize("filters,want", [
    ("comm:bash", [1, 3, 5]),
    ("pid:>2", [3, 4, 5]),
    ("comm:bash,reads:>=5", [1, 5]),
    ("comm:~^c", [2]),
    ("", [1, 2, 3, 4, 5]),
])
def test_event_handler_filters_then_calls_back(filters, want):
    def scenario(parser, Ev):
        p = parser()
        if filters:
            p.set_filters(filters)
        got = []
        p.set_event_callback(got.append)
        for comm, pid, reads in EVENTS:
            p.event_handler(Ev(comm=comm, pid=pid, reads=reads))
        return [e.pid for e in got]
    port, ref = _both(scenario)
    assert port == ref == want


@pytest.mark.parametrize("filters,sort,want", [
    ("comm:bash", "-reads", [7, 5, 1]),
    ("", "reads", [1, 3, 5, 7, 9]),
    ("", "comm,-pid", [7, 1, 5, 9, 3]),
    ("pid:<4", "-comm", [9, 5, 1]),
])
def test_event_handler_array_filters_and_sorts(filters, sort, want):
    def scenario(parser, Ev):
        p = parser()
        if filters:
            p.set_filters(filters)
        p.set_sort(sort)
        arrays = []
        p.set_event_callback_array(arrays.append)
        p.event_handler_array([Ev(comm=c, pid=i, reads=r) for c, i, r in EVENTS])
        return [[e.reads for e in a] for a in arrays]
    port, ref = _both(scenario)
    assert port == ref == [want]


@pytest.mark.parametrize("node,payload,want", [
    ("node-9", {"comm": "x", "pid": 3}, ("node-9", "x", 3)),
    ("node-1", {"comm": "y", "pid": 4, "node": "elsewhere"}, ("elsewhere", "y", 4)),
])
def test_json_handler_keeps_or_stamps_the_node(node, payload, want):
    def scenario(parser, Ev):
        p = parser()
        got = []
        p.set_event_callback(got.append)
        p.json_handler(node)(json.dumps(payload))
        return [(e.node, e.comm, e.pid) for e in got]
    port, ref = _both(scenario)
    assert port == ref == [want]


@pytest.mark.parametrize("ttl,ticks,want", [
    (2, 1, [["a", "b"]]),
    (2, 3, [["a", "b"], ["a", "b"], []]),
    (1, 2, [["a", "b"], []]),
])
def test_snapshots_merge_nodes_until_their_ttl(ttl, ticks, want):
    def scenario(parser, Ev):
        p = parser()
        p.enable_snapshots(ttl_ticks=ttl)
        arrays = []
        p.set_event_callback_array(arrays.append)
        p.json_handler_array("n1")(json.dumps([{"comm": "a", "reads": 1}]))
        p.json_handler_array("n2")(json.dumps([{"comm": "b", "reads": 2}]))
        for _ in range(ticks):
            p.tick()
        return [sorted(e.comm for e in a) for a in arrays]
    port, ref = _both(scenario)
    assert port == ref == want


def test_json_handler_array_without_snapshots_goes_straight_through():
    def scenario(parser, Ev):
        p = parser()
        arrays = []
        p.set_event_callback_array(arrays.append)
        p.json_handler_array("n7")(json.dumps([{"comm": "a"}, {"comm": "b", "node": "n8"}]))
        return [[(e.node, e.comm) for e in a] for a in arrays]
    port, ref = _both(scenario)
    assert port == ref == [[("n7", "a"), ("n8", "b")]]


@pytest.mark.parametrize("batches", [[["a"], ["b"]], [["a", "b", "c"]], []])
def test_oneshot_accumulate_then_flush(batches):
    def scenario(parser, Ev):
        p = parser()
        arrays = []
        p.set_event_callback_array(arrays.append)
        for comms in batches:
            p.accumulate([Ev(comm=c) for c in comms])
        before = len(arrays)
        p.flush()
        p.flush()  # nothing left: no second callback
        return before, [[e.comm for e in a] for a in arrays]
    port, ref = _both(scenario)
    flat = [c for comms in batches for c in comms]
    assert port == ref == (0, [flat] if flat else [])


def test_combiner_keys_and_refresh():
    for S in (PS, RS):
        c = S.SnapshotCombiner(ttl_ticks=2)
        c.add_snapshot("n1", [1, 2])
        c.add_snapshot("n2", [3])
        assert sorted(c.get_snapshots()) == [1, 2, 3] and sorted(c.keys()) == ["n1", "n2"]
        c.add_snapshot("n1", [4])  # a refresh restarts n1's age
        assert sorted(c.get_snapshots()) == [3, 4]
        assert c.keys() == ["n1"] and c.get_snapshots() == [4] and c.keys() == []


def test_formatter_renders_like_the_reference():
    def scenario(parser, Ev):
        f = parser().formatter()
        return f.header(), f.format_event(Ev(comm="bash", pid=12, reads=3))
    port, ref = _both(scenario)
    assert port == ref
