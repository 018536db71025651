"""The port's agent/ig.proto ↔ wire.py drift guard: the cases of
``tests/test_proto.py`` held against ``inspektor_gadget_tpu_torch`` (its
copy of ig.proto, ig_pb2.py, wire.py, the history window and the
standing-query engine), plus the proof that the port's ig.proto is the
reference's byte for byte and that both compiled stubs load into one
process (protobuf's default pool refuses a second ``ig.proto`` that
differs from the first).
"""

import pytest

pb = pytest.importorskip("google.protobuf")

from inspektor_gadget_tpu_torch.agent import ig_pb2  # noqa: E402


def test_run_request_roundtrip():
    m = ig_pb2.GadgetRunRequest(
        category="trace", name="exec", timeout=1.5, run_id="r1",
        output=["json", "summary"])
    m.params["gadget.source"] = "native"
    m2 = ig_pb2.GadgetRunRequest.FromString(m.SerializeToString())
    assert (m2.category, m2.name, m2.timeout, m2.run_id) == \
        ("trace", "exec", 1.5, "r1")
    assert dict(m2.params) == {"gadget.source": "native"}
    assert list(m2.output) == ["json", "summary"]


def test_run_request_fields_match_wire_contract():
    # service.py reads these keys from the run header (service.py
    # _run_gadget_traced). Text-level like the window/resume guards: the
    # image has no protoc, so the compiled ig_pb2 keeps the pre-resume
    # field set while ig.proto is the authoritative spec.
    wire_keys = {"category", "name", "params", "timeout", "run_id",
                 "output", "resumable", "linger", "ring",
                 "share", "keepalive", "max_subscribers", "sub_budget",
                 "subscriber"}
    assert _message_fields(_proto_source(), "GadgetRunRequest") == wire_keys


def test_event_fields_match_wire_framing():
    # client.py reads seq/type; payload carries the JSON+npz body
    proto_fields = {f.name for f in ig_pb2.GadgetEvent.DESCRIPTOR.fields}
    assert proto_fields == {"type", "seq", "payload"}


def test_container_definition_matches_hook_client():
    # agent/main.py add-container + service.add_container field set
    proto_fields = {f.name for f in
                    ig_pb2.ContainerDefinition.DESCRIPTOR.fields}
    assert {"id", "name", "pid", "mntns", "namespace", "pod"} <= proto_fields


def test_control_roundtrip_stop():
    c = ig_pb2.GadgetControlRequest(stop=True)
    c2 = ig_pb2.GadgetControlRequest.FromString(c.SerializeToString())
    assert c2.stop is True and c2.WhichOneof("request") == "stop"


# -- history-plane RPC drift guard (text-level: the container image has
# no protoc, so the .proto spec is bound to the wire contract by field
# name instead of compiled descriptors) --------------------------------------

def _proto_source() -> str:
    import pathlib
    return (pathlib.Path(__file__).parent.parent / "inspektor_gadget_tpu_torch"
            / "agent" / "ig.proto").read_text(encoding="utf-8")


def _message_fields(src: str, message: str) -> set[str]:
    import re
    m = re.search(rf"message {message} \{{(.*?)\}}", src, re.S)
    assert m, f"ig.proto: message {message} missing"
    return set(re.findall(
        r"^\s*(?:repeated\s+)?(?:map<[^>]+>|\w+)\s+(\w+)\s*=",
        m.group(1), re.M))


def test_history_rpcs_documented_in_proto():
    """service.py serves ListWindows/FetchWindows; ig.proto must
    document both on GadgetManager or the spec has drifted."""
    src = _proto_source()
    svc = src[src.index("service GadgetManager"):]
    svc = svc[:svc.index("\n}")]
    for rpc in ("ListWindows", "FetchWindows"):
        assert f"rpc {rpc}(WindowRangeRequest) returns (WindowReply)" \
            in svc, f"ig.proto: GadgetManager is missing rpc {rpc}"


def test_window_request_fields_match_wire_contract():
    # service.py _window_range + fetch_windows read exactly these keys
    assert _message_fields(_proto_source(), "WindowRangeRequest") == {
        "gadget", "start_ts", "end_ts", "start_seq", "end_seq", "key",
        "offset", "max_bytes"}


def test_window_reply_fields_match_wire_contract():
    # client.py fetch_windows reads these keys from every reply
    fields = _message_fields(_proto_source(), "WindowReply")
    assert {"ok", "node", "count", "next_offset", "eof",
            "payload"} <= fields


# -- pushdown drift guard (ISSUE 13: tiered history lifecycle) --------------

def test_query_windows_rpc_documented_in_proto():
    """service.py serves QueryWindows (node-side query fold); ig.proto
    must document it on GadgetManager or the spec has drifted."""
    src = _proto_source()
    svc = src[src.index("service GadgetManager"):]
    svc = svc[:svc.index("\n}")]
    assert ("rpc QueryWindows(QueryWindowsRequest) returns "
            "(QueryWindowsReply)") in svc, \
        "ig.proto: GadgetManager is missing rpc QueryWindows"


def test_query_windows_request_fields_match_wire_contract():
    # service.py query_windows reads gadget + _window_range keys; the
    # client sends exactly this set (client.py query_windows)
    assert _message_fields(_proto_source(), "QueryWindowsRequest") == {
        "gadget", "start_ts", "end_ts", "start_seq", "end_seq", "key"}


def test_query_windows_reply_fields_match_wire_contract():
    # client.py query_windows reads these keys off every reply (the
    # accounting contract: windows folded, levels consulted,
    # torn/dropped counts, one packed merged window)
    fields = _message_fields(_proto_source(), "QueryWindowsReply")
    assert {"ok", "node", "folded", "levels", "torn", "dropped",
            "payload"} <= fields


# -- standing-query drift guard (ISSUE 17: seal-time materialized
# answers pushed over the summary tier as EV_QUERY = 13) ---------------------

def test_standing_query_answer_documented_in_proto():
    """queries/engine.py materializes exactly these header keys and
    service.py pushes them as EV_QUERY events; the spec must carry the
    same set or the answer shape has drifted."""
    assert _message_fields(_proto_source(), "StandingQueryAnswer") == {
        "schema", "id", "gadget", "node", "stats", "key", "top",
        "range_s", "windows", "levels", "coverage_digest", "tick",
        "start_ts", "end_ts", "events", "drops"}


def test_ev_query_wire_id_matches_proto_comment():
    """EV_QUERY's numeric id is part of the wire contract (clients
    dispatch on it); the proto comment documents 13 and wire.py must
    agree."""
    from inspektor_gadget_tpu_torch.agent import wire
    assert wire.EV_QUERY == 13
    assert wire.WIRE_EVENT_IDS["EV_QUERY"] == 13
    assert "EV_QUERY" in _proto_source()


def test_standing_query_header_matches_proto_fields():
    """Build a real materialized answer and assert its header keys equal
    the proto message's field set — the engine cannot grow or drop a
    header key without the spec following."""
    import numpy as np

    from inspektor_gadget_tpu_torch.history.window import (
        SealedWindow, window_digest,
    )
    from inspektor_gadget_tpu_torch.queries import (
        StandingQuery, StandingQueryEngine,
    )
    win = SealedWindow(
        gadget="t/p", node="n0", run_id="r", window=1,
        start_ts=0.0, end_ts=1.0, events=4, drops=0,
        cms=np.ones((2, 8), np.int32), hll=np.zeros(16, np.int32),
        ent=np.zeros(8, np.float32),
        topk_keys=np.array([7], np.uint32),
        topk_counts=np.array([4], np.int64), slices={})
    win.digest = window_digest(win)
    eng = StandingQueryEngine(
        [StandingQuery(id="q", stats=("topk",), range_s=60.0)],
        gadget="t/p", node="n0")
    pubs = eng.on_seal(win, now=1.0)
    assert len(pubs) == 1
    header, _payload = pubs[0]
    assert set(header) == _message_fields(
        _proto_source(), "StandingQueryAnswer")


# -- fleet aggregation tier drift guard (ISSUE 20: merge tree) --------------

def test_fleet_aggregate_fields_match_wire_contract():
    """fleet/aggregator.py publishes exactly wire.FLEET_AGGREGATE_FIELDS
    as the accounting header beside each merged summary; the proto
    message must carry the same set or the spec has drifted."""
    from inspektor_gadget_tpu_torch.agent import wire
    assert _message_fields(_proto_source(), "FleetAggregate") == \
        set(wire.FLEET_AGGREGATE_FIELDS)


def test_fleet_aggregate_header_matches_proto_fields():
    """A real aggregator publish of the port's tier: its accounting keys
    are the proto's FleetAggregate fields, as in the reference's case."""
    from inspektor_gadget_tpu_torch.agent import wire
    from inspektor_gadget_tpu_torch.fleet import AggregatorNode
    from inspektor_gadget_tpu_torch.fleet.sim import make_window

    agg = AggregatorNode("zone-a", ["n0", "n1"], gadget="t/p")
    agg.observe("n0", make_window("n0", 1, gadget="t/p"))
    sealed, acct = agg.publish()
    assert sealed is not None
    assert set(acct) == _message_fields(_proto_source(), "FleetAggregate")
    assert acct["schema"] == wire.FLEET_AGGREGATE_SCHEMA
    assert acct["missing"] == ["n1"]
    assert acct["digest"] == sealed.digest


def test_proto_and_stubs_are_the_reference_s_byte_for_byte():
    """The wire contract is one file: the port's ig.proto and ig_pb2.py
    are the reference's copies, unchanged."""
    import pathlib
    root = pathlib.Path(__file__).parent.parent
    for name in ("ig.proto", "ig_pb2.py"):
        assert (root / "inspektor_gadget_tpu_torch" / "agent" / name).read_bytes() == \
            (root / "inspektor_gadget_tpu" / "agent" / name).read_bytes(), name


def test_port_stubs_load_beside_the_reference_s():
    from google.protobuf import descriptor_pool

    from inspektor_gadget_tpu.agent import ig_pb2 as ref_pb2
    assert ig_pb2.DESCRIPTOR is ref_pb2.DESCRIPTOR  # one file in the default pool
    assert descriptor_pool.Default().FindFileByName("ig.proto").package == "igtpu"
    m = ig_pb2.GadgetRunRequest(category="trace", name="exec")
    assert ref_pb2.GadgetRunRequest.FromString(m.SerializeToString()).name == "exec"
    svc = ig_pb2.DESCRIPTOR.services_by_name["GadgetManager"]
    assert {"GetCatalog", "RunGadget"} <= {m.name for m in svc.methods}


def test_fleet_tier_documented_in_proto():
    """The proto's fleet-tier comment must keep naming the invariants
    the tier rests on (byte-identity + the refusal-note propagation)."""
    src = _proto_source()
    assert "byte-identical to the flat fold" in src
    assert "ig-tpu/fleet-aggregate/v1" in src


# -- resume-plane drift guard (ISSUE 11: supervised streams) ----------------

def test_resume_request_documented_in_proto():
    """client.py sends {'resume': {'run_id', 'last_seq'[, 'sub_id']}}
    as the first stream message; ig.proto must document exactly that
    shape inside the control oneof or the spec has drifted."""
    src = _proto_source()
    assert _message_fields(src, "GadgetResumeRequest") == \
        {"run_id", "last_seq", "sub_id"}
    import re
    m = re.search(r"message GadgetControlRequest \{(.*?)\n\}", src, re.S)
    assert m, "ig.proto: GadgetControlRequest missing"
    assert "GadgetResumeRequest resume" in m.group(1), \
        "ig.proto: control oneof is missing the resume branch"


def test_run_request_documents_resume_opt_in():
    """service.py reads resumable/linger/ring off the run header; the
    spec must carry all three so a protoc consumer can opt in."""
    fields = _message_fields(_proto_source(), "GadgetRunRequest")
    assert {"resumable", "linger", "ring"} <= fields


# -- shared-run drift guard (ISSUE 12: one run, many subscribers) -----------

def test_attach_request_documented_in_proto():
    """client.py sends {'attach': {run_id|key, last_seq, subscriber
    options...}} as the first stream message of an attach-to-existing;
    ig.proto must document that shape inside the control oneof."""
    src = _proto_source()
    assert _message_fields(src, "GadgetAttachRequest") == {
        "run_id", "key", "last_seq", "id", "priority", "drop_policy",
        "queue", "evict_after", "tier"}
    import re
    m = re.search(r"message GadgetControlRequest \{(.*?)\n\}", src, re.S)
    assert m, "ig.proto: GadgetControlRequest missing"
    assert "GadgetAttachRequest attach" in m.group(1), \
        "ig.proto: control oneof is missing the attach branch"


def test_subscriber_options_match_wire_contract():
    """service.py _validate_sub_opts + Subscriber read exactly these
    keys off run['subscriber'] / the attach message; the spec must
    carry the same set so a protoc consumer can shape its delivery."""
    assert _message_fields(_proto_source(), "SubscriberOptions") == {
        "id", "priority", "drop_policy", "queue", "evict_after", "tier"}


def test_run_request_documents_share_opt_in():
    """service.py reads share/keepalive/max_subscribers/sub_budget/
    subscriber off the run header; the spec must carry all five so a
    protoc consumer can opt into shared runs with overload knobs."""
    fields = _message_fields(_proto_source(), "GadgetRunRequest")
    assert {"share", "keepalive", "max_subscribers", "sub_budget",
            "subscriber"} <= fields
