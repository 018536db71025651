"""The port's per-node agent (`inspektor_gadget_tpu_torch.agent`) over real
gRPC on unix sockets, on the CPU: the single-node cases of
``tests/test_agent.py`` (catalog, the stream with seq, the summary
stream, the container hook RPC, DumpState, stream replay and overrun),
then what the reference's fan-out tests reach only through a fleet — the
recording RPCs down to a replay that reproduces every digest, the window
RPCs against the store they read, the checkpointer — and the port's one
departure: the agent's device.

Every agent listens on a socket under a pytest temp directory and is
stopped (and waited for) in its fixture's teardown.
"""

from __future__ import annotations

import os
import threading
import time
import urllib.request

import grpc
import pytest
import torch

import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu_torch.agent import wire
from inspektor_gadget_tpu_torch.agent.client import AgentClient
from inspektor_gadget_tpu_torch.agent.service import AgentServer, serve
from inspektor_gadget_tpu_torch.agent.stream import LOST_MARKER, GadgetStream
from inspektor_gadget_tpu_torch.runtime.runtime import build_catalog

torch.set_num_threads(2)

SKETCH = {"operator.tpusketch.enable": "true", "operator.tpusketch.depth": "3",
          "operator.tpusketch.log2-width": "10", "operator.tpusketch.hll-p": "8",
          "operator.tpusketch.entropy-log2-width": "6", "operator.tpusketch.topk": "8"}
SYNTH = {"gadget.source": "pysynthetic", "gadget.seed": "7", "gadget.batch-size": "1024"}


@pytest.fixture(scope="module")
def agent(tmp_path_factory):
    d = tmp_path_factory.mktemp("agent")
    target = f"unix://{d}/agent.sock"
    server, ag = serve(target, node_name="node-0", device="cpu")
    yield {"target": target, "agent": ag, "dir": d}
    server.stop(grace=0.5).wait(10.0)


@pytest.fixture()
def client(agent):
    c = AgentClient(agent["target"], "node-0", rpc_deadline=60.0)
    yield c
    c.close()


def _run_batches(client, params, n, **kw):
    """A RunGadget that the client stops once it has seen `n` batches;
    the gadget is paced at one batch a second, so the stop lands inside
    the pause after batch n and the run folds exactly n batches."""
    stop = threading.Event()
    seen = []

    def on_batch(_node, batch):
        seen.append(batch.count)
        if len(seen) >= n:
            stop.set()

    summaries = []
    out = client.run_gadget("trace", "exec", {**SYNTH, "gadget.rate": "1024", **params},
                            outputs=kw.pop("outputs", ("batch", "summary")),
                            on_batch=on_batch, on_summary=lambda _n, s: summaries.append(s),
                            stop_event=stop, **kw)
    return out, seen, summaries


def test_catalog_roundtrip(client):
    cat = client.get_catalog(use_cache_on_error=False)
    names = {(g["category"], g["name"]) for g in cat["gadgets"]}
    assert ("trace", "exec") in names
    assert any(op["name"] == "tpusketch" for op in cat["operators"])
    assert cat.pop("node") == "node-0"
    assert cat == build_catalog()


def test_single_node_stream_with_seq(client):
    rows = []
    res = client.run_gadget(
        "trace", "exec",
        {"gadget.source": "pysynthetic", "gadget.rate": "20000", "gadget.batch-size": "256"},
        timeout=1.0, on_json=lambda node, row: rows.append((node, row)))
    assert res["error"] is None
    assert len(rows) > 50
    assert rows[0][0] == "node-0"
    assert rows[0][1]["comm"].startswith("proc-")
    # every client-observed seq gap is covered by the agent's drop count
    assert res["gaps"] <= res["dropped"], "seq gaps exceed drop accounting"
    assert res["records"] == res["last_seq"] - res["gaps"]


def test_summary_stream_sketch_merge(client):
    """The node streams sketch digests (the low-bandwidth path)."""
    summaries = []
    res = client.run_gadget(
        "trace", "exec",
        {"gadget.source": "pysynthetic", "gadget.rate": "50000", **SKETCH,
         "operator.tpusketch.harvest-interval": "300ms"},
        timeout=1.5, outputs=("summary",), on_summary=lambda node, s: summaries.append(s))
    assert res["error"] is None
    assert summaries
    last = summaries[-1]
    assert last["events"] > 500
    assert last["heavy_hitters"]


def test_summaries_fold_exactly_the_streamed_batches(client):
    out, seen, summaries = _run_batches(
        client, {**SKETCH, "operator.tpusketch.harvest-interval": "1h"}, 3)
    assert out["error"] is None and out["gaps"] == 0
    assert seen == [1024] * 3
    (final,) = summaries
    assert final["events"] == 3 * 1024 and final["distinct"] > 0


def test_summary_only_runs_decode_no_row(client):
    """Rows ride the stream only as json: a run that asks for summaries
    alone decodes no event into a row (the agent wires no row handler),
    one that asks for json decodes every event it sends."""
    from inspektor_gadget_tpu_torch.telemetry import snapshot

    def rows() -> float:
        return snapshot().get('ig_display_rows_total{gadget="trace/exec"}', 0.0)

    before = rows()
    summaries = []
    out = client.run_gadget("trace", "exec", {**SYNTH, "gadget.rate": "4096", **SKETCH},
                            timeout=1.5, outputs=("summary",),
                            on_summary=lambda _n, s: summaries.append(s))
    assert out["error"] is None and summaries[-1]["events"] > 0
    assert rows() == before
    sent = []
    out = client.run_gadget("trace", "exec", {**SYNTH, "gadget.rate": "4096"}, timeout=1.0,
                            on_json=lambda _n, row: sent.append(row))
    assert out["error"] is None and sent
    assert rows() - before >= len(sent)


def test_container_hook_rpc(client):
    r = client.add_container({"id": "h1", "name": "hooked", "pid": 1, "mntns": 777777})
    assert r["ok"]
    assert any(c["id"] == "h1" for c in client.dump_state()["containers"])
    r2 = client.remove_container("h1")
    assert r2["ok"]


def test_dump_state_debug_rpc(client):
    client.apply_trace({"metadata": {"name": "dump-t", "annotations": {}},
                        "spec": {"gadget": "trace/exec"}})
    state = client.dump_state()
    assert "threads" in state and state["threads"]
    assert state["device"] == "cpu"
    # CRD-path state rides the same dump
    assert any(t["name"] == "dump-t" for t in state["traces"])
    for key in ("runs", "alerts", "history_tiers", "standing_queries", "pipeline",
                "accuracy", "flight_record"):
        assert key in state, key
    assert client.delete_trace("dump-t")


def test_run_requests_refused_loudly(client):
    out = client.run_gadget("trace", "nosuch", timeout=5.0)
    assert out["error"] and out["gadget_error"]
    method = client.channel.stream_stream(
        "/igtpu.GadgetManager/RunGadget", request_serializer=wire.identity_serializer,
        response_deserializer=wire.identity_deserializer)
    bad = [wire.encode_msg({"run": {"category": "trace", "name": "exec",
                                    "subscriber": {"priority": "vip"}}})]
    (reply,) = list(method(iter(bad), timeout=30.0))
    assert "unknown priority class" in wire.decode_msg(reply)[0]["error"]
    (reply,) = list(method(iter([wire.encode_msg({})]), timeout=30.0))
    assert wire.decode_msg(reply)[0]["error"] == "first message must be a run request"


# -- stream semantics (ref: stream.go tests) --------------------------------

def test_stream_replay_history():
    s = GadgetStream()
    for i in range(150):
        s.publish(i)
    sub = s.subscribe("late", replay=True)
    # only the last 100 retained
    items = list(sub.queue)
    assert len(items) == 100
    assert items[0] == 50 and items[-1] == 149


def test_stream_overrun_marks_loss():
    s = GadgetStream()
    sub = s.subscribe("slow", replay=False)
    for i in range(500):
        s.publish(i)
    items = list(sub.queue)
    assert LOST_MARKER in items
    assert len(items) <= 251


# -- the device, the bound port, the metrics endpoint ------------------------

def test_cuda_agent_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        AgentServer("n-cuda")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve("127.0.0.1:0", node_name="n-cuda")


def test_serve_binds_a_free_port_and_serves_metrics():
    server, ag = serve("127.0.0.1:0", node_name="tcp-node", device="cpu",
                       metrics_addr="127.0.0.1:0")
    try:
        assert ag.port > 0 and ag.metrics_server.port > 0
        c = AgentClient(f"127.0.0.1:{ag.port}", "tcp-node", rpc_deadline=30.0)
        try:
            assert c.get_catalog(use_cache_on_error=False)["node"] == "tcp-node"
        finally:
            c.close()
        base = f"http://127.0.0.1:{ag.metrics_server.port}"
        body = urllib.request.urlopen(f"{base}/metrics", timeout=10).read().decode()
        assert 'ig_agent_rpc_total{method="GetCatalog"}' in body
        health = urllib.request.urlopen(f"{base}/healthz", timeout=10).read().decode()
        assert '"status": "ok"' in health
    finally:
        ag.metrics_server.stop()
        server.stop(grace=0.5).wait(10.0)


def test_serve_raises_where_it_cannot_bind(tmp_path):
    with pytest.raises(RuntimeError, match="could not bind"):
        serve(f"unix://{tmp_path}/no/such/dir/a.sock", node_name="nobind", device="cpu")


# -- the recording RPCs ------------------------------------------------------

def test_recording_rpcs_fetch_and_replay_every_digest(client, tmp_path):
    from inspektor_gadget_tpu_torch.capture import RECORDINGS, iter_journals, replay_journal
    RECORDINGS.set_base_dir(str(tmp_path / "capture"))
    try:
        ack = client.start_recording("rec-a")
        assert ack["ok"] and ack["node"] == "node-0"
        assert client.start_recording("rec-a")["already"]
        out, seen, summaries = _run_batches(
            client, {**SKETCH, "operator.tpusketch.harvest-interval": "1500ms"}, 4)
        assert out["error"] is None and len(summaries) >= 2
        stopped = client.stop_recording("rec-a")
        assert stopped["ok"] and stopped["recording"]
        listing = client.list_recordings("rec-a")
        assert listing["files"] and any(r.get("id") == "rec-a" for r in listing["recordings"])
        got = client.fetch_recording("rec-a", str(tmp_path / "bundle"))
        assert got["files"] == len(listing["files"])
        assert got["bytes"] == sum(f["bytes"] for f in listing["files"])
        (jpath,) = list(iter_journals(str(tmp_path / "bundle")))
        res = replay_journal(jpath, device="cpu", param_overrides={
            "operator.tpusketch.history-dir": str(tmp_path / "rehist")})
        assert res.events == sum(seen)
        assert res.recorded_digests and res.digests_match, (res.digests, res.recorded_digests)
        # a path escaping the recording is refused, not served
        with pytest.raises(RuntimeError, match="bad fetch request"):
            client.fetch_file("rec-a", "../../etc/passwd", str(tmp_path / "x"))
        with pytest.raises(RuntimeError):
            client.stop_recording("never-started")
    finally:
        RECORDINGS.stop_all()
        RECORDINGS.set_base_dir(None)


# -- the window RPCs ---------------------------------------------------------

def test_window_rpcs_answer_from_the_node_s_store(client, tmp_path):
    from inspektor_gadget_tpu_torch.history import (HISTORY, answer_query, decode_frames,
                                                    validate_store_name)
    base = str(tmp_path / "history")
    HISTORY.set_base_dir(base)
    try:
        out, seen, summaries = _run_batches(
            client, {**SKETCH, "operator.tpusketch.harvest-interval": "1500ms",
                     "operator.tpusketch.history": "true",
                     "operator.tpusketch.history-interval": "0"}, 4)
        assert out["error"] is None
        listed = client.list_windows(gadget="trace/exec")
        rows = listed["windows"]
        assert len(rows) == len(summaries) >= 2
        assert {r["node"] for r in rows} == {"node-0"}
        frames, losses = client.fetch_windows(gadget="trace/exec", chunk_bytes=1)
        assert not losses and [h["digest"] for h, _ in frames] == [r["digest"] for r in rows]
        assert sum(w.events for w in decode_frames(frames)) == sum(seen)
        store = list(HISTORY.fetch_windows(gadget="trace/exec", node="node-0"))
        pushed = client.query_windows(gadget="trace/exec")
        assert pushed["folded"] == len(rows) and not pushed["dropped"]
        want = answer_query(decode_frames(store)).to_dict()
        got = answer_query([pushed["window"]]).to_dict()
        for k in ("events", "distinct", "entropy_bits", "heavy_hitters", "inv", "slices"):
            assert got[k] == want[k], k
        # another node's view of the same area is empty, and a store name
        # that escapes the area is refused
        assert client.list_windows(gadget="trace/none")["windows"] == []
        with pytest.raises(ValueError):
            validate_store_name("..")
        with pytest.raises(RuntimeError):
            client.list_windows(gadget="..")
    finally:
        HISTORY.close_all()
        HISTORY.set_base_dir(None)


# -- the checkpointer --------------------------------------------------------

def test_checkpointer_saves_live_runs(agent, client, tmp_path):
    from inspektor_gadget_tpu_torch.operators import tpusketch
    ag = agent["agent"]
    ckpt = tmp_path / "ckpt"
    ag.start_checkpointer(str(ckpt), interval=0.2)
    try:
        stop = threading.Event()
        t = threading.Thread(target=lambda: client.run_gadget(
            "trace", "exec", {**SYNTH, "gadget.rate": "20000", **SKETCH}, stop_event=stop,
            outputs=("summary",)), daemon=True)
        t.start()
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and not (ckpt / "trace-exec.npz").exists():
            time.sleep(0.1)
        assert (ckpt / "trace-exec.npz").exists()
        stop.set()
        t.join(timeout=30.0)
        assert not t.is_alive()
    finally:
        ag.stop_checkpointer()
        tpusketch.set_checkpoint_dir(None)
    assert os.path.getsize(ckpt / "trace-exec.npz") > 0
    # the run's gRPC teardown is done: nothing of it stays registered
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and ag._runs:
        time.sleep(0.1)
    assert not ag._runs


def test_unknown_rpc_is_unimplemented(agent):
    ch = grpc.insecure_channel(agent["target"])
    try:
        m = ch.unary_unary("/igtpu.GadgetManager/NoSuch",
                           request_serializer=wire.identity_serializer,
                           response_deserializer=wire.identity_deserializer)
        with pytest.raises(grpc.RpcError) as e:
            m(wire.encode_msg({}), timeout=30.0)
        assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED
    finally:
        ch.close()
