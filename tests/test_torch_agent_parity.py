"""The port's agent against the reference's, both in this process on the
CPU, each on its own unix socket under a pytest temp directory:

- one RunGadget request (trace exec on pysynthetic seed 7, stopped by the
  client after a fixed number of batches) streams final summary frames
  that decode to equal summaries: events, distinct and entropy bit for
  bit, heavy hitters and the invertible plane equal;
- the catalogs are equal (descriptions aside: the port's name what it has
  not ported);
- ListWindows and FetchWindows over one store answer the same bytes;
- interop both ways: the reference's AgentClient drives the port's agent
  and the port's AgentClient drives the reference's (catalog, a run,
  DumpState).
"""

from __future__ import annotations

import threading

import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu.agent.client import AgentClient as RefClient
from inspektor_gadget_tpu.agent.service import serve as ref_serve
from inspektor_gadget_tpu.history import HISTORY as REF_HISTORY
from inspektor_gadget_tpu_torch.agent import wire
from inspektor_gadget_tpu_torch.agent.client import AgentClient
from inspektor_gadget_tpu_torch.agent.service import serve
from inspektor_gadget_tpu_torch.history import HISTORY

from _torch_registry import own_gadgets_only

torch.set_num_threads(2)

NODE = "pn0"  # both agents' node name: the window RPCs serve only their node's windows
BATCHES, BATCH = 3, 1024
PARAMS = {"gadget.source": "pysynthetic", "gadget.seed": "7",
          "gadget.batch-size": str(BATCH), "gadget.rate": str(BATCH),
          "operator.tpusketch.enable": "true", "operator.tpusketch.depth": "3",
          "operator.tpusketch.log2-width": "10", "operator.tpusketch.hll-p": "8",
          "operator.tpusketch.entropy-log2-width": "6", "operator.tpusketch.topk": "8",
          "operator.tpusketch.invertible": "true",
          "operator.tpusketch.inv-log2-buckets": "9",
          "operator.tpusketch.harvest-interval": "1h"}


@pytest.fixture(scope="module")
def agents(tmp_path_factory):
    d = tmp_path_factory.mktemp("parity")
    port_target, ref_target = f"unix://{d}/port.sock", f"unix://{d}/ref.sock"
    with own_gadgets_only():
        port_server, _ = serve(port_target, node_name=NODE, device="cpu")
        ref_server, _ = ref_serve(ref_target, node_name=NODE)
        yield {"port": port_target, "reference": ref_target}
        port_server.stop(grace=0.5).wait(10.0)
        ref_server.stop(grace=0.5).wait(10.0)


def _run(client, params: dict, n: int = BATCHES) -> tuple[dict, list, list]:
    """RunGadget at one batch a second, stopped by the client once it has
    seen `n` batches: the stop lands in the pause after batch n."""
    stop = threading.Event()
    seen, summaries = [], []

    def on_batch(_node, batch):
        seen.append(batch.count)
        if len(seen) >= n:
            stop.set()

    out = client.run_gadget("trace", "exec", params, outputs=("batch", "summary"),
                            on_batch=on_batch,
                            on_summary=lambda _n, s: summaries.append(s), stop_event=stop)
    return out, seen, summaries


def _client(kind: str, target: str):
    return (AgentClient if kind == "port" else RefClient)(target, NODE, rpc_deadline=120.0)


def test_one_request_folds_to_equal_summaries(agents):
    finals = {}
    for kind in ("reference", "port"):
        c = _client(kind, agents[kind])
        try:
            out, seen, summaries = _run(c, PARAMS)
        finally:
            c.close()
        assert out["error"] is None and out["gaps"] == 0, (kind, out["error"])
        assert seen == [BATCH] * BATCHES, (kind, seen)
        (finals[kind],) = summaries
    got, want = finals["port"], finals["reference"]
    assert got["events"] == want["events"] == BATCHES * BATCH
    assert got["distinct"] == want["distinct"]
    assert got["entropy"] == want["entropy"]
    assert got["heavy_hitters"] == want["heavy_hitters"]
    assert got["inv"] == want["inv"] and got["inv"] is not None
    assert got.get("decoded") == want.get("decoded")
    assert got["drops"] == want["drops"] and got["epoch"] == want["epoch"]


def _strip_descriptions(cat: dict) -> dict:
    def params(ps):
        return [{k: v for k, v in p.items() if k != "description"} for p in ps]
    return {
        "node": cat["node"],
        "gadgets": [{**g, "description": None, "params": params(g.get("params", []))}
                    for g in cat["gadgets"]],
        "operators": [{**o, "description": None,
                       "instanceParams": params(o.get("instanceParams", []))}
                      for o in cat["operators"]],
    }


def test_catalogs_are_equal(agents):
    cats = {}
    for kind in ("reference", "port"):
        c = _client(kind, agents[kind])
        try:
            cats[kind] = c.get_catalog(use_cache_on_error=False)
        finally:
            c.close()
    got, want = cats["port"], cats["reference"]
    assert [(g["category"], g["name"]) for g in got["gadgets"]] == \
        [(g["category"], g["name"]) for g in want["gadgets"]]
    assert _strip_descriptions(got) == _strip_descriptions(want)


def _raw(target: str, method: str, msg: dict) -> bytes:
    import grpc
    ch = grpc.insecure_channel(target)
    try:
        call = ch.unary_unary(f"/igtpu.GadgetManager/{method}",
                              request_serializer=wire.identity_serializer,
                              response_deserializer=wire.identity_deserializer)
        return call(wire.encode_msg(msg), timeout=120.0)
    finally:
        ch.close()


def test_window_rpcs_answer_the_same_bytes_over_one_store(agents, tmp_path):
    base = str(tmp_path / "history")
    HISTORY.set_base_dir(base)
    REF_HISTORY.set_base_dir(base)
    try:
        c = AgentClient(agents["port"], NODE, rpc_deadline=120.0)
        try:
            out, _seen, _ = _run(c, {**PARAMS, "operator.tpusketch.history": "true",
                                     "operator.tpusketch.history-interval": "0",
                                     "operator.tpusketch.harvest-interval": "1500ms"}, 4)
        finally:
            c.close()
        assert out["error"] is None
        HISTORY.close_all()
        req = {"gadget": "trace/exec"}
        listed = {k: _raw(agents[k], "ListWindows", req) for k in agents}
        assert listed["port"] == listed["reference"]
        header, _ = wire.decode_msg(listed["port"])
        assert len(header["windows"]) >= 2
        for offset in (0, 1):
            fetched = {k: _raw(agents[k], "FetchWindows",
                               {**req, "offset": offset, "max_bytes": 1 << 20})
                       for k in agents}
            assert fetched["port"] == fetched["reference"], offset
        h, _ = wire.decode_msg(fetched["port"])
        assert h["count"] == len(header["windows"]) - 1
    finally:
        HISTORY.close_all()
        REF_HISTORY.close_all()
        HISTORY.set_base_dir(None)
        REF_HISTORY.set_base_dir(None)


@pytest.mark.parametrize("client_kind,agent_kind", [("reference", "port"),
                                                    ("port", "reference")])
def test_each_client_drives_the_other_s_agent(agents, client_kind, agent_kind):
    c = _client(client_kind, agents[agent_kind])
    try:
        cat = c.get_catalog(use_cache_on_error=False)
        assert cat["node"] == NODE and ("trace", "exec") in \
            {(g["category"], g["name"]) for g in cat["gadgets"]}
        out, seen, summaries = _run(c, PARAMS, 2)
        assert out["error"] is None and seen == [BATCH] * 2
        assert summaries[-1]["events"] == 2 * BATCH
        state = c.dump_state()
        assert state["threads"] and "runs" in state and "flight_record" in state
        assert all(r["done"] for r in state["runs"] if r["gadget"] == "trace/exec")
    finally:
        c.close()
