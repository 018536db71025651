"""The port's fan-out (`inspektor_gadget_tpu_torch.runtime.GrpcRuntime`) on
the CPU, over real gRPC on unix sockets under pytest temp directories:

- the fan-out cases of ``tests/test_agent.py`` against three in-process
  port agents: the merged row stream names every node, the node filter
  keeps one, a node's sketch summary stream, and a node killed mid-run
  is isolated while its peers stream on;
- parity: two port agents under the port's `GrpcRuntime` and two
  reference agents under the reference's, fed the same seeded streams
  (pysynthetic seed 7 on n0, seed 8 on n1), answer `query_history`
  (pushdown on every node) and fold last summaries on the summary tier
  alike: events, distinct and entropy bit for bit, heavy hitters and the
  invertible plane equal;
- mixed fleets: port agent n0 beside reference agent n1, driven by each
  package's `GrpcRuntime` to the same answer as the pure fleets;
- the aggregation tier: `query_history(topology="auto:2")` answers as
  the flat fold and as the reference's tree.
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu.history import HISTORY as REF_HISTORY
from inspektor_gadget_tpu.runtime.grpc_runtime import GrpcRuntime as RefRuntime
from inspektor_gadget_tpu_torch.agent.client import AgentClient
from inspektor_gadget_tpu_torch.agent.service import serve
from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
from inspektor_gadget_tpu_torch.history import HISTORY
from inspektor_gadget_tpu_torch.params import Params
from inspektor_gadget_tpu_torch.runtime import CombinedGadgetResult, GrpcRuntime

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def agents(tmp_path_factory):
    d = tmp_path_factory.mktemp("fanout")
    servers, targets = [], {}
    for i in range(3):
        addr = f"unix://{d}/agent{i}.sock"
        server, _agent = serve(addr, node_name=f"node-{i}", device="cpu")
        servers.append(server)
        targets[f"node-{i}"] = addr
    yield targets
    for s in servers:
        s.stop(grace=0.5).wait(10.0)


def _exec_ctx(rate: str, timeout: float, runtime_params=None, batch: str = "256"):
    desc = get("trace", "exec")
    params = desc.params().to_params()
    params.set("source", "pysynthetic")
    params.set("rate", rate)
    params.set("batch-size", batch)
    return GadgetContext(desc, gadget_params=params, runtime_params=runtime_params,
                         timeout=timeout, device="cpu")


def test_fanout_runtime_merges_nodes(agents):
    runtime = GrpcRuntime(dict(agents))
    events = []
    try:
        result = runtime.run_gadget(_exec_ctx("5000", 1.5), on_event=events.append)
    finally:
        runtime.close()
    assert isinstance(result, CombinedGadgetResult)
    assert set(result.keys()) == {"node-0", "node-1", "node-2"}
    assert not result.errors()
    assert {e.node for e in events} == {"node-0", "node-1", "node-2"}
    assert result.partial is False
    assert result.health == {n: "healthy" for n in agents}
    assert sorted(result.contributing()) == sorted(agents)
    for node, r in result.items():
        # exact accounting: every seq received or counted as a gap
        assert r.records + r.gaps == r.last_seq, (node, r)
        assert r.records > 0 and r.reconnects == 0 and not r.shared


def test_fanout_node_filter(agents):
    runtime = GrpcRuntime(dict(agents))
    rt_params = Params(runtime.params())
    rt_params.set("node", "node-2")
    events = []
    try:
        result = runtime.run_gadget(_exec_ctx("5000", 1.0, rt_params), on_event=events.append)
    finally:
        runtime.close()
    assert set(result.keys()) == {"node-2"}
    assert events and {e.node for e in events} == {"node-2"}


def test_summary_stream_sketch_merge(agents):
    """Nodes stream sketch digests; the client merges (the low-bandwidth
    path)."""
    client = AgentClient(agents["node-0"], "node-0")
    summaries = []
    try:
        res = client.run_gadget(
            "trace", "exec",
            {"gadget.source": "pysynthetic", "gadget.rate": "50000",
             "operator.tpusketch.enable": "true", "operator.tpusketch.log2-width": "12",
             "operator.tpusketch.hll-p": "10",
             "operator.tpusketch.harvest-interval": "300ms"},
            timeout=1.5, outputs=("summary",),
            on_summary=lambda node, s: summaries.append(s))
    finally:
        client.close()
    assert res["error"] is None
    assert summaries
    assert summaries[-1]["events"] > 500
    assert summaries[-1]["heavy_hitters"]


def test_node_failure_isolated(agents, tmp_path):
    """Stop one agent mid-run: its node reports an error and ends dead,
    the others stream on and the result is labeled partial (ref:
    CombinedGadgetResult partial results, runtime.go:42-79)."""
    addr = f"unix://{tmp_path}/doomed.sock"
    doomed_server, _ = serve(addr, node_name="doomed", device="cpu")
    targets = {**agents, "doomed": addr}
    runtime = GrpcRuntime(targets)
    rt_params = Params(runtime.params())
    for k, v in (("retry-base", "50ms"), ("retry-cap", "200ms"), ("retry-horizon", "500ms"),
                 ("attempt-deadline", "300ms")):
        rt_params.set(k, v)
    events = []
    started = threading.Event()

    def on_event(e):
        events.append(e)
        if e.node == "doomed":
            started.set()

    def killer():
        started.wait(20.0)
        time.sleep(0.2)
        doomed_server.stop(grace=0).wait(10.0)

    t = threading.Thread(target=killer, daemon=True)
    t.start()
    try:
        result = runtime.run_gadget(_exec_ctx("3000", 3.0, rt_params), on_event=on_event)
    finally:
        runtime.close()
        t.join(timeout=30.0)
    healthy = {"node-0", "node-1", "node-2"}
    assert set(result.keys()) == healthy | {"doomed"}
    for n in healthy:
        assert result[n].error is None, result[n].error
        assert result[n].health == "healthy"
    assert {e.node for e in events} >= healthy | {"doomed"}
    assert result["doomed"].error and result["doomed"].health == "dead"
    assert result.partial is True
    assert sorted(result.contributing()) == sorted(healthy)


# -- parity with the reference's fan-out, and mixed fleets -----------------

BATCHES, BATCH = 4, 1024
SEEDS = {"n0": "7", "n1": "8"}
RUN_ID = "fanout-parity"  # a node's run is RUN_ID-<node>: tracer ids are per process


def _params(seed: str) -> dict:
    return {"gadget.source": "pysynthetic", "gadget.seed": seed,
            "gadget.batch-size": str(BATCH), "gadget.rate": str(BATCH),
            "operator.tpusketch.enable": "true", "operator.tpusketch.depth": "3",
            "operator.tpusketch.log2-width": "10", "operator.tpusketch.hll-p": "8",
            "operator.tpusketch.entropy-log2-width": "6", "operator.tpusketch.topk": "8",
            "operator.tpusketch.invertible": "true",
            "operator.tpusketch.inv-log2-buckets": "9",
            "operator.tpusketch.harvest-interval": "1h",
            "operator.tpusketch.history": "true",
            "operator.tpusketch.history-interval": "0"}


# subscriptions on the summary tier: (runtime package, fleet), each node of
# the fleet one agent of (package, node)
FLEETS = {"port": {"n0": "port", "n1": "port"},
          "reference": {"n0": "reference", "n1": "reference"},
          "mixed": {"n0": "port", "n1": "reference"}}
SUBSCRIPTIONS = [("port", "port"), ("reference", "reference"), ("port", "mixed"),
                 ("reference", "mixed")]


@pytest.fixture(scope="module")
def folded(tmp_path_factory):
    """Four agents (port n0, n1; reference n0, n1), each an owner's shared
    run of BATCHES batches paced at one a second; the four summary-tier
    subscriptions of SUBSCRIPTIONS attach through each package's
    GrpcRuntime before the owners end their runs for everyone."""
    from inspektor_gadget_tpu.agent.service import serve as ref_serve
    d = tmp_path_factory.mktemp("fanout-parity")
    HISTORY.set_base_dir(str(d / "port-history"))
    REF_HISTORY.set_base_dir(str(d / "ref-history"))
    servers, agents_, targets = [], {}, {}
    try:
        for kind, serve_fn in (("port", serve), ("reference", ref_serve)):
            for node in SEEDS:
                addr = f"unix://{d}/{kind}-{node}.sock"
                kw = {"device": "cpu"} if kind == "port" else {}
                server, ag = serve_fn(addr, node_name=node, **kw)
                servers.append(server)
                agents_[(kind, node)] = ag
                targets[(kind, node)] = addr

        owners: dict = {}
        stops = {key: threading.Event() for key in targets}

        def own(key):
            seen = []

            def on_batch(_n, batch):
                seen.append(batch.count)
                if len(seen) >= BATCHES:
                    stops[key].set()

            c = AgentClient(targets[key], key[1], rpc_deadline=120.0)
            try:
                out = c.run_gadget("trace", "exec", _params(SEEDS[key[1]]),
                                   run_id=f"{RUN_ID}-{key[1]}",
                                   share=True, keepalive=5.0, outputs=("batch", "summary"),
                                   on_batch=on_batch, stop_event=stops[key], stop_run=True)
            finally:
                c.close()
            owners[key] = {"out": out, "seen": seen}

        owner_threads = [threading.Thread(target=own, args=(key,), daemon=True)
                         for key in targets]
        for t in owner_threads:
            t.start()
        deadline = time.monotonic() + 60.0
        runs = {key: f"{RUN_ID}-{key[1]}" for key in targets}
        while time.monotonic() < deadline and not all(
                runs[key] in agents_[key]._streams for key in targets):
            time.sleep(0.02)

        subs: dict = {}

        def subscribe(runtime_kind: str, fleet: str):
            fleet_targets = {node: targets[(kind, node)]
                             for node, kind in FLEETS[fleet].items()}
            rt = (GrpcRuntime if runtime_kind == "port" else RefRuntime)(fleet_targets)
            last: dict = {}
            try:
                res = rt.subscribe_summaries(gadget="trace/exec", priority="high",
                                             on_summary=lambda n, s: last.__setitem__(n, s))
            finally:
                rt.close()
            subs[(runtime_kind, fleet)] = {"out": res, "last": last}

        sub_threads = [threading.Thread(target=subscribe, args=s, daemon=True)
                       for s in SUBSCRIPTIONS]
        for t in sub_threads:
            t.start()
        want_subs = {key: 1 for key in targets}
        for _rt, fleet in SUBSCRIPTIONS:
            for node, kind in FLEETS[fleet].items():
                want_subs[(kind, node)] += 1
        while time.monotonic() < deadline and not all(
                agents_[key]._streams[runs[key]].live_subscribers() >= n
                for key, n in want_subs.items()):
            time.sleep(0.02)
        attached = {key: agents_[key]._streams[runs[key]].live_subscribers()
                    for key in targets}
        for t in owner_threads + sub_threads:
            t.join(timeout=120.0)
        HISTORY.close_all()
        REF_HISTORY.close_all()
        yield {"targets": targets, "owners": owners, "subs": subs, "attached": attached,
               "want_subs": want_subs}
    finally:
        for s in servers:
            s.stop(grace=0.5).wait(10.0)
        HISTORY.close_all()
        REF_HISTORY.close_all()
        HISTORY.set_base_dir(None)
        REF_HISTORY.set_base_dir(None)


def _fleet_targets(folded, fleet: str) -> dict:
    return {node: folded["targets"][(kind, node)] for node, kind in FLEETS[fleet].items()}


def _same_summary(got: dict, want: dict) -> None:
    assert got["events"] == want["events"] == BATCHES * BATCH
    assert got["distinct"] == want["distinct"]
    assert got["entropy"] == want["entropy"]
    assert got["heavy_hitters"] == want["heavy_hitters"]
    assert got["inv"] == want["inv"] and got["inv"] is not None
    assert got["drops"] == want["drops"]


def test_the_fleets_fold_every_batch_of_their_streams(folded):
    assert folded["attached"] == folded["want_subs"]
    for key, own in folded["owners"].items():
        assert own["out"]["error"] is None, (key, own["out"]["error"])
        assert own["seen"] == [BATCH] * BATCHES, key
    for key, sub in folded["subs"].items():
        assert set(sub["out"]) == {"n0", "n1"}, key
        for node, out in sub["out"].items():
            assert out.get("error") is None, (key, node, out)
            assert out["attach"]["shared"] and out["attach"]["run_id"] == f"{RUN_ID}-{node}"
            assert out["gaps"] == 0 and out["sub_drops"] == 0 and not out["evicted"]


def test_port_fanout_folds_summaries_like_the_reference(folded):
    port, ref = folded["subs"][("port", "port")]["last"], \
        folded["subs"][("reference", "reference")]["last"]
    assert set(port) == set(ref) == {"n0", "n1"}
    for node in SEEDS:
        _same_summary(port[node], ref[node])
    # the seeds differ, so the nodes' streams do
    assert port["n0"]["heavy_hitters"] != port["n1"]["heavy_hitters"]


def _answer(runtime_cls, targets: dict) -> dict:
    rt = runtime_cls(targets)
    try:
        ans = rt.query_history(gadget="trace/exec", top=20)
    finally:
        rt.close()
    d = ans.to_dict()
    for k in ("start_ts", "end_ts"):  # each store's wall clock
        d.pop(k)
    return d


def test_port_fanout_answers_query_history_like_the_reference(folded):
    got = _answer(GrpcRuntime, _fleet_targets(folded, "port"))
    want = _answer(RefRuntime, _fleet_targets(folded, "reference"))
    assert got["paths"] == want["paths"] == {"n0": "pushdown", "n1": "pushdown"}
    assert got["windows"] == want["windows"] == 2
    assert got["events"] == want["events"] == 2 * BATCHES * BATCH
    assert got["distinct"] == want["distinct"]
    assert got["entropy_bits"] == want["entropy_bits"]
    assert got["heavy_hitters"] == want["heavy_hitters"] and got["heavy_hitters"]
    assert got["inv"] == want["inv"] and got["inv"] is not None
    assert got == want


def test_mixed_fleet_answers_alike_through_either_runtime(folded):
    mixed = _fleet_targets(folded, "mixed")
    by_port, by_ref = _answer(GrpcRuntime, mixed), _answer(RefRuntime, mixed)
    assert by_port == by_ref
    assert by_port == _answer(GrpcRuntime, _fleet_targets(folded, "port"))
    sub_port = folded["subs"][("port", "mixed")]["last"]
    sub_ref = folded["subs"][("reference", "mixed")]["last"]
    pure = folded["subs"][("port", "port")]["last"]
    for node in SEEDS:
        _same_summary(sub_port[node], sub_ref[node])
        _same_summary(sub_port[node], pure[node])


def test_query_history_topology_raises_naming_item_11(folded):
    """`query_history(topology=...)` routes through the aggregation tier
    (item 11, once a NotImplementedError naming it): over the port fleet
    it answers as the flat fold does, and as the reference's tree over
    the reference fleet; a spec that omits an agent raises TopologyError."""
    from inspektor_gadget_tpu_torch.fleet import TopologyError

    def tree(runtime_cls, targets):
        rt = runtime_cls(targets)
        try:
            d = rt.query_history(gadget="trace/exec", top=20, topology="auto:2").to_dict()
        finally:
            rt.close()
        for k in ("start_ts", "end_ts"):
            d.pop(k)
        return d

    port_targets = _fleet_targets(folded, "port")
    got = tree(GrpcRuntime, port_targets)
    flat = _answer(GrpcRuntime, port_targets)
    want = tree(RefRuntime, _fleet_targets(folded, "reference"))
    for k in ("events", "distinct", "entropy_bits", "heavy_hitters", "inv", "windows",
              "nodes", "levels"):
        assert got[k] == flat[k], k
    assert got["paths"] == {"n0": "tree", "n1": "tree"}
    assert got == want
    rt = GrpcRuntime(port_targets)
    try:
        with pytest.raises(TopologyError, match="not placed in any zone"):
            rt.query_history(gadget="trace/exec", topology="za=n0")
    finally:
        rt.close()
