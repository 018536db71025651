"""Shared runs across a fleet of port agents, on the CPU: the fleet half of
``tests/test_shared_runs_e2e.py`` (its single-agent cases are
``tests/test_torch_agent_shared.py``), with the port's `GrpcRuntime`,
`ChaosProxy` and `SubscriberChurn`:

- K subscribers on one 2-node fleet run (``share=true``): each agent runs
  ONE gadget, the healthy subscribers receive identical record streams
  with contiguous per-subscriber seqs, and the fleet result is whole
  (not partial, not overloaded) with exact accounting;
- subscriber churn through a chaos proxy (every third round leaving by a
  cut) against one shared run leaves no stream state, queue or thread
  behind;
- `GrpcRuntime.subscribe_summaries`, the summary tier, delivers harvest
  summaries and sealed-window announcements and never a row or batch.

The agents are in-process port agents on unix sockets under a pytest
temp directory; where the reference reads the process-wide
``ig_agent_active_runs`` gauge (which every agent of the test process
moves), these count each agent's own runs.
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu_torch.agent import wire
from inspektor_gadget_tpu_torch.agent.client import AgentClient
from inspektor_gadget_tpu_torch.agent.service import serve
from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
from inspektor_gadget_tpu_torch.params import Params
from inspektor_gadget_tpu_torch.runtime.grpc_runtime import GrpcRuntime
from inspektor_gadget_tpu_torch.telemetry import REGISTRY
from inspektor_gadget_tpu_torch.testing.chaos import ChaosProxy, SubscriberChurn

torch.set_num_threads(2)

pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

RUN_PARAMS = {"gadget.source": "pysynthetic", "gadget.rate": "2000",
              "gadget.batch-size": "128"}


def _metric(name: str, **labels) -> float:
    total = 0.0
    for key, v in REGISTRY.snapshot().items():
        if key != name and not key.startswith(name + "{"):
            continue
        if all(f'{k}="{lv}"' in key for k, lv in labels.items()):
            total += v
    return total


@pytest.fixture(scope="module")
def shared_agents(tmp_path_factory):
    """Two in-process agents on unix sockets."""
    tmp = tmp_path_factory.mktemp("shared-fleet")
    servers, agents, targets = [], {}, {}
    for i in range(2):
        addr = f"unix://{tmp}/shared{i}.sock"
        server, agent = serve(addr, node_name=f"shnode-{i}", device="cpu")
        servers.append(server)
        agents[f"shnode-{i}"] = agent
        targets[f"shnode-{i}"] = addr
    yield {"agents": agents, "targets": targets}
    for agent in agents.values():
        for st in list(agent._streams.values()):
            if st.ctx is not None:
                st.ctx.cancel()
    for s in servers:
        s.stop(grace=0.5).wait(10.0)


def _active_runs(agents: dict) -> int:
    """Gadget runs in flight on these agents (their `_runs` tables)."""
    return sum(len(a._runs) for a in agents.values())


class _Collector:
    """Per-subscriber stream capture: seqs, data-record content keys
    (batch payload bytes), and summaries keyed by epoch."""

    def __init__(self):
        self.seqs: list[int] = []
        self.content: list[bytes] = []
        self.summaries: dict[int, tuple] = {}
        self.stop = threading.Event()
        self.out: dict = {}

    def on_message(self, _node, seq, _t):
        self.seqs.append(seq)

    def on_batch(self, _node, batch):
        self.content.append(batch.cols["key_hash"].tobytes())

    def on_summary(self, _node, s):
        self.summaries[int(s["epoch"])] = (int(s["events"]),
                                           int(s["distinct"]))


def _aligned_overlap(a: list, b: list) -> int:
    """Length of the contiguous common window of two record streams
    (each subscriber joins the SAME pipeline at its own moment, so one
    stream must be a windowed suffix of the other)."""
    if not a or not b:
        return 0
    for first, second in ((a, b), (b, a)):
        if second[0] in first:
            i = first.index(second[0])
            n = min(len(first) - i, len(second))
            if first[i:i + n] == second[:n]:
                return n
    return 0


def test_shared_fleet_run_one_gadget_k_subscribers(shared_agents):
    """The tentpole: a 2-node fleet run with share=true; two extra
    subscribers per node ride the SAME gadget (one run per agent, 2 runs
    in flight for the whole fleet), receive identical
    record streams, and their accounting is exact."""
    agents = shared_agents["agents"]
    targets = shared_agents["targets"]
    runs_before = _active_runs(agents)

    from inspektor_gadget_tpu_torch.operators import operators as op_registry
    from inspektor_gadget_tpu_torch.params import Collection

    runtime = GrpcRuntime(dict(targets))
    desc = get("trace", "exec")
    params = desc.params().to_params()
    params.set("source", "pysynthetic")
    params.set("rate", "2000")
    params.set("batch-size", "128")
    op_params = Collection()
    sp = op_registry.get("tpusketch").instance_params().to_params()
    for k, v in (("enable", "true"), ("log2-width", "10"),
                 ("hll-p", "10"), ("harvest-interval", "500ms")):
        sp.set(k, v)
    op_params["operator.tpusketch."] = sp
    rp = Params(runtime.params())
    rp.set("share", "true")
    rp.set("run-keepalive", "1s")
    ctx = GadgetContext(desc, gadget_params=params, operator_params=op_params,
                        runtime_params=rp, timeout=10.0)
    events = []
    fleet_done = threading.Event()
    fleet_holder: dict = {}

    def fleet_run():
        fleet_holder["result"] = runtime.run_gadget(
            ctx, on_event=events.append, on_batch=lambda b: None,
            on_summary=lambda n, s: None)
        fleet_done.set()

    threading.Thread(target=fleet_run, daemon=True).start()

    # wait until the shared run is registered on both agents, then
    # attach two extra subscribers per node as fast as possible (the
    # sketch warmup keeps the pipeline quiet far longer than this)
    def live_run(agent):
        for st in agent._streams.values():
            if st.shared and not st.done:
                return st
        return None

    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        if all(live_run(a) is not None for a in agents.values()):
            break
        time.sleep(0.02)
    run_states = {n: live_run(a) for n, a in agents.items()}
    assert all(run_states.values()), "shared runs never registered"

    subs: dict[tuple, _Collector] = {}
    threads = []
    for node, target in targets.items():
        for j in range(2):
            col = _Collector()
            subs[(node, j)] = col

            def pump(target=target, node=node, col=col):
                client = AgentClient(target, node)
                col.out = client.run_gadget(
                    "", "", attach_to=run_states[node].run_id,
                    subscriber={"priority": "high", "queue": 4096},
                    on_message=col.on_message, on_batch=col.on_batch,
                    on_summary=col.on_summary, stop_event=col.stop)
                client.close()

            t = threading.Thread(target=pump, daemon=True)
            t.start()
            threads.append(t)

    # ONE gadget per agent while K=3 subscribers ride each node
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if all(st.live_subscribers() >= 3 for st in run_states.values()):
            break
        time.sleep(0.05)
    for node, st in run_states.items():
        assert st.live_subscribers() >= 3, (node, st.subscriber_rows())
        assert len(agents[node]._runs) == 1, \
            f"{node} runs a private gadget per subscriber"
    assert _active_runs(agents) - runs_before == 2
    assert _metric("ig_agent_run_subscribers",
                   run=run_states["shnode-0"].run_id) >= 3.0

    # let data flow to every subscriber, then detach the extras cleanly
    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline:
        if all(len(c.content) >= 6 and len(c.summaries) >= 2
               for c in subs.values()):
            break
        time.sleep(0.1)
    for col in subs.values():
        col.stop.set()
    for t in threads:
        t.join(timeout=20.0)
    assert not fleet_done.is_set() or fleet_holder.get("result") is not None

    for (node, j), col in subs.items():
        out = col.out
        assert out["error"] is None, (node, j, out["error"])
        assert out["attach"] and out["attach"]["shared"] is True
        # exact per-subscriber accounting: contiguous seqs, no drops
        assert col.seqs == list(range(1, len(col.seqs) + 1)), (node, j)
        assert out["records"] == out["last_seq"] and out["gaps"] == 0
        assert out["sub_drops"] == 0 and out["evicted"] is False
        assert len(col.content) >= 6, (node, j, len(col.content))

    # identical record streams per node: the two subscribers' batch
    # sequences align on a long contiguous window, and their summaries
    # agree exactly on every epoch both observed
    for node in targets:
        a, b = subs[(node, 0)], subs[(node, 1)]
        overlap = _aligned_overlap(a.content, b.content)
        assert overlap >= min(len(a.content), len(b.content)) - 1 >= 5, \
            (node, len(a.content), len(b.content), overlap)
        common = set(a.summaries) & set(b.summaries)
        assert common, "no common summary epochs"
        for ep in common:
            assert a.summaries[ep] == b.summaries[ep], (node, ep)

    # the fleet run itself ends clean and labeled shared-aware
    assert fleet_done.wait(30.0)
    result = fleet_holder["result"]
    assert not result.errors(), result.errors()
    assert result.partial is False
    assert result.overloaded() == {}
    for node, r in result.items():
        assert r.records + r.gaps == r.last_seq, (node, r)
        assert r.sub_drops == 0 and not r.evicted
    runtime.close()

    # detach-all + keepalive expiry: the agents' runs return to
    # baseline and nothing lingers
    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline:
        if _active_runs(agents) == runs_before:
            break
        time.sleep(0.1)
    assert _active_runs(agents) == runs_before




def test_subscriber_churn_leaves_no_leaks(shared_agents):
    """The chaos round: attach/hold/detach churn (every 3rd round
    leaving by proxy cut) against one shared run — the run survives
    every round, and afterwards nothing lingers: no stream states, no
    leaked subscriber queues, thread count back to baseline."""
    agents = shared_agents["agents"]
    target = shared_agents["targets"]["shnode-1"]
    proxy = ChaosProxy(target)
    stop = threading.Event()
    holder: dict = {}
    baseline_threads = threading.active_count()

    def owner():
        c = AgentClient(target, "churn-owner")
        holder["out"] = c.run_gadget(
            "trace", "exec", dict(RUN_PARAMS, **{"gadget.rate": "1800"}),
            timeout=0.0, run_id="churn-e2e",
            share=True, keepalive=0.6,
            on_message=lambda *_: None, stop_event=stop)
        c.close()

    t = threading.Thread(target=owner, daemon=True)
    t.start()
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        st = agents["shnode-1"]._streams.get("churn-e2e")
        if st is not None and st.index > 0:
            break
        time.sleep(0.05)
    assert st is not None

    churn = SubscriberChurn(proxy.target, "churn-e2e", node="churner",
                            proxy=proxy,
                            subscriber={"priority": "normal",
                                        "queue": 256})
    churn.run(6, hold=0.4, cut_every=3)
    proxy.close()
    assert churn.rounds == 6 and churn.cuts == 2
    assert churn.acks >= 4, "clean rounds must ack their attach"
    assert not churn.errors, churn.errors
    assert not st.done, "subscriber churn killed the shared run"

    stop.set()
    t.join(timeout=20.0)
    assert holder["out"]["error"] is None

    # drain: keepalive + retire window pass; registries and threads
    # return to baseline — no leaked queues, threads, or lingering runs
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        if "churn-e2e" not in agents["shnode-1"]._streams \
                and threading.active_count() <= baseline_threads + 4:
            break
        time.sleep(0.2)
    assert "churn-e2e" not in agents["shnode-1"]._streams, \
        "stream state leaked past its retire window"
    assert threading.active_count() <= baseline_threads + 4, \
        "subscriber churn leaked threads"
    assert _metric("ig_agent_run_subscribers", run="churn-e2e") == 0.0


def test_summary_tier_gets_summaries_never_batches(shared_agents, tmp_path):
    """The summary pub/sub tier: a tier=summary subscriber on a shared
    run with history enabled receives harvest summaries and
    sealed-window announcements from the ONE shared harvest — and not a
    single raw row/batch/log message."""
    import os
    agents = shared_agents["agents"]
    target = shared_agents["targets"]["shnode-0"]
    from inspektor_gadget_tpu_torch.history import HISTORY
    hist = str(tmp_path / "history")
    HISTORY.set_base_dir(hist)
    stop = threading.Event()
    holder: dict = {}
    params = dict(RUN_PARAMS)
    params.update({"operator.tpusketch.enable": "true",
                   "operator.tpusketch.log2-width": "10",
                   "operator.tpusketch.hll-p": "10",
                   "operator.tpusketch.harvest-interval": "400ms",
                   "operator.tpusketch.history": "true",
                   "operator.tpusketch.history-interval": "0",
                   "operator.tpusketch.history-log2-width": "10",
                   "operator.tpusketch.history-slots": "4"})

    def owner():
        c = AgentClient(target, "sum-owner")
        holder["out"] = c.run_gadget(
            "trace", "exec", params, timeout=0.0, run_id="summary-e2e",
            share=True, keepalive=0.5,
            outputs=("json", "batch", "summary"),
            on_message=lambda *_: None, stop_event=stop)
        c.close()

    t = threading.Thread(target=owner, daemon=True)
    t.start()
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        st = agents["shnode-0"]._streams.get("summary-e2e")
        if st is not None and not st.done:
            break
        time.sleep(0.05)
    assert st is not None

    # the cheap consumer: a GrpcRuntime-level summary subscription
    runtime = GrpcRuntime({"shnode-0": target})
    summaries: list = []
    windows: list = []
    kinds: list = []
    sub_stop = threading.Event()
    threading.Timer(4.0, sub_stop.set).start()
    client_kinds_seen = kinds.append
    res = runtime.subscribe_summaries(
        gadget="trace/exec",
        on_summary=lambda n, s: (summaries.append(s),
                                 client_kinds_seen(wire.EV_SUMMARY)),
        on_window=lambda n, w: (windows.append(w),
                                client_kinds_seen(wire.EV_WINDOW)),
        stop_event=sub_stop)
    runtime.close()
    out = res["shnode-0"]
    assert out.get("error") is None, out
    assert out["attach"] and out["attach"]["shared"] is True
    assert summaries, "summary tier delivered no summaries"
    assert windows, "summary tier delivered no window announcements"
    assert all(w.get("digest") and w.get("events", 0) >= 0
               for w in windows)
    # zero raw records reached this subscriber: every seq-bearing
    # message it got was summary-tier (the out['records'] count equals
    # what the summary/window/notice handlers saw, and no batch handler
    # even existed to call)
    assert out["records"] >= len(summaries) + len(windows)
    rows = {s["sub_id"]: s for r in [agents["shnode-0"]._streams[
        "summary-e2e"]] for s in r.subscriber_rows()}
    tier_rows = [s for s in rows.values() if s["tier"] == "summary"]
    assert tier_rows and all(s["drops"] == 0 for s in tier_rows)

    stop.set()
    t.join(timeout=20.0)
    assert holder["out"]["error"] is None
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and not st.done:
        time.sleep(0.1)
    HISTORY.close_all()
    HISTORY.set_base_dir(None)
    assert os.path.isdir(hist)


# ---------------------------------------------------------------------------
# SharedRun-level regressions (review findings): anonymous-resume routing
# and detached-subscriber expiry
