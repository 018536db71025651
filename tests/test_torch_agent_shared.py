"""Shared runs on the port's agent: one gadget run, many subscribers, on
one agent on the CPU — the eight cases of ``tests/test_shared_runs_e2e.py``
with the fleet taken out (the fleet half, with the port's fan-out
runtime and chaos proxy, is ``tests/test_torch_shared_fleet.py``; the
`fleet runs` CLI runs in ``tests/test_torch_cli_routes.py``): the owner is an AgentClient
run request with ``share=True``, the other subscribers attach to it.

- K subscribers ride ONE gadget (run registry and active-runs gauge
  counted once), K2's plain version folds each batch once, and the
  healthy subscribers receive identical record streams with contiguous
  per-subscriber seqs;
- a stalled low-priority subscriber drops on its own queue and is
  evicted with a labeled terminal record while its peer streams on;
- detach-all starts the keepalive countdown and a re-attach within it
  rides the same run;
- admission control refuses typed (memory budget, max subscribers);
- attach/detach churn, some rounds leaving by closing the channel,
  leaves no stream state, queue or thread behind;
- the summary tier gets summaries and window announcements, never a
  batch or a row;
- the owner's whole-run stop ends the run for every subscriber, each
  receiving the one final harvest;
- the SharedRun-level cases: anonymous resume and detached expiry.
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu_torch.agent import wire
from inspektor_gadget_tpu_torch.agent.client import AgentClient
from inspektor_gadget_tpu_torch.agent.service import SharedRun, serve
from inspektor_gadget_tpu_torch.ops import kernels as K
from inspektor_gadget_tpu_torch.telemetry import REGISTRY

torch.set_num_threads(2)

pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

NODE = "shnode-0"
RUN_PARAMS = {"gadget.source": "pysynthetic", "gadget.rate": "2000",
              "gadget.batch-size": "128"}
SKETCH = {"operator.tpusketch.enable": "true", "operator.tpusketch.log2-width": "10",
          "operator.tpusketch.hll-p": "10", "operator.tpusketch.harvest-interval": "500ms"}


def _metric(name: str, **labels) -> float:
    total = 0.0
    for key, v in REGISTRY.snapshot().items():
        if key != name and not key.startswith(name + "{"):
            continue
        if all(f'{k}="{lv}"' in key for k, lv in labels.items()):
            total += v
    return total


@pytest.fixture(scope="module")
def shared_agent(tmp_path_factory):
    d = tmp_path_factory.mktemp("shared")
    target = f"unix://{d}/shared.sock"
    server, agent = serve(target, node_name=NODE, device="cpu")
    yield {"agent": agent, "target": target}
    for st in list(agent._streams.values()):
        if st.ctx is not None:
            st.ctx.cancel()
    server.stop(grace=0.5).wait(10.0)


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
        self.summaries[int(s["epoch"])] = (int(s["events"]), int(s["distinct"]))


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


def _wait_for(pred, timeout: float, step: float = 0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(step)
    return pred()


def _owner(target: str, holder: dict, stop: threading.Event, params: dict, **kw):
    def run():
        c = AgentClient(target, "owner", rpc_deadline=60.0)
        try:
            holder["out"] = c.run_gadget("trace", "exec", params, timeout=0.0, share=True,
                                         on_message=lambda *_: None, stop_event=stop, **kw)
        finally:
            c.close()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_shared_run_one_gadget_k_subscribers(shared_agent, monkeypatch):
    """The tentpole on one node: an owner and two attached subscribers
    ride the SAME gadget (one run, the active-runs gauge counts 1),
    receive identical record streams, their accounting is exact, and
    K2's plain version ran once a batch, not once a subscriber."""
    agent, target = shared_agent["agent"], shared_agent["target"]
    plain = []
    monkeypatch.setattr(K, "fused_planes_plain",
                        lambda *a, _f=K.fused_planes_plain: plain.append(1) or _f(*a))
    runs_before = _metric("ig_agent_active_runs")
    owner_stop, owner_holder = threading.Event(), {}
    t_owner = _owner(target, owner_holder, owner_stop, {**RUN_PARAMS, **SKETCH},
                     run_id="k-e2e", keepalive=0.5, outputs=("batch", "summary"),
                     subscriber={"priority": "high", "queue": 4096})
    st = _wait_for(lambda: agent._streams.get("k-e2e"), 20.0)
    assert st is not None, "shared run never registered"

    subs = [_Collector() for _ in range(2)]
    threads = []
    for col in subs:
        def pump(col=col):
            c = AgentClient(target, "sub", rpc_deadline=60.0)
            try:
                col.out = c.run_gadget(
                    "", "", attach_to="k-e2e", subscriber={"priority": "high", "queue": 4096},
                    on_message=col.on_message, on_batch=col.on_batch,
                    on_summary=col.on_summary, stop_event=col.stop)
            finally:
                c.close()
        t = threading.Thread(target=pump, daemon=True)
        t.start()
        threads.append(t)

    assert _wait_for(lambda: st.live_subscribers() >= 3, 10.0), st.subscriber_rows()
    assert len([r for r in agent._runs if r == "k-e2e"]) == 1
    assert _metric("ig_agent_active_runs") - runs_before == 1.0
    assert _metric("ig_agent_run_subscribers", run="k-e2e") >= 3.0

    _wait_for(lambda: all(len(c.content) >= 6 and len(c.summaries) >= 2 for c in subs),
              20.0, 0.1)
    for col in subs:
        col.stop.set()
    for t in threads:
        t.join(timeout=20.0)
        assert not t.is_alive()
    for j, col in enumerate(subs):
        out = col.out
        assert out["error"] is None, (j, out["error"])
        assert out["attach"] and out["attach"]["shared"] is True
        assert col.seqs == list(range(1, len(col.seqs) + 1)), j
        assert out["records"] == out["last_seq"] and out["gaps"] == 0
        assert out["sub_drops"] == 0 and out["evicted"] is False
        assert len(col.content) >= 6, (j, len(col.content))
    a, b = subs
    overlap = _aligned_overlap(a.content, b.content)
    assert overlap >= min(len(a.content), len(b.content)) - 1 >= 5, \
        (len(a.content), len(b.content), overlap)
    common = set(a.summaries) & set(b.summaries)
    assert common, "no common summary epochs"
    for ep in common:
        assert a.summaries[ep] == b.summaries[ep], ep

    owner_stop.set()
    t_owner.join(timeout=20.0)
    assert owner_holder["out"]["error"] is None
    assert _wait_for(lambda: st.done, 20.0, 0.1), "keepalive expiry never stopped the gadget"
    assert st.index <= 1024, "the ring wrapped: batch count below would undercount"
    batches = sum(1 for _i, kind, _h, _p in st._ring if kind == wire.EV_BATCH_NPZ)
    assert batches >= 6 and len(plain) == batches, (len(plain), batches)
    assert _wait_for(lambda: _metric("ig_agent_active_runs") == runs_before, 15.0, 0.1)


def test_stalled_low_priority_subscriber_dropped_and_evicted(shared_agent):
    """Overload protection: a low-priority subscriber whose client stops
    draining accumulates drops on ITS OWN 4-deep queue, is evicted after
    its stall window with a labeled terminal record, and the healthy
    peer on the same run never sees a gap, a drop, or a stall."""
    agent, target = shared_agent["agent"], shared_agent["target"]
    evictions_before = _metric("ig_agent_subscriber_evictions_total")
    owner_stop, owner_holder = threading.Event(), {}
    params = dict(RUN_PARAMS, **{"gadget.rate": "3000", "gadget.batch-size": "256"})
    t_owner = _owner(target, owner_holder, owner_stop, params, run_id="evict-e2e",
                     keepalive=1.0, outputs=("batch",), subscriber={"priority": "high"})
    st = _wait_for(lambda: (s := agent._streams.get("evict-e2e")) is not None
                   and s.index > 0 and s, 20.0)
    assert st and not st.done, "shared run never produced"

    gate = threading.Event()
    victim_holder: dict = {}

    def victim():
        c = AgentClient(target, "victim", rpc_deadline=60.0)
        try:
            victim_holder["out"] = c.run_gadget(
                "", "", attach_to="evict-e2e",
                subscriber={"priority": "low", "queue": 4, "evict_after": 0.8,
                            "drop_policy": "drop-oldest"},
                on_message=lambda *_: gate.wait(60.0))
        finally:
            c.close()

    t_victim = threading.Thread(target=victim, daemon=True)
    t_victim.start()
    peer = _Collector()

    def peer_pump():
        c = AgentClient(target, "peer", rpc_deadline=60.0)
        try:
            peer.out = c.run_gadget("", "", attach_to="evict-e2e",
                                    subscriber={"priority": "normal", "queue": 4096},
                                    on_message=peer.on_message, stop_event=peer.stop)
        finally:
            c.close()

    t_peer = threading.Thread(target=peer_pump, daemon=True)
    t_peer.start()

    rows = _wait_for(lambda: [s for s in st.subscriber_rows()
                              if s["priority"] == "low" and s["evicted"]], 45.0, 0.1)
    assert rows, f"agent never evicted the wedged subscriber: {st.subscriber_rows()}"
    assert rows[0]["drops"] > 0, rows[0]
    gate.set()
    t_victim.join(timeout=60.0)
    assert not t_victim.is_alive(), "evicted subscriber stream never ended"
    out = victim_holder["out"]
    assert out["evicted"] is True
    assert "evicted" in (out["error"] or "")
    assert out["sub_drops"] > 0, "no drops accounted before eviction"
    assert _metric("ig_agent_subscriber_evictions_total") >= evictions_before + 1.0
    assert _metric("ig_agent_subscriber_drops_total", run="evict-e2e",
                   policy="drop-oldest", **{"class": "low"}) >= float(out["sub_drops"])

    assert agent._streams.get("evict-e2e") is st and not st.done, \
        "eviction hurt the shared run"
    time.sleep(0.5)
    peer.stop.set()
    t_peer.join(timeout=20.0)
    assert peer.out["error"] is None
    assert peer.out["sub_drops"] == 0 and peer.out["evicted"] is False
    assert peer.seqs == list(range(1, len(peer.seqs) + 1))
    assert peer.out["records"] == peer.out["last_seq"]
    # the eviction shows in DumpState's subscriber rows (the fleet-runs view)
    c = AgentClient(target, "probe", rpc_deadline=60.0)
    try:
        (row,) = [r for r in c.shared_runs() if r["run_id"] == "evict-e2e"]
    finally:
        c.close()
    assert any(s["evicted"] and s["priority"] == "low" for s in row["subscribers"]), row
    assert row["dropped"] >= out["sub_drops"]
    owner_stop.set()
    t_owner.join(timeout=20.0)
    assert owner_holder["out"]["error"] is None


def test_detach_all_keepalive_reattach_without_restart(shared_agent):
    """Dashboard churn must not thrash capture: when every subscriber
    leaves, the gadget keeps running for run-keepalive seconds; a
    re-attach inside the window rides the SAME run (same context object,
    same stream state, subscriber count back up) with no restart."""
    agent, target = shared_agent["agent"], shared_agent["target"]
    ka_params = dict(RUN_PARAMS, **{"gadget.rate": "2100"})
    stop1, h1 = threading.Event(), {}
    t1 = _owner(target, h1, stop1, ka_params, run_id="ka-e2e", keepalive=3.0)
    st = _wait_for(lambda: (s := agent._streams.get("ka-e2e")) is not None
                   and s.index > 0 and s, 20.0)
    assert st
    ctx_before = agent._runs.get("ka-e2e")
    assert ctx_before is not None

    stop1.set()
    t1.join(timeout=20.0)
    assert h1["out"]["error"] is None
    _wait_for(lambda: not st.is_attached(), 5.0)
    assert not st.is_attached()
    assert not st.done, "gadget stopped instead of keeping alive"
    assert st.keepalive_remaining() > 0.0
    assert st.live_subscribers() == 0

    col, h2 = _Collector(), {}

    def second():
        c = AgentClient(target, "ka-2", rpc_deadline=60.0)
        try:
            h2["out"] = c.run_gadget("trace", "exec", ka_params, timeout=0.0,
                                     run_id="ignored", share=True,
                                     on_message=col.on_message, stop_event=col.stop)
        finally:
            c.close()

    t2 = threading.Thread(target=second, daemon=True)
    t2.start()
    assert _wait_for(lambda: col.seqs, 10.0), "re-attached subscriber got no records"
    assert agent._runs.get("ka-e2e") is ctx_before, "keepalive re-attach restarted the gadget"
    assert agent._streams.get("ka-e2e") is st
    assert st.live_subscribers() == 1
    col.stop.set()
    t2.join(timeout=20.0)
    assert h2["out"]["error"] is None
    assert h2["out"]["attach"]["run_id"] == "ka-e2e"
    assert h2["out"]["attach"]["shared"] is True
    assert _wait_for(lambda: st.done, 15.0, 0.1), "keepalive expiry never stopped the gadget"


def test_admission_control_refuses_typed(shared_agent):
    """max-subscribers and the per-run subscriber budget refuse with a
    TYPED reason the client surfaces; low priority is refused at a
    budget level where high is still admitted."""
    target = shared_agent["target"]
    refused_before = _metric("ig_agent_attach_refused_total", reason="max-subscribers")
    stop, holder = threading.Event(), {}
    t = _owner(target, holder, stop, dict(RUN_PARAMS, **{"gadget.rate": "1900"}),
               run_id="adm-e2e", keepalive=0.2, max_subscribers=2, sub_budget=2048,
               subscriber={"queue": 1024, "priority": "high"})
    client = AgentClient(target, "adm-probe", rpc_deadline=60.0)
    try:
        assert _wait_for(lambda: any(r["run_id"] == "adm-e2e"
                                     for r in client.shared_runs()), 20.0)
        # budget: 1024 (owner) of 2048 used. A low-priority 512-queue
        # would reach 1536 > 60% of 2048 → refused; the same queue at
        # high priority fits → admitted
        low = client.run_gadget("", "", attach_to="adm-e2e",
                                subscriber={"priority": "low", "queue": 512}, timeout=5.0)
        assert low["attach_refused"] == "memory-budget", low
        assert "attach refused" in (low["error"] or "")
        assert _metric("ig_agent_attach_refused_total", reason="memory-budget") >= 1.0

        keep, high_holder = threading.Event(), {}

        def high_sub():
            c2 = AgentClient(target, "adm-high", rpc_deadline=60.0)
            try:
                high_holder["out"] = c2.run_gadget(
                    "", "", attach_to="adm-e2e", subscriber={"priority": "high", "queue": 512},
                    on_message=lambda *_: None, stop_event=keep)
            finally:
                c2.close()

        th = threading.Thread(target=high_sub, daemon=True)
        th.start()
        rows = _wait_for(lambda: [r for r in client.shared_runs()
                                  if r["run_id"] == "adm-e2e"
                                  and r["live_subscribers"] >= 2], 10.0)
        assert rows and rows[0]["live_subscribers"] == 2, rows
        third = client.run_gadget("", "", attach_to="adm-e2e",
                                  subscriber={"priority": "high"}, timeout=5.0)
        assert third["attach_refused"] == "max-subscribers", third
        assert _metric("ig_agent_attach_refused_total",
                       reason="max-subscribers") >= refused_before + 1.0
        # malformed options refuse loudly CLIENT-side before the wire
        with pytest.raises(ValueError):
            client.run_gadget("", "", attach_to="adm-e2e", subscriber={"priority": "vip"})
        keep.set()
        th.join(timeout=20.0)
        assert high_holder["out"]["error"] is None
    finally:
        client.close()
        stop.set()
        t.join(timeout=20.0)
    assert holder["out"]["error"] is None


def test_subscriber_churn_leaves_no_leaks(shared_agent):
    """Attach/hold/detach churn against one shared run, every 3rd round
    leaving by closing its channel mid-stream: the run survives every
    round, and afterwards nothing lingers — no stream state, no
    subscriber gauge, thread count back to baseline."""
    agent, target = shared_agent["agent"], shared_agent["target"]
    baseline_threads = threading.active_count()
    stop, holder = threading.Event(), {}
    t = _owner(target, holder, stop, dict(RUN_PARAMS, **{"gadget.rate": "1800"}),
               run_id="churn-e2e", keepalive=0.6, resumable=True, linger=1.0)
    st = _wait_for(lambda: (s := agent._streams.get("churn-e2e")) is not None
                   and s.index > 0 and s, 20.0)
    assert st

    acks, cuts, errors = 0, 0, []
    for rnd in range(6):
        c = AgentClient(target, f"churn-{rnd}", rpc_deadline=60.0)
        leave = threading.Event()
        res: dict = {}

        def pump(c=c, leave=leave, res=res):
            res["out"] = c.run_gadget("", "", attach_to="churn-e2e",
                                      subscriber={"priority": "normal", "queue": 256},
                                      on_message=lambda *_: None, stop_event=leave)

        th = threading.Thread(target=pump, daemon=True)
        th.start()
        time.sleep(0.4)
        if rnd % 3 == 2:
            c.close()  # the transport dies under the stream
            cuts += 1
        else:
            leave.set()
        th.join(timeout=20.0)
        assert not th.is_alive(), rnd
        c.close()
        out = res["out"]
        if out.get("attach"):
            acks += 1
        if out["error"] is not None:
            errors.append((rnd, out["error"]))
        assert not st.done, f"churn round {rnd} killed the shared run"
    assert cuts == 2 and acks >= 4, "clean rounds must ack their attach"
    assert not errors, errors

    stop.set()
    t.join(timeout=20.0)
    assert holder["out"]["error"] is None
    assert _wait_for(lambda: "churn-e2e" not in agent._streams
                     and threading.active_count() <= baseline_threads + 4, 20.0, 0.2), \
        (list(agent._streams), threading.active_count(), baseline_threads)
    assert _metric("ig_agent_run_subscribers", run="churn-e2e") == 0.0


def test_summary_tier_gets_summaries_never_batches(shared_agent, tmp_path):
    """A tier=summary subscriber on a shared run with history enabled
    receives harvest summaries and sealed-window announcements from the
    ONE shared harvest — and not a single raw row, batch or log."""
    from inspektor_gadget_tpu_torch.history import HISTORY
    agent, target = shared_agent["agent"], shared_agent["target"]
    HISTORY.set_base_dir(str(tmp_path / "history"))
    stop, holder = threading.Event(), {}
    params = {**RUN_PARAMS, **SKETCH, "operator.tpusketch.harvest-interval": "400ms",
              "operator.tpusketch.history": "true",
              "operator.tpusketch.history-interval": "0",
              "operator.tpusketch.history-log2-width": "10",
              "operator.tpusketch.history-slots": "4"}
    try:
        t = _owner(target, holder, stop, params, run_id="summary-e2e", keepalive=0.5,
                   outputs=("json", "batch", "summary"))
        st = _wait_for(lambda: (s := agent._streams.get("summary-e2e")) is not None
                       and not s.done and s, 20.0)
        assert st
        summaries, windows, raw = [], [], []
        sub_stop = threading.Event()
        timer = threading.Timer(4.0, sub_stop.set)
        timer.start()
        c = AgentClient(target, "sum-sub", rpc_deadline=60.0)
        try:
            out = c.run_gadget("", "", attach_to="summary-e2e",
                               subscriber={"tier": "summary", "priority": "low"},
                               on_summary=lambda _n, s: summaries.append(s),
                               on_window=lambda _n, w: windows.append(w),
                               on_batch=lambda *_: raw.append("batch"),
                               on_json=lambda *_: raw.append("json"),
                               on_log=lambda *_: raw.append("log"),
                               stop_event=sub_stop)
        finally:
            timer.cancel()
            c.close()
        assert out.get("error") is None, out
        assert out["attach"] and out["attach"]["shared"] is True
        assert summaries, "summary tier delivered no summaries"
        assert windows, "summary tier delivered no window announcements"
        assert all(w.get("digest") and w.get("events", 0) >= 0 for w in windows)
        assert raw == [], "the summary tier saw raw records"
        assert out["records"] >= len(summaries) + len(windows)
        tier_rows = [s for s in st.subscriber_rows() if s["tier"] == "summary"]
        assert tier_rows and all(s["drops"] == 0 for s in tier_rows)
        stop.set()
        t.join(timeout=20.0)
        assert holder["out"]["error"] is None
        assert _wait_for(lambda: st.done, 10.0, 0.1)
    finally:
        stop.set()
        HISTORY.close_all()
        HISTORY.set_base_dir(None)


def test_stop_run_ends_a_shared_run_for_every_subscriber(shared_agent, monkeypatch):
    """The owner's whole-run stop (`stop_run=True`, the agent's
    ``{"stop": "run"}``): a summary-tier subscriber that joined by a
    compatible request (the share key) and the owner both receive the
    run's one final harvest, as the same frame but for their own seq,
    and K2's plain version folded each batch once."""
    from inspektor_gadget_tpu_torch.agent import client as client_mod
    agent, target = shared_agent["agent"], shared_agent["target"]
    plain = []
    monkeypatch.setattr(K, "fused_planes_plain",
                        lambda *a, _f=K.fused_planes_plain: plain.append(1) or _f(*a))
    frames: dict[str, list[bytes]] = {}
    decode = wire.decode_msg

    def spy(data):
        h, p = decode(data)
        if h.get("type") == wire.EV_SUMMARY:
            frames.setdefault(threading.current_thread().name, []).append(data)
        return h, p

    monkeypatch.setattr(client_mod.wire, "decode_msg", spy)
    params = {**RUN_PARAMS, "gadget.rate": "2300", **SKETCH,
              "operator.tpusketch.harvest-interval": "1h"}
    owner_stop, outs = threading.Event(), {}

    def run(name, **kw):
        c = AgentClient(target, name, rpc_deadline=60.0)
        try:
            outs[name] = c.run_gadget("trace", "exec", params, share=True,
                                      outputs=("summary",), **kw)
        finally:
            c.close()

    t_owner = threading.Thread(target=run, args=("owner",), name="owner", daemon=True,
                               kwargs={"stop_event": owner_stop, "stop_run": True,
                                       "run_id": "stoprun-e2e", "keepalive": 5.0})
    t_owner.start()
    st = _wait_for(lambda: (s := agent._streams.get("stoprun-e2e")) is not None
                   and s.index == 0 and not s.done and s, 20.0)
    assert st
    t_sub = threading.Thread(target=run, args=("subscriber",), name="subscriber", daemon=True,
                             kwargs={"subscriber": {"tier": "summary"}})
    t_sub.start()
    assert _wait_for(lambda: st.live_subscribers() == 2, 10.0), st.subscriber_rows()
    time.sleep(0.5)
    owner_stop.set()
    t_owner.join(timeout=30.0)
    t_sub.join(timeout=30.0)
    assert not t_owner.is_alive() and not t_sub.is_alive()
    assert outs["owner"]["error"] is None and outs["subscriber"]["error"] is None
    assert outs["subscriber"]["attach"]["run_id"] == "stoprun-e2e"
    assert st.done
    (mine,), (theirs,) = frames["owner"], frames["subscriber"]

    def without_seq(frame):
        h, p = decode(frame)
        return wire.encode_msg({k: v for k, v in h.items() if k != "seq"}, p)

    assert without_seq(mine) == without_seq(theirs)
    events = decode(mine)[0]["events"]
    assert events > 0 and len(plain) == events // 128 and events % 128 == 0


# -- SharedRun-level regressions: anonymous-resume routing and
# detached-subscriber expiry --------------------------------------------------

def test_anonymous_resume_prefers_detached_subscriber():
    """A resume without sub_id must resolve to a DETACHED subscriber —
    picking the attached primary would hijack a live peer's stream."""
    run = SharedRun("route-run", "trace/route", shared=True, keepalive=5.0, node="t")
    a = run.admit({"queue": 64})
    run.attach_subscriber(a, 0)
    b = run.admit({"queue": 64})
    _qb, gen_b, _ack = run.attach_subscriber(b, 0)
    for _ in range(5):
        run.push(wire.EV_PAYLOAD_JSON, {"node": "t"}, b"x")
    run.detach(b, gen_b)
    assert a.attached and not b.attached

    resolved = run.resume("", b.seq)
    assert resolved is not None
    sub, _q, _gen, ack = resolved
    assert sub is b, "anonymous resume hijacked the attached primary"
    assert ack["sub_id"] == b.sub_id
    assert a.attached, "the live peer must be untouched"
    resolved2 = run.resume(a.sub_id, a.seq)
    assert resolved2 is not None and resolved2[0] is a
    run.finish()


def test_detached_subscriber_expires_and_frees_its_slot():
    """A subscriber that disconnects and never resumes must not hold a
    max-subscribers slot past the resume window (`linger`)."""
    run = SharedRun("expire-run", "trace/expire", shared=True, linger=0.2, keepalive=5.0,
                    max_subscribers=2, sub_budget=1 << 20, node="t")
    a = run.admit({"queue": 64})
    run.attach_subscriber(a, 0)
    b = run.admit({"queue": 64})
    _qb, gen_b, _ack = run.attach_subscriber(b, 0)
    run.detach(b, gen_b)

    refused = run.admit({"queue": 64})
    assert isinstance(refused, dict) and refused["reason"] == "max-subscribers"

    time.sleep(0.3)
    run.push(wire.EV_PAYLOAD_JSON, {"node": "t"}, b"x")
    assert b.left, "detached subscriber never expired past its window"
    assert run.resume(b.sub_id, 0) is None
    c = run.admit({"queue": 64})
    assert not isinstance(c, dict), c
    assert run.live_subscribers() == 2
    run.finish()


def test_trailers_and_the_sentinel_never_evict_a_record():
    """A full subscriber queue takes the run's trailers (drop accounting,
    result) and its end-of-stream past its bound: no queued record is
    evicted after the drop count went out, so the client's seq gaps
    never exceed the drops the trailer reports."""
    run = SharedRun("trailer-run", "trace/trailer", node="t")
    sub = run.admit({"queue": 4})
    q, _gen, _ack = run.attach_subscriber(sub, 0)
    for _ in range(4 + 8):  # the bound, then the maxsize slack of an attach
        run.push(wire.EV_PAYLOAD_JSON, {"node": "t"}, b"x")
    for _ in range(5):  # drop-oldest: each evicts one queued record
        run.push(wire.EV_PAYLOAD_JSON, {"node": "t"}, b"x")
    dropped = run.dropped
    assert dropped == 5 and q.full()
    run.push(wire.EV_CONTROL_ACK, {"dropped": dropped}, force=True)
    run.finish()
    assert run.dropped == dropped, "a trailer or the sentinel evicted a record"
    got = []
    while not q.empty():
        got.append(q.get_nowait())
    assert got[-1] is None
    headers = [wire.decode_msg(m)[0] for m in got[:-1]]
    assert headers[-1]["type"] == wire.EV_CONTROL_ACK and headers[-1]["dropped"] == 5
    seqs = [h["seq"] for h in headers]
    gaps = sum(b - a - 1 for a, b in zip([0] + seqs, seqs))
    assert gaps == dropped
