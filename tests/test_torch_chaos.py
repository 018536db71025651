"""The port's chaos tier on the CPU: supervised fan-out streams through the
port's `ChaosProxy` and `AgentProcess` against port agents — the
``chaos_agents`` cases of ``tests/test_chaos_soak.py`` and its acceptance
end to end:

- resume at the client level: a proxy-cut stream re-attaches with
  `resume {run_id, last_seq}`, the ring replays with no duplicate seq,
  an unknown run answers `unknown_run`; a detached run lingers visible
  in DumpState and cancels itself after its linger window;
- shared runs under fault: a cut subscriber leaves the run and its peers
  whole; SIGKILLing the agent under a shared run answers unknown_run to
  every subscriber, each backfilling from the dead life's sealed windows
  alike;
- a supervised 2-node fan-out survives a connection cut (exact
  accounting, not partial); a node that never heals ends dead and the
  result partial; an unknown gadget is a fatal gadget error;
- the acceptance: a 3-agent run survives a SIGKILL and respawn (its
  sealed windows backfill-merge into the result) and a blackhole
  partition of ~2.7x the backoff horizon that heals.

The soak (`slow`, outside tier-1) repeats mixed faults over four nodes
with subscriber churn against a shared run and checks the invariants;
its scaling points land as PerfRecords in a ledger of its own
(`perf.ledger.append_record`), as the reference's soak's do.
In-process agents run on the CPU (``device="cpu"``); `AgentProcess`
starts ``--device cpu`` agents.
"""

from __future__ import annotations

import json
import random
import tempfile
import threading
import time

import pytest
import torch

import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu_torch.agent.client import AgentClient
from inspektor_gadget_tpu_torch.agent.service import serve
from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
from inspektor_gadget_tpu_torch.params import Params
from inspektor_gadget_tpu_torch.runtime.grpc_runtime import GrpcRuntime
from inspektor_gadget_tpu_torch.runtime.supervisor import (
    FATAL, TRANSPORT, FleetHealth, RetryPolicy, classify_error,
)
from inspektor_gadget_tpu_torch.telemetry import REGISTRY
from inspektor_gadget_tpu_torch.testing.chaos import AgentProcess, ChaosProxy, SubscriberChurn

torch.set_num_threads(2)

pytestmark = pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")


def _counter_value(name: str, **labels) -> float:
    """Sum of the family's samples matching every given label pair
    (label order in the exposition follows declaration, not the call)."""
    total = 0.0
    for key, v in REGISTRY.snapshot().items():
        if key != name and not key.startswith(name + "{"):
            continue
        if all(f'{k}="{lv}"' in key for k, lv in labels.items()):
            total += v
    return total



# ---------------------------------------------------------------------------
# resume protocol (client ↔ agent through a chaos proxy)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chaos_agents():
    """Two in-process agents on unix sockets, each behind a TCP chaos
    proxy; yields {node: (proxy, unix_target)}."""
    tmp = tempfile.mkdtemp()
    servers, proxies, targets = [], {}, {}
    for i in range(2):
        addr = f"unix://{tmp}/chaos{i}.sock"
        server, _agent = serve(addr, node_name=f"cnode-{i}", device="cpu")
        servers.append(server)
        proxy = ChaosProxy(addr)
        proxies[f"cnode-{i}"] = proxy
        targets[f"cnode-{i}"] = proxy.target
    yield {"proxies": proxies, "targets": targets}
    for p in proxies.values():
        p.close()
    for s in servers:
        s.stop(grace=0.5)


RUN_PARAMS = {"gadget.source": "pysynthetic", "gadget.rate": "2000",
              "gadget.batch-size": "128"}


def test_resume_replays_ring_without_duplicate_seqs(chaos_agents):
    proxy = chaos_agents["proxies"]["cnode-0"]
    target = chaos_agents["targets"]["cnode-0"]
    client = AgentClient(target, "cnode-0")
    seqs1: list[int] = []
    got_enough = threading.Event()

    def on_msg1(_n, seq, _t):
        seqs1.append(seq)
        if len(seqs1) >= 50:
            got_enough.set()

    holder: dict = {}

    def run1():
        holder["out"] = client.run_gadget(
            "trace", "exec", RUN_PARAMS, timeout=0.0,
            run_id="resume-unit", resumable=True, linger=8.0, ring=8192,
            on_message=on_msg1)

    t = threading.Thread(target=run1, daemon=True)
    t.start()
    assert got_enough.wait(20.0), "no stream traffic before the cut"
    proxy.cut()
    t.join(timeout=20.0)
    assert not t.is_alive(), "cut stream did not return"
    out1 = holder["out"]
    assert out1["error"], "a severed stream must surface a transport error"
    assert classify_error(out1["error"]) == TRANSPORT, out1["error"]
    last1 = out1["last_seq"]
    assert last1 >= 50
    # exact accounting on the first leg
    assert out1["records"] + out1["gaps"] == last1

    # re-attach after the cut: replay starts at last_seq+1, no overlap
    client.reconnect()
    stop = threading.Event()
    seqs2: list[int] = []

    def on_msg2(_n, seq, _t):
        seqs2.append(seq)
        if len(seqs2) >= 50:
            stop.set()

    out2 = client.run_gadget(
        "trace", "exec", RUN_PARAMS, timeout=0.0,
        run_id="resume-unit", resume_from=last1,
        on_message=on_msg2, stop_event=stop)
    client.close()
    assert out2["error"] is None, out2["error"]
    ack = out2["resume"]
    assert ack and ack["run_id"] == "resume-unit"
    assert ack["missed"] == 0, "8192-deep ring must cover a fast cut"
    assert seqs2, "no messages after resume"
    assert min(seqs2) == last1 + 1, "replay must start right after last_seq"
    assert not (set(seqs1) & set(seqs2)), "duplicate seqs across resume"
    assert seqs2 == sorted(seqs2)
    assert out2["records"] + out2["gaps"] == out2["last_seq"] - last1


def test_resume_unknown_run_is_reported(chaos_agents):
    target = chaos_agents["targets"]["cnode-1"]
    client = AgentClient(target, "cnode-1")
    out = client.run_gadget("trace", "exec", {}, timeout=0.0,
                            run_id="never-started", resume_from=123)
    client.close()
    assert out["unknown_run"] is True
    assert "unknown run" in (out["error"] or "")
    # the supervisor branches on unknown_run BEFORE classification —
    # restart fresh + backfill, not resume-retry
    assert not out["resume"]


def test_lingering_run_visible_then_self_cancels(chaos_agents):
    proxy = chaos_agents["proxies"]["cnode-1"]
    target = chaos_agents["targets"]["cnode-1"]
    client = AgentClient(target, "cnode-1")
    started = threading.Event()

    def run1():
        client.run_gadget("trace", "exec", RUN_PARAMS, timeout=0.0,
                          run_id="linger-unit", resumable=True, linger=1.0,
                          on_message=lambda *_: started.set())

    t = threading.Thread(target=run1, daemon=True)
    t.start()
    assert started.wait(20.0)
    proxy.cut()
    t.join(timeout=20.0)

    # a second client sees the detached run awaiting resume…
    probe = AgentClient(target, "cnode-1", rpc_deadline=5.0)
    deadline = time.monotonic() + 5.0
    row = None
    while time.monotonic() < deadline:
        rows = [r for r in probe.dump_state().get("runs", [])
                if r["run_id"] == "linger-unit"]
        if rows and not rows[0]["attached"] and not rows[0]["done"]:
            row = rows[0]
            break
        time.sleep(0.1)
    assert row, "detached run not visible in DumpState"
    assert row["resumable"] and row["detached_for"] >= 0.0

    # …and `debug state` shows it to a user, and the fleet health CLI
    # renders it as awaiting resume
    from inspektor_gadget_tpu_torch.cli.main import main as cli_main
    import io
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["debug", "state", "--remote", f"cnode-1={target}"])
    assert rc == 0
    shown = json.loads(buf.getvalue().split("\n", 1)[1])
    assert any(r["run_id"] == "linger-unit" and not r["attached"] and r["resumable"]
               for r in shown["runs"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["fleet", "health", "--remote", f"cnode-1={target}"])
    assert rc == 0
    assert "awaiting resume: linger-unit" in buf.getvalue()

    # past the linger window the run cancels itself and the stream
    # state retires — no zombie gadget, no registry growth
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        rows = [r for r in probe.dump_state().get("runs", [])
                if r["run_id"] == "linger-unit" and not r["done"]]
        if not rows:
            break
        time.sleep(0.2)
    assert not rows, "detached run did not cancel after its linger window"
    probe.close()
    client.close()


# ---------------------------------------------------------------------------
# shared-run subscribers under fault
# ---------------------------------------------------------------------------

def test_cut_subscriber_leaves_shared_run_whole(chaos_agents):
    """A subscriber severed mid-stream is THAT subscriber's problem:
    the shared gadget keeps capturing, the owner's stream never blips,
    and the dead subscriber lingers detached awaiting a resume instead
    of taking the run down with it."""
    target = chaos_agents["targets"]["cnode-0"]
    sub_proxy = ChaosProxy(target)  # the subscriber's own breakable path
    owner_stop = threading.Event()
    owner_holder: dict = {}
    owner_seqs: list[int] = []
    started = threading.Event()

    def owner():
        client = AgentClient(target, "cnode-0")
        owner_holder["out"] = client.run_gadget(
            "trace", "exec",
            dict(RUN_PARAMS, **{"gadget.rate": "1600"}),
            timeout=0.0, run_id="sub-cut", share=True, keepalive=1.0,
            on_message=lambda _n, s, _t: (owner_seqs.append(s),
                                          started.set()),
            stop_event=owner_stop)
        client.close()

    t_owner = threading.Thread(target=owner, daemon=True)
    t_owner.start()
    assert started.wait(30.0), "shared run never produced"

    sub_holder: dict = {}
    sub_seqs: list[int] = []

    def subscriber():
        client = AgentClient(sub_proxy.target, "cut-sub")
        sub_holder["out"] = client.run_gadget(
            "", "", attach_to="sub-cut",
            subscriber={"queue": 1024},
            on_message=lambda _n, s, _t: sub_seqs.append(s))
        client.close()

    t_sub = threading.Thread(target=subscriber, daemon=True)
    t_sub.start()
    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline and len(sub_seqs) < 20:
        time.sleep(0.05)
    assert len(sub_seqs) >= 20, "subscriber saw no traffic before the cut"
    owner_before_cut = len(owner_seqs)
    sub_proxy.cut()
    t_sub.join(timeout=20.0)
    assert not t_sub.is_alive()
    out = sub_holder["out"]
    assert out["error"], "a severed subscriber must surface its error"
    assert classify_error(out["error"]) == TRANSPORT

    # the run and the owner are untouched; the cut subscriber's state
    # lingers detached (resumable by the resume protocol, per subscriber)
    time.sleep(0.7)
    probe = AgentClient(target, "probe", rpc_deadline=5.0)
    rows = [r for r in probe.dump_state().get("runs", [])
            if r["run_id"] == "sub-cut"]
    probe.close()
    assert rows and not rows[0]["done"], "subscriber cut killed the run"
    assert len(owner_seqs) > owner_before_cut, "owner stream blipped"
    sub_rows = {s["sub_id"]: s for s in rows[0]["subscribers"]}
    cut_rows = [s for s in sub_rows.values()
                if not s["attached"] and not s["left"]]
    assert cut_rows, f"cut subscriber not lingering: {sub_rows}"
    owner_stop.set()
    t_owner.join(timeout=20.0)
    assert owner_holder["out"]["error"] is None
    # exact accounting end to end for the owner despite the peer's death
    o = owner_holder["out"]
    assert o["records"] + o["gaps"] == o["last_seq"]
    assert o["sub_drops"] == 0
    sub_proxy.close()


def test_agent_sigkill_subscribers_unknown_run_then_independent_backfill(
        tmp_path_factory):
    """SIGKILL the agent under a shared run with two subscribers: BOTH
    resumes answer unknown_run (the new life has nothing to resume),
    and each subscriber's supervisor heals its own gap from the dead
    life's sealed windows INDEPENDENTLY — two clients, two fetches,
    the same sealed truth."""
    from inspektor_gadget_tpu_torch.history import HISTORY
    from inspektor_gadget_tpu_torch.runtime.supervisor import NodeSupervisor

    hist = str(tmp_path_factory.mktemp("subkill-history"))
    tmp = tempfile.mkdtemp()
    addr = f"unix://{tmp}/subkill.sock"
    proc = AgentProcess("subkill-node", addr, history_dir=hist)
    proc.start(wait=True, timeout=90.0)
    clients: list[AgentClient] = []
    try:
        params = {"gadget.source": "pysynthetic", "gadget.rate": "2000",
                  "operator.tpusketch.enable": "true",
                  "operator.tpusketch.log2-width": "10",
                  "operator.tpusketch.hll-p": "10",
                  "operator.tpusketch.harvest-interval": "300ms",
                  "operator.tpusketch.history": "true",
                  "operator.tpusketch.history-interval": "0",
                  "operator.tpusketch.history-log2-width": "10",
                  "operator.tpusketch.history-slots": "4"}
        # warm the subprocess's sketch path so the measured life seals
        warm = AgentClient(addr, "subkill-node")
        warm.run_gadget("trace", "exec", params, timeout=1.5,
                        outputs=("summary",))
        warm.close()

        owner_stop = threading.Event()
        holder: dict = {}
        got = threading.Event()

        def owner():
            c = AgentClient(addr, "subkill-node")
            clients.append(c)
            holder["owner"] = c.run_gadget(
                "trace", "exec", params, timeout=0.0, run_id="subkill",
                share=True, resumable=True, keepalive=8.0,
                outputs=("summary",),
                on_message=lambda *_: got.set(), stop_event=owner_stop)

        def second():
            c = AgentClient(addr, "subkill-2")
            clients.append(c)
            holder["second"] = c.run_gadget(
                "", "", attach_to="subkill",
                on_message=lambda *_: None)

        t1 = threading.Thread(target=owner, daemon=True)
        t1.start()
        assert got.wait(60.0), "shared run never produced"
        t2 = threading.Thread(target=second, daemon=True)
        t2.start()
        time.sleep(2.5)  # let the run seal a few 300ms windows

        kill_wall = time.time()
        proc.kill()
        t1.join(timeout=30.0)
        t2.join(timeout=30.0)
        assert holder["owner"]["error"] and holder["second"]["error"]
        proc.respawn(wait=True, timeout=90.0)

        # every subscriber's resume answers unknown_run on the new life
        for name, last in (("subkill-r1", holder["owner"]["last_seq"]),
                           ("subkill-r2", 0)):
            c = AgentClient(addr, name)
            out = c.run_gadget("trace", "exec", {}, timeout=0.0,
                               run_id="subkill", resume_from=int(last))
            c.close()
            assert out["unknown_run"] is True, (name, out)

        # each subscriber's supervisor backfills INDEPENDENTLY from the
        # dead life's sealed windows
        health = FleetHealth(["subkill-node"])
        outs = []
        for name in ("bf-1", "bf-2"):
            c = AgentClient(addr, name)
            sup = NodeSupervisor(
                "subkill-node", c,
                policy=RetryPolicy(base=0.05, cap=0.2, horizon=2.0,
                                   attempt_deadline=1.0),
                health=health, run_id="subkill", gadget="trace/exec",
                done=lambda: True)
            out = {"backfill": [], "backfilled": 0}
            sup._backfill(kill_wall - 30.0, time.time() + 1.0, out)
            c.close()
            outs.append(out)
        for out in outs:
            assert out["backfilled"] > 0, \
                "subscriber recovered nothing from the dead life"
        assert outs[0]["backfilled"] == outs[1]["backfilled"], \
            "independent backfills must recover the same sealed truth"
    finally:
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001 — dead channels
                pass
        proc.stop()
        HISTORY.close_all()


# ---------------------------------------------------------------------------
# supervised fan-out (fast e2e)
# ---------------------------------------------------------------------------

def _fast_runtime_params(runtime, **overrides):
    p = Params(runtime.params())
    defaults = {"retry-base": "50ms", "retry-cap": "400ms",
                "attempt-deadline": "1s", "retry-horizon": "2s",
                "resume-ring": "16384", "resume-linger": "8s",
                "straggler-floor": "1s"}
    defaults.update(overrides)
    for k, v in defaults.items():
        p.set(k, v)
    return p


def test_supervised_fanout_survives_cut(chaos_agents):
    targets = dict(chaos_agents["targets"])
    runtime = GrpcRuntime(targets)
    desc = get("trace", "exec")
    params = desc.params().to_params()
    params.set("source", "pysynthetic")
    params.set("rate", "1500")
    params.set("batch-size", "128")
    ctx = GadgetContext(desc, gadget_params=params,
                        runtime_params=_fast_runtime_params(runtime),
                        timeout=5.0)
    events = []

    def cutter():
        time.sleep(1.2)
        chaos_agents["proxies"]["cnode-0"].cut()

    threading.Thread(target=cutter, daemon=True).start()
    result = runtime.run_gadget(ctx, on_event=events.append)
    runtime.close()

    assert set(result.keys()) == set(targets)
    assert not result.errors(), result.errors()
    assert result["cnode-0"].reconnects >= 1
    assert result["cnode-0"].health == "healthy"
    assert result.partial is False
    assert result.health == {"cnode-0": "healthy", "cnode-1": "healthy"}
    assert sorted(result.contributing()) == sorted(targets)
    # events flowed from both nodes, including post-cut
    assert {e.node for e in events} == set(targets)
    # EXACT accounting: every seq is either received or a counted gap
    for node, r in result.items():
        assert r.records + r.gaps == r.last_seq, (node, r)
    assert _counter_value("ig_fleet_reconnects_total",
                          node="cnode-0") >= 1.0


def test_never_healing_node_is_dead_and_result_partial(chaos_agents):
    # one real node + one target nobody serves (connection refused):
    # the run must complete in bounded time with the dead node LABELED
    # dead and the combined result explicitly partial
    targets = {"cnode-0": chaos_agents["targets"]["cnode-0"],
               "ghost": "127.0.0.1:1"}
    runtime = GrpcRuntime(targets)
    desc = get("trace", "exec")
    params = desc.params().to_params()
    params.set("source", "pysynthetic")
    params.set("rate", "1000")
    ctx = GadgetContext(desc, gadget_params=params,
                        runtime_params=_fast_runtime_params(
                            runtime, **{"retry-horizon": "600ms",
                                        "attempt-deadline": "400ms"}),
                        timeout=2.5)
    t0 = time.monotonic()
    result = runtime.run_gadget(ctx, on_event=lambda e: None)
    elapsed = time.monotonic() - t0
    runtime.close()

    assert elapsed < 30.0, "never-healing node must not wedge the run"
    assert result["cnode-0"].error is None
    assert result["ghost"].error, "dead node must carry its last error"
    assert result["ghost"].health == "dead"
    assert result.health["ghost"] == "dead"
    assert result.partial is True
    assert result.contributing() == ["cnode-0"]
    assert _counter_value("ig_runtime_node_errors_total", node="ghost",
                          **{"class": "transport"}) >= 1.0


def test_unknown_gadget_is_a_gadget_error(chaos_agents):
    """A run-setup refusal (unknown gadget) reaches the client flagged
    gadget_error so the supervisor classifies it fatal, not transport."""
    client = AgentClient(chaos_agents["targets"]["cnode-0"], "cnode-0")
    out = client.run_gadget("trace", "no-such-gadget", {}, timeout=1.0)
    client.close()
    assert out["error"]
    assert out["gadget_error"] is True
    assert classify_error(out["error"],
                          gadget_error=out["gadget_error"]) == FATAL



# ---------------------------------------------------------------------------
# the chaos ACCEPTANCE e2e: SIGKILL+respawn and a healed 2×-horizon partition
# ---------------------------------------------------------------------------

def test_chaos_acceptance_sigkill_respawn_and_partition_heal(
        tmp_path_factory):
    """3-agent run under chaos proxies (the chaos tier's acceptance):

    - `aknode` (real subprocess) is SIGKILLed mid-run and respawned on
      the same address + history dir: the resume finds `unknown_run`,
      capture restarts fresh, and the killed life's SEALED windows
      backfill-merge into the node's result (accounted in
      ig_fleet_backfilled_records_total),
    - `anode-1` is blackhole-partitioned for ~2.7× the backoff horizon,
      passes through `dead`, heals, and resumes from last_seq with ring
      replay (exact seq accounting, no duplicates by construction),
    - `anode-0` is never faulted — the in-run control: the partitioned
      node's server-side sketch totals must match it within a documented
      tolerance, because its agent kept capturing the whole time.

    The run completes without manual intervention and the result is NOT
    partial (every node healed)."""
    from inspektor_gadget_tpu_torch.history import HISTORY, merge_windows
    from inspektor_gadget_tpu_torch.operators import operators as op_registry
    from inspektor_gadget_tpu_torch.params import Collection

    hist_base = str(tmp_path_factory.mktemp("chaos-history"))
    tmp = tempfile.mkdtemp()
    servers, proxies, targets = [], {}, {}
    HISTORY.set_base_dir(hist_base)
    agent_proc = None
    runtime = None
    try:
        for i in range(2):
            addr = f"unix://{tmp}/acc{i}.sock"
            server, _ = serve(addr, node_name=f"anode-{i}", device="cpu")
            servers.append(server)
            proxies[f"anode-{i}"] = ChaosProxy(addr)
            targets[f"anode-{i}"] = proxies[f"anode-{i}"].target
        ak_addr = f"unix://{tmp}/acc-k.sock"
        agent_proc = AgentProcess("aknode", ak_addr, history_dir=hist_base)
        agent_proc.start(wait=True, timeout=90.0)
        proxies["aknode"] = ChaosProxy(ak_addr)
        targets["aknode"] = proxies["aknode"].target

        # warm the fresh subprocess's sketch path (jit compiles on first
        # harvest): the measured first life must spend its time SEALING
        # windows, not compiling — otherwise the pre-kill life can end
        # with nothing sealed and there is nothing to backfill
        warm = AgentClient(ak_addr, "aknode")
        warm.run_gadget("trace", "exec",
                        {"gadget.source": "pysynthetic",
                         "gadget.rate": "2000",
                         "operator.tpusketch.enable": "true",
                         "operator.tpusketch.log2-width": "10",
                         "operator.tpusketch.hll-p": "10",
                         "operator.tpusketch.harvest-interval": "300ms"},
                        timeout=1.5, outputs=("summary",))
        warm.close()

        desc = get("trace", "exec")
        params = desc.params().to_params()
        params.set("source", "pysynthetic")
        params.set("rate", "600")
        params.set("batch-size", "64")
        op_params = Collection()
        sp = op_registry.get("tpusketch").instance_params().to_params()
        for k, v in (("enable", "true"), ("log2-width", "10"),
                     ("hll-p", "10"), ("harvest-interval", "500ms"),
                     ("history", "true"), ("history-interval", "0"),
                     ("history-log2-width", "10"), ("history-slots", "4")):
            sp.set(k, v)
        op_params["operator.tpusketch."] = sp

        runtime = GrpcRuntime(targets)
        ctx = GadgetContext(
            desc, gadget_params=params, operator_params=op_params,
            runtime_params=_fast_runtime_params(
                runtime, **{"retry-horizon": "1500ms",
                            "attempt-deadline": "1s"}),
            timeout=14.0)

        events = []
        summaries: dict = {}

        def on_summary(node, s):
            summaries.setdefault(node, []).append(s)

        def chaos_script():
            time.sleep(3.0)
            # (b) partition anode-1 ~2.7× the 1.5s horizon, then heal
            proxies["anode-1"].partition(mode="blackhole")
            # (a) SIGKILL the real agent mid-run; respawn on the same
            # address + dirs (no waiting — the supervisor's retry loop
            # must discover the new life on its own). By now the first
            # life has sealed several 500ms windows — the state the
            # backfill recovers.
            time.sleep(1.5)
            agent_proc.kill()
            agent_proc.respawn(wait=False)
            time.sleep(2.5)
            proxies["anode-1"].heal()

        threading.Thread(target=chaos_script, daemon=True).start()
        result = runtime.run_gadget(ctx, on_event=events.append,
                                    on_summary=on_summary)

        assert set(result.keys()) == {"anode-0", "anode-1", "aknode"}
        # the run completed without manual intervention, nobody wedged,
        # and every node healed → the answer is NOT partial
        assert not result.errors(), result.errors()
        assert result.partial is False, result.health

        # (b) the partitioned node: went through dead (2× horizon),
        # resurrected, resumed from last_seq with exact accounting
        r1 = result["anode-1"]
        assert r1.reconnects >= 1
        assert r1.health == "healthy"
        assert r1.records + r1.gaps == r1.last_seq
        assert _counter_value("ig_fleet_transitions_total",
                              node="anode-1", to="dead") >= 1.0
        assert _counter_value("ig_fleet_reconnects_total",
                              node="anode-1") >= 1.0

        # (a) the killed node: reconnected to its NEW life and healed
        # the gap from the old life's sealed windows
        rk = result["aknode"]
        assert rk.reconnects >= 1
        assert rk.health == "healthy"
        assert rk.backfilled > 0, \
            "killed node must recover sealed windows from its past life"
        assert rk.backfill, "backfilled SealedWindows must ride the result"
        merged = merge_windows(rk.backfill)
        assert merged.events == rk.backfilled
        assert _counter_value("ig_fleet_backfilled_records_total",
                              node="aknode") >= float(rk.backfilled)

        # delivered stream: the resumed node stays within tolerance of
        # the in-run control (its agent captured through the partition
        # into the replay ring — resume is NOT restart)
        per_node = {n: 0 for n in targets}
        for e in events:
            per_node[e.node] += 1
        assert per_node["anode-0"] > 200, per_node
        assert per_node["anode-1"] >= 0.55 * per_node["anode-0"], per_node
        assert per_node["aknode"] > 0, per_node

        # server-side sketch totals: partitioned node ≈ control within
        # the documented tolerance (docs/robustness.md: rate-jitter
        # bound, not sketch error — CMS totals are exact adds)
        ev0 = max(s["events"] for s in summaries["anode-0"])
        ev1 = max(s["events"] for s in summaries["anode-1"])
        assert ev1 >= 0.55 * ev0, (ev0, ev1)
    finally:
        if runtime is not None:
            runtime.close()
        for p in proxies.values():
            p.close()
        if agent_proc is not None:
            agent_proc.stop()
        for s in servers:
            s.stop(grace=0.5)
        HISTORY.close_all()
        HISTORY.set_base_dir(None)


# ---------------------------------------------------------------------------
# the full soak: N nodes, repeated mixed faults, invariants + scaling points
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_soak_fleet_chaos_invariants_and_scaling(tmp_path_factory):
    """ROADMAP soak invariants at 4 nodes over ~20s of injected chaos:
    no wedged run, exact per-node seq accounting (received + gaps ==
    last_seq), every node healthy at the end, stream states drained
    (no leaked lingering runs), bounded thread growth, and the N-node
    merge/ingest scaling points published as schema-valid PerfRecords
    so fleet-scale regressions can gate like speed regressions."""
    from inspektor_gadget_tpu_torch.history import HISTORY, decode_frames, merge_windows
    from inspektor_gadget_tpu_torch.operators import operators as op_registry
    from inspektor_gadget_tpu_torch.params import Collection
    from inspektor_gadget_tpu_torch.perf.ledger import append_record, read_ledger
    from inspektor_gadget_tpu_torch.perf.provenance import build_provenance
    from inspektor_gadget_tpu_torch.perf.schema import make_record

    n_nodes = 4
    hist_base = str(tmp_path_factory.mktemp("soak-history"))
    tmp = tempfile.mkdtemp()
    HISTORY.set_base_dir(hist_base)
    servers, agents, proxies, targets = [], [], {}, {}
    runtime = None
    baseline_threads = threading.active_count()
    try:
        for i in range(n_nodes):
            addr = f"unix://{tmp}/soak{i}.sock"
            server, agent = serve(addr, node_name=f"snode-{i}", device="cpu")
            servers.append(server)
            agents.append(agent)
            proxies[f"snode-{i}"] = ChaosProxy(addr)
            targets[f"snode-{i}"] = proxies[f"snode-{i}"].target

        desc = get("trace", "exec")
        params = desc.params().to_params()
        params.set("source", "pysynthetic")
        params.set("rate", "1200")
        params.set("batch-size", "128")
        op_params = Collection()
        sp = op_registry.get("tpusketch").instance_params().to_params()
        for k, v in (("enable", "true"), ("log2-width", "10"),
                     ("hll-p", "10"), ("harvest-interval", "1s"),
                     ("history", "true"), ("history-interval", "0"),
                     ("history-log2-width", "10"), ("history-slots", "4")):
            sp.set(k, v)
        op_params["operator.tpusketch."] = sp

        runtime = GrpcRuntime(targets)
        ctx = GadgetContext(
            desc, gadget_params=params, operator_params=op_params,
            runtime_params=_fast_runtime_params(
                runtime, **{"share": "true", "run-keepalive": "1s"}),
            timeout=20.0)

        events = []
        faults = {"count": 0}

        def chaos_loop():
            rng = random.Random(11)
            nodes = sorted(proxies)
            time.sleep(2.0)
            while faults["count"] < 6:
                node = nodes[faults["count"] % len(nodes)]
                kind = faults["count"] % 3
                if kind == 0:
                    proxies[node].cut()
                elif kind == 1:
                    proxies[node].set_latency(0.05 + rng.random() * 0.1)
                    time.sleep(1.0)
                    proxies[node].heal()
                else:
                    proxies[node].partition(mode="blackhole")
                    time.sleep(1.2)
                    proxies[node].heal()
                faults["count"] += 1
                time.sleep(1.3)

        # subscriber churn rides the soak: dashboard clients attach and
        # leave (some by proxy cut) against snode-0's SHARED run while
        # the connection chaos plays out — the leak/thread invariants
        # below now cover the multiplexing plane too
        churn = SubscriberChurn(
            targets["snode-0"], f"{ctx.run_id}-snode-0",
            node="soak-churner", proxy=proxies["snode-0"],
            subscriber={"queue": 256, "priority": "low"})

        def churn_loop():
            time.sleep(3.0)  # let the shared run start producing
            stop_at = time.monotonic() + 12.0
            while time.monotonic() < stop_at:
                churn.round(hold=0.6, cut=(churn.rounds % 4 == 3))

        t0 = time.monotonic()
        threading.Thread(target=chaos_loop, daemon=True).start()
        threading.Thread(target=churn_loop, daemon=True).start()
        result = runtime.run_gadget(ctx, on_event=events.append)
        duration = time.monotonic() - t0

        # invariant: no wedged run, every node answered and healed
        assert set(result.keys()) == set(targets)
        assert not result.errors(), result.errors()
        assert result.partial is False, result.health
        assert faults["count"] >= 5, "chaos loop did not run"
        # invariant: exact seq accounting per node despite N faults
        for node, r in result.items():
            assert r.records + r.gaps == r.last_seq, (node, r)
        total_reconnects = sum(r.reconnects for r in result.values())
        assert total_reconnects >= 2, "faults produced no reconnects?"
        # the churn really happened, and some rounds attached cleanly
        # (rounds overlapping a proxy fault may error — that IS the
        # chaos; the invariants below are what must hold regardless)
        assert churn.rounds >= 6, f"subscriber churn barely ran: {churn.rounds}"
        assert churn.acks >= 2, "no churn subscriber ever attached"
        assert churn.cuts >= 1, "no churn subscriber left by cut"

        # invariant: stream states drain (no leaked lingering runs)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            leftovers = [rid for a in agents for rid in a._streams]
            if not leftovers:
                break
            time.sleep(0.3)
        assert not leftovers, f"leaked stream states: {leftovers}"
        # invariant: bounded growth — the run's threads wind down
        deadline = time.monotonic() + 10.0
        while (threading.active_count() > baseline_threads + 24
               and time.monotonic() < deadline):
            time.sleep(0.3)
        assert threading.active_count() <= baseline_threads + 24

        # scaling points → schema-valid PerfRecords in a ledger: fleet
        # ingest rows/s and the merge's windows/s
        frames_per_node, _errs = runtime.fetch_windows(gadget="trace/exec")
        windows = []
        for res in frames_per_node.values():
            windows.extend(decode_frames(res["frames"]))
        assert windows, "soak sealed no windows"
        m0 = time.perf_counter()
        merged = merge_windows(windows)
        merge_s = max(time.perf_counter() - m0, 1e-9)
        assert merged.events > 0
        ledger = str(tmp_path_factory.mktemp("soak-ledger") / "PERF.jsonl")
        prov = build_provenance("cpu", False)
        ingest_rec = make_record(
            config=f"soak-fleet-{n_nodes}node", metric="fleet_ingest",
            unit="ev/s", value=len(events) / duration,
            stages={"merge": {"seconds": merge_s,
                              "events": float(merged.events)},
                    "harvest": {"events": float(len(events)),
                                "seconds": duration}},
            provenance=prov,
            extra={"nodes": n_nodes, "faults": faults["count"],
                   "reconnects": total_reconnects,
                   "windows": len(windows)})
        merge_rec = make_record(
            config=f"soak-fleet-{n_nodes}node", metric="fleet_merge",
            unit="windows/s", value=len(windows) / merge_s,
            stages={"merge": {"seconds": merge_s,
                              "calls": float(len(windows))}},
            provenance=prov,
            extra={"nodes": n_nodes})
        append_record(ingest_rec, path=ledger)
        append_record(merge_rec, path=ledger)
        read = read_ledger(path=ledger)
        assert len(read.records) == 2 and not read.skipped
        print(f"soak-fleet-{n_nodes}node: fleet_ingest {ingest_rec['value']:.1f} rows/s "
              f"over {duration:.1f} s ({faults['count']} faults, {total_reconnects} "
              f"reconnects); fleet_merge {merge_rec['value']:.1f} windows/s "
              f"({len(windows)} windows, {merged.events} events)")
    finally:
        if runtime is not None:
            runtime.close()
        for p in proxies.values():
            p.close()
        for s in servers:
            s.stop(grace=0.5)
        HISTORY.close_all()
        HISTORY.set_base_dir(None)
