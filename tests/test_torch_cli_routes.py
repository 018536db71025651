"""The port's CLI routes that go through the fan-out, each run in this
process (``cli.main``) against live port agents on the CPU: two in-process
agents (n0, n1) on unix sockets under a pytest temp directory, with the
local fleet's state file (``$IG_TPU_TORCH_AGENTS``) naming them for the
routes that default to it.

Every route that exited 2 naming ROADMAP item 18b before the fan-out was
ported runs here: a gadget's ``--remote`` and ``--node`` (a trace and a
one-shot gadget), ``query --remote``, ``watch --id --remote``, ``record
start|stop|list --remote``, ``record stop --fetch``, ``record
fetch``, ``replay`` of a fetched bundle, ``deploy --render|--apply``
(against `FakeClusterApplier`), ``undeploy --render|--apply``, ``traces``,
and ``debug``, ``debug trace export`` and ``alerts list`` without
``--remote``; so do ``query --remote --topology`` and every ``fleet``
verb (item 11). ``deploy --local`` spawns agents: it runs in
``tests/test_torch_deploy.py``.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

import pytest
import torch

import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu_torch import environment
from inspektor_gadget_tpu_torch.agent.client import AgentClient
from inspektor_gadget_tpu_torch.agent.service import serve
from inspektor_gadget_tpu_torch.capture import RECORDINGS
from inspektor_gadget_tpu_torch.cli import apply as apply_mod
from inspektor_gadget_tpu_torch.cli import main as cli
from inspektor_gadget_tpu_torch.cli.deploy import STATE_FILE_ENV
from inspektor_gadget_tpu_torch.history import HISTORY

torch.set_num_threads(2)

SKETCH = ["--tpusketch-enable", "true", "--tpusketch-depth", "3",
          "--tpusketch-log2-width", "10", "--tpusketch-hll-p", "8",
          "--tpusketch-entropy-log2-width", "6", "--tpusketch-topk", "8",
          "--tpusketch-harvest-interval", "300ms"]
REC_ID = "routes-rec"


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    d = tmp_path_factory.mktemp("routes")
    HISTORY.set_base_dir(str(d / "history"))
    RECORDINGS.set_base_dir(str(d / "capture"))
    servers, agents, targets = [], {}, {}
    for node in ("n0", "n1"):
        addr = f"unix://{d}/{node}.sock"
        server, ag = serve(addr, node_name=node, device="cpu")
        servers.append(server)
        agents[node] = ag
        targets[node] = addr
    state = d / "agents.json"
    state.write_text(json.dumps({"targets": targets, "pids": {}}))
    prev_state = os.environ.get(STATE_FILE_ENV)
    os.environ[STATE_FILE_ENV] = str(state)
    prev_sigint = signal.getsignal(signal.SIGINT)
    prev_env = environment.current()
    try:
        yield {"dir": d, "targets": targets, "agents": agents,
               "remote": ",".join(f"{k}={v}" for k, v in targets.items())}
    finally:
        signal.signal(signal.SIGINT, prev_sigint)
        environment.set_environment(prev_env)
        if prev_state is None:
            os.environ.pop(STATE_FILE_ENV, None)
        else:
            os.environ[STATE_FILE_ENV] = prev_state
        for s in servers:
            s.stop(grace=0.5).wait(10.0)
        RECORDINGS.stop_all()
        RECORDINGS.set_base_dir(None)
        HISTORY.close_all()
        HISTORY.set_base_dir(None)


@pytest.fixture(scope="module")
def recorded(fleet):
    """The capture journey through the CLI: record start --remote, a
    sketched trace exec --remote with history, record stop --remote."""
    r = fleet["remote"]
    assert cli.main(["record", "start", "--id", REC_ID, "--remote", r]) == 0
    assert cli.main(["trace", "exec", "--remote", r, "--source", "pysynthetic",
                     "--rate", "4096", "--batch-size", "1024", "--timeout", "2.5",
                     "--tpusketch-history", "true", "--tpusketch-history-interval", "0",
                     *SKETCH, "-o", "json"]) == 0
    assert cli.main(["record", "stop", "--id", REC_ID, "--remote", r]) == 0
    HISTORY.close_all()
    return REC_ID


def _json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith(("{", "["))]


def route_trace_remote(fleet, capsys, tmp_path):
    assert cli.main(["trace", "exec", "--remote", fleet["remote"], "--source", "pysynthetic",
                     "--rate", "5000", "--batch-size", "256", "--timeout", "1",
                     "-o", "json"]) == 0
    cap = capsys.readouterr()
    rows = _json_lines(cap.out)
    assert rows and {r["node"] for r in rows} == {"n0", "n1"}
    assert "PARTIAL" not in cap.err


def route_trace_node(fleet, capsys, tmp_path):
    assert cli.main(["trace", "exec", "--remote", fleet["remote"], "--node", "n1",
                     "--source", "pysynthetic", "--rate", "5000", "--batch-size", "256",
                     "--timeout", "1", "-o", "json"]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert rows and {r["node"] for r in rows} == {"n1"}


def route_snapshot_remote(fleet, capsys, tmp_path):
    """A one-shot gadget: every node's rows combined once, client-side."""
    assert cli.main(["snapshot", "process", "--remote", fleet["remote"], "--timeout", "5",
                     "-o", "json"]) == 0
    (rows,) = _json_lines(capsys.readouterr().out)
    assert rows and {r["node"] for r in rows} == {"n0", "n1"}


def route_query_remote(fleet, capsys, tmp_path, recorded):
    assert cli.main(["query", "--remote", fleet["remote"], "--gadget", "trace/exec",
                     "-o", "json"]) == 0
    ans = json.loads(capsys.readouterr().out)
    assert ans["paths"] == {"n0": "pushdown", "n1": "pushdown"}
    assert sorted(ans["nodes"]) == ["n0", "n1"] and ans["events"] > 0


def route_query_topology(fleet, capsys, tmp_path, recorded):
    """--topology folds the same windows through the aggregation tier:
    the answer is the flat query's."""
    base = ["query", "--remote", fleet["remote"], "--gadget", "trace/exec", "-o", "json"]
    assert cli.main(base) == 0
    flat = json.loads(capsys.readouterr().out)
    assert cli.main([*base, "--topology", "auto:2"]) == 0
    tree = json.loads(capsys.readouterr().out)
    for k in ("events", "distinct", "entropy_bits", "heavy_hitters", "windows", "inv"):
        assert tree[k] == flat[k], k
    assert tree["paths"] == {"n0": "tree", "n1": "tree"}
    assert tree["fleet"]["depth"] == 1 and tree["fleet"]["aggregators"] == 1
    assert cli.main([*base[:-2], "--topology", "za=n0"]) == 2
    assert "not placed in any zone" in capsys.readouterr().err


def route_fleet_health(fleet, capsys, tmp_path):
    assert cli.main(["fleet", "health", "--remote", fleet["remote"], "-o", "json"]) == 0
    rows = json.loads(capsys.readouterr().out)["agents"]
    assert {r["node"]: r["state"] for r in rows} == {"n0": "healthy", "n1": "healthy"}
    # no --remote: the local fleet's state file names the same agents
    assert cli.main(["fleet", "health"]) == 0
    assert "healthy" in capsys.readouterr().out


def route_fleet_verbs(fleet, capsys, tmp_path):
    for verb in ("runs", "queries", "lag", "accuracy"):
        assert cli.main(["fleet", verb, "--remote", fleet["remote"], "-o", "json"]) == 0, verb
        doc = json.loads(capsys.readouterr().out)
        assert [r["node"] for r in doc["agents"]] == ["n0", "n1"], verb
        assert all(not r["error"] for r in doc["agents"]), verb
    assert cli.main(["fleet", "topology", "--remote", fleet["remote"]]) == 0
    assert "merge tree over 2 agent(s): depth 1" in capsys.readouterr().out


def route_watch_remote(fleet, capsys, tmp_path):
    params = {"gadget.source": "pysynthetic", "gadget.rate": "4096",
              "gadget.batch-size": "1024",
              **{f"operator.tpusketch.{k.lstrip('-').removeprefix('tpusketch-')}": v
                 for k, v in zip(SKETCH[::2], SKETCH[1::2])},
              "operator.tpusketch.history": "true",
              "operator.tpusketch.history-interval": "0",
              "operator.tpusketch.standing-queries":
                  json.dumps([{"id": "hot", "stats": ["topk"], "range": "1m"}])}
    stop, holder = threading.Event(), {}
    client = AgentClient(fleet["targets"]["n0"], "owner", rpc_deadline=60.0)

    def owner():
        holder["out"] = client.run_gadget("trace", "exec", params, run_id="routes-watch",
                                          share=True, keepalive=1.0, outputs=("summary",),
                                          stop_event=stop, stop_run=True)

    t = threading.Thread(target=owner, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and \
                "routes-watch" not in fleet["agents"]["n0"]._streams:
            time.sleep(0.02)
        rc = cli.main(["watch", "--id", "hot", "--remote", f"n0={fleet['targets']['n0']}",
                       "--run", "routes-watch", "--iterations", "1", "--duration", "30",
                       "--json"])
    finally:
        stop.set()
        t.join(timeout=30.0)
        client.close()
    assert rc == 0
    (doc,) = _json_lines(capsys.readouterr().out)
    assert doc["refresh"] == 1 and doc["meta"]["id"] == "hot"
    assert doc["meta"]["nodes"]["n0"]["tick"] >= 1 and doc["answer"]["events"] > 0
    assert holder["out"]["error"] is None


def route_record_start(fleet, capsys, tmp_path):
    r = fleet["remote"]
    assert cli.main(["record", "start", "--id", "routes-start", "--remote", r]) == 0
    out = capsys.readouterr().out
    assert "n0: recording routes-start started ->" in out
    assert "n1: recording routes-start started ->" in out
    assert cli.main(["record", "stop", "--id", "routes-start", "--remote", r]) == 0
    assert "n1: recording routes-start stopped" in capsys.readouterr().out


def route_record_list(fleet, capsys, tmp_path, recorded):
    assert cli.main(["record", "list", "--remote", fleet["remote"], "-o", "json"]) == 0
    tables = json.loads(capsys.readouterr().out)
    assert set(tables) == {"n0", "n1"}
    for recs in tables.values():
        assert any(r["id"] == recorded and r["state"] == "stopped" for r in recs)


def route_record_stop_fetch(fleet, capsys, tmp_path):
    r = fleet["remote"]
    assert cli.main(["record", "start", "--id", "routes-fetch", "--remote", r]) == 0
    dest = tmp_path / "bundle"
    assert cli.main(["record", "stop", "--id", "routes-fetch", "--remote", r,
                     "--fetch", str(dest)]) == 0
    out = capsys.readouterr().out
    assert f"bundle -> {dest}" in out
    bundle = json.loads((dest / "bundle.json").read_text())
    assert bundle["schema"] == "ig-tpu/capture-bundle/v1"
    assert set(bundle["nodes"]) == {"n0", "n1"} and not bundle["errors"]


def route_record_fetch(fleet, capsys, tmp_path, recorded):
    dest = tmp_path / "fetched"
    assert cli.main(["record", "fetch", "--id", recorded, "--dest", str(dest),
                     "--remote", fleet["remote"]]) == 0
    bundle = json.loads((dest / "bundle.json").read_text())
    assert set(bundle["nodes"]) == {"n0", "n1"} and not bundle["errors"]
    assert all(st["files"] > 0 and st["bytes"] > 0 for st in bundle["nodes"].values())


def route_replay_bundle(fleet, capsys, tmp_path, recorded):
    dest = tmp_path / "replayed"
    assert cli.main(["record", "fetch", "--id", recorded, "--dest", str(dest)]) == 0
    capsys.readouterr()
    assert cli.main(["replay", str(dest), "--verify", "--device", "cpu", "-o", "json"]) == 0
    reports = json.loads(capsys.readouterr().out)
    # each node recorded its own run into the one shared manager, and the
    # bundle holds every node's copy of the recording
    assert len(reports) >= 2
    assert all(r["digests_match"] and r["alerts_match"] and r["batches"] > 0 for r in reports)


def route_deploy_render(fleet, capsys, tmp_path):
    assert cli.main(["deploy", "--render"]) == 0
    out = capsys.readouterr().out
    assert "kind: DaemonSet" in out and "nvidia.com/gpu: 1" in out
    assert "inspektor_gadget_tpu_torch.agent.main" in out and "google.com/tpu" not in out


def route_deploy_apply(fleet, capsys, tmp_path):
    pods = tmp_path / "pods.json"
    fake = apply_mod.FakeClusterApplier(str(pods), nodes=("node-a", "node-b"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(apply_mod, "KubectlApplier", lambda context="": fake)
        assert cli.main(["deploy", "--apply"]) == 0
        assert "deployed: 2/2 agents ready" in capsys.readouterr().out
        assert len(json.loads(pods.read_text())["pods"]) == 2
        assert cli.main(["undeploy", "--apply"]) == 0
    assert "removed: DaemonSet/ig-tpu-agent" in capsys.readouterr().out
    assert json.loads(pods.read_text())["pods"] == []


def route_undeploy_render(fleet, capsys, tmp_path):
    assert cli.main(["undeploy", "--render"]) == 0
    out = capsys.readouterr().out
    assert "kind: Namespace" in out and "ig-tpu-agent" in out


def route_traces(fleet, capsys, tmp_path):
    r = f"n0={fleet['targets']['n0']}"
    assert cli.main(["traces", "start", "--remote", r, "--name", "rt1", "--gadget",
                     "trace/exec", "-p", "source=pysynthetic", "-p", "rate=20000"]) == 0
    assert "n0: rt1 Started" in capsys.readouterr().out
    assert cli.main(["traces", "list", "--remote", r]) == 0
    assert "rt1" in capsys.readouterr().out
    assert cli.main(["traces", "stop", "--remote", r, "--name", "rt1"]) == 0
    capsys.readouterr()
    assert cli.main(["traces", "delete", "--remote", r, "--name", "rt1"]) == 0
    assert "n0: deleted=True" in capsys.readouterr().out


def route_debug_local(fleet, capsys, tmp_path):
    assert cli.main(["debug", "state"]) == 0
    out = capsys.readouterr().out
    for node, target in fleet["targets"].items():
        assert f"=== {node} ({target}) ===" in out


def route_debug_trace_export_local(fleet, capsys, tmp_path):
    out_file = tmp_path / "trace.json"
    assert cli.main(["debug", "trace", "export", "--out", str(out_file)]) == 0
    assert capsys.readouterr().out.startswith("wrote ")
    doc = json.loads(out_file.read_text())
    assert "traceEvents" in doc


def route_alerts_list_local(fleet, capsys, tmp_path):
    assert cli.main(["alerts", "list", "-o", "json"]) == 0
    assert set(json.loads(capsys.readouterr().out)) == {"local", "n0", "n1"}


ROUTES = {name[len("route_"):].replace("_", "-"): fn
          for name, fn in list(globals().items()) if name.startswith("route_")}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_remote_routes_run_against_port_agents(route, fleet, capsys, tmp_path, request):
    fn = ROUTES[route]
    kwargs = {}
    if "recorded" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        kwargs["recorded"] = request.getfixturevalue("recorded")
    capsys.readouterr()
    fn(fleet, capsys, tmp_path, **kwargs)


@pytest.mark.parametrize("argv,rc,said", [
    (["fleet", "health"], 2, "no agents (use deploy --local N or --remote)"),
    (["bench", "run"], 1, "torch.cuda.is_available() is false; pass device='cpu'"),
    (["query", "--topology", "auto"], 2, "--topology needs --remote")],
    ids=["fleet", "bench", "query-topology"])
def test_unported_routes_still_exit_2_naming_their_item(argv, rc, said, capsys, monkeypatch,
                                                         tmp_path):
    """Once unported, now ported: no route names a ROADMAP item. `fleet`
    and `query --topology` without an agent to ask (no local fleet, no
    --remote) exit 2 saying so, as the reference's do; `bench run`
    without a card asks for the card by default and exits 1 with
    `resolve_device`'s message, writing no ledger."""
    if argv[0] == "bench" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv(STATE_FILE_ENV, str(tmp_path / "no-agents.json"))
    ledger = tmp_path / "PERF.jsonl"
    monkeypatch.setenv("IG_TPU_TORCH_PERF_LEDGER", str(ledger))
    assert cli.main(argv) == rc
    err = capsys.readouterr().err
    assert said in err
    assert "ROADMAP item" not in err
    assert not ledger.exists()


@pytest.mark.parametrize("output", ["json", "table"])
def test_doctor_route_matches_the_reference(output, capsys, monkeypatch, tmp_path):
    """`doctor` (ROADMAP item 19) and the reference's `ig-tpu doctor` on
    this host, with no local fleet: the same exit code (1 if and only if
    a gadget is unavailable), the same windows and their verdicts (but
    ``native_toolchain``, whose compilers differ: the port's needs nvcc
    too), and the same gadget rows."""
    import inspektor_gadget_tpu.cli.deploy as ref_deploy
    from inspektor_gadget_tpu.cli.main import main as ref_main

    from _torch_registry import own_gadgets_only
    monkeypatch.setenv(STATE_FILE_ENV, str(tmp_path / "no-agents.json"))
    monkeypatch.setattr(ref_deploy, "STATE_FILE", str(tmp_path / "no-ref-agents.json"))
    monkeypatch.setenv("IG_HISTORY_DIR", str(tmp_path / "history"))
    monkeypatch.setenv("IG_CAPTURE_DIR", str(tmp_path / "capture"))
    capsys.readouterr()
    with own_gadgets_only():
        rc = cli.main(["doctor", "-o", output])
        got = capsys.readouterr().out
        ref_rc = ref_main(["doctor", "-o", output])
        want = capsys.readouterr().out
    assert rc == ref_rc
    if output == "table":
        for head in ("CAPTURE WINDOWS", "GADGETS", "PLATFORM", "SUMMARY"):
            assert head in got
        assert got.split("SUMMARY")[1] == want.split("SUMMARY")[1]
        return
    got, want = json.loads(got), json.loads(want)
    assert rc == (1 if any(g["status"] == "unavailable" for g in got["gadgets"]) else 0)
    assert set(got["windows"]) == set(want["windows"])
    for name, w in got["windows"].items():
        if name not in ("native_toolchain", "device_topology"):
            assert w["ok"] == want["windows"][name]["ok"], (name, w, want["windows"][name])
    rows = [(g["category"], g["name"], g["status"], g["window"]) for g in got["gadgets"]]
    assert rows == [(g["category"], g["name"], g["status"], g["window"])
                    for g in want["gadgets"]]
    assert len(rows) == 30
    assert got["platform"]["platform"] in ("unprobed", "cpu", "cuda")
    assert "ig_doctor_window_ok" in json.dumps(got["telemetry"])
