"""The port's fleet CLI plane (`cli/fleet.py`, `query --topology`): every
fleet verb reports an unreachable agent with the same row shape and the
same exit code, `fleet topology` renders the merge tree and its wire
cost, and `query --topology` needs --remote and refuses a bad spec with
rc 2; the same cases as the reference's tests/test_fleet_cli.py.
"""

from __future__ import annotations

import json

import pytest

from inspektor_gadget_tpu_torch.cli.fleet import (
    _fleet_rc,
    _sweep_agents,
    _unreachable_line,
    cmd_fleet_accuracy,
    cmd_fleet_lag,
    cmd_fleet_queries,
    cmd_fleet_runs,
    cmd_fleet_topology,
)

GADGET = "trace/exec"


class _Args:
    remote = ""
    gadget = ""
    deadline = 0.5
    output = "table"
    topology = "auto"
    fan_in = 0
    all = False
    watch = 0.0
    iterations = 0


class _DeadClient:
    """Every dial raises — the uniformly-unreachable fleet."""

    def __init__(self, target, node, rpc_deadline=3.0):
        raise ConnectionError(f"dial {target}: connection refused")


class _HalfDeadClient:
    """n0 answers with empty state; every other node raises."""

    def __init__(self, target, node, rpc_deadline=3.0):
        if node != "n0":
            raise ConnectionError(f"dial {target}: connection refused")
        self.node = node

    def dump_state(self):
        return {"runs": [], "standing_queries": [], "pipeline": [],
                "accuracy": []}

    def close(self):
        pass


FLEET_VERBS = [
    pytest.param(cmd_fleet_runs, id="runs"),
    pytest.param(cmd_fleet_queries, id="queries"),
    pytest.param(cmd_fleet_accuracy, id="accuracy"),
    pytest.param(cmd_fleet_lag, id="lag"),
]


@pytest.mark.parametrize("verb", FLEET_VERBS)
def test_unreachable_row_shape_and_rc_uniform(verb, monkeypatch, capsys):
    """The pin: the same `node unreachable: err` row, rc 1,
    across every fleet sweep verb — parametrized so a verb regrowing
    its own error rendering fails here by name."""
    from inspektor_gadget_tpu_torch.agent import client as agent_client
    monkeypatch.setattr(agent_client, "AgentClient", _HalfDeadClient)
    args = _Args()
    args.remote = "n0=unix:///tmp/a.sock,n1=unix:///tmp/b.sock"
    assert verb(args) == 1
    out = capsys.readouterr().out
    expected = _unreachable_line(
        {"node": "n1",
         "error": "dial unix:///tmp/b.sock: connection refused"})
    assert expected == ("n1" + " " * 11
                        + "unreachable: dial unix:///tmp/b.sock: "
                          "connection refused")
    assert expected in out
    # no dashed or per-verb variant row shapes
    assert "n1" + " " * 11 + "-" not in out


@pytest.mark.parametrize("verb", FLEET_VERBS)
def test_all_reachable_rc_zero(verb, monkeypatch):
    from inspektor_gadget_tpu_torch.agent import client as agent_client

    class _Fine(_HalfDeadClient):
        def __init__(self, target, node, rpc_deadline=3.0):
            self.node = node

    monkeypatch.setattr(agent_client, "AgentClient", _Fine)
    args = _Args()
    args.remote = "n0=unix:///tmp/a.sock,n1=unix:///tmp/b.sock"
    assert verb(args) == 0


@pytest.mark.parametrize("verb", FLEET_VERBS)
def test_json_error_rows_keep_payload_keys(verb, monkeypatch, capsys):
    """The -o json shape is stable under failure: an unreachable node's
    row still carries the verb's payload key (empty), so dashboards
    never KeyError on a partition."""
    from inspektor_gadget_tpu_torch.agent import client as agent_client
    monkeypatch.setattr(agent_client, "AgentClient", _DeadClient)
    args = _Args()
    args.remote = "n0=unix:///tmp/a.sock"
    args.output = "json"
    assert verb(args) == 1
    doc = json.loads(capsys.readouterr().out)
    row = doc["agents"][0]
    assert row["node"] == "n0"
    assert "connection refused" in row["error"]
    payload_keys = {"runs", "queries"} & set(row)
    assert payload_keys, row  # the verb's list key survives the error
    assert all(row[k] == [] for k in payload_keys)


def test_sweep_agents_copies_mutable_defaults(monkeypatch):
    from inspektor_gadget_tpu_torch.agent import client as agent_client
    monkeypatch.setattr(agent_client, "AgentClient", _DeadClient)
    rows = _sweep_agents(
        {"a": "t1", "b": "t2"}, 0.1,
        lambda c: (_ for _ in ()).throw(RuntimeError("x")), runs=[])
    rows[0]["runs"].append("poison")
    assert rows[1]["runs"] == []  # no shared list between rows


def test_fleet_rc_and_line_helpers():
    ok = {"node": "n0", "error": ""}
    bad = {"node": "n1", "error": "boom"}
    assert _fleet_rc([ok]) == 0
    assert _fleet_rc([ok, bad]) == 1
    assert _unreachable_line(bad) == "n1" + " " * 11 + "unreachable: boom"
    assert _unreachable_line(bad, width=14) == (
        "n1" + " " * 13 + "unreachable: boom")


# ---------------------------------------------------------------------------
# fleet topology verb
# ---------------------------------------------------------------------------

def _topo_args(n: int = 6, **kw) -> _Args:
    args = _Args()
    args.remote = ",".join(f"n{i}=unix:///tmp/{i}.sock"
                           for i in range(n))
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def test_topology_table_renders_tree_and_wire_cost(capsys):
    assert cmd_fleet_topology(_topo_args(6)) == 0
    out = capsys.readouterr().out
    assert "merge tree over 6 agent(s): depth 2, fan-in 4" in out
    # 6 leaves + 2 zones under the root = 8 edges; + 1 root frame
    assert "9 window frame(s) through the tree vs 6 flat" in out
    assert "client link folds 2 instead of 6" in out
    assert "fleet/" in out


def test_topology_json_carries_wire_accounting(capsys):
    assert cmd_fleet_topology(_topo_args(6, output="json")) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["topology"]["leaves"] == 6
    assert doc["wire_windows_tree"] == doc["topology"]["edges"] + 1
    assert doc["wire_windows_flat"] == 6


def test_topology_fan_in_shorthand(capsys):
    assert cmd_fleet_topology(_topo_args(8, fan_in=2,
                                         output="json")) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["spec"] == "auto:2"
    assert doc["topology"]["fan_in"] == 2
    assert doc["topology"]["depth"] == 3


def test_topology_declared_spec_and_bad_spec(capsys):
    args = _topo_args(4, topology="za=n0,n1;zb=n2,n3", output="json")
    assert cmd_fleet_topology(args) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["topology"]["aggregators"] == 3
    bad = _topo_args(4, topology="za=n0,nope")
    assert cmd_fleet_topology(bad) == 2
    assert "unknown agent" in capsys.readouterr().err


def test_topology_no_agents_rc2(capsys, monkeypatch, tmp_path):
    from inspektor_gadget_tpu_torch.cli import deploy
    monkeypatch.delenv(deploy.STATE_FILE_ENV, raising=False)
    monkeypatch.setattr(deploy, "STATE_FILE",
                        str(tmp_path / "none.json"))
    args = _Args()
    assert cmd_fleet_topology(args) == 2
    assert "no agents" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# query --topology plumbing
# ---------------------------------------------------------------------------

def test_query_topology_requires_remote(capsys):
    from inspektor_gadget_tpu_torch.cli.main import build_parser
    parser = build_parser()
    args = parser.parse_args(["query", "--topology", "auto"])
    assert args.func(args) == 2
    assert "--topology needs --remote" in capsys.readouterr().err


def test_query_topology_bad_spec_rc2(capsys):
    from inspektor_gadget_tpu_torch.cli.main import build_parser
    parser = build_parser()
    args = parser.parse_args([
        "query", "--remote", "n0=unix:///tmp/x.sock",
        "--topology", "auto:x"])
    assert args.func(args) == 2
    assert "auto:<int>" in capsys.readouterr().err
