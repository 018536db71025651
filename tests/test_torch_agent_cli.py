"""The port's agent as a user starts it — ``ig-tpu-torch agent`` in a
subprocess on the CPU, on a socket under a pytest temp directory — and
the CLI routes that read it through `AgentClient`: ``agent liveness`` and
``dump``, ``debug state|flight-record|trace export --remote``, ``history
tiers --remote``, ``alerts list --remote`` and ``watch --list --remote``.
The agent without a card exits 1; SIGTERM stops it with exit 0 and a
flight record written.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from inspektor_gadget_tpu_torch.agent.main import main as agent_main
from inspektor_gadget_tpu_torch.cli import main as cli

ROOT = Path(__file__).resolve().parent.parent
PORT = [sys.executable, "-m", "inspektor_gadget_tpu_torch.cli.main"]


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    d = tmp_path_factory.mktemp("agentcli")
    target = f"unix://{d}/b.sock"
    proc = subprocess.Popen(
        PORT + ["agent", "--listen", target, "--node-name", "n1", "--device", "cpu",
                "--flight-record-path", str(d / "fr.json"), "--metrics-addr", "127.0.0.1:0",
                "--history-dir", str(d / "history"), "--capture-dir", str(d / "capture")],
        env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=str(d),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline and proc.poll() is None:
        if agent_main(["liveness", "--target", target]) == 0:
            break
        time.sleep(0.5)
    else:
        proc.kill()
        out, err = proc.communicate(timeout=10)
        pytest.fail(f"agent never answered: rc={proc.returncode}\n{out}\n{err}")
    yield {"proc": proc, "target": target, "dir": d, "remote": f"n1={target}"}
    if proc.poll() is None:
        proc.kill()
    proc.communicate(timeout=10)


def test_agent_without_a_card_exits_1(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(PORT + ["agent", "--listen", f"unix://{tmp_path}/a.sock"],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 1
    # the bounded CUDA probe stops it before torch touches CUDA
    assert "error: device probe failed: cuda unavailable: probe rc=1" in r.stderr
    assert not (tmp_path / "a.sock").exists()


def test_agent_liveness_and_dump(live, capsys):
    assert agent_main(["liveness", "--target", live["target"]]) == 0
    assert capsys.readouterr().out.strip() == "ok"
    assert agent_main(["dump", "--target", live["target"]]) == 0
    state = json.loads(capsys.readouterr().out)
    assert state["device"] == "cpu" and state["threads"]
    assert agent_main(["add-container", "--target", live["target"], "--id", "cli-c1",
                       "--name", "web", "--pid", "1", "--mntns", "4026531840"]) == 0
    assert "'ok': True" in capsys.readouterr().out
    assert agent_main(["remove-container", "--target", live["target"], "--id", "cli-c1"]) == 0
    assert agent_main(["liveness", "--target", f"unix://{live['dir']}/none.sock"]) == 1


def test_debug_state_remote(live, capsys):
    assert cli.main(["debug", "state", "--remote", live["remote"]]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"=== n1 ({live['target']}) ===")
    state = json.loads(out.split("\n", 1)[1])
    assert state["active_runs"] == [] and "flight_record" in state
    assert cli.main(["debug", "--remote", live["remote"]]) == 0
    assert "=== n1" in capsys.readouterr().out


def test_debug_flight_record_and_trace_export_remote(live, capsys, tmp_path):
    assert cli.main(["debug", "flight-record", "--remote", live["remote"]]) == 0
    fr = json.loads(capsys.readouterr().out)
    assert fr["n1"]["facts"]["node"] == "n1"
    assert cli.main(["debug", "flight-record", "--remote", live["remote"],
                     "--node", "nope"]) == 2
    assert "unknown node" in capsys.readouterr().err
    out = tmp_path / "t.json"
    assert cli.main(["debug", "trace", "export", "--remote", live["remote"],
                     "--out", str(out)]) == 0
    assert "traceEvents" in json.loads(out.read_text())


def test_history_tiers_remote(live, capsys):
    assert cli.main(["history", "tiers", "--remote", live["remote"], "-o", "json"]) == 0
    tiers = json.loads(capsys.readouterr().out)
    assert set(tiers) == {"n1"} and "error" not in tiers["n1"]
    assert cli.main(["history", "tiers", "--remote", live["remote"]]) == 0
    assert capsys.readouterr().out.startswith("== n1 ==")
    assert cli.main(["history", "tiers", "--remote", "bad-entry"]) == 2


def test_alerts_list_remote(live, capsys):
    assert cli.main(["alerts", "list", "--remote", live["remote"], "-o", "json"]) == 0
    tables = json.loads(capsys.readouterr().out)
    assert set(tables) == {"local", "n1"} and tables["n1"] == []
    assert cli.main(["alerts", "list", "--remote", f"n2=unix://{live['dir']}/none.sock"]) == 1
    assert "n2: error" in capsys.readouterr().err


def test_watch_list_remote(live, capsys):
    assert cli.main(["watch", "--list", "--remote", live["remote"], "-o", "json"]) == 0
    assert json.loads(capsys.readouterr().out) == {"queries": [], "errors": {}}


def test_agent_stops_on_sigterm_with_a_flight_record(live):
    proc = live["proc"]
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert "device platform: cpu (cpu requested; probe 0.00s)" in out
    assert "device: cpu" in out
    # the doctor's start-up report, as `ig-tpu-torch doctor` renders it
    assert "CAPTURE WINDOWS" in out and "GADGETS" in out and "SUMMARY " in out
    assert "PLATFORM cpu (cpu requested)" in out
    assert f"ig-tpu-agent listening on {live['target']}" in out
    assert "metrics on http://127.0.0.1:" in out
    record = json.loads((live["dir"] / "fr.json").read_text())
    assert record["facts"]["node"] == "n1"
    assert any("signal" in e.get("kind", "") for e in record["errors"])
