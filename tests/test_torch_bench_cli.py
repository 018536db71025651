"""`ig-tpu-torch bench run|compare|report|import` as a user runs it,
beside the reference's `ig-tpu bench` (`inspektor_gadget_tpu/cli/bench.py`):
`run --device cpu` writes a valid record and its pipeline-lag record to
the ledger it is given; `run` without a card (the default device is the
card) exits 1 with `resolve_device`'s message and writes nothing, in
the working directory or the state directory; `report` and `import`
print what the reference's print on the same ledgers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from inspektor_gadget_tpu.cli.bench import main as ref_bench
from inspektor_gadget_tpu.perf import schema as RS
from inspektor_gadget_tpu_torch.cli.bench import main as port_bench
from inspektor_gadget_tpu_torch.perf import ledger as PL
from inspektor_gadget_tpu_torch.perf import schema as PS

from _torch_perf import probe_state  # noqa: F401 — autouse
from _torch_perf import rec

REPO = Path(__file__).resolve().parent.parent
PORT = [sys.executable, "-m", "inspektor_gadget_tpu_torch.cli.main"]


def run(args, env_extra: dict, cwd: Path, timeout: float = 240):
    env = {**os.environ, **env_extra}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    return subprocess.run(PORT + args, capture_output=True, text=True, timeout=timeout,
                          cwd=cwd, env=env)


def test_bench_run_on_the_cpu_appends_its_records(tmp_path):
    ledger = tmp_path / "PERF.jsonl"
    r = run(["bench", "run", "--config", "tiny", "--device", "cpu", "--ledger", str(ledger),
             "-o", "summary"], {}, tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("harness.tiny: ") and " on cpu" in r.stdout
    assert f"appended to {ledger}" in r.stderr
    main, lag = PL.read_ledger(str(ledger)).records
    for x in (main, lag):
        assert PS.validate_record(x) == [] and RS.validate_record(x) == []
    assert main["config"] == "harness.tiny" and main["provenance"]["platform"] == "cpu"
    assert lag["config"] == "harness.tiny.pipeline-lag" and lag["unit"] == "seconds"
    assert lag["value"] == main["extra"]["stage_lag"]["h2d"]["p99_s"]
    assert lag["extra"]["source_config"] == "harness.tiny"


def test_bench_run_without_a_card_exits_1_and_writes_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    home, state = tmp_path / "home", tmp_path / "state"
    home.mkdir()
    r = run(["bench", "run", "--config", "tiny"],
            {"HOME": str(home), "XDG_STATE_HOME": str(state)}, tmp_path)
    assert r.returncode == 1
    assert "torch.cuda.is_available() is false; pass device='cpu'" in r.stderr
    assert not state.exists() and not any(home.iterdir())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["home"]


def test_bench_run_argument_errors_exit_2():
    assert port_bench(["run", "--config", "nope", "--device", "cpu", "--no-ledger"]) == 2
    assert port_bench(["run", "--config", "tiny", "--device", "cpu", "--chips", "2",
                       "--no-ledger"]) == 2


def test_bench_run_no_ledger_prints_the_record(capsys):
    assert port_bench(["run", "--config", "tiny", "--device", "cpu", "--seconds", "0.05",
                       "--pipeline", "classic", "--no-ledger"]) == 0
    out = capsys.readouterr()
    r = json.loads(out.out)
    assert PS.validate_record(r) == [] and r["extra"]["pipeline"].startswith("pop(")
    assert "not appended (--no-ledger)" in out.err


def test_bench_import_and_report_print_the_references(tmp_path, capsys):
    lp, lr = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    bench = [str(REPO / f"BENCH_r0{i}.json") for i in range(1, 6)]
    outs = []
    for main, ledger in ((port_bench, lp), (ref_bench, lr)):
        assert main(["import", *bench, "--ledger", ledger]) == 0
        assert main(["import", *bench, "--ledger", ledger]) == 0  # idempotent
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out
    assert outs[0].err.replace(lp, "L") == outs[1].err.replace(lr, "L")
    assert "already imported" in outs[0].err
    # one ledger, both reports: the port's records beside the imported ones
    PL.append_record(rec(PS, 3.1e7, platform="gpu", config="harness.e2e-prod"), lp)
    for args in (["report"], ["report", "--last", "0"], ["report", "-o", "json"],
                 ["report", "--config", "bench.e2e", "--last", "2"]):
        assert port_bench([*args, "--ledger", lp]) == 0
        got = capsys.readouterr().out
        assert ref_bench([*args, "--ledger", lp]) == 0
        assert got == capsys.readouterr().out, args
    assert port_bench(["report", "--ledger", str(tmp_path / "none.jsonl")]) == 0
    assert "empty" in capsys.readouterr().out
