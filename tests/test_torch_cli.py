"""The port's CLI (`inspektor_gadget_tpu_torch.cli.main`, the
``ig-tpu-torch`` console script) as a black box, as ``tests/test_cli.py``
drives the reference's: subprocesses on the CPU, beside the reference's
CLI where the two must answer alike.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from inspektor_gadget_tpu_torch.cli import main as cli

PORT = [sys.executable, "-m", "inspektor_gadget_tpu_torch.cli.main"]
REF = [sys.executable, "-m", "inspektor_gadget_tpu.cli.main"]
SMALL = ["--tpusketch-depth", "3", "--tpusketch-log2-width", "10", "--tpusketch-hll-p", "8",
         "--tpusketch-entropy-log2-width", "6", "--tpusketch-topk", "8"]


def run(cmd, *args, timeout=180):
    return subprocess.run(cmd + list(args), capture_output=True, text=True, timeout=timeout)


def test_list_and_catalog():
    r = run(PORT, "list")
    assert r.returncode == 0, r.stderr
    assert [ln.split()[:2] for ln in r.stdout.strip().splitlines()] == \
        [["top", "sketch"], ["trace", "exec"]]
    r = run(PORT, "catalog")
    assert r.returncode == 0, r.stderr
    cat = json.loads(r.stdout)
    assert {(g["category"], g["name"]) for g in cat["gadgets"]} == \
        {("trace", "exec"), ("top", "sketch")}
    (op,) = cat["operators"]
    assert op["name"] == "tpusketch" and len(op["instanceParams"]) == 38


def test_trace_exec_json_rows_like_the_reference():
    args = ("trace", "exec", "--source", "pysynthetic", "--rate", "3000", "--timeout", "1",
            "-o", "json")
    got, want = run(PORT, *args), run(REF, *args)
    assert got.returncode == want.returncode == 0, got.stderr
    rows = [json.loads(ln) for ln in got.stdout.splitlines() if ln.strip()]
    ref_rows = [json.loads(ln) for ln in want.stdout.splitlines() if ln.strip()]
    assert len(rows) > 10 and rows[0]["comm"].startswith("proc-") and rows[0]["pid"] > 0
    assert list(rows[0]) == list(ref_rows[0])
    n = min(len(rows), len(ref_rows))
    for r, w in zip(rows[:n], ref_rows[:n]):
        # the same seeded stream; the wall clock and the identity columns
        # the reference's localmanager operator fills aside
        for d in (r, w):
            for k in ("timestamp", "node", "namespace", "pod", "container"):
                d.pop(k)
        assert r == w


def test_bad_source_exits_2_with_the_reference_message():
    args = ("trace", "exec", "--source", "bogus", "--timeout", "1")
    got, want = run(PORT, *args), run(REF, *args)
    assert got.returncode == want.returncode == 2
    assert got.stderr == want.stderr
    assert "not in ['auto', 'native', 'synthetic', 'pysynthetic']" in got.stderr


def test_sketch_plane_on_the_cpu_prints_epochs():
    r = run(PORT, "trace", "exec", "--device", "cpu", "--source", "pysynthetic", "--rate",
            "40000", "--batch-size", "4096", "--timeout", "3", "-F", "uid:99",
            "--tpusketch-enable", "true", "--tpusketch-harvest-interval", "500ms", *SMALL)
    assert r.returncode == 0, r.stderr
    epochs = [ln for ln in r.stdout.splitlines() if ln.startswith("— sketch epoch")]
    assert len(epochs) >= 2
    assert "proc-0" in r.stdout
    assert '"pid"' not in r.stdout  # -F uid:99 matches no row


def test_remote_exits_2_naming_its_item():
    r = run(PORT, "trace", "exec", "--remote", "n0=unix:///nonexistent.sock", "--timeout", "1")
    assert r.returncode == 2
    assert f"ROADMAP item {cli.REMOTE_ITEM}" in r.stderr


def test_cuda_without_a_card_exits_1():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = run(PORT, "trace", "exec", "--device", "cuda", "--source", "pysynthetic", "--timeout",
            "1", "--tpusketch-enable", "true")
    assert r.returncode == 1
    assert "torch.cuda.is_available() is false; pass device='cpu'" in r.stderr


@pytest.mark.parametrize("command", sorted(cli.UNPORTED_COMMANDS))
def test_unported_commands_exit_2_naming_their_item(command, capsys):
    assert cli.main([command, "--help"]) == 2
    err = capsys.readouterr().err
    assert f"'{command}' is not ported" in err
    assert f"(ROADMAP item {cli.UNPORTED_COMMANDS[command][1]})" in err


def test_version_and_help_run_in_process(capsys):
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.startswith("ig-tpu-torch ")
    assert cli.main([]) == 0
    assert "trace" in capsys.readouterr().out
