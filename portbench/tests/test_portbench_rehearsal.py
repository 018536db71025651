"""Every cell rehearsed on the CPU at a tiny size through the same code,
and the measurement path's refusal to run without a card."""

import json
import subprocess
import sys

import pytest

from conftest import HELD_CELLS, ROOT, tiny
from portbench.run import execute, main
from portbench.spec import Spec

SPEC = Spec(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC.bench["workloads"]]
DEVICE_SOURCES = ("device_trace",)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS + HELD_CELLS)
def test_cell_rehearses_on_the_cpu(cell, trace, full_spec):
    line, rows = execute(full_spec, cell, 2 ** 31 + 17, 1.5, bool(trace), "cpu", 0.0,
                         traffic_overrides=tiny(full_spec, cell))
    assert line["correct"] is True, rows
    assert list(line)[-1] == "compared"
    assert line["device"]["platform"] == "cpu" and line["device"]["kind"] == "cpu"
    assert "busy_s" not in line["device"] and "breakdown" not in line
    by_name = {m["name"]: m for m in full_spec.bench["end_to_end"] + full_spec.bench["per_layer"]}
    for name in line["metrics"]:
        assert by_name[name]["source"] not in DEVICE_SOURCES, name
    if not trace:
        assert "setup_s" in line["metrics"]
    json.dumps(line)


def test_measurement_path_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal is for hosts without one")
    rc = main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_rehearsal_loads_no_jax():
    """The rehearsal in a fresh process leaves no module whose top-level
    name is jax, jaxlib, flax or the JAX package in sys.modules (the
    port's own name begins with the JAX package's: names compare whole)."""
    code = (
        "import sys, json\n"
        "from portbench.run import execute, forbidden_modules, ROOT\n"
        "from portbench.spec import Spec\n"
        "spec = Spec(ROOT / 'BENCHMARK.json')\n"
        f"line, _ = execute(spec, {CELLS[0]!r}, 5, 1.0, False, 'cpu', 0.0,\n"
        "                  traffic_overrides={'batch_events': 4096, 'pool_batches': 2})\n"
        "assert line['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "inspektor_gadget_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "inspektor_gadget_tpu"}


def test_a_cell_runs_on_the_card(card, tmp_path):
    """On a card: the command itself, one short run, correct."""
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "11", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", CELLS + HELD_CELLS)
def test_the_traced_slice_follows_the_window(cell, full_spec):
    """A traced run profiles a slice after its window, once every chunk
    of the window is popped: the window itself runs as untraced."""
    from portbench.harness import Run
    run = Run(full_spec, cell, 2 ** 31 + 29, 1.5, trace=True, device="cpu",
              traffic_overrides=tiny(full_spec, cell))
    obs = run.execute()["obs"]
    assert run.t_end <= run.prof_t[0] < run.prof_t[1]
    assert "profile" in obs and obs["profile"]["window_s"] > 0
    assert all(b["handled"] <= run.prof_t[0] for b in obs["batches"])
    if "chunks" in obs:
        assert obs["chunks"]["dropped"] == 0
        assert max(obs["chunks"]["pop"]) <= run.prof_t[0]
