"""The benchmark's own tests: CPU rehearsals at tiny sizes."""

import json
import logging
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a cell's traffic at a size a CPU test holds: the same code, small batches
TINY = {"backlog": {"batch_events": 4096, "pool_batches": 2},
        "open_loop": {"rate_events_per_s": 20000, "pool_events": 65536, "warmup_s": 1.2}}


@pytest.fixture(autouse=True)
def _quiet_run_logs():
    logging.getLogger("ig-tpu").setLevel(logging.CRITICAL)


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the measurement path runs only on the card")
    return torch.device("cuda")


def tiny(spec, cell: str) -> dict:
    return TINY[spec.traffic(spec.cell(cell)["traffic"])["kind"]]


HELD = Path(__file__).resolve().parent / "held"
# cells held out of BENCHMARK.json (PERF.md, Open questions), with their
# files and entries: the open loop, and a configuration that runs every
# plane the reference has (invertible, quantiles, history, standing
# queries), rehearsed at tiny sizes
HELD_BENCH = json.loads((HELD / "benchmark.json").read_text())
HELD_CELLS = [w["name"] for w in HELD_BENCH["workloads"]]


@pytest.fixture(scope="session")
def full_spec(tmp_path_factory):
    """The benchmark's parts and the held cells', found as the harness
    finds them."""
    from portbench.spec import PKG, Spec
    root = tmp_path_factory.mktemp("portbench-full")
    for d in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(PKG / d, root / d)
        if (HELD / d).is_dir():
            for f in (HELD / d).iterdir():
                shutil.copy(f, root / d / f.name)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in HELD_BENCH.items():
        bench[key] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Spec(root / "BENCHMARK.json", root=root)
