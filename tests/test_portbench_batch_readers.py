"""The benchmark's readers of the operator's per-batch parts
(`portbench/metrics/`): each gives a hand-built run's observations the
expected value, and None where the run has nothing to read (a program
whose harvest records lack the keys)."""

from __future__ import annotations

from pathlib import Path

import pytest

from portbench.spec import Spec

ROOT = Path(__file__).resolve().parents[1]
SPEC = Spec(ROOT / "BENCHMARK.json")
CELL = "exec-sketch.backlog"

# two window harvests: 3 batches, then 5
HARVESTS = [
    {"batches": 3.0, "fold": 3.0, "copy": 1.5, "dispatch": 6.0, "post": 0.9,
     "device_lag": 0.3, "digest_wait": 2.0, "digest_decode": 20.0, "phase": "window"},
    {"batches": 5.0, "fold": 5.0, "copy": 2.5, "dispatch": 10.0, "post": 1.5,
     "device_lag": 0.5, "digest_wait": 4.0, "digest_decode": 22.0, "phase": "window"},
]
WANT = {"fold_ms.backlog": 1.0, "copy_ms.backlog": 0.5, "dispatch_ms.backlog": 2.0,
        "post_ms.backlog": 0.3, "device_lag_ms.backlog": 0.1, "harvest_wait_ms.backlog": 3.0}
KEYS = {"fold_ms.backlog": "fold", "copy_ms.backlog": "copy",
        "dispatch_ms.backlog": "dispatch", "post_ms.backlog": "post",
        "device_lag_ms.backlog": "device_lag", "harvest_wait_ms.backlog": "digest_wait"}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_harvest_records(name):
    entry = next(m for m in SPEC.bench["per_layer"] if m["name"] == name)
    assert (entry["unit"], entry["better"], entry["source"], entry["moves"],
            entry["workloads"]) == ("ms", "lower", "program_counter", "events_per_s", [CELL])
    read = SPEC.reader(name)
    assert read({"harvests": HARVESTS}) == pytest.approx(WANT[name])
    # the parent's records (no such key), no harvest, no batch: nothing
    bare = [{k: v for k, v in h.items() if k != KEYS[name]} for h in HARVESTS]
    assert read({"harvests": bare}) is None
    assert read({"harvests": []}) is None
    assert read({}) is None
    if name != "harvest_wait_ms.backlog":
        assert read({"harvests": [dict(h, batches=0.0) for h in HARVESTS]}) is None
