"""A configuration, a traffic mix, a cell and a per-layer metric added
as files and BENCHMARK.json entries are picked up with no edit."""

import json
import shutil

import conftest  # noqa: F401 (puts the repository on sys.path)
from portbench.run import execute
from portbench.spec import PKG, Spec


def test_new_files_are_picked_up(tmp_path):
    for d in ("configs", "traffic", "cells", "metrics"):
        (tmp_path / d).mkdir()
    shutil.copy(PKG / "configs" / "exec-sketch.json", tmp_path / "configs" / "exec-small.json")
    cfg = json.loads((tmp_path / "configs" / "exec-small.json").read_text())
    cfg["stream"]["containers"] = 16
    (tmp_path / "configs" / "exec-small.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "tiny-backlog.json").write_text(json.dumps(
        {"kind": "backlog", "batch_events": 2048, "pool_batches": 2, "warmup_min_batches": 2}))
    (tmp_path / "cells" / "exec-small.tiny.json").write_text(json.dumps(
        {"config": "exec-small", "traffic": "tiny-backlog", "limits": {"state_words_off": 0}}))
    (tmp_path / "metrics" / "batches_seen.py").write_text(
        "def read(obs):\n    return float(len(obs['batches']))\n")
    shutil.copy(PKG / "metrics" / "setup_s.py", tmp_path / "metrics" / "setup_s.py")
    bench = {"workloads": [{"name": "exec-small.tiny", "config": "exec-small",
                            "traffic": "tiny-backlog", "chips": 1, "why": "test"}],
             "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower",
                             "bound": 0.25, "source": "host_clock"}],
             "per_layer": [{"name": "batches_seen", "unit": "batches", "better": "higher",
                            "source": "host_clock", "layer": "source queue",
                            "moves": "setup_s"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(tmp_path / "BENCHMARK.json", root=tmp_path)
    assert spec.config("exec-small")["stream"]["containers"] == 16
    assert [m["name"] for m in spec.metrics_for("exec-small.tiny", True)] == ["batches_seen"]
    line, _ = execute(spec, "exec-small.tiny", 3, 1.0, True, "cpu", 0.0)
    assert line["correct"]
    assert line["metrics"]["batches_seen"]["value"] > 0
    line, _ = execute(spec, "exec-small.tiny", 3, 1.0, False, "cpu", 0.0)
    assert set(line["metrics"]) == {"setup_s"}
