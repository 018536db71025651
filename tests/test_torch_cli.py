"""The port's CLI (`inspektor_gadget_tpu_torch.cli.main`, the
``ig-tpu-torch`` console script) as a black box, as ``tests/test_cli.py``
drives the reference's: subprocesses on the CPU, beside the reference's
CLI where the two must answer alike. The history route: a ``trace exec``
with ``--tpusketch-history true`` seals into a store that ``query``,
``history tiers|compact|archive`` of both packages read alike.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from inspektor_gadget_tpu_torch.cli import main as cli

from _torch_registry import own_gadgets_only

PORT = [sys.executable, "-m", "inspektor_gadget_tpu_torch.cli.main"]
REF = [sys.executable, "-m", "inspektor_gadget_tpu.cli.main"]
SMALL = ["--tpusketch-depth", "3", "--tpusketch-log2-width", "10", "--tpusketch-hll-p", "8",
         "--tpusketch-entropy-log2-width", "6", "--tpusketch-topk", "8"]


def run(cmd, *args, timeout=180):
    return subprocess.run(cmd + list(args), capture_output=True, text=True, timeout=timeout)


def test_list_and_catalog():
    r = run(PORT, "list")
    assert r.returncode == 0, r.stderr
    gadgets = ([["advise", "network-policy"], ["advise", "seccomp-profile"],
                ["audit", "seccomp"], ["profile", "block-io"], ["profile", "cpu"],
                ["snapshot", "process"], ["snapshot", "socket"]]
               + [["top", n] for n in ("alerts", "block-io", "file", "metrics", "recordings",
                                       "self", "sketch", "tcp", "windows")]
               + [["trace", n] for n in ("bind", "capabilities", "dns", "exec", "fsslower",
                                         "mount", "network", "oomkill", "open", "signal",
                                         "sni", "tcp", "tcpconnect")]
               + [["traceloop", "traceloop"]])
    assert [ln.split()[:2] for ln in r.stdout.strip().splitlines()] == gadgets
    r = run(PORT, "catalog")
    assert r.returncode == 0, r.stderr
    cat = json.loads(r.stdout)
    assert [[g["category"], g["name"]] for g in cat["gadgets"]] == gadgets
    ops = {op["name"]: len(op["instanceParams"]) for op in cat["operators"]}
    assert ops == {"localmanager": 2, "tpusketch": 38, "kubemanager": 4, "kubeipresolver": 1,
                   "alerts": 4, "capture": 7}


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
        # the same seeded stream; the wall clock and the containers aside,
        # which each package's localmanager names from its own procfs scan
        assert r["node"] == w["node"] == "local"
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


def test_cuda_without_a_card_exits_1():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = run(PORT, "trace", "exec", "--device", "cuda", "--source", "pysynthetic", "--timeout",
            "1", "--tpusketch-enable", "true")
    assert r.returncode == 1
    assert "torch.cuda.is_available() is false; pass device='cpu'" in r.stderr


# the commands the port lacked once (`bench`, ROADMAP item 20, the last of
# them): each is ported now. The routes of the fan-out run in
# tests/test_torch_cli_routes.py
@pytest.mark.parametrize("command", ["bench"])
def test_unported_commands_exit_2_naming_their_item(command, capsys):
    """A command once unported answers --help with exit 0, lists its
    verbs and names no ROADMAP item."""
    with pytest.raises(SystemExit) as e:
        cli.main([command, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr()
    assert all(verb in out.out for verb in ("run", "compare", "report", "import"))
    assert "ROADMAP item" not in out.out + out.err


def _top_level_commands(parser) -> set[str]:
    (sub,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return set(sub.choices)


def test_top_level_commands_equal_the_references():
    """Every top-level command of the reference's CLI is the port's."""
    from inspektor_gadget_tpu.cli import main as ref_cli
    with own_gadgets_only():
        got, want = (_top_level_commands(m.build_parser()) for m in (cli, ref_cli))
    assert got == want
    assert {"bench", "doctor", "fleet", "query", "agent"} <= got


# the gadgets of ROADMAP item 17b, each with the flags of a short CPU run
GADGETS_17B = {
    ("top", "block-io"): ["--interval", "250ms"],
    ("top", "file"): ["--interval", "250ms"],
    ("top", "metrics"): ["--interval", "250ms"],
    ("top", "self"): ["--interval", "250ms"],
    ("top", "tcp"): ["--interval", "250ms", "--source", "pysynthetic"],
    ("profile", "cpu"): [],
    ("profile", "block-io"): ["--quantiles", "true"],
    ("audit", "seccomp"): ["--source", "pysynthetic"],
    ("advise", "seccomp-profile"): ["--source", "pysynthetic"],
    ("advise", "network-policy"): ["--source", "pysynthetic"],
    ("traceloop", "traceloop"): ["--source", "pysynthetic"],
}


@pytest.fixture
def restore_sigint():
    """cmd_run installs its own SIGINT handler: put the test process's back."""
    prev = signal.getsignal(signal.SIGINT)
    yield
    signal.signal(signal.SIGINT, prev)


@pytest.mark.parametrize("category,name", list(GADGETS_17B),
                         ids=[f"{c}-{n}" for c, n in GADGETS_17B])
def test_17b_gadgets_run_on_the_cpu(category, name, capsys, restore_sigint):
    assert cli.main([category, name, "--device", "cpu", "--timeout", "1",
                     *GADGETS_17B[(category, name)]]) == 0
    out = capsys.readouterr().out
    assert out.strip(), f"{category} {name} printed nothing"


def test_top_file_and_traceloop_exit_0():
    for args in (("top", "file", "--interval", "250ms"),
                 ("traceloop", "traceloop", "--source", "pysynthetic")):
        r = run(PORT, *args, "--device", "cpu", "--timeout", "1", timeout=120)
        assert r.returncode == 0 and r.stdout.strip(), r.stderr


def test_version_and_help_run_in_process(capsys):
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.startswith("ig-tpu-torch ")
    assert cli.main([]) == 0
    assert "trace" in capsys.readouterr().out


# -- the history route --------------------------------------------------------------

QUERIES = json.dumps([{"id": "hot", "stats": ["topk", "cardinality"], "range": "4s"}])
SCHEDULE = "1s@2s,60s@inf"


@pytest.fixture(scope="module")
def history_run(tmp_path_factory):
    """One ``trace exec`` of the port with the history plane on, sealing a
    window a second into its store."""
    base = str(tmp_path_factory.mktemp("cli") / "hist")
    r = run(PORT, "trace", "exec", "--device", "cpu", "--source", "pysynthetic", "--rate",
            "40000", "--batch-size", "4096", "--timeout", "3", "-F", "uid:99",
            "--tpusketch-enable", "true", "--tpusketch-harvest-interval", "1s", *SMALL,
            "--tpusketch-history", "true", "--tpusketch-history-interval", "1s",
            "--tpusketch-history-dir", base, "--tpusketch-standing-queries", QUERIES)
    assert r.returncode == 0, r.stderr
    return base, r.stdout


def _answer(cmd, base, *extra):
    r = run(cmd, "query", "--history", base, "--gadget", "trace/exec", "-o", "json", *extra)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


def test_query_reads_the_store_as_the_reference_does(history_run):
    base, out = history_run
    got, want = _answer(PORT, base), _answer(REF, base)
    assert got == want
    last = [ln for ln in out.splitlines() if ln.startswith("— sketch epoch")][-1]
    assert got["windows"] >= 2
    assert got["events"] == int(last.split("events=")[1].split()[0].replace(",", ""))
    keyed = _answer(PORT, base, "--key", "kind:1")  # exec events are kind 1
    assert keyed == _answer(REF, base, "--key", "kind:1")
    assert list(keyed["slices"]) == ["kind:1"] and keyed["slices"]["kind:1"]["events"] > 0
    pruned = _answer(PORT, base, "--key", "kind:0")  # no window carries it
    assert pruned == _answer(REF, base, "--key", "kind:0") and pruned["windows"] == 0
    r = run(PORT, "query", "--history", base, "--slices", "--top", "3", "--quantiles")
    assert r.returncode == 0 and "window(s) [local]" in r.stdout, r.stderr
    assert "quantiles: not available" in r.stdout  # sealed without the quantile plane


def test_log2_histogram_renders_as_the_reference():
    import numpy as np
    from inspektor_gadget_tpu.cli.query import render_histogram_log2 as ref_render
    from inspektor_gadget_tpu_torch.cli.query import render_histogram_log2
    hist = np.random.default_rng(3).integers(0, 5000, 40)
    hist[:6] = 0
    hist[20] = 0
    assert render_histogram_log2(hist.tolist()) == ref_render(hist.tolist())
    assert len(render_histogram_log2(hist.tolist())) == 34 and render_histogram_log2([]) == []


def test_history_tiers_compact_and_archive(history_run, tmp_path):
    """`history compact` folds exactly (the answer is unchanged) and
    `history archive` offloads what compaction left at the final level;
    `query --archive-dir` rehydrates it to the same answer. The port's
    and the reference's passes over two copies of the store give the
    same segment bytes."""
    import shutil
    base, _ = history_run
    first = _answer(PORT, base)
    stores = {}
    for name, cmd in (("port", PORT), ("ref", REF)):
        copy = str(tmp_path / name)
        shutil.copytree(base, copy)
        r = run(cmd, "history", "tiers", "--history", copy, "-o", "json")
        assert r.returncode == 0, r.stderr
        tiers = json.loads(r.stdout)["tiers"]
        assert tiers["levels"]["0"]["windows"] == first["windows"]
        r = run(cmd, "history", "compact", "--history", copy, "--schedule", SCHEDULE)
        assert r.returncode == 0 and "super-window(s)" in r.stdout, r.stderr
        stores[name] = copy
    (store,) = os.listdir(stores["port"])
    segs = {n: sorted(f for f in os.listdir(os.path.join(d, store)) if f.startswith("seg-"))
            for n, d in stores.items()}
    assert segs["port"] == segs["ref"]
    for f in segs["port"]:
        with open(os.path.join(stores["port"], store, f), "rb") as a, \
                open(os.path.join(stores["ref"], store, f), "rb") as b:
            assert a.read() == b.read(), f
    compacted = _answer(PORT, stores["port"])
    assert compacted["compacted_windows"] == compacted["windows"] > 0
    arch = str(tmp_path / "archive")
    r = run(PORT, "history", "archive", "--history", stores["port"], "--archive-dir", arch,
            "--schedule", SCHEDULE)
    assert r.returncode == 0 and "segment(s) archived" in r.stdout, r.stderr
    assert _answer(PORT, stores["port"])["windows"] == 0
    rehydrated = _answer(PORT, stores["port"], "--archive-dir", arch)
    for ans in (compacted, rehydrated):
        for k in ("events", "distinct", "entropy_bits", "heavy_hitters"):
            assert ans[k] == first[k], k


def test_watch_list_and_local(capsys):
    assert cli.main(["watch", "--list", "-o", "json"]) == 0
    assert json.loads(capsys.readouterr().out) == {"queries": [], "errors": {}}
    assert cli.main(["watch", "--local", "--id", "hot"]) == 1
    assert "no live engine registers query 'hot'" in capsys.readouterr().err
    assert cli.main(["watch"]) == 2
