"""The port's doctor (`inspektor_gadget_tpu_torch/doctor.py`) against the
JAX package's, with the reference's own cases (tests/test_doctor.py).

The two packages probe the same host. `gadget_report` is held to the
reference's row by row (category, name, status, window, note) on the
same windows dict: the host's own windows, and the same windows with
one or another forced down. The rows that differ by design
(``native_toolchain``, ``device_topology``, the PLATFORM line) are held
to what the port's docstring says of them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import types

import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu import doctor as RD
from inspektor_gadget_tpu_torch import doctor as PD
from inspektor_gadget_tpu_torch.telemetry import snapshot
from inspektor_gadget_tpu_torch.utils import platform_probe as PP

from _torch_registry import own_gadgets_only

torch.set_num_threads(2)

NAMES = {"native_lib", "native_toolchain", "fanotify", "perf", "kmsg", "ptrace", "sock_diag",
         "netlink_proc", "af_packet", "mountinfo", "procfs", "blktrace", "tcpinfo", "audit",
         "captrace", "fstrace", "sockstate", "sigtrace", "container_runtime", "capture_dir",
         "history_dir", "history_tiers", "standing_queries", "fleet_health", "shared_runs",
         "device_topology", "pipeline_health", "accuracy", "fleet_topology"}


@pytest.fixture
def no_fleet(monkeypatch, tmp_path):
    """Neither package sees a local fleet; stores under tmp_path."""
    import inspektor_gadget_tpu.cli.deploy as ref_deploy
    from inspektor_gadget_tpu_torch.cli.deploy import STATE_FILE_ENV
    monkeypatch.setenv(STATE_FILE_ENV, str(tmp_path / "agents.json"))
    monkeypatch.setattr(ref_deploy, "STATE_FILE", str(tmp_path / "ref-agents.json"))
    monkeypatch.setenv("IG_HISTORY_DIR", str(tmp_path / "history"))
    monkeypatch.setenv("IG_CAPTURE_DIR", str(tmp_path / "capture"))


@pytest.fixture
def acquire_state():
    """`last_acquire()` as it was before the test, after it."""
    before = PP._last_acquire
    yield
    PP._last_acquire = before


@pytest.fixture(scope="module")
def host_windows():
    return RD.probe_windows()


def _as_port(windows: dict) -> dict:
    return {k: PD.Window(w.name, w.ok, w.detail) for k, w in windows.items()}


def _rows(report) -> list[tuple]:
    return [(g.category, g.name, g.status, g.window, g.note) for g in report]


def test_probe_windows_names_and_shape(no_fleet):
    windows = PD.probe_windows()
    assert set(windows) == NAMES == set(RD.probe_windows())
    for w in windows.values():
        assert isinstance(w.ok, bool) and w.detail


def test_windows_agree_with_the_reference_on_this_host(no_fleet, host_windows):
    """Both packages probe the same kernel windows, runtime and stores:
    every verdict agrees but the two rows that differ by design."""
    got = PD.probe_windows()
    for name, w in got.items():
        if name in ("native_toolchain", "device_topology"):
            continue
        assert w.ok == host_windows[name].ok, (name, w.detail, host_windows[name].detail)


def _forced(windows: dict, **down: str) -> dict:
    out = dict(windows)
    for name, detail in down.items():
        out[name] = dataclasses.replace(windows[name], ok=False, detail=detail)
    return out


SCENARIOS = {
    "host": {},
    "no fanotify": {"fanotify": "forced down"},
    "no native lib": {"native_lib": "forced: build failed"},
    "no tracefs": {"captrace": "tracefs", "fstrace": "tracefs", "sockstate": "tracefs",
                   "sigtrace": "tracefs", "blktrace": "tracefs"},
    "no tracefs, no audit": {"captrace": "tracefs", "audit": "no CAP_AUDIT_READ",
                             "fstrace": "tracefs", "perf": "paranoid 4"},
    "card host": {"fanotify": "x", "captrace": "x", "fstrace": "x", "sockstate": "x",
                  "sigtrace": "x", "blktrace": "x", "audit": "x", "kmsg": "x", "perf": "x",
                  "tcpinfo": "x"},
    "nothing but procfs": {n: "down" for n in ("netlink_proc", "fanotify", "mountinfo",
                                               "sock_diag", "kmsg", "ptrace", "perf",
                                               "af_packet", "audit", "captrace", "fstrace",
                                               "sockstate", "sigtrace", "blktrace",
                                               "tcpinfo", "capture_dir", "history_dir")},
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_gadget_report_equals_the_reference_on_the_same_windows(scenario, host_windows):
    windows = _forced(host_windows, **SCENARIOS[scenario])
    with own_gadgets_only():
        want = _rows(RD.gadget_report(windows))
        got = _rows(PD.gadget_report(_as_port(windows)))
    assert got == want
    assert len(got) == 30


def test_gadget_report_covers_every_registered_gadget(no_fleet):
    from inspektor_gadget_tpu_torch.gadgets import get_all
    with own_gadgets_only():
        report = PD.gadget_report()
        registered = {(d.category, d.name) for d in get_all()}
    assert {(g.category, g.name) for g in report} == registered
    assert all(g.status in ("real", "degraded", "unavailable", "synthetic-only") for g in report)
    counts = {g.status: 0 for g in report}
    for g in report:
        counts[g.status] += 1
    snap = snapshot()
    for status, n in counts.items():
        assert snap[f'ig_doctor_gadgets{{status="{status}"}}'] == n


def test_gadget_report_reflects_live_windows(no_fleet):
    windows = PD.probe_windows()
    with own_gadgets_only():
        by_name = {(g.category, g.name): g for g in PD.gadget_report(windows)}
        if windows["native_lib"].ok and windows["fanotify"].ok:
            assert by_name[("trace", "open")].status == "real"
        if windows["native_lib"].ok and windows["captrace"].ok:
            assert by_name[("trace", "capabilities")].status == "real"
        down = _forced(windows, fanotify="forced down")
        g = {(x.category, x.name): x for x in PD.gadget_report(down)}
    assert g[("trace", "open")].status == "unavailable"
    assert g[("trace", "open")].note == "forced down"


def test_device_topology_row_reads_only_an_initialised_card(monkeypatch):
    """Unprobed while this process has not initialised CUDA (the CPU test
    process never does); with a context, the card count, mesh, shard
    eligibility and each card's name, capability and memory."""
    w = PD._probe_device_topology()
    assert w.ok and "unprobed" in w.detail
    props = types.SimpleNamespace(name="NVIDIA H100 80GB HBM3", major=9, minor=0,
                                  total_memory=85 << 30)
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        is_initialized=lambda: True, device_count=lambda: 2,
        get_device_properties=lambda i: props))
    monkeypatch.setitem(sys.modules, "torch", fake)
    w = PD._probe_device_topology()
    assert w.ok
    assert w.detail.startswith("2 local cuda device(s), ingest mesh (node=2); "
                               "shard-ingest eligible; NVIDIA H100 80GB HBM3 (cc 9.0, 85.0 GiB)")
    fake.cuda.device_count = lambda: 1
    assert "shard-ingest needs >= 2 devices" in PD._probe_device_topology().detail


def test_fleet_topology_row_reports_tree_shape(monkeypatch, tmp_path):
    from inspektor_gadget_tpu_torch.cli.deploy import STATE_FILE_ENV
    state = tmp_path / "fleet.json"
    monkeypatch.setenv(STATE_FILE_ENV, str(state))
    w = PD._probe_fleet_topology()
    assert w.ok and "query-time choice" in w.detail
    state.write_text(json.dumps({"targets": {f"n{i}": f"unix:///tmp/{i}.sock"
                                             for i in range(6)}}))
    w = PD._probe_fleet_topology()
    assert w.ok and "6 agent(s)" in w.detail and "fan-in 4" in w.detail
    assert "frame(s)/query" in w.detail


def test_history_dir_row_reports_writability_usage_and_free(monkeypatch, tmp_path):
    monkeypatch.setenv("IG_HISTORY_DIR", str(tmp_path / "hist"))
    w = PD._probe_history_dir()
    assert w.ok and "writable" in w.detail and "segment(s)" in w.detail and "MiB" in w.detail
    if os.geteuid() != 0:
        ro = tmp_path / "ro"
        ro.mkdir()
        os.chmod(ro, 0o500)
        monkeypatch.setenv("IG_HISTORY_DIR", str(ro / "hist"))
        w = PD._probe_history_dir()
        assert not w.ok and "unwritable" in w.detail


def test_capture_dir_row(monkeypatch, tmp_path):
    monkeypatch.setenv("IG_CAPTURE_DIR", str(tmp_path / "cap"))
    w = PD._probe_capture_dir()
    assert w.ok and str(tmp_path / "cap") in w.detail and "writable" in w.detail
    blocker = tmp_path / "file"
    blocker.write_text("x")
    monkeypatch.setenv("IG_CAPTURE_DIR", str(blocker / "cap"))
    w = PD._probe_capture_dir()
    assert not w.ok and "unwritable" in w.detail


def test_fleet_health_row_reports_local_fleet(monkeypatch):
    import inspektor_gadget_tpu_torch.cli.deploy as deploy
    monkeypatch.setattr(deploy, "local_targets", lambda path=None: {})
    w = PD._probe_fleet_health()
    assert w.ok and "single-node" in w.detail
    monkeypatch.setattr(deploy, "local_targets", lambda path=None: {"ghost": "127.0.0.1:1"})
    w = PD._probe_fleet_health()
    assert not w.ok and "unreachable" in w.detail and "ghost" in w.detail


def test_shared_runs_row_reports_fleet_shared_state(monkeypatch):
    import inspektor_gadget_tpu_torch.cli.deploy as deploy
    monkeypatch.setattr(deploy, "local_targets", lambda path=None: {})
    w = PD._probe_shared_runs()
    assert w.ok and "single-node" in w.detail
    monkeypatch.setattr(deploy, "local_targets", lambda path=None: {"ghost": "127.0.0.1:1"})
    w = PD._probe_shared_runs()
    assert not w.ok and "unreadable" in w.detail and "ghost" in w.detail


def test_standing_queries_row_reports_live_engines():
    from inspektor_gadget_tpu_torch.queries import StandingQuery, StandingQueryEngine
    from inspektor_gadget_tpu_torch.queries import engine as qengine
    w = PD._probe_standing_queries()
    if not qengine.live_engines():
        assert w.ok and "opt-in" in w.detail
    qengine.register("doctor-test", StandingQueryEngine(
        [StandingQuery(id="hot", stats=("topk",), range_s=60.0)],
        gadget="trace/exec", node="n0"))
    try:
        w = PD._probe_standing_queries()
        assert w.ok and "hot" in w.detail and "cache" in w.detail
    finally:
        qengine.unregister("doctor-test")


def test_quiet_planes_report_ok(no_fleet):
    for probe, word in ((PD._probe_pipeline_health, "no live instrumented runs"),
                        (PD._probe_accuracy, "no audited runs")):
        w = probe()
        assert w.ok
        if not w.detail.split(" — ")[0].endswith("run(s)"):
            assert word in w.detail


def test_render_report_has_sections_and_the_platform_line(no_fleet, acquire_state):
    PP._last_acquire = None
    out = PD.render_report()
    assert "CAPTURE WINDOWS" in out and "GADGETS" in out and "SUMMARY" in out
    assert "PLATFORM unprobed (agents probe at startup; see --device)" in out
    PP.acquire_platform("cpu")
    assert "PLATFORM cpu (cpu requested)" in PD.render_report()
    with pytest.raises(PP.PlatformError):
        PP.acquire_platform("cuda", timeout=5.0, probe_fn=lambda: PP.ProbeResult(
            False, "", "probe rc=1: no libcuda", 0.1))
    assert "PLATFORM cuda FAILED (probe rc=1: no libcuda)" in PD.render_report()


def test_doctor_cli_exit_code_is_1_iff_a_gadget_is_unavailable(no_fleet, capsys):
    from inspektor_gadget_tpu_torch.cli.main import main
    with own_gadgets_only():
        rc = main(["doctor", "-o", "json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == (1 if any(g["status"] == "unavailable" for g in doc["gadgets"]) else 0)
    assert set(doc["windows"]) == NAMES and len(doc["gadgets"]) == 30
    assert set(doc) == {"windows", "gadgets", "platform", "telemetry"}


class _RefOnlyDesc:
    category, name, description = "trace", "doctor-only-ref", "a reference-only gadget"

    def new_instance(self, ctx):
        raise NotImplementedError


def test_doctor_reads_the_ports_registry_only():
    """A gadget registered in the reference's registry alone (as
    tests/test_aux.py's example does for good) is not the port's."""
    from inspektor_gadget_tpu.gadgets import registry as ref_registry
    key = ("trace", "doctor-only-ref")
    ref_registry._REGISTRY[key] = _RefOnlyDesc()
    try:
        rows = {(g.category, g.name) for g in PD.gadget_report(_as_port(RD.probe_windows()))}
    finally:
        ref_registry._REGISTRY.pop(key, None)
    assert key not in rows
