"""The port's hook installation and runtime-invoked hook round trip
(ref: gadget-container/entrypoint.sh:83-142 hook installation,
hooks/oci/main.go container add via the agent socket): the cases of
``tests/test_hooks.py`` against ``inspektor_gadget_tpu_torch``'s agent on
the CPU, plus the proof that an installed hook runs the port's agent."""

import io
import json
import os
import subprocess
import tempfile
from pathlib import Path

import pytest

from inspektor_gadget_tpu_torch.agent.hooks import (
    HookInstaller, _hook_command, detect_hook_mode, run_oci_hook,
)
from inspektor_gadget_tpu_torch.agent.main import main as agent_main


def test_detect_hook_mode(tmp_path):
    assert detect_hook_mode(str(tmp_path)) == "fanotify"
    (tmp_path / "run/containerd").mkdir(parents=True)
    (tmp_path / "run/containerd/containerd.sock").touch()
    assert detect_hook_mode(str(tmp_path)) == "nri"
    (tmp_path / "run/crio").mkdir(parents=True)
    (tmp_path / "run/crio/crio.sock").touch()
    assert detect_hook_mode(str(tmp_path)) == "oci"  # crio preferred


def test_install_and_uninstall_oci_hook_configs(tmp_path):
    inst = HookInstaller(str(tmp_path), "unix:///run/ig.sock")
    res = inst.install("oci")
    assert res.mode == "oci" and len(res.installed) == 4  # 2 dirs × 2 stages
    cfg = json.loads((tmp_path / "etc/containers/oci/hooks.d/"
                      "ig-tpu-prestart.json").read_text())
    assert cfg["version"] == "1.0.0"
    assert cfg["stages"] == ["prestart"]
    assert cfg["when"] == {"always": True}
    assert "--stage" in cfg["hook"]["args"]
    post = json.loads((tmp_path / "usr/share/containers/oci/hooks.d/"
                       "ig-tpu-poststop.json").read_text())
    assert post["stages"] == ["poststop"]
    removed = inst.uninstall()
    assert len(removed) == 4
    assert not list((tmp_path / "etc/containers/oci/hooks.d").iterdir())


def test_install_nri_appends_to_existing_conf(tmp_path):
    conf = tmp_path / "etc/nri/conf.json"
    conf.parent.mkdir(parents=True)
    conf.write_text(json.dumps(
        {"version": "0.1", "plugins": [{"type": "other-plugin"}]}))
    inst = HookInstaller(str(tmp_path))
    res = inst.install("nri")
    assert res.mode == "nri"
    data = json.loads(conf.read_text())
    types = [p["type"] for p in data["plugins"]]
    assert types == ["other-plugin", "ig-tpu-nri"]  # appended, not replaced
    shim = tmp_path / "opt/nri/bin/ig-tpu-nri"
    assert shim.exists() and os.access(shim, os.X_OK)
    # idempotent: a second install must not duplicate the entry
    inst.install("nri")
    assert [p["type"] for p in json.loads(conf.read_text())["plugins"]] == \
        ["other-plugin", "ig-tpu-nri"]
    inst.uninstall()
    data = json.loads(conf.read_text())
    assert [p["type"] for p in data["plugins"]] == ["other-plugin"]
    assert not shim.exists()


@pytest.fixture()
def live_agent():
    from inspektor_gadget_tpu_torch.agent.service import serve
    tmp = tempfile.mkdtemp()
    addr = f"unix://{tmp}/hook-agent.sock"
    server, agent = serve(addr, node_name="hook-node", device="cpu")
    yield addr
    server.stop(grace=0.5).wait(10.0)
    # the hooks' containers live in the process-wide localmanager
    # collection: take out what the cases added
    from inspektor_gadget_tpu_torch.operators.operators import get as get_op
    cc = get_op("localmanager").cc
    if cc is not None:
        for c in list(cc.get_all()):
            if c.id.startswith("hooked-"):
                cc.remove_container(c.id)


def _fake_bundle(tmp_path):
    bundle = tmp_path / "bundle"
    bundle.mkdir()
    (bundle / "config.json").write_text(json.dumps({"annotations": {
        "io.kubernetes.cri.sandbox-name": "pod-hooked",
        "io.kubernetes.cri.sandbox-namespace": "ns-hooked",
        "io.kubernetes.cri.container-name": "app-hooked",
        "io.kubernetes.cri.container-type": "container",
    }}))
    return bundle


def _agent_containers(addr):
    from inspektor_gadget_tpu_torch.agent.client import AgentClient
    client = AgentClient(addr)
    try:
        return {c["id"]: c for c in client.dump_state().get("containers", [])}
    finally:
        client.close()


def test_oci_hook_round_trip_in_process(tmp_path, live_agent, monkeypatch):
    """prestart state in → container lands in the collection with bundle
    identity resolved; poststop removes it."""
    bundle = _fake_bundle(tmp_path)
    state = {"ociVersion": "1.0.2", "id": "hooked-1", "pid": os.getpid(),
             "bundle": str(bundle)}
    rc = run_oci_hook("prestart", live_agent, io.StringIO(json.dumps(state)))
    assert rc == 0
    containers = _agent_containers(live_agent)
    assert "hooked-1" in containers, containers
    c = containers["hooked-1"]
    assert c["name"] == "app-hooked"
    assert c["pod"] == "pod-hooked" and c["namespace"] == "ns-hooked"
    assert int(c["mntns"]) == os.stat(f"/proc/{os.getpid()}/ns/mnt").st_ino

    rc = run_oci_hook("poststop", live_agent,
                      io.StringIO(json.dumps({"id": "hooked-1"})))
    assert rc == 0
    assert "hooked-1" not in _agent_containers(live_agent)


def test_installed_hook_config_round_trip_subprocess(tmp_path, live_agent):
    """The full fake-runtime path: install into a scratch host root, then
    execute exactly the command the installed config tells the runtime to
    run, with the OCI state on stdin — the container must appear."""
    inst = HookInstaller(str(tmp_path), live_agent)
    inst.install("oci")
    cfg = json.loads((tmp_path / "etc/containers/oci/hooks.d/"
                      "ig-tpu-prestart.json").read_text())
    cmd = [cfg["hook"]["path"]] + cfg["hook"]["args"][1:]
    bundle = _fake_bundle(tmp_path)
    state = {"ociVersion": "1.0.2", "id": "hooked-sub", "pid": os.getpid(),
             "bundle": str(bundle)}
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent.parent)
    r = subprocess.run(cmd, input=json.dumps(state), text=True,
                       capture_output=True, env=env, timeout=60)
    assert r.returncode == 0, r.stderr
    containers = _agent_containers(live_agent)
    assert "hooked-sub" in containers
    assert containers["hooked-sub"]["name"] == "app-hooked"


def test_oci_hook_rejects_bad_state(live_agent):
    assert run_oci_hook("prestart", live_agent, io.StringIO("not json")) == 1
    assert run_oci_hook("prestart", live_agent, io.StringIO("{}")) == 1


def test_oci_hook_degrades_when_agent_down(tmp_path):
    """A prestart hook exiting nonzero BLOCKS container creation on the
    host (OCI contract) — an unreachable agent must degrade to exit 0,
    fast (bounded timeout, not the 30s client default)."""
    import time
    state = {"id": "orphan", "pid": 1}
    t0 = time.monotonic()
    rc = run_oci_hook("prestart", f"unix://{tmp_path}/nope.sock",
                      io.StringIO(json.dumps(state)))
    elapsed = time.monotonic() - t0
    assert rc == 0
    assert elapsed < 10.0, f"hook stalled {elapsed:.1f}s"


def test_nri_unknown_events_are_ignored(live_agent):
    """Sandbox/synchronize NRI events must not land in the collection as
    workload containers."""
    for event in ("RunPodSandbox", "StopPodSandbox", "Synchronize"):
        rc = run_oci_hook("prestart", live_agent,
                          io.StringIO(json.dumps(
                              {"event": event, "id": f"sbx-{event}",
                               "pid": 1})), nri=True)
        assert rc == 0
    containers = _agent_containers(live_agent)
    assert not any(c.startswith("sbx-") for c in containers)


def test_containerized_install_warns_on_host_invalid_command(tmp_path):
    """Installing from a container (host_root != /) with the default
    in-container interpreter must warn that the host can't exec it."""
    inst = HookInstaller(str(tmp_path), "unix:///run/ig.sock")
    res = inst.install("oci")
    assert any("WARNING" in n for n in res.notes), res.notes
    # an explicit host-valid command silences the warning
    (tmp_path / "usr/bin").mkdir(parents=True)
    (tmp_path / "usr/bin/ig-hook").touch()
    inst2 = HookInstaller(str(tmp_path), "unix:///run/ig.sock",
                          hook_cmd=["/usr/bin/ig-hook", "--socket",
                                    "unix:///run/ig.sock"])
    res2 = inst2.install("oci")
    assert not any("WARNING" in n for n in res2.notes)
    cfg = json.loads((tmp_path / "etc/containers/oci/hooks.d/"
                      "ig-tpu-prestart.json").read_text())
    assert cfg["hook"]["path"] == "/usr/bin/ig-hook"


def test_cli_install_hooks_subcommand(tmp_path, capsys):
    rc = agent_main(["install-hooks", "--host-root", str(tmp_path),
                     "--mode", "oci", "--socket", "unix:///run/x.sock"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "hook mode: oci" in out and "ig-tpu-prestart.json" in out
    rc = agent_main(["uninstall-hooks", "--host-root", str(tmp_path)])
    assert rc == 0
    assert "removed" in capsys.readouterr().out


def test_hook_command_runs_the_port_s_agent(tmp_path):
    cmd = _hook_command("unix:///run/x.sock")
    assert cmd[1:3] == ["-m", "inspektor_gadget_tpu_torch.agent.main"]
    assert cmd[3:] == ["oci-hook", "--socket", "unix:///run/x.sock"]
    HookInstaller(str(tmp_path), "unix:///run/x.sock").install("nri")
    shim = (tmp_path / "opt/nri/bin/ig-tpu-nri").read_text()
    assert "inspektor_gadget_tpu_torch.agent.main" in shim
    assert "inspektor_gadget_tpu.agent" not in shim
