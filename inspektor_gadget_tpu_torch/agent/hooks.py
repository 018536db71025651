"""Hook installation on the host — the entrypoint's other half.

Reference contract: gadget-container/entrypoint.sh:83-142 detects the
container runtime and installs synchronous container-lifecycle hooks
before starting the daemon: crio-style OCI hook configs copied into the
host's hooks.d directories (each pointing at a tiny binary that reads the
OCI state from stdin and calls AddContainer/RemoveContainer over the
agent socket — hooks/oci/main.go:1-156, prestart.sh/poststop.sh), or an
NRI plugin registered in /etc/nri/conf.json (hooks/nri/main.go:1-148).
Fanotify needs no installation (the in-process watch).

Here the hook "binary" is this package itself: the installed config
invokes `ig-tpu-agent oci-hook <stage> --socket <sock>` (main.py), which
reads the OCI state JSON from stdin, enriches identity from the bundle's
config.json annotations (oci_annotations dialect resolvers), and calls
the agent's AddContainer/RemoveContainer — so a runtime-invoked hook
lands the container in the collection synchronously at creation, not at
the next poll tick.

All host paths are taken relative to `host_root` so deployments mount
the host filesystem at /host (as the reference's DaemonSet does) and
tests use a scratch directory.

The port's copy of ``inspektor_gadget_tpu/agent/hooks.py``: an installed
hook runs the port's agent module, so the hook lands in the port's agent.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shlex
import stat
import sys
from pathlib import Path

# crio-style OCI hook config directories, in install-preference order
# (ref: entrypoint.sh:88-90)
OCI_HOOK_DIRS = ("etc/containers/oci/hooks.d",
                 "usr/share/containers/oci/hooks.d")
NRI_CONF = "etc/nri/conf.json"
NRI_BIN_DIR = "opt/nri/bin"

_PRESTART = "ig-tpu-prestart.json"
_POSTSTOP = "ig-tpu-poststop.json"
_NRI_PLUGIN = "ig-tpu-nri"

# a hook stalls the runtime's container-create path, so it must give up
# fast when the agent is unresponsive (never the 30s client default)
_HOOK_TIMEOUT = 3.0


@dataclasses.dataclass
class InstallResult:
    mode: str                    # oci | nri | fanotify | none
    installed: list[str]         # files written/updated on the host
    notes: list[str]
    degraded: bool = False       # mode is a fallback from a failed install


def detect_hook_mode(host_root: str = "/") -> str:
    """Runtime detection → hook mode (ref: entrypoint.sh:21-82 HOOK_MODE
    auto-detection): cri-o prefers OCI hook configs, containerd prefers
    NRI, docker/unknown fall back to the in-process fanotify watch."""
    root = Path(host_root)
    if (root / "run/crio/crio.sock").exists():
        return "oci"
    if (root / "run/containerd/containerd.sock").exists():
        return "nri"
    return "fanotify"


def _hook_command(socket: str) -> list[str]:
    """The command a runtime invokes; args[0] is the path per OCI spec."""
    return [sys.executable, "-m", "inspektor_gadget_tpu_torch.agent.main",
            "oci-hook", "--socket", socket]


def _oci_hook_config(stage: str, cmd: list[str]) -> dict:
    # crio hook config schema 1.0.0 (ref: gadget-{prestart,poststop}.json)
    return {
        "version": "1.0.0",
        "hook": {
            "path": cmd[0],
            "args": [os.path.basename(cmd[0])] + cmd[1:] + ["--stage", stage],
        },
        "when": {"always": True},
        "stages": [stage],
    }


class HookInstaller:
    def __init__(self, host_root: str = "/",
                 agent_socket: str = "unix:///tmp/igtpu-agent.sock",
                 hook_cmd: list[str] | None = None):
        self.host_root = Path(host_root)
        self.agent_socket = agent_socket
        # the command the HOST runtime will exec; override when installing
        # from inside a container whose interpreter/package paths don't
        # exist on the host (the reference copies a self-contained binary)
        self.hook_cmd = hook_cmd

    def _cmd(self) -> list[str]:
        return self.hook_cmd or _hook_command(self.agent_socket)

    def _host_path_notes(self) -> list[str]:
        # hook.path is executed by the host runtime, not this container:
        # warn when the interpreter is visibly absent from the host view
        if self.hook_cmd or str(self.host_root) == "/":
            return []
        exe = self._cmd()[0]
        host_exe = self.host_root / exe.lstrip("/")
        if not host_exe.exists():
            return [f"WARNING: hook command {exe} does not exist under "
                    f"{self.host_root} — the host runtime cannot exec it; "
                    "pass hook_cmd with a host-valid command"]
        return []

    # -- install ------------------------------------------------------------

    def install(self, mode: str = "auto") -> InstallResult:
        if mode == "auto":
            mode = detect_hook_mode(str(self.host_root))
        if mode == "oci":
            return self._install_oci()
        if mode == "nri":
            return self._install_nri()
        if mode == "fanotify":
            return InstallResult("fanotify", [], [
                "no host installation needed: the runc fanotify watch "
                "runs in-process (runcfanotify parity)"])
        raise ValueError(f"unknown hook mode {mode!r}")

    def _install_oci(self) -> InstallResult:
        installed, notes = [], self._host_path_notes()
        cmd = self._cmd()
        for rel in OCI_HOOK_DIRS:
            d = self.host_root / rel
            try:
                d.mkdir(parents=True, exist_ok=True)
                for stage, fname in (("prestart", _PRESTART),
                                     ("poststop", _POSTSTOP)):
                    p = d / fname
                    p.write_text(json.dumps(
                        _oci_hook_config(stage, cmd), indent=2))
                    installed.append(str(p))
            except OSError as e:
                notes.append(f"{d}: {e}")
        if not installed:
            notes.append("couldn't install OCI hook configuration")
        return InstallResult("oci", installed, notes)

    def _install_nri(self) -> InstallResult:
        installed, notes = [], self._host_path_notes()
        try:
            # plugin "binary": a shim execing the hook client (ref installs
            # the nrigadget binary into /opt/nri/bin)
            bindir = self.host_root / NRI_BIN_DIR
            bindir.mkdir(parents=True, exist_ok=True)
            shim = bindir / _NRI_PLUGIN
            cmd = " ".join(shlex.quote(c) for c in self._cmd())
            shim.write_text(f"#!/bin/sh\nexec {cmd} --nri \"$@\"\n")
            shim.chmod(shim.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP
                       | stat.S_IXOTH)
            installed.append(str(shim))
            # conf.json: append our plugin if a config exists, else create
            # it (ref: entrypoint.sh:106-119 jq append)
            conf_path = self.host_root / NRI_CONF
            conf_path.parent.mkdir(parents=True, exist_ok=True)
            conf = {"version": "0.1", "plugins": []}
            if conf_path.exists():
                try:
                    conf = json.loads(conf_path.read_text())
                except (OSError, ValueError) as e:
                    notes.append(f"existing {conf_path} unreadable ({e}); "
                                 "overwriting")
                    conf = {"version": "0.1", "plugins": []}
            plugins = conf.setdefault("plugins", [])
            if not any(isinstance(p, dict) and p.get("type") == _NRI_PLUGIN
                       for p in plugins):
                plugins.append({"type": _NRI_PLUGIN})
            conf_path.write_text(json.dumps(conf, indent=2))
            installed.append(str(conf_path))
        except OSError as e:
            # read-only host paths must not abort agent startup: degrade to
            # the in-process fanotify watch (same role, no install needed)
            notes.append(f"NRI install failed ({e}); falling back to the "
                         "in-process fanotify watch")
            return InstallResult("fanotify", installed, notes, degraded=True)
        return InstallResult("nri", installed, notes)

    # -- uninstall ----------------------------------------------------------

    def uninstall(self) -> list[str]:
        """Remove exactly what install() wrote (undeploy parity). Returns
        the removed paths; other plugins' NRI entries are preserved."""
        removed = []
        for rel in OCI_HOOK_DIRS:
            for fname in (_PRESTART, _POSTSTOP):
                p = self.host_root / rel / fname
                if p.exists():
                    p.unlink()
                    removed.append(str(p))
        shim = self.host_root / NRI_BIN_DIR / _NRI_PLUGIN
        if shim.exists():
            shim.unlink()
            removed.append(str(shim))
        conf_path = self.host_root / NRI_CONF
        if conf_path.exists():
            try:
                conf = json.loads(conf_path.read_text())
                plugins = conf.get("plugins", [])
                kept = [p for p in plugins
                        if not (isinstance(p, dict)
                                and p.get("type") == _NRI_PLUGIN)]
                if len(kept) != len(plugins):
                    conf["plugins"] = kept
                    conf_path.write_text(json.dumps(conf, indent=2))
                    removed.append(f"{conf_path} (plugin entry)")
            except (OSError, ValueError):
                pass
        return removed


# -- the hook invocation itself (what the runtime runs) ---------------------

def run_oci_hook(stage: str, socket: str, state_stream,
                 nri: bool = False) -> int:
    """Read the OCI state JSON from the runtime, resolve identity, call
    the agent (ref: hooks/oci/main.go — read state, gRPC AddContainer).
    NRI invocations carry the same state under an event wrapper."""
    from .client import AgentClient

    try:
        payload = json.load(state_stream)
    except ValueError as e:
        print(f"oci-hook: bad state JSON: {e}", file=sys.stderr)
        return 1
    if nri:
        # NRI v0.1 event wrapper; only container lifecycle events concern
        # us — sandbox/synchronize/unknown events must be ignored, not
        # added to the collection as workload containers
        nri_stage = {"StartContainer": "prestart",
                     "StopContainer": "poststop",
                     "RemoveContainer": "poststop"}.get(
                         payload.get("event", ""))
        if nri_stage is None:
            return 0
        stage = nri_stage
    cid = payload.get("id", "")
    pid = int(payload.get("pid", 0) or 0)
    if not cid:
        print("oci-hook: state has no container id", file=sys.stderr)
        return 1
    # A prestart hook that exits nonzero BLOCKS container creation on the
    # host (OCI hooks contract) — if the agent is down, degrade loudly on
    # stderr but let the container start (ref: the hook binaries dial with
    # a short timeout for the same reason).
    try:
        client = AgentClient(socket)
        if stage == "poststop":
            client.remove_container(cid, timeout=_HOOK_TIMEOUT)
            return 0
    except Exception as e:  # noqa: BLE001 — grpc.RpcError and transport
        print(f"oci-hook: agent unreachable ({e}); container proceeds "
              "untracked", file=sys.stderr)
        return 0
    # identity from the bundle's config.json annotations when present
    # (ref: hooks/oci/main.go reads the spec; dialect resolution here)
    name = pod = namespace = ""
    mntns = 0
    bundle = payload.get("bundle", "")
    if bundle:
        try:
            spec = json.loads((Path(bundle) / "config.json").read_text())
            from ..containers.oci_annotations import resolve_identity
            ident = resolve_identity(spec.get("annotations") or {})
            if ident is not None:
                name, pod, namespace = ident.name, ident.pod, ident.namespace
        except (OSError, ValueError):
            pass
    if pid:
        try:
            mntns = os.stat(f"/proc/{pid}/ns/mnt").st_ino
        except OSError:
            pass
    try:
        client.add_container({
            "id": cid, "name": name or cid[:12], "pid": pid, "mntns": mntns,
            "namespace": namespace, "pod": pod,
        }, timeout=_HOOK_TIMEOUT)
    except Exception as e:  # noqa: BLE001
        print(f"oci-hook: agent unreachable ({e}); container proceeds "
              "untracked", file=sys.stderr)
    return 0
