"""ig-tpu-agent daemon + hook client subcommands.

Reference contract: gadget-container/gadgettracermanager/main.go — serve
mode starts the gRPC services on a unix socket (:247-299) with a liveness
probe subcommand (:224-245); the same binary doubles as the hook client
(add/remove-container, used by OCI/NRI hooks — hooks/oci/main.go).

Usage:
  python -m inspektor_gadget_tpu_torch.agent.main serve --listen unix:///run/ig.sock
  python -m inspektor_gadget_tpu_torch.agent.main liveness --target ...
  python -m inspektor_gadget_tpu_torch.agent.main add-container --id c1 --pid 123 ...
  python -m inspektor_gadget_tpu_torch.agent.main dump   # debug state (DumpState)

The port's copy of ``inspektor_gadget_tpu/agent/main.py``, with the
reference's subcommands and flags but for one departure in `serve`:
``--platform auto|tpu|cpu`` is replaced by ``--device {cuda,cpu}``
(default ``cuda``). Before anything touches the card, ``cuda`` runs the
bounded CUDA probe (`utils.platform_probe`, ``--probe-timeout``) and
prints ``device platform: cuda (...)``; a failed or timed-out probe, or
a card torch cannot reach, exits 1 with the detail before anything
listens: there is no degrade to the CPU. ``cpu`` skips the probe. Then,
unless ``--no-doctor``, `serve` prints the doctor's report, as the
reference does.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ig-tpu-agent")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("serve")
    sp.add_argument("--listen", default="unix:///tmp/igtpu-agent.sock")
    sp.add_argument("--node-name", default="node")
    sp.add_argument("--pod-manifest", default="",
                    help="JSON pod manifest to watch with the pod informer")
    sp.add_argument("--kube-api", default="",
                    help="apiserver URL for pod-informer discovery")
    sp.add_argument("--informer-interval", type=float, default=2.0)
    sp.add_argument("--checkpoint-dir", default="",
                    help="persist live sketch state here each interval; "
                         "resumed (merged) after restart")
    sp.add_argument("--checkpoint-interval", type=float, default=30.0)
    sp.add_argument("--capture-dir", default="",
                    help="base directory for capture recordings "
                         "(StartRecording RPC / ig-tpu record start); "
                         "default $IG_CAPTURE_DIR or ~/.ig-tpu/capture")
    sp.add_argument("--history-dir", default="",
                    help="base directory for the sealed-window sketch "
                         "history (tpusketch --history true; served via "
                         "ListWindows/FetchWindows); default "
                         "$IG_HISTORY_DIR or ~/.ig-tpu/history")
    sp.add_argument("--history-compact", action="store_true",
                    help="run the tiered-history compaction engine in "
                         "the background: aged sealed windows merge into "
                         "coarser super-windows per --history-schedule")
    # the default resolves at serve time: the history package imports
    # torch, and the hook client and liveness probe must start fast
    sp.add_argument("--history-schedule", default="",
                    help="resolution schedule res@horizon[,...]; the "
                         "last horizon must be inf (validated at startup; "
                         "default: the history plane's DEFAULT_SCHEDULE)")
    sp.add_argument("--history-compact-interval", type=float, default=60.0,
                    help="seconds between background compaction passes")
    sp.add_argument("--history-archive-dir", default="",
                    help="offload fully-compacted cold history segments "
                         "to this archive root (manifest-driven "
                         "rehydration serves queries over them)")
    sp.add_argument("--history-archive-cache-bytes", type=int,
                    default=64 << 20,
                    help="rehydration cache budget (LRU by bytes)")
    sp.add_argument("--metrics-addr", default="",
                    help="serve Prometheus text metrics on host:port "
                         "(e.g. :9100); off by default")
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of every run's operator state (no "
                         "fallback: cuda without a card exits 1)")
    sp.add_argument("--probe-timeout", type=float, default=None,
                    help="seconds to wait for the CUDA probe "
                         "(default $IG_PLATFORM_PROBE_TIMEOUT or 20); a "
                         "timeout exits 1")
    sp.add_argument("--flight-record-path", default="",
                    help="dump the flight recorder (recent spans/logs/"
                         "errors) here on SIGTERM/crash; default "
                         "/tmp/igtpu-flight-<node>.json, 'off' disables")
    sp.add_argument("--watch-traces", action="store_true",
                    help="reconcile Trace resources off the kube API "
                         "(requires --kube-api; controller role of "
                         "gadget-container main.go:262-299)")
    sp.add_argument("--trace-namespace", default="ig-tpu")
    sp.add_argument("--no-doctor", action="store_true",
                    help="skip the capture-window probe at startup")
    sp.add_argument("--install-hooks", action="store_true",
                    help="install runtime hooks on the host before "
                         "serving, remove them on shutdown "
                         "(entrypoint.sh:83-142 parity)")
    sp.add_argument("--host-root", default="/",
                    help="host filesystem mount point for hook installs")
    sp.add_argument("--hook-mode", default="auto",
                    choices=("auto", "oci", "nri", "fanotify"))

    for name in ("liveness", "dump"):
        p = sub.add_parser(name)
        p.add_argument("--target", default="unix:///tmp/igtpu-agent.sock")

    acp = sub.add_parser("add-container")
    acp.add_argument("--target", default="unix:///tmp/igtpu-agent.sock")
    for f in ("id", "name", "namespace", "pod"):
        acp.add_argument(f"--{f}", default="")
    acp.add_argument("--pid", type=int, default=0)
    acp.add_argument("--mntns", type=int, default=0)

    rcp = sub.add_parser("remove-container")
    rcp.add_argument("--target", default="unix:///tmp/igtpu-agent.sock")
    rcp.add_argument("--id", required=True)

    # hook installation on the host (ref: entrypoint.sh:83-142) and the
    # hook invocation itself (ref: hooks/oci/main.go)
    ihp = sub.add_parser("install-hooks")
    ihp.add_argument("--host-root", default="/")
    ihp.add_argument("--mode", default="auto",
                     choices=("auto", "oci", "nri", "fanotify"))
    ihp.add_argument("--socket", default="unix:///tmp/igtpu-agent.sock")

    uhp = sub.add_parser("uninstall-hooks")
    uhp.add_argument("--host-root", default="/")

    ohp = sub.add_parser("oci-hook")
    ohp.add_argument("--socket", default="unix:///tmp/igtpu-agent.sock")
    ohp.add_argument("--stage", default="prestart",
                     choices=("prestart", "poststop"))
    ohp.add_argument("--nri", action="store_true",
                     help="payload is an NRI event wrapper, not OCI state")

    args = ap.parse_args(argv)

    if args.cmd == "install-hooks":
        from .hooks import HookInstaller
        res = HookInstaller(args.host_root, args.socket).install(args.mode)
        print(f"hook mode: {res.mode}")
        for p in res.installed:
            print(f"installed {p}")
        for n in res.notes:
            print(n)
        if res.mode == "fanotify":
            # nothing installable: the watch runs inside the serving agent
            # — only a success if that's what was asked for/detected, not
            # a silent degrade from a failed NRI install
            print("note: fanotify discovery runs in the serving agent "
                  "process (serve wires it), no host files needed")
            return 1 if res.degraded else 0
        return 0 if res.installed else 1
    if args.cmd == "uninstall-hooks":
        from .hooks import HookInstaller
        for p in HookInstaller(args.host_root).uninstall():
            print(f"removed {p}")
        return 0
    if args.cmd == "oci-hook":
        from .hooks import run_oci_hook
        return run_oci_hook(args.stage, args.socket, sys.stdin,
                            nri=args.nri)

    if args.cmd == "serve":
        if args.watch_traces and not args.kube_api:
            ap.error("--watch-traces requires --kube-api")
        # bounded device acquisition BEFORE the first CUDA use: a wedged
        # libcuda or a missing card stops the agent with the probe's
        # detail, never a silent CPU agent
        from ..utils.platform_probe import (DEFAULT_PROBE_TIMEOUT, PlatformError,
                                            acquire_platform)
        try:
            acq = acquire_platform(args.device, timeout=(
                args.probe_timeout if args.probe_timeout is not None
                else DEFAULT_PROBE_TIMEOUT))
        except PlatformError as e:
            print(f"error: device probe failed: {e}", file=sys.stderr)
            return 1
        print(f"device platform: {acq['platform']} ({acq['detail']}; probe "
              f"{acq['elapsed']:.2f}s)", flush=True)
        from ..device import resolve_device
        try:
            dev = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(f"device: {dev}", flush=True)
        # entrypoint-analogue environment probe (ref: entrypoint.sh:21-120
        # detects OS/kernel/runtime before starting the daemon): report
        # which capture windows work on this host so degraded gadgets are
        # known up front, not discovered mid-run
        if not args.no_doctor:
            from ..doctor import render_report
            print(render_report(), flush=True)
        return _serve_loop(args)

    from .client import AgentClient
    client = AgentClient(args.target)
    if args.cmd == "liveness":
        try:
            client.get_catalog(use_cache_on_error=False)
            print("ok")
            return 0
        except Exception as e:
            print(f"unhealthy: {e}", file=sys.stderr)
            return 1
    if args.cmd == "dump":
        import json
        print(json.dumps(client.dump_state(), indent=2))
        return 0
    if args.cmd == "add-container":
        print(client.add_container({
            "id": args.id, "name": args.name, "pid": args.pid,
            "mntns": args.mntns, "namespace": args.namespace, "pod": args.pod,
        }))
        return 0
    if args.cmd == "remove-container":
        print(client.remove_container(args.id))
        return 0
    return 2


def _serve_loop(args) -> int:
    from ..telemetry.tracing import RECORDER, install_crash_handlers
    from .service import serve
    # crash-safe black box: unhandled exceptions (any thread) dump the
    # flight recorder, and the SIGTERM/SIGINT path below dumps it too —
    # a wedged or killed agent leaves evidence of what it was doing
    flight_path = args.flight_record_path or \
        f"/tmp/igtpu-flight-{args.node_name}.json"
    if flight_path != "off":
        install_crash_handlers(flight_path, signals=())
    if args.capture_dir:
        from ..capture import RECORDINGS
        RECORDINGS.set_base_dir(args.capture_dir)
    if args.history_dir:
        from ..history import HISTORY
        HISTORY.set_base_dir(args.history_dir)
    if args.history_archive_dir:
        from ..history import HISTORY
        HISTORY.set_archive(args.history_archive_dir,
                            args.history_archive_cache_bytes)
    compactor = None
    if args.history_compact:
        # schedule validated LOUDLY before the agent serves: a bad
        # retention policy must fail startup, not eat history later
        from ..history import DEFAULT_SCHEDULE, CompactionEngine
        compactor = CompactionEngine(args.history_schedule or DEFAULT_SCHEDULE)
        compactor.start_background(args.history_compact_interval)
    # bind BEFORE installing hooks: a prestart config pointing at a socket
    # nobody serves stalls every container creation on the host
    try:
        server, _agent = serve(args.listen, node_name=args.node_name,
                               checkpoint_dir=args.checkpoint_dir,
                               checkpoint_interval=args.checkpoint_interval,
                               metrics_addr=args.metrics_addr,
                               device=args.device)
    except (RuntimeError, OSError, ValueError) as e:
        if compactor is not None:
            compactor.stop()
        print(f"error: {e}", file=sys.stderr)
        return 1
    if _agent.metrics_server is not None:
        print(f"metrics on http://{_agent.metrics_server.host}:"
              f"{_agent.metrics_server.port}/metrics", flush=True)
    installer = None
    watcher = None
    try:
        if args.watch_traces and args.kube_api:
            from ..gadgets.trace_resource import TraceWatcher
            from ..utils.k8s import KubeClient
            watcher = TraceWatcher(
                KubeClient(server=args.kube_api), _agent.traces,
                namespace=args.trace_namespace,
                interval=args.informer_interval)
            watcher.start()
        if args.install_hooks:
            from .hooks import HookInstaller
            installer = HookInstaller(args.host_root, args.listen)
            res = installer.install(args.hook_mode)
            print(f"hook mode: {res.mode} "
                  f"({len(res.installed)} files installed)", flush=True)
            if res.mode == "fanotify":
                # nothing on the host invokes us: run the in-process runc
                # fanotify watch so container tracking still works (ref:
                # entrypoint.sh fanotify hook mode → the daemon's own
                # watch, runcfanotify.go)
                from ..containers import with_fanotify_discovery
                from ..operators.operators import ensure_initialized
                with_fanotify_discovery()(
                    ensure_initialized("localmanager").cc)
        if args.kube_api:
            # IP→pod/service enrichment off the same apiserver
            # (ref: kubeipresolver.go:62-156 inventory cache)
            from ..operators.operators import get as get_operator
            from ..utils.k8s import KubeClient
            get_operator("kubeipresolver").use_kube_client(
                KubeClient(server=args.kube_api))
        if args.pod_manifest or args.kube_api:
            # pod-informer discovery feeding the localmanager collection
            # (ref: WithPodInformer wired in main.go's serve path)
            from ..containers import (
                file_pod_source, kube_api_pod_source, with_pod_informer,
            )
            from ..operators.operators import ensure_initialized
            lm = ensure_initialized("localmanager")
            src = (file_pod_source(args.pod_manifest) if args.pod_manifest
                   else kube_api_pod_source(args.kube_api,
                                            node_name=args.node_name))
            with_pod_informer(src, node_name=args.node_name,
                              interval=args.informer_interval)(lm.cc)
        print(f"ig-tpu-agent listening on {args.listen}"
              + ("" if args.listen.startswith("unix:")
                 else f" (port {_agent.port})"), flush=True)
        stop = [False]

        def on_sig(signum, *_):
            if flight_path != "off":
                RECORDER.record_error("signal",
                                      f"agent stopping on signal {signum}")
                RECORDER.dump(flight_path)
            stop[0] = True
        signal.signal(signal.SIGTERM, on_sig)
        signal.signal(signal.SIGINT, on_sig)
        while not stop[0]:
            time.sleep(0.2)
    finally:
        # uninstall while still serving, then stop: containers created in
        # the grace window must not invoke hooks against a dead socket —
        # and stop unconditionally, else a failed informer/install leaves
        # non-daemon gRPC workers keeping a dead agent alive
        if watcher is not None:
            watcher.stop()
        if _agent.metrics_server is not None:
            _agent.metrics_server.stop()
        _agent.stop_checkpointer()
        # seal any armed recordings: a clean SIGTERM must not leave
        # unsealed journals for the torn-tail reader to account
        from ..capture import RECORDINGS
        RECORDINGS.stop_all()
        # same for history stores: close seals active window segments
        if compactor is not None:
            compactor.stop()
        from ..history import HISTORY
        HISTORY.close_all()
        if installer is not None:
            installer.uninstall()
        server.stop(grace=2.0).wait(5.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
