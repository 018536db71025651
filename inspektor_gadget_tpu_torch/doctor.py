"""Environment doctor — the entrypoint's capability-probe role (PyTorch
port of ``inspektor_gadget_tpu/doctor.py``).

Reference contract: gadget-container/entrypoint.sh:21-120 detects the OS,
kernel, container runtime and BPF mount state before starting the daemon,
and picks the hook installation mechanism accordingly. This build has seven
heterogeneous capture windows instead of one BPF substrate, so the doctor
probes each window (fanotify, perf_event_open, /dev/kmsg, ptrace,
sock_diag, netlink proc-connector, AF_PACKET, mountinfo, procfs) and maps
every registered gadget to real / degraded / unavailable — run at agent
start (agent/main.py) and on demand via `ig-tpu-torch doctor`.

Probes are cheap, side-effect-free, and never raise: each returns
(ok, detail) so a broken window degrades the report, not the process.

The port's probes read the port's own modules and registry. Three rows
differ from the reference's:

- ``native_lib`` builds the port's capture library at its first use (g++
  into ``build/native/``) and reports why a build or load failed.
- ``native_toolchain`` names both compilers the port's native code
  needs: g++ for the capture library (and whether it takes
  ``-fsanitize=thread``, which the stress harnesses' TSAN build needs),
  and nvcc with ``sm_90a`` for the CUDA kernels in ``csrc/``.
- ``device_topology`` reads ``torch.cuda`` only when this process has
  already initialised it; otherwise it says "unprobed", as the
  reference does for a JAX backend nobody brought up.

The report's PLATFORM line is `utils.platform_probe.last_acquire()`: the
bounded CUDA probe's outcome, a failure included (the port raises where
the reference degrades to the CPU).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket

from .telemetry import gauge

# probed platform facts as registry gauges: scrapes and embedded snapshots
# (bench.py, cmd_doctor --output json) carry degraded/unavailable windows
# as data, not hand-assembled prose
_tm_window_ok = gauge("ig_doctor_window_ok",
                      "capture window probe result (1 ok, 0 down)",
                      ("window",))
_tm_gadget_status = gauge("ig_doctor_gadgets",
                          "registered gadgets per doctor status",
                          ("status",))


@dataclasses.dataclass
class Window:
    name: str
    ok: bool
    detail: str


# ---------------------------------------------------------------------------
# Window probes
# ---------------------------------------------------------------------------

def _probe_native_lib() -> Window:
    try:
        from .sources import bridge
        if bridge.native_available():
            return Window("native_lib", True, f"{bridge.LIBRARY.path.name} loaded")
        return Window("native_lib", False, (bridge._unavailable or "build failed")
                      .splitlines()[0])
    except Exception as e:  # noqa: BLE001
        return Window("native_lib", False, repr(e))


def _native_ok() -> bool:
    from .sources.bridge import native_available
    return native_available()


def _probe_native_toolchain() -> Window:
    """Build-plane row: can this host compile the port's native code?
    g++ builds the capture library (`native.HostLibrary`) and the stress
    harnesses, under TSAN where it takes ``-fsanitize=thread``; nvcc with
    ``sm_90a`` builds the CUDA kernels (`native.CudaLibrary`). The native
    tests key off the same facts (`native.tsan_supported`,
    `native.nvcc_path`), so a skipped tier shows here too."""
    try:
        from . import native
        cxx = native.cxx_path()
        built = ("lib built" if any(native.HOST_BUILD_DIR.glob("libigcapture-*.so"))
                 else "lib not built yet")
        if cxx:
            tsan = "tsan ok" if native.tsan_supported(cxx) else "no -fsanitize=thread"
            host = f"{os.path.basename(cxx)} present ({built}; {tsan})"
        else:
            host = f"missing {os.environ.get('CXX') or 'g++'} (capture library: {built})"
        nvcc = native.nvcc_path()
        sm90a = bool(nvcc) and native.nvcc_has_sm90a(nvcc)
        if sm90a:
            dev = "nvcc present with sm_90a (csrc/ kernels)"
        elif nvcc:
            dev = "nvcc present, no sm_90a build — csrc/ kernels cannot build"
        else:
            dev = "missing nvcc — csrc/ kernels cannot build"
        return Window("native_toolchain", bool(cxx) and sm90a, f"{host}; {dev}")
    except Exception as e:  # noqa: BLE001
        return Window("native_toolchain", False, repr(e))


def _probe_fanotify() -> Window:
    try:
        from .sources.bridge import fanotify_supported
        if not _native_ok():
            return Window("fanotify", False, "native lib unavailable")
        ok = fanotify_supported()
        return Window("fanotify", ok,
                      "fanotify_init ok" if ok else
                      "fanotify_init failed (needs CAP_SYS_ADMIN)")
    except Exception as e:  # noqa: BLE001
        return Window("fanotify", False, repr(e))


def _probe_perf() -> Window:
    try:
        from .sources.bridge import perf_supported
        if not _native_ok():
            return Window("perf", False, "native lib unavailable")
        ok = perf_supported()
        if ok:
            return Window("perf", True, "perf_event_open ok")
        para = "?"
        try:
            para = open("/proc/sys/kernel/perf_event_paranoid").read().strip()
        except OSError:
            pass
        return Window("perf", False,
                      f"perf_event_open failed (perf_event_paranoid={para})")
    except Exception as e:  # noqa: BLE001
        return Window("perf", False, repr(e))


def _probe_kmsg() -> Window:
    try:
        fd = os.open("/dev/kmsg", os.O_RDONLY | os.O_NONBLOCK)
        try:
            try:
                os.read(fd, 8192)
            except BlockingIOError:
                pass  # readable, just no backlog
        finally:
            os.close(fd)
        return Window("kmsg", True, "/dev/kmsg readable")
    except OSError as e:
        return Window("kmsg", False, f"/dev/kmsg: {e.strerror}")


def _probe_ptrace() -> Window:
    scope = "?"
    try:
        scope = open("/proc/sys/kernel/yama/ptrace_scope").read().strip()
    except OSError:
        scope = "absent"
    if os.geteuid() == 0 and scope != "3":
        return Window("ptrace", True, f"root, yama scope {scope}")
    if scope == "0":
        return Window("ptrace", True, f"yama scope 0 (same-uid attach)")
    return Window("ptrace", False,
                  f"euid {os.geteuid()}, yama scope {scope}")


def _probe_sock_diag() -> Window:
    NETLINK_SOCK_DIAG = 4
    try:
        s = socket.socket(socket.AF_NETLINK, socket.SOCK_RAW, NETLINK_SOCK_DIAG)
        s.close()
        return Window("sock_diag", True, "NETLINK_SOCK_DIAG socket ok")
    except OSError as e:
        return Window("sock_diag", False, f"netlink: {e.strerror}")


def _probe_netlink_proc() -> Window:
    # proc connector needs CAP_NET_ADMIN to bind the CN_IDX_PROC group
    NETLINK_CONNECTOR = 11
    CN_IDX_PROC = 1
    try:
        s = socket.socket(socket.AF_NETLINK, socket.SOCK_DGRAM,
                          NETLINK_CONNECTOR)
        try:
            # nl_pid 0: kernel auto-assigns a free port — binding the
            # literal pid collides (EADDRINUSE) when this process already
            # holds a proc-connector socket (agent with a live exec source)
            s.bind((0, CN_IDX_PROC))
        finally:
            s.close()
        return Window("netlink_proc", True, "proc connector bind ok")
    except OSError as e:
        return Window("netlink_proc", False, f"proc connector: {e.strerror}")


def _probe_af_packet() -> Window:
    try:
        s = socket.socket(socket.AF_PACKET, socket.SOCK_RAW, 0)
        s.close()
        return Window("af_packet", True, "raw packet socket ok")
    except OSError as e:
        return Window("af_packet", False,
                      f"AF_PACKET: {e.strerror} (needs CAP_NET_RAW)")


def _probe_audit() -> Window:
    # host-wide audit window: NETLINK_AUDIT + READLOG multicast
    # (CAP_AUDIT_READ; kernel >= 3.16)
    try:
        from .sources.bridge import audit_supported
        ok = _native_ok() and audit_supported()
        return Window("audit", ok,
                      "NETLINK_AUDIT readlog multicast ok" if ok else
                      "audit readlog unavailable (needs CAP_AUDIT_READ)")
    except Exception as e:  # noqa: BLE001
        return Window("audit", False, repr(e))


def _probe_captrace() -> Window:
    # cap_capable tracepoint (tracefs, kernel >= 6.7) — capable.bpf.c's
    # exact hook point, no BPF
    try:
        from .sources.bridge import captrace_supported
        ok = _native_ok() and captrace_supported()
        return Window("captrace", ok,
                      "cap_capable tracepoint ok" if ok else
                      "cap_capable tracepoint unavailable "
                      "(tracefs or kernel < 6.7)")
    except Exception as e:  # noqa: BLE001
        return Window("captrace", False, repr(e))


def _probe_sockstate() -> Window:
    # inet_sock_set_state tracepoint — event-driven trace/tcp
    try:
        from .sources.bridge import sockstate_supported
        ok = _native_ok() and sockstate_supported()
        return Window("sockstate", ok,
                      "inet_sock_set_state tracepoint ok" if ok else
                      "inet_sock_set_state unavailable (tracefs)")
    except Exception as e:  # noqa: BLE001
        return Window("sockstate", False, repr(e))


def _probe_sigtrace() -> Window:
    # signal_generate tracepoint — full sigsnoop parity
    try:
        from .sources.bridge import sigtrace_supported
        ok = _native_ok() and sigtrace_supported()
        return Window("sigtrace", ok,
                      "signal_generate tracepoint ok" if ok else
                      "signal_generate unavailable (tracefs)")
    except Exception as e:  # noqa: BLE001
        return Window("sigtrace", False, repr(e))


def _probe_fstrace() -> Window:
    # raw_syscalls tracepoints with in-kernel id filter (host-wide fsslower)
    try:
        from .sources.bridge import fstrace_supported
        ok = _native_ok() and fstrace_supported()
        return Window("fstrace", ok,
                      "raw_syscalls tracepoints ok" if ok else
                      "raw_syscalls tracepoints unavailable (tracefs)")
    except Exception as e:  # noqa: BLE001
        return Window("fstrace", False, repr(e))


def _probe_tcpinfo() -> Window:
    # top/tcp byte counters: sock_diag ext INET_DIAG_INFO (kernel >= 4.1)
    try:
        from .sources.bridge import tcpinfo_supported
        ok = _native_ok() and tcpinfo_supported()
        return Window("tcpinfo", ok,
                      "sock_diag INET_DIAG_INFO byte counters ok" if ok else
                      "INET_DIAG_INFO dump failed (kernel < 4.1?)")
    except Exception as e:  # noqa: BLE001
        return Window("tcpinfo", False, repr(e))


def _probe_blktrace() -> Window:
    try:
        from .sources.bridge import blktrace_supported
        ok = _native_ok() and blktrace_supported()
        return Window("blktrace", ok,
                      "tracefs block events readable" if ok else
                      "tracefs block events unavailable (mount tracefs)")
    except Exception as e:  # noqa: BLE001
        return Window("blktrace", False, repr(e))


def _probe_container_runtime() -> Window:
    """Runtime-availability row: can the container discovery/enrichment
    chain reach a real runtime (docker / containerd / CRI)? The real-
    runtime integration tier (tests/test_real_runtime.py) keys off the
    same sockets this probe checks."""
    try:
        from .containers.runtime_client import detect_runtime_client
        client = detect_runtime_client()
        if client is None:
            return Window("container_runtime", False,
                          "no runtime reachable (docker/containerd/CRI "
                          "sockets absent)")
        name = type(client).__name__.removesuffix("Client").lower()
        closer = getattr(client, "close", None)
        if closer is not None:
            closer()
        return Window("container_runtime", True, f"{name} reachable")
    except Exception as e:  # noqa: BLE001
        return Window("container_runtime", False, repr(e))


def _probe_capture_dir() -> Window:
    """Capture-plane row: is the recording area writable, and how much
    does it already hold? A node that cannot journal loses its replay
    evidence exactly when an incident makes it wanted."""
    try:
        import tempfile

        from .capture import capture_base_dir
        from .capture.journal import dir_stats
        base = capture_base_dir()
        os.makedirs(base, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=base, prefix=".doctor-"):
            pass
        segments, usage = dir_stats(base)
        try:
            st = os.statvfs(base)
            free = st.f_bavail * st.f_frsize
            free_s = f", {free / (1 << 30):.1f} GiB free"
        except OSError:
            free_s = ""
        return Window("capture_dir", True,
                      f"{base} writable ({usage / (1 << 20):.1f} MiB in "
                      f"{segments} segment(s){free_s})")
    except OSError as e:
        return Window("capture_dir", False,
                      f"capture dir unwritable: {e.strerror or e}")
    except Exception as e:  # noqa: BLE001
        return Window("capture_dir", False, repr(e))


def _probe_history_dir() -> Window:
    """History-plane row: is the sealed-window store area writable, and
    how much does it already hold? A node that cannot seal windows
    answers live queries only — the 2pm incident stays unanswerable at
    3pm, which is exactly what the history plane exists to fix."""
    try:
        import tempfile

        from .capture.journal import dir_stats
        from .history import history_base_dir
        base = history_base_dir()
        os.makedirs(base, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=base, prefix=".doctor-"):
            pass
        segments, usage = dir_stats(base)
        try:
            st = os.statvfs(base)
            free = st.f_bavail * st.f_frsize
            free_s = f", {free / (1 << 30):.1f} GiB free"
        except OSError:
            free_s = ""
        return Window("history_dir", True,
                      f"{base} writable ({usage / (1 << 20):.1f} MiB in "
                      f"{segments} segment(s){free_s})")
    except OSError as e:
        return Window("history_dir", False,
                      f"history dir unwritable: {e.strerror or e}")
    except Exception as e:  # noqa: BLE001
        return Window("history_dir", False, repr(e))


def _probe_history_tiers() -> Window:
    """Tier-plane row: how the node's history footprint is distributed
    across compaction levels and the archive tier. An empty store is
    fine (nothing sealed yet); the row fails only when the tier walk
    itself breaks — a store you cannot account is a retention policy
    you cannot trust."""
    try:
        from .history import HISTORY
        tiers = HISTORY.tier_stats()
        levels = tiers.get("levels") or {}
        if not tiers.get("stores"):
            return Window("history_tiers", True,
                          "no history stores yet (nothing sealed)")
        lvl_s = ", ".join(
            f"L{lvl}: {row['windows']}w/{row['bytes'] / (1 << 20):.1f}MiB"
            for lvl, row in levels.items()) or "no windows"
        arch = tiers.get("archived") or {}
        detail = (f"{tiers['stores']} store(s), {lvl_s}")
        if arch.get("segments"):
            cache = tiers.get("archive_cache") or {}
            detail += (f"; archived {arch['segments']} segment(s)/"
                       f"{arch['bytes'] / (1 << 20):.1f}MiB "
                       f"(cache {cache.get('hits', 0)}h/"
                       f"{cache.get('misses', 0)}m)")
        return Window("history_tiers", True, detail)
    except Exception as e:  # noqa: BLE001
        return Window("history_tiers", False, repr(e))


def _probe_standing_queries() -> Window:
    """Standing-query-plane row: which continuous queries are live in
    this process, how fresh their materialized answers are, and whether
    the result cache is earning its bytes. No registered queries is
    fine (the plane is opt-in); the row fails only when reading the
    live registry itself breaks."""
    try:
        from .queries import live_stats
        rows = live_stats()
        if not rows:
            return Window("standing_queries", True,
                          "no standing queries registered (opt-in via "
                          "the 'standing-queries' param)")
        cache = rows[0].get("cache") or {}
        per_q = ", ".join(
            f"{r['id']}: {r['windows']}w/{r['range_s']:g}s "
            f"({r['refreshed']} refreshes)"
            for r in rows)
        detail = (f"{len(rows)} quer{'y' if len(rows) == 1 else 'ies'} — "
                  f"{per_q}; cache {cache.get('hits', 0)}h/"
                  f"{cache.get('misses', 0)}m/"
                  f"{cache.get('invalidations', 0)}i, "
                  f"{cache.get('bytes', 0) / (1 << 10):.1f}KiB")
        return Window("standing_queries", True, detail)
    except Exception as e:  # noqa: BLE001
        return Window("standing_queries", False, repr(e))


def _probe_each_agent(probe_one):
    """The shared skeleton of the fleet-facing doctor rows: probe every
    locally-registered agent concurrently under a bounded deadline (the
    row costs one deadline, not one per agent) with per-node isolation.
    Returns (targets, [(node, result, error)])."""
    from .cli.deploy import local_targets
    targets = local_targets()
    if not targets:
        return targets, []
    from concurrent.futures import ThreadPoolExecutor

    from .agent.client import AgentClient

    def probe(item):
        node, target = item
        client = None
        try:
            client = AgentClient(target, node, rpc_deadline=2.0)
            return node, probe_one(client), None
        except Exception as e:  # noqa: BLE001 — per-node isolation
            return node, None, str(e)
        finally:
            if client is not None:
                client.close()

    with ThreadPoolExecutor(max_workers=min(len(targets), 16)) as ex:
        return targets, list(ex.map(probe, targets.items()))


def _probe_fleet_health() -> Window:
    """Fleet-plane row: are the locally-registered agents (deploy
    --local) reachable under a bounded deadline? No local fleet is fine
    — single-node mode — but a registered agent that doesn't answer is
    exactly the kind of silent rot the chaos runtime exists to surface
    (`ig-tpu-torch fleet health` gives the per-run detail)."""
    try:
        targets, probed = _probe_each_agent(
            lambda c: c.get_catalog(use_cache_on_error=False))
        if not targets:
            return Window("fleet_health", True,
                          "no local fleet registered (single-node mode)")
        down = sorted(n for n, _res, err in probed if err)
        if down:
            return Window("fleet_health", False,
                          f"{len(down)}/{len(targets)} agent(s) "
                          f"unreachable: {', '.join(down)} "
                          f"(expected during fleet bring-up)")
        return Window("fleet_health", True,
                      f"{len(targets)} local agent(s) reachable")
    except Exception as e:  # noqa: BLE001
        return Window("fleet_health", False, repr(e))


def _probe_shared_runs() -> Window:
    """Shared-run plane row: how many shared gadget runs and live
    subscribers the local fleet is serving, and whether any subscriber
    is being shed (drops/evictions). No fleet (or no shared runs) is
    fine; an unreadable agent fails the row — an overloaded node you
    cannot see is the outage in waiting (`ig-tpu-torch fleet runs` gives the
    per-run detail)."""
    try:
        targets, probed = _probe_each_agent(lambda c: c.shared_runs())
        if not targets:
            return Window("shared_runs", True,
                          "no local fleet registered (single-node mode)")
        down = sorted(n for n, _res, err in probed if err)
        if down:
            return Window("shared_runs", False,
                          f"{len(down)}/{len(targets)} agent(s) "
                          f"unreadable: {', '.join(down)}")
        runs = [r for _n, rows, _e in probed for r in rows or []]
        subs = sum(r.get("live_subscribers", 0) for r in runs)
        drops = sum(s.get("drops", 0) for r in runs
                    for s in (r.get("subscribers") or []))
        evicted = sum(1 for r in runs
                      for s in (r.get("subscribers") or [])
                      if s.get("evicted"))
        detail = (f"{len(runs)} shared run(s), {subs} live "
                  f"subscriber(s) across {len(targets)} agent(s)")
        if drops or evicted:
            detail += (f"; shedding: {drops} drop(s), {evicted} "
                       f"eviction(s) — see `ig-tpu-torch fleet runs`")
        return Window("shared_runs", True, detail)
    except Exception as e:  # noqa: BLE001
        return Window("shared_runs", False, repr(e))


def _probe_device_topology() -> Window:
    """Device-plane topology row: how many local cards the sharded ingest
    plane can lane across, the (node) mesh it would build, and whether
    ``shard-ingest`` is eligible (>= 2 devices). Counting cards
    initialises CUDA, so this row only reads a context some other plane
    already paid for (``torch.cuda.is_initialized()``): the doctor must
    never be the thing that hangs on device acquisition, which is the
    platform probe's bounded job."""
    try:
        import sys
        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return Window("device_topology", True,
                          "torch.cuda not initialized in this process — "
                          "topology unprobed (run a gadget or an agent "
                          "with --device cuda first)")
        n = torch.cuda.device_count()
        cards = []
        for i in range(n):
            p = torch.cuda.get_device_properties(i)
            cards.append(f"{p.name} (cc {p.major}.{p.minor}, "
                         f"{p.total_memory / (1 << 30):.1f} GiB)")
        eligible = ("shard-ingest eligible" if n >= 2
                    else "shard-ingest needs >= 2 devices")
        return Window("device_topology", True,
                      f"{n} local cuda device(s), ingest mesh (node={n}); "
                      f"{eligible}" + (f"; {', '.join(cards)}" if cards else ""))
    except Exception as e:  # noqa: BLE001
        return Window("device_topology", False, repr(e))


def _probe_pipeline_health() -> Window:
    """Pipeline-health-plane row: which gadget runs in this
    process carry live per-stage lag accounting, their worst-stage lag
    watermark, and the starved ratio (1.0 = host-bound; 0.0 =
    device-bound). No live runs is fine — the plane rides
    every tpusketch run automatically, so an idle process simply has
    nothing to report; the row fails only when reading the registry
    breaks (`ig-tpu-torch fleet lag` gives the per-node detail)."""
    try:
        from .telemetry.pipeline import live_stats
        rows = live_stats()
        if not rows:
            return Window("pipeline_health", True,
                          "no live instrumented runs (the plane rides "
                          "every tpusketch run)")
        per_run = []
        for ps in rows:
            snap = ps.snapshot()
            worst = max((r["watermark_s"]
                         for r in snap["stages"].values()), default=0.0)
            per_run.append(
                f"{ps.run_id[:8]}: lag {worst * 1e3:.1f}ms, "
                f"starved {snap['starved_ratio'] * 100:.0f}%")
        return Window("pipeline_health", True,
                      f"{len(rows)} instrumented run(s) — "
                      + ", ".join(per_run))
    except Exception as e:  # noqa: BLE001
        return Window("pipeline_health", False, repr(e))


def _probe_accuracy() -> Window:
    """Accuracy-audit-plane row: which gadget runs in this
    process carry a live shadow-sample audit, their sample fill, and the
    worst observed-error/analytic-bound ratio (> 1.0 means an estimate
    drifted past its envelope — the accuracy_drift alert's trigger).
    No audited runs is fine — the plane is opt-in (audit-sample > 0);
    analytic bounds still ride every answer. The row fails only when
    reading the registry breaks (`ig-tpu-torch fleet accuracy` has detail)."""
    try:
        from .ops.accuracy import live_stats
        rows = live_stats()
        if not rows:
            return Window("accuracy", True,
                          "no audited runs (audit plane is opt-in: "
                          "audit-sample > 0; analytic bounds always ride "
                          "answers)")
        per_run = []
        for a in rows:
            snap = a.snapshot()
            per_run.append(
                f"{a.run_id[:8]}: sample {snap['sample_size']}, "
                f"fed {snap['samples_fed']}, ratio {snap['ratio']:.2f}")
        return Window("accuracy", True,
                      f"{len(rows)} audited run(s) — " + ", ".join(per_run))
    except Exception as e:  # noqa: BLE001
        return Window("accuracy", False, repr(e))


def _probe_fleet_topology() -> Window:
    """Fleet-aggregation-tier row: can this process build a
    merge tree over the deployed fleet, and what shape would it fold
    through — leaves, depth, fan-in, and the wire frames one merged
    query costs vs the flat fold. No deployed fleet is fine (the tier
    is a query-time choice); the row fails only when the deploy state
    names agents that auto_topology refuses (the loud TopologyError
    an `ig-tpu-torch query --topology` would hit)."""
    try:
        from .cli.deploy import local_targets
        from .fleet import auto_topology
        targets = local_targets()
        if not targets:
            return Window("fleet_topology", True,
                          "no deployed fleet (topology is a query-time "
                          "choice: ig-tpu-torch query --topology auto)")
        topo = auto_topology(list(targets))
        return Window(
            "fleet_topology", True,
            f"{len(topo.leaves())} agent(s) → depth {topo.depth()}, "
            f"fan-in {topo.fan_in()}, {len(topo.aggregators())} "
            f"aggregator(s); {topo.edges() + 1} window frame(s)/query "
            f"vs {len(topo.leaves())} flat")
    except Exception as e:  # noqa: BLE001
        return Window("fleet_topology", False, repr(e))


def _probe_mountinfo() -> Window:
    try:
        with open("/proc/self/mountinfo") as f:
            f.readline()
        return Window("mountinfo", True, "/proc/self/mountinfo readable")
    except OSError as e:
        return Window("mountinfo", False, f"mountinfo: {e.strerror}")


def _probe_procfs() -> Window:
    try:
        os.listdir("/proc")
        with open("/proc/self/stat"):
            pass
        return Window("procfs", True, "/proc readable")
    except OSError as e:
        return Window("procfs", False, f"/proc: {e.strerror}")


_PROBES = (
    _probe_native_lib, _probe_native_toolchain, _probe_fanotify,
    _probe_perf, _probe_kmsg,
    _probe_ptrace, _probe_sock_diag, _probe_netlink_proc, _probe_af_packet,
    _probe_mountinfo, _probe_procfs, _probe_blktrace, _probe_tcpinfo,
    _probe_audit, _probe_captrace, _probe_fstrace, _probe_sockstate,
    _probe_sigtrace, _probe_container_runtime, _probe_capture_dir,
    _probe_history_dir, _probe_history_tiers, _probe_standing_queries,
    _probe_fleet_health, _probe_shared_runs, _probe_device_topology,
    _probe_pipeline_health, _probe_accuracy, _probe_fleet_topology,
)


def probe_windows() -> dict[str, Window]:
    """Probe every capture window once; returns {name: Window}."""
    out: dict[str, Window] = {}
    for probe in _PROBES:
        w = probe()
        out[w.name] = w
        _tm_window_ok.labels(window=w.name).set(1.0 if w.ok else 0.0)
    return out


# ---------------------------------------------------------------------------
# Per-gadget status
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GadgetStatus:
    category: str
    name: str
    status: str          # real | degraded | unavailable | synthetic-only
    window: str          # primary window name ("" for synthetic-only)
    note: str


def _source_windows() -> dict[int, tuple[str, str, str]]:
    """native_kind → (primary window, degraded-fallback window, note)."""
    from .sources import bridge as B
    return {
        B.SRC_PROC_EXEC: ("netlink_proc", "", ""),
        B.SRC_PROC_TCP: ("procfs", "", ""),
        B.SRC_FANOTIFY_EXEC: ("fanotify", "", ""),
        B.SRC_FANOTIFY_OPEN: ("fanotify", "", ""),
        B.SRC_FANOTIFY_RUNC: ("fanotify", "", ""),
        B.SRC_MOUNTINFO: ("mountinfo", "", ""),
        B.SRC_SOCK_DIAG: ("sock_diag", "procfs", "procfs scan fallback"),
        B.SRC_KMSG_OOM: ("kmsg", "", ""),
        B.SRC_PTRACE: ("ptrace", "", "needs --command/--pid or container filter"),
        B.SRC_PERF_CPU: ("perf", "procfs", "procfs stat-delta fallback"),
        B.SRC_PKT_DNS: ("af_packet", "", ""),
        B.SRC_PKT_SNI: ("af_packet", "", ""),
        B.SRC_PKT_FLOW: ("af_packet", "", ""),
    }


# Gadgets that don't route through SourceTraceGadget.native_kind (procfs
# drain loops, the perf sampler, self-observation) declare their windows
# here: (primary window, degraded fallback, note).
_GADGET_WINDOWS: dict[tuple[str, str], tuple[str, str, str]] = {
    ("profile", "cpu"): ("perf", "procfs",
                         "49Hz callchains; procfs stat-delta fallback"),
    ("profile", "block-io"): ("blktrace", "procfs",
                              "per-IO tracefs latency; diskstats fallback"),
    ("top", "file"): ("fanotify", "procfs",
                      "per-(pid,file) fanotify rows with filenames; "
                      "per-process /proc/<pid>/io fallback"),
    ("top", "tcp"): ("tcpinfo", "procfs",
                     "per-connection INET_DIAG_INFO byte deltas; "
                     "connection-churn fallback"),
    ("top", "block-io"): ("procfs", "", "/proc/diskstats deltas"),
    ("top", "sketch"): ("native_lib", "", "capture-plane self-observation"),
    ("top", "recordings"): ("capture_dir", "",
                            "recording lifecycle + journal disk usage"),
    ("top", "windows"): ("history_dir", "",
                         "sealed-window store contents + freshness"),
    ("top", "self"): ("native_lib", "", "native source self-stats"),
    ("snapshot", "process"): ("procfs", "", "procfs collector"),
    ("snapshot", "socket"): ("procfs", "", "procfs collector"),
    ("advise", "network-policy"): ("af_packet", "",
                                   "synthesizes from trace/network events"),
    # host-wide audit windows with the ptrace per-target flavour as the
    # labeled fallback (ref: capable.bpf.c / audit-seccomp.bpf.c are
    # system-wide kprobes)
    ("trace", "capabilities"): ("captrace", "audit|ptrace",
                                "cap_capable tracepoint (every check, "
                                "allow+deny verdicts); audit EPERM-rule "
                                "fallback is denial-only; ptrace flavour "
                                "per-target"),
    ("audit", "seccomp"): ("audit", "ptrace",
                           "host-wide AUDIT_SECCOMP records; ptrace "
                           "per-target flavour also sees RET_ERRNO"),
    ("trace", "fsslower"): ("fstrace", "ptrace",
                            "host-wide raw_syscalls entry/exit latency "
                            "with in-kernel fs-syscall filter; ptrace "
                            "flavour per-target"),
    ("trace", "tcp"): ("sockstate", "procfs",
                       "event-driven inet_sock_set_state transitions "
                       "(no scan window); /proc diff scanner fallback"),
    ("trace", "tcpconnect"): ("sockstate", "procfs",
                              "connect-only view of the state-transition "
                              "stream; /proc diff scanner fallback"),
    ("trace", "signal"): ("sigtrace", "netlink_proc",
                          "signal_generate tracepoint (every signal, "
                          "sender+target); netlink-exit fatal-signal "
                          "fallback; ptrace flavour per-target"),
}


def gadget_report(windows: dict[str, Window] | None = None) -> list[GadgetStatus]:
    """Status of every registered gadget given the probed windows."""
    from . import all_gadgets  # noqa: F401 — ensure registry is populated
    from .gadgets import registry as gadget_registry

    if windows is None:
        windows = probe_windows()
    native_ok = windows["native_lib"].ok
    src_map = _source_windows()
    out: list[GadgetStatus] = []

    for desc in gadget_registry.get_all():
        # interrogate the gadget class for its native source kind without
        # instantiating a run: new_instance needs a context, so read the
        # class attribute off a probe instance when cheap, else the class
        g_cls = _gadget_class(desc)
        native_kind = getattr(g_cls, "native_kind", None) if g_cls else None
        # the explicit table wins over the class source kind: gadgets that
        # pick their window at runtime (audit vs ptrace) declare both here
        if (desc.category, desc.name) in _GADGET_WINDOWS:
            window, fallback, note = _GADGET_WINDOWS[desc.category, desc.name]
            if native_kind is not None and not native_ok:
                # both flavours run through the capture library; a probe-ok
                # kernel window doesn't help if the lib can't load
                out.append(GadgetStatus(desc.category, desc.name,
                                        "unavailable", window,
                                        windows["native_lib"].detail))
            elif windows.get(window) and windows[window].ok:
                out.append(GadgetStatus(desc.category, desc.name, "real",
                                        window, note))
            else:
                # "a|b" fallback chains: first probing-ok window wins
                fb_ok = next((f for f in fallback.split("|")
                              if f and windows.get(f) and windows[f].ok),
                             "") if fallback else ""
                if fb_ok:
                    out.append(GadgetStatus(
                        desc.category, desc.name, "degraded", fb_ok,
                        f"{window} unavailable "
                        f"({windows[window].detail}); {note}"))
                else:
                    out.append(GadgetStatus(desc.category, desc.name,
                                            "unavailable", window,
                                            windows[window].detail))
            continue
        if native_kind is None:
            out.append(GadgetStatus(desc.category, desc.name, "synthetic-only",
                                    "", "no native window for this gadget"))
            continue
        window, fallback, note = src_map.get(native_kind, ("", "", ""))
        if not native_ok:
            out.append(GadgetStatus(desc.category, desc.name, "unavailable",
                                    window, windows["native_lib"].detail))
            continue
        if window and windows.get(window) and windows[window].ok:
            out.append(GadgetStatus(desc.category, desc.name, "real",
                                    window, note))
        elif fallback and windows.get(fallback) and windows[fallback].ok:
            out.append(GadgetStatus(
                desc.category, desc.name, "degraded", fallback,
                f"{window} unavailable ({windows[window].detail}); {note}"))
        else:
            detail = windows[window].detail if window in windows else "unknown"
            out.append(GadgetStatus(desc.category, desc.name, "unavailable",
                                    window, detail))
    out.sort(key=lambda g: (g.category, g.name))
    counts: dict[str, int] = {}
    for g in out:
        counts[g.status] = counts.get(g.status, 0) + 1
    for status in ("real", "degraded", "unavailable", "synthetic-only"):
        _tm_gadget_status.labels(status=status).set(counts.get(status, 0))
    return out


def _gadget_class(desc):
    """Best-effort extraction of the gadget implementation class from a
    descriptor's new_instance closure (gadget classes carry native_kind as
    a class attribute; descriptors don't)."""
    fn = getattr(desc, "new_instance", None)
    if fn is None:
        return None
    func = getattr(fn, "__func__", fn)
    # _register-built descs close over gadget_cls; hand-written descs
    # reference the class in code constants or globals
    closure = getattr(func, "__closure__", None)
    if closure:
        for cell in closure:
            v = cell.cell_contents
            if isinstance(v, type):
                return v
    import inspect
    try:
        src_names = func.__code__.co_names
        module = inspect.getmodule(func)
        for nm in src_names:
            v = getattr(module, nm, None)
            if isinstance(v, type) and hasattr(v, "native_kind"):
                return v
    except Exception as e:  # noqa: BLE001
        logging.getLogger("ig-tpu.doctor").debug(
            "gadget class extraction failed for %s: %r", desc.name, e)
    return None


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def render_report(windows: dict[str, Window] | None = None,
                  gadgets: list[GadgetStatus] | None = None) -> str:
    if windows is None:
        windows = probe_windows()
    if gadgets is None:
        gadgets = gadget_report(windows)
    lines = ["CAPTURE WINDOWS"]
    for w in windows.values():
        mark = "ok " if w.ok else "NO "
        lines.append(f"  {mark} {w.name:<14s} {w.detail}")
    lines.append("")
    lines.append("GADGETS")
    for g in gadgets:
        label = f"{g.category}/{g.name}"
        lines.append(f"  {g.status:<15s} {label:<28s} "
                     f"{g.window:<13s} {g.note}")
    counts: dict[str, int] = {}
    for g in gadgets:
        counts[g.status] = counts.get(g.status, 0) + 1
    lines.append("")
    # device-plane acquisition outcome (set by acquire_platform — the
    # agent probes at startup; standalone doctor shows "unprobed")
    from .utils.platform_probe import last_acquire
    acq = last_acquire()
    if acq is None:
        lines.append("PLATFORM unprobed (agents probe at startup; see --device)")
    elif acq["ok"]:
        lines.append(f"PLATFORM {acq['platform']} ({acq['detail']})")
    else:
        lines.append(f"PLATFORM {acq['requested']} FAILED ({acq['detail']})")
    lines.append("")
    lines.append("SUMMARY " + "  ".join(
        f"{k}={v}" for k, v in sorted(counts.items())))
    return "\n".join(lines)
