"""Fault injection for fleet chaos tests.

Three chaos primitives the soak tier composes (ROADMAP: "chaos-hardened
100-node soak"; the container black-box and alerts e2e tiers both caught
real bugs — this tier exists to catch the distributed ones):

  - ChaosProxy: a TCP relay between an AgentClient and its agent with
    injectable faults — connection cut (close every live connection
    once; new ones pass), latency/slow-drip (per-chunk delay), and
    partition with heal (refuse or blackhole new connections AND kill
    live ones until heal()). The client dials the proxy's listen
    address; the proxy dials the real agent (tcp host:port or a unix
    socket path), so no agent code knows it is being tortured.
  - AgentProcess: a real `ig-tpu-torch agent` subprocess with SIGKILL /
    respawn — the crash-restart driver. Respawning reuses the same
    listen address and state dirs, so a resume attempt against the new
    process exercises the unknown-run → backfill-and-restart path.
  - SkewClock: an injectable monotonic clock with a settable offset, for
    testing that health/straggler logic tolerates clock skew.
  - SubscriberChurn: attach/hold/detach cycles against one SHARED gadget
    run (some rounds leaving by proxy cut) — dashboard-client churn as a
    first-class fault for the shared-run multiplexing plane.

Nothing here is test-framework-specific: `ig-tpu` users can point the
proxy at a production agent to rehearse failure drills.

The port's copy of ``inspektor_gadget_tpu/testing/chaos.py``:
`AgentProcess` runs the port's agent on the CPU (``--device cpu``; the
port's agents never fall back, so a respawn cannot hang acquiring a
device) with no flight record.
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time

log = logging.getLogger("ig-tpu.chaos")

_CHUNK = 65536


class ChaosProxy:
    """TCP proxy with injectable faults between a client and one agent.

    backend: "host:port" or a unix socket path ("/tmp/x.sock" or
    "unix:///tmp/x.sock"). Counters (connections_total, cuts_total,
    bytes_up/bytes_down) let tests assert the faults actually happened.
    """

    def __init__(self, backend: str, listen_host: str = "127.0.0.1"):
        self.backend = backend
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((listen_host, 0))
        self._listener.listen(16)
        self.listen_host, self.listen_port = self._listener.getsockname()
        self._mu = threading.Lock()
        self._conns: list[tuple[socket.socket, socket.socket | None]] = []
        self._closing = False
        self._partitioned: str | None = None  # None | "refuse" | "blackhole"
        self.latency = 0.0
        self.connections_total = 0
        self.refused_total = 0
        self.cuts_total = 0
        self.bytes_up = 0
        self.bytes_down = 0
        threading.Thread(target=self._accept_loop, daemon=True).start()

    @property
    def target(self) -> str:
        """The grpc target clients should dial."""
        return f"{self.listen_host}:{self.listen_port}"

    # -- fault controls -----------------------------------------------------

    def cut(self) -> None:
        """Sever every live connection once; new connections pass."""
        with self._mu:
            conns, self._conns = self._conns, []
            self.cuts_total += 1
        for pair in conns:
            self._close_pair(pair)

    def partition(self, mode: str = "refuse") -> None:
        """Isolate the agent until heal(): live connections die now;
        new ones are refused (fails fast — connection reset) or
        blackholed (accepted, never relayed — the connect 'succeeds'
        but gRPC channel readiness never does, exercising the
        per-attempt deadline)."""
        if mode not in ("refuse", "blackhole"):
            raise ValueError(f"unknown partition mode {mode!r}")
        with self._mu:
            self._partitioned = mode
        self.cut()

    def heal(self) -> None:
        """End the partition and clear injected latency."""
        with self._mu:
            self._partitioned = None
            self.latency = 0.0

    def set_latency(self, seconds: float) -> None:
        """Delay every relayed chunk (slow node, not a dead one)."""
        with self._mu:
            self.latency = max(0.0, float(seconds))

    # -- plumbing -----------------------------------------------------------

    def _dial_backend(self) -> socket.socket:
        b = self.backend
        if b.startswith("unix://"):
            b = b[len("unix://"):]
        if b.startswith("/") or b.startswith("@"):
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(b)
            return s
        host, port = b.rsplit(":", 1)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.connect((host or "127.0.0.1", int(port)))
        return s

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._mu:
                mode = self._partitioned
                self.connections_total += 1
            if mode == "refuse":
                self.refused_total += 1
                try:
                    conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                    b"\x01\x00\x00\x00\x00\x00\x00\x00")
                    conn.close()  # RST-ish: the dial fails fast
                except OSError:
                    pass
                continue
            if mode == "blackhole":
                # hold the socket open but never relay: the TCP connect
                # succeeds, the HTTP/2 handshake never answers
                with self._mu:
                    self._conns.append((conn, None))
                continue
            try:
                backend = self._dial_backend()
            except OSError as e:
                log.debug("chaos backend dial failed: %r", e)
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            pair = (conn, backend)
            with self._mu:
                self._conns.append(pair)
            threading.Thread(target=self._pump, args=(conn, backend, "up"),
                             daemon=True).start()
            threading.Thread(target=self._pump, args=(backend, conn, "down"),
                             daemon=True).start()

    def _pump(self, src: socket.socket, dst: socket.socket,
              direction: str) -> None:
        try:
            while True:
                data = src.recv(_CHUNK)
                if not data:
                    break
                delay = self.latency
                if delay > 0:
                    time.sleep(delay)
                dst.sendall(data)
                with self._mu:
                    if direction == "up":
                        self.bytes_up += len(data)
                    else:
                        self.bytes_down += len(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass

    @staticmethod
    def _close_pair(pair) -> None:
        for s in pair:
            if s is None:
                continue
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closing = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._mu:
            conns, self._conns = self._conns, []
        for pair in conns:
            self._close_pair(pair)


class AgentProcess:
    """A real agent subprocess with SIGKILL/respawn — the crash driver.

    The listen address and state dirs (history/capture/checkpoint)
    survive the kill, so the respawned agent serves the previous life's
    sealed windows: exactly what resume-with-backfill needs.
    """

    def __init__(self, node: str, listen: str, *, history_dir: str = "",
                 capture_dir: str = "", checkpoint_dir: str = "",
                 extra_args: tuple[str, ...] = (),
                 env: dict[str, str] | None = None):
        self.node = node
        self.listen = listen
        self.history_dir = history_dir
        self.capture_dir = capture_dir
        self.checkpoint_dir = checkpoint_dir
        self.extra_args = tuple(extra_args)
        self.env = dict(os.environ)
        # the package may be running from a source checkout that is not
        # installed: make `-m inspektor_gadget_tpu_torch...` resolvable in the
        # child regardless of its cwd
        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        pkg_root = os.path.dirname(pkg_parent)
        existing = self.env.get("PYTHONPATH", "")
        if pkg_root not in existing.split(os.pathsep):
            self.env["PYTHONPATH"] = (pkg_root + (os.pathsep + existing
                                                  if existing else ""))
        if env:
            self.env.update(env)
        self.proc: subprocess.Popen | None = None
        self.spawns = 0

    def _argv(self) -> list[str]:
        argv = [sys.executable, "-m", "inspektor_gadget_tpu_torch.agent.main",
                "serve", "--listen", self.listen,
                "--node-name", self.node,
                "--device", "cpu", "--no-doctor",
                "--flight-record-path", "off"]
        if self.history_dir:
            argv += ["--history-dir", self.history_dir]
        if self.capture_dir:
            argv += ["--capture-dir", self.capture_dir]
        if self.checkpoint_dir:
            argv += ["--checkpoint-dir", self.checkpoint_dir]
        argv += list(self.extra_args)
        return argv

    def start(self, wait: bool = True, timeout: float = 90.0) -> None:
        if self.proc is not None and self.proc.poll() is None:
            raise RuntimeError(f"agent {self.node} already running")
        self.proc = subprocess.Popen(
            self._argv(), env=self.env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        self.spawns += 1
        if wait:
            self.wait_ready(timeout)

    def wait_ready(self, timeout: float = 90.0) -> None:
        """Poll the catalog RPC until the agent answers (liveness
        contract, agent/main.py `liveness`)."""
        from ..agent.client import AgentClient
        deadline = time.monotonic() + timeout
        last: Exception | None = None
        while time.monotonic() < deadline:
            if self.proc is not None and self.proc.poll() is not None:
                raise RuntimeError(
                    f"agent {self.node} exited rc={self.proc.returncode} "
                    f"before becoming ready")
            try:
                c = AgentClient(self.listen, self.node, rpc_deadline=2.0)
                try:
                    c.get_catalog(use_cache_on_error=False)
                    return
                finally:
                    c.close()
            except Exception as e:  # noqa: BLE001 — not up yet
                last = e
                time.sleep(0.2)
        raise TimeoutError(
            f"agent {self.node} not ready after {timeout}s: {last!r}")

    def kill(self, sig: int = signal.SIGKILL) -> None:
        """SIGKILL by default: no SIGTERM grace, no seals, no goodbyes —
        the crash the journal/history torn-tail disciplines exist for."""
        if self.proc is None:
            return
        try:
            self.proc.send_signal(sig)
        except ProcessLookupError:
            pass
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)

    def respawn(self, wait: bool = True, timeout: float = 90.0) -> None:
        """Kill-if-alive then start fresh on the same address/dirs."""
        if self.proc is not None and self.proc.poll() is None:
            self.kill()
        # a unix socket path must be unlinked or the rebind fails
        if self.listen.startswith("unix://"):
            try:
                os.unlink(self.listen[len("unix://"):])
            except OSError:
                pass
        self.start(wait=wait, timeout=timeout)

    def stop(self) -> None:
        if self.proc is None:
            return
        if self.proc.poll() is None:
            try:
                self.proc.terminate()
                self.proc.wait(timeout=10)
            except (subprocess.TimeoutExpired, ProcessLookupError):
                self.kill()


class SubscriberChurn:
    """Attach/hold/detach churn against one SHARED gadget run — the
    fan-out analogue of connection chaos (dashboard clients coming and
    going, some of them dying mid-stream).

    Each round attaches a fresh subscriber to `run_id` on `target`
    (optionally dialing through a ChaosProxy), pumps records for `hold`
    seconds, then leaves — cleanly via a stop request, or rudely via
    `proxy.cut()` when `cut=True`. Counters (rounds, records, acks,
    cuts, errors) let tests assert the churn really happened; the
    invariants (no leaked queues/threads/runs, unaffected peers) are the
    test's to check.
    """

    def __init__(self, target: str, run_id: str, *, node: str = "",
                 proxy: "ChaosProxy | None" = None,
                 subscriber: dict | None = None):
        self.target = target
        self.run_id = run_id
        self.node = node or "churn"
        self.proxy = proxy
        self.subscriber = dict(subscriber or {})
        self.rounds = 0
        self.cuts = 0
        self.records = 0
        self.acks = 0
        self.errors: list[str] = []

    def round(self, hold: float = 0.5, cut: bool = False) -> dict:
        """One attach/hold/leave cycle; returns the client's accounting
        dict. cut=True severs the proxy mid-hold instead of stopping."""
        from ..agent.client import AgentClient
        stop = threading.Event()
        holder: dict = {}
        client = AgentClient(self.target, self.node)

        def pump():
            holder["out"] = client.run_gadget(
                "", "", attach_to=self.run_id,
                subscriber=dict(self.subscriber),
                on_message=lambda *_: None, stop_event=stop)

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        time.sleep(max(hold, 0.0))
        if cut and self.proxy is not None:
            self.proxy.cut()
            self.cuts += 1
            stop.set()  # unblock the stopper thread; the stream is gone
        else:
            stop.set()
        t.join(timeout=30.0)
        client.close()
        out = holder.get("out") or {"error": "churn round never returned"}
        self.rounds += 1
        self.records += int(out.get("records") or 0)
        if out.get("attach"):
            self.acks += 1
        # a cut round's transport error is the injected fault, not a
        # failure of the run under test
        if out.get("error") and not cut:
            self.errors.append(str(out["error"]))
        return out

    def run(self, rounds: int, *, hold: float = 0.5,
            cut_every: int = 0) -> None:
        """`rounds` cycles; every cut_every-th (1-based) leaves by
        proxy cut instead of a clean stop (0 = never cut)."""
        for i in range(1, rounds + 1):
            self.round(hold=hold,
                       cut=bool(cut_every and i % cut_every == 0))


class SkewClock:
    """A monotonic clock with injectable skew (FleetHealth's `clock`
    seam): skew(+5) jumps time forward five seconds for every consumer
    of this clock — the fleet-health equivalent of a VM pause or an NTP
    step."""

    def __init__(self, base=time.monotonic):
        self._base = base
        self.offset = 0.0

    def __call__(self) -> float:
        return self._base() + self.offset

    def skew(self, seconds: float) -> None:
        self.offset += float(seconds)


__all__ = ["AgentProcess", "ChaosProxy", "SkewClock", "SubscriberChurn"]
