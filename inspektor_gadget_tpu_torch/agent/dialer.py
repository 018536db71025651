"""Dialers: how an AgentClient reaches its agent.

Reference contract: pkg/runtime/grpc/k8s-exec-dialer.go:1-132 — the client
does not assume the agent is routable; it dials gRPC over the stdin/stdout
of a `kubectl exec` stream into the gadget pod. The seam here is the same:
a Dialer turns a target into a grpc.Channel. DirectDialer is the plain
host:port/unix path; ExecTunnelDialer bridges a local unix socket to a
subprocess's stdio (kubectl exec, ssh, or any stdio proxy), one subprocess
per gRPC connection, exactly as the reference spawns one exec stream per
dial.

The port's copy of ``inspektor_gadget_tpu/agent/dialer.py``, with two
departures, neither on the wire. The tunnel table is guarded by a lock:
the accept thread adds a tunnel, each tunnel's reader thread removes its
own, and `close` walks the table, all at once. And the listener's backlog
is SOMAXCONN, not 8: the accept thread spawns one subprocess a
connection, so under load connections queue behind it, and a full
backlog makes the next connect of gRPC's channel fail (EAGAIN on a unix
socket, then ENOTCONN on its first write) where it should wait its turn.
`accepted` counts the connections taken.
"""

from __future__ import annotations

import logging
import os
import socket
import subprocess
import tempfile
import threading
import uuid

import grpc

log = logging.getLogger("ig-tpu.dialer")


class DirectDialer:
    """Plain target: host:port or unix:///path."""

    def dial(self, target: str) -> grpc.Channel:
        return grpc.insecure_channel(target)

    def close(self) -> None:
        pass


class ExecTunnelDialer:
    """gRPC over a subprocess's stdio (the k8s-exec-dialer analogue).

    argv is the tunnel command, e.g.
      ["kubectl", "exec", "-i", "-n", "ig-tpu", "pod/ig-tpu-agent-x",
       "--", "socat", "-", "UNIX-CONNECT:/run/igtpu-agent.sock"]
    Anything that relays its stdio to the agent's socket works (ssh, socat,
    a python bridge). The dialer listens on a private local unix socket;
    every connection gRPC opens spawns one tunnel subprocess and pumps
    bytes both ways.
    """

    def __init__(self, argv: list[str]):
        self.argv = list(argv)
        self._dir = tempfile.mkdtemp(prefix="igtpu-tunnel-")
        self._path = os.path.join(self._dir, f"{uuid.uuid4().hex[:8]}.sock")
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self._path)
        self._listener.listen(socket.SOMAXCONN)
        self._closing = False
        self.accepted = 0
        self._procs_mu = threading.Lock()
        self._procs: list[subprocess.Popen] = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def dial(self, target: str) -> grpc.Channel:
        # the tunnel command embeds the real destination; `target` is kept
        # for logging/symmetry with DirectDialer
        return grpc.insecure_channel(f"unix://{self._path}")

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._procs_mu:
                if self._closing:
                    conn.close()
                    return
                proc = subprocess.Popen(
                    self.argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=subprocess.DEVNULL, bufsize=0)
                self._procs.append(proc)
                self.accepted += 1
            threading.Thread(target=self._pump_out, args=(conn, proc),
                             daemon=True).start()
            threading.Thread(target=self._pump_in, args=(conn, proc),
                             daemon=True).start()

    @staticmethod
    def _pump_out(conn: socket.socket, proc: subprocess.Popen) -> None:
        """local socket → tunnel stdin"""
        try:
            while True:
                data = conn.recv(65536)
                if not data:
                    break
                # bufsize=0 → raw FileIO: write() may accept only part of
                # the chunk when the pipe is full; loop until drained or
                # the stream corrupts under backpressure
                mv = memoryview(data)
                while mv:
                    n = proc.stdin.write(mv)
                    if not n:
                        # would-block/zero write on a blocking pipe: the
                        # chunk can't be delivered intact — tear the tunnel
                        # down rather than resume mid-stream corrupted
                        raise OSError("tunnel stdin short write")
                    mv = mv[n:]
                proc.stdin.flush()
        except (OSError, ValueError, BrokenPipeError):
            pass
        finally:
            try:
                proc.stdin.close()
            except Exception as e:  # noqa: BLE001 — teardown best-effort
                log.debug("tunnel stdin close failed: %r", e)

    def _pump_in(self, conn: socket.socket, proc: subprocess.Popen) -> None:
        """tunnel stdout → local socket"""
        try:
            while True:
                # bufsize=0 → raw FileIO: read() returns as soon as any
                # bytes are available (partial reads are fine here)
                data = proc.stdout.read(65536)
                if not data:
                    break
                conn.sendall(data)
        except (OSError, ValueError, BrokenPipeError):
            pass
        finally:
            try:
                conn.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            # stdout EOF means the tunnel exited (or is about to once its
            # stdin closes): reap it so reconnect churn over a long-lived
            # runtime doesn't accumulate zombies
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                try:
                    proc.wait(timeout=2)
                except subprocess.TimeoutExpired:
                    pass
            with self._procs_mu:
                if proc in self._procs:
                    self._procs.remove(proc)

    def close(self) -> None:
        self._closing = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._procs_mu:
            procs, self._procs = self._procs, []
        for p in procs:
            try:
                p.kill()
                p.wait(timeout=2)
            except Exception as e:  # noqa: BLE001 — teardown best-effort
                log.debug("tunnel process reap failed: %r", e)
        try:
            os.unlink(self._path)
            os.rmdir(self._dir)
        except OSError:
            pass


def kubectl_exec_dialer(pod: str, namespace: str = "ig-tpu",
                        agent_socket: str = "/run/igtpu-agent.sock",
                        kubectl: str = "kubectl") -> ExecTunnelDialer:
    """The concrete kubectl-exec tunnel (k8s-exec-dialer.go parity)."""
    return ExecTunnelDialer([
        kubectl, "exec", "-i", "-n", namespace, pod, "--",
        "socat", "-", f"UNIX-CONNECT:{agent_socket}",
    ])
