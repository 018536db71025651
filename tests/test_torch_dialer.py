"""The port's dialers under reconnect churn, on the CPU (the four cases of
``tests/test_dialer.py``): a supervised runtime redials on every
reconnect attempt, so 50 dial/close cycles must not grow fds or threads,
and the exec tunnel's per-connection subprocesses must be reaped (no
zombies) across churn, its listener serving on after raw connection
churn. The agent is the port's, in this process, on the CPU."""

from __future__ import annotations

import os
import socket
import sys
import threading
import time

import pytest
import torch

import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu_torch.agent.client import AgentClient
from inspektor_gadget_tpu_torch.agent.dialer import DirectDialer, ExecTunnelDialer
from inspektor_gadget_tpu_torch.agent.service import serve

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def agent_addr(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dialer")
    addr = f"unix://{tmp}/dialer-agent.sock"
    server, _ = serve(addr, node_name="dialer-node", device="cpu")
    yield addr
    server.stop(grace=0.5).wait(10.0)


def _fd_count() -> int:
    return len(os.listdir("/proc/self/fd"))


def test_direct_dialer_churn_no_fd_or_thread_growth(agent_addr):
    """50 dial → RPC → close cycles: bounded fd/thread growth. gRPC
    keeps a small shared pool, so allow slack — what must NOT happen is
    linear growth with the cycle count."""
    # warm up once so lazily-created shared state doesn't count as leak
    c = AgentClient(agent_addr, "warm")
    c.get_catalog(use_cache_on_error=False)
    c.close()
    time.sleep(0.3)
    fd0 = _fd_count()
    th0 = threading.active_count()
    for _ in range(50):
        client = AgentClient(agent_addr, "churn")
        client.get_catalog(use_cache_on_error=False)
        client.close()
    time.sleep(1.0)  # let grpc wind down its per-channel workers
    fd_growth = _fd_count() - fd0
    th_growth = threading.active_count() - th0
    assert fd_growth <= 16, f"fd leak over 50 dial/close cycles: +{fd_growth}"
    assert th_growth <= 8, f"thread leak over 50 cycles: +{th_growth}"


def test_direct_dialer_reconnect_churn(agent_addr):
    """The supervisor's redial path: one client, 50 reconnect() calls,
    each followed by a live RPC — bounded fds, every channel usable."""
    client = AgentClient(agent_addr, "reconn")
    client.get_catalog(use_cache_on_error=False)
    time.sleep(0.3)
    fd0 = _fd_count()
    for _ in range(50):
        client.reconnect()
        client.get_catalog(use_cache_on_error=False)
    time.sleep(1.0)
    growth = _fd_count() - fd0
    client.close()
    assert growth <= 16, f"fd leak over 50 reconnect cycles: +{growth}"


# a stdio↔unix-socket bridge: what socat/kubectl-exec does, stdlib-only
# (the container has no socat)
_BRIDGE = r"""
import socket, sys, threading
s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
s.connect(sys.argv[1])
def up():
    while True:
        d = sys.stdin.buffer.read1(65536)
        if not d:
            break
        s.sendall(d)
    try:
        s.shutdown(socket.SHUT_WR)
    except OSError:
        pass
t = threading.Thread(target=up, daemon=True)
t.start()
while True:
    d = s.recv(65536)
    if not d:
        break
    sys.stdout.buffer.write(d)
    sys.stdout.buffer.flush()
"""


def test_exec_tunnel_end_to_end_and_subprocess_reap(agent_addr):
    """A real exec tunnel (python stdio bridge standing in for
    socat/kubectl-exec): catalog RPCs work through it, and repeated
    dial/close cycles reap every tunnel subprocess — the reap path at
    dialer.py _pump_in must leave no zombies behind."""
    sock_path = agent_addr[len("unix://"):]
    dialer = ExecTunnelDialer([sys.executable, "-c", _BRIDGE, sock_path])
    try:
        for _ in range(5):
            client = AgentClient(agent_addr, "tunnel", dialer=dialer)
            # the dialer owns the subprocesses; don't let client.close()
            # tear the shared dialer down between cycles
            client.dialer = DirectDialer()
            cat = client.get_catalog(use_cache_on_error=False)
            assert any(g["name"] == "exec" for g in cat["gadgets"])
            client.close()
        # every tunnel subprocess exits and is waited on (no zombies:
        # a zombie still answers poll() None only until reaped; after
        # the reap path ran, returncode is set and _procs is empty)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and dialer._procs:
            time.sleep(0.2)
        assert not dialer._procs, \
            f"{len(dialer._procs)} tunnel subprocess(es) not reaped"
    finally:
        dialer.close()


def test_exec_tunnel_raw_churn_reaps_and_survives(agent_addr):
    """Raw connection churn (no gRPC): 10 open/close cycles against the
    tunnel listener; every connection accepted and its subprocess reaped,
    listener still serving."""
    sock_path = agent_addr[len("unix://"):]
    dialer = ExecTunnelDialer([sys.executable, "-c", _BRIDGE, sock_path])
    try:
        for _ in range(10):
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(dialer._path)
            s.close()
        # the accept thread spawns one tunnel a connection: wait until it
        # took all ten, not only until its table is empty for a moment
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and (dialer.accepted < 10 or dialer._procs):
            time.sleep(0.2)
        assert dialer.accepted == 10, f"{dialer.accepted} of 10 connections accepted"
        assert not dialer._procs, "churned tunnels not reaped"
        # the listener is still alive: one more real roundtrip works
        client = AgentClient(agent_addr, "tunnel2", dialer=dialer)
        client.dialer = DirectDialer()
        assert client.get_catalog(use_cache_on_error=False)["gadgets"]
        client.close()
    finally:
        dialer.close()
