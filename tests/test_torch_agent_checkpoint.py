"""Checkpoint and resume wired into the port's agent: the cases of
``tests/test_checkpoint_resume.py`` against ``inspektor_gadget_tpu_torch``
on the CPU. The persisted state is the sketch bundle (and scorer):
host-offloaded by the agent's checkpointer, merged back on the next
start. The kill case SIGKILLs a serving port agent (``--device cpu``)
mid-ingest, restarts it, and holds the resumed counts to what the
checkpoint had.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu_torch.agent.client import AgentClient
from inspektor_gadget_tpu_torch.gadgets import GadgetContext, get
from inspektor_gadget_tpu_torch.operators import tpusketch
from inspektor_gadget_tpu_torch.operators.operators import get as get_op
from inspektor_gadget_tpu_torch.ops.sketches import bundle_init, bundle_to_numpy
from inspektor_gadget_tpu_torch.params import Collection
from inspektor_gadget_tpu_torch.runtime.local import LocalRuntime
from inspektor_gadget_tpu_torch.utils.checkpoint import load_pytree

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
RUN = {"gadget.source": "pysynthetic", "gadget.rate": "50000",
       "operator.tpusketch.enable": "true", "operator.tpusketch.harvest-interval": "200ms"}


@pytest.fixture()
def ckpt_dir(tmp_path):
    tpusketch.set_checkpoint_dir(tmp_path)
    yield tmp_path
    tpusketch.set_checkpoint_dir(None)


def _run_sketch(timeout=0.8, **extra_params):
    desc = get("trace", "exec")
    params = desc.params().to_params()
    params.set("source", "pysynthetic")
    params.set("rate", "100000")
    summaries = []
    op_params = Collection()
    sketch_params = get_op("tpusketch").instance_params().to_params()
    sketch_params.set("enable", "true")
    sketch_params.set("harvest-interval", "200ms")
    for k, v in extra_params.items():
        sketch_params.set(k, v)
    op_params["operator.tpusketch."] = sketch_params
    ctx = GadgetContext(desc, gadget_params=params, operator_params=op_params,
                        timeout=timeout, extra={"on_sketch_summary": summaries.append},
                        device="cpu")
    result = LocalRuntime().run_gadget(ctx)
    assert not result.errors()
    return summaries


def test_clean_shutdown_saves_and_next_run_resumes(ckpt_dir):
    """post_gadget_run checkpoints; the next run's counts start from it."""
    first = _run_sketch()
    assert first and first[-1].events > 1000
    e1 = first[-1].events
    assert (ckpt_dir / "trace-exec.npz").exists()
    second = _run_sketch()
    assert second[-1].events >= e1 + 1000, (second[-1].events, e1)


def test_config_change_falls_back_to_fresh(ckpt_dir):
    _run_sketch()
    # different sketch geometry → leaf mismatch → fresh state
    small = _run_sketch(**{"log2-width": "10", "hll-p": "10"})
    assert small[-1].events < 1_000_000


def test_corrupt_checkpoint_falls_back_to_fresh(ckpt_dir):
    """A torn .npz must mean fresh state, never a gadget that refuses to
    start."""
    (ckpt_dir / "trace-exec.npz").write_bytes(b"not a zip at all")
    (ckpt_dir / "trace-exec.json").write_text("{}")
    summaries = _run_sketch()
    assert summaries and summaries[-1].events > 1000


def test_scorer_checkpoint_roundtrip(ckpt_dir):
    first = _run_sketch(anomaly="true")
    assert first[-1].anomaly
    assert (ckpt_dir / "trace-exec-scorer.npz").exists()
    second = _run_sketch(anomaly="true")
    assert second[-1].anomaly


def _connect(addr: str, deadline_s: float) -> AgentClient | None:
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        client = AgentClient(addr, "ckpt-node", rpc_deadline=10.0)
        try:
            client.get_catalog(use_cache_on_error=False)
            return client
        except Exception:  # noqa: BLE001 — not serving yet
            client.close()
            time.sleep(0.5)
    return None


def test_agent_kill_and_resume(tmp_path):
    """SIGKILL a serving agent mid-ingest; restart; merged counts must be
    >= the checkpointed pre-kill counts."""
    ckpt = tmp_path / "ckpt"
    addr = f"unix://{tmp_path}/agent.sock"
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def spawn():
        return subprocess.Popen(
            [sys.executable, "-m", "inspektor_gadget_tpu_torch.agent.main", "serve",
             "--listen", addr, "--node-name", "ckpt-node", "--no-doctor", "--device", "cpu",
             "--checkpoint-dir", str(ckpt), "--checkpoint-interval", "0.3",
             "--flight-record-path", "off"],
            env=env, cwd=str(tmp_path), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    proc = spawn()
    client = client2 = None
    try:
        client = _connect(addr, 120.0)
        assert client is not None, "agent never came up"

        def run():
            try:
                client.run_gadget("trace", "exec", RUN, timeout=0.0, outputs=("summary",))
            except Exception:  # noqa: BLE001 — the kill below tears the stream
                pass

        t = threading.Thread(target=run, daemon=True)
        t.start()
        like = bundle_to_numpy(bundle_init(device="cpu"))
        deadline = time.monotonic() + 60
        pre_kill = 0.0
        while time.monotonic() < deadline:
            try:
                leaves = load_pytree(ckpt / "trace-exec", like=like)
                pre_kill = float(bundle_init_events(leaves))
                if pre_kill > 1000:
                    break
            except Exception:  # noqa: BLE001 — not written yet, or mid-write
                pass
            time.sleep(0.2)
        assert pre_kill > 1000, "no checkpoint with counts before kill"

        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        t.join(timeout=10)
        client.close()

        proc = spawn()
        client2 = _connect(addr, 120.0)
        assert client2 is not None, "agent never restarted"
        summaries = []
        stop = threading.Event()

        def on_s(_node, s):
            summaries.append(s)
            if s["events"] >= pre_kill:
                stop.set()

        watchdog = threading.Timer(120.0, stop.set)
        watchdog.start()
        res = client2.run_gadget("trace", "exec", RUN, timeout=0.0, outputs=("summary",),
                                 on_summary=on_s, stop_event=stop)
        watchdog.cancel()
        assert res["error"] is None, res["error"]
        assert summaries, "no summaries after restart"
        assert max(s["events"] for s in summaries) >= pre_kill, (
            f"reset detected: {summaries[-1]['events']} < {pre_kill}")
    finally:
        if client2 is not None:
            client2.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def bundle_init_events(leaves) -> float:
    """The bundle's event total from its checkpoint leaves."""
    from inspektor_gadget_tpu_torch.ops.sketches import bundle_from_numpy
    return float(bundle_from_numpy(leaves, device="cpu").events)
