"""The capture fan-out on the CPU: a recording armed over the port's
GrpcRuntime journals a 2-agent run of port agents (batches, summaries and
alert transitions a node), every node's journals are pulled into one
client-side bundle (`fetch_recording`), and the bundle replays — the
fetch fan-out of ``tests/test_capture_replay_e2e.py``:

- each node's fetched journal names its node, gadget, recording and
  provenance; the cluster fold-in of the nodes' alerts fires once;
- a SIGKILLed writer tears a journal mid-segment and reopening drops
  the torn tail with the loss accounted;
- replaying each journal through the port's operator chain on the
  recorded clock reproduces the recorded alert lifecycle and summary
  digests, the same run to run;
- ``replay --verify`` of a fetched journal, ``record list --remote`` and
  ``record inspect`` of the bundle, ``alerts test --journal`` from the
  CLI, in this process.

Agents, replays and the CLI's replay run on the CPU.
"""

from __future__ import annotations

import binascii
import json
import os
import signal
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest
import torch

import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu_torch.agent import wire
from inspektor_gadget_tpu_torch.agent.service import serve
from inspektor_gadget_tpu_torch.capture import (
    RECORDINGS,
    JournalReader,
    is_journal,
    replay_journal,
)
from inspektor_gadget_tpu_torch.gadgets import GadgetContext
from inspektor_gadget_tpu_torch.gadgets import registry as gadget_registry
from inspektor_gadget_tpu_torch.gadgets.interface import GadgetDesc, GadgetType
from inspektor_gadget_tpu_torch.operators import operators as op_registry
from inspektor_gadget_tpu_torch.params import Collection, ParamDescs

torch.set_num_threads(2)


RULE_ID = "entropy-jump"
FOR_S = 0.05
EPOCH_GAP_S = 0.08
REC_ID = "e2e-incident"

RULES_DOC = json.dumps({"rules": [{
    "id": RULE_ID, "kind": "entropy_jump", "threshold": 1.0, "window": 3,
    "for": FOR_S, "cooldown": "5s", "severity": "warning",
}]})


class _CaptureSynthGadget:
    """Scripted key distribution (constant → uniform → constant) with one
    EXPLICIT harvest per batch: the recorded journal then carries
    deterministic harvest boundaries for the replay to reproduce."""

    def __init__(self, ctx):
        self.ctx = ctx
        self._batch_handler = None

    def set_batch_handler(self, handler):
        self._batch_handler = handler

    def run(self, ctx):
        from inspektor_gadget_tpu_torch.operators import tpusketch
        from inspektor_gadget_tpu_torch.sources.batch import EventBatch
        rng = np.random.default_rng(7)
        phases = (
            [np.full(2048, 0xDEADBEEF, dtype=np.uint64)] * 3
            + [rng.integers(1, 2**32, 8192, dtype=np.uint64)
               for _ in range(3)]
            + [np.full(64, 0xDEADBEEF, dtype=np.uint64)] * 3
        )
        inst = next((i for i in tpusketch.live_instances()
                     if i.ctx.run_id == ctx.run_id), None)
        for keys in phases:
            if ctx.done:
                return
            b = EventBatch.alloc(len(keys), with_comm=False)
            b.cols["key_hash"][:] = keys
            b.cols["mntns"][:] = 1
            b.cols["ts"][:] = time.time_ns()
            b.count = len(keys)
            if self._batch_handler is not None:
                self._batch_handler(b)
            if inst is not None:
                inst.harvest()
            ctx.sleep_or_done(EPOCH_GAP_S)


class _CaptureSynthDesc(GadgetDesc):
    name = "capturesynth"
    category = "trace"
    gadget_type = GadgetType.TRACE
    description = "scripted-entropy batch gadget (capture/replay e2e)"
    event_cls = None

    def params(self) -> ParamDescs:
        return ParamDescs()

    def new_instance(self, ctx) -> _CaptureSynthGadget:
        return _CaptureSynthGadget(ctx)


@pytest.fixture(scope="module", autouse=True)
def synth_gadget():
    desc = _CaptureSynthDesc()
    gadget_registry.register(desc)
    yield desc
    gadget_registry._REGISTRY.pop((desc.category, desc.name), None)


@pytest.fixture(scope="module")
def agents(tmp_path_factory):
    servers, targets = [], {}
    tmp = tmp_path_factory.mktemp("cap-agents")
    for i in range(2):
        addr = f"unix://{tmp}/cap-agent{i}.sock"
        server, _ = serve(addr, node_name=f"cnode-{i}", device="cpu")
        servers.append(server)
        targets[f"cnode-{i}"] = addr
    yield targets
    for s in servers:
        s.stop(grace=0.5).wait(10.0)


@pytest.fixture(scope="module")
def capture_area(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("capture-area"))
    RECORDINGS.set_base_dir(base)
    yield base
    RECORDINGS.set_base_dir(None)


def _op_params() -> Collection:
    col = Collection()
    ap = op_registry.get("alerts").instance_params().to_params()
    ap.set("rules", RULES_DOC)
    col["operator.alerts."] = ap
    sp = op_registry.get("tpusketch").instance_params().to_params()
    for k, v in (("enable", "true"), ("depth", "4"), ("log2-width", "10"),
                 ("hll-p", "8"), ("entropy-log2-width", "8"),
                 ("topk", "16"), ("harvest-interval", "1h")):
        sp.set(k, v)
    col["operator.tpusketch."] = sp
    return col


def _transition_key(a: dict) -> tuple:
    return (a.get("rule"), a.get("key", ""), a.get("transition"),
            a.get("epoch"))


def _frame(header: dict, payload: bytes = b"") -> bytes:
    zp = zlib.compress(wire.encode_msg(header, payload), 1)
    return (len(zp).to_bytes(4, "little")
            + (zlib.crc32(zp) & 0xFFFFFFFF).to_bytes(4, "little") + zp)


@pytest.fixture(scope="module")
def recorded_bundle(agents, capture_area, tmp_path_factory):
    """Arm → run on both agents → stop → fetch: the shared journey every
    test below inspects from a different side."""
    from inspektor_gadget_tpu_torch.runtime.grpc_runtime import GrpcRuntime
    runtime = GrpcRuntime(dict(agents))
    cluster_events: list[dict] = []
    try:
        results, errors = runtime.start_recording(REC_ID)
        assert not errors, errors
        assert set(results) == set(agents)

        desc = gadget_registry.get("trace", "capturesynth")
        ctx = GadgetContext(desc, operator_params=_op_params(), timeout=120.0)
        run = runtime.run_gadget(ctx, on_alert=cluster_events.append)
        assert not run.errors(), run.errors()

        stop_results, stop_errors = runtime.stop_recording(REC_ID)
        assert not stop_errors, stop_errors

        bundle_dir = str(tmp_path_factory.mktemp("bundle"))
        bundle = runtime.fetch_recording(REC_ID, bundle_dir)
        assert not bundle["errors"], bundle["errors"]
    finally:
        runtime.close()
    return {"bundle_dir": bundle_dir, "bundle": bundle,
            "cluster_events": cluster_events}


def _node_journal(bundle_dir: str, node: str) -> str:
    """The fetched journal recorded BY `node` (manifest-addressed)."""
    root = os.path.join(bundle_dir, node)
    for name in sorted(os.listdir(root)):
        jpath = os.path.join(root, name)
        if is_journal(jpath) and \
                JournalReader(jpath).manifest.get("node") == node:
            return jpath
    raise AssertionError(f"no journal recorded by {node} under {root}")


def test_record_kill_replay_end_to_end(recorded_bundle, agents):
    bundle_dir = recorded_bundle["bundle_dir"]

    # -- the 2-agent run produced one journal per node, with provenance --
    journals = {n: _node_journal(bundle_dir, n) for n in agents}
    for node, jpath in journals.items():
        m = JournalReader(jpath).manifest
        assert m["node"] == node
        assert m["gadget"] == "trace/capturesynth"
        assert m["recording_id"] == REC_ID
        assert "operator.alerts.rules" in m["params"]
        assert m["git_sha"]  # provenance stamped, not guessed

    # the cluster fold-in fired exactly once during the recorded run
    cluster = [e for e in recorded_bundle["cluster_events"]
               if e["rule"] == RULE_ID]
    assert [e["transition"] for e in cluster] == \
        ["pending", "firing", "resolved"]

    # -- SIGKILL a writer mid-segment: the journal survives ---------------
    victim = journals["cnode-0"]
    segs = sorted(f for f in os.listdir(victim) if f.endswith(".igj"))
    seg = os.path.join(victim, segs[-1])
    reader0 = JournalReader(victim)
    pre_records = sum(1 for _ in reader0.records())
    assert not reader0.losses
    good = _frame({"type": wire.EV_JOURNAL_MARK, "seq": 10_000,
                   "ts": time.time(), "mark": "pre-kill"})
    torn = _frame({"type": wire.EV_JOURNAL_MARK, "seq": 10_001,
                   "ts": time.time(), "mark": "never-lands"})
    child = subprocess.Popen([
        sys.executable, "-c",
        "import binascii, os, signal, sys\n"
        "f = open(sys.argv[1], 'ab')\n"
        "f.write(binascii.unhexlify(sys.argv[2]))\n"
        "f.write(binascii.unhexlify(sys.argv[3]))\n"
        "f.flush(); os.fsync(f.fileno())\n"
        "os.kill(os.getpid(), signal.SIGKILL)\n",
        seg, binascii.hexlify(good).decode(),
        binascii.hexlify(torn[: len(torn) // 2]).decode(),
    ])
    child.wait(timeout=30)
    assert child.returncode == -signal.SIGKILL

    # reopen: the torn tail is dropped and the loss is ACCOUNTED; every
    # record up to and including the killed writer's last whole frame
    # survives
    reader = JournalReader(victim)
    recs = list(reader.records())
    assert len(recs) == pre_records + 1
    assert recs[-1][0]["mark"] == "pre-kill"
    assert len(reader.losses) == 1
    assert reader.losses[0].dropped_bytes == len(torn) // 2

    # -- replay both journals: identical lifecycle, deterministically -----
    for node, jpath in journals.items():
        res = replay_journal(jpath, speed=0.0, device="cpu")
        recorded = [a for a in res.recorded_alerts if a["rule"] == RULE_ID]
        replayed = [a for a in res.alerts if a["rule"] == RULE_ID]
        # same rule, key, state sequence, and debounce epoch — exactly
        assert [_transition_key(a) for a in replayed] == \
            [_transition_key(a) for a in recorded], (node, replayed, recorded)
        assert [a["transition"] for a in replayed] == \
            ["pending", "firing", "resolved"]
        # debounce timing on the injected clock: firing held ≥ `for`
        pend = next(a for a in replayed if a["transition"] == "pending")
        fire = next(a for a in replayed if a["transition"] == "firing")
        assert fire["epoch"] > pend["epoch"]
        # the replayed sketch summaries digest-match the recording
        assert res.digests_match, (node, res.recorded_digests, res.digests)
        # one harvest per scripted batch + the run's teardown harvest
        assert len(res.digests) == 10
        assert res.events == 3 * 2048 + 3 * 8192 + 3 * 64


def test_replay_is_deterministic_run_to_run(recorded_bundle, agents):
    jpath = _node_journal(recorded_bundle["bundle_dir"], "cnode-1")
    a = replay_journal(jpath, speed=0.0, device="cpu")
    b = replay_journal(jpath, speed=0.0, device="cpu")
    # byte-identical summary sequence: same digests in the same order
    assert a.digests == b.digests
    assert [_transition_key(x) for x in a.alerts] == \
        [_transition_key(x) for x in b.alerts]


def test_replay_cli_verify_and_record_verbs(recorded_bundle, agents,
                                            capsys, capture_area):
    from inspektor_gadget_tpu_torch.cli.main import main as cli_main
    jpath = _node_journal(recorded_bundle["bundle_dir"], "cnode-1")

    assert cli_main(["replay", jpath, "--verify", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "verify=ok" in out and RULE_ID in out

    spec = ",".join(f"{k}={v}" for k, v in agents.items())
    assert cli_main(["record", "list", "--remote", spec]) == 0
    out = capsys.readouterr().out
    assert REC_ID in out and "stopped" in out

    assert cli_main(["record", "inspect",
                     recorded_bundle["bundle_dir"]]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert any(str(wire.EV_SUMMARY) in j["by_type"]
               for j in doc["journals"].values())


def test_alerts_test_consumes_journals(recorded_bundle, tmp_path, capsys):
    from inspektor_gadget_tpu_torch.cli.main import main as cli_main
    rules = tmp_path / "rules.json"
    rules.write_text(RULES_DOC)
    jpath = _node_journal(recorded_bundle["bundle_dir"], "cnode-0")
    assert cli_main(["alerts", "test", "--file", str(rules),
                     "--journal", jpath]) == 0
    cap = capsys.readouterr()
    assert f"{RULE_ID} -> firing" in cap.out
