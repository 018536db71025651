"""The port's capture and replay plane (`inspektor_gadget_tpu_torch.capture`
and the alerts operator) against the reference's, on the CPU.

Each package's `LocalRuntime` records ``trace/exec`` on the pysynthetic
source (seed 7, batches of 4096, a harvest every two batches taken from
the batch callback, so both recordings harvest at the same batches) with
the capture operator and alert rules on sketch fields. Then:

- the two recordings hold the same records in the same order: the same
  batches, the same summary digests, the same alert transitions, the
  run-end resolve included;
- a journal recorded by either package and replayed by the other gives
  the replaying package's own digests and transitions, which equal the
  recording's; the port's replay is the same run to run;
- with the history plane on (``history-interval 0``: a window a
  harvest) the resealed windows' digests equal the recorded run's, in
  order, in both packages; with ``history-interval 1s`` on a journal
  recorded under an injected clock, both packages reseal the same
  windows with the same stamps, on the recorded timeline (the port's
  history clock falls back to the alerts clock, as the reference's does);
- with the ae scorer on (the reference's initial weights carried into
  the port's replay), the sketch fields are equal and the scores within
  5% (``tests/test_torch_runtime.py``'s tolerance), and the port replays
  its own ae recording digest for digest;
- the recording manager, `iter_journals` over a journal, a recording and
  a bundle, and the CLI's ``record``, ``replay --verify`` and ``alerts
  test --journal`` in-process.
"""

from __future__ import annotations

import functools
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu import capture as RC
from inspektor_gadget_tpu import gadgets as RG
from inspektor_gadget_tpu import params as RPm
from inspektor_gadget_tpu.agent import wire as RW
from inspektor_gadget_tpu.capture import operator as RCop
from inspektor_gadget_tpu.cli import main as ref_cli
from inspektor_gadget_tpu.history import HISTORY as REF_HISTORY
from inspektor_gadget_tpu.operators import operators as ROps
from inspektor_gadget_tpu.operators import tpusketch as R
from inspektor_gadget_tpu.runtime.local import LocalRuntime as RefLocalRuntime
from inspektor_gadget_tpu_torch import capture as PC
from inspektor_gadget_tpu_torch import gadgets as PG
from inspektor_gadget_tpu_torch import params as PPm
from inspektor_gadget_tpu_torch.agent import wire as PW
from inspektor_gadget_tpu_torch.capture import operator as PCop
from inspektor_gadget_tpu_torch.cli import main as cli
from inspektor_gadget_tpu_torch.history import HISTORY
from inspektor_gadget_tpu_torch.models.params import params_from_numpy
from inspektor_gadget_tpu_torch.operators import operators as POps
from inspektor_gadget_tpu_torch.operators import tpusketch as P
from inspektor_gadget_tpu_torch.runtime import LocalRuntime

torch.set_num_threads(2)

SMALL = {"depth": "3", "log2-width": "10", "hll-p": "8", "entropy-log2-width": "6",
         "topk": "8", "harvest-interval": "1h"}
AE = {"anomaly": "true", "anomaly-model": "ae"}
BATCH = 4096
BATCHES = 8
HARVEST_EVERY = 2
RULES = json.dumps([
    {"id": "busy", "kind": "threshold", "field": "events", "op": ">", "threshold": 10000,
     "severity": "info"},
    {"id": "ej", "kind": "entropy_jump", "threshold": 0.001, "window": 2},
    {"id": "card", "kind": "cardinality_spike", "factor": 1.02, "window": 2},
    {"id": "churn", "kind": "heavy_hitter_churn", "threshold": 0.05},
])
PKG = {
    "reference": dict(G=RG, Pm=RPm, Ops=ROps, live=R._live, runtime=RefLocalRuntime, C=RC,
                      W=RW, Cop=RCop, kw={}),
    "port": dict(G=PG, Pm=PPm, Ops=POps, live=P._live, runtime=LocalRuntime, C=PC, W=PW,
                 Cop=PCop, kw={"device": "cpu"}),
}


def record(pkg: str, capdir: str, *, planes: dict | None = None, rules: str = RULES,
           history_dir: str = "", batches: int = BATCHES) -> str:
    """One recorded LocalRuntime run of trace/exec; returns its journal."""
    k = PKG[pkg]
    desc = k["G"].get("trace", "exec")
    gp = desc.params().to_params()
    for key, v in {"source": "pysynthetic", "seed": "7", "batch-size": str(BATCH),
                   "rate": "1e9"}.items():
        gp.set(key, v)
    sketch = {"enable": "true", **SMALL, **(planes or {})}
    if history_dir:
        sketch.update({"history": "true", "history-interval": "0",
                       "history-dir": history_dir})
    # every operator's params, as the CLI passes them (the manifest records them)
    ops = {f"operator.{op.name}.": op.instance_params().to_params()
           for op in k["Ops"].get_all()}
    for name, values in (("tpusketch", sketch), ("capture", {"dir": capdir}),
                         ("alerts", {"rules": rules, "log": "false"})):
        for key, v in values.items():
            ops[f"operator.{name}."].set(key, v)
    ctx = k["G"].GadgetContext(desc, gadget_params=gp, operator_params=k["Pm"].Collection(ops),
                               **k["kw"])
    n = 0

    def on_batch(batch):
        nonlocal n
        n += 1
        if n % HARVEST_EVERY == 0:
            k["live"][ctx.run_id].harvest()
        if n == batches:
            ctx.cancel()

    out = k["runtime"]().run_gadget(ctx, on_batch=on_batch)
    assert out["local"].error is None, out["local"].error
    (jpath,) = list(k["C"].iter_journals(capdir))
    return jpath


def replay(pkg: str, jpath: str, **kw):
    if pkg == "port":
        kw.setdefault("device", "cpu")
    return PKG[pkg]["C"].replay_journal(jpath, **kw)


def _keys(alerts: list[dict]) -> list[tuple]:
    return [(a["rule"], a.get("key", ""), a["transition"], a.get("epoch", 0)) for a in alerts]


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    """Each package's recording, with the history plane sealing a window
    a harvest into its own store."""
    base = tmp_path_factory.mktemp("capture")
    out = {}
    for pkg in PKG:
        hist = str(base / f"{pkg}-hist")
        out[pkg] = (record(pkg, str(base / f"{pkg}-cap"), history_dir=hist), hist)
    yield out
    for pkg in PKG:  # the stores' writers were released at teardown
        shutil.rmtree(out[pkg][1], ignore_errors=True)


def _records(pkg: str, jpath: str) -> list[tuple[int, dict, bytes]]:
    return [(h["type"], h, p) for h, p in PKG[pkg]["C"].JournalReader(jpath).records()]


def test_both_packages_record_the_same_journal(recordings):
    """The capture operator's records: the run-start and run-end marks,
    every batch, a summary with its digest at each harvest, each alert
    transition, in the same order in both packages' journals."""
    got = {pkg: _records(pkg, recordings[pkg][0]) for pkg in PKG}
    types = {pkg: [t for t, _, _ in recs] for pkg, recs in got.items()}
    assert types["port"] == types["reference"]
    ev = PW
    assert types["port"].count(ev.EV_BATCH_NPZ) == BATCHES
    assert types["port"].count(ev.EV_SUMMARY) == BATCHES // HARVEST_EVERY + 1  # + teardown's
    assert types["port"][0] == types["port"][-1] == ev.EV_JOURNAL_MARK
    marks = [h["mark"] for t, h, _ in got["port"] if t == ev.EV_JOURNAL_MARK]
    assert marks == ["run-start", "run-end"]
    for (t, ph, pp), (_, rh, rp) in zip(got["port"], got["reference"]):
        if t == ev.EV_BATCH_NPZ:
            pb, rb = PW.decode_batch(pp), RW.decode_batch(rp)
            assert pb.count == rb.count == BATCH and ph["batch_seq"] == rh["batch_seq"]
            for col in ("kind", "pid", "uid", "key_hash"):
                np.testing.assert_array_equal(pb.cols[col][:pb.count], rb.cols[col][:rb.count])
        elif t == ev.EV_SUMMARY:
            assert ph["digest"] == rh["digest"]
            assert PW.decode_summary(ph, pp)["events"] == RW.decode_summary(rh, rp)["events"]
        elif t == ev.EV_ALERT:
            assert _keys([ph["alert"]]) == _keys([rh["alert"]])
    manifest = PC.JournalReader(recordings["port"][0]).manifest
    assert manifest["platform"] == "cpu" and manifest["gadget"] == "trace/exec"
    assert manifest["params"]["operator.capture.dir"]


@pytest.mark.parametrize("recorder", sorted(PKG))
def test_a_journal_replays_alike_in_both_packages(recordings, recorder, tmp_path):
    """Either package's journal, replayed by each package: the digests and
    transitions equal the recording's, and the resealed windows' digests
    equal the recorded run's, in order."""
    jpath, live_hist = recordings[recorder]
    live = [r["digest"] for r in
            (HISTORY if recorder == "port" else REF_HISTORY).list_windows(
                base_dir=live_hist, gadget="trace/exec")]
    assert len(live) == BATCHES // HARVEST_EVERY  # teardown's harvest seals no empty window
    results = {}
    for pkg in PKG:
        hist = str(tmp_path / f"{pkg}-replay")
        res = replay(pkg, jpath, param_overrides={"operator.tpusketch.history-dir": hist})
        assert res.digests_match and res.alerts_match, (pkg, res.digests, res.recorded_digests)
        assert res.batches == BATCHES and res.events == BATCHES * BATCH
        store = HISTORY if pkg == "port" else REF_HISTORY
        assert [r["digest"] for r in store.list_windows(base_dir=hist, gadget="trace/exec")] \
            == live, pkg
        results[pkg] = res
    assert results["port"].digests == results["reference"].digests
    assert _keys(results["port"].alerts) == _keys(results["reference"].alerts)
    assert len(results["port"].recorded_alerts) >= 3


def test_run_end_resolve_is_journaled_and_replays(recordings):
    """`busy` still fires when the run ends: the engine's close() resolves
    it while the capture operator's writer is still open (teardown runs
    capture → alerts → localmanager → kubemanager → tpusketch in reverse,
    the reference's chain), so the journal ends with the resolve and the
    replay reproduces it."""
    chain = [op.name for op in POps.get_operators_for_gadget(PG.get("trace", "exec"))]
    assert chain == ["capture", "alerts", "localmanager", "kubemanager", "tpusketch"]
    assert chain == [op.name for op in ROps.get_operators_for_gadget(RG.get("trace", "exec"))]
    res = replay("port", recordings["port"][0])
    recorded = [a["transition"] for a in res.recorded_alerts if a["rule"] == "busy"]
    assert recorded == ["pending", "firing", "resolved"]
    assert [a["transition"] for a in res.alerts if a["rule"] == "busy"] == recorded
    assert res.alerts_match


def test_port_replay_is_deterministic_run_to_run(recordings):
    jpath = recordings["port"][0]
    a, b = replay("port", jpath), replay("port", jpath, speed=0.0)
    assert a.digests == b.digests == a.recorded_digests
    assert _keys(a.alerts) == _keys(b.alerts) == _keys(a.recorded_alerts)
    assert [s["heavy_hitters"] for s in a.summaries] == [s["heavy_hitters"] for s in b.summaries]


def test_history_interval_windows_take_the_recorded_clock(tmp_path, monkeypatch):
    """A journal recorded under an injected clock (a record every 0.25 s)
    and replayed with ``history-interval 1s``: the replay has only the
    alerts clock, and both packages reseal the same windows, stamped on
    the recorded timeline (seconds since the journal's first record)."""
    t = iter(np.arange(1_000.0, 2_000.0, 0.25))
    monkeypatch.setattr(PCop, "JournalWriter",
                        functools.partial(PCop.JournalWriter, clock=lambda: float(next(t))))
    jpath = record("port", str(tmp_path / "cap"))
    over = {"operator.tpusketch.history": "true", "operator.tpusketch.history-interval": "1s"}
    rows = {}
    for pkg in PKG:
        hist = str(tmp_path / f"{pkg}-hist")
        res = replay(pkg, jpath, param_overrides={**over, "operator.tpusketch.history-dir": hist})
        assert res.digests_match and res.alerts_match
        store = HISTORY if pkg == "port" else REF_HISTORY
        rows[pkg] = [(r["window"], r["start_ts"], r["end_ts"], r["events"], r["digest"])
                     for r in store.list_windows(base_dir=hist, gadget="trace/exec")]
    assert rows["port"] == rows["reference"]
    assert len(rows["port"]) >= 3
    assert all(0.0 <= start < end < 100.0 for _, start, end, _, _ in rows["port"])
    assert sum(r[3] for r in rows["port"]) == BATCHES * BATCH


def test_ae_scores_replay_within_tolerance(tmp_path, monkeypatch):
    """The reference's ae recording replayed by the port, the reference's
    initial scorer weights carried into the port's instance: the sketch
    fields of every summary equal the recording's and the scores agree
    within 5%. The port's own ae recording replays digest for digest."""
    carried = {}
    orig_ref = R.TpuSketch.instantiate

    def ref_inst(self, ctx, gadget, params):
        inst = orig_ref(self, ctx, gadget, params)
        if inst.scorer is not None:
            carried.setdefault("params", jax.tree.map(np.array, inst.scorer.params))
        return inst

    monkeypatch.setattr(R.TpuSketch, "instantiate", ref_inst)
    jref = record("reference", str(tmp_path / "ref"), planes=AE)
    ref = replay("reference", jref)
    orig_port = P.TpuSketch.instantiate

    def port_inst(self, ctx, gadget, params):
        inst = orig_port(self, ctx, gadget, params)
        params_from_numpy(inst.scorer, carried["params"])
        return inst

    monkeypatch.setattr(P.TpuSketch, "instantiate", port_inst)
    got = replay("port", jref)
    assert ref.digests_match and len(got.summaries) == len(ref.summaries) == 5
    for g, w in zip(got.summaries, ref.summaries):
        for f in ("events", "drops", "distinct", "entropy", "epoch", "heavy_hitters"):
            assert g[f] == w[f], f
        assert list(g["anomaly"]) == list(w["anomaly"]) and len(g["anomaly"]) > 0
        gs, ws = np.array(list(g["anomaly"].values())), np.array(list(w["anomaly"].values()))
        assert (np.abs(gs - ws) <= 5e-2 * np.abs(ws)).all(), (gs, ws)
    assert _keys(got.alerts) == _keys(ref.alerts)
    monkeypatch.setattr(P.TpuSketch, "instantiate", orig_port)
    jport = record("port", str(tmp_path / "port"), planes=AE)
    own = replay("port", jport)
    assert own.digests_match and own.alerts_match
    assert all(s["anomaly"] for s in own.summaries)


# -- the recording manager and iter_journals ------------------------------------------

@pytest.mark.parametrize("bad", ["", ".", "..", "a/b", "/abs", "../up"])
def test_recording_ids_are_validated_like_the_reference(bad):
    msgs = []
    for mod in (RC.manager, PC.manager):
        with pytest.raises(ValueError) as e:
            mod.validate_recording_id(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_manager_round_trip(tmp_path):
    """start → a journal per run → describe/list → stop → list/inspect, in
    the port's manager; the reference's manager reads the stopped
    recording to the same stats."""
    base = str(tmp_path / "recs")
    mgr = PC.RecordingManager()
    mgr.set_base_dir(base)
    rec = mgr.start("demo", retention_bytes=0)
    with pytest.raises(ValueError, match="already active"):
        mgr.start("demo")
    for run in ("r1", "r2"):
        w = rec.writer_for(node="n0", gadget="trace/exec", run_id=run,
                           params={"operator.tpusketch.enable": "true"}, platform="cpu")
        assert rec.writer_for(node="n0", gadget="trace/exec", run_id=run) is w
        w.append(PW.EV_ALERT, {"alert": {"rule": "r", "transition": "firing"}})
    rec.release(node="n0", run_id="r2")
    (active,) = mgr.list()
    assert active["state"] == "recording" and list(active["open_journals"]) == ["n0--r1"]
    assert mgr.inspect("demo")["state"] == "recording"
    meta = mgr.stop("demo")
    assert meta["journals"] == ["n0--r1", "n0--r2"] and meta["opts"] == {"retention_bytes": 0}
    with pytest.raises(KeyError):
        mgr.stop("demo")
    with pytest.raises(ValueError, match="already exists"):
        mgr.start("demo")
    (stopped,) = mgr.list()
    assert stopped["state"] == "stopped" and stopped["path"] == os.path.join(base, "demo")
    got = mgr.inspect("demo")
    ref_mgr = RC.RecordingManager()
    want = ref_mgr.inspect("demo", base_dir=base)
    assert got["state"] == want["state"] == "stopped" and got["meta"] == want["meta"]
    assert got["journals"] == want["journals"]
    by_type = {name: s["by_type"] for name, s in got["journals"].items()}
    # recording-start, the alert, then run-end (released) or recording-stop
    assert by_type == {"n0--r1": {"8": 2, "7": 1}, "n0--r2": {"8": 2, "7": 1}}
    manifest = PC.JournalReader(os.path.join(base, "demo", "n0--r1")).manifest
    assert manifest["platform"] == "cpu" and manifest["recording_id"] == "demo"
    with pytest.raises(FileNotFoundError):
        mgr.inspect("absent")


def test_iter_journals_over_a_journal_a_recording_and_a_bundle(recordings, tmp_path):
    jpath = recordings["port"][0]
    recording = tmp_path / "rec"
    bundle = tmp_path / "bundle"
    for i in range(2):
        shutil.copytree(jpath, recording / f"n{i}--run")
        shutil.copytree(jpath, bundle / f"n{i}" / "run")
    (bundle / "bundle.json").write_text("{}")
    for path in (jpath, str(recording), str(bundle), str(tmp_path / "absent")):
        assert list(PC.iter_journals(path)) == list(RC.iter_journals(path))
    assert list(PC.iter_journals(jpath)) == [jpath]
    assert [os.path.relpath(j, bundle) for j in PC.iter_journals(str(bundle))] == \
        ["n0/run", "n1/run"]
    assert len(list(PC.iter_journals(str(recording)))) == 2


def test_replay_source_hands_out_the_recorded_batches(recordings):
    src = PC.ReplaySource(recordings["port"][0])
    ref = RC.ReplaySource(recordings["port"][0])
    assert len(src) == len(ref) == BATCHES and src.digest == ref.digest
    seqs = [src.generate().seq for _ in range(BATCHES)]
    assert seqs == [i * BATCH for i in range(BATCHES)] and src.exhausted()
    assert src.generate().count == 0
    src.reset()
    assert src.pop().count == BATCH
    looped = PC.ReplaySource(recordings["port"][0], cycle=True)
    assert sum(looped.generate().count for _ in range(BATCHES + 3)) == (BATCHES + 3) * BATCH
    assert not looped.exhausted()


def test_replay_on_cuda_without_a_card_raises(recordings):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available\\(\\) is false"):
        PC.replay_journal(recordings["port"][0])


def test_replay_passes_over_params_the_port_lacks(recordings):
    """The reference's manifest carries its localmanager's params (and its
    own capture params, which replay strips): the port's chain takes the
    params it has, the localmanager's and kubemanager's too, and passes
    over the rest (here one of an operator neither package has)."""
    manifest = RC.JournalReader(recordings["reference"][0]).manifest
    assert any(k.startswith("operator.localmanager.") for k in manifest["params"])
    manifest = {**manifest, "params": {**manifest["params"], "operator.ghost.knob": "1"}}
    from inspektor_gadget_tpu_torch.capture.replay import _ReplayDesc, _replay_op_params
    col = _replay_op_params(manifest, _ReplayDesc(None, None, 0.0, None), None)
    assert sorted(col) == ["operator.alerts.", "operator.capture.", "operator.kubemanager.",
                           "operator.localmanager.", "operator.tpusketch."]
    for key in ("containername", "host"):
        assert (col["operator.localmanager."].get(key).as_string()
                == manifest["params"][f"operator.localmanager.{key}"])
    assert col["operator.tpusketch."].get("harvest-interval").as_string() == "1h"
    assert col["operator.capture."].get("dir").as_string() == ""
    assert col["operator.alerts."].get("rules").as_string() == RULES


# -- the CLI in-process ----------------------------------------------------------------

def test_cli_record_inspect_replay_and_alerts_test(recordings, tmp_path, capsys):
    jpath = recordings["reference"][0]
    cap = os.path.dirname(jpath)
    assert cli.main(["record", "inspect", jpath]) == 0
    got = json.loads(capsys.readouterr().out)
    assert ref_cli.main(["record", "inspect", jpath]) == 0
    assert got == json.loads(capsys.readouterr().out)
    assert got["by_type"][str(PW.EV_BATCH_NPZ)] == BATCHES and got["losses"] == []
    assert cli.main(["record", "inspect", cap]) == 0
    assert list(json.loads(capsys.readouterr().out)["journals"]) == [jpath]

    over = ["--device", "cpu"]
    assert cli.main(["replay", cap, "--verify", "-o", "json", *over]) == 0
    (rep,) = json.loads(capsys.readouterr().out)
    assert rep["digests_match"] and rep["alerts_match"] and rep["batches"] == BATCHES
    assert cli.main(["replay", cap, "--verify", *over]) == 0
    out = capsys.readouterr().out
    assert "verify=ok" in out and "!! busy -> firing" in out

    rules = tmp_path / "rules.json"
    rules.write_text(RULES)
    assert cli.main(["alerts", "rules", "--file", str(rules)]) == 0
    assert "4 rule(s) ok" in capsys.readouterr().out
    assert cli.main(["alerts", "test", "--file", str(rules), "--journal", cap]) == 0
    port_out = capsys.readouterr().out
    assert ref_cli.main(["alerts", "test", "--file", str(rules), "--journal", cap]) == 0
    assert port_out == capsys.readouterr().out
    assert "busy -> firing" in port_out and "1 journal(s), 5 summaries" in port_out

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"id": "x", "kind": "threshold", "field": "nope",
                                "threshold": 1}]))
    assert cli.main(["alerts", "rules", "--file", str(bad)]) == 2
    assert "unknown summary field" in capsys.readouterr().err
    assert cli.main(["alerts", "test", "--file", str(rules)]) == 2
    assert "exactly one of --journal or --summaries" in capsys.readouterr().err
    assert cli.main(["replay", str(tmp_path / "none"), *over]) == 2
    capsys.readouterr()


def test_cli_record_lifecycle_on_this_process(tmp_path, capsys):
    PC.RECORDINGS.set_base_dir(str(tmp_path))
    try:
        assert cli.main(["record", "list"]) == 0
        assert capsys.readouterr().out.strip() == "no recordings"
        assert cli.main(["record", "start", "--id", "live", "--retention-bytes", "0"]) == 0
        assert "recording live started (local)" in capsys.readouterr().out
        assert cli.main(["record", "start", "--id", "live"]) == 2
        assert "already active" in capsys.readouterr().err
        assert cli.main(["record", "list", "-o", "json"]) == 0
        (row,) = json.loads(capsys.readouterr().out)["local"]
        assert row["id"] == "live" and row["state"] == "recording"
        assert cli.main(["record", "inspect", "live"]) == 0
        assert json.loads(capsys.readouterr().out)["state"] == "recording"
        assert cli.main(["record", "stop", "--id", "live"]) == 0
        assert "stopped: 0 journal(s)" in capsys.readouterr().out
        assert cli.main(["record", "stop", "--id", "live"]) == 2
        assert cli.main(["record", "inspect", "nothing-here"]) == 2
        capsys.readouterr()
        assert cli.main(["alerts", "list", "-o", "json"]) == 0
        assert "local" in json.loads(capsys.readouterr().out)
    finally:
        PC.RECORDINGS.stop_all()
        PC.RECORDINGS.set_base_dir(None)
