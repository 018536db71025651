"""The port's stage-segmented harness (`perf/harness.py run_harness`) on
the CPU against the JAX package's (`inspektor_gadget_tpu/perf/harness.py`)
at the `tiny` config: for each arm (fused, classic, sharded over two CPU
lanes, invertible, quantiles, replay) the record validates under both
packages' validators and carries the reference's stage names, stage
keys, `extra` keys, config, metric and unit; the sharded arm's harvested
digest is the single-lane fold of the batches its lanes took; the
argument errors are the reference's. Timing belongs on the card
(`chip_smoke.py` phase 5o): no rate is compared here.
"""

from __future__ import annotations

import json
import re

import numpy as np
import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401 — before capture (a circular import)
from inspektor_gadget_tpu.perf import harness as RH
from inspektor_gadget_tpu.perf import schema as RS
from inspektor_gadget_tpu_torch.ops import sketches as S
from inspektor_gadget_tpu_torch.perf import harness as PH
from inspektor_gadget_tpu_torch.perf import schema as PS

from _torch_perf import probe_state  # noqa: F401 — autouse

torch.set_num_threads(2)

LANES = ["cpu", "cpu"]
ARMS = {
    "fused": {},
    "classic": {"pipeline": "classic"},
    "sharded": {"pipeline": "sharded", "chips": 2},
    "invertible": {"invertible": True},
    "quantiles": {"quantiles": True},
}
# stages that run only at harvest ticks, which a short window may not reach
TICK_STAGES = {"harvest", "inv_decode"}
WINDOW = 0.4


def port_run(**kw) -> dict:
    if kw.get("pipeline") == "sharded":
        kw.setdefault("lanes", LANES)
    return PH.run_harness("tiny", device="cpu", seconds=WINDOW, **kw)


def ref_run(**kw) -> dict:
    return RH.run_harness("tiny", platform="cpu", seconds=WINDOW, **kw)


def _impl_free(pipeline: str) -> str:
    """extra.pipeline without the source implementation that ran (the
    native library or the Python fallback, per host)."""
    return re.sub(r"\((native|py-fold|py|replay)\)", "(src)", pipeline)


def assert_same_shape(got: dict, want: dict) -> None:
    for r in (got, want):
        assert PS.validate_record(r) == [] and RS.validate_record(r) == []
    for key in ("config", "metric", "unit", "direction", "schema"):
        assert got[key] == want[key], key
    assert set(got["extra"]) == set(want["extra"])
    assert _impl_free(got["extra"]["pipeline"]) == _impl_free(want["extra"]["pipeline"])
    assert set(got["stages"]) - TICK_STAGES == set(want["stages"]) - TICK_STAGES
    for name in set(got["stages"]) & set(want["stages"]):
        assert set(got["stages"][name]) == set(want["stages"][name]), name
    assert set(got["provenance"]) == set(want["provenance"])
    assert set(got["provenance"]["probe"]) == set(want["provenance"]["probe"])
    assert got["provenance"]["platform"] == want["provenance"]["platform"] == "cpu"
    assert got["provenance"]["degraded"] is False


@pytest.fixture(scope="module")
def ref_records():
    return {arm: ref_run(**kw) for arm, kw in ARMS.items()}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_each_arm_records_the_references_shape(arm, ref_records):
    got = port_run(**ARMS[arm])
    assert_same_shape(got, ref_records[arm])
    ex = got["extra"]
    assert got["value"] > 0 and ex["steps"] > 0
    assert got["provenance"]["probe"]["outcome"] == "ok"
    assert ex["requested_platform"] == "cpu"
    if ex["steps"] >= PH.HARNESS_CONFIGS["tiny"]["harvest_every"]:
        assert "harvest" in got["stages"]
    if arm == "sharded":
        assert ex["chips"] == 2 and ex["lane_batch"] * 2 == ex["batch"]
        assert ex["events"] == ex["steps"] * ex["batch"]
        assert got["value"] == pytest.approx(ex["per_chip_ev_per_s"] * 2)
        assert "per_chip_ev_per_s x chips" in ex["aggregation"]
    else:
        assert ex["events"] == ex["steps"] * ex["batch"] - ex["drops"]
        assert 0.0 <= ex["audit_overhead"] <= 1.0
    if arm in ("fused", "invertible", "quantiles"):
        assert 0.0 <= ex["starved_fraction"] <= 1.0
        assert {"pop", "h2d"} <= set(ex["stage_lag"])
    if arm == "invertible":
        assert ex["invertible"] is True and ex["inv_geometry"] == "3x2^8"
        assert "inv_update" in got["stages"]
    if arm == "quantiles":
        assert ex["quantiles"] is True and ex["qt_geometry"] == "2048@alpha0.01"
        assert "qt_update" in got["stages"]


def test_the_chrome_trace_and_the_stage_histogram(tmp_path):
    from inspektor_gadget_tpu_torch.telemetry import snapshot
    trace_out = str(tmp_path / "trace.json")
    r = port_run(pipeline="classic", trace_out=trace_out)
    assert r["trace_file"] == trace_out
    with open(trace_out) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any(str(n).startswith("perf/run/tiny") for n in names)
    assert "perf/pop" in names and "perf/bundle_update" in names
    snap = snapshot()
    assert snap['ig_perf_stage_seconds_count{stage="bundle_update"}'] >= r["extra"]["steps"]
    assert r["telemetry"]['ig_perf_runs_total{config="tiny"}'] >= 1


def _write_journal(pkg: str, path: str, counts: list[int]) -> None:
    """A journal of EventBatches of the given counts, written by `pkg`'s
    own journal writer and batch encoding."""
    if pkg == "port":
        from inspektor_gadget_tpu_torch.agent import wire
        from inspektor_gadget_tpu_torch.capture import JournalWriter, build_manifest
        from inspektor_gadget_tpu_torch.sources.synthetic import PySyntheticSource
    else:
        from inspektor_gadget_tpu.agent import wire
        from inspektor_gadget_tpu.capture import JournalWriter, build_manifest
        from inspektor_gadget_tpu.sources.synthetic import PySyntheticSource
    src = PySyntheticSource(seed=7, vocab=300)
    w = JournalWriter(path, manifest=build_manifest(gadget="trace/exec", node="n0"))
    for n in counts:
        w.append(wire.EV_BATCH_NPZ, {}, wire.encode_batch(src.generate(n)))
    w.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_replay_of_a_journal_either_package_wrote(writer, tmp_path):
    from inspektor_gadget_tpu.capture import JournalReader as RefReader
    from inspektor_gadget_tpu_torch.capture import JournalReader
    counts = [2048, 2048, 1500, 2048, 1024]
    jpath = str(tmp_path / "journal")
    _write_journal(writer, jpath, counts)
    digest = JournalReader(jpath).digest()
    assert digest == RefReader(jpath).digest()
    want = ref_run(replay=jpath)
    for kw in ({}, {"pipeline": "classic"}):
        got = port_run(replay=jpath, **kw)
        if not kw:
            assert_same_shape(got, want)
        assert got["provenance"]["replay"] == {"journal": jpath, "digest": digest,
                                               "batches": len(counts)}
        assert got["provenance"]["replay"] == want["provenance"]["replay"]
        ex = got["extra"]
        assert ex["replay_digest"] == digest and ex["batch"] == max(counts)
        assert ex["events"] == sum(counts[i % len(counts)] for i in range(ex["steps"]))
        assert "(replay)" in ex["pipeline"]


def test_the_sharded_harvest_is_the_single_lane_fold(monkeypatch):
    """Every harvest digest of the sharded arm equals the digest of one
    lane folding, in round and lane order, the batches the lanes took
    up to it. The vocabulary is cut under top-k's k, where the merged
    top-k is lane-count invariant (as in tests/test_torch_sharded_ingest.py)."""
    cfg = PH.HARNESS_CONFIGS["tiny"]
    monkeypatch.setattr(PH, "VOCAB", 6)
    rounds: list[list[tuple[torch.Tensor, torch.Tensor]]] = []
    digests: list[tuple[int, np.ndarray]] = []
    make_step, make_harvest = S.make_bundle_ingest_sharded, S.make_bundle_harvest_sharded

    def spy_step(mesh, like):
        step = make_step(mesh, like)

        def run(lanes, hh, distinct, dist, weights, drops, values=None):
            rounds.append([(h.clone(), w.clone()) for h, w in zip(hh, weights)])
            return step(lanes, hh, distinct, dist, weights, drops, values)
        return run

    def spy_harvest(mesh, like):
        harvest = make_harvest(mesh, like)

        def run(lanes):
            merged = harvest(lanes)
            digests.append((len(rounds), S.bundle_digest(merged).numpy().copy()))
            return merged
        return run

    monkeypatch.setattr(S, "make_bundle_ingest_sharded", spy_step)
    monkeypatch.setattr(S, "make_bundle_harvest_sharded", spy_harvest)
    rec = port_run(pipeline="sharded", chips=2)
    assert rec["extra"]["steps"] >= cfg["harvest_every"], "no harvest in the window"
    assert len(digests) == 1 + rec["extra"]["steps"] // cfg["harvest_every"]  # with the warm-up's
    single = S.bundle_init(depth=cfg["depth"], log2_width=cfg["log2_width"], hll_p=cfg["hll_p"],
                           entropy_log2_width=cfg["entropy_log2_width"], k=cfg["k"],
                           device="cpu")
    done = 0
    for n_rounds, digest in digests:
        for lanes in rounds[done:n_rounds]:
            for hh, w in lanes:
                S.bundle_ingest_step(single, hh, hh, hh, w)
        done = n_rounds
        assert np.array_equal(S.bundle_digest(single).numpy(), digest), n_rounds
    assert S.decode_digest(digests[-1][1])[0] == done * cfg["batch"]


def test_argument_errors_are_the_references():
    cases = [
        (dict(config="nope"), "unknown harness config"),
        (dict(pipeline="warp"), "unknown pipeline"),
        (dict(pipeline="fused", chips=2), "needs pipeline=sharded"),
        (dict(pipeline="sharded", replay="j"), "does not take --replay"),
        (dict(pipeline="sharded", chips=2, invertible=True), "single-chip"),
        (dict(pipeline="classic", quantiles=True), "fused arm"),
    ]
    for kw, frag in cases:
        config = kw.pop("config", "tiny")
        with pytest.raises(ValueError) as got:
            PH.run_harness(config, device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            RH.run_harness(config, platform="cpu", **kw)
        assert str(got.value) == str(want.value) and frag in str(got.value)
    with pytest.raises(ValueError, match=r"chips=99 out of range for this host \(2 local"):
        PH.run_harness("tiny", device="cpu", pipeline="sharded", chips=99, lanes=LANES)
    with pytest.raises(ValueError, match=r"chips=2 out of range for this host \(1 local"):
        PH.run_harness("tiny", device="cpu", pipeline="sharded", chips=2)
    with pytest.raises(ValueError, match="not divisible by chips=3"):
        PH.run_harness("tiny", device="cpu", pipeline="sharded", chips=3, lanes=["cpu"] * 3)


def test_cuda_without_a_card_raises_before_any_work():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available.. is false"):
        PH.run_harness("tiny")


def test_a_loop_that_ran_a_plain_version_on_the_card_raises(monkeypatch):
    """On a CUDA device each loop must have launched its kernel once a
    step (a lane): a wrapper that fell back to its plain version shows
    as a missing launch."""
    from inspektor_gadget_tpu_torch.ops import kernels as K
    cuda = torch.device("cuda")
    before = PH._launches()
    monkeypatch.setattr(K.fused_planes, "launches", K.fused_planes.launches + 3)
    PH._require_launches(cuda, before, 3, 0, "the fused arm")
    with pytest.raises(RuntimeError, match="the fused arm: launched K2 3 and K1 0 times, "
                                           "expected K2 4 and K1 0"):
        PH._require_launches(cuda, before, 4, 0, "the fused arm")
    PH._require_launches(torch.device("cpu"), before, 4, 0, "the fused arm")  # the CPU: no check
