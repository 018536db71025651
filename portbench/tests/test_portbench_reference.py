"""The plain reference on hand-checked streams, the comparison's
rejection of a changed count, the control and the faults, and K2's byte
count."""

import math

import numpy as np
import pytest
import torch

from conftest import HELD_CELLS, ROOT, tiny
from portbench import reference as R
from portbench import roofline
from portbench.check import compare
from portbench.harness import Run
from portbench.spec import Spec
from portbench.stream import fnv1a64_names

SPEC = Spec(ROOT / "BENCHMARK.json")
CPU = torch.device("cpu")
ALL_CELLS = [w["name"] for w in SPEC.bench["workloads"]] + HELD_CELLS


def _fold(keys, k=128, values=None, op=None):
    g = R.Geometry(dict(op or {}, topk=str(k)))
    ref = R.Reference(g, CPU)
    vals = None if values is None else torch.tensor(values, dtype=torch.int64)
    ref.fold(ref.delta(torch.tensor(keys, dtype=torch.int64), vals), 0)
    return ref


def _fnv1a64(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def test_hashes_match_published_values():
    # murmur3's finalizer, and FNV-1a-64's published vector for "a"
    assert int(R.fmix32(torch.tensor([0]))[0]) == 0
    assert int(R.fmix32(torch.tensor([1]))[0]) == 0x514E28B7
    assert _fnv1a64(b"a") == 0xAF63DC4C8601EC8C
    names = fnv1a64_names("flow-", 1200)
    for i in (0, 7, 99, 1000, 1199):
        assert int(names[i]) == _fnv1a64(f"flow-{i}".encode())
    assert int(R.fold64(np.array([0x0000000100000002], np.uint64))[0]) == 3


def test_reference_folds_a_hand_checked_stream():
    ref = _fold([7, 7, 9, 11])
    s = ref.summary()
    assert s["events"] == 4 and s["drops"] == 0
    assert s["heavy_hitters"] == [(7, 2), (9, 1), (11, 1)]
    assert s["approx"] is False
    assert all(int(row.sum()) == 4 for row in ref.cms)
    for r in range(4):
        assert int(ref.cms[r][R.bucket(torch.tensor([7]), r, 16)][0]) == 2
    # three keys in three of 4096 buckets: H(1/2, 1/4, 1/4) = 1.5 bits
    assert s["entropy_bits"] == pytest.approx(1.5, abs=1e-12)
    # linear counting over 16384 registers, 3 of them set
    m = 1 << 14
    assert s["distinct"] == pytest.approx(m * math.log(m / (m - 3)), rel=1e-12)
    assert int((ref.hll > 0).sum()) == 3


def test_top_k_keeps_the_largest_ties_to_the_smaller_key():
    ref = _fold([5, 5, 3, 4, 9, 9], k=2)
    assert ref.summary()["heavy_hitters"] == [(5, 2), (9, 2)]
    assert ref.overflow == 1
    ref.fold(ref.delta(torch.tensor([3, 3, 3]), None), 0)
    assert ref.summary()["heavy_hitters"] == [(3, 4), (5, 2)]


def test_invertible_and_quantile_planes():
    op = {"invertible": "true", "quantiles": "true"}
    ref = _fold([7, 7, 9], values=[0, 1, 100], op=op)
    assert int(ref.inv[0].sum()) == 9 and int(ref.inv[1][0].sum()) == (7 + 7 + 9)
    assert ref.qt_zeros == 1 and ref.qt_total == 3
    gamma = 1.01 / 0.99
    assert int(ref.qt[0]) == 1                       # ln 1 = 0: bucket 0
    assert int(ref.qt[math.ceil(math.log(100) / math.log(gamma))]) == 1


def _tiny_run(spec, cell):
    run = Run(spec, cell, 4242, 1.5, device="cpu", traffic_overrides=tiny(spec, cell))
    return run, run.execute()["prog"]


def _plant(monkeypatch, fault: str) -> None:
    """Break the timed path underneath the harness: the operator's step
    or what its harvest reads."""
    from inspektor_gadget_tpu_torch.operators import tpusketch as tps
    if fault == "frozen":
        def frozen(bundle, *a, **k):
            return bundle, bundle.events.clone()
        monkeypatch.setattr(tps, "bundle_ingest_step", frozen)
    elif fault == "half":
        real = tps.bundle_ingest_step

        def half(bundle, hh, distinct, dist, w, *a, **k):
            w = w.clone()
            n = int(torch.count_nonzero(w))
            w[n // 2:n] = 0
            return real(bundle, hh, distinct, dist, w, *a, **k)
        monkeypatch.setattr(tps, "bundle_ingest_step", half)
    elif fault == "answer":
        from inspektor_gadget_tpu_torch.ops import quantiles
        real_decode, real_q = tps.decode_digest, quantiles.dd_quantile_np

        def altered(digest):
            out = list(real_decode(digest))
            out[6] = out[6].copy()
            out[6][0] += 1
            return tuple(out)

        def altered_q(*a, **k):
            return real_q(*a, **k) * 1.05
        monkeypatch.setattr(tps, "decode_digest", altered)
        monkeypatch.setattr(quantiles, "dd_quantile_np", altered_q)


@pytest.mark.parametrize("cell", ["exec-sketch.rate", "tcp-full.backlog"])
def test_a_changed_count_is_rejected(cell, full_spec):
    run, prog = _tiny_run(full_spec, cell)
    ref = run.judge(prog)
    ok, rows = compare(prog, ref, run.cell["limits"])
    assert ok, rows
    bad = dict(prog, leaves=dict(prog["leaves"]))
    table = bad["leaves"]["cms.table"].copy()
    table[0, int(np.argmax(table[0]))] += 1
    bad["leaves"]["cms.table"] = table
    assert not compare(bad, ref, run.cell["limits"])[0]
    s = [dict(x) for x in prog["summaries"]]
    k, c = s[-1]["heavy_hitters"][0]
    s[-1]["heavy_hitters"] = [(k, c + 1)] + s[-1]["heavy_hitters"][1:]
    assert not compare(dict(prog, summaries=s), ref, run.cell["limits"])[0]


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_the_control_is_not_correct(cell, full_spec):
    """The reference in bfloat16 in the program's place fails the cell."""
    run, prog = _tiny_run(full_spec, cell)
    ok, rows = compare(run.judge(prog, control=True), run.judge(prog), run.cell["limits"])
    assert not ok, rows


@pytest.mark.parametrize("fault", ["frozen", "half", "answer"])
@pytest.mark.parametrize("cell", ["exec-sketch.backlog", "tcp-full.backlog"])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch, full_spec):
    """A step that leaves the state unchanged, half of each batch left
    out, a heavy-hitter count altered where the harvest reads it."""
    _plant(monkeypatch, fault)
    run, prog = _tiny_run(full_spec, cell)
    ok, rows = compare(prog, run.judge(prog), run.cell["limits"])
    assert not ok, (fault, rows)


def test_k2_bytes_at_the_production_shapes(full_spec):
    n = 1 << 17
    exec_op = SPEC.config("exec-sketch")["operator"]
    assert roofline.k2_bytes(exec_op, n) == 4 * n * 2 + 4 * (4 * 65536 + 2 * 4096 + 16384)
    tcp_op = full_spec.config("tcp-full")["operator"]
    words = 4 * 65536 + 2 * 4096 + 16384 + 3 * 3 * 4096 + 2048
    assert roofline.k2_bytes(tcp_op, n) == 4 * n * 3 + 4 * words
    assert roofline.k2_ops(exec_op, n) == n * 6 * (roofline.HASH_OPS + 1)
