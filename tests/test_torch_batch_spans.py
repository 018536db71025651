"""The port's tpusketch operator tiles its batch and its harvest into
spans, and its harvest record sums the batch's parts, on the CPU.

Under the chain's ``op/tpusketch`` span a gadget-path batch is
``tpusketch/h2d`` (holding ``tpusketch/fold`` and ``tpusketch/copy``),
``tpusketch/update`` and ``tpusketch/post``; a harvest is
``tpusketch/harvest`` over ``…/dispatch``, ``…/wait``, ``…/read``,
``…/finish`` and ``…/anomaly``. ``last_harvest_ms`` carries the parts of
the digest read and, per instance, the sums over the batches folded since
the harvest before. The card's device-completion stamps are booked here
against stand-in events, the arithmetic the card runs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from inspektor_gadget_tpu_torch.operators import operators as O
from inspektor_gadget_tpu_torch.operators import tpusketch as P
from inspektor_gadget_tpu_torch.sources.batch import EventBatch, FoldedBatch
from inspektor_gadget_tpu_torch.telemetry.tracing import TRACER

torch.set_num_threads(2)

PARTS = ("fold", "copy", "dispatch", "post")
HARVEST_PARTS = ("dispatch", "wait", "read", "finish", "anomaly")


@pytest.fixture()
def inst():
    cfg = P.SketchConfig(depth=3, log2_width=10, hll_p=8, entropy_log2_width=6, topk=8,
                         harvest_interval=3600.0)
    inst = P.TpuSketchInstance(cfg, P.SketchContext(run_id="batch-spans"), device="cpu")
    TRACER.reset()
    yield inst
    inst.post_gadget_run()
    TRACER.reset()


def _batch(rng, n: int) -> EventBatch:
    b = EventBatch.alloc(n, with_comm=False)
    b.cols["key_hash"][:] = rng.integers(1, 300, n).astype(np.uint64) * \
        np.uint64(0x9E3779B97F4A7C15)
    b.cols["ts"][:] = 1_700_000_000_000_000_000
    b.count = n
    return b


def test_a_batch_is_tiled_under_the_operator_span(inst):
    rng = np.random.default_rng(3)
    chain = O.Operators([inst])
    n_batches = 4
    for i in range(n_batches):
        chain.enrich_batch(_batch(rng, 1000 + 300 * i))
    recs = TRACER.records()
    by_id = {r.span_id: r for r in recs}
    ops = [r for r in recs if r.name == "op/tpusketch"]
    assert len(ops) == n_batches
    for op in ops:
        kids = [r for r in recs if r.parent_id == op.span_id]
        assert [r.name for r in kids] == ["tpusketch/h2d", "tpusketch/update", "tpusketch/post"]
        (h2d,) = [r for r in kids if r.name == "tpusketch/h2d"]
        inner = [r for r in recs if r.parent_id == h2d.span_id]
        assert [r.name for r in inner] == ["tpusketch/fold", "tpusketch/copy"]
        # in order, and inside the operator's span
        tiles = inner + kids[1:]
        for a, b in zip(tiles, tiles[1:]):
            assert a.start <= b.start
        assert sum(r.duration for r in tiles) <= op.duration
        assert by_id[h2d.parent_id] is op
    enrich_ms = 1e3 * sum(op.duration for op in ops)

    inst.harvest()
    h = inst.last_harvest_ms
    assert h["batches"] == n_batches
    assert all(h[k] >= 0.0 for k in PARTS)
    assert sum(h[k] for k in PARTS) <= enrich_ms
    assert h["digest_dispatch"] + h["digest_wait"] + h["digest_read"] == h["digest_decode"]
    assert "device_lag" not in h  # the card's alone
    assert h["total"] >= h["digest_decode"] + h["finish"] + h["anomaly"]
    recs = TRACER.records()
    (harvest,) = [r for r in recs if r.name == "tpusketch/harvest"]
    parts = [r.name for r in recs if r.parent_id == harvest.span_id]
    assert parts == [f"tpusketch/harvest/{p}" for p in HARVEST_PARTS]
    assert not [r for r in recs if r.name.startswith("tpusketch/stage/")]
    assert "device" not in inst._pstats.snapshot()["stages"]

    # the next record sums only the batches since this harvest
    chain.enrich_batch(_batch(rng, 500))
    inst.harvest()
    assert inst.last_harvest_ms["batches"] == 1


def test_the_folded_path_keeps_its_two_spans(inst):
    n = 3000
    pb = inst.folded_block()
    lanes = pb.numpy()
    lanes[0, :n] = np.arange(1, n + 1, dtype=np.uint32) % 97 + 1
    lanes[1, :n] = 1
    lanes[2, :n] = 7
    inst.ingest_folded(FoldedBatch(lanes=lanes, count=n, block=pb))
    assert [r.name for r in TRACER.records()] == ["tpusketch/h2d", "tpusketch/update"]
    inst.harvest()
    assert inst.last_harvest_ms["batches"] == 0


class _Event:
    """A stand-in CUDA timing event: its time on the card (ms) and
    whether it has completed."""

    def __init__(self, ms: float, done: bool = True):
        self.ms, self.done = ms, done

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, end: "_Event") -> float:
        return end.ms - self.ms


def test_completion_stamps_map_through_the_anchor(inst, monkeypatch):
    """A stamp's lag is its event's completion, placed on the host clock
    by the anchor, less its dispatch end (never below 0); stamps book in
    order up to the first that has not completed, and a backlog past
    `_STAMPS_MAX` books on the hot path."""
    inst._anchor = (_Event(1000.0), 50.0)  # event at 1000 ms was done at host 50.0 s
    inst._stamp(_Event(1004.0), 50.001)    # done at 50.004: 3 ms behind
    inst._stamp(_Event(1010.0), 50.012)    # done at 50.010: before its stamp, so 0
    late = _Event(1020.0, done=False)
    inst._stamp(late, 50.015)
    inst._book_stamps()
    assert inst._acc["device_lag"] == pytest.approx(3.0)
    assert len(inst._stamps) == 1
    stage = inst._pstats.snapshot()["stages"]["device"]
    assert stage["count"] == 2 and stage["watermark_s"] == 0.0
    monkeypatch.setattr(P, "_STAMPS_MAX", 1)
    late.done = True
    inst._stamp(_Event(1030.0), 50.020)  # two parked: past the limit, both book
    assert not inst._stamps
    assert inst._acc["device_lag"] == pytest.approx(3.0 + 5.0 + 10.0)
    assert inst._pstats.snapshot()["stages"]["device"]["count"] == 4
    inst._anchor = None  # the CPU instance's teardown harvest takes no anchor
