"""The port's telemetry against the JAX package's, and the staging
hooks that feed it, on the CPU.

The same calls on a fresh registry of each package must render the same
Prometheus text and snapshot; the same observations on a PipelineStats
of each the same snapshot. The port's pinned pool and H2D stager count
pool hits and misses and the transfers in flight into the registry, and
starved and saturated ticks (with the wait timed) into a PipelineStats.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from inspektor_gadget_tpu.telemetry import pipeline as RP
from inspektor_gadget_tpu.telemetry import registry as RR
from inspektor_gadget_tpu_torch.sources import H2DStager, PinnedBufferPool
from inspektor_gadget_tpu_torch.telemetry import REGISTRY, PipelineStats
from inspektor_gadget_tpu_torch.telemetry import pipeline as PP
from inspektor_gadget_tpu_torch.telemetry import registry as PR

torch.set_num_threads(2)


def _drive(mod) -> "RR.Registry":
    reg = mod.Registry()
    c = reg.counter("ig_test_events_total", "events popped", ("gadget",))
    c.labels(gadget="trace/exec").inc(3)
    c.labels(gadget='we"ird\\name\n').inc(0.5)
    g = reg.gauge("ig_test_depth", "queue depth")
    g.set(7)
    g.dec(2.25)
    reg.gauge("ig_test_live", "from a callback").set_function(lambda: 42)
    h = reg.histogram("ig_test_seconds", "a latency", ("stage",))
    for v in (0.0, 3e-6, 1e-3, 0.5, 20.0):
        h.labels(stage="pop").observe(v)
    reg.histogram("ig_test_custom", "custom buckets", buckets=(0.1, 1.0)).observe(0.3)
    return reg


def test_registry_exposition_matches_reference():
    ref, port = _drive(RR), _drive(PR)
    assert port.render_prometheus() == ref.render_prometheus()
    assert port.snapshot() == ref.snapshot()
    def events(reg):
        return next(f for f in reg.families() if f.name == "ig_test_events_total")
    assert events(port).total == events(ref).total == 3.5
    with pytest.raises(ValueError):
        port.gauge("ig_test_events_total")  # a name keeps its kind
    assert PR.DEFAULT_BUCKETS == RR.DEFAULT_BUCKETS


def test_pipeline_stats_and_lag_sketch_match_reference():
    ref, port = RP.PipelineStats("r1", "g"), PP.PipelineStats("r1", "g")
    for stats in (ref, port):
        for i, lag in enumerate((0.0, 1e-4, 2e-3, 0.05, 1.5)):
            stats.note_host_lag(lag)
            stats.note_device_lag(lag / 3, lane=i % 2)
        stats.note_starved()
        stats.note_saturated(0.25)
        stats.note_saturated(0.5, stage="pop")
        stats.note_backpressure("h2d", 2)
        stats.note_occupancy("h2d", 3)
        stats.note_round()
    assert port.snapshot() == ref.snapshot()
    rs, ps = RP.LagSketch(), PP.LagSketch()
    for v in np.random.default_rng(1).lognormal(-6, 2, 500):
        rs.add(float(v))
        ps.add(float(v))
    assert [ps.quantile(q) for q in (0.0, 0.5, 0.99, 1.0)] == \
        [rs.quantile(q) for q in (0.0, 0.5, 0.99, 1.0)]


class _PendingEvent:
    """A fence with the CUDA event's query/synchronize, pending until
    waited on."""

    def __init__(self):
        self.done = False

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        time.sleep(0.002)
        self.done = True


def test_stager_hooks_count_hits_misses_starved_and_saturated():
    lane = "t-hooks"
    hits = REGISTRY.counter("ig_ingest_pool_hits_total", labels=("lane",)).labels(lane=lane)
    misses = REGISTRY.counter("ig_ingest_pool_misses_total", labels=("lane",)).labels(lane=lane)
    inflight = REGISTRY.gauge("ig_ingest_h2d_inflight", labels=("lane",)).labels(lane=lane)
    stats = PipelineStats("stager-test")
    pool = PinnedBufferPool(16, lanes=2, max_free=4, device="cpu", lane=lane)
    st = H2DStager(pool, depth=2, device="cpu", stats=stats)
    fences = []
    for i in range(4):
        blk = pool.get()
        st.stage(blk, (blk[0], blk[1]))
        fence = _PendingEvent() if i != 1 else torch.zeros(1)  # a CPU fence has completed
        fences.append(fence)
        st.fence(fence)
    # ticks: 0, 1 free slots (starved); 2 lands on batch 0's pending fence
    # (saturated); 3 on batch 1's completed fence (starved)
    assert (stats.starved, stats.saturated) == (3, 1) and stats.stall_s >= 0.002
    assert (pool.hits, pool.misses) == (1, 3) and (hits.value, misses.value) == (1, 3)
    assert st.inflight == 2 and inflight.value == 2
    assert stats.snapshot()["occupancy"] == {"h2d:0": 2.0}
    st.drain()
    assert inflight.value == 0 and st.inflight == 0 and pool.free_blocks() == 3
    assert stats.snapshot()["occupancy"] == {"h2d:0": 0.0} and fences[2].done
    text = REGISTRY.render_prometheus()
    assert f'ig_ingest_pool_misses_total{{lane="{lane}"}} 3' in text
