"""The port's top and profile gadgets against the JAX package's, on the
CPU, and the registries and catalogs of both packages whole.

The interval gadgets are fed the same inputs in both packages and
their rows must be equal, exactly: top tcp's batch fold (`_on_batch`
and `collect`) on hand-built EventBatches of the byte window, the churn
window and the synthetic stand-in; top block-io and profile block-io's
diskstats window on the same monkeypatched /proc/diskstats sequences
(profile block-io's histogram bytes equal, with and without the
quantile line); top metrics on a registry of each package seeded alike
under a pinned clock. `render_log2_hist` gives the same bytes on seeded
buckets. profile block-io's DDSketch fold on the CPU equals the
reference's `dd_update` then `dd_quantile` on the same observations:
the counts `np.array_equal`, zeros and total equal, and the same
quantile line.
"""

from __future__ import annotations

import dataclasses
import io
import types

import numpy as np
import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
import inspektor_gadget_tpu_torch.all_gadgets  # noqa: F401
from inspektor_gadget_tpu import gadgets as RG
from inspektor_gadget_tpu import telemetry as RT
from inspektor_gadget_tpu.gadgets.profile import block_io as RPB
from inspektor_gadget_tpu.gadgets.top import block_io as RTB
from inspektor_gadget_tpu.gadgets.top import metrics as RTM
from inspektor_gadget_tpu.runtime.runtime import build_catalog as ref_catalog
from inspektor_gadget_tpu.sources import batch as RB
from inspektor_gadget_tpu_torch import gadgets as PG
from inspektor_gadget_tpu_torch import telemetry as PT
from inspektor_gadget_tpu_torch.gadgets.profile import block_io as PPB
from inspektor_gadget_tpu_torch.gadgets.top import block_io as PTB
from inspektor_gadget_tpu_torch.gadgets.top import metrics as PTM
from inspektor_gadget_tpu_torch.runtime.runtime import build_catalog
from inspektor_gadget_tpu_torch.sources import batch as PB

torch.set_num_threads(2)

GADGETS_17B = [("top", "block-io"), ("top", "file"), ("top", "metrics"), ("top", "self"),
               ("top", "tcp"), ("profile", "cpu"), ("profile", "block-io"),
               ("audit", "seccomp"), ("advise", "seccomp-profile"),
               ("advise", "network-policy"), ("traceloop", "traceloop")]


def test_registry_and_catalog_hold_every_gadget_of_the_reference():
    ref = [(d.category, d.name) for d in RG.registry.get_all()]
    port = [(d.category, d.name) for d in PG.registry.get_all()]
    assert port == ref and len(port) == 30
    assert set(GADGETS_17B) <= set(port)
    want, got = ref_catalog()["gadgets"], build_catalog()["gadgets"]
    assert got == want
    for c, n in GADGETS_17B:
        assert PG.get(c, n).gadget_type.value == RG.get(c, n).gadget_type.value


def _ctx(G, category: str, name: str, port: bool, params: dict | None = None):
    desc = G.get(category, name)
    gp = desc.params().to_params()
    for k, v in (params or {}).items():
        gp.set(k, v)
    kw = {"device": "cpu"} if port else {}
    return desc, G.GadgetContext(desc, gadget_params=gp, **kw)


# -- render_log2_hist -------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_render_log2_hist_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    buckets = rng.integers(0, 5000, 32).tolist()
    buckets[:seed * 3] = [0] * (seed * 3)
    buckets[-(seed + 1) * 4:] = [0] * ((seed + 1) * 4)  # an empty tail to trim
    for b in (buckets, [0] * 32, [], [1] + [0] * 31):
        for unit in ("usecs", "msecs"):
            assert PPB.render_log2_hist(b, unit) == RPB.render_log2_hist(b, unit)


# -- top tcp ------------------------------------------------------------------------

VOCAB = {301: "10.0.0.1:443 -> 10.0.0.2:51000", 302: "127.0.0.1:5432 -> 127.0.0.1:40000"}


class _Vocab:
    def vocab_lookup(self, key: int) -> str:
        return VOCAB.get(int(key), "")


TCP_ROWS = [  # kind 21: the byte window; 4: churn (aux1 an address hash)
    {"kind": 21, "pid": 10, "key_hash": 301, "aux1": 4096, "aux2": 100},
    {"kind": 21, "pid": 10, "key_hash": 301, "aux1": 1 << 33, "aux2": 7},
    {"kind": 21, "pid": 11, "key_hash": 302, "aux1": 5, "aux2": 1 << 20},
    {"kind": 4, "pid": 12, "key_hash": 999, "aux1": 0xABCDEF1234, "aux2": 443},
    {"kind": 4, "pid": 12, "key_hash": 999, "aux1": 0x10001, "aux2": 443},
]


def _tcp_rows(G, Batch, port: bool, native: bool) -> list[list[dict]]:
    _, ctx = _ctx(G, "top", "tcp", port, {"source": "pysynthetic"})
    g = ctx.desc.new_instance(ctx)
    g._feed.source = g._feed._current_source = _Vocab()
    g._feed._is_native = native
    ticks = []
    for rep in range(2):
        b = Batch.alloc(len(TCP_ROWS))
        b.count = len(TCP_ROWS)
        for i, r in enumerate(TCP_ROWS):
            for k, v in {"mntns": 4026531840 + i, **r}.items():
                b.cols[k][i] = v
            b.comm[i, :4] = np.frombuffer(b"nc\0\0", np.uint8)
        g._on_batch(b)
        if rep:
            g._on_batch(b)
        ticks.append([dataclasses.asdict(r) for r in g.collect(ctx)])
    return ticks


@pytest.mark.parametrize("native", (True, False), ids=("native", "synthetic"))
def test_top_tcp_fold_matches_the_reference(native):
    """Two intervals; churn rows never report an address hash as bytes
    on a native source, the synthetic stand-in's aux1 low bits do."""
    want = _tcp_rows(RG, RB.EventBatch, False, native)
    got = _tcp_rows(PG, PB.EventBatch, True, native)
    assert got == want
    first = {r["conn"]: r for r in got[0]}
    assert first[VOCAB[301]]["sent"] == 4096 + (1 << 33) and first[VOCAB[301]]["events"] == 2
    churn = first["0x00000000000003e7"]
    assert churn["events"] == 2
    assert churn["sent"] == (0 if native else 0x1234 + 1)  # aux1 & 0xFFFF, synthetic only
    assert {r["events"] for r in got[1]} == {4, 2}


# -- the diskstats windows ------------------------------------------------------------

def _diskstats(seed: int, ticks: int, devices: int = 24) -> list[str]:
    """`ticks` /proc/diskstats snapshots: counters that only grow, loop and
    ram devices, a short line, and a device that appears late."""
    rng = np.random.default_rng(seed)
    state = rng.integers(0, 1000, (devices, 11))
    out = []
    for t in range(ticks):
        state += rng.integers(0, 40, state.shape) * (rng.random((devices, 1)) < 0.7)
        lines = []
        for d in range(devices if t > 2 else devices - 3):
            name = ("loop0" if d == 0 else "ram1" if d == 1 else f"sd{chr(97 + d % 26)}{d}")
            lines.append(f"   8 {d} {name} " + " ".join(str(x) for x in state[d]))
        lines.append("   7 0 short 1 2 3")
        out.append("\n".join(lines) + "\n")
    return out


def _feed_diskstats(monkeypatch, mod, snapshots: list[str], ctx=None) -> None:
    """`mod`'s open() serves the snapshots in turn for /proc/diskstats;
    serving the last cancels `ctx`."""
    left = list(snapshots)

    def fake_open(path, *a, **kw):
        assert path == "/proc/diskstats"
        text = left.pop(0) if len(left) > 1 else left[0]
        if len(left) == 1 and ctx is not None:
            ctx.cancel()
        return io.StringIO(text)

    monkeypatch.setattr(mod, "open", fake_open, raising=False)


def test_top_block_io_rows_match_the_reference(monkeypatch):
    snaps = _diskstats(5, 6)
    out = []
    for G, mod, port in ((RG, RTB, False), (PG, PTB, True)):
        _feed_diskstats(monkeypatch, mod, snaps)
        desc, ctx = _ctx(G, "top", "block-io", port)
        g = desc.new_instance(ctx)
        g.setup(ctx)
        out.append([[dataclasses.asdict(r) for r in g.collect(ctx)] for _ in range(4)])
    assert out[1] == out[0]
    assert sum(len(t) for t in out[1]) > 20 and all(r["device"] not in ("loop0", "ram1")
                                                    for t in out[1] for r in t)


@pytest.mark.parametrize("quantiles", ("false", "true"))
def test_profile_block_io_diskstats_matches_the_reference(quantiles, monkeypatch):
    """20 ticks of 21 devices: more than 256 observations, so the fold
    flushes mid-run as well as at its end."""
    snaps = _diskstats(6, 21)
    out = []
    for G, mod, port in ((RG, RTB, False), (PG, PTB, True)):
        desc, ctx = _ctx(G, "profile", "block-io", port,
                         {"window": "diskstats", "quantiles": quantiles})
        _feed_diskstats(monkeypatch, mod, snaps, ctx)
        out.append(desc.new_instance(ctx).run_with_result(ctx))
    assert out[1] == out[0]
    assert b"degraded" in out[1] and b"-> " in out[1]
    assert (b"p50=" in out[1]) == (quantiles == "true")


# -- the DDSketch fold ------------------------------------------------------------------

def _latencies(seed: int, n: int) -> list[tuple[float, int]]:
    rng = np.random.default_rng(seed)
    us = np.maximum(rng.lognormal(5.0, 1.5, n).astype(np.int64), 1)
    w = rng.integers(1, 40, n)
    return [(int(u) / 1e6, int(k)) for u, k in zip(us, w)]


@pytest.mark.parametrize("seed", (0, 1))
def test_profile_block_io_fold_matches_the_reference(seed):
    """The gadget's `_fold` in chunks of its flush size, then its
    quantile line: counts with np.array_equal, zeros, total and the
    line exactly."""
    obs = _latencies(seed, 2000)
    sketches, lines = [], []
    for G, port in ((RG, False), (PG, True)):
        desc, ctx = _ctx(G, "profile", "block-io", port, {"quantiles": "true"})
        g = desc.new_instance(ctx)
        sk = None
        for i in range(0, len(obs), g._FLUSH):
            sk = g._fold(sk, obs[i:i + g._FLUSH])
        sketches.append(sk)
        lines.append(g._quantile_summary(sk))
    ref, port = sketches
    assert port.counts.device.type == "cpu"
    assert np.array_equal(port.counts.numpy(), np.asarray(ref.counts))
    assert int(port.zeros) == int(ref.zeros) and int(port.total) == int(ref.total)
    assert int(port.total) == sum(w for _, w in obs)
    assert lines[1] == lines[0] and b"p50=" in lines[1]


def test_profile_block_io_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    desc, ctx = _ctx(PG, "profile", "block-io", True, {"quantiles": "true"})
    ctx.device = "cuda"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        desc.new_instance(ctx)


# -- top metrics --------------------------------------------------------------------------

def _seed_registry(T) -> object:
    reg = T.Registry()
    c = reg.counter("ig_demo_events_total", "demo", ("gadget",))
    g = reg.gauge("ig_demo_depth", "demo")
    h = reg.histogram("ig_demo_seconds", "demo", buckets=(0.1, 1.0))
    c.labels(gadget="trace/exec").inc(10)
    g.set(3)
    h.observe(0.5)
    return reg, c, g, h


def test_top_metrics_rows_match_the_reference(monkeypatch):
    """Each package's gadget over a registry of its own seeded alike,
    under a clock that advances 2 s a tick: equal rows, histogram
    buckets elided, counters as rates and gauges as levels."""
    out = []
    for G, T, mod, port in ((RG, RT, RTM, False), (PG, PT, PTM, True)):
        reg, c, g, h = _seed_registry(T)
        clock = iter(range(0, 100, 2))
        monkeypatch.setattr(mod, "REGISTRY", reg)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=lambda: float(next(clock)), time_ns=lambda: 0))
        desc, ctx = _ctx(G, "top", "metrics", port)
        gad = desc.new_instance(ctx)
        gad.setup(ctx)
        c.labels(gadget="trace/exec").inc(8)
        c.labels(gadget="trace/open").inc(4)
        g.set(5)
        h.observe(2.0)
        out.append([dataclasses.asdict(r) for r in gad.collect(ctx)])
    assert out[1] == out[0]
    rows = {(r["metric"], r["labels"]): r for r in out[1]}
    assert rows[("ig_demo_events_total", '{gadget="trace/exec"}')]["rate"] == 4.0
    assert rows[("ig_demo_depth", "")]["value"] == 5.0 and rows[("ig_demo_depth", "")]["rate"] == 0
    assert not [m for m, _ in rows if m.endswith("_bucket")]


def test_top_metrics_reads_the_ports_registry_only():
    assert PTM.REGISTRY is PT.REGISTRY and PTM.REGISTRY is not RT.REGISTRY
    desc, ctx = _ctx(PG, "top", "metrics", True)
    g = desc.new_instance(ctx)
    g.setup(ctx)
    rows = g.collect(ctx)
    want = {f"{n}{lbl}" for n, kind, lbl, _ in PT.REGISTRY.samples()
            if not (kind == "histogram" and n.endswith("_bucket"))}
    got = {f"{r.metric}{r.labels}" for r in rows}
    assert got <= want and len(got) >= len(want) - 2  # a family may be added meanwhile
