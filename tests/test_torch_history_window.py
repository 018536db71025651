"""The port's sealed windows (`history/window.py`) against the JAX
package's, on random windows with slices made with numpy from a seed.

Both modules are host numpy, so everything must be equal exactly:
`window_digest` strings, `encode_window` headers and payload bytes (the
npz's zip entries carry the wall clock, pinned here), decoded windows,
slice sketches, and every field and answer of `merge_windows` over
windows that disagree in geometry and in the planes they carry.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

from inspektor_gadget_tpu.history import window as RW
from inspektor_gadget_tpu.ops.accuracy import ShadowSample as RShadow
from inspektor_gadget_tpu_torch.history import window as PW
from inspektor_gadget_tpu_torch.ops.accuracy import ShadowSample as PShadow


@pytest.fixture(autouse=True)
def _pinned_wall_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


def _slices(rng, n_slices: int) -> tuple[dict, dict]:
    """The same slices built by each package's SliceSketch."""
    out_p, out_r = {}, {}
    for i in range(n_slices):
        key = f"mntns:{100 + i}" if i % 3 else f"mntns:{100 + i}|kind:{i % 4}"
        n = int(rng.integers(1, 400))
        hh = np.minimum(rng.zipf(1.3, n), 90).astype(np.uint32) * np.uint32(40503)
        ds = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        dt = rng.integers(0, 50, n).astype(np.uint32)
        sp, sr = PW.SliceSketch(), RW.SliceSketch()
        sp.update(hh, ds, dt)
        sr.update(hh, ds, dt)
        assert sp.events == sr.events and sp.hh == sr.hh
        assert np.array_equal(sp.hll, sr.hll) and np.array_equal(sp.ent, sr.ent)
        assert PW.slice_hll_estimate(sp.hll) == RW.slice_hll_estimate(sr.hll)
        assert PW.entropy_bits(sp.ent) == RW.entropy_bits(sr.ent)
        for s, out in ((sp, out_p), (sr, out_r)):
            out[key] = {"events": s.events, "hll": s.hll, "ent": s.ent, "hh": s.sealed_hh()}
    return out_p, out_r


def _window_kwargs(rng, i: int, *, depth=3, log2_width=8, inv=True, qt=True, rs=True,
                   rs_capacity=32, level=0, approx=False) -> dict:
    w, k = 1 << log2_width, 8
    kw = dict(
        gadget="trace/exec", node=f"n{i % 2}", run_id=f"run-{i}", window=i + 1,
        start_ts=1000.0 + 10 * i, end_ts=1010.0 + 10 * i,
        events=int(rng.integers(100, 10_000)), drops=int(rng.integers(0, 5)),
        cms=rng.integers(0, 500, (depth, w)).astype(np.int32),
        hll=rng.integers(0, 12, 256).astype(np.int32),
        ent=rng.integers(0, 300, 64).astype(np.float32),
        topk_keys=rng.integers(0, 2**32, k, dtype=np.uint64).astype(np.uint32),
        topk_counts=np.sort(rng.integers(1, 900, k))[::-1].astype(np.int64),
        names={int(rng.integers(1, 2**32)): f"cmd{i}"}, slices_dropped=int(i % 3),
        level=level, approx=approx)
    kw["topk_keys"][-1] = 0  # an empty candidate slot
    if level:
        kw["compacted_from"] = [{"digest": f"d{i}", "seq": i, "window": i, "run_id": "r",
                                 "start_ts": 1.0, "end_ts": 2.0, "level": level - 1}]
    if inv:
        kw.update(inv_count=rng.integers(0, 40, (3, 64)).astype(np.int32),
                  inv_keysum=rng.integers(0, 2**32, (3, 64), dtype=np.uint64).astype(np.uint32),
                  inv_fpsum=rng.integers(0, 2**32, (3, 64), dtype=np.uint64).astype(np.uint32))
    if qt:
        kw.update(qt_counts=rng.integers(0, 30, 128).astype(np.int32),
                  qt_zeros=int(rng.integers(0, 50)), qt_total=int(rng.integers(3000, 4000)),
                  qt_alpha=0.01, qt_min_value=1.0)
    if rs:
        keys = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
        s = RShadow(rs_capacity)
        s.update(keys, rng.integers(1, 4, 500))
        kw.update(rs_keys=s.keys, rs_weights=s.weights, rs_capacity=rs_capacity)
    return kw


def _pair(rng, i: int, n_slices: int = 4, **opts):
    kw = _window_kwargs(rng, i, **opts)
    sp, sr = _slices(rng, n_slices)
    p = PW.SealedWindow(**kw, slices=sp)
    r = RW.SealedWindow(**kw, slices=sr)
    return p, r


def _same_window(p, r) -> None:
    for f in dataclasses.fields(RW.SealedWindow):
        a, b = getattr(p, f.name), getattr(r, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif f.name == "slices":
            assert set(a) == set(b)
            for key in b:
                for part in ("events", "hh"):
                    assert a[key][part] == b[key][part]
                for part in ("hll", "ent"):
                    assert a[key][part].dtype == b[key][part].dtype
                    assert np.array_equal(a[key][part], b[key][part])
        else:
            assert a == b, f.name


@pytest.mark.parametrize("opts", [
    {}, dict(inv=False, qt=False, rs=False), dict(level=2, approx=True),
    dict(qt=False, n_slices=0), dict(rs_capacity=8, inv=False)])
def test_window_encode_decode_digest_match_the_reference(opts):
    rng = np.random.default_rng(len(str(opts)))
    p, r = _pair(rng, 3, **opts)
    assert PW.window_digest(p) == RW.window_digest(r)
    p.digest = PW.window_digest(p)
    r.digest = RW.window_digest(r)
    (ph, pb), (rh, rb) = PW.encode_window(p), RW.encode_window(r)
    assert ph == rh and pb == rb
    pd, rd = PW.decode_window(ph, pb), RW.decode_window(rh, rb)
    _same_window(pd, rd)
    assert PW.window_digest(pd) == p.digest
    assert PW.provenance_row(pd) == RW.provenance_row(rd)
    for q in (dict(start_ts=1030.0), dict(end_ts=999.0), dict(key="mntns:101"),
              dict(start_seq=2, end_seq=5), dict(key="kind:9")):
        assert PW.header_overlaps(ph, **q) == RW.header_overlaps(rh, **q)


def _same_merged(p, r) -> None:
    for f in dataclasses.fields(RW.MergedWindows):
        a, b = getattr(p, f.name), getattr(r, f.name)
        if f.name == "rs":
            assert (a is None) == (b is None)
            if b is not None:
                assert a.capacity == b.capacity and np.array_equal(a.keys, b.keys)
                assert np.array_equal(a.weights, b.weights)
        elif isinstance(b, np.ndarray) or b is None and isinstance(a, np.ndarray):
            assert b is not None and a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif f.name == "slices":
            assert set(a) == set(b)
            for key in b:
                assert a[key]["events"] == b[key]["events"] and a[key]["hh"] == b[key]["hh"]
                assert np.array_equal(a[key]["hll"], b[key]["hll"])
                assert np.array_equal(a[key]["ent"], b[key]["ent"])
        else:
            assert a == b, f.name


@pytest.mark.parametrize("mix", ["uniform", "mixed planes", "mixed geometry"])
def test_merge_windows_matches_the_reference(mix):
    rng = np.random.default_rng({"uniform": 1, "mixed planes": 2, "mixed geometry": 3}[mix])
    pairs = []
    for i in range(6):
        opts = {}
        if mix == "mixed planes":
            opts = [dict(), dict(inv=False), dict(qt=False), dict(rs=False),
                    dict(rs_capacity=16), dict(approx=True)][i]
        elif mix == "mixed geometry" and i in (2, 4):
            opts = dict(log2_width=9) if i == 2 else dict(depth=4)
        pairs.append(_pair(rng, i, n_slices=3, **opts))
    # one slice of mismatched geometry
    pairs[1][0].slices["odd"] = {"events": 2, "hll": np.ones(256, np.uint8),
                                 "ent": np.ones(64, np.int64), "hh": [(5, 2)]}
    pairs[1][1].slices["odd"] = dict(pairs[1][0].slices["odd"])
    pairs[3][0].slices["odd"] = {"events": 1, "hll": np.zeros(16, np.uint8),
                                 "ent": np.zeros(64, np.int64), "hh": []}
    pairs[3][1].slices["odd"] = dict(pairs[3][0].slices["odd"])
    mp = PW.merge_windows(p for p, _ in pairs)
    mr = RW.merge_windows(r for _, r in pairs)
    _same_merged(mp, mr)
    assert mp.distinct() == mr.distinct() and mp.entropy_bits() == mr.entropy_bits()
    assert mp.heavy_hitters(5) == mr.heavy_hitters(5)
    assert mp.quantile_answer() == mr.quantile_answer()
    q = [0.5, 0.99]
    assert np.array_equal(np.asarray(mp.quantile(q)), np.asarray(mr.quantile(q)), equal_nan=True)
    hp, hr = mp.histogram_log2(), mr.histogram_log2()
    assert (hp is None and hr is None) or np.array_equal(hp, hr)
    assert mp.heavy_flows(top=10) == mr.heavy_flows(top=10)
    dp, dr = mp.heavy_flow_decode(), mr.heavy_flow_decode()
    assert (dp is None and dr is None) or dataclasses.asdict(dp) == dataclasses.asdict(dr)
    assert mp.accuracy() == mr.accuracy()
    for key in list(mr.slices)[:3] + ["absent"]:
        assert mp.slice_answer(key) == mr.slice_answer(key)
    sp = PW.merged_to_sealed(mp, gadget="trace/exec", node="n0", level=1, window=9,
                             run_id="r", compacted_from=[PW.provenance_row(pairs[0][0])])
    sr = RW.merged_to_sealed(mr, gadget="trace/exec", node="n0", level=1, window=9,
                             run_id="r", compacted_from=[RW.provenance_row(pairs[0][1])])
    assert sp.digest == sr.digest
    assert PW.encode_window(sp) == RW.encode_window(sr)


def test_merged_shadow_is_the_port_sample():
    """The merged shadow sample is the port's own ShadowSample class."""
    rng = np.random.default_rng(4)
    m = PW.merge_windows([_pair(rng, i)[0] for i in range(2)])
    assert isinstance(m.rs, PShadow)
