"""The port's standing queries (`queries.spec`, `queries.cache`,
`queries.engine`) against the reference's, on the CPU.

`load_queries` accepts and refuses the same documents with the same
messages, through PyYAML and through its JSON fallback (the path taken
where PyYAML is missing, as on the card's machine). The two-stack
`SlidingFold` seals, at every tick, to the digest of a flat fold over
the windows it covers and of the reference's fold. A
`StandingQueryEngine` of each package, fed the same seeded windows (the
npz's zip entries pinned), publishes the same headers and payload bytes
at every seal, each answer equal to an ad-hoc `answer_query` over the
windows in its range, and the standing answer still equals the ad-hoc
one over a compacted range. The result caches count the same hits,
misses and invalidations. Through the operator, the port's instance
publishes at each seal what the same query over its store answers.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import pytest
import torch

from inspektor_gadget_tpu import history as RH
from inspektor_gadget_tpu import queries as RQ
from inspektor_gadget_tpu.perf.standing_bench import make_windows
from inspektor_gadget_tpu_torch import history as PH
from inspektor_gadget_tpu_torch import queries as PQ
from inspektor_gadget_tpu_torch.operators import tpusketch as P
from inspektor_gadget_tpu_torch.queries import engine as port_engine
from inspektor_gadget_tpu_torch.sources.batch import EventBatch

torch.set_num_threads(2)

PINNED_WALL = 1_700_000_123.0
TENANTS = (101, 102, 103)

DOCS = [
    "",
    "[]",
    '{"watch": []}',
    '"hot"',
    "[42]",
    '[{"stats": ["topk"], "range": 30}]',
    '[{"id": "bad id!", "stats": ["topk"], "range": 30}]',
    '[{"id": "q", "stats": ["topk"], "range": 30, "topk": 5}]',
    '[{"id": "q", "range": 30}]',
    '[{"id": "q", "stats": [], "range": 30}]',
    '[{"id": "q", "stats": ["median"], "range": 30}]',
    '[{"id": "q", "stats": ["topk", "topk"], "range": 30}]',
    '[{"id": "q", "stats": ["topk"]}]',
    '[{"id": "q", "stats": ["topk"], "range": "soon"}]',
    '[{"id": "q", "stats": ["topk"], "range": -5}]',
    '[{"id": "q", "stats": ["topk"], "range": true}]',
    '[{"id": "q", "stats": ["topk"], "range": 30, "key": 7}]',
    '[{"id": "q", "stats": ["topk"], "range": 30, "top": 0}]',
    '[{"id": "q", "stats": ["topk"], "range": 30, "top": 99999}]',
    '[{"id": "q", "stats": ["topk"], "range": 30, "every": 0}]',
    '[{"id": "q", "stats": ["topk"], "range": 30}, {"id": "q", "stats": ["topk"], "range": 60}]',
    '[{"id": "q", "stats": ["topk"], "range": "2d"}]',
    "[{not json",
    # accepted documents
    '[{"id": "hot", "stats": ["topk", "cardinality"], "range": "1h", "top": 8}]',
    '{"queries": [{"id": "a", "stats": ["entropy"], "range": 30, "every": 3},'
    ' {"id": "b", "stats": ["quantiles"], "range": "15m", "key": "mntns:42"}]}',
]


@pytest.mark.parametrize("parser", ["yaml", "json"])
@pytest.mark.parametrize("doc", DOCS)
def test_load_queries_matches_the_reference(doc, parser, monkeypatch):
    """The same specs or the same QueryError message, with default_every 2
    and a one-day range cap."""
    if parser == "json":
        monkeypatch.setitem(sys.modules, "yaml", None)  # `import yaml` raises ImportError
    out = {}
    for name, Q in (("reference", RQ), ("port", PQ)):
        try:
            specs = Q.load_queries(doc, default_every=2, max_range_s=86400.0)
            out[name] = [(q.id, q.stats, q.range_s, q.key, q.top, q.every, q.identity(),
                          q.describe()) for q in specs]
        except Q.QueryError as e:
            out[name] = f"QueryError: {e}"
    assert out["port"] == out["reference"]


def test_load_queries_file(tmp_path):
    with pytest.raises(PQ.QueryError) as port_err:
        PQ.load_queries_file(str(tmp_path / "absent.json"))
    with pytest.raises(RQ.QueryError) as ref_err:
        RQ.load_queries_file(str(tmp_path / "absent.json"))
    assert str(port_err.value) == str(ref_err.value)
    p = tmp_path / "qs.json"
    p.write_text(DOCS[-2], encoding="utf-8")
    assert PQ.load_queries_file(str(p)) == [
        PQ.StandingQuery(**vars(q)) for q in RQ.load_queries_file(str(p))]


def _both(wins) -> tuple[list, list]:
    """Reference windows and their port copies (through the wire codec)."""
    return wins, [PH.decode_window(*RH.encode_window(w)) for w in wins]


def _flat(H, wins):
    win = H.merged_to_sealed(H.merge_windows(wins), gadget="bench/standing", node="bench0",
                             window=0, run_id="")
    return H.window_digest(win)


def test_sliding_fold_equals_a_flat_fold_every_tick():
    ref_wins, port_wins = _both(make_windows(14, width=32, hll_m=32, ent_w=16, k=4))
    folds = {"reference": RQ.SlidingFold(gadget="bench/standing", node="bench0"),
             "port": PQ.SlidingFold(gadget="bench/standing", node="bench0")}
    live: list = []
    for rw, pw in zip(ref_wins, port_wins):
        folds["reference"].push(rw)
        folds["port"].push(pw)
        live.append(pw)
        cutoff = pw.end_ts - 5.0
        for f in folds.values():
            f.evict_older_than(cutoff)
        live = [w for w in live if w.end_ts >= cutoff]
        assert folds["port"].coverage() == frozenset(w.digest for w in live) \
            == folds["reference"].coverage()
        got = folds["port"].value()
        assert PH.window_digest(got) == _flat(PH, live) == \
            RH.window_digest(folds["reference"].value())
        assert folds["port"].metas() == folds["reference"].metas()
    assert len(folds["port"]) < 14 and folds["port"].folds == folds["reference"].folds


def _windows(n: int) -> tuple[list, list]:
    """n one-second windows with slices and the quantile plane, drawn from
    one seed, as both packages' SealedWindow."""
    rng = np.random.default_rng(4)
    universe = rng.integers(1, 1 << 24, 24).astype(np.uint32)
    out = {"reference": [], "port": []}
    for i in range(n):
        slices = {}
        for key in (f"mntns:{TENANTS[i % 3]}", "kind:1"):
            slices[key] = {"events": int(rng.integers(1, 400)),
                           "hll": rng.integers(0, 9, 256).astype(np.uint8),
                           "ent": rng.integers(0, 30, 64).astype(np.int64),
                           "hh": [(int(k), int(c)) for k, c in
                                  zip(rng.choice(universe, 4, replace=False),
                                      rng.integers(1, 90, 4))]}
        qt = rng.integers(0, 40, 256).astype(np.int32)
        kw = dict(gadget="trace/exec", node="n0", run_id="r", window=i + 1,
                  start_ts=float(i), end_ts=float(i + 1), events=int(1000 + i), drops=i % 2,
                  cms=rng.integers(0, 900, (3, 64)).astype(np.int32),
                  hll=rng.integers(0, 14, 64).astype(np.int32),
                  ent=rng.integers(0, 50, 32).astype(np.float32),
                  topk_keys=rng.choice(universe, 6, replace=False),
                  topk_counts=rng.integers(1, 500, 6).astype(np.int64), slices=slices,
                  qt_counts=qt, qt_zeros=int(rng.integers(0, 9)), qt_total=int(qt.sum()) + 9,
                  qt_alpha=0.01, qt_min_value=1.0)
        for name, H in (("reference", RH), ("port", PH)):
            w = H.SealedWindow(**{k: (v.copy() if isinstance(v, np.ndarray) else v)
                                  for k, v in kw.items()})
            w.digest = H.window_digest(w)
            out[name].append(w)
    return out["reference"], out["port"]


SPECS = [{"id": "hot", "stats": ["topk", "cardinality"], "range": 4, "top": 5},
         {"id": "tenant", "stats": ["topk", "quantiles"], "range": 6, "key": "mntns:101",
          "every": 2}]


def _fold(answer) -> dict:
    """An answer's to_dict() but the count of windows folded and their
    levels: a standing answer folds one merged window (its header counts
    the windows it covers)."""
    out = answer.to_dict()
    del out["windows"], out["levels"]
    return out


def _ad_hoc(H, wins, spec, now) -> tuple[dict, int]:
    """answer_query over the windows a range query at `now` fetches
    (header_overlaps keeps end_ts >= now - range), and their count."""
    in_range = [w for w in wins if w.end_ts >= now - spec["range"]]
    ans = H.answer_query(in_range, key=spec.get("key") or None, top=spec.get("top", 10))
    return _fold(ans), len(in_range)


def _standing(H, payload: bytes, header: dict) -> tuple[dict, int]:
    frames, dropped = H.unpack_frames(payload)
    assert dropped == 0
    ans = H.answer_query(H.decode_frames(frames), key=header["key"] or None, top=header["top"])
    return _fold(ans), header["windows"]


def test_engines_publish_the_reference_answers(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: PINNED_WALL)  # the npz entries' clock
    doc = json.dumps(SPECS)
    engines = {"reference": RQ.StandingQueryEngine(RQ.load_queries(doc), gadget="trace/exec",
                                                   node="n0"),
               "port": PQ.StandingQueryEngine(PQ.load_queries(doc), gadget="trace/exec",
                                              node="n0")}
    ref_wins, port_wins = _windows(10)
    for i, (rw, pw) in enumerate(zip(ref_wins, port_wins)):
        pubs = {"reference": engines["reference"].on_seal(rw, now=rw.end_ts),
                "port": engines["port"].on_seal(pw, now=pw.end_ts)}
        assert pubs["port"] == pubs["reference"]
        assert [h["id"] for h, _p in pubs["port"]] == (["hot", "tenant"] if i % 2 else ["hot"])
        for header, payload in pubs["port"]:
            spec = next(s for s in SPECS if s["id"] == header["id"])
            got = _standing(PH, payload, header)
            assert got == _ad_hoc(PH, port_wins[:i + 1], spec, pw.end_ts)
            assert got == _ad_hoc(RH, ref_wins[:i + 1], spec, rw.end_ts)
    for qid in ("hot", "tenant"):
        got, want = engines["port"].read(qid), engines["reference"].read(qid)
        assert got == want and got[2]  # a cache hit: on_seal cached this coverage
    assert engines["port"].stats() == engines["reference"].stats()
    assert engines["port"].cache.stats()["hits"] == 2


def test_standing_equals_recompute_across_compaction():
    """A super-window over the first two windows plus a source not yet
    GC'd: the ad-hoc fold dedupes and equals the standing answer."""
    ref_wins, wins = _both(make_windows(4, width=32, hll_m=32, ent_w=16, k=4))
    superw = PH.merged_to_sealed(
        PH.merge_windows(wins[:2]), gadget="bench/standing", node="bench0", level=1, window=1,
        compacted_from=[{"digest": w.digest} for w in wins[:2]])
    superw.digest = PH.window_digest(superw)
    eng = PQ.StandingQueryEngine([PQ.StandingQuery(id="q", stats=("topk",), range_s=3600.0)],
                                 gadget="bench/standing", node="bench0")
    ref_eng = RQ.StandingQueryEngine([RQ.StandingQuery(id="q", stats=("topk",),
                                                       range_s=3600.0)],
                                     gadget="bench/standing", node="bench0")
    for w, rw in zip(wins, ref_wins):
        eng.on_seal(w, now=w.end_ts)
        ref_eng.on_seal(rw, now=rw.end_ts)
    header, payload, _ = eng.read("q")
    standing = PH.answer_query(PH.decode_frames(PH.unpack_frames(payload)[0]), top=8)
    ad_hoc = PH.answer_query([superw, wins[0], wins[2], wins[3]], top=8)
    assert any("superseded" in n for n in ad_hoc.dropped_windows)
    for field in ("heavy_hitters", "distinct", "entropy_bits", "events", "drops"):
        assert getattr(standing, field) == getattr(ad_hoc, field), field
    ref_header, _rp, _ = ref_eng.read("q")
    assert header["coverage_digest"] == ref_header["coverage_digest"]


def test_result_caches_count_alike():
    caches = {"reference": RQ.ResultCache(max_bytes=4096), "port": PQ.ResultCache(max_bytes=4096)}
    for cache in caches.values():
        cov = frozenset({"d1", "d2"})
        cache.put("a", cov, {"id": "a"}, b"x" * 64)
        assert cache.get("a", cov) == ({"id": "a"}, b"x" * 64)
        assert cache.get("a", frozenset({"d2", "d3"})) is None  # stale: invalidated
        for qid in ("a", "b", "c"):
            cache.put(qid, frozenset({qid}), {"id": qid}, b"y" * 1500)
        assert cache.get("a", frozenset({"a"})) is None  # evicted by bytes
        assert cache.get("c", frozenset({"c"})) is not None
    assert caches["port"].stats() == caches["reference"].stats() == {
        "entries": 2, "bytes": 4024, "max_bytes": 4096, "hits": 2, "misses": 2,
        "invalidations": 1}
    with pytest.raises(ValueError, match="max_bytes"):
        PQ.ResultCache(max_bytes=0)


def test_the_operator_publishes_what_its_store_answers(tmp_path, monkeypatch):
    """The port's instance on the CPU, a window a harvest, two standing
    queries: each published answer equals the same query over the store;
    the engine is live while the instance runs and gone after teardown."""
    monkeypatch.setattr(time, "time", lambda: PINNED_WALL)
    tick = iter(range(1, 1000))
    published: list = []
    ctx = P.SketchContext(gadget="trace/exec", run_id="sq-run", node="n0",
                          history_clock=lambda: 1.7e9 + next(tick),
                          on_query_answer=lambda h, p: published.append((h, p)))
    specs = [{**s, "range": s["range"] * 1.0} for s in SPECS]
    cfg = P.SketchConfig(depth=3, log2_width=10, hll_p=8, entropy_log2_width=6, topk=8,
                         harvest_interval=3600.0, quantiles=True, history=True,
                         history_interval=0.0, history_dir=str(tmp_path),
                         standing_queries=json.dumps(specs))
    opened = set(PH.HISTORY._writers)
    inst = P.TpuSketchInstance(cfg, ctx, device="cpu")
    rng = np.random.default_rng(5)
    try:
        assert [rid for rid, _e in port_engine.live_engines()] == ["sq-run"]
        for _ in range(6):
            n = 3000
            b = EventBatch.alloc(n, with_comm=False)
            keys = np.minimum(rng.zipf(1.3, n), 200).astype(np.uint64)
            b.cols["key_hash"][:] = keys * np.uint64(0x9E3779B97F4A7C15) + np.uint64(1)
            b.cols["mntns"][:] = rng.choice((101, 102), n)
            b.cols["kind"][:] = rng.integers(0, 3, n)
            b.cols["aux1"][:] = rng.integers(1, 10**6, n)
            b.count = n
            inst.enrich_batch(b)
            inst.harvest()
        assert len(published) == 6 + 3
        for header, payload in published:
            spec = next(s for s in specs if s["id"] == header["id"])
            # the windows in range that the store held at this seal tick
            frames = list(PH.HISTORY.fetch_windows(
                base_dir=str(tmp_path), start_ts=header["end_ts"] - spec["range"],
                end_seq=header["tick"]))
            want = PH.answer_query(PH.decode_frames(frames), key=spec.get("key"),
                                   top=spec["top"] if "top" in spec else 10)
            assert _standing(PH, payload, header) == (_fold(want), len(frames))
        (row_hot, row_tenant) = port_engine.live_stats()
        assert (row_hot["ticks"], row_hot["published"], row_tenant["published"]) == (6, 6, 3)
    finally:
        inst.post_gadget_run()
        with PH.HISTORY._mu:
            fresh = [PH.HISTORY._writers.pop(k) for k in list(PH.HISTORY._writers)
                     if k not in opened]
        for w in fresh:
            w.close()
    assert port_engine.live_engines() == []
