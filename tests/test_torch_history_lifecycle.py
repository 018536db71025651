"""The port's history lifecycle (compaction and the archive tier) against
the reference's, on the CPU.

One store of seeded windows (the npz's zip entries pinned) is copied
twice; each package's `CompactionEngine`, under one injected clock,
compacts its copy: one pass, the ladder to the final level, and a pass
crashed between the super-windows' append and the sources' GC and then
rerun. The segments are byte-identical and the index rows equal but for
``sealed_ts``; the fold over each copy equals the fold before compaction
(compaction folds exactly, ``tests/test_history_lifecycle.py:169``); each
package reads the other's compacted store to the same answer. Archived
on one clock, the manifest rows and objects are the same, the
rehydrated answers match, and a corrupted object or a torn manifest line
behave as the reference's ``tests/test_history_lifecycle.py:442`` and
``:461``.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from inspektor_gadget_tpu import history as RH
from inspektor_gadget_tpu.utils.journal import append_line as ref_append_line
from inspektor_gadget_tpu_torch import history as PH
from inspektor_gadget_tpu_torch.utils.journal import append_line

torch.set_num_threads(2)

T0 = 1_000_000.0
FUTURE = T0 + 10_000_000.0
PINNED_WALL = 1_700_000_123.0
PKGS = {"reference": RH, "port": PH}
SCHEDULE = "10s@1m,60s@1d,600s@inf"


def _window(rng, i: int) -> PH.SealedWindow:
    """Integer-valued planes, so every fold is exact under any association."""
    win = PH.SealedWindow(
        gadget="trace/lc", node="lcnode", run_id="r1", window=i + 1,
        start_ts=T0 + i * 10.0, end_ts=T0 + (i + 1) * 10.0, events=100 + i, drops=i % 3,
        cms=rng.integers(0, 50, (4, 64)).astype(np.int32),
        hll=rng.integers(0, 6, 256).astype(np.int32),
        ent=rng.integers(0, 20, 64).astype(np.float32),
        topk_keys=rng.integers(1, 1 << 31, 8).astype(np.uint32),
        topk_counts=rng.integers(1, 100, 8).astype(np.int64),
        slices={f"mntns:{100 + i % 2}": {
            "events": 10, "hll": rng.integers(0, 3, 256).astype(np.uint8),
            "ent": rng.integers(0, 5, 64).astype(np.int64), "hh": [(i + 1, 3)]}})
    win.digest = PH.window_digest(win)
    return win


@pytest.fixture()
def seeded(tmp_path, monkeypatch):
    """A port-written store of 12 windows, one segment a 3 -> (base, the
    store's directory name); time.time pinned for the npz's zip entries."""
    monkeypatch.setattr(time, "time", lambda: PINNED_WALL)
    store = PH.HistoryStore()
    base = str(tmp_path / "seed")
    writer = store.writer_for("trace-lc", node="lcnode", base_dir=base)
    rng = np.random.default_rng(3)
    for i in range(12):
        store.append_window(_window(rng, i), writer=writer)
        if (i + 1) % 3 == 0:
            writer.rotate()
    store.close_all()
    return base, "lcnode--trace-lc"


def _copies(tmp_path, seeded) -> dict[str, tuple]:
    base, name = seeded
    out = {}
    for pkg, H in PKGS.items():
        copy = str(tmp_path / pkg)
        shutil.copytree(base, copy)
        out[pkg] = (H, H.HistoryStore(), copy, os.path.join(copy, name))
    return out


def _segments(store_dir: str) -> dict[str, bytes]:
    return {f: open(os.path.join(store_dir, f), "rb").read()
            for f in sorted(os.listdir(store_dir)) if f.startswith("seg-")}


def _rows(path: str, drop: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    for r in rows:
        r.pop(drop)
    return rows


def _answer(H, store, base, **kw) -> dict:
    losses: list = []
    frames = list(store.fetch_windows(base_dir=base, gadget="trace/lc", losses=losses, **kw))
    return {**H.answer_query(H.decode_frames(frames), top=8).to_dict(), "losses": losses}


def _fold_keys(ans: dict) -> tuple:
    return tuple(ans[k] for k in ("events", "drops", "distinct", "entropy_bits",
                                  "heavy_hitters", "slices"))


@pytest.mark.parametrize("passes", ["one pass", "ladder", "crash, then rerun"])
def test_compaction_writes_the_reference_bytes(passes, tmp_path, seeded):
    copies = _copies(tmp_path, seeded)
    before = _answer(PH, PH.HistoryStore(), seeded[0])
    stats = {}
    for pkg, (H, store, base, sdir) in copies.items():
        engine = H.CompactionEngine(SCHEDULE if passes != "crash, then rerun"
                                    else "10s@1m,60s@inf", store=store, clock=lambda: FUTURE)
        if passes == "crash, then rerun":
            def boom():
                raise RuntimeError("killed before the sources' GC")
            engine._before_gc = boom
            with pytest.raises(RuntimeError, match="killed"):
                engine.compact_store(sdir)
            mid = _answer(H, store, base)
            assert sum("superseded" in n for n in mid["dropped_windows"]) == 12
            assert _fold_keys(mid) == _fold_keys(before)
            engine._before_gc = None
        stats[pkg] = [engine.compact_store(sdir)]
        if passes == "ladder":
            stats[pkg].append(engine.compact_store(sdir))
        store.close_all()
    assert stats["port"] == stats["reference"]
    sdirs = {pkg: c[3] for pkg, c in copies.items()}
    assert _segments(sdirs["port"]) == _segments(sdirs["reference"])
    assert _rows(os.path.join(sdirs["port"], "index.jsonl"), "sealed_ts") == \
        _rows(os.path.join(sdirs["reference"], "index.jsonl"), "sealed_ts")
    answers = {(r, w): _answer(PKGS[r], PKGS[r].HistoryStore(), copies[w][2])
               for r in PKGS for w in PKGS}
    first = answers["port", "port"]
    assert all(a == first for a in answers.values())
    assert _fold_keys(first) == _fold_keys(before)
    assert first["compacted_windows"] == first["windows"] == {
        "one pass": 3, "ladder": 1, "crash, then rerun": 3}[passes]
    assert first["dropped_windows"] == []


@pytest.fixture()
def archived(tmp_path, seeded):
    """Both copies compacted to the final level and offloaded, each by its
    own package, under one clock."""
    copies = _copies(tmp_path, seeded)
    before = _answer(PH, PH.HistoryStore(), seeded[0])
    out = {}
    for pkg, (H, store, base, sdir) in copies.items():
        H.CompactionEngine("10s@1m,60s@inf", store=store, clock=lambda: FUTURE) \
            .compact_store(sdir)
        tier = H.ArchiveTier(H.FilesystemArchive(str(tmp_path / f"objects-{pkg}")),
                             cache_dir=os.path.join(base, ".archive-cache"),
                             clock=lambda: FUTURE)
        store._archives[os.path.abspath(base)] = tier
        stats = tier.archive_store(sdir, min_level=1, writer=store.writer_for_dir(sdir))
        out[pkg] = (H, store, base, sdir, tier, stats)
    yield out, before
    for c in out.values():
        c[1].close_all()


def test_archive_rows_objects_and_rehydration_match(archived):
    out, before = archived
    (_, _, _, pdir, ptier, pstats), (_, _, _, rdir, rtier, rstats) = out["port"], out["reference"]
    assert pstats == rstats and pstats["segments"] == 1 and pstats["windows"] == 3
    prows, rrows = ptier.manifest_rows(pdir), rtier.manifest_rows(rdir)
    assert prows == rrows and prows[0]["level"] == 1
    assert ptier.backend.get(prows[0]["object"]) == rtier.backend.get(rrows[0]["object"])
    assert not os.path.isfile(os.path.join(pdir, prows[0]["file"]))
    got = {pkg: _answer(H, store, base) for pkg, (H, store, base, *_r) in out.items()}
    assert got["port"] == got["reference"]
    assert _fold_keys(got["port"]) == _fold_keys(before)
    assert (ptier.misses, ptier.hits) == (rtier.misses, rtier.hits) == (1, 0)
    for H, store, base, *_r in out.values():  # the second read is a cache hit
        assert _answer(H, store, base) == got["port"]
    assert ptier.hits == rtier.hits == 1
    # the manifest prunes: a range no archived segment overlaps reads nothing
    misses = ptier.misses
    far = _answer(PH, out["port"][1], out["port"][2], start_ts=T0 + 9e6, end_ts=T0 + 9.1e6)
    assert far["windows"] == 0 and ptier.misses == misses
    assert ptier.stats(pdir) == rtier.stats(rdir)


def test_a_corrupted_object_is_reported_never_merged(archived):
    """The reference's tests/test_history_lifecycle.py:442 on both tiers."""
    out, _ = archived
    answers = {}
    for pkg, (H, store, base, sdir, tier, _s) in out.items():
        row = tier.manifest_rows(sdir)[0]
        path = tier.backend._path(row["object"])
        data = bytearray(open(path, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(path, "wb").write(bytes(data))
        answers[pkg] = _answer(H, store, base)
    assert answers["port"] == answers["reference"]
    assert answers["port"]["windows"] == 0
    (loss,) = answers["port"]["losses"]
    assert "digest mismatch" in loss["reason"]


def test_a_torn_manifest_line_is_repaired_on_read(archived):
    """The reference's tests/test_history_lifecycle.py:461 on both tiers:
    the torn line is dropped, and a row appended after it is read."""
    out, before = archived
    for pkg, (H, store, base, sdir, tier, _s) in out.items():
        mpath = os.path.join(sdir, H.ARCHIVE_MANIFEST)
        good = open(mpath, "rb").read()
        with open(mpath, "ab") as f:
            f.write(b'{"object": "torn-half')
        assert len(tier.manifest_rows(sdir)) == 1
        (append_line if pkg == "port" else ref_append_line)(mpath, {
            "schema": "x", "object": "o2", "file": "none", "bytes": 1, "digest": "d",
            "level": 1, "windows": 0, "first_seq": 0, "last_seq": 0, "first_ts": 0.0,
            "last_ts": 0.0, "keys": []})
        assert [r["object"] for r in tier.manifest_rows(sdir)][-1] == "o2"
        assert open(mpath, "rb").read().startswith(good)
        assert _fold_keys(_answer(H, store, base)) == _fold_keys(before)
    assert open(os.path.join(out["port"][3], PH.ARCHIVE_MANIFEST), "rb").read() == \
        open(os.path.join(out["reference"][3], RH.ARCHIVE_MANIFEST), "rb").read()


def test_the_rehydration_cache_is_lru_bounded(tmp_path, seeded):
    """Three archived segments through a cache that holds one."""
    base, name = seeded
    store = PH.HistoryStore()
    sdir = os.path.join(base, name)
    PH.CompactionEngine("10s@15s,20s@inf", store=store, clock=lambda: FUTURE) \
        .compact_store(sdir)
    writer = store.writer_for_dir(sdir)
    seg = max(len(b) for b in _segments(sdir).values())
    store.set_archive(str(tmp_path / "objects"), seg + 128, base_dir=base)
    tier = store.archive(base)
    try:
        assert tier.archive_store(sdir, min_level=1, writer=writer)["segments"] >= 1
        _answer(PH, store, base)
        cached = [os.path.join(r, f) for r, _d, fs in os.walk(tier.cache_dir) for f in fs]
        assert sum(os.path.getsize(p) for p in cached) <= seg + 128 or len(cached) == 1
        assert tier.misses >= 1
    finally:
        store.close_all()


def test_schedule_grammar_is_the_reference_one():
    for spec in (PH.DEFAULT_SCHEDULE, "30s@1h,5m@2d,1h@inf", "1m@1d12h,1h@∞"):
        assert PH.parse_schedule(spec) == [
            PH.ScheduleLevel(lvl.resolution, lvl.horizon) for lvl in RH.parse_schedule(spec)]
    for bad in ("", "1m", "1m@1h", "1h@1d,1m@inf", "1m@inf,1h@inf", "x@1h,1h@inf"):
        with pytest.raises(ValueError) as ref_err:
            RH.parse_schedule(bad)
        with pytest.raises(ValueError) as port_err:
            PH.parse_schedule(bad)
        assert str(port_err.value) == str(ref_err.value)
