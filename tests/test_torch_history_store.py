"""The port's capture journal and sealed-window store against the
reference's, on the CPU.

The journal: the same records appended through each package's
`JournalWriter` on one injected clock are the same segment and index
bytes, and a torn tail (a cut frame header, a frame shorter than its
length prefix, a CRC mismatch, a frame whose payload does not inflate) is
dropped and accounted alike by both readers and both writers' recovery.

The store: windows built from one seeded numpy draw, appended through
each package's `HistoryStore` (the npz's zip entries pinned), rotate into
byte-identical segments whose index rows (but for ``sealed_ts``, the
writers' wall clock) carry the same slice keys and window counts; each
package's query over the other's store, whole and keyed, is its own;
retention GC deletes the same sealed segments and never the active one;
the store-name guard refuses the same names with the same message.

The operators: the reference's tpusketch instance and the port's (on
``device="cpu"``), fed the streams of ``tests/test_torch_operator.py``
under one injected history clock, seal into their own stores. The
segments are byte-identical and the index rows equal but for
``sealed_ts``, and each package's `fetch_windows` + ``answer_query(...)
.to_dict()`` on the other's store equals its own, ``--key`` pruning
included.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib

import numpy as np
import pytest
import torch

import inspektor_gadget_tpu.all_gadgets  # noqa: F401
from inspektor_gadget_tpu.agent import wire as RW
from inspektor_gadget_tpu.capture import journal as RJ
from inspektor_gadget_tpu.gadgets import GadgetContext, get
from inspektor_gadget_tpu.history import HISTORY as REF_HISTORY
from inspektor_gadget_tpu.history import store as RS
from inspektor_gadget_tpu.history import query as RQ
from inspektor_gadget_tpu.history import window as RWin
from inspektor_gadget_tpu.operators import tpusketch as R
from inspektor_gadget_tpu.operators.operators import get as get_op
from inspektor_gadget_tpu.sources.batch import EventBatch as RefEventBatch
from inspektor_gadget_tpu.sources.batch import FoldedBatch as RefFoldedBatch
from inspektor_gadget_tpu_torch.agent import wire as PW
from inspektor_gadget_tpu_torch.capture import journal as PJ
from inspektor_gadget_tpu_torch.history import HISTORY as PORT_HISTORY
from inspektor_gadget_tpu_torch.history import query as PQ
from inspektor_gadget_tpu_torch.history import store as PS
from inspektor_gadget_tpu_torch.history import window as PWin
from inspektor_gadget_tpu_torch.operators import tpusketch as P
from inspektor_gadget_tpu_torch.sources.batch import EventBatch, FoldedBatch

torch.set_num_threads(2)

PINNED_WALL = 1_700_000_123.0
TENANTS = (101, 102, 103, 104)
PKGS = {"reference": (RJ, RS, RQ, RWin), "port": (PJ, PS, PQ, PWin)}


class _Tick:
    """An injected clock: one second a read."""

    def __init__(self, t: float = 1_700_000_000.0):
        self.t = t

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def _files(path: str, prefix: str = "seg-") -> dict[str, bytes]:
    out = {}
    for f in sorted(os.listdir(path)):
        if f.startswith(prefix):
            with open(os.path.join(path, f), "rb") as fh:
                out[f] = fh.read()
    return out


def _index(path: str) -> list[dict]:
    """The index rows but their ``sealed_ts`` (the writer's wall clock)."""
    with open(os.path.join(path, "index.jsonl"), encoding="utf-8") as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    for r in rows:
        r.pop("sealed_ts")
    return rows


# -- the journal -----------------------------------------------------------------------

def _records(rng, n: int) -> list[tuple[int, dict, bytes]]:
    """Typed records: summary headers with floats and nested lists, window
    frames with incompressible payloads, journal marks."""
    out = []
    for i in range(n):
        kind = (RW.EV_SUMMARY, RW.EV_WINDOW, RW.EV_JOURNAL_MARK)[i % 3]
        header = {"events": int(rng.integers(0, 1 << 40)), "entropy": float(rng.random()),
                  "names": {str(int(k)): f"proc-{int(k)}" for k in rng.integers(0, 99, 3)},
                  "heavy": [[int(k), int(c)] for k, c in rng.integers(0, 1 << 31, (4, 2))]}
        out.append((kind, header, rng.bytes(int(rng.integers(0, 1500)))))
    return out


def _write_journal(J, path: str, records, *, close: bool = True):
    w = J.JournalWriter(path, manifest={"schema": J.JOURNAL_SCHEMA}, max_segment_bytes=4096,
                        clock=_Tick())
    for kind, header, payload in records:
        w.append(kind, header, payload)
    if close:
        w.close()
    return w


def test_journal_frames_are_the_reference_bytes(tmp_path):
    """One record stream through both writers: the same segment bytes and
    index rows, and each package's reader reads the other's journal."""
    records = _records(np.random.default_rng(0), 40)
    paths = {name: str(tmp_path / name) for name in PKGS}
    for name, (J, *_rest) in PKGS.items():
        _write_journal(J, paths[name], records)
    segs = {name: _files(p) for name, p in paths.items()}
    assert len(segs["port"]) > 3 and segs["port"] == segs["reference"]
    assert _index(paths["port"]) == _index(paths["reference"])
    for reader_pkg, writer_pkg in (("port", "reference"), ("reference", "port")):
        got = list(PKGS[reader_pkg][0].JournalReader(paths[writer_pkg]).records())
        assert [(h["type"], h["seq"], p) for h, p in got] == [
            (k, i + 1, p) for i, (k, _h, p) in enumerate(records)]
    assert PW.encode_msg({"a": 1.5}, b"x") == RW.encode_msg({"a": 1.5}, b"x")
    assert PJ.JournalReader(paths["port"]).digest() == RJ.JournalReader(paths["port"]).digest()


def _tear(seg: str, how: str) -> None:
    data = bytearray(open(seg, "rb").read())
    last = 0
    off = 0
    while off < len(data):  # find the last frame's offset
        last = off
        off += 8 + int.from_bytes(data[off:off + 4], "little")
    if how == "header":
        data = data[:last + 5]
    elif how == "short":
        data = data[:len(data) - 3]
    elif how == "crc":
        data[-1] ^= 0xFF
    else:  # a whole frame whose payload does not inflate
        junk = b"not zlib at all"
        data += (len(junk).to_bytes(4, "little")
                 + (zlib.crc32(junk) & 0xFFFFFFFF).to_bytes(4, "little") + junk)
    with open(seg, "wb") as f:
        f.write(bytes(data))


@pytest.mark.parametrize("how", ["header", "short", "crc", "zlib"])
def test_torn_tails_are_dropped_and_accounted_alike(how, tmp_path):
    """A torn active segment: both readers keep the same records and
    report the same loss; both writers' recovery truncates it to the same
    bytes and continue the seq alike."""
    records = _records(np.random.default_rng(1), 9)
    base = str(tmp_path / "j")
    _write_journal(PJ, base, records, close=False)
    seg = sorted(p for p in os.listdir(base) if p.startswith("seg-"))[-1]
    _tear(os.path.join(base, seg), how)
    reads = {}
    for name, (J, *_rest) in PKGS.items():
        rd = J.JournalReader(base)
        got = [(h["seq"], p) for h, p in rd.records()]
        reads[name] = (got, [loss.__dict__ for loss in rd.losses])
        recs, loss = J.scan_segment(os.path.join(base, seg))
        assert loss is not None and loss.__dict__ == rd.losses[-1].__dict__
    assert reads["port"] == reads["reference"]
    want_seqs = len(records) - (how in ("header", "short", "crc"))
    assert [s for s, _ in reads["port"][0]] == list(range(1, want_seqs + 1))
    recovered = {}
    for name, (J, *_rest) in PKGS.items():
        copy = str(tmp_path / f"recover-{name}")
        shutil.copytree(base, copy)
        w = J.JournalWriter(copy, clock=_Tick(2e9))
        assert w.append(RW.EV_SUMMARY, {"after": True}) == want_seqs + 1
        w.close()
        recovered[name] = (_files(copy), _index(copy))
    assert recovered["port"] == recovered["reference"]


# -- the store ---------------------------------------------------------------------------

def _window_kw(rng, i: int, span: float = 10.0) -> dict:
    """One window's fields (both packages' SealedWindow take them), with
    one to three of six slice keys."""
    keys = [f"mntns:{t}" for t in TENANTS] + ["kind:1", "mntns:101|kind:1"]
    slices = {}
    for k in rng.choice(keys, int(rng.integers(1, 4)), replace=False):
        slices[str(k)] = {"events": int(rng.integers(1, 500)),
                          "hll": rng.integers(0, 9, 256).astype(np.uint8),
                          "ent": rng.integers(0, 40, 64).astype(np.int64),
                          "hh": [(int(k2), int(c)) for k2, c in
                                 zip(rng.integers(1, 1 << 31, 3), rng.integers(1, 99, 3))]}
    return dict(gadget="trace/exec", node="n0", run_id="r1", window=i + 1,
                start_ts=1e6 + i * span, end_ts=1e6 + (i + 1) * span,
                events=int(rng.integers(100, 5000)), drops=i % 3,
                cms=rng.integers(0, 90, (3, 256)).astype(np.int32),
                hll=rng.integers(0, 12, 256).astype(np.int32),
                ent=rng.integers(0, 60, 64).astype(np.float32),
                topk_keys=rng.integers(1, 1 << 31, 8).astype(np.uint32),
                topk_counts=np.sort(rng.integers(1, 900, 8))[::-1].astype(np.int64),
                slices=slices, names={})


def _seed_stores(tmp_path, monkeypatch, n: int = 14, **writer_kw):
    """The same windows through both packages' stores -> {pkg: (store,
    base, store dir, windows)}; time.time pinned for the npz's zip
    entries."""
    monkeypatch.setattr(time, "time", lambda: PINNED_WALL)
    rng = np.random.default_rng(2)
    kws = [_window_kw(rng, i) for i in range(n)]
    out = {}
    for name, (_J, S, _Q, W) in PKGS.items():
        store = S.HistoryStore()
        base = str(tmp_path / name)
        writer = store.writer_for("trace/exec", node="n0", base_dir=base,
                                  max_segment_bytes=4096, **writer_kw)
        wins = []
        for kw in kws:
            win = W.SealedWindow(**{k: (v.copy() if isinstance(v, np.ndarray) else v)
                                    for k, v in kw.items()})
            win.digest = W.window_digest(win)
            store.append_window(win, writer=writer)
            wins.append(win)
        store.release(writer)
        out[name] = (store, base, os.path.join(base, "n0--trace-exec"), wins)
    return out


@pytest.fixture()
def stores(tmp_path, monkeypatch):
    made = _seed_stores(tmp_path, monkeypatch)
    yield made
    for store, *_rest in made.values():
        store.close_all()


def test_store_rotation_index_rows_and_key_pruning(stores):
    """Byte-identical segments; index rows with each segment's slice-key
    union and window count; each package's query over the other's store
    equals its own, whole and keyed."""
    _, _, pdir, pwins = stores["port"]
    _, _, rdir, _ = stores["reference"]
    segs = _files(pdir)
    assert len(segs) > 3 and segs == _files(rdir)
    rows = _index(pdir)
    assert rows == _index(rdir)
    seq_keys: dict[int, list[str]] = {i + 1: w.slice_keys for i, w in enumerate(pwins)}
    for row in rows:
        span = range(row["first_seq"], row["last_seq"] + 1)
        assert row["windows"] == len(span) == row["records"]
        assert row["keys"] == sorted({k for s in span for k in seq_keys[s]})
    for key in (None, "mntns:101", "mntns:101|kind:1", "kind:9"):
        answers = {}
        for reader, (_J, S, Q, _W) in PKGS.items():
            for writer in PKGS:
                store, base = S.HistoryStore(), stores[writer][1]
                losses: list = []
                frames = list(store.fetch_windows(base_dir=base, key=key, losses=losses))
                ans = Q.answer_query(Q.decode_frames(frames), key=key, top=5)
                answers[reader, writer] = (ans.to_dict(), losses, len(frames))
        first = answers["port", "port"]
        assert all(a == first for a in answers.values()), key
        want = sum(1 for w in pwins if key is None or key in w.slice_keys)
        assert first[2] == want


def test_stats_and_tier_stats_match(stores):
    got = PS.HistoryStore().stats(stores["port"][1])["stores"]["n0--trace-exec"]
    want = RS.HistoryStore().stats(stores["reference"][1])["stores"]["n0--trace-exec"]
    for d in (got, want):
        d.pop("path")
    assert got == want and got["windows"] == 14 and got["levels"]["0"]["windows"] == 14
    t_got = PS.HistoryStore().tier_stats(stores["port"][1])
    t_want = RS.HistoryStore().tier_stats(stores["reference"][1])
    for t in (t_got, t_want):
        # every file of the area, the manifest and the index's wall-clock
        # sealed_ts included, so a digit or two apart
        t.pop("base"), t.pop("bytes")
    assert t_got == t_want and t_got["levels"]["0"]["windows"] == 14


def test_retention_gc_never_touches_the_active_segment(tmp_path, monkeypatch):
    made = _seed_stores(tmp_path, monkeypatch, n=20, retention_segments=2)
    try:
        listings = {}
        for name, (store, _base, sdir, _w) in made.items():
            writer = store.writer_for_dir(sdir)
            active = writer.stats()["active_segment"]
            sealed = [f for f in _files(sdir) if f != active]
            assert len(sealed) <= 2 and {r["file"] for r in _index(sdir)} >= set(sealed)
            listings[name] = _files(sdir)
        assert listings["port"] == listings["reference"]
        assert PS.HISTORY_METRICS.gc.value > 0
        # the active segment is never deleted, even by name
        store, _b, sdir, _w = made["port"]
        writer = store.writer_for_dir(sdir)
        win = PWin.SealedWindow(**_window_kw(np.random.default_rng(9), 30))
        store.append_window(win, writer=writer)
        active = writer.stats()["active_segment"]
        assert writer.remove_segments([active]) == (0, 0)
        assert os.path.isfile(os.path.join(sdir, active))
    finally:
        for store, *_rest in made.values():
            store.close_all()


@pytest.mark.parametrize("name", ["", ".", "..", "a/b", "../escape"])
def test_store_name_guard(name):
    with pytest.raises(ValueError) as ref_err:
        RS.validate_store_name(name)
    with pytest.raises(ValueError) as port_err:
        PS.validate_store_name(name)
    assert str(port_err.value) == str(ref_err.value) == f"bad history store name {name!r}"


def test_base_dir_follows_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("IG_HISTORY_DIR", str(tmp_path / "env"))
    assert PS.history_base_dir() == RS.history_base_dir() == str(tmp_path / "env")
    assert PS.history_base_dir("/x") == "/x"
    monkeypatch.delenv("IG_HISTORY_DIR")
    assert PS.history_base_dir().endswith(os.path.join(".ig-tpu", "history"))


# -- two operators, one clock -----------------------------------------------------------

SMALL = {"depth": "3", "log2-width": "10", "hll-p": "8", "entropy-log2-width": "6",
         "topk": "8", "harvest-interval": "1h"}
OPS = {
    "a window a harvest": dict(invertible=True, inv_log2_buckets=9, quantiles=True,
                               audit_sample=32, history=True, history_interval=0.0),
    "windows by interval": dict(quantiles=True, history=True, history_interval=2.5,
                                history_slots=4, history_max_slices=5),
}


@pytest.fixture()
def release():
    """Drop the instances both packages built and close their writers."""
    before = (set(R._live), set(P._live))
    opened = {id(h): set(h._writers) for h in (REF_HISTORY, PORT_HISTORY)}
    yield
    for h in (REF_HISTORY, PORT_HISTORY):
        with h._mu:
            fresh = [h._writers.pop(k) for k in list(h._writers) if k not in opened[id(h)]]
        for w in fresh:
            w.close()
    for mod, was in zip((R, P), before):
        with mod._live_mu:
            fresh = [mod._live.pop(r) for r in list(mod._live) if r not in was]
        for inst in fresh:
            if getattr(inst, "_stager", None) is not None:
                inst._stager.drain()
            inst._pstats.unregister()
            if inst._astats is not None:
                inst._astats.unregister()
            inst._stats.unregister()


def _param(k: str, v) -> str:
    if isinstance(v, bool):
        return str(v).lower()
    return f"{int(v * 1000)}ms" if k.endswith("interval") else str(v)


def _operators(kw: dict, tmp_path):
    ctx = GadgetContext(get("trace", "exec"), run_id="run-1",
                        extra={"node": "n0", "history_clock": _Tick()})
    op = get_op("tpusketch")
    p = op.instance_params().to_params()
    p.set("enable", "true")
    for k, v in {**SMALL, **{k.replace("_", "-"): _param(k, v) for k, v in kw.items()},
                 "history-dir": str(tmp_path / "reference")}.items():
        p.set(k, v)
    ref = op.instantiate(ctx, None, p)
    cfg = P.SketchConfig(depth=3, log2_width=10, hll_p=8, entropy_log2_width=6, topk=8,
                         harvest_interval=3600.0, history_dir=str(tmp_path / "port"), **kw)
    pctx = P.SketchContext(gadget="trace/exec", run_id="run-1", node="n0",
                           batch_size=ctx.gadget_params.get("batch-size").as_int(),
                           history_clock=_Tick())
    return ref, P.TpuSketchInstance(cfg, pctx, device="cpu")


def _feed(ref, port, rng) -> None:
    """tests/test_torch_operator.py's streams: folded blocks (zipf keys,
    weights, tenants, values) and EventBatches, a harvest a round."""
    cap = port._pad
    for rnd in range(3):
        for i in range(2):
            n = cap - 313 * i
            lanes = np.zeros((4, cap), np.uint32)
            ranks = np.minimum(rng.zipf(1.3, n), 400).astype(np.uint64)
            lanes[0, :n] = ((ranks * np.uint64(0x9E3779B1)) & np.uint64(0xFFFFFFFF))
            lanes[1, :n] = rng.integers(1, 4, n) if i else 1
            lanes[2, :n] = rng.choice(TENANTS, n)
            lanes[3, :n] = rng.integers(0, 5_000_000, n)
            rb, pb = ref.folded_block(), port.folded_block()
            rb[:4] = lanes
            pb.numpy()[:4] = lanes
            ref.ingest_folded(RefFoldedBatch(lanes=rb, count=n, has_values=True))
            port.ingest_folded(FoldedBatch(lanes=pb.numpy(), count=n, has_values=True,
                                           block=pb))
        for i in range(2):
            n = 1500 + 700 * i
            keys = np.minimum(rng.zipf(1.4, n), 300).astype(np.uint64)
            cols = {"key_hash": keys * np.uint64(0x9E3779B97F4A7C15) + np.uint64(1),
                    "pid": (np.minimum(rng.zipf(1.2, n), 5000) + 1000).astype(np.uint32),
                    "aux1": rng.integers(0, 2**33, n).astype(np.uint64),
                    "mntns": rng.choice(TENANTS, n).astype(np.uint64),
                    "kind": rng.integers(0, 4, n).astype(np.uint32)}
            for cls, inst in ((RefEventBatch, ref), (EventBatch, port)):
                b = cls.alloc(n, with_comm=False)
                for k, v in cols.items():
                    b.cols[k][:] = v
                b.count, b.drops = n, rnd + i
                inst.enrich_batch(b)
        ref.harvest()
        port.harvest()


@pytest.mark.parametrize("case", list(OPS))
def test_operators_seal_byte_identical_stores(case, tmp_path, monkeypatch, release):
    monkeypatch.setattr(time, "time", lambda: PINNED_WALL)  # the npz entries' clock
    ref, port = _operators(OPS[case], tmp_path)
    _feed(ref, port, np.random.default_rng(list(OPS).index(case)))
    ref.post_gadget_run()
    port.post_gadget_run()
    sdir = {n: str(tmp_path / n / "n0--trace-exec") for n in PKGS}
    segs = _files(sdir["port"])
    assert segs and segs == _files(sdir["reference"])
    rows = {n: _index(d) for n, d in sdir.items()}
    assert rows["port"] == rows["reference"] and rows["port"][-1]["windows"] > 1
    manifest = json.loads(open(os.path.join(sdir["port"], "manifest.json")).read())
    assert manifest["platform"] == "cpu" and manifest["schema"] == PS.HISTORY_SCHEMA
    keys = rows["port"][0]["keys"]
    for key in (None, keys[0], keys[-1], "mntns:999"):
        answers = []
        for _J, S, Q, _W in PKGS.values():
            for base in (str(tmp_path / n) for n in PKGS):
                frames = list(S.HistoryStore().fetch_windows(base_dir=base, key=key,
                                                             gadget="trace/exec"))
                answers.append(Q.answer_query(Q.decode_frames(frames), key=key).to_dict())
        assert all(a == answers[0] for a in answers), key
        assert (answers[0]["windows"] > 0) == (key != "mntns:999")
