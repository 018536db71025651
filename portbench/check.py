"""The comparison that decides ``correct``.

`reference_outputs` regenerates the run's stream from its seed, folds
exactly the batches the run's feed handed over (warm-up, window and
drain alike) with the plain reference, and takes a snapshot wherever the
program emitted a summary or sealed a window. `compare` holds the
program's outputs against those snapshots and returns every number
compared with its limit. The same comparison judges the control (the
reference in bfloat16, put in the program's place).
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference as R
from .stream import EventPool

MAX_CACHED = 64  # batch deltas kept for reuse (a backlog pool holds 16)

def _vocab_index(pool: EventPool):
    """Every stream key's uint32 form and, for each, the index of its
    uint32 value among the vocabulary's distinct folded keys (names whose
    hashes fold alike are one key to the sketch plane)."""
    folded = R.fold64(pool.vocab_hashes)
    uniq, inv = np.unique(folded, return_inverse=True)
    return uniq, inv


def reference_outputs(cfg: dict, pool: EventPool, log, summary_marks: list[int],
                      window_marks: list[int], device: torch.device, *,
                      control: bool = False, decoded: list | None = None) -> dict:
    """The reference's state, its summary at each of `summary_marks` and
    its window at each of `window_marks` (a mark is the number of batches
    folded when the program emitted it). Where `decoded` lists the
    program's decoded pairs of each summary, also the number of pairs
    whose count is not the key's exact count."""
    geom = R.Geometry(cfg["operator"])
    ref = R.Reference(geom, device, control=control)
    win = R.WindowRef(geom, device, ref) if geom.history else None
    uniq, inv = _vocab_index(pool)
    exact = torch.zeros(len(uniq), dtype=torch.int64, device=device)
    inv_t = torch.from_numpy(inv.astype(np.int64)).to(device)
    summaries, windows, decoded_off = [], [], 0
    s_marks, w_marks = list(summary_marks), list(window_marks)
    deltas: dict[tuple[int, int], dict] = {}  # by (pool row, events): the backlog's batches recur
    si = wi = 0
    hist = geom.history
    for b in range(len(log) + 1):
        while wi < len(w_marks) and w_marks[wi] == b:
            windows.append(win.seal())
            wi += 1
        while si < len(s_marks) and s_marks[si] == b:
            summaries.append(ref.summary())
            if decoded is not None:
                decoded_off += _decoded_off(decoded[si], uniq, exact)
            si += 1
        if b == len(log):
            break
        start, n = log.starts[b], log.counts[b]
        at = (start % pool.size, n)
        cached = deltas.get(at)
        if cached is None or hist:
            rows = pool.rows(start, n)
            keys_np = R.fold64(rows["key_hash"])
            keys = torch.from_numpy(keys_np.astype(np.int64)).to(device)
        if cached is None:
            vals = None
            if geom.quantiles:
                v = np.minimum(rows["aux1"], np.uint64(R.MASK32)).astype(np.int64)
                vals = torch.from_numpy(v).to(device)
            cached = {"ref": ref.delta(keys, vals)}
            if decoded is not None:
                kidx = torch.from_numpy(pool.key_rows(start, n)).to(device)
                cached["exact"] = torch.bincount(inv_t[kidx], minlength=len(uniq))
            if len(deltas) < MAX_CACHED:
                deltas[at] = cached
        ref.fold(cached["ref"], log.drops[b])
        if decoded is not None:
            exact += cached["exact"]
        if hist:
            win.fold(keys, keys_np, rows["mntns"], rows["kind"])
    return {"leaves": ref.leaves(), "summaries": summaries, "windows": windows,
            "decoded_off": decoded_off,
            "qt_counts": ref.qt.cpu().numpy() if geom.quantiles else None,
            "qt_params": {"alpha": geom.qt_alpha, "min_value": geom.qt_min}}


def _decoded_off(pairs, uniq: np.ndarray, exact: torch.Tensor) -> int:
    if not pairs:
        return 0
    keys = np.array([k for k, _ in pairs], np.uint32)
    counts = np.array([c for _, c in pairs], np.int64)
    pos = np.clip(np.searchsorted(uniq, keys), 0, len(uniq) - 1)
    known = uniq[pos] == keys
    truth = exact.cpu().numpy()[pos]
    return int(np.sum(~known | (truth != counts)))


def _words_off(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size, 1)
    return int(np.sum(a.astype(np.float64) != b.astype(np.float64)))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def compare(prog: dict, ref: dict, limits: dict) -> tuple[bool, list[tuple[str, float, float]]]:
    """(correct, [(name, value, limit)]) for the numbers the cell's
    limits name."""
    got: dict[str, float] = {}
    pl, rl = prog["leaves"], ref["leaves"]
    got["state_words_off"] = float(sum(_words_off(pl.get(k, []), v) for k, v in rl.items()))
    sf = dg = eg = qg = 0.0
    ps, rs = prog["summaries"], ref["summaries"]
    if len(ps) != len(rs):
        sf += abs(len(ps) - len(rs))
    misplaced = 0.0
    if ref["qt_counts"] is not None:
        pc, rc = np.asarray(prog["qt_counts"], np.int64), ref["qt_counts"]
        misplaced = float(np.abs(pc - rc).sum())
        got["qt_counts_off"] = misplaced / max(float(rc.sum()), 1.0)
        got["decoded_off"] = float(ref["decoded_off"])
    for p, r in zip(ps, rs):
        sf += sum(p[f] != r[f] for f in ("events", "drops", "heavy_hitters", "approx"))
        dg = max(dg, _rel(p["distinct"], r["distinct"]))
        eg = max(eg, _rel(p["entropy_bits"], r["entropy_bits"]))
        if "qt_state" in r:
            qg += _quantiles_off(p["quantiles"], r["qt_state"], misplaced, ref["qt_params"])
    got["summary_fields_off"] = sf
    got["distinct_gap"] = dg
    got["entropy_gap"] = eg
    if ref["qt_counts"] is not None:
        got["quantiles_off"] = qg
    if ref["windows"] or prog.get("windows"):
        got["window_words_off"] = float(_windows_off(prog.get("windows", []), ref["windows"]))
        got["answers_off"] = float(_answers_off(prog.get("answers", []), ref["windows"],
                                                [w["covers"] for w in prog.get("seal_marks", [])]))
    rows = [(name, got[name], float(limits[name])) for name in limits if name in got]
    ok = all(v <= lim for _, v, lim in rows) and all(name in got for name in limits)
    return ok, rows


def _quantiles_off(values, state, misplaced: float, params: dict) -> int:
    """Quantile values outside the reference's values at the ranks
    `misplaced` events below and above each quantile's rank (the events
    whose bucket the two arithmetics round apart)."""
    c, z, t = state
    lo = R.dd_quantiles(c, z, t, R.QUANTILES, shift=-misplaced, **params)
    hi = R.dd_quantiles(c, z, t, R.QUANTILES, shift=misplaced, **params)
    v = np.asarray(values, np.float64)
    return int(np.sum((v < lo * (1 - 1e-9)) | (v > hi * (1 + 1e-9))))


def _windows_off(pw: list[dict], rw: list[dict]) -> int:
    off = abs(len(pw) - len(rw))
    for p, r in zip(pw, rw):
        for f in ("events", "drops", "cms", "hll", "ent", "topk_keys", "topk_counts",
                  "slices_dropped", "inv_count", "inv_keysum", "inv_fpsum", "qt_zeros",
                  "qt_total", "rs_keys", "rs_weights"):
            if f in r:
                off += _words_off(p.get(f, []), r[f])
        if sorted(p["slices"]) != sorted(r["slices"]):
            off += len(set(p["slices"]) ^ set(r["slices"]))
        for key in set(p["slices"]) & set(r["slices"]):
            off += _slice_off(p["slices"][key], r["slices"][key])
    return off


def _answers_off(answers: list[dict], windows: list[dict], seal_covers: list[int]) -> int:
    """Each standing answer against the merge of the reference windows it
    covers (the newest `windows` sealed by its tick): events and drops
    summed, count-min and entropy buckets summed, HLL registers the max."""
    off = 0
    for a in answers:
        upto = sum(1 for c in seal_covers if c <= a["covers"])
        cov = windows[max(upto - a["windows"], 0):upto]
        if len(cov) != a["windows"] or not cov:
            off += 1
            continue
        merged = {"events": sum(w["events"] for w in cov), "drops": sum(w["drops"] for w in cov),
                  "cms": sum(w["cms"] for w in cov), "ent": sum(w["ent"] for w in cov),
                  "hll": np.max(np.stack([w["hll"] for w in cov]), axis=0)}
        off += sum(_words_off(a[f], v) for f, v in merged.items())
    return off


def _slice_off(p: dict, r: dict) -> int:
    """A slice's events, registers and buckets exactly; its heavy
    hitters: every pair's count the key's exact count, and the counts the
    largest the slice holds."""
    off = int(p["events"] != r["events"])
    off += _words_off(p["hll"], r["hll"]) + _words_off(p["ent"], r["ent"])
    counts = r["counts"]
    hh = p["hh"]
    off += sum(counts.get(int(k), -1) != int(c) for k, c in hh)
    top = sorted(counts.values(), reverse=True)[:R.SLICE_HH_K]
    off += int(sorted((int(c) for _, c in hh), reverse=True) != top)
    return off
