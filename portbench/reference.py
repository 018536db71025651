"""The plain reference: the sketch plane's semantics folded from the raw
events in plain PyTorch, batch by batch.

It imports nothing of the program. The hashes are frozen copies of the
sketch plane's published arithmetic (multiply-shift over the murmur3
finalizer, the count-min rows' fixed odd multipliers, the invertible
plane's fingerprint); everything else follows from what the state means:

  count-min   int32 counts of each key's hashed bucket, a table a row
  HLL         per register, the largest rank (leading zeros + 1) seen
  entropy     float32 bucket counts, each batch's exact count added once
  top-k       the k keys of the largest count-min estimate among every
              key seen, ties to the smaller key; `overflow` once more
              than k keys were candidates
  invertible  per bucket: int32 count, uint32 sums of key and
              fingerprint
  DDSketch    counts of ceil(ln v / ln gamma) buckets, zeros, total

Estimates are float64: distinct by HLL's formula with linear counting
and the large-range correction, entropy as log2 N - sum c log2 c / N.
With ``control=True`` every float32 leaf and estimate is bfloat16
instead: the nearest precision below the one the configuration states.

A sealed window's payload is folded the same way over the batches it
covers (`WindowRef`); its slices follow the per-container and per-kind
subpopulation rule (at most `max_slices`, in creation order).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
ROW_MULTIPLIERS = [0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
                   0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09]
INV_ROW_OFFSET = 16
FP_SALT = 0x7F4A7C15
SLICE_HLL_P = 8
SLICE_ENT_LOG2_WIDTH = 6
SLICE_HH_K = 32


def row_multiplier(row: int) -> int:
    if row < len(ROW_MULTIPLIERS):
        return ROW_MULTIPLIERS[row]
    z = (row * 0x9E3779B9 + 0x6A09E667) & MASK32
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & MASK32
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & MASK32
    return (z ^ (z >> 16)) | 1


def row_salt(row: int) -> int:
    return (row * 0x9E3779B9) & MASK32


def fold64(k: np.ndarray) -> np.ndarray:
    """uint64 key hashes xor-folded to uint32."""
    k = np.asarray(k, np.uint64)
    return ((k >> np.uint64(32)) ^ (k & np.uint64(MASK32))).astype(np.uint32)


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 on int64 lanes, in 16-bit halves."""
    lo, hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def bucket(keys: torch.Tensor, row: int, log2_width: int) -> torch.Tensor:
    h = fmix32((mul32(keys, row_multiplier(row)) + row_salt(row)) & MASK32)
    return h >> (32 - log2_width)


def hll_index_rank(keys: torch.Tensor, p: int) -> tuple[torch.Tensor, torch.Tensor]:
    h = fmix32(keys)
    idx = h >> (32 - p)
    rest = ((h << p) & MASK32) | ((1 << p) - 1)
    bitlen = torch.frexp(rest.to(torch.float64)).exponent.to(torch.int64)
    return idx, torch.clamp(32 - bitlen, 0, 32 - p) + 1


def hll_estimate(regs: torch.Tensor, dtype=torch.float64) -> float:
    m = regs.numel()
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1 + 1.079 / m))
    inv = torch.exp2(-regs.to(dtype))
    raw = (torch.tensor(alpha * m * m, dtype=dtype) / inv.sum().cpu()).item()
    zeros = int((regs == 0).sum())
    est = m * math.log(m / max(zeros, 1)) if (raw <= 2.5 * m and zeros > 0) else raw
    if est > 2.0 ** 32 / 30.0:
        est = -(2.0 ** 32) * math.log1p(-est / 2.0 ** 32)
    return float(torch.tensor(est, dtype=dtype).item())


def entropy_bits(counts: torch.Tensor, dtype=torch.float64) -> float:
    c = counts.to(dtype)
    n = c.sum()
    if float(n) <= 0:
        return 0.0
    pos = c[c > 0]
    plogp = (pos * torch.log2(pos)).sum()
    return float((torch.log2(n) - plogp / n).item())


def qt_bucket_constants(alpha: float, min_value: float) -> tuple[float, float]:
    gamma = (1.0 + alpha) / (1.0 - alpha)
    ilg = 1.0 / math.log(gamma)
    return float(np.float32(ilg)), float(np.float32(math.log(min_value) * ilg))


QUANTILES = (0.5, 0.9, 0.99, 0.999)


def dd_quantiles(counts: np.ndarray, zeros: float, total: float, qs, *, alpha: float,
                 min_value: float, shift: float = 0.0) -> np.ndarray:
    """Value at each quantile: the bucket midpoint 2 gamma**i / (gamma + 1),
    0 inside the zero bucket; with `shift`, at the rank `shift` events
    above (or below) the quantile's."""
    gamma = (1.0 + alpha) / (1.0 - alpha)
    qs = np.asarray(qs, np.float64)
    if total <= 0:
        return np.zeros(len(qs))
    rank = np.clip(qs * max(float(total) - 1.0, 0.0) + shift, 0.0, max(float(total) - 1.0, 0.0))
    cum = float(zeros) + np.cumsum(np.asarray(counts, np.float64))
    b = np.clip((cum[None, :] <= rank[:, None]).sum(axis=1), 0, len(cum) - 1)
    lg = math.log(gamma)
    mid = 2.0 * np.exp((b + math.log(min_value) / lg) * lg) / (gamma + 1.0)
    return np.where(rank < float(zeros), 0.0, mid)


def splitmix_priority(keys: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = keys.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


class Geometry:
    """The sketch plane's sizes, from the configuration's operator block
    (the operator's documented defaults where a key is absent)."""

    def __init__(self, op: dict):
        def get(key, default):
            return op.get(key, default)

        self.depth = int(get("depth", 4))
        self.log2_width = int(get("log2-width", 16))
        self.hll_p = int(get("hll-p", 14))
        self.ent_log2 = int(get("entropy-log2-width", 12))
        self.k = int(get("topk", 128))
        self.inv_rows = int(get("inv-rows", 3)) if get("invertible", "false") == "true" else 0
        self.inv_log2 = int(get("inv-log2-buckets", 12))
        self.quantiles = get("quantiles", "false") == "true"
        self.qt_alpha = float(get("quantile-alpha", 0.01))
        self.qt_buckets = 2048
        self.qt_min = 1.0
        self.history = get("history", "false") == "true"
        self.hist_log2 = int(get("history-log2-width", 12))
        self.max_slices = int(get("history-max-slices", 256))
        self.audit = int(get("audit-sample", 0))


class Reference:
    """The cumulative state, folded batch by batch on `device`."""

    def __init__(self, geom: Geometry, device: torch.device, control: bool = False):
        self.g = geom
        self.dev = device
        self.fdt = torch.bfloat16 if control else torch.float32
        self.edt = torch.bfloat16 if control else torch.float64
        d = device
        self.cms = torch.zeros((geom.depth, 1 << geom.log2_width), dtype=torch.int64, device=d)
        self.cms_total = torch.zeros((), dtype=self.fdt, device=d)
        self.hll = torch.zeros(1 << geom.hll_p, dtype=torch.int64, device=d)
        self.ent = torch.zeros(1 << geom.ent_log2, dtype=self.fdt, device=d)
        self.tk_keys = torch.zeros(0, dtype=torch.int64, device=d)
        self.tk_counts = torch.zeros(0, dtype=torch.int64, device=d)
        self.overflow = 0
        self.events = torch.zeros((), dtype=self.fdt, device=d)
        self.drops = torch.zeros((), dtype=self.fdt, device=d)
        self._drops_seen = 0
        if geom.inv_rows:
            shape = (geom.inv_rows, 1 << geom.inv_log2)
            self.inv = [torch.zeros(shape, dtype=torch.int64, device=d) for _ in range(3)]
        if geom.quantiles:
            self.qt = torch.zeros(geom.qt_buckets, dtype=torch.int64, device=d)
            self.qt_zeros = 0
            self.qt_total = 0
            self._ilg, self._off = qt_bucket_constants(geom.qt_alpha, geom.qt_min)

    def delta(self, keys: torch.Tensor, values: torch.Tensor | None) -> dict:
        """One batch's contribution to every plane: `keys` the uint32
        keys (int64 lanes) of its events, `values` their uint32 value
        lane. A batch that recurs (the backlog's pool) reuses it."""
        g, n = self.g, keys.numel()
        one = torch.ones_like(keys)
        cms = torch.zeros_like(self.cms)
        for r in range(g.depth):
            cms[r].index_add_(0, bucket(keys, r, g.log2_width), one)
        idx, rank = hll_index_rank(keys, g.hll_p)
        hll = torch.zeros_like(self.hll).scatter_reduce_(0, idx, rank, reduce="amax")
        d = {"n": n, "cms": cms, "hll": hll,
             "ent": torch.bincount(bucket(keys, 0, g.ent_log2), minlength=1 << g.ent_log2),
             "keys": torch.unique(keys[keys != 0])}
        if g.inv_rows:
            fp = fmix32(keys ^ FP_SALT)
            inv = [torch.zeros_like(t) for t in self.inv]
            for r in range(g.inv_rows):
                b = bucket(keys, INV_ROW_OFFSET + r, g.inv_log2)
                inv[0][r].index_add_(0, b, one)
                inv[1][r].index_add_(0, b, keys)
                inv[2][r].index_add_(0, b, fp)
            d["inv"] = inv
        if g.quantiles:
            v = values.to(torch.float32).to(self.edt)
            nz = v > 0
            b = torch.ceil(torch.log(torch.clamp(v, min=g.qt_min)) * self._ilg - self._off)
            b = torch.clamp(b, 0, g.qt_buckets - 1).to(torch.int64)[nz]
            d["qt"] = torch.bincount(b, minlength=g.qt_buckets)
            d["qt_zeros"] = int(n - int(nz.sum()))
        return d

    def fold(self, d: dict, drops_cum: int) -> None:
        """Add one batch's `delta`, with the cumulative upstream drops it
        reported, and refresh the top-k against the updated count-min."""
        g, n = self.g, d["n"]
        self.cms += d["cms"]
        self.cms_total += torch.tensor(float(n), dtype=self.fdt, device=self.dev)
        torch.maximum(self.hll, d["hll"], out=self.hll)
        self.ent += d["ent"].to(self.fdt)
        self.events += torch.tensor(float(n), dtype=self.fdt, device=self.dev)
        new = drops_cum - self._drops_seen
        self._drops_seen = drops_cum
        if new > 0:
            self.drops += torch.tensor(float(new), dtype=self.fdt, device=self.dev)
        cand = torch.unique(torch.cat([self.tk_keys, d["keys"]]))
        est = self.query(cand)
        order = torch.sort(-est, stable=True).indices[:g.k]
        self.overflow = max(self.overflow, int(cand.numel() > g.k))
        self.tk_keys, self.tk_counts = cand[order], est[order]
        if g.inv_rows:
            for t, dt in zip(self.inv, d["inv"]):
                t += dt
            self.inv[1] &= MASK32
            self.inv[2] &= MASK32
        if g.quantiles:
            self.qt += d["qt"]
            self.qt_zeros += d["qt_zeros"]
            self.qt_total += n

    def query(self, keys: torch.Tensor) -> torch.Tensor:
        est = torch.stack([self.cms[r][bucket(keys, r, self.g.log2_width)]
                           for r in range(self.g.depth)])
        return est.min(dim=0).values

    def topk_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(keys uint32, counts int64), k slots, empty slots zero."""
        k = self.g.k
        keys = np.zeros(k, np.uint32)
        counts = np.zeros(k, np.int64)
        m = self.tk_keys.numel()
        keys[:m] = self.tk_keys.cpu().numpy().astype(np.uint32)
        counts[:m] = self.tk_counts.cpu().numpy()
        return keys, counts

    def summary(self) -> dict:
        keys, counts = self.topk_arrays()
        out = {"events": float(self.events), "drops": float(self.drops),
               "distinct": hll_estimate(self.hll, self.edt),
               "entropy_bits": entropy_bits(self.ent, self.edt),
               "heavy_hitters": [(int(k), int(c)) for k, c in zip(keys, counts) if k != 0],
               "approx": bool(self.overflow)}
        if self.g.quantiles:
            c = self.qt.cpu().numpy().copy()
            out["quantiles"] = dd_quantiles(
                c, self.qt_zeros, self.qt_total, QUANTILES,
                alpha=self.g.qt_alpha, min_value=self.g.qt_min).tolist()
            out["qt_state"] = (c, self.qt_zeros, self.qt_total)
        return out

    def leaves(self) -> dict[str, np.ndarray]:
        """The state as named arrays, in the integer and float types the
        configuration states (float32 leaves as float64 values)."""
        keys, counts = self.topk_arrays()
        out = {"cms.table": self.cms.cpu().numpy(),
               "cms.total": np.array([float(self.cms_total)]),
               "hll.registers": self.hll.cpu().numpy(),
               "entropy.counts": self.ent.to(torch.float64).cpu().numpy(),
               "topk.keys": keys.astype(np.int64), "topk.counts": counts,
               "topk.overflow": np.array([self.overflow]),
               "events": np.array([float(self.events)]),
               "drops": np.array([float(self.drops)])}
        if self.g.inv_rows:
            out["inv.count"] = self.inv[0].cpu().numpy()
            out["inv.keysum"] = self.inv[1].cpu().numpy()
            out["inv.fpsum"] = self.inv[2].cpu().numpy()
        if self.g.quantiles:
            out["qt.zeros"] = np.array([self.qt_zeros])
            out["qt.total"] = np.array([self.qt_total])
        return out


class WindowRef:
    """The open window of the history plane, folded over the batches a
    seal covers: its count-min slot, its HLL, its slices and its shadow
    sample; the entropy, invertible and quantile lanes are deltas of the
    cumulative state (`Reference`) between two seals."""

    def __init__(self, geom: Geometry, device: torch.device, cum: Reference):
        self.g, self.dev, self.cum = geom, device, cum
        self._base = self._cum_snapshot()
        self._open()

    def _cum_snapshot(self) -> dict:
        c = self.cum
        snap = {"events": float(c.events), "drops": float(c.drops),
                "ent": c.ent.to(torch.float32).cpu().numpy().copy()}
        if self.g.inv_rows:
            snap["inv"] = [t.cpu().numpy().copy() for t in c.inv]
        if self.g.quantiles:
            snap["qt"] = (c.qt.cpu().numpy().copy(), c.qt_zeros, c.qt_total)
        return snap

    def _open(self) -> None:
        g = self.g
        self.cms = torch.zeros((g.depth, 1 << g.hist_log2), dtype=torch.int64, device=self.dev)
        self.hll = torch.zeros(1 << g.hll_p, dtype=torch.int64, device=self.dev)
        self.slice_order: list[str] = []
        self.slice_dropped: set[str] = set()
        self.slice_rows: dict[str, list[np.ndarray]] = {}
        self.shadow_keys: list[np.ndarray] = []

    def fold(self, keys: torch.Tensor, keys_np: np.ndarray, mntns: np.ndarray,
             kind: np.ndarray) -> None:
        g = self.g
        for r in range(g.depth):
            self.cms[r].index_add_(0, bucket(keys, r, g.hist_log2), torch.ones_like(keys))
        idx, rank = hll_index_rank(keys, g.hll_p)
        self.hll.scatter_reduce_(0, idx, rank, reduce="amax")
        if g.audit:
            self.shadow_keys.append(keys_np)
        # the subpopulation slices, in the order a batch creates them:
        # each container (ascending), then its kinds (ascending), then
        # every kind; past max_slices a new key is only counted dropped
        pairs = np.unique((mntns.astype(np.uint64) << np.uint64(8)) | kind.astype(np.uint64))
        kinds = np.unique(kind)
        order: list[str] = []
        prev = None
        for code in pairs.tolist():
            ns, k = code >> 8, code & 0xFF
            if ns != prev:
                order.append(f"mntns:{ns}")
                prev = ns
            order.append(f"mntns:{ns}|kind:{k}")
        order += [f"kind:{k}" for k in kinds.tolist()]
        for key in order:
            if key not in self.slice_rows:
                if len(self.slice_rows) >= g.max_slices:
                    self.slice_dropped.add(key)
                    continue
                self.slice_rows[key] = []
                self.slice_order.append(key)
        code = (mntns.astype(np.uint64) << np.uint64(8)) | kind.astype(np.uint64)
        for label, col in (("m", mntns.astype(np.uint64)), ("p", code), ("k", kind)):
            srt = np.argsort(col, kind="stable")
            vals, first = np.unique(col[srt], return_index=True)
            bounds = list(first) + [len(col)]
            for j, v in enumerate(vals.tolist()):
                if label == "m":
                    key = f"mntns:{v}"
                elif label == "p":
                    key = f"mntns:{v >> 8}|kind:{v & 0xFF}"
                else:
                    key = f"kind:{v}"
                rows = self.slice_rows.get(key)
                if rows is not None:
                    rows.append(keys_np[srt[bounds[j]:bounds[j + 1]]])

    def seal(self) -> dict:
        """The window's payload as the reference computes it, and a new
        window opened."""
        g, c = self.g, self.cum
        now = self._cum_snapshot()
        cand, _ = c.topk_arrays()
        cand_t = torch.from_numpy(cand.astype(np.int64)).to(self.dev)
        counts = torch.stack([self.cms[r][bucket(cand_t, r, g.hist_log2)]
                              for r in range(g.depth)]).min(dim=0).values.cpu().numpy()
        order = np.argsort(-counts)
        keep = [(int(cand[i]), int(counts[i])) for i in order if cand[i] != 0 and counts[i] > 0]
        out = {"events": int(now["events"] - self._base["events"]),
               "drops": int(now["drops"] - self._base["drops"]),
               "cms": self.cms.cpu().numpy(),
               "hll": self.hll.cpu().numpy(),
               "ent": (now["ent"] - self._base["ent"]).astype(np.float64),
               "topk_keys": np.array([k for k, _ in keep], np.int64),
               "topk_counts": np.array([v for _, v in keep], np.int64),
               "slices": {key: slice_state(np.concatenate(self.slice_rows[key]))
                          for key in self.slice_order},
               "slices_dropped": len(self.slice_dropped)}
        if g.inv_rows:
            out["inv_count"] = now["inv"][0] - self._base["inv"][0]
            out["inv_keysum"] = (now["inv"][1] - self._base["inv"][1]) & MASK32
            out["inv_fpsum"] = (now["inv"][2] - self._base["inv"][2]) & MASK32
        if g.quantiles:
            out["qt_zeros"] = now["qt"][1] - self._base["qt"][1]
            out["qt_total"] = now["qt"][2] - self._base["qt"][2]
            out["qt_counts"] = now["qt"][0] - self._base["qt"][0]
        if g.audit:
            keys = (np.concatenate(self.shadow_keys) if self.shadow_keys
                    else np.zeros(0, np.uint32))
            uk, cnt = np.unique(keys, return_counts=True)
            o = np.lexsort((uk, splitmix_priority(uk)))[:g.audit]
            out["rs_keys"], out["rs_weights"] = uk[o].astype(np.int64), cnt[o].astype(np.int64)
        self._base = now
        self._open()
        return out


def slice_state(keys: np.ndarray) -> dict:
    """One slice's window state from its events' uint32 keys: events,
    HLL registers (p 8), entropy buckets (64) over the murmur3 finalizer,
    and the exact count of each key."""
    t = torch.from_numpy(keys.astype(np.int64))
    h = fmix32(t)
    idx = (h >> (32 - SLICE_HLL_P)).numpy()
    rest = ((h << SLICE_HLL_P) & MASK32) | ((1 << SLICE_HLL_P) - 1)
    rank = 32 - torch.frexp(rest.to(torch.float64)).exponent.numpy() + 1
    rank = np.minimum(rank, 32 - SLICE_HLL_P + 1)
    hll = np.zeros(1 << SLICE_HLL_P, np.int64)
    np.maximum.at(hll, idx, rank)
    ent = np.bincount((h >> (32 - SLICE_ENT_LOG2_WIDTH)).numpy(),
                      minlength=1 << SLICE_ENT_LOG2_WIDTH).astype(np.int64)
    uk, cnt = np.unique(keys[keys != 0], return_counts=True)
    top = np.lexsort((uk, -cnt))[:SLICE_HH_K]
    return {"events": int(keys.size), "hll": hll, "ent": ent,
            "counts": dict(zip(uk.tolist(), cnt.tolist())),
            "hh": [(int(uk[i]), int(cnt[i])) for i in top]}
