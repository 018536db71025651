"""Invertible heavy-key sketch (PyTorch port of
``inspektor_gadget_tpu/ops/invertible.py``: state, update, merge,
decode and the priority classes).

Per (row, bucket) three integer lanes: ``count`` (sum of weights),
``keysum`` (sum of key*weight mod 2**32) and ``fpsum`` (sum of
fingerprint(key)*weight mod 2**32). Update and merge are integer adds;
the uint32 lanes wrap mod 2**32, which is the algebra the decode
inverts.

Decode peels pure buckets (one distinct key: ``keysum == key*count``
and ``fpsum == fp(key)*count`` mod 2**32, and the key hashes back into
the bucket). `inv_decode_device` is a fixed loop of torch ops on the
state's device that peels odd-count buckets (their count inverts mod
2**32); the numpy host finisher (`inv_decode_finish`) peels the rest to
a fixpoint, even counts included. Both give what the reference's give on
the same state: the residual, the buffer, its fill and every `InvDecode`
field. Recovered counts are exact; recovery is complete while the
distinct keys stay within `inv_capacity`, and partial (``complete`` is
False) beyond it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from .hashing import (MASK32, _row_multiplier, fmix32, fmix32_np, hashed_bucket, mul32,
                      row_salt, u32)
from .lanes import psum

# hash rows disjoint from the count-min rows, fixed so state built
# anywhere merges coherently
INV_ROW_OFFSET = 16
FP_SALT = 0x7F4A7C15
# the host finisher enumerates 2**t candidates for a pure bucket whose
# count has t trailing zero bits; a count divisible by 2**17 or more keeps
# too few key bits in the mod-2**32 key sum and stays in the residual
_MAX_EVEN_T = 16


@dataclass
class InvSketch:
    count: torch.Tensor   # (rows, buckets) int32
    keysum: torch.Tensor  # (rows, buckets) int64 lanes of uint32
    fpsum: torch.Tensor   # (rows, buckets) int64 lanes of uint32
    log2_buckets: int

    @property
    def rows(self) -> int:
        return self.count.shape[0]

    @property
    def buckets(self) -> int:
        return self.count.shape[1]


def inv_init(rows: int = 3, log2_buckets: int = 12,
             device: str | torch.device = "cuda") -> InvSketch:
    d = resolve_device(device)
    shape = (rows, 1 << log2_buckets)
    return InvSketch(count=torch.zeros(shape, dtype=torch.int32, device=d),
                     keysum=torch.zeros(shape, dtype=torch.int64, device=d),
                     fpsum=torch.zeros(shape, dtype=torch.int64, device=d),
                     log2_buckets=log2_buckets)


def inv_capacity(rows: int, log2_buckets: int) -> int:
    """Distinct keys that peel completely with overwhelming probability:
    rows*buckets/4 (a load of 0.25 a cell)."""
    return (rows << log2_buckets) // 4


def inv_bytes(rows: int, log2_buckets: int) -> int:
    """State bytes of one geometry (3 int32 lanes a bucket)."""
    return 3 * 4 * (rows << log2_buckets)


def inv_row_hash(row: int) -> tuple[int, int]:
    """(multiplier, salt) of invertible row `row`."""
    r = INV_ROW_OFFSET + row
    return int(_row_multiplier(r)), row_salt(r)


def inv_fingerprint(keys: torch.Tensor) -> torch.Tensor:
    return fmix32(u32(keys) ^ FP_SALT)


def inv_bucket(keys: torch.Tensor, row: int, log2_buckets: int) -> torch.Tensor:
    mult, salt = inv_row_hash(row)
    return hashed_bucket(keys, mult, salt, log2_buckets)


def inv_lane_values(keys: torch.Tensor, weights: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(count, key*w, fp*w) per event as int64 lanes; count is the int32
    weight itself."""
    k = u32(keys)
    w = weights.to(torch.int64)
    wu = w & MASK32
    return w, mul32(k, wu), mul32(inv_fingerprint(k), wu)


def inv_update(state: InvSketch, keys: torch.Tensor,
               weights: torch.Tensor | None = None) -> InvSketch:
    """Absorb a batch: integer scatter-adds on all three lanes. In place."""
    if weights is None:
        weights = torch.ones(keys.shape, dtype=torch.int32, device=keys.device)
    w, kw, fw = inv_lane_values(keys, weights)
    w = w.to(torch.int32)
    for r in range(state.rows):
        idx = inv_bucket(keys, r, state.log2_buckets)
        state.count[r].index_add_(0, idx, w)
        state.keysum[r].index_add_(0, idx, kw)
        state.fpsum[r].index_add_(0, idx, fw)
    state.keysum.bitwise_and_(MASK32)
    state.fpsum.bitwise_and_(MASK32)
    return state


def inv_merge(a: InvSketch, b: InvSketch) -> InvSketch:
    return InvSketch(count=a.count + b.count,
                     keysum=(a.keysum + b.keysum) & MASK32,
                     fpsum=(a.fpsum + b.fpsum) & MASK32,
                     log2_buckets=a.log2_buckets)


def inv_psum(lanes: Sequence[InvSketch], group=None) -> InvSketch:
    """Cluster-wide merge (reference ``ops/invertible.py:166``): each lane
    summed in lane order, then across `group`. The count wraps as int32;
    the key and fingerprint sums, uint32 lanes kept as int64, are masked
    after the sum."""
    return InvSketch(count=psum([s.count for s in lanes], group),
                     keysum=psum([s.keysum for s in lanes], group).bitwise_and_(MASK32),
                     fpsum=psum([s.fpsum for s in lanes], group).bitwise_and_(MASK32),
                     log2_buckets=lanes[0].log2_buckets)


# -- decode: the device loop ----------------------------------------------------

def modinv32_odd(c: torch.Tensor) -> torch.Tensor:
    """Inverse of odd uint32 lanes mod 2**32 by Newton's iteration (x0 = c
    is right mod 8; each step doubles the right bits). Garbage for even
    lanes; callers mask on oddness."""
    c = u32(c)
    x = c
    for _ in range(4):
        x = mul32(x, (2 - mul32(c, x)) & MASK32)
    return x


def inv_decode_device(state: InvSketch, *, sweeps: int = 4, cap: int = 1024):
    """`sweeps` sweeps of pure-bucket peeling on the state's device ->
    (residual InvSketch, keys (cap,) int64 lanes, counts (cap,) int32,
    n recovered (0-dim int32 tensor)). Each sweep takes the rows in
    order, row r+1 seeing row r's subtractions: it finds the row's pure
    buckets with odd counts, appends their keys to the buffer while it
    has room, and subtracts them from every row. Pure buckets past the
    buffer stay in the residual for the host finisher. Pure buckets that
    fit are written to unique slots and every other bucket to the sink
    slot `cap`, which the cut to [:cap] drops, so the buffer is the same
    whatever order a device's scatter takes. The state is not changed."""
    rows, w, lb = state.rows, state.buckets, state.log2_buckets
    dev = state.count.device
    count, keysum, fpsum = state.count.clone(), state.keysum.clone(), state.fpsum.clone()
    arange_w = torch.arange(w, dtype=torch.int64, device=dev)
    keys_buf = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    cnt_buf = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    cursor = torch.zeros((), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(sweeps):
        for r in range(rows):
            cnt = count[r]
            cnt_u = u32(cnt)
            odd = (cnt > 0) & ((cnt & 1) == 1)
            cand = mul32(keysum[r], modinv32_odd(cnt_u))
            fp = inv_fingerprint(cand)
            pure = (odd & (cand != 0) & (fpsum[r] == mul32(fp, cnt_u))
                    & (inv_bucket(cand, r, lb) == arange_w))
            pos = cursor + torch.cumsum(pure.to(torch.int32), 0, dtype=torch.int32) - 1
            fits = pure & (pos < cap)
            slot = torch.where(fits, pos, cap).to(torch.int64)
            c_rec = torch.where(fits, cnt, zero)
            keys_buf[slot] = torch.where(fits, cand, 0)
            cnt_buf[slot] = c_rec
            cursor = cursor + fits.sum(dtype=torch.int32)
            c_u = u32(c_rec)
            kc, fc = mul32(cand, c_u), mul32(fp, c_u)
            for r2 in range(rows):
                idx2 = inv_bucket(cand, r2, lb)
                count[r2].index_add_(0, idx2, -c_rec)
                keysum[r2].index_add_(0, idx2, (-kc) & MASK32)
                fpsum[r2].index_add_(0, idx2, (-fc) & MASK32)
            keysum.bitwise_and_(MASK32)
            fpsum.bitwise_and_(MASK32)
    residual = InvSketch(count=count, keysum=keysum, fpsum=fpsum, log2_buckets=lb)
    return residual, keys_buf[:cap], cnt_buf[:cap], cursor


# -- decode: the host finisher (numpy) ------------------------------------------

@dataclasses.dataclass
class InvDecode:
    """One decode: exact (key32, total weight) pairs, heaviest first;
    `complete` says whether every lane drained to zero (False: the
    distinct-key load passed the peeling capacity and coverage is
    partial, not wrong)."""

    keys: list[tuple[int, int]]
    recovered: int
    residual_events: int      # weight left undecoded (row-0 count sum)
    complete: bool
    sweeps: int

    def top(self, k: int) -> list[tuple[int, int]]:
        return self.keys[:k]


def _fp_np(keys: np.ndarray) -> np.ndarray:
    return fmix32_np(np.asarray(keys, np.uint32) ^ np.uint32(FP_SALT))


def _bucket_np(keys: np.ndarray, row: int, log2_buckets: int) -> np.ndarray:
    mult, salt = inv_row_hash(row)
    h = fmix32_np(np.asarray(keys, np.uint32) * np.uint32(mult) + np.uint32(salt))
    return (h >> np.uint32(32 - log2_buckets)).astype(np.int64)


def _modinv32_np(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, np.uint32)
    x = c.copy()
    for _ in range(4):
        x = (x * ((np.uint32(2) - c * x).astype(np.uint32))).astype(np.uint32)
    return x


def _host_peel(count: np.ndarray, keysum: np.ndarray, fpsum: np.ndarray,
               log2_buckets: int, recovered: dict[int, int], max_sweeps: int) -> int:
    """Numpy peeling to a fixpoint, even counts included: an even count
    2**t * odd fixes the key's low 32-t bits, the t high bits are
    enumerated (t <= _MAX_EVEN_T) and a unique survivor of the bucket and
    fingerprint checks is taken. Returns the sweeps used."""
    rows, w = count.shape
    arange_w = np.arange(w, dtype=np.int64)
    sweeps = 0
    for _ in range(max_sweeps):
        sweeps += 1
        progress = False
        for r in range(rows):
            cnt = count[r]
            live = cnt > 0
            if not live.any():
                continue
            keys_r: list[np.ndarray] = []
            cnts_r: list[np.ndarray] = []
            cnt_u = cnt.astype(np.uint32)
            odd = live & ((cnt & 1) == 1)
            if odd.any():
                cand = (keysum[r] * _modinv32_np(cnt_u)).astype(np.uint32)
                ok = (odd & (cand != 0) & (fpsum[r] == _fp_np(cand) * cnt_u)
                      & (_bucket_np(cand, r, log2_buckets) == arange_w))
                if ok.any():
                    keys_r.append(cand[ok])
                    cnts_r.append(cnt[ok].astype(np.int64))
            even = live & ((cnt & 1) == 0)
            if even.any():
                idxs = np.flatnonzero(even)
                c = cnt[idxs].astype(np.int64)
                t = np.zeros(len(idxs), np.int64)
                cc = c.copy()
                while ((cc & 1) == 0).any():
                    sel = (cc & 1) == 0
                    cc[sel] >>= 1
                    t[sel] += 1
                keep = t <= _MAX_EVEN_T
                idxs, c, t, cc = idxs[keep], c[keep], t[keep], cc[keep]
                if idxs.size:
                    base = (keysum[r][idxs] * _modinv32_np(cc.astype(np.uint32))).astype(np.uint32)
                    # base = key << t (mod 2**32): its low t bits must be zero
                    low_ok = (base & ((np.uint32(1) << t.astype(np.uint32)) - np.uint32(1))) == 0
                    for j in np.flatnonzero(low_ok):
                        b_i, tt, cn = int(idxs[j]), int(t[j]), int(c[j])
                        low = int(base[j]) >> tt
                        cands = ((np.arange(1 << tt, dtype=np.uint64) << np.uint64(32 - tt))
                                 | np.uint64(low)).astype(np.uint32)
                        ok = cands != 0
                        ok &= _bucket_np(cands, r, log2_buckets) == b_i
                        ok &= (_fp_np(cands) * np.uint32(cn & MASK32)).astype(np.uint32) \
                            == fpsum[r][b_i]
                        hits = np.flatnonzero(ok)
                        if hits.size == 1:  # two or more survivors stay undecoded
                            keys_r.append(cands[hits])
                            cnts_r.append(np.asarray([cn], np.int64))
            if not keys_r:
                continue
            progress = True
            kk = np.concatenate(keys_r)
            cc = np.concatenate(cnts_r)
            cu = cc.astype(np.uint32)
            for r2 in range(rows):
                idx2 = _bucket_np(kk, r2, log2_buckets)
                np.subtract.at(count[r2], idx2, cc.astype(count.dtype))
                np.subtract.at(keysum[r2], idx2, (kk * cu).astype(np.uint32))
                np.subtract.at(fpsum[r2], idx2, (_fp_np(kk) * cu).astype(np.uint32))
            for k, c_ in zip(kk.tolist(), cc.tolist()):
                recovered[int(k)] = recovered.get(int(k), 0) + int(c_)
        if not progress:
            break
    return sweeps


def _finish(count: np.ndarray, keysum: np.ndarray, fpsum: np.ndarray, log2_buckets: int,
            recovered: dict[int, int], host_sweeps: int, min_count: int) -> InvDecode:
    sweeps = _host_peel(count, keysum, fpsum, log2_buckets, recovered, host_sweeps)
    keys = sorted(((k, c) for k, c in recovered.items() if c >= min_count),
                  key=lambda kv: (-kv[1], kv[0]))
    complete = bool((count == 0).all() and (keysum == 0).all() and (fpsum == 0).all())
    return InvDecode(keys=keys, recovered=len(keys),
                     residual_events=int(np.maximum(count[0], 0).sum()),
                     complete=complete, sweeps=sweeps)


def _host_lanes(state: InvSketch) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(count int64, keysum uint32, fpsum uint32) numpy copies."""
    return (state.count.detach().cpu().numpy().astype(np.int64),
            state.keysum.detach().cpu().numpy().astype(np.uint32),
            state.fpsum.detach().cpu().numpy().astype(np.uint32))


def inv_decode_finish(residual: InvSketch, keys_buf, cnt_buf, n, *, host_sweeps: int = 32,
                      min_count: int = 1) -> InvDecode:
    """Host finisher over an `inv_decode_device` result: the buffer's
    first n keys, then numpy peeling of the residual to a fixpoint."""
    recovered: dict[int, int] = {}
    n = int(n)
    keys = np.asarray(torch.as_tensor(keys_buf).cpu())[:n].astype(np.uint32)
    cnts = np.asarray(torch.as_tensor(cnt_buf).cpu())[:n]
    for k, c in zip(keys.tolist(), cnts.tolist()):
        if k:
            recovered[int(k)] = recovered.get(int(k), 0) + int(c)
    return _finish(*_host_lanes(residual), residual.log2_buckets, recovered, host_sweeps,
                   min_count)


def inv_decode(state, *, device_sweeps: int = 4, host_sweeps: int = 32, cap: int = 1024,
               min_count: int = 1) -> InvDecode:
    """Full decode of one (merged) invertible sketch: an InvSketch runs
    the device loop on its own device, then the host finisher; a
    (count, keysum, fpsum) tuple of numpy arrays goes to the host
    finisher alone."""
    if isinstance(state, InvSketch):
        dev = inv_decode_device(state, sweeps=device_sweeps, cap=cap)
        return inv_decode_finish(*dev, host_sweeps=host_sweeps, min_count=min_count)
    count, keysum, fpsum = state
    count = np.asarray(count).astype(np.int64)
    keysum = np.asarray(keysum).astype(np.uint32)
    fpsum = np.asarray(fpsum).astype(np.uint32)
    return _finish(count, keysum, fpsum, int(count.shape[1]).bit_length() - 1, {},
                   host_sweeps, min_count)


# -- priority classes --------------------------------------------------------
# Per-tenant accuracy classes under one fixed memory budget (the
# reference's ``ops/invertible.py:438-572``): each class is its own
# invertible sketch over the events of its tenants (mntns), and the
# classes partition the base geometry's bytes.

@dataclasses.dataclass(frozen=True)
class InvClass:
    """One accuracy class: its own bucket geometry and the tenant
    (mntns) set it serves. `tenants is None` marks the '*' catch-all."""

    name: str
    log2_buckets: int
    tenants: tuple[int, ...] | None

    @property
    def is_default(self) -> bool:
        return self.tenants is None


def parse_priority_classes(text: str) -> list[InvClass]:
    """Parse ``name=log2buckets:tenant|tenant,...`` (one class must take
    ``*``, the catch-all). Raises ValueError naming the offending class
    on any malformed entry — the loud-validation contract."""
    classes: list[InvClass] = []
    names: set[str] = set()
    tenants_seen: dict[int, str] = {}
    defaults = 0
    if not text.strip():
        raise ValueError("empty priority-classes spec")
    for part in text.split(","):
        part = part.strip()
        if not part:
            raise ValueError("empty class entry (stray comma?)")
        if "=" not in part:
            raise ValueError(f"class {part!r}: expected "
                             "name=log2buckets:tenants")
        name, rest = part.split("=", 1)
        name = name.strip()
        if not name:
            raise ValueError(f"class {part!r}: empty class name")
        if name in names:
            raise ValueError(f"duplicate class name {name!r}")
        names.add(name)
        if ":" not in rest:
            raise ValueError(f"class {name!r}: expected "
                             "log2buckets:tenants after '='")
        lb_s, ten_s = rest.split(":", 1)
        try:
            lb = int(lb_s)
        except ValueError:
            raise ValueError(f"class {name!r}: log2buckets {lb_s!r} is "
                             "not an integer") from None
        if not 6 <= lb <= 20:
            raise ValueError(f"class {name!r}: log2buckets {lb} outside "
                             "[6, 20]")
        ten_s = ten_s.strip()
        if ten_s == "*":
            defaults += 1
            if defaults > 1:
                raise ValueError(f"class {name!r}: second '*' catch-all "
                                 "(exactly one default class)")
            classes.append(InvClass(name=name, log2_buckets=lb,
                                    tenants=None))
            continue
        tenants: list[int] = []
        for t in ten_s.split("|"):
            t = t.strip()
            if not t:
                raise ValueError(f"class {name!r}: empty tenant entry")
            try:
                tv = int(t)
            except ValueError:
                raise ValueError(f"class {name!r}: tenant {t!r} is not a "
                                 "mntns integer") from None
            if tv in tenants_seen:
                raise ValueError(
                    f"class {name!r}: tenant {tv} already claimed by "
                    f"class {tenants_seen[tv]!r}")
            tenants_seen[tv] = name
            tenants.append(tv)
        if not tenants:
            raise ValueError(f"class {name!r}: no tenants")
        classes.append(InvClass(name=name, log2_buckets=lb,
                                tenants=tuple(tenants)))
    if defaults == 0:
        raise ValueError("no '*' catch-all class — every stream needs a "
                         "home (add e.g. rest=<log2b>:*)")
    return classes


def validate_class_budget(classes: list[InvClass], *, rows: int,
                          log2_buckets: int) -> None:
    """The classes PARTITION the base geometry's memory: sum of per-class
    state bytes must fit inside inv-rows × 2^inv-log2-buckets — priority
    is a reallocation, never a growth. Raises ValueError with the exact
    byte arithmetic."""
    budget = inv_bytes(rows, log2_buckets)
    spent = sum(inv_bytes(rows, c.log2_buckets) for c in classes)
    if spent > budget:
        detail = " + ".join(
            f"{c.name}:{inv_bytes(rows, c.log2_buckets)}" for c in classes)
        raise ValueError(
            f"priority classes need {spent} bytes ({detail}) but the "
            f"base geometry budgets {budget} (inv-rows {rows} x "
            f"2^{log2_buckets} buckets x 3 lanes x 4B) — shrink a class "
            "or grow inv-log2-buckets")


def class_weights(classes: list[InvClass], mntns: np.ndarray,
                  weights: np.ndarray) -> list[np.ndarray]:
    """Per-class effective weight vectors for one batch: an event's
    weight lands in exactly one class (its tenant's, else the '*'
    catch-all), so summing per-class decodes reproduces whole-stream
    totals exactly."""
    mntns = np.asarray(mntns)
    weights = np.asarray(weights)
    claimed = np.zeros(mntns.shape, bool)
    out: list[np.ndarray] = []
    masks: list[np.ndarray] = []
    for c in classes:
        if c.is_default:
            masks.append(None)
            continue
        m = np.isin(mntns, np.asarray(c.tenants, dtype=mntns.dtype))
        claimed |= m
        masks.append(m)
    for c, m in zip(classes, masks):
        if m is None:
            m = ~claimed
        out.append((weights * m).astype(np.uint32))
    return out

