"""Accuracy audit plane: analytic error envelopes and a mergeable
ground-truth shadow sample (the port's copy of
``inspektor_gadget_tpu/ops/accuracy.py``, numpy only).

Every answer the system serves is a sketch estimate; this module makes
the error of those estimates observable, two ways:

- **Analytic envelopes** derived from live geometry and observed mass:
  the CMS overestimate bound e/width · N at confidence 1 − e^−depth,
  the HLL ±1.04/√m standard error with the linear-counting regime
  labelled, DDSketch's α relative rank bound, and the first-order
  entropy collision-bias bound (distinct − 1)/(2·width·ln 2) bits.

- **Observed error** from a deterministic bottom-k **shadow sample**
  that rides harvests host-side. Priorities are a fixed splitmix64 of
  the key (no RNG anywhere), so the sample is a pure function of the
  multiset of (key, weight) contributions: merge is union-by-key and
  keep the k smallest priorities, bit-identical under any fold order. A
  key that survives the final bottom-k was never evicted, so surviving
  weights are exact totals: ground truth for heavy-hitter counts and an
  inverse-probability estimator for distinct and entropy.
"""

from __future__ import annotations

import math
import threading

import numpy as np

from ..telemetry.registry import counter, gauge

__all__ = [
    "ShadowSample", "shadow_priorities",
    "cms_bound", "hll_bound", "dd_bound", "entropy_bias_bound",
    "accuracy_block", "accuracy_ratio",
    "AccuracyStats", "live_stats",
    "HLL_STDERR_CONST", "LINEAR_COUNTING_FACTOR",
]

# -- analytic envelopes ------------------------------------------------------

# HLL standard-error constant and the linear-counting switchover factor
# (estimate ≤ 2.5·m) — named so docs/observability.md's formulas can be
# drift-tested against the code's constants.
HLL_STDERR_CONST = 1.04
LINEAR_COUNTING_FACTOR = 2.5


def cms_bound(depth: int, width: int, events: float) -> dict:
    """Count-min overestimate envelope at the live geometry: with width
    w and depth d, ĉ − c ≤ N·e/w with probability 1 − e^−d
    (ops/countmin.py's guarantee, evaluated at the actual harvested
    event total N)."""
    rel = math.e / max(int(width), 1)
    return {
        "bound": rel,                       # relative to total events N
        "bound_abs": rel * max(float(events), 0.0),
        "confidence": 1.0 - math.exp(-max(int(depth), 1)),
    }


def hll_bound(p: int, estimate: float | None = None) -> dict:
    """HLL relative standard error ±1.04/√m with m = 2^p registers; the
    regime label flips to linear_counting below 2.5·m, where the
    estimator switches formula and the 1.04/√m envelope is
    conservative rather than tight."""
    m = 1 << int(p)
    regime = "raw"
    if estimate is not None and float(estimate) <= LINEAR_COUNTING_FACTOR * m:
        regime = "linear_counting"
    return {"bound": HLL_STDERR_CONST / math.sqrt(m), "regime": regime}


def dd_bound(alpha: float) -> dict:
    """DDSketch's guarantee is the sketch parameter itself: every
    rank-q answer is within relative error α of the true value."""
    return {"bound": float(alpha)}


def entropy_bias_bound(log2_width: int, distinct: float) -> dict:
    """First-order collision-bias envelope for the hashed-histogram
    entropy sketch: d distinct keys in w = 2^log2_width buckets merge
    ~(d−1)/(2w) of the mass in expectation, biasing plug-in entropy by
    at most (d − 1)/(2·w·ln 2) bits (the Miller–Madow correction with
    the bucket count as the alphabet)."""
    w = 1 << int(log2_width)
    d = max(float(distinct), 1.0)
    return {"bound": (d - 1.0) / (2.0 * w * math.log(2.0))}


# -- deterministic shadow sample ---------------------------------------------


def shadow_priorities(keys: np.ndarray) -> np.ndarray:
    """splitmix64 of the uint32 key → uint64 priority. Fixed constants
    (same family everywhere, like ops/hashing._SEED_MULTIPLIERS) so
    samples built on different nodes/processes merge coherently; the
    priority is derivable from the key, so sealed windows never need to
    persist it."""
    z = keys.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = ((z ^ (z >> np.uint64(30)))
         * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(27)))
         * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return z ^ (z >> np.uint64(31))


class ShadowSample:
    """Fixed-capacity deterministic bottom-k sample over a uint32 key
    stream with integer weights.

    State is always canonical: keys sorted by (priority, key), weights
    aligned, length ≤ capacity. Canonical form is what makes merge
    results byte-comparable across fold orders.
    """

    __slots__ = ("capacity", "keys", "weights")

    def __init__(self, capacity: int,
                 keys: np.ndarray | None = None,
                 weights: np.ndarray | None = None):
        self.capacity = int(capacity)
        self.keys = (np.asarray(keys, np.uint32) if keys is not None
                     else np.zeros(0, np.uint32))
        self.weights = (np.asarray(weights, np.int64) if weights is not None
                        else np.zeros(0, np.int64))

    def __len__(self) -> int:
        return int(self.keys.size)

    @property
    def full(self) -> bool:
        return self.keys.size >= self.capacity

    def _canon(self, keys: np.ndarray, weights: np.ndarray) -> None:
        """Sort by (priority, key), truncate to capacity, store."""
        prios = shadow_priorities(keys)
        order = np.lexsort((keys, prios))[: self.capacity]
        self.keys = np.ascontiguousarray(keys[order])
        self.weights = np.ascontiguousarray(weights[order])

    def update(self, keys: np.ndarray,
               weights: np.ndarray | None = None) -> None:
        """Fold a host batch (pad-free: caller passes the real rows).
        Weights default to 1 per row; a pre-aggregated lane passes its
        integer weights. Zero-weight rows still register the key."""
        if self.capacity <= 0:
            return
        k = np.asarray(keys, np.uint32).ravel()
        if k.size == 0:
            return
        if weights is None:
            w = np.ones(k.size, np.int64)
        else:
            w = np.asarray(weights, np.int64).ravel()
        if self.full:
            # threshold pre-filter (the hot-path fast path): a key whose
            # priority exceeds the current kth-smallest can neither join
            # the bottom-k nor belong to a resident key (residents all
            # sit at or below the threshold), so dropping it before the
            # dedup+sort changes nothing — it would have been truncated
            # by _canon anyway, and resident weights stay exact
            tau = shadow_priorities(self.keys[-1:])[0]
            m = shadow_priorities(k) <= tau
            if not m.any():
                return
            k, w = k[m], w[m]
        # one dedup pass over residents + batch: resident keys accumulate,
        # new keys enter, and _canon truncates back to capacity
        all_k = np.concatenate([self.keys, k])
        all_w = np.concatenate([self.weights, w])
        mk, minv = np.unique(all_k, return_inverse=True)
        mw = np.zeros(mk.size, np.int64)
        np.add.at(mw, minv, all_w)
        self._canon(mk, mw)

    def merge(self, other: "ShadowSample") -> "ShadowSample":
        """Weighted subsample union: union-by-key (weights add), keep
        the capacity smallest priorities. Associative + commutative, so
        any fold order over any partition of the stream yields the
        bit-identical sample."""
        if self.capacity != other.capacity:
            raise ValueError(
                f"shadow capacity mismatch: {self.capacity} vs "
                f"{other.capacity}")
        out = ShadowSample(self.capacity)
        all_k = np.concatenate([self.keys, other.keys])
        all_w = np.concatenate([self.weights, other.weights])
        if all_k.size == 0:
            return out
        mk, minv = np.unique(all_k, return_inverse=True)
        mw = np.zeros(mk.size, np.int64)
        np.add.at(mw, minv, all_w)
        out._canon(mk, mw)
        return out

    def copy(self) -> "ShadowSample":
        return ShadowSample(self.capacity, self.keys.copy(),
                            self.weights.copy())

    def reset(self) -> None:
        self.keys = np.zeros(0, np.uint32)
        self.weights = np.zeros(0, np.int64)

    # -- estimators (ground-truth reads) ------------------------------------

    def threshold(self) -> float:
        """Largest resident priority normalized to (0, 1] — the
        inclusion probability of the bottom-k membership test. 1.0 for
        a non-full sample (everything seen is resident)."""
        if not self.full or self.keys.size == 0:
            return 1.0
        prios = shadow_priorities(self.keys)
        return float(int(prios[-1]) + 1) / float(1 << 64)

    def distinct_estimate(self) -> float:
        """Exact when not full (nothing was ever evicted); the standard
        bottom-k estimator (k − 1)/τ when full."""
        if not self.full:
            return float(self.keys.size)
        return (self.keys.size - 1) / self.threshold()

    def entropy_estimate(self, events: float) -> float:
        """Shannon entropy (bits) of the key stream via the
        inverse-probability estimator: resident weights are exact
        totals, each resident key (below the threshold-defining one)
        was included with probability τ, so Σ w·log2(w) scales by 1/τ.
        Exact when the sample never filled."""
        n = max(float(events), 1.0)
        w = self.weights.astype(np.float64)
        if self.full and w.size > 1:
            tau = self.threshold()
            w = w[:-1]  # the τ-defining key conditions the estimator
            scale = 1.0 / tau
        else:
            scale = 1.0
        w = w[w > 0]
        if w.size == 0:
            return 0.0
        s = float(np.sum(w * np.log2(w))) * scale
        return max(math.log2(n) - s / n, 0.0)

    def observed_hh_err(self, keys: np.ndarray, counts: np.ndarray,
                        events: float) -> tuple[float, int] | None:
        """Mean |estimate − truth| / N over the answer keys the sample
        holds ground truth for (resident weights are exact). Returns
        (err_rel, n_audited) or None when the audit has no overlap."""
        if self.keys.size == 0 or np.asarray(keys).size == 0:
            return None
        k = np.asarray(keys, np.uint32).ravel()
        c = np.asarray(counts, np.float64).ravel()
        order = np.argsort(self.keys, kind="stable")
        pos = np.searchsorted(self.keys[order], k)
        pos = np.clip(pos, 0, self.keys.size - 1)
        hit = self.keys[order][pos] == k
        if not hit.any():
            return None
        truth = self.weights[order][pos[hit]].astype(np.float64)
        err = float(np.mean(np.abs(c[hit] - truth))) / max(float(events), 1.0)
        return err, int(hit.sum())


# -- the accuracy block ------------------------------------------------------


def accuracy_block(*, events: float, depth: int, width: int, hll_p: int,
                   ent_log2_width: int, distinct: float | None = None,
                   entropy_bits: float | None = None,
                   hh_keys=None, hh_counts=None,
                   qt_alpha: float | None = None,
                   shadow: ShadowSample | None = None) -> dict:
    """Build the per-stat accuracy block ({bound, observed_err, audited}
    per stat + audit metadata) that rides harvest summaries, sealed
    answers and DumpState. Analytic bounds come from geometry + observed
    mass alone; observed errors appear only when a shadow sample with
    content is supplied (audited=True). JSON-able, stable keys."""
    stats: dict[str, dict] = {}
    hh = dict(cms_bound(depth, width, events))
    dist = dict(hll_bound(hll_p, distinct))
    ent = dict(entropy_bias_bound(ent_log2_width,
                                  distinct if distinct is not None else 1.0))
    for row in (hh, dist, ent):
        row["observed_err"] = None
        row["audited"] = False
    sample_size = len(shadow) if shadow is not None else 0
    if shadow is not None and sample_size > 0:
        if hh_keys is not None and hh_counts is not None:
            audit = shadow.observed_hh_err(hh_keys, hh_counts, events)
            if audit is not None:
                hh["observed_err"], hh["audited_keys"] = audit
                hh["audited"] = True
        if distinct is not None:
            truth = shadow.distinct_estimate()
            dist["observed_err"] = (abs(float(distinct) - truth)
                                    / max(truth, 1.0))
            dist["audited"] = True
        if entropy_bits is not None:
            truth = shadow.entropy_estimate(events)
            ent["observed_err"] = abs(float(entropy_bits) - truth)
            ent["audited"] = True
    stats["heavy_hitters"] = hh
    stats["distinct"] = dist
    stats["entropy"] = ent
    if qt_alpha is not None:
        # the value lane has no shadow (keys only), so quantiles stay
        # analytic-only: the α guarantee is exact by construction
        stats["quantiles"] = {"bound": float(qt_alpha),
                              "observed_err": None, "audited": False}
    block = {
        "stats": stats,
        "audited": any(s.get("audited") for s in stats.values()),
        "sample_size": sample_size,
        "sample_capacity": (shadow.capacity if shadow is not None else 0),
    }
    block["ratio"] = accuracy_ratio(block)
    return block


def accuracy_ratio(block: dict | None) -> float:
    """Worst observed_err/bound over the audited stats — the single
    scalar the accuracy_drift alert watches. 0.0 when nothing is
    audited (no observation ≠ zero error: an idle window or a plane-off
    run must read as 'no signal', which is the alert's idle immunity)."""
    if not block:
        return 0.0
    worst = 0.0
    for s in (block.get("stats") or {}).values():
        if not s.get("audited"):
            continue
        obs, bound = s.get("observed_err"), s.get("bound")
        if obs is None or not bound:
            continue
        worst = max(worst, float(obs) / float(bound))
    return worst


# -- live registry (the PipelineStats pattern) -------------------------------

_tm_observed_err = gauge(
    "ig_sketch_accuracy_observed_err",
    "Observed error of a sketch statistic vs the shadow-sample ground "
    "truth (same unit as the stat's analytic bound)",
    ("stat",))
_tm_accuracy_ratio = gauge(
    "ig_sketch_accuracy_ratio",
    "Worst observed_err / analytic bound across audited stats "
    "(0.0 = nothing audited)")
_tm_audit_samples = counter(
    "ig_sketch_audit_samples_total",
    "Events fed through the accuracy-audit shadow sample")


class AccuracyStats:
    """Per-run accuracy audit accounting, fed at harvest grain —
    registered like PipelineStats so live surfaces (DumpState, doctor,
    `ig-tpu fleet accuracy`) can find it by run."""

    def __init__(self, run_id: str, gadget: str = ""):
        self.run_id = run_id
        self.gadget = gadget
        self._mu = threading.Lock()
        self._block: dict | None = None
        self.samples_fed = 0
        self._touched: set[str] = set()

    def note_fed(self, n: int) -> None:
        """n events entered the shadow this batch (batch-grain)."""
        if n <= 0:
            return
        with self._mu:
            self.samples_fed += int(n)
        _tm_audit_samples.inc(n)

    def observe_block(self, block: dict) -> None:
        """Latest harvest's accuracy block → gauges + snapshot state."""
        with self._mu:
            self._block = block
            for stat, row in (block.get("stats") or {}).items():
                if row.get("audited") and row.get("observed_err") is not None:
                    self._touched.add(stat)
                    _tm_observed_err.labels(stat=stat).set(
                        float(row["observed_err"]))
        _tm_accuracy_ratio.set(accuracy_ratio(block))

    def snapshot(self) -> dict:
        """The `accuracy` row DumpState / doctor / fleet accuracy carry."""
        with self._mu:
            block = self._block
            return {
                "audited": bool(block and block.get("audited")),
                "sample_size": int(block.get("sample_size", 0)) if block else 0,
                "ratio": accuracy_ratio(block),
                "samples_fed": self.samples_fed,
                "stats": dict((block or {}).get("stats") or {}),
            }

    def register(self) -> None:
        with _live_mu:
            _live[self.run_id] = self

    def unregister(self) -> None:
        """Drop out of the live registry and return every gauge this
        run touched exactly to baseline."""
        with _live_mu:
            _live.pop(self.run_id, None)
        with self._mu:
            touched = list(self._touched)
        for stat in touched:
            _tm_observed_err.labels(stat=stat).set(0.0)
        _tm_accuracy_ratio.set(0.0)


_live_mu = threading.Lock()
_live: dict[str, AccuracyStats] = {}


def live_stats() -> list[AccuracyStats]:
    with _live_mu:
        return list(_live.values())
