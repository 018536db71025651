"""DDSketch-style quantile sketch (PyTorch port of
``inspektor_gadget_tpu/ops/quantiles.py``).

Values map to log-spaced buckets ``i = ceil(log_gamma(v))``. The bucket
index must equal the reference's bit for bit, or a value on a gamma**i
boundary lands one bucket off and merged state forks. The reference's
float32 ``log`` is not the C library's: XLA's CPU backend lowers it to
the Cephes polynomial (Eigen's ``plog``) and LLVM contracts its
multiply-adds into fused multiply-adds, and ``log(v) * ilg - off``
contracts into one more. `xla_logf` and `bucket_index` repeat those
operations in that order, with every fused multiply-add rounded once
(`fma_f32`), and the CUDA kernel does the same with ``__fmaf_rn`` and
``-fmad=false``. ``tests/test_torch_sketch_ops.py`` holds them to the
reference on boundary values.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .hashing import u32

# Cephes logf constants exactly as float32 (XLA's CPU lowering of log)
_LOG_MIN_NORMAL = float.fromhex("0x1p-126")
_LOG_SQRTHF = float.fromhex("0x1.6a09e6p-1")
_LOG_P = [float.fromhex(h) for h in (
    "0x1.204376p-4", "-0x1.d7a37p-4", "0x1.de4a34p-4", "-0x1.fcba9ep-4",
    "0x1.23d37ep-3", "-0x1.555cap-3", "0x1.999d58p-3", "-0x1.fffff8p-3",
    "0x1.555554p-2")]
_LOG_Q1 = float.fromhex("-0x1.bd0106p-13")
_LOG_Q2 = float.fromhex("0x1.63p-1")


@dataclass
class DDSketch:
    counts: torch.Tensor  # (n_buckets,) int32, log-gamma spaced
    zeros: torch.Tensor   # () int32, values <= 0
    total: torch.Tensor   # () int32
    alpha: float
    min_value: float

    @property
    def gamma(self) -> float:
        return (1.0 + self.alpha) / (1.0 - self.alpha)


def dd_init(alpha: float = 0.01, n_buckets: int = 2048, min_value: float = 1e-9,
            device: str | torch.device = "cuda") -> DDSketch:
    d = resolve_device(device)
    return DDSketch(counts=torch.zeros((n_buckets,), dtype=torch.int32, device=d),
                    zeros=torch.zeros((), dtype=torch.int32, device=d),
                    total=torch.zeros((), dtype=torch.int32, device=d),
                    alpha=alpha, min_value=min_value)


def bucket_constants(alpha: float, min_value: float) -> tuple[float, float]:
    """(inverse log gamma, offset) rounded to float32 as the reference
    folds them: computed in float64 on the host, then one rounding."""
    gamma = (1.0 + alpha) / (1.0 - alpha)
    ilg = 1.0 / math.log(gamma)
    off = math.log(min_value) * ilg
    return float(np.float32(ilg)), float(np.float32(off))


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a*b + c with one rounding. The float32 product is exact in
    float64; the sum is made round-to-odd there (TwoSum gives its exact
    error), so the final rounding to float32 is the correctly rounded
    fused result."""
    f64 = torch.float64
    a = a.to(f64)
    b = b.to(f64) if isinstance(b, torch.Tensor) else torch.tensor(b, dtype=f64, device=a.device)
    c = c.to(f64) if isinstance(c, torch.Tensor) else torch.tensor(c, dtype=f64, device=a.device)
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def xla_logf(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive float32 values, bit-identical to XLA's
    CPU ``log`` (see the module note). Every step is a separate float32
    operation or one `fma_f32`."""
    f32 = torch.float32
    x = torch.where(x > _LOG_MIN_NORMAL, x, torch.full_like(x, _LOG_MIN_NORMAL))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(f32) + 1.0
    m = ((bits & -0x7F800001) | 0x3F000000).view(f32)
    lt = m < _LOG_SQRTHF
    tmp = torch.where(lt, m, torch.zeros_like(m))
    e = e - lt.to(f32)
    x = (m - 1.0) + tmp
    z = x * x
    x3 = z * x
    p = _LOG_P
    y1 = fma_f32(fma_f32(x, p[0], p[1]), x, p[2])
    y2 = fma_f32(fma_f32(x, p[3], p[4]), x, p[5])
    y3 = fma_f32(fma_f32(x, p[6], p[7]), x, p[8])
    y = fma_f32(fma_f32(y1, x3, y2), x3, y3)
    t = fma_f32(y, x3, e * _LOG_Q1)
    return fma_f32(e, _LOG_Q2, fma_f32(z, -0.5, x) + t)


def value_f32(values: torch.Tensor) -> torch.Tensor:
    """The value lane as float32: float lanes as they are, integer lanes
    as uint32 (the bundle's value lane) rounded to nearest."""
    if values.is_floating_point():
        return values.to(torch.float32)
    return u32(values).to(torch.float32)


def bucket_index(values: torch.Tensor, *, alpha: float, min_value: float,
                 n_buckets: int) -> torch.Tensor:
    """int64 bucket of each value: ceil(log(max(v, min)) * ilg - off)
    clipped to [0, n_buckets), computed as the reference computes it."""
    ilg, off = bucket_constants(alpha, min_value)
    v = value_f32(values)
    v = torch.maximum(v, torch.tensor(min_value, dtype=torch.float32, device=v.device))
    idx = torch.ceil(fma_f32(xla_logf(v), ilg, -off))
    return torch.clamp(idx, 0, n_buckets - 1).to(torch.int64)


def _bucket_index(state: DDSketch, values: torch.Tensor) -> torch.Tensor:
    return bucket_index(values, alpha=state.alpha, min_value=state.min_value,
                        n_buckets=state.counts.shape[0])


def dd_update(state: DDSketch, values: torch.Tensor,
              mask: torch.Tensor | None = None) -> DDSketch:
    """Fold a batch of non-negative values; masked slots weigh 0 and
    values <= 0 land in the zero bucket. In place."""
    w = (torch.ones(values.shape, dtype=torch.int32, device=values.device)
         if mask is None else mask.to(torch.int32))
    is_zero = torch.where(value_f32(values) <= 0, w, torch.zeros_like(w))
    state.counts.index_add_(0, _bucket_index(state, values), w - is_zero)
    state.zeros.add_(is_zero.sum().to(torch.int32))
    state.total.add_(w.sum().to(torch.int32))
    return state


def dd_quantile(state: DDSketch, q) -> torch.Tensor:
    """Value at quantile(s) q: the bucket midpoint 2*gamma**i/(gamma+1);
    0 inside the zero bucket, NaN when empty. float32, like the reference."""
    f32 = torch.float32
    dev = state.counts.device
    qs = torch.atleast_1d(torch.as_tensor(q, dtype=f32, device=dev))
    total = state.total.to(f32)
    rank = qs * torch.clamp(total - 1.0, min=0.0)
    cum = state.zeros.to(f32) + torch.cumsum(state.counts.to(f32), 0)
    bucket = (cum[None, :] <= rank[:, None]).sum(dim=1)
    bucket = torch.clamp(bucket, 0, state.counts.shape[0] - 1)
    log_gamma = math.log(state.gamma)
    offset = math.log(state.min_value) / log_gamma
    mid = 2.0 * torch.exp((bucket.to(f32) + offset) * log_gamma) / (state.gamma + 1.0)
    out = torch.where(rank < state.zeros.to(f32), torch.zeros_like(mid), mid)
    out = torch.where(total > 0, out, torch.full_like(out, math.nan))
    return out[0] if np.ndim(q) == 0 else out


def dd_merge(a: DDSketch, b: DDSketch) -> DDSketch:
    return DDSketch(counts=a.counts + b.counts, zeros=a.zeros + b.zeros,
                    total=a.total + b.total, alpha=a.alpha, min_value=a.min_value)


# -- host twins (numpy, float64) --------------------------------------------
# Harvests and sealed windows read quantiles off host copies of the
# DDSketch lanes; same formulas as `dd_quantile`, in float64.

def dd_quantile_np(counts: np.ndarray, zeros: float, total: float, q,
                   *, alpha: float = 0.01,
                   min_value: float = 1e-9) -> np.ndarray:
    """Host-side quantile read over raw DDSketch lanes (e.g. a merged
    window fold). Scalar q → scalar; array q → array."""
    gamma = (1.0 + alpha) / (1.0 - alpha)
    qs = np.atleast_1d(np.asarray(q, np.float64))
    total = float(total)
    rank = qs * max(total - 1.0, 0.0)
    cum = float(zeros) + np.cumsum(np.asarray(counts, np.float64))
    bucket = (cum[None, :] <= rank[:, None]).sum(axis=1)
    bucket = np.clip(bucket, 0, len(cum) - 1)
    log_gamma = math.log(gamma)
    offset = math.log(min_value) / log_gamma
    mid = 2.0 * np.exp((bucket + offset) * log_gamma) / (gamma + 1.0)
    out = np.where(rank < float(zeros), 0.0, mid)
    out = np.where(total > 0, out, np.nan)
    return out[0] if np.ndim(q) == 0 else out


def dd_histogram_log2_np(counts: np.ndarray, *, alpha: float = 0.01,
                         min_value: float = 1e-9,
                         n_slots: int = 27,
                         unit_scale: float = 1e6) -> np.ndarray:
    """Host-side log2 re-binning (the biolatency ASCII render input).
    `unit_scale` converts bucket midpoints into the display unit before
    the log2: 1e6 for seconds→µs (the device twin's convention), 1.0 to
    bin raw integer-domain values (the bundle plane's ns lane) as-is."""
    gamma = (1.0 + alpha) / (1.0 - alpha)
    n = len(counts)
    log_gamma = math.log(gamma)
    offset = math.log(min_value) / log_gamma
    mids = np.exp((np.arange(n, dtype=np.float64) + offset)
                  * log_gamma) * unit_scale
    slot = np.clip(np.floor(np.log2(np.maximum(mids, 1.0))),
                   0, n_slots - 1).astype(np.int64)
    out = np.zeros((n_slots,), np.int64)
    np.add.at(out, slot, np.asarray(counts, np.int64))
    return out
