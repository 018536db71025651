"""SketchBundle: the per-node analytics state updated once per event
batch (PyTorch port of ``inspektor_gadget_tpu/ops/sketches.py``).

Key streams per batch (uint32 lanes, fixed length, integer weights):
  hh_keys       heavy-hitter keys (count-min, top-k, invertible)
  distinct_keys HLL distinct stream
  dist_keys     distribution stream (entropy)
  values        optional uint32 value lane (DDSketch)

`bundle_update` is the plain composition of the sketch ops;
`bundle_update_fused` takes every plane's delta from one K2 pass (the
CUDA kernel on the card, its plain version on the CPU) and is what
`bundle_ingest_step`, the staged-ingest step, runs. Both give
bit-identical state on either device, and both equal the JAX package's
within the regimes of PERF.md §1: `cms.total` wraps its int32 sum as the
reference does; `events` adds the batch's exact weight sum rounded to
float32 once, where the reference sums in float32 in XLA's order (equal
whenever a batch's weight sum is below 2**24); the entropy delta is
exact (see `entropy.py`). Updates change the bundle in place, where the
reference donates it, and return it. The sharded ingest keeps one bundle
a device lane and merges them only at harvest (below).
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .countmin import CountMin, cms_init, cms_merge, cms_update
from .entropy import EntropySketch, entropy_estimate, entropy_init, entropy_merge, entropy_update
from .hashing import MASK32, bits32, sum_wrap32, u32
from .hll import HLL, hll_estimate, hll_init, hll_merge, hll_update
from .invertible import InvSketch, inv_init, inv_merge, inv_update
from .kernels import FusedGeometry, fused_planes, split_planes
from .quantiles import DDSketch, dd_init, dd_merge, dd_update
from .topk import TopK, topk_init, topk_merge, topk_update

# The production geometry: the reference benchmark's accelerator shapes
# (bench.py:58) with the optional planes on at the tpusketch operator's
# defaults (invertible 3 x 2**12, DDSketch 2048 buckets at 1%).
PRODUCTION_BATCH = 1 << 17
PRODUCTION_GEOMETRY = dict(depth=4, log2_width=16, hll_p=14, entropy_log2_width=12, k=128,
                           inv_rows=3, inv_log2_buckets=12, quantiles=True,
                           quantile_alpha=0.01, quantile_buckets=2048,
                           quantile_min_value=1.0)


@dataclass
class SketchBundle:
    cms: CountMin
    hll: HLL
    entropy: EntropySketch
    topk: TopK
    events: torch.Tensor  # () float32, total weight absorbed
    drops: torch.Tensor   # () float32, upstream loss carried along
    inv: InvSketch | None = None
    quantiles: DDSketch | None = None

    @property
    def device(self) -> torch.device:
        return self.events.device

    def geometry(self) -> FusedGeometry:
        inv, qt = self.inv, self.quantiles
        return FusedGeometry(
            depth=self.cms.depth, log2_width=self.cms.log2_width,
            ent_log2_width=self.entropy.log2_width, hll_p=self.hll.p,
            inv_rows=inv.rows if inv is not None else 0,
            inv_log2_buckets=inv.log2_buckets if inv is not None else 0,
            qt_buckets=qt.counts.shape[0] if qt is not None else 0,
            qt_alpha=qt.alpha if qt is not None else 0.01,
            qt_min_value=qt.min_value if qt is not None else 1.0)


def bundle_init(*, depth: int = 4, log2_width: int = 16, hll_p: int = 14,
                entropy_log2_width: int = 12, k: int = 128, inv_rows: int = 0,
                inv_log2_buckets: int = 12, quantiles: bool = False,
                quantile_alpha: float = 0.01, quantile_buckets: int = 2048,
                quantile_min_value: float = 1.0,
                device: str | torch.device = "cuda") -> SketchBundle:
    d = resolve_device(device)
    return SketchBundle(
        cms=cms_init(depth, log2_width, device=d),
        hll=hll_init(hll_p, device=d),
        entropy=entropy_init(entropy_log2_width, device=d),
        topk=topk_init(k, device=d),
        events=torch.zeros((), dtype=torch.float32, device=d),
        drops=torch.zeros((), dtype=torch.float32, device=d),
        inv=inv_init(inv_rows, inv_log2_buckets, device=d) if inv_rows else None,
        quantiles=(dd_init(alpha=quantile_alpha, n_buckets=quantile_buckets,
                           min_value=quantile_min_value, device=d)
                   if quantiles else None))


def _values_or_zero(values, like: torch.Tensor) -> torch.Tensor:
    """Sources without a value lane feed zeros: every event lands in the
    DDSketch zero bucket, keeping totals honest."""
    return values if values is not None else torch.zeros_like(like, dtype=torch.int32)


def _add_drops(bundle: SketchBundle, drops) -> None:
    if drops is not None:
        bundle.drops.add_(torch.as_tensor(drops, dtype=torch.float32, device=bundle.device))


def bundle_update(bundle: SketchBundle, hh_keys: torch.Tensor, distinct_keys: torch.Tensor,
                  dist_keys: torch.Tensor, mask: torch.Tensor, drops=None,
                  values: torch.Tensor | None = None) -> SketchBundle:
    """The plain composition: each sketch op in turn. In place."""
    w = mask.to(torch.int32)
    cms_update(bundle.cms, hh_keys, w)
    hll_update(bundle.hll, distinct_keys, w)
    entropy_update(bundle.entropy, dist_keys, w)
    bundle.topk = topk_update(bundle.topk, bundle.cms, hh_keys, w)
    bundle.events.add_(w.sum(dtype=torch.int64).to(torch.float32))
    _add_drops(bundle, drops)
    if bundle.inv is not None:
        inv_update(bundle.inv, hh_keys, w)
    if bundle.quantiles is not None:
        dd_update(bundle.quantiles, _values_or_zero(values, w), w)
    return bundle


def bundle_update_fused(bundle: SketchBundle, hh_keys: torch.Tensor,
                        distinct_keys: torch.Tensor, dist_keys: torch.Tensor,
                        mask: torch.Tensor, drops=None,
                        values: torch.Tensor | None = None) -> SketchBundle:
    """Every plane's delta from one K2 pass (counterpart of the
    reference's ``_bundle_update_pallas``), then the same top-k refresh
    against the updated CMS. Takes every shape. In place."""
    w = mask.to(torch.int32)
    geom = bundle.geometry()
    vals = _values_or_zero(values, w) if geom.qt_buckets else None
    cms_d, ent_d, ranks, inv_d, qt_d = split_planes(
        fused_planes(hh_keys, distinct_keys, dist_keys, w, vals, geom), geom)
    wsum = w.sum(dtype=torch.int64)  # exact
    wrapped = sum_wrap32(w)          # the reference's int32 sum
    bundle.cms.table.add_(cms_d)
    bundle.cms.total.add_(wrapped.to(torch.float32))
    torch.maximum(bundle.hll.registers, ranks, out=bundle.hll.registers)
    bundle.entropy.counts.add_(ent_d)
    bundle.topk = topk_update(bundle.topk, bundle.cms, hh_keys, w)
    bundle.events.add_(wsum.to(torch.float32))
    _add_drops(bundle, drops)
    if bundle.inv is not None:
        inv = bundle.inv
        inv.count.add_(bits32(inv_d[:, 0]))
        inv.keysum.add_(inv_d[:, 1]).bitwise_and_(MASK32)
        inv.fpsum.add_(inv_d[:, 2]).bitwise_and_(MASK32)
    if bundle.quantiles is not None:
        qt = bundle.quantiles
        qt.counts.add_(qt_d)
        qt.zeros.add_(torch.where(u32(vals) == 0, w, torch.zeros_like(w)).sum().to(torch.int32))
        qt.total.add_(wrapped.to(torch.int32))
    return bundle


def bundle_ingest_step(bundle: SketchBundle, hh_keys: torch.Tensor,
                       distinct_keys: torch.Tensor, dist_keys: torch.Tensor,
                       weights: torch.Tensor, drops=None,
                       values: torch.Tensor | None = None):
    """THE staged-ingest step. `weights` is the weights lane as integer
    per-event weights: pad slots weigh 0, pre-aggregated slots may weigh
    more than 1 (count-min, entropy, invertible, DDSketch and events take
    the magnitude; HLL and top-k look only at nonzero).

    Returns (bundle, fence). On the card the fence is a CUDA event
    recorded on the current stream after the step: the stager waits on
    it before a staged host block goes back to the pool. On the CPU the
    step has finished when it returns and the fence is a fresh copy of
    the events counter, as in the reference."""
    out = bundle_update_fused(bundle, hh_keys, distinct_keys, dist_keys,
                              weights.to(torch.int32), drops, values)
    if out.device.type == "cuda":
        fence = torch.cuda.Event()
        fence.record(torch.cuda.current_stream(out.device))
        return out, fence
    return out, out.events.clone()


def _merge_optional(x, y, merge):
    return merge(x, y) if x is not None and y is not None else None


def bundle_merge(a: SketchBundle, b: SketchBundle) -> SketchBundle:
    cms = cms_merge(a.cms, b.cms)
    return SketchBundle(
        cms=cms, hll=hll_merge(a.hll, b.hll),
        entropy=entropy_merge(a.entropy, b.entropy),
        topk=topk_merge(a.topk, b.topk, cms),
        events=a.events + b.events, drops=a.drops + b.drops,
        inv=_merge_optional(a.inv, b.inv, inv_merge),
        quantiles=_merge_optional(a.quantiles, b.quantiles, dd_merge))


def bundle_map(fn, b: SketchBundle) -> SketchBundle:
    """A new bundle of `fn(t)` for every tensor leaf of `b`, its geometry
    kept (a copy, a move to another device, zeros like it)."""
    rep = dataclasses.replace
    return SketchBundle(
        cms=rep(b.cms, table=fn(b.cms.table), total=fn(b.cms.total)),
        hll=rep(b.hll, registers=fn(b.hll.registers)),
        entropy=rep(b.entropy, counts=fn(b.entropy.counts)),
        topk=rep(b.topk, keys=fn(b.topk.keys), counts=fn(b.topk.counts),
                 overflow=fn(b.topk.overflow)),
        events=fn(b.events), drops=fn(b.drops),
        inv=(rep(b.inv, count=fn(b.inv.count), keysum=fn(b.inv.keysum), fpsum=fn(b.inv.fpsum))
             if b.inv is not None else None),
        quantiles=(rep(b.quantiles, counts=fn(b.quantiles.counts), zeros=fn(b.quantiles.zeros),
                       total=fn(b.quantiles.total))
                   if b.quantiles is not None else None))


# -- sharded ingest: one bundle a lane, merged only at harvest -----------------
# A "mesh" is an ordered list of lane devices (parallel/mesh.py); lanes may
# share a device when the caller lists one twice. Each lane holds its own
# bundle on its own device and absorbs its own staged batch with the same
# bundle_update_fused step the single-device path runs (one K2 a lane and
# round, launched on the lane's device and its current stream). The
# harvest is the only cross-lane work: parallel.cluster's cluster_merge
# (sum the additive planes, max the HLL registers, gather every lane's
# top-k candidates and re-rank them against the merged count-min), so the
# harvested bundle is bit-identical to the single-lane fold of the same
# stream (tests/test_torch_sharded_ingest.py). parallel.cluster imports
# this module, so the makers import it when called.

def bundle_stack_sharded(bundle: SketchBundle, mesh) -> list[SketchBundle]:
    """One bundle a lane of `mesh`: lane 0 a copy of `bundle` (so a
    resumed checkpoint's counts enter the harvest exactly once), the other
    lanes empty, each on its lane's device (reference ``:304``)."""
    return [bundle_map(lambda t, d=d, k=k: (t.to(d, copy=True) if k == 0
                                            else torch.zeros_like(t, device=d)), bundle)
            for k, d in enumerate(mesh)]


def _lane_device(d: torch.device):
    return torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()


def make_bundle_ingest_sharded(mesh, like: SketchBundle):
    """The sharded ingest step (reference ``:325``): ``step(lanes, hh,
    distinct, dist, weights, drops, values=None) -> (lanes, token)``.

    Each batch argument holds one entry a lane (a list of tensors, or a
    (chips, batch) tensor on one device), lane k's on lane k's device;
    `drops` one float or 0-d tensor a lane; `values` the DDSketch value
    lanes, when `like` has the plane (absent: zeros, every event in the
    zero bucket). Lane k's bundle absorbs lane k's batch through
    `bundle_ingest_step` under its own device, so K2 launches once a lane
    on the lane's device and current stream. The lanes update in place.
    The token holds each lane's fence, as `bundle_ingest_step` gives it
    (a CUDA event on the card, a copy of the lane's events on the CPU),
    for that lane's stager."""
    from ..parallel.mesh import lane_device
    mesh = [lane_device(d) for d in mesh]
    qt = like.quantiles is not None

    def step(lanes, hh, distinct, dist, weights, drops, values=None):
        if len(lanes) != len(mesh):
            raise ValueError(f"{len(lanes)} lane bundles for a mesh of {len(mesh)}")
        tokens = []
        for k, (b, d) in enumerate(zip(lanes, mesh)):
            for name, arr in (("hh", hh), ("distinct", distinct), ("dist", dist),
                              ("weights", weights)):
                if arr[k].device != d:
                    raise ValueError(f"lane {k}: {name} lies on {arr[k].device}, "
                                     f"not on the lane's device {d}")
            with _lane_device(d):
                _, tok = bundle_ingest_step(b, hh[k], distinct[k], dist[k], weights[k], drops[k],
                                            values[k] if qt and values is not None else None)
            tokens.append(tok)
        return lanes, tokens

    return step


def make_bundle_harvest_sharded(mesh, like: SketchBundle):
    """The collective harvest (reference ``:374``): ``harvest(lanes) ->``
    ONE merged bundle on lane 0's device, `cluster_merge` itself, so lane
    counts cannot fork the merge algebra. It reads the lanes and changes
    none of them: ingest goes on updating them after a harvest."""
    from ..parallel.cluster import cluster_merge
    n = len(mesh)

    def harvest(lanes: list[SketchBundle]) -> SketchBundle:
        if len(lanes) != n:
            raise ValueError(f"{len(lanes)} lane bundles for a mesh of {n}")
        return cluster_merge(lanes)

    return harvest


def bundle_digest(b: SketchBundle) -> torch.Tensor:
    """Harvest digest as ONE int32 tensor of uint32 words, so a harvest
    costs one device-to-host copy: [f32 bits of (events, drops, distinct,
    entropy_bits, candidate_overflow), top-k keys..k, top-k counts..k].
    Decode with `decode_digest`."""
    meta = torch.stack([b.events, b.drops, hll_estimate(b.hll).to(torch.float32),
                        entropy_estimate(b.entropy).to(torch.float32),
                        b.topk.overflow.to(torch.float32)])
    return torch.cat([meta.view(torch.int32), bits32(b.topk.keys), b.topk.counts])


def decode_digest(digest) -> tuple[float, float, float, float, bool, np.ndarray, np.ndarray]:
    """Host-side decode of `bundle_digest` (or the reference's digest) ->
    (events, drops, distinct, entropy_bits, candidate_overflow,
    topk_keys_u32, topk_counts)."""
    if isinstance(digest, torch.Tensor):
        digest = digest.cpu().numpy()
    d = np.asarray(digest).view(np.uint32)
    meta = d[:5].view(np.float32)
    k = (d.size - 5) // 2
    return (float(meta[0]), float(meta[1]), float(meta[2]), float(meta[3]),
            bool(meta[4] > 0), d[5:5 + k], d[5 + k:].astype(np.int64))


# -- state carried across packages ------------------------------------------
# The leaves of the reference's SketchBundle, as numpy arrays in its field
# order (sketches.py:35-52): cms.table, cms.total, hll.registers,
# entropy.counts, topk.keys, topk.counts, topk.overflow, events, drops,
# then inv.count, inv.keysum, inv.fpsum and quantiles.counts,
# quantiles.zeros, quantiles.total when those planes are on.

def bundle_to_numpy(bundle: SketchBundle) -> list[np.ndarray]:
    """The bundle's leaves in the reference's order and dtypes."""
    def arr(t, dtype):
        return t.detach().cpu().numpy().astype(dtype)

    def lane(t):
        return bits32(t).cpu().numpy().view(np.uint32)

    out = [arr(bundle.cms.table, np.int32), arr(bundle.cms.total, np.float32),
           arr(bundle.hll.registers, np.int32), arr(bundle.entropy.counts, np.float32),
           lane(bundle.topk.keys), arr(bundle.topk.counts, np.int32),
           arr(bundle.topk.overflow, np.int32), arr(bundle.events, np.float32),
           arr(bundle.drops, np.float32)]
    if bundle.inv is not None:
        out += [arr(bundle.inv.count, np.int32), lane(bundle.inv.keysum),
                lane(bundle.inv.fpsum)]
    if bundle.quantiles is not None:
        q = bundle.quantiles
        out += [arr(q.counts, np.int32), arr(q.zeros, np.int32), arr(q.total, np.int32)]
    return out


def bundle_from_numpy(leaves, *, quantile_alpha: float = 0.01,
                      quantile_min_value: float = 1.0,
                      device: str | torch.device = "cuda") -> SketchBundle:
    """Rebuild a bundle from the reference's leaves (see above). The
    DDSketch's alpha and min_value are not leaves and are passed here."""
    d = resolve_device(device)
    leaves = [np.asarray(x) for x in leaves]
    if len(leaves) not in (9, 12, 15):
        raise ValueError(f"expected 9, 12 or 15 leaves, got {len(leaves)}")

    def t(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(d)

    def lane(x):
        return u32(torch.from_numpy(np.array(x, dtype=np.uint32).view(np.int32))).to(d)

    table, total, regs, ent, tk, tc, tov, events, drops = leaves[:9]
    rest = leaves[9:]
    inv = qt = None
    if rest and rest[0].ndim == 2:
        inv = InvSketch(count=t(rest[0], np.int32), keysum=lane(rest[1]), fpsum=lane(rest[2]),
                        log2_buckets=int(rest[0].shape[1]).bit_length() - 1)
        rest = rest[3:]
    if rest:
        qt = DDSketch(counts=t(rest[0], np.int32), zeros=t(rest[1], np.int32),
                      total=t(rest[2], np.int32), alpha=quantile_alpha,
                      min_value=quantile_min_value)
    return SketchBundle(
        cms=CountMin(table=t(table, np.int32), total=t(total, np.float32),
                     log2_width=int(table.shape[1]).bit_length() - 1),
        hll=HLL(registers=t(regs, np.int32), p=int(regs.shape[0]).bit_length() - 1),
        entropy=EntropySketch(counts=t(ent, np.float32),
                              log2_width=int(ent.shape[0]).bit_length() - 1),
        topk=TopK(keys=lane(tk), counts=t(tc, np.int32), overflow=t(tov, np.int32)),
        events=t(events, np.float32), drops=t(drops, np.float32), inv=inv, quantiles=qt)
