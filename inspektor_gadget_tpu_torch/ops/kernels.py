"""The sketch path's two kernels, their plain PyTorch versions, and the
loader that builds and binds the CUDA library.

K1 `histogram` replaces ``inspektor_gadget_tpu/ops/pallas_kernels.py:61``
(``pallas_histogram``); K2 `fused_planes` (and `fused_sketch_planes`,
the reference's signature around it) replaces
``inspektor_gadget_tpu/ops/pallas_kernels.py:296``
(``fused_sketch_planes``). The kernels themselves, and the note on what
bounds them and how they are built, are in ``csrc/sketch_kernels.cu``.
Both launch its one entry, ``ig_fused_planes``, with a `LaunchPlan`
built here: K1 with its one histogram plane, K2 with every plane. The
plan cuts each plane into jobs of one shared-memory tile and each job's
rows into slices by its work, one thread block a (job, slice);
tests/test_torch_sketch_layout.py pins it and emulates the kernel's
partition.

The entropy plane, K1's one plane and K2's entropy row, is a HIST64
plane: its counts are exact int64 (a (low, high) word pair a bucket),
never wrapping; every other histogram plane wraps as the reference's
int32 tables do.

For a CUDA tensor a wrapper launches its kernel or raises; for a CPU
tensor it computes the plain version, which the tests hold against the
JAX package and ``chip_smoke.py`` holds the kernel against on the card.
Each wrapper counts its launches in a plain integer attribute,
``histogram.launches`` and ``fused_planes.launches``.

The library is built at first use by ``native.CudaLibrary`` and loaded
with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..native import CudaLibrary, check, on_cpu, stream
from .hashing import MASK32, _row_multiplier, bits32, hashed_bucket, row_salt, u32
from .hll import hll_index_rank
from .invertible import inv_lane_values, inv_row_hash
from .quantiles import bucket_constants, bucket_index

# plane kinds and key lanes, as csrc/sketch_kernels.cu numbers them; a
# HIST64 plane is a HIST plane whose signed counts do not wrap: each
# bucket takes two words, low then high, an int64 in the flat buffer
HIST, HLL, INV_COUNT, INV_KEYSUM, INV_FPSUM, QUANT, HIST64 = range(7)
LANE_HH, LANE_DISTINCT, LANE_DIST, LANE_VALUES = range(4)

# The launch plan's limits (csrc/sketch_kernels.cu: kThreads, kMinBlocks,
# kMaxSmem, kBlockFields) and its layout, the fastest measured on the H100
# (PERF.md).
THREADS = 512
TILE_LOG2 = 14            # buckets a block holds: 16384 (64 KB)
BLOCKS_PER_SM = 3         # 64 KB tiles, registers capped to fit: one wave of blocks
SMEM_LIMIT = 232_448      # shared memory a block may use on sm_90
BLOCK_FIELDS = 10         # a block's row of the plan's table
# the work of a job's row by its plane's kind: a key read, a weight read
# and a hash, where a DDSketch bucket costs about three hashes
ROW_COST = {HIST: 3, HLL: 3, INV_COUNT: 3, INV_KEYSUM: 3, INV_FPSUM: 3, QUANT: 5, HIST64: 3}


# -- bind ----------------------------------------------------------------------

def _bind(lib) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ig_fused_planes.argtypes = [vp, vp, vp, vp, vp, vp, i, i, f, f, f, i, vp, i, vp]
    lib.ig_fused_planes.restype = i
    lib.ig_fused_planes_occupancy.argtypes = [i, ctypes.POINTER(i)]
    lib.ig_fused_planes_occupancy.restype = i


# -fmad=false: the DDSketch bucket must not be contracted (see the source)
LIBRARY = CudaLibrary("sketch_kernels.cu", _bind, ("-fmad=false",))


def _kernel_lane(x: torch.Tensor, n: int, dev: torch.device, name: str) -> torch.Tensor:
    """A 32-bit contiguous lane of length n on `dev`, or a raised error."""
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.shape != (n,):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected ({n},)")
    return bits32(x).contiguous()


# -- the one kernel entry and its launch plan ---------------------------------

@dataclass(frozen=True)
class Plane:
    kind: int
    lane: int
    mult: int
    salt: int
    log2_width: int  # hashed planes: bucket bits; 0 for the quantile row
    width: int
    offset: int      # first bucket of the plane in the flat delta buffer

    @property
    def span(self) -> int:
        """Words of the flat buffer the plane takes: one a bucket, two
        (an int64) for HIST64."""
        return 2 * self.width if self.kind == HIST64 else self.width

    def word(self, bucket: int) -> int:
        """The flat buffer's word of `bucket` (its low word for HIST64)."""
        return self.offset + (2 * bucket if self.kind == HIST64 else bucket)

    def counts64(self, buf: torch.Tensor) -> torch.Tensor:
        """A HIST64 plane's exact counts: a view of its words as int64
        (the offset is even, so the view stays on 8 bytes)."""
        return buf[self.offset:self.offset + self.span].view(torch.int64)


def _flat_size(planes: tuple[Plane, ...]) -> int:
    return planes[-1].offset + planes[-1].span


@dataclass(frozen=True)
class Job:
    """Buckets [lo, lo + width) of planes[plane]: the tile a block holds
    in its shared memory."""
    plane: int
    lo: int
    width: int


def _round4(x: int) -> int:
    return (x + 3) & ~3


def _row_slices(n: int, parts: int) -> list[tuple[int, int]]:
    """[0, n) cut into at most `parts` ranges that start on multiples of 4."""
    step = _round4(-(-n // parts))
    return [(r, min(n, r + step)) for r in range(0, n, step)]


@dataclass(frozen=True, eq=False)  # hashed by identity: launch_plan hands out one per key
class LaunchPlan:
    """How ig_fused_planes lays a batch of n rows and a set of planes on
    the card: each plane cut into jobs of at most 2**TILE_LOG2 buckets,
    each job's rows cut into slices, one block a (job, slice). A block
    zeroes its job's tile, tallies its slice into it and flushes it."""
    planes: tuple[Plane, ...]
    n: int
    jobs: tuple[Job, ...]
    slices: tuple[tuple[int, int, int], ...]  # (job, first row, end row) per block

    @property
    def blocks(self) -> int:
        return len(self.slices)

    @property
    def tile_words(self) -> int:
        return _round4(max(j.width for j in self.jobs))

    @property
    def smem_bytes(self) -> int:
        """Shared memory a block: the widest job's tile (csrc)."""
        return 4 * self.tile_words

    def table(self) -> np.ndarray:
        """The kernel's (blocks, BLOCK_FIELDS) int32 rows, uint32 fields as
        their bit patterns: kind, lane, mult, salt, shift, lo, width, the
        tile's first bucket in the flat buffer, first row, end row."""
        rows = []
        for ji, r0, r1 in self.slices:
            j = self.jobs[ji]
            pl = self.planes[j.plane]
            rows.append((pl.kind, pl.lane, pl.mult, pl.salt, 32 - pl.log2_width, j.lo,
                         j.width, pl.word(j.lo), r0, r1))
        t = np.array(rows, dtype=np.int64).reshape(-1, BLOCK_FIELDS)
        return np.where(t >= 1 << 31, t - (1 << 32), t).astype(np.int32)

    def summary(self) -> dict:
        return {"blocks": self.blocks, "jobs": len(self.jobs), "cluster": 1,
                "tile_buckets": max(j.width for j in self.jobs),
                "smem_bytes": self.smem_bytes, "threads": THREADS}


@functools.lru_cache(maxsize=256)
def launch_plan(planes: tuple[Plane, ...], n: int, sms: int) -> LaunchPlan:
    """The launch plan of `planes` over a batch of n > 0 rows on a card
    of `sms` streaming multiprocessors.

    - Jobs: each plane's buckets cut into tiles of 2**TILE_LOG2.
    - Slices: each job's rows are cut into slices, at most BLOCKS_PER_SM
      blocks an SM in all and at least THREADS rows a block, each next
      slice going to the job whose slices carry the most work (ROW_COST
      a row).
    """
    tile = 1 << TILE_LOG2
    jobs = [Job(i, lo, min(tile, pl.width - lo))
            for i, pl in enumerate(planes) for lo in range(0, pl.width, tile)]
    cost = [ROW_COST[planes[j.plane].kind] for j in jobs]
    most = max(1, n // THREADS)
    parts = [1] * len(jobs)
    for _ in range(max(0, BLOCKS_PER_SM * sms - len(jobs))):
        # one more slice to the job whose slices carry the most work
        ji = max((j for j in range(len(jobs)) if parts[j] < most),
                 key=lambda j: cost[j] / parts[j], default=None)
        if ji is None:
            break
        parts[ji] += 1
    slices = [(ji, r0, r1) for ji in range(len(jobs)) for r0, r1 in _row_slices(n, parts[ji])]
    return LaunchPlan(planes, n, tuple(jobs), tuple(slices))


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of CUDA device `dev`."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=256)
def _device_table(plan: LaunchPlan, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(plan.table()).to(dev)


def plan_occupancy(plan: LaunchPlan) -> int:
    """cudaOccupancyMaxActiveBlocksPerMultiprocessor at the plan's shared
    memory: how many of its blocks an SM of the current device runs at
    once."""
    lib = LIBRARY.get()
    out = ctypes.c_int(0)
    check(lib.ig_fused_planes_occupancy(plan.tile_words, ctypes.byref(out)),
          "ig_fused_planes_occupancy")
    return out.value


def launch_planes(planes: tuple[Plane, ...], lanes, w: torch.Tensor,
                  vals: torch.Tensor | None, n: int, dev: torch.device, ilg: float = 0.0,
                  neg_off: float = 0.0, min_value: float = 0.0,
                  qt_buckets: int = 0) -> torch.Tensor:
    """Zero the flat int32 delta buffer of `planes` and launch
    ig_fused_planes on it under the card's `launch_plan`. No launch for
    an empty batch."""
    out = torch.zeros(_flat_size(planes), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    plan = launch_plan(planes, n, sm_count(dev))
    table = _device_table(plan, dev)
    lib = LIBRARY.get()
    with torch.cuda.device(dev):
        check(lib.ig_fused_planes(
            *(x.data_ptr() for x in lanes), vals.data_ptr() if vals is not None else None,
            w.data_ptr(), table.data_ptr(), plan.blocks, plan.tile_words, ilg, neg_off,
            min_value, qt_buckets, out.data_ptr(), n, stream(dev)), "ig_fused_planes")
    return out


# -- K1: hashed weighted histogram --------------------------------------------

def histogram_plain(keys: torch.Tensor, weights: torch.Tensor, *, log2_width: int,
                    mult: int = 0x9E3779B1, salt: int = 0) -> torch.Tensor:
    """hist[b] = sum of the signed int32 weights[n] with
    fmix32(keys[n]*mult+salt) >> (32-log2_width) == b, exact, as int64."""
    idx = hashed_bucket(keys, mult, salt, log2_width)
    out = torch.zeros(1 << log2_width, dtype=torch.int64, device=keys.device)
    return out.index_add_(0, idx, bits32(weights).to(torch.int64))


def histogram(keys: torch.Tensor, weights: torch.Tensor, *, log2_width: int,
              mult: int = 0x9E3779B1, salt: int = 0) -> torch.Tensor:
    """K1: (n,) uint32 keys + (n,) int32 weights -> (2**log2_width,) int64
    histogram, exact (a HIST64 plane: no count wraps). CUDA tensors
    launch the kernel, CPU tensors take `histogram_plain`."""
    if on_cpu(keys, weights):
        return histogram_plain(keys, weights, log2_width=log2_width, mult=mult, salt=salt)
    dev = keys.device
    n = keys.shape[0]
    k = _kernel_lane(keys, n, dev, "keys")
    w = _kernel_lane(weights.to(torch.int32), n, dev, "weights")
    width = 1 << log2_width
    plane = Plane(HIST64, LANE_HH, mult & MASK32, salt & MASK32, log2_width, width, 0)
    out = launch_planes((plane,), (k, k, k), w, None, n, dev)
    if n:
        histogram.launches += 1
    return plane.counts64(out)


histogram.launches = 0


# -- K2: every sketch plane in one pass ---------------------------------------

@dataclass(frozen=True)
class FusedGeometry:
    depth: int
    log2_width: int
    ent_log2_width: int
    hll_p: int
    inv_rows: int = 0
    inv_log2_buckets: int = 0
    qt_buckets: int = 0
    qt_alpha: float = 0.01
    qt_min_value: float = 1.0

    @functools.cached_property
    def planes(self) -> tuple[Plane, ...]:
        """The planes in the reference's order: depth count-min rows
        (wrapping int32, as the reference's table does), the entropy row
        (HIST64: exact, its high words after it), the HLL row, 3 lanes per
        invertible row (count, keysum, fpsum), the DDSketch row."""
        spec = [(HIST, LANE_HH, int(_row_multiplier(d)), row_salt(d), self.log2_width)
                for d in range(self.depth)]
        spec.append((HIST64, LANE_DIST, int(_row_multiplier(0)), 0, self.ent_log2_width))
        spec.append((HLL, LANE_DISTINCT, 0, 0, self.hll_p))
        for r in range(self.inv_rows):
            mult, salt = inv_row_hash(r)
            spec += [(kind, LANE_HH, mult, salt, self.inv_log2_buckets)
                     for kind in (INV_COUNT, INV_KEYSUM, INV_FPSUM)]
        out, offset = [], 0
        for kind, lane, mult, salt, lw in spec:
            out.append(Plane(kind, lane, mult, salt, lw, 1 << lw, offset))
            assert kind != HIST64 or offset % 2 == 0  # its int64s lie on 8 bytes
            offset += out[-1].span
        if self.qt_buckets:
            out.append(Plane(QUANT, LANE_VALUES, 0, 0, 0, self.qt_buckets, offset))
        return tuple(out)

    @property
    def total(self) -> int:
        """Words of the flat delta buffer."""
        return _flat_size(self.planes)


def fused_planes_plain(hh: torch.Tensor, distinct: torch.Tensor, dist: torch.Tensor,
                       weights: torch.Tensor, values: torch.Tensor | None,
                       geom: FusedGeometry) -> torch.Tensor:
    """Plain version of K2: the flat (geom.total,) int32 delta buffer,
    plane after plane (see `FusedGeometry.planes`)."""
    lanes = (hh, distinct, dist, values)
    w = bits32(weights).to(torch.int64)
    out = torch.zeros(geom.total, dtype=torch.int64, device=hh.device)
    inv = inv_lane_values(hh, weights) if geom.inv_rows else None
    for pl in geom.planes:
        seg = out[pl.offset:pl.offset + pl.width]
        keys = lanes[pl.lane]
        if pl.kind == HIST64:  # exact sums as (low, high) word pairs
            s = torch.zeros(pl.width, dtype=torch.int64, device=hh.device)
            s.index_add_(0, hashed_bucket(keys, pl.mult, pl.salt, pl.log2_width), w)
            out[pl.offset:pl.offset + pl.span] = torch.stack([s, s >> 32], 1).view(-1)
        elif pl.kind == HIST:
            seg.index_add_(0, hashed_bucket(keys, pl.mult, pl.salt, pl.log2_width), w)
        elif pl.kind == HLL:
            idx, rank = hll_index_rank(keys, pl.log2_width)
            rank = torch.where(w != 0, rank.to(torch.int64), torch.zeros_like(w))
            seg.scatter_reduce_(0, idx, rank, reduce="amax")
        elif pl.kind == QUANT:
            idx = bucket_index(keys, alpha=geom.qt_alpha, min_value=geom.qt_min_value,
                               n_buckets=geom.qt_buckets)
            seg.index_add_(0, idx, torch.where(u32(keys) != 0, w, torch.zeros_like(w)))
        else:
            idx = hashed_bucket(keys, pl.mult, pl.salt, pl.log2_width)
            seg.index_add_(0, idx, inv[pl.kind - INV_COUNT])
    return bits32(out & MASK32)


def fused_planes(hh: torch.Tensor, distinct: torch.Tensor, dist: torch.Tensor,
                 weights: torch.Tensor, values: torch.Tensor | None,
                 geom: FusedGeometry) -> torch.Tensor:
    """K2: one pass over the batch -> the flat (geom.total,) int32 delta
    buffer. CUDA tensors launch the kernel, CPU tensors take
    `fused_planes_plain`."""
    if geom.qt_buckets and (values is None or values.is_floating_point()):
        raise ValueError("the quantile plane needs the uint32 value lane")
    if on_cpu(hh, distinct, dist, weights, values if geom.qt_buckets else None):
        return fused_planes_plain(hh, distinct, dist, weights, values, geom)
    dev = hh.device
    n = hh.shape[0]
    lanes = [_kernel_lane(x, n, dev, name) for x, name in
             ((hh, "hh"), (distinct, "distinct"), (dist, "dist"))]
    w = _kernel_lane(weights.to(torch.int32), n, dev, "weights")
    vals = _kernel_lane(values, n, dev, "values") if geom.qt_buckets else None
    ilg, off = bucket_constants(geom.qt_alpha, geom.qt_min_value)
    out = launch_planes(geom.planes, lanes, w, vals, n, dev, ilg, -off,
                        float(np.float32(geom.qt_min_value)), geom.qt_buckets)
    if n:
        fused_planes.launches += 1
    return out


fused_planes.launches = 0


def split_planes(buf: torch.Tensor, geom: FusedGeometry):
    """Flat delta buffer -> (cms (depth, W) int32, entropy (We,) float32
    (the exact count, rounded once), HLL ranks (2**p,) int32, invertible
    (rows, 3, Wi) int64 lanes or None, quantile (buckets,) int32 or None)."""
    d, w = geom.depth, 1 << geom.log2_width
    pl = geom.planes
    ent, hll = pl[d], pl[d + 1]
    inv = None
    if geom.inv_rows:
        lo = pl[d + 2].offset
        wi = 1 << geom.inv_log2_buckets
        inv = u32(buf[lo:lo + 3 * geom.inv_rows * wi]).view(geom.inv_rows, 3, wi)
    qt = buf[pl[-1].offset:] if geom.qt_buckets else None
    return (buf[:d * w].view(d, w),
            ent.counts64(buf).to(torch.float32),
            buf[hll.offset:hll.offset + hll.width],
            inv, qt)


def fused_sketch_planes(hh_keys: torch.Tensor, distinct_keys: torch.Tensor,
                        dist_keys: torch.Tensor, weights: torch.Tensor,
                        values: torch.Tensor | None = None, *, depth: int,
                        log2_width: int, ent_log2_width: int, hll_p: int,
                        inv_rows: int = 0, inv_log2_buckets: int = 0,
                        qt_buckets: int = 0, qt_alpha: float = 0.01,
                        qt_min_value: float = 1.0):
    """The reference's signature: one fused pass -> per-plane deltas (see
    `split_planes`). Every shape is taken; nothing is padded."""
    geom = FusedGeometry(depth, log2_width, ent_log2_width, hll_p, inv_rows,
                         inv_log2_buckets if inv_rows else 0, qt_buckets,
                         qt_alpha, qt_min_value)
    return split_planes(fused_planes(hh_keys, distinct_keys, dist_keys, weights,
                                     values, geom), geom)
