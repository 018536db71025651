"""The sketch path's two kernels, their plain PyTorch versions, and the
loader that builds and binds the CUDA library.

K1 `histogram` replaces ``inspektor_gadget_tpu/ops/pallas_kernels.py:61``
(``pallas_histogram``); K2 `fused_planes` (and `fused_sketch_planes`,
the reference's signature around it) replaces
``inspektor_gadget_tpu/ops/pallas_kernels.py:296``
(``fused_sketch_planes``). The kernels themselves, and the note on what
bounds them and how they are built, are in ``csrc/sketch_kernels.cu``.
Both launch its one entry, ``ig_fused_planes``, with a table of (plane,
bucket tile) jobs: K1 with its one histogram plane, K2 with every plane.

For a CUDA tensor a wrapper launches its kernel or raises; for a CPU
tensor it computes the plain version, which the tests hold against the
JAX package and ``chip_smoke.py`` holds the kernel against on the card.
Each wrapper counts its launches in a plain integer attribute,
``histogram.launches`` and ``fused_planes.launches``.

The library is built at first use with nvcc from the package's own
sources into ``build/kernels/`` at the repository root (named by a hash
of source and flags, so an edited source is rebuilt) and loaded with
ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .hashing import MASK32, _row_multiplier, bits32, hashed_bucket, row_salt, u32
from .hll import hll_index_rank
from .invertible import inv_lane_values, inv_row_hash
from .quantiles import bucket_constants, bucket_index

CSRC = Path(__file__).resolve().parents[1] / "csrc" / "sketch_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
TILE = 16384  # buckets per shared-memory tile; csrc kTileMax

# plane kinds and key lanes, as csrc/sketch_kernels.cu numbers them
HIST, HLL, INV_COUNT, INV_KEYSUM, INV_FPSUM, QUANT = range(6)
LANE_HH, LANE_DISTINCT, LANE_DIST, LANE_VALUES = range(4)


# -- build and bind -----------------------------------------------------------

class _Library:
    """The built library, loaded once per process."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.path: Path | None = None
        self.build_log = ""
        self.build_seconds = 0.0

    def build(self) -> Path:
        """Compile csrc/sketch_kernels.cu with nvcc (once per source and
        flag set) and return the library's path."""
        src = CSRC.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"libsketch_kernels-{digest}.so"
        if out.exists():
            return out
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC)],
                              capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{self.build_log}")
        os.replace(tmp, out)
        return out

    def get(self) -> ctypes.CDLL:
        with self._mu:
            if self._lib is None:
                self.path = self.build()
                lib = ctypes.CDLL(str(self.path))
                vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
                lib.ig_fused_planes.argtypes = [vp, vp, vp, vp, vp, vp, i, i,
                                                f, f, f, i, vp, i, vp]
                lib.ig_fused_planes.restype = i
                self._lib = lib
            return self._lib


LIBRARY = _Library()


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _kernel_lane(x: torch.Tensor, n: int, dev: torch.device, name: str) -> torch.Tensor:
    """A 32-bit contiguous lane of length n on `dev`, or a raised error."""
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.shape != (n,):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected ({n},)")
    return bits32(x).contiguous()


def _on_cpu(*xs: torch.Tensor) -> bool:
    devs = {x.device.type for x in xs if x is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors on {sorted(devs)}: a kernel takes CUDA tensors, "
                     "its plain version CPU tensors")


# -- the one kernel entry: a table of (plane, bucket tile) jobs ---------------

@dataclass(frozen=True)
class Plane:
    kind: int
    lane: int
    mult: int
    salt: int
    log2_width: int  # hashed planes: bucket bits; 0 for the quantile row
    width: int
    offset: int      # first bucket of the plane in the flat delta buffer


@functools.lru_cache(maxsize=64)
def _job_table(planes: tuple[Plane, ...], dev: torch.device) -> tuple[torch.Tensor, int]:
    """The kernel's (n_jobs, 8) int32 job rows on `dev` — one per (plane,
    bucket tile) — and the widest tile."""
    rows = []
    for pl in planes:
        for lo in range(0, pl.width, TILE):
            rows.append((pl.kind, pl.lane, pl.mult, pl.salt, 32 - pl.log2_width,
                         lo, min(TILE, pl.width - lo), pl.offset))
    table = np.array(rows, dtype=np.int64)
    table = np.where(table >= 1 << 31, table - (1 << 32), table).astype(np.int32)
    return torch.from_numpy(table).to(dev), int(max(r[6] for r in rows))


def _launch_planes(planes: tuple[Plane, ...], lanes, w: torch.Tensor,
                   vals: torch.Tensor | None, n: int, dev: torch.device, ilg: float,
                   neg_off: float, min_value: float, qt_buckets: int) -> torch.Tensor:
    """Zero the flat int32 delta buffer of `planes` and launch
    ig_fused_planes on it (no launch for an empty batch)."""
    last = planes[-1]
    out = torch.zeros(last.offset + last.width, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    jobs, max_tile = _job_table(planes, dev)
    lib = LIBRARY.get()
    with torch.cuda.device(dev):
        _check(lib.ig_fused_planes(
            *(x.data_ptr() for x in lanes), vals.data_ptr() if vals is not None else None,
            w.data_ptr(), jobs.data_ptr(), jobs.shape[0], max_tile, ilg, neg_off,
            min_value, qt_buckets, out.data_ptr(), n, _stream(dev)), "ig_fused_planes")
    return out


# -- K1: hashed weighted histogram --------------------------------------------

def histogram_plain(keys: torch.Tensor, weights: torch.Tensor, *, log2_width: int,
                    mult: int = 0x9E3779B1, salt: int = 0) -> torch.Tensor:
    """hist[b] = sum of weights[n] with fmix32(keys[n]*mult+salt) >>
    (32-log2_width) == b, as int32 (wrapping)."""
    idx = hashed_bucket(keys, mult, salt, log2_width)
    out = torch.zeros(1 << log2_width, dtype=torch.int64, device=keys.device)
    out.index_add_(0, idx, weights.to(torch.int64))
    return bits32(out & MASK32)


def histogram(keys: torch.Tensor, weights: torch.Tensor, *, log2_width: int,
              mult: int = 0x9E3779B1, salt: int = 0) -> torch.Tensor:
    """K1: (n,) uint32 keys + (n,) int32 weights -> (2**log2_width,) int32
    histogram. CUDA tensors launch the kernel, CPU tensors take
    `histogram_plain`."""
    if _on_cpu(keys, weights):
        return histogram_plain(keys, weights, log2_width=log2_width, mult=mult, salt=salt)
    dev = keys.device
    n = keys.shape[0]
    k = _kernel_lane(keys, n, dev, "keys")
    w = _kernel_lane(weights.to(torch.int32), n, dev, "weights")
    plane = Plane(HIST, LANE_HH, mult & MASK32, salt & MASK32, log2_width, 1 << log2_width, 0)
    out = _launch_planes((plane,), (k, k, k), w, None, n, dev, 0.0, 0.0, 0.0, 0)
    if n:
        histogram.launches += 1
    return out


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
        """The planes in the reference's order: depth count-min rows, the
        entropy row, the HLL row, 3 lanes per invertible row (count,
        keysum, fpsum), the DDSketch row."""
        spec = [(HIST, LANE_HH, int(_row_multiplier(d)), row_salt(d), self.log2_width)
                for d in range(self.depth)]
        spec.append((HIST, LANE_DIST, int(_row_multiplier(0)), 0, self.ent_log2_width))
        spec.append((HLL, LANE_DISTINCT, 0, 0, self.hll_p))
        for r in range(self.inv_rows):
            mult, salt = inv_row_hash(r)
            spec += [(kind, LANE_HH, mult, salt, self.inv_log2_buckets)
                     for kind in (INV_COUNT, INV_KEYSUM, INV_FPSUM)]
        out, offset = [], 0
        for kind, lane, mult, salt, lw in spec:
            out.append(Plane(kind, lane, mult, salt, lw, 1 << lw, offset))
            offset += 1 << lw
        if self.qt_buckets:
            out.append(Plane(QUANT, LANE_VALUES, 0, 0, 0, self.qt_buckets, offset))
        return tuple(out)

    @property
    def total(self) -> int:
        last = self.planes[-1]
        return last.offset + last.width


def fused_planes_plain(hh: torch.Tensor, distinct: torch.Tensor, dist: torch.Tensor,
                       weights: torch.Tensor, values: torch.Tensor | None,
                       geom: FusedGeometry) -> torch.Tensor:
    """Plain version of K2: the flat (geom.total,) int32 delta buffer,
    plane after plane (see `FusedGeometry.planes`)."""
    lanes = (hh, distinct, dist, values)
    w = weights.to(torch.int64)
    out = torch.zeros(geom.total, dtype=torch.int64, device=hh.device)
    inv = inv_lane_values(hh, weights) if geom.inv_rows else None
    for pl in geom.planes:
        seg = out[pl.offset:pl.offset + pl.width]
        keys = lanes[pl.lane]
        if pl.kind == HIST:
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
    if _on_cpu(hh, distinct, dist, weights, values if geom.qt_buckets else None):
        return fused_planes_plain(hh, distinct, dist, weights, values, geom)
    dev = hh.device
    n = hh.shape[0]
    lanes = [_kernel_lane(x, n, dev, name) for x, name in
             ((hh, "hh"), (distinct, "distinct"), (dist, "dist"))]
    w = _kernel_lane(weights.to(torch.int32), n, dev, "weights")
    vals = _kernel_lane(values, n, dev, "values") if geom.qt_buckets else None
    ilg, off = bucket_constants(geom.qt_alpha, geom.qt_min_value)
    out = _launch_planes(geom.planes, lanes, w, vals, n, dev, ilg, -off,
                         float(np.float32(geom.qt_min_value)), geom.qt_buckets)
    if n:
        fused_planes.launches += 1
    return out


fused_planes.launches = 0


def split_planes(buf: torch.Tensor, geom: FusedGeometry):
    """Flat delta buffer -> (cms (depth, W) int32, entropy (We,) float32,
    HLL ranks (2**p,) int32, invertible (rows, 3, Wi) int64 lanes or None,
    quantile (buckets,) int32 or None)."""
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
            buf[ent.offset:ent.offset + ent.width].to(torch.float32),
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
