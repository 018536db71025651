// Hand-written Hopper (sm_90a) kernels for the sketch-ingest path.
//
// One entry, ig_fused_planes, launched with a table of (plane, bucket
// tile) jobs, serves both kernels of the path:
// K1 (one hashed-histogram plane) replaces
//    inspektor_gadget_tpu/ops/pallas_kernels.py:61 pallas_histogram
//    (body _hist_kernel :39)
// K2 (every sketch plane)         replaces
//    inspektor_gadget_tpu/ops/pallas_kernels.py:296 fused_sketch_planes
//    (body _fused_kernel :142)
//
// It is built by nvcc into a plain-C shared library and launched through
// ctypes (inspektor_gadget_tpu_torch/ops/kernels.py), on the caller's
// stream; it returns cudaGetLastError().
//
// What bounds them on the card: they read each 4-byte lane once and write
// each delta bucket once, so the floor is bytes over the memory rate, a
// few microseconds at the production geometry. What they actually wait
// on is atomic traffic: every event adds into one bucket per plane, and
// the zipf key streams the system sees send a large share of the events
// to a few buckets.
//
// Design. The TPU kernel tallied with a one-hot matrix product on the MXU
// in f32. That is not carried over: under TF32 the f32 tallies stop being
// exact integers, and bit-identity with the reference is the contract.
// Here every plane accumulates in integer atomics (atomicAdd on uint32,
// which wraps mod 2^32 by itself, atomicMax for HLL ranks). Integer
// atomics commute, so the result is exact and the same from run to run in
// whatever order the blocks run. Each block owns one (plane, bucket tile)
// job and one slice of the batch: it zeroes a shared-memory tile, tallies
// the slice into it with shared-memory atomics (contention on a hot
// bucket stays inside the SM), then flushes the nonzero buckets to device
// memory with one global atomic each. A tile is at most 16384 buckets
// (64 KB): the entropy (4096), HLL (16384), invertible (4096) and DDSketch
// (2048) planes fit in one; a 65536-wide count-min row is split into four
// tiles, each a job of its own that reads the whole slice and keeps the
// keys that hash into its range. Re-reading a lane four times costs L2
// traffic only (a 2^17-row lane is 512 KB), and it keeps every plane on
// the same shared-memory path instead of sending the widest rows to
// global atomics, where the hot zipf buckets would serialise in L2.
// Narrow planes write only their own width; nothing is padded to the
// widest plane as the TPU grid did.
//
// Numerics. Hashes are uint32 integer arithmetic, identical everywhere.
// The DDSketch bucket must equal the reference's float32 computation bit
// for bit: xla_logf repeats XLA's CPU lowering of log (the Cephes
// polynomial with its multiply-adds fused), and the index is
// ceil(fma(log(v), ilg, -off)) as XLA contracts it. Every fused step is
// an explicit __fmaf_rn and every other step an explicit _rn operation;
// the library is built with -fmad=false so nvcc adds no contraction of
// its own, and never with --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTileMax = 16384;

// job kinds (kept in step with ops/kernels.py)
constexpr int kHist = 0;
constexpr int kHll = 1;
constexpr int kInvCount = 2;
constexpr int kInvKeysum = 3;
constexpr int kInvFpsum = 4;
constexpr int kQuant = 5;

constexpr uint32_t kFpSalt = 0x7F4A7C15u;

struct Batch {
  const uint32_t* lane[4];  // hh, distinct, dist, values
  const int32_t* w;
  int n;
};

struct QuantParams {
  float ilg;
  float neg_off;
  float min_value;
  int buckets;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hashed_bucket(uint32_t key, uint32_t mult,
                                                  uint32_t salt, int shift) {
  return fmix32(key * mult + salt) >> shift;
}

__device__ __forceinline__ void zero_tile(uint32_t* tile, int width) {
  for (int b = threadIdx.x; b < width; b += blockDim.x) tile[b] = 0u;
  __syncthreads();
}

__device__ __forceinline__ void flush_add(const uint32_t* tile, int width,
                                          uint32_t* out) {
  __syncthreads();
  for (int b = threadIdx.x; b < width; b += blockDim.x) {
    const uint32_t v = tile[b];
    if (v) atomicAdd(out + b, v);
  }
}

__device__ __forceinline__ void flush_max(const uint32_t* tile, int width,
                                          uint32_t* out) {
  __syncthreads();
  for (int b = threadIdx.x; b < width; b += blockDim.x) {
    const uint32_t v = tile[b];
    if (v) atomicMax(out + b, v);
  }
}

// The hashed-histogram plane (K1's one plane; K2's count-min rows and
// entropy row): rows [begin, end) of the batch add their
// weight into bucket fmix32(key*mult+salt) >> shift when it falls in the
// tile [lo, lo+width); out points at the plane's bucket 0.
__device__ void hashed_hist_tile(uint32_t* tile, const uint32_t* __restrict__ keys,
                                 const int32_t* __restrict__ w, int begin, int end,
                                 uint32_t mult, uint32_t salt, int shift, int lo,
                                 int width, uint32_t* out) {
  zero_tile(tile, width);
  for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const int32_t wi = w[i];
    if (wi == 0) continue;
    const uint32_t b = hashed_bucket(keys[i], mult, salt, shift) - (uint32_t)lo;
    if (b < (uint32_t)width) atomicAdd(tile + b, (uint32_t)wi);
  }
  flush_add(tile, width, out + lo);
}

// XLA's CPU float32 log (Cephes logf, multiply-adds fused), for x > 0.
__device__ __forceinline__ float xla_logf(float x) {
  x = x > 0x1p-126f ? x : 0x1p-126f;
  const uint32_t bits = __float_as_uint(x);
  float e = __fadd_rn((float)((int)(bits >> 23) - 127), 1.0f);
  const float m = __uint_as_float((bits & 0x807FFFFFu) | 0x3F000000u);
  const bool lt = m < 0x1.6a09e6p-1f;
  e = __fsub_rn(e, lt ? 1.0f : 0.0f);
  const float xx = __fadd_rn(__fsub_rn(m, 1.0f), lt ? m : 0.0f);
  const float z = __fmul_rn(xx, xx);
  const float x3 = __fmul_rn(z, xx);
  const float y1 = __fmaf_rn(__fmaf_rn(xx, 0x1.204376p-4f, -0x1.d7a37p-4f), xx, 0x1.de4a34p-4f);
  const float y2 = __fmaf_rn(__fmaf_rn(xx, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), xx, -0x1.555cap-3f);
  const float y3 = __fmaf_rn(__fmaf_rn(xx, 0x1.999d58p-3f, -0x1.fffff8p-3f), xx, 0x1.555554p-2f);
  const float y = __fmaf_rn(__fmaf_rn(y1, x3, y2), x3, y3);
  const float t = __fmaf_rn(y, x3, __fmul_rn(e, -0x1.bd0106p-13f));
  return __fmaf_rn(e, 0x1.63p-1f, __fadd_rn(__fmaf_rn(z, -0.5f, xx), t));
}

// DDSketch bucket of a uint32 value: ceil(log(max(v, min)) * ilg - off),
// clipped to [0, buckets).
__device__ __forceinline__ uint32_t quant_bucket(uint32_t v, const QuantParams& q) {
  const float f = fmaxf(__uint2float_rn(v), q.min_value);
  float idx = ceilf(__fmaf_rn(xla_logf(f), q.ilg, q.neg_off));
  idx = fminf(fmaxf(idx, 0.0f), (float)(q.buckets - 1));
  return (uint32_t)idx;
}

// HLL rank: leading zeros of the bits below the index, plus one, clz
// taken on the int32 reinterpretation as the reference does.
__device__ __forceinline__ uint32_t hll_rank(uint32_t h, int p) {
  const uint32_t rest = (h << p) | ((1u << p) - 1u);
  const int lz = min(max(__clz((int)rest), 0), 32 - p);
  return (uint32_t)(lz + 1);
}

// Rows one block walks: at least one tile's width, so that zeroing and
// flushing the tile never costs more than the tally, and no more than
// needed to give the grid ~512 blocks.
int rows_per_block(int n, int n_jobs, int tile) {
  int chunks = (512 + n_jobs - 1) / n_jobs;
  const int by_tile = (n + tile - 1) / tile;
  if (chunks > by_tile) chunks = by_tile;
  if (chunks < 1) chunks = 1;
  return (n + chunks - 1) / chunks;
}

// jobs: (n_jobs, 8) int32 rows of kind, lane, mult, salt, shift, lo,
// width, plane offset in `out`.
__global__ void __launch_bounds__(kThreads)
fused_planes_kernel(Batch batch, const int32_t* __restrict__ jobs,
                    QuantParams q, uint32_t* out, int rows) {
  extern __shared__ uint32_t tile[];
  const int32_t* job = jobs + 8 * blockIdx.y;
  const int kind = job[0];
  const uint32_t* __restrict__ keys = batch.lane[job[1]];
  const uint32_t mult = (uint32_t)job[2];
  const uint32_t salt = (uint32_t)job[3];
  const int shift = job[4];
  const int lo = job[5];
  const int width = job[6];
  uint32_t* plane = out + job[7];
  const int begin = blockIdx.x * rows;
  const int end = min(batch.n, begin + rows);
  const int32_t* __restrict__ w = batch.w;

  if (kind == kHist) {
    hashed_hist_tile(tile, keys, w, begin, end, mult, salt, shift, lo, width, plane);
    return;
  }
  zero_tile(tile, width);
  for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const int32_t wi = w[i];
    if (wi == 0) continue;
    const uint32_t k = keys[i];
    const uint32_t wu = (uint32_t)wi;
    uint32_t b;
    uint32_t val;
    if (kind == kHll) {
      const uint32_t h = fmix32(k);
      b = h >> shift;
      val = hll_rank(h, 32 - shift);
    } else if (kind == kQuant) {
      if (k == 0u) continue;  // zero values weigh 0 here (the zero bucket is host-side)
      b = quant_bucket(k, q);
      val = wu;
    } else {
      b = hashed_bucket(k, mult, salt, shift);
      val = kind == kInvCount ? wu
          : kind == kInvKeysum ? k * wu
          : fmix32(k ^ kFpSalt) * wu;
    }
    b -= (uint32_t)lo;
    if (b >= (uint32_t)width) continue;
    if (kind == kHll) atomicMax(tile + b, val);
    else atomicAdd(tile + b, val);
  }
  if (kind == kHll) flush_max(tile, width, plane + lo);
  else flush_add(tile, width, plane + lo);
}

}  // namespace

extern "C" int ig_fused_planes(const void* hh, const void* distinct, const void* dist,
                               const void* values, const void* weights,
                               const void* jobs, int n_jobs, int max_tile,
                               float ilg, float neg_off, float min_value,
                               int qt_buckets, void* out, int n, void* stream) {
  if (max_tile < 1 || max_tile > kTileMax || n_jobs < 1 || n_jobs > 65535)
    return (int)cudaErrorInvalidValue;
  Batch batch;
  batch.lane[0] = (const uint32_t*)hh;
  batch.lane[1] = (const uint32_t*)distinct;
  batch.lane[2] = (const uint32_t*)dist;
  batch.lane[3] = (const uint32_t*)values;
  batch.w = (const int32_t*)weights;
  batch.n = n;
  const QuantParams q{ilg, neg_off, min_value, qt_buckets};
  const int rows = rows_per_block(n, n_jobs, max_tile);
  const size_t smem = (size_t)max_tile * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + rows - 1) / rows, n_jobs);
  fused_planes_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      batch, (const int32_t*)jobs, q, (uint32_t*)out, rows);
  return (int)cudaGetLastError();
}
