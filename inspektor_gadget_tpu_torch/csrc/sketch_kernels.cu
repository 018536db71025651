// Hand-written Hopper (sm_90a) kernels for the sketch-ingest path.
//
// One entry, ig_fused_planes, serves both kernels of the path:
// K1 (one hashed-histogram plane) replaces
//    inspektor_gadget_tpu/ops/pallas_kernels.py:61 pallas_histogram
//    (body _hist_kernel :39)
// K2 (every sketch plane)         replaces
//    inspektor_gadget_tpu/ops/pallas_kernels.py:296 fused_sketch_planes
//    (body _fused_kernel :142)
// It is built by nvcc into a plain-C shared library and launched through
// ctypes (inspektor_gadget_tpu_torch/ops/kernels.py), on the caller's
// stream, with a launch plan that ops/kernels.py builds (`launch_plan`);
// it returns the CUDA error of the launch.
//
// What bounds them on the card. Each lane of 4-byte keys is read once and
// each bucket of the output written once: 2.6 MB in and 1.3 MB out for K2
// at the production geometry (batch 2^17; count-min 4 x 2^16, entropy
// 2^12, HLL 2^14, invertible 3 x 3 x 2^12, DDSketch 2048), about 1.2 us of
// memory. What they wait on instead (measured on an H100 SXM with
// sketch_probe.py, a probe since taken out of the tree; git keeps it):
// a fixed ~5.7 us a call (the launch and the zeroing of every block's
// tile), the tally, in which each (plane, tile) job reads its key lane
// and the weights again (29 MB, mostly from L2), and ~0.3M device atomics
// in the flush. Atomic contention is not among them: a block's
// shared-memory atomics run as fast at the zipf stream's buckets (its top
// key is 21% of it) as at uniform ones.
//
// Why no tensor cores. The TPU kernel tallied with a one-hot product on
// the MXU in f32. A one-hot product on the tensor cores is exact only in
// int8, and the weights lane is int32; in f16/bf16/TF32, or f32
// accumulation, the tallies stop being exact integers, and bit-identity
// with the reference is the contract (GPU and TPU nodes merge each
// other's sketches). Every plane accumulates in integer atomics instead:
// atomicAdd on uint32 wraps mod 2^32 by itself, atomicMax takes HLL
// ranks. They commute, so the result is exact and the same in whatever
// order the blocks run.
//
// The entropy plane (kHist64) must not wrap: the reference adds float32
// weights. Each of its buckets is an int64 in the output, a (low, high)
// word pair. Its tile keeps 32-bit low words as the others do; an add
// that wraps a low word adds +2^32, and a negative weight -2^32, into the
// bucket's int64 in device memory, and the flush adds each low word into
// it with a 64-bit atomic, whose own wrap carries by itself: the exact
// signed sum, whatever the order. Weights that are small and positive
// never carry, so the tally costs a compare, and no device atomic waits
// for its result.
//
// The layout (ops/kernels.py LaunchPlan), chosen by measurement:
// - Jobs. Each plane is cut into tiles of at most 16384 buckets (64 KB of
//   shared memory): four a 65536-wide count-min row, one for each other
//   plane at the production geometry, 28 in all.
// - Rows. Each job's rows are cut into slices in proportion to its work a
//   row (a DDSketch bucket costs about three hashes), 3 blocks for each
//   SM of the card in all and at least 512 rows a block, so that no block
//   walks much longer than another. One block a (job, slice).
// - Tally. A block zeroes its tile, then its threads take 4 rows at a
//   time: 16-byte loads where the lane's view puts the row on 16 bytes,
//   4-byte loads where not (rows of a (5, n) tensor with odd n) and for
//   the ragged tail. One shared-memory atomic a row that adds.
// - Flush. One device atomic a nonzero bucket of the tile into the
//   zeroed output (atomicMax for HLL ranks).
// Why not thread block clusters (the layout first proposed, and then a
// second one): with each job's tile spread over a cluster of 4 blocks,
// every row hashed once per plane and added into the owning block
// through distributed shared memory after equal keys of a warp were
// combined (__match_any_sync, __reduce_add_sync), K2 took 0.085 ms: an
// atomic into another block's shared memory ran at 1/6 to 1/7 the rate
// of one into the block's own, and combining a warp's keys first cost
// 6-9x the atomics it saved. With block-local tiles whose pairs were
// added through distributed shared memory before the flush, K2 took
// 0.0207 ms: the pair reduction and two cluster barriers cost a fixed
// ~3 us, more than the flush atomics they saved. This layout took
// 0.0171 ms in the same run (PERF.md).
// Per call at the production geometry on chip_smoke.py's timing input
// (layout_counts in tests/test_torch_sketch_layout.py, which pins them):
// K2 reads 29.4 MB of lanes (mostly from L2), hashes 3.67M keys, makes
// 1.87M shared-memory atomics and 0.31M device atomics, over 396 blocks
// of 64 KB of shared memory, 3 resident an SM; K1 (entropy, 2^12) reads
// 1.0 MB, hashes 131K keys, makes 117K shared-memory and 40K device
// atomics over 256 blocks of 16 KB. Neither launches clusters (size 1)
// or makes distributed-shared-memory atomics.
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
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMinBlocks = 3;      // blocks an SM: 3 x 64 KB tiles, registers capped to fit
constexpr int kMaxSmem = 232448;   // shared memory a block may use on sm_90
constexpr int kMaxDevices = 64;

// plane kinds and the block table's layout (kept in step with ops/kernels.py)
constexpr int kHist = 0;
constexpr int kHll = 1;
constexpr int kInvCount = 2;
constexpr int kInvKeysum = 3;
constexpr int kQuant = 5;
constexpr int kHist64 = 6;  // a histogram of exact int64 counts
constexpr int kBlockFields = 10;  // kind, lane, mult, salt, shift, lo, width,
                                  // first bucket in out, first row, end row

constexpr uint32_t kFpSalt = 0x7F4A7C15u;

struct Batch {
  const uint32_t* lane[4];  // hh, distinct, dist, values
  const int32_t* w;
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

// Rows [r, r+4) of a lane: one 16-byte load where the lane's view puts
// row r on 16 bytes and all four rows are in range, else 4-byte loads;
// rows at or past `end` read as 0 (weight 0: they add nothing).
__device__ __forceinline__ void load4(const uint32_t* __restrict__ p, int r, int end,
                                      uint32_t v[4]) {
  const uint32_t* a = p + r;
  if (r + 4 <= end && (reinterpret_cast<uintptr_t>(a) & 15u) == 0) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(a));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    #pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = r + j < end ? __ldg(a + j) : 0u;
  }
}

// One block a (job, row slice) of the plan: zero the job's tile, tally
// the slice's rows into it with shared-memory atomics, flush its nonzero
// buckets into `out` with one device atomic each.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_planes_kernel(Batch batch, const int32_t* __restrict__ blocks, QuantParams q,
                    uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t tile[];
  const int32_t* job = blocks + kBlockFields * blockIdx.x;
  const int kind = job[0];
  const int lane = job[1];
  const uint32_t mult = (uint32_t)job[2];
  const uint32_t salt = (uint32_t)job[3];
  const int shift = job[4];
  const uint32_t lo = (uint32_t)job[5];
  const int width = job[6];
  uint32_t* dst = out + job[7];  // kHist64: bucket b's int64 at dst[2b] (on 8 bytes)
  const int rb = job[8];
  const int re = job[9];
  const uint32_t* __restrict__ keys = lane == 0 ? batch.lane[0] : lane == 1 ? batch.lane[1]
                                    : lane == 2 ? batch.lane[2] : batch.lane[3];

  uint4* tile4 = reinterpret_cast<uint4*>(tile);
  for (int i = threadIdx.x; i < (width + 3) >> 2; i += kThreads)
    tile4[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int r = rb + 4 * (int)threadIdx.x; r < re; r += 4 * kThreads) {
    uint32_t w[4];
    load4(reinterpret_cast<const uint32_t*>(batch.w), r, re, w);
    if ((w[0] | w[1] | w[2] | w[3]) == 0u) continue;
    uint32_t key[4];
    load4(keys, r, re, key);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t k = key[j];
      const uint32_t wj = w[j];
      uint32_t b;
      uint32_t val;
      if (kind == kHll) {
        const uint32_t h = fmix32(k);
        b = h >> shift;
        val = hll_rank(h, 32 - shift);
      } else if (kind == kQuant) {
        b = quant_bucket(k, q);
        val = k == 0u ? 0u : wj;  // zero values weigh 0 here (the zero bucket is host-side)
      } else {
        b = fmix32(k * mult + salt) >> shift;
        val = kind == kHist || kind == kInvCount || kind == kHist64 ? wj
            : kind == kInvKeysum ? k * wj
            : fmix32(k ^ kFpSalt) * wj;
      }
      b -= lo;
      if (wj == 0u || val == 0u || b >= (uint32_t)width) continue;
      if (kind == kHll) {
        atomicMax(tile + b, val);
      } else if (kind == kHist64) {
        // the tile keeps the low word; a wrap of it adds +2^32, and a
        // negative weight -2^32, straight into the bucket's int64
        const uint32_t old = atomicAdd(tile + b, val);
        const long long carry = (old + val < old ? 1 : 0) - ((int32_t)wj < 0 ? 1 : 0);
        if (carry != 0)
          atomicAdd(reinterpret_cast<unsigned long long*>(dst) + b,
                    (unsigned long long)(carry * 4294967296LL));
      } else {
        atomicAdd(tile + b, val);
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < width; b += kThreads) {
    const uint32_t v = tile[b];
    if (v == 0u) continue;
    if (kind == kHll) {
      atomicMax(dst + b, v);
    } else if (kind == kHist64) {  // a 64-bit add: a wrap of the low word carries itself
      atomicAdd(reinterpret_cast<unsigned long long*>(dst) + b, (unsigned long long)v);
    } else {
      atomicAdd(dst + b, v);
    }
  }
}

// cudaFuncSetAttribute once per (device, size), raised, never lowered: the
// attribute holds for the current device only.
std::mutex g_mu;
size_t g_smem_set[kMaxDevices] = {};

cudaError_t prepare(size_t smem) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  if (smem <= g_smem_set[device]) return cudaSuccess;
  const cudaError_t set = cudaFuncSetAttribute(
      fused_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set == cudaSuccess) g_smem_set[device] = smem;
  return set;
}

bool tile_ok(int tile_words) {
  return tile_words >= 4 && tile_words % 4 == 0 &&
         (size_t)tile_words * sizeof(uint32_t) <= (size_t)kMaxSmem;
}

}  // namespace

// Blocks of ig_fused_planes the current device keeps resident on one SM
// with a tile of `tile_words` buckets (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int ig_fused_planes_occupancy(int tile_words, int* blocks_per_sm) {
  if (!tile_ok(tile_words)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tile_words * sizeof(uint32_t);
  const cudaError_t err = prepare(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fused_planes_kernel,
                                                            kThreads, smem);
}

// blocks: (n_blocks, 10) int32 rows on the current device, one a block
// (ops/kernels.py `LaunchPlan`); tile_words: the widest job's buckets,
// rounded up to 4; out: the zeroed flat delta buffer.
extern "C" int ig_fused_planes(const void* hh, const void* distinct, const void* dist,
                               const void* values, const void* weights, const void* blocks,
                               int n_blocks, int tile_words, float ilg, float neg_off,
                               float min_value, int qt_buckets, void* out, int n,
                               void* stream) {
  if (!tile_ok(tile_words) || n_blocks < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tile_words * sizeof(uint32_t);
  const cudaError_t err = prepare(smem);
  if (err != cudaSuccess) return (int)err;
  Batch batch;
  batch.lane[0] = (const uint32_t*)hh;
  batch.lane[1] = (const uint32_t*)distinct;
  batch.lane[2] = (const uint32_t*)dist;
  batch.lane[3] = (const uint32_t*)values;
  batch.w = (const int32_t*)weights;
  const QuantParams q{ilg, neg_off, min_value, qt_buckets};
  fused_planes_kernel<<<n_blocks, kThreads, smem, (cudaStream_t)stream>>>(
      batch, (const int32_t*)blocks, q, (uint32_t*)out);
  return (int)cudaGetLastError();
}
