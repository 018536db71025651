// Hand-written Hopper (sm_90a) kernel K3: streaming-softmax attention.
//
// Replaces inspektor_gadget_tpu/parallel/flash_attention.py:86
// flash_attention (body _flash_kernel :42). The forward of the seq
// anomaly scorer's attn="flash" backend; the backward recomputes in
// PyTorch (inspektor_gadget_tpu_torch/parallel/flash_attention.py).
//
// It is built by nvcc into a plain-C shared library and launched through
// ctypes, on the caller's stream; it returns cudaGetLastError().
//
// Layout [B, T, H, D] as in the reference, q, k and v each with their own
// batch, time and head strides (the seq model hands in strided views of
// one qkv tensor; nothing is copied) and unit stride over D. The output
// is a contiguous [B, T, H, D] tensor in the inputs' type (f32 or bf16).
// Any T, and D in {16, 32, 64, 128}: nothing is padded, the ragged last
// query and key tiles are masked here.
//
// Math, as the reference: q is cast to f32 and scaled before the dot;
// scores, the running max m, the denominator l and the accumulator are
// f32; keys at or beyond T, and above the diagonal when causal, score
// the finite -1e30 (so a masked key gives exp() = 0, never NaN); the
// output is acc / max(l, 1e-30), rounded to the inputs' type.
//
// What bounds it on the card: its inputs are small (at the operator's
// shape 128 x 255 tokens, 4 heads of 32, bf16, q, k, v and o are 33 MB:
// 10 us at 3.35 TB/s) and its work is 2·B·H·T²·D operations causal, so
// on tensor cores it would be bound by bytes at the operator's window
// and by operations at long windows. This version does its math in f32
// on the CUDA cores (67 TFLOP/s at most), so operations bound it at every
// shape. Tensor cores (mma/wgmma) and TMA are later work.
//
// Design. The TPU grid walked the key blocks of one query block in order,
// carrying (m, l, acc) in VMEM scratch between grid steps. Here one
// thread block owns one (batch·head, 128-row query tile) and walks the
// key tiles itself in a loop, so the carry is in registers. Each query
// row is owned by G threads (G = 1 for D <= 32, D/32 above), each holding
// 32 or fewer of its dims of q and acc in registers; a row's score is the
// sum of its G partial dots over a warp shuffle. Key and value tiles are
// staged through shared memory as f32, where every thread of the block
// reads the same key row at once (a broadcast). The softmax state is
// rescaled once per 8 keys. Causal tiles above the diagonal are never
// loaded. The heaviest query tiles (the last, under causal masking) are
// scheduled first.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kRows = 128;  // query rows per block
constexpr int kChunk = 8;   // keys per softmax rescale

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Strides {
  long long b, t, h;  // in elements
};

template <int D>
struct Shape {
  static constexpr int G = D > 32 ? D / 32 : 1;  // threads per query row
  static constexpr int DPT = D / G;              // dims per thread
  static constexpr int NV = DPT / 4;             // float4 slices per thread
  static constexpr int BK = D == 128 ? 32 : 64;  // keys per shared tile (32 KB for k and v at most)
  static constexpr int NT = kRows * G;           // threads per block
};

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, Strides sq, Strides sk, Strides sv, int t_len, int heads,
             int causal, float scale) {
  using S = Shape<D>;
  __shared__ __align__(16) float ks[S::BK][D];
  __shared__ __align__(16) float vs[S::BK][D];

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bi = blockIdx.y / heads;
  const int hi = blockIdx.y % heads;
  const int g = threadIdx.x % S::G;
  const int row = tile * kRows + threadIdx.x / S::G;
  const bool live = row < t_len;

  const T* qb = q + bi * sq.b + hi * sq.h;
  const T* kb = k + bi * sk.b + hi * sk.h;
  const T* vb = v + bi * sv.b + hi * sv.h;

  // this thread's dims: 4 * (i * G + g) + c, for i < NV and c < 4
  float qr[S::DPT], acc[S::DPT];
#pragma unroll
  for (int i = 0; i < S::NV; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int dim = 4 * (i * S::G + g) + c;
      qr[4 * i + c] = live ? to_f32(qb[row * sq.t + dim]) * scale : 0.f;
      acc[4 * i + c] = 0.f;
    }
  }
  float m = kNeg, l = 0.f;

  const int last_row = min(t_len, (tile + 1) * kRows) - 1;
  const int key_end = causal ? last_row + 1 : t_len;
  for (int k0 = 0; k0 < key_end; k0 += S::BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < S::BK * D; e += S::NT) {
      const int j = e / D, d = e % D;
      const int key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < t_len) {
        kx = to_f32(kb[key * sk.t + d]);
        vx = to_f32(vb[key * sv.t + d]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();
    for (int j0 = 0; j0 < S::BK && k0 + j0 < key_end; j0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float4* kr = reinterpret_cast<const float4*>(ks[j0 + c]);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < S::NV; ++i) {
          const float4 kk = kr[i * S::G + g];
          dot = fmaf(qr[4 * i], kk.x, dot);
          dot = fmaf(qr[4 * i + 1], kk.y, dot);
          dot = fmaf(qr[4 * i + 2], kk.z, dot);
          dot = fmaf(qr[4 * i + 3], kk.w, dot);
        }
#pragma unroll
        for (int off = S::G / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int key = k0 + j0 + c;
        const bool keep = key < t_len && (!causal || key <= row);
        s[c] = keep ? dot : kNeg;
      }
      float m_new = m;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) m_new = fmaxf(m_new, s[c]);
      const float corr = expf(m - m_new);
      float p[kChunk];
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        p[c] = expf(s[c] - m_new);
        psum += p[c];
      }
      m = m_new;
      l = l * corr + psum;
#pragma unroll
      for (int x = 0; x < S::DPT; ++x) acc[x] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float4* vr = reinterpret_cast<const float4*>(vs[j0 + c]);
#pragma unroll
        for (int i = 0; i < S::NV; ++i) {
          const float4 vv = vr[i * S::G + g];
          acc[4 * i] = fmaf(p[c], vv.x, acc[4 * i]);
          acc[4 * i + 1] = fmaf(p[c], vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p[c], vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p[c], vv.w, acc[4 * i + 3]);
        }
      }
    }
  }
  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
  T* orow = o + (((long long)bi * t_len + row) * heads + hi) * D;
#pragma unroll
  for (int i = 0; i < S::NV; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) store(orow + 4 * (i * S::G + g) + c, acc[4 * i + c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int t, int h,
                   Strides sq, Strides sk, Strides sv, int causal, float scale,
                   cudaStream_t stream) {
  const dim3 grid((t + kRows - 1) / kRows, b * h);
  flash_kernel<T, D><<<grid, Shape<D>::NT, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, sv, t, h, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v, void* o, int b,
                     int t, int h, Strides sq, Strides sk, Strides sv, int causal, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, t, h, sq, sk, sv, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, t, h, sq, sk, sv, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, t, h, sq, sk, sv, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, t, h, sq, sk, sv, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike)
extern "C" int ig_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int dtype, int b, int t, int h, int d,
                                  long long sqb, long long sqt, long long sqh,
                                  long long skb, long long skt, long long skh,
                                  long long svb, long long svt, long long svh,
                                  int causal, float scale, void* stream) {
  if (b < 1 || t < 1 || h < 1 || (long long)b * h > 65535) return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_d<float>(d, q, k, v, o, b, t, h, sq, sk, sv, causal, scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(d, q, k, v, o, b, t, h, sq, sk, sv, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
