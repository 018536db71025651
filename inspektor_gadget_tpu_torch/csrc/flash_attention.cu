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
// is a contiguous [B, T, H, D] tensor in the inputs' type. Any T, and D in
// {16, 32, 64, 128}: nothing is padded, the ragged last query and key
// tiles are masked here. Keys at or beyond T, and above the diagonal when
// causal, score the finite -1e30 (a masked key gives exp() = 0, never
// NaN); the output is acc / max(l, 1e-30).
//
// Two kernels, chosen by the inputs' type:
//
// bfloat16 (the seq model's type): flash_mma_kernel, on the tensor cores.
//   What bounds it on the card: at the operator's window (128 x 255
//   tokens, 4 heads of 32) q, k, v and o are 33 MB, 10 us at 3.35 TB/s,
//   against 2.1 GFLOP of causal attention (2 us at 989 TFLOP/s): bytes.
//   At a 16 x 4095 window the products are 69 GFLOP (70 us), and the
//   softmax takes one exponential per score, ~0.54 G of them over the
//   tiles up to the diagonal: at the SFU's ~4 T/s that is ~0.14 ms, above
//   the operations bound, so exponentials and then operations set it.
//   Design (FlashAttention-2's): a block of 4 warps owns one (batch·head,
//   64-row query tile), 16 rows a warp; the grid is (B·H, query tiles), so
//   every (batch, head)'s heaviest causal tile starts before any lighter
//   one and the short tiles fill the tail. The Q tile comes in once by
//   cp.async and stays in registers as mma A fragments (ldmatrix), bf16
//   and unscaled. K and V tiles of 64 keys stream through two
//   shared-memory stages by 16-byte cp.async, tile j+1 loading while tile
//   j computes. Rows are padded by 8 elements, so the 8 rows one ldmatrix
//   phase reads fall on 8 distinct 16-byte bank groups. S = Q·K^T and O +=
//   P·V are mma.sync.m16n8k16 (bf16 in, f32 accumulate); K's B fragments
//   come from ldmatrix on row-major K, V's from ldmatrix.trans, and P goes
//   from the S accumulators to A fragments in registers (the m16n8
//   accumulator layout is the m16n8k16 A layout), rounded to bf16: the one
//   rounding the f32 reference does not have (parallel/flash_attention.py
//   k3_tolerance bounds it). Scores are scaled in f32 after the product by
//   scale·log2(e), folded into the FFMA that subtracts the row max, so
//   each weight is one FFMA and one ex2.approx; the row max and
//   denominator live in f32 registers of the row's 4-thread quad and are
//   rescaled once per 64-key tile, their reductions taken as trees. Only
//   the diagonal and the ragged last tile are masked; tiles above the
//   diagonal are never loaded. The output is staged through the warp's
//   rows of the Q tile and stored 16 bytes a thread. Shared memory: 5
//   tiles of 64 x (D + 8) bf16, 87 KB at D = 128 (dynamic, above the 48 KB
//   default).
//
// float32: flash_kernel, f32 math on the CUDA cores (on tensor cores f32
//   would mean TF32, which rounds). One block owns one (batch·head,
//   128-row query tile); each query row is owned by G threads (G = 1 for
//   D <= 32, D/32 above), each holding 32 or fewer of its dims of q and
//   acc in registers; a row's score is the sum of its G partial dots over
//   a warp shuffle. K and V tiles are staged through shared memory as
//   f32, where every thread reads the same key row at once (a broadcast).
//   q is scaled before the dot, as in the reference; the softmax state is
//   rescaled once per 8 keys. Operations on the CUDA cores (67 TFLOP/s)
//   bound it at every shape.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;

struct Strides {
  long long b, t, h;  // in elements
};

// -- float32: the CUDA-core kernel ---------------------------------------------

constexpr int kRows = 128;  // query rows per block
constexpr int kChunk = 8;   // keys per softmax rescale

template <int D>
struct Shape {
  static constexpr int G = D > 32 ? D / 32 : 1;  // threads per query row
  static constexpr int DPT = D / G;              // dims per thread
  static constexpr int NV = DPT / 4;             // float4 slices per thread
  static constexpr int BK = D == 128 ? 32 : 64;  // keys per shared tile (32 KB for k and v at most)
  static constexpr int NT = kRows * G;           // threads per block
};

template <int D>
__global__ void __launch_bounds__(Shape<D>::NT)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, Strides sq, Strides sk,
             Strides sv, int t_len, int heads, int causal, float scale) {
  using S = Shape<D>;
  __shared__ __align__(16) float ks[S::BK][D];
  __shared__ __align__(16) float vs[S::BK][D];

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bi = blockIdx.y / heads;
  const int hi = blockIdx.y % heads;
  const int g = threadIdx.x % S::G;
  const int row = tile * kRows + threadIdx.x / S::G;
  const bool live = row < t_len;

  const float* qb = q + bi * sq.b + hi * sq.h;
  const float* kb = k + bi * sk.b + hi * sk.h;
  const float* vb = v + bi * sv.b + hi * sv.h;

  // this thread's dims: 4 * (i * G + g) + c, for i < NV and c < 4
  float qr[S::DPT], acc[S::DPT];
#pragma unroll
  for (int i = 0; i < S::NV; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int dim = 4 * (i * S::G + g) + c;
      qr[4 * i + c] = live ? qb[row * sq.t + dim] * scale : 0.f;
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
        kx = kb[key * sk.t + d];
        vx = vb[key * sv.t + d];
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
  float* orow = o + (((long long)bi * t_len + row) * heads + hi) * D;
#pragma unroll
  for (int i = 0; i < S::NV; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) orow[4 * (i * S::G + g) + c] = acc[4 * i + c] / denom;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b, int t,
                       int h, Strides sq, Strides sk, Strides sv, int causal, float scale,
                       cudaStream_t stream) {
  const dim3 grid((t + kRows - 1) / kRows, b * h);
  flash_kernel<D><<<grid, Shape<D>::NT, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, sq, sk, sv, t, h, causal,
      scale);
  return cudaGetLastError();
}

// -- bfloat16: the tensor-core kernel ------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // query rows a block; keys a K/V stage
constexpr int kWarps = 4;  // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Mma {
  static constexpr int LD = D + 8;         // shared row pitch, elements (conflict-free ldmatrix)
  static constexpr int KD = D / 16;        // k16 steps of Q·K^T over the head dim
  static constexpr int ND = D / 8;         // n8 tiles of the output over the head dim
  static constexpr int NK = kTile / 8;     // n8 tiles of S over a key tile
  static constexpr int CH = D / 8;         // 16-byte chunks a row
  static constexpr int TILE = kTile * LD;  // elements a shared tile
  static constexpr int SMEM = 5 * TILE * (int)sizeof(bf16);  // Q, K x 2 stages, V x 2 stages
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !live
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a · b, one m16n8k16 tile: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU.EX2 (about 2^-22 relative; a result below 2^-126, a
// weight no sum can see, flushes to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> one register of two bf16, lo in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&x);
}

// rows [row0, row0 + 64) of one (batch, head) slice into a shared tile;
// rows at or beyond t_len are zero-filled (finite values for masked keys)
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long st, int row0,
                                          int t_len) {
  using M = Mma<D>;
#pragma unroll
  for (int i = 0; i < kTile * M::CH / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / M::CH, c = e % M::CH;
    const int row = row0 + r;
    const bool live = row < t_len;
    cp_async16(dst + r * M::LD + c * 8, live ? src + row * st + c * 8 : src, live);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, Strides sq, Strides sk,
                 Strides sv, int t_len, int heads, int causal, float scale_log2) {
  using M = Mma<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + M::TILE;      // 2 stages
  bf16* v_s = k_s + 2 * M::TILE;  // 2 stages

  // blocks start in the order of their linear index, x fastest: every
  // (batch, head)'s heaviest causal tile first, then the next heaviest
  const int tile = gridDim.y - 1 - blockIdx.y;
  const int bi = blockIdx.x / heads;
  const int hi = blockIdx.x % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;  // the mma fragments' group and thread in group
  const int q0 = tile * kTile;
  const int n_tiles = causal ? tile + 1 : (t_len + kTile - 1) / kTile;

  const bf16* qb = q + bi * sq.b + hi * sq.h;
  const bf16* kb = k + bi * sk.b + hi * sk.h;
  const bf16* vb = v + bi * sv.b + hi * sv.h;

  load_tile<D>(q_s, qb, sq.t, q0, t_len);
  load_tile<D>(k_s, kb, sk.t, 0, t_len);
  load_tile<D>(v_s, vb, sv.t, 0, t_len);
  cp_async_commit();

  // the shared row and column each lane hands ldmatrix: for Q (A
  // fragments) and V (transposed B fragments) matrices 0-3 are (rows 0-7,
  // cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15); for K (B fragments
  // of two n8 tiles) they are (keys 0-7, dims 0-7), (0-7, 8-15), (8-15,
  // 0-7), (8-15, 8-15)
  const int a_row = lane % 8 + 8 * (lane / 8 % 2), a_col = 8 * (lane / 16);
  const int b_row = lane % 8 + 8 * (lane / 16), b_col = 8 * (lane / 8 % 2);

  unsigned qf[M::KD][4];
  float acc[M::ND][4];
#pragma unroll
  for (int n = 0; n < M::ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // this thread's rows g and g + 8 of the warp's 16: running max and its
  // partial denominator (the quad's sum is taken at the end)
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {  // the next tile loads into the other stage while this one computes
      load_tile<D>(k_s + (stage ^ 1) * M::TILE, kb, sk.t, (j + 1) * kTile, t_len);
      load_tile<D>(v_s + (stage ^ 1) * M::TILE, vb, sv.t, (j + 1) * kTile, t_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < M::KD; ++kk)
        ldsm_x4(qf[kk], q_s + (16 * warp + a_row) * M::LD + 16 * kk + a_col);
    }
    const bf16* ks = k_s + stage * M::TILE;
    const bf16* vs = v_s + stage * M::TILE;

    // S = Q·K^T for the warp's 16 rows and the tile's 64 keys
    float s[M::NK][4];
#pragma unroll
    for (int n = 0; n < M::NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < M::KD; ++kk) {
#pragma unroll
      for (int np = 0; np < M::NK / 2; ++np) {
        unsigned b[4];
        ldsm_x4(b, ks + (16 * np + b_row) * M::LD + 16 * kk + b_col);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // mask: the diagonal tile and the ragged last tile only
    const int k0 = j * kTile;
    if ((causal && j == tile) || k0 + kTile > t_len) {
#pragma unroll
      for (int n = 0; n < M::NK; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + 8 * n + 2 * tq + (c & 1);
          const int row = q0 + 16 * warp + g + 8 * (c >> 1);
          if (key >= t_len || (causal && key > row)) s[n][c] = kNeg;
        }
      }
    }

    // online softmax, once per tile; a row's 64 scores sit in its quad.
    // m is in log2 units: the max of the unscaled scores times
    // scale·log2(e) (the scale is positive), and each weight is
    // 2^(s·scale·log2(e) - m), one FFMA and one MUFU.EX2
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t[M::NK];  // the row's max, then its sum, as trees (short dependency chains)
#pragma unroll
      for (int n = 0; n < M::NK; ++n) t[n] = fmaxf(s[n][2 * r], s[n][2 * r + 1]);
#pragma unroll
      for (int w = M::NK / 2; w > 0; w /= 2) {
#pragma unroll
        for (int n = 0; n < w; ++n) t[n] = fmaxf(t[n], t[n + w]);
      }
      float mx = fmaxf(t[0], __shfl_xor_sync(0xffffffffu, t[0], 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      const float corr = fast_exp2(m[r] - m_new);
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < M::NK; ++n) {
        s[n][2 * r] = fast_exp2(fmaf(s[n][2 * r], scale_log2, -m_new));
        s[n][2 * r + 1] = fast_exp2(fmaf(s[n][2 * r + 1], scale_log2, -m_new));
        t[n] = s[n][2 * r] + s[n][2 * r + 1];
      }
#pragma unroll
      for (int w = M::NK / 2; w > 0; w /= 2) {
#pragma unroll
        for (int n = 0; n < w; ++n) t[n] += t[n + w];
      }
      l[r] = l[r] * corr + t[0];
#pragma unroll
      for (int n = 0; n < M::ND; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // O += P·V: S tiles 2kk and 2kk+1 are the A fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < M::ND / 2; ++np) {
        unsigned b[4];
        ldsm_x4_trans(b, vs + (16 * kk + a_row) * M::LD + 16 * np + a_col);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is consumed: the next iteration's load may refill it
  }

  // epilogue: the quad's denominators, then the warp's 16 rows through its
  // own rows of the Q tile, stored 16 bytes a thread
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  bf16* o_s = q_s + 16 * warp * M::LD;
#pragma unroll
  for (int n = 0; n < M::ND; ++n) {
    *reinterpret_cast<unsigned*>(o_s + g * M::LD + 8 * n + 2 * tq) =
        pack_bf16(acc[n][0] / l[0], acc[n][1] / l[0]);
    *reinterpret_cast<unsigned*>(o_s + (g + 8) * M::LD + 8 * n + 2 * tq) =
        pack_bf16(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * M::CH / 32; ++i) {
    const int e = lane + 32 * i;
    const int r = e / M::CH, c = e % M::CH;
    const int row = q0 + 16 * warp + r;
    if (row < t_len)
      *reinterpret_cast<uint4*>(o + (((long long)bi * t_len + row) * heads + hi) * D + 8 * c) =
          *reinterpret_cast<const uint4*>(o_s + r * M::LD + 8 * c);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int b, int t,
                        int h, Strides sq, Strides sk, Strides sv, int causal, float scale,
                        cudaStream_t stream) {
  constexpr int smem = Mma<D>::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(b * h, (t + kTile - 1) / kTile);
  flash_mma_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, sq, sk, sv, t, h, causal,
      scale * kLog2e);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const void*, const void*, void*, int, int, int,
                               Strides, Strides, Strides, int, float, cudaStream_t);

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike)
extern "C" int ig_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int dtype, int b, int t, int h, int d,
                                  long long sqb, long long sqt, long long sqh,
                                  long long skb, long long skt, long long skh,
                                  long long svb, long long svt, long long svh,
                                  int causal, float scale, void* stream) {
  if (b < 1 || t < 1 || h < 1 || (long long)b * h > 65535) return (int)cudaErrorInvalidValue;
  Launch launch = nullptr;
  switch (dtype * 1000 + d) {
    case 16: launch = launch_f32<16>; break;
    case 32: launch = launch_f32<32>; break;
    case 64: launch = launch_f32<64>; break;
    case 128: launch = launch_f32<128>; break;
    case 1016: launch = launch_bf16<16>; break;
    case 1032: launch = launch_bf16<32>; break;
    case 1064: launch = launch_bf16<64>; break;
    case 1128: launch = launch_bf16<128>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh};
  return (int)launch(q, k, v, o, b, t, h, sq, sk, sv, causal, scale, (cudaStream_t)stream);
}
