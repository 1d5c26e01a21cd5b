// Device code of K2 (fused_beam.cu), whose tiled products K1
// (fused_attention.cu) also uses for its gate.
//
// K2 runs the pieces below as phases of one persistent cooperative
// kernel, each block walking a share of the work items. So every piece
// takes its work item (a tile, an image and a chunk) as arguments
// instead of reading blockIdx, starts with __syncthreads() before it
// writes shared memory (the previous item or phase may still read it),
// and assumes kThreads threads per block.
//
// Buffers that K2 rewrites while it runs (h, att_dec, gate, scores, ctx)
// are read through plain pointers or cp.async.cg (which reads L2), never
// `const __restrict__`: that would allow the non-coherent read-only
// cache, which is not kept in step with writes made earlier in the same
// launch.
//
// Products. In bf16 a tile runs on the tensor cores: mma.sync m16n8k16
// (bf16 operands, f32 sums), operands staged by 16-byte cp.async in a
// ring of 64-deep slices (Shape::Stages deep) and read with ldmatrix. In
// f32 it stays a CUDA-core FMA tile, so f32 products are exact f32 (no
// TF32). Either way the tile's sums land in shared memory (f32), where
// the caller's epilogue reads them.
//
// L2 policy. The weights and activations that products read are marked
// evict_last and the grids that attention streams once a step
// (att_enc, enc) evict_first, so that at the serving sizes the 25 MB of
// weights can stay in the 50 MB L2 from one step to the next.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace icd {

constexpr int kThreads = 256;  // threads per block, every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;    // beams per image

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// ---------------------------------------------------------------------------
// PTX: L2 policies, 16-byte loads and copies, ldmatrix, mma.
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// 16 bytes of a buffer that no thread writes during the launch.
__device__ __forceinline__ uint4 load_stream16(const void* p,
                                               uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;" ::"r"(
          smem_addr(dst)),
      "l"(src), "l"(policy));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; d 16 x 8, f32. The
// tensor core sums the 16 products of each output from zero, and d takes
// that sum with an f32 add (rounded to nearest): the tensor core's own
// accumulation need not round to nearest, and over thousands of terms
// its error would pass that of an f32 sum taken in another order.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  float t[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// The 16 / sizeof(T) values of a 16-byte word, as floats.
template <typename T>
__device__ __forceinline__ void unpack16(uint4 v, float* x) {
  if constexpr (is_f32<T>()) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  } else {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// n floats (a multiple of 4) of shared memory at p, 16-byte aligned.
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float* x) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    x[i] = v.x;
    x[i + 1] = v.y;
    x[i + 2] = v.z;
    x[i + 3] = v.w;
  }
}

// ---------------------------------------------------------------------------
// Tiled products: acc(m, n) = sum_k a(row0 + m, k) * b(col0 + n, k) over
// a BM x BN tile, f32 sums, written to shared memory (row stride
// BN + 4; zero outside rows x cols), where the caller's epilogue reads
// them: the tile ends with __syncthreads().
constexpr int kTileK = 64;        // depth of a tensor-core slice
constexpr int kLds = kTileK + 8;  // bf16 row stride: 144 B, so ldmatrix's
                                  // 8 rows miss each other's banks
constexpr int kFmaK = 16;         // depth of an FMA slice

// A tile shape: BM x BN outputs; the 8 warps as WM along M x 8 / WM along
// N, each MT x NT mma tiles of 16 x 8; a Stages-deep cp.async ring.
template <int BM_, int BN_, int WM_, int Stages_>
struct Shape {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = kWarps / WM_;
  static constexpr int Stages = Stages_, Acc = BN_ + 4;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  static_assert(MT * WM * 16 == BM && NT * WN * 8 == BN, "whole mma tiles");
};

// The shape a tile takes in type T: S on the tensor cores for bf16; for
// f32 the FMA tile, 64 rows (4 a thread) by S's width.
template <typename T, class S>
using TileOf = typename std::conditional<is_f32<T>(), Shape<64, S::BN, 4, 1>,
                                         S>::type;

__host__ __device__ constexpr size_t max_size(size_t a, size_t b) {
  return a > b ? a : b;
}

// Shared memory of one tile of shape S in type T, bytes. bf16: the ring,
// whose room the sums take once the last slice is read; f32: 16-deep
// operand slices, then the sums.
template <typename T, class S>
__host__ __device__ constexpr size_t product_smem() {
  return is_f32<T>()
             ? (size_t)kFmaK * (64 + 1 + S::BN + 1) * 4 + (size_t)64 * S::Acc * 4
             : max_size((size_t)S::Stages * (S::BM + S::BN) * kLds * 2,
                        (size_t)S::BM * S::Acc * 4);
}

// A run of a bf16 operand row: n valid values from p (n <= 0: none).
struct Run {
  const __nv_bfloat16* p;
  int n;
};

// Copies 16 bytes' worth of values (16 / sizeof(T)) from src to shared
// dst, zero past n valid values: one cp.async where all are valid and src
// is 16-byte aligned, else one value at a time. (K2's code is large and
// each phase's part of it runs once a step, so it is likely fetched from
// L2 each time: the loops that copy are kept rolled.)
template <typename T>
__device__ __forceinline__ void stage16(T* dst, const T* src, int n,
                                        uint64_t policy) {
  constexpr int kVec = 16 / sizeof(T);
  if (n >= kVec && aligned16(src)) {
    cp_async16(dst, src, policy);
  } else if (n <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else {
#pragma unroll 1
    for (int e = 0; e < kVec; ++e) dst[e] = e < n ? src[e] : from_float<T>(0.f);
  }
}

// bf16 on the tensor cores, over depth [k0, k1) (k0 a multiple of
// kTileK). a(r, k) and b(n, k) give the Run at depth k (a multiple of 8)
// of operand row r < rows or n < cols; each segment of a row is
// zero-filled up to a multiple of 8, so no run crosses a seam.
template <class S, class RunA, class RunB>
__device__ void mma_tile(int row0, int col0, int rows, int cols, int k0,
                         int k1, RunA a, RunB b, char* smem) {
  constexpr int kStage = (S::BM + S::BN) * kLds;  // bf16 values
  constexpr int kWarpRows = S::BM / S::WM, kWarpCols = S::BN / S::WN;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % S::WM, wn = warp / S::WM;
  const uint64_t policy = l2_evict_last();

  auto load = [&](int stage, int kb) {
    __nv_bfloat16* as = ring + stage * kStage;
#pragma unroll 1
    for (int i = threadIdx.x; i < (S::BM + S::BN) * (kTileK / 8);
         i += kThreads) {
      const int m = i / (kTileK / 8), c = (i % (kTileK / 8)) * 8;
      const int k = kb + c;
      Run run{nullptr, 0};
      if (m < S::BM) {
        if (row0 + m < rows && k < k1) run = a(row0 + m, k);
      } else if (col0 + m - S::BM < cols && k < k1) {
        run = b(col0 + m - S::BM, k);
      }
      stage16(as + m * kLds + c, run.p, run.n, policy);
    }
  };

  float d[S::MT][S::NT][4];
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;

  const int slices = (k1 - k0 + kTileK - 1) / kTileK;
  __syncthreads();
#pragma unroll 1
  for (int s = 0; s < S::Stages - 1; ++s) {
    if (s < slices) load(s, k0 + s * kTileK);
    cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<S::Stages - 2>();
    __syncthreads();  // slice kt is in; slice kt - 1's stage is free
    const int next = kt + S::Stages - 1;
    if (next < slices) load(next % S::Stages, k0 + next * kTileK);
    cp_async_commit();
    const __nv_bfloat16* as = ring + (kt % S::Stages) * kStage;
    const __nv_bfloat16* bs = as + S::BM * kLds;
#pragma unroll 1  // (rolled: fewer live registers, no spills)
    for (int kk = 0; kk < kTileK; kk += 16) {
      unsigned bq[S::NT][2];
#pragma unroll
      for (int j = 0; j < S::NT / 2; ++j) {
        unsigned r4[4];
        ldmatrix_x4(r4, bs + (kWarpCols * wn + 16 * j + lane % 8 +
                              (lane / 16) * 8) * kLds +
                            kk + ((lane / 8) % 2) * 8);
        bq[2 * j][0] = r4[0];
        bq[2 * j][1] = r4[1];
        bq[2 * j + 1][0] = r4[2];
        bq[2 * j + 1][1] = r4[3];
      }
      if constexpr (S::NT % 2 == 1) {  // the last n8 tile alone
        ldmatrix_x2(bq[S::NT - 1],
                    bs + (kWarpCols * wn + 8 * (S::NT - 1) + lane % 8) * kLds +
                        kk + ((lane / 8) % 2) * 8);
      }
#pragma unroll
      for (int i = 0; i < S::MT; ++i) {
        unsigned af[4];
        ldmatrix_x4(af, as + (kWarpRows * wm + 16 * i + lane % 16) * kLds +
                            kk + (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < S::NT; ++j) mma_bf16(d[i][j], af, bq[j][0], bq[j][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the sums take it

  float* acc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < S::MT; ++i) {
    const int r = kWarpRows * wm + 16 * i + lane / 4;
#pragma unroll
    for (int j = 0; j < S::NT; ++j) {
      const int n = kWarpCols * wn + 8 * j + (lane % 4) * 2;
      acc[r * S::Acc + n] = d[i][j][0];
      acc[r * S::Acc + n + 1] = d[i][j][1];
      acc[(r + 8) * S::Acc + n] = d[i][j][2];
      acc[(r + 8) * S::Acc + n + 1] = d[i][j][3];
    }
  }
  __syncthreads();
}

// f32 on the CUDA cores: 16-deep slices through shared memory, 4 x BN/16
// outputs per thread. a(r, k) and b(n, k) return the operands as float
// for r < rows, n < cols, k < kdim.
template <class S, class LoadA, class LoadB>
__device__ void fma_tile(int row0, int col0, int rows, int cols, int kdim,
                         LoadA a, LoadB b, float* acc, float* smem) {
  static_assert(S::BM == 64, "16 threads of 4 rows");
  constexpr int BN = S::BN, kCols = BN / 16;
  float* as = smem;
  float* bs = smem + kFmaK * (64 + 1);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float d[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) d[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += kFmaK) {
    __syncthreads();
    for (int i = threadIdx.x; i < (64 + BN) * kFmaK; i += kThreads) {
      const int m = i / kFmaK, kk = i % kFmaK, k = k0 + kk;
      if (m < 64) {
        const int r = row0 + m;
        as[kk * (64 + 1) + m] = (k < kdim && r < rows) ? a(r, k) : 0.f;
      } else {
        const int n = col0 + m - 64;
        bs[kk * (BN + 1) + m - 64] = (k < kdim && n < cols) ? b(n, k) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmaK; ++kk) {
      float x[4], y[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = as[kk * (64 + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) y[j] = bs[kk * (BN + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) d[i][j] = fmaf(x[i], y[j], d[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      acc[(ty + 16 * i) * S::Acc + tx + 16 * j] = d[i][j];
  __syncthreads();
}

// One product tile of shape TileOf<T, S> in the grid's type, part `part`
// of `parts` of its depth: the tensor-core tile over whole slices of the
// padded depth kpad for bf16, the FMA tile over the whole depth kdim for
// f32 (which takes one part). va, vb give values (f32), ra, rb runs
// (bf16). Returns the shared array of the tile's sums.
template <typename T, class S, class ValA, class ValB, class RunA, class RunB>
__device__ const float* product_tile(int row0, int col0, int rows, int cols,
                                     int kdim, int kpad, int part, int parts,
                                     ValA va, ValB vb, RunA ra, RunB rb,
                                     char* smem) {
  using Tile = TileOf<T, S>;
  if constexpr (is_f32<T>()) {
    float* acc = reinterpret_cast<float*>(
        smem + (size_t)kFmaK * (64 + 1 + Tile::BN + 1) * 4);
    fma_tile<Tile>(row0, col0, rows, cols, kdim, va, vb, acc,
                   reinterpret_cast<float*>(smem));
    return acc;
  } else {
    const int per = ((kpad + kTileK - 1) / kTileK + parts - 1) / parts;
    const int k0 = part * per * kTileK;
    mma_tile<Tile>(row0, col0, rows, cols, k0, min(kpad, k0 + per * kTileK),
                   ra, rb, smem);
    return reinterpret_cast<const float*>(smem);
  }
}

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }

// ---------------------------------------------------------------------------
// 1. The products of h: att_dec = h Wd^T + bd and gate = sigmoid(h Wg^T +
// bg), as one (R, A + D) product with [Wd; Wg], in tiles of 64 x 32.
// Both in f32.
using HShape = Shape<64, 32, 4, 5>;

template <typename T>
__device__ void decoder_products_tile(int row0, int col0, const T* h,
                                      const T* __restrict__ wd,
                                      const T* __restrict__ bd,
                                      const T* __restrict__ wg,
                                      const T* __restrict__ bg,
                                      float* att_dec, float* gate, int rows,
                                      int hdim, int adim, int ddim,
                                      char* smem) {
  auto wrow = [=](int n) {
    return n < adim ? wd + (size_t)n * hdim : wg + (size_t)(n - adim) * hdim;
  };
  const float* acc = product_tile<T, HShape>(
      row0, col0, rows, adim + ddim, hdim, round8(hdim), 0, 1,
      [=](int r, int k) { return to_float(h[(size_t)r * hdim + k]); },
      [=](int n, int k) { return to_float(wrow(n)[k]); },
      [=](int r, int k) {
        return Run{(const __nv_bfloat16*)h + (size_t)r * hdim + k, hdim - k};
      },
      [=](int n, int k) {
        return Run{(const __nv_bfloat16*)wrow(n) + k, hdim - k};
      },
      smem);
  for (int i = threadIdx.x; i < HShape::BM * HShape::BN; i += kThreads) {
    const int m = i / HShape::BN, j = i % HShape::BN;
    const int r = row0 + m, n = col0 + j;
    if (r >= rows || n >= adim + ddim) continue;
    const float v = acc[m * HShape::Acc + j];
    if (n < adim)
      att_dec[(size_t)r * adim + n] = v + to_float(bd[n]);
    else
      gate[(size_t)r * ddim + (n - adim)] = sigmoid(v + to_float(bg[n - adim]));
  }
}

// ---------------------------------------------------------------------------
// 2. Scores of one image's k beams over pixels [p0, p1): one warp per
// pixel, two pixels a warp at a time, lanes across A in 16-byte words
// (a value at a time where a row of att_enc is not made of whole 16-byte
// words), one accumulator per beam. The k att_dec rows sit in shared
// memory, so each att_enc row is read once for all k beams. Shared
// memory: (k + 1) * A floats.
template <typename T>
__device__ void attention_scores_chunk(int img, int p0, int p1,
                                       const T* __restrict__ att_enc,
                                       const float* att_dec,
                                       const T* __restrict__ wf,
                                       const T* __restrict__ bf,
                                       float* scores, int k, int pix,
                                       int adim, float* smem) {
  constexpr int kVec = 16 / sizeof(T);
  float* dec = smem;             // (k, A) att_dec rows of this image
  float* wfs = smem + k * adim;  // (A,)
  __syncthreads();
  for (int i = threadIdx.x; i < k * adim; i += kThreads)
    dec[i] = att_dec[(size_t)img * k * adim + i];
  for (int i = threadIdx.x; i < adim; i += kThreads) wfs[i] = to_float(wf[i]);
  __syncthreads();

  const float bias = to_float(bf[0]);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool vec = adim % kVec == 0 && aligned16(att_enc);
  const uint64_t policy = l2_evict_first();
  for (int p = p0 + warp; p < p1; p += 2 * kWarps) {
    const int q = p + kWarps;  // the warp's second pixel, if any
    const T* ep = att_enc + ((size_t)img * pix + p) * adim;
    const T* eq = att_enc + ((size_t)img * pix + min(q, p1 - 1)) * adim;
    float accp[kMaxRows], accq[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) accp[r] = accq[r] = 0.f;
    if (vec) {
      // A lane's kVec values a time: x from att_enc, dec and wf from
      // shared memory in 16-byte words.
      for (int a = lane * kVec; a < adim; a += 32 * kVec) {
        float xp[kVec], xq[kVec], w[kVec];
        unpack16<T>(load_stream16(ep + a, policy), xp);
        unpack16<T>(q < p1 ? load_stream16(eq + a, policy)
                           : make_uint4(0, 0, 0, 0),
                    xq);
        load_floats<kVec>(wfs + a, w);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < k) {
            float dv[kVec];
            load_floats<kVec>(dec + r * adim + a, dv);
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              accp[r] = fmaf(fmaxf(xp[j] + dv[j], 0.f), w[j], accp[r]);
              accq[r] = fmaf(fmaxf(xq[j] + dv[j], 0.f), w[j], accq[r]);
            }
          }
        }
      }
    } else {
      for (int a = lane; a < adim; a += 32) {
        const float xp = to_float(ep[a]), xq = to_float(eq[a]), w = wfs[a];
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < k) {
            const float dv = dec[r * adim + a];
            accp[r] = fmaf(fmaxf(xp + dv, 0.f), w, accp[r]);
            accq[r] = fmaf(fmaxf(xq + dv, 0.f), w, accq[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < k) {  // k is the same for the whole warp
        const float sp = warp_sum(accp[r]), sq = warp_sum(accq[r]);
        if (lane == 0) {
          scores[((size_t)img * k + r) * pix + p] = sp + bias;
          if (q < p1) scores[((size_t)img * k + r) * pix + q] = sq + bias;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. Softmax over P, the context sum and the gate, for one image's k beams
// and the kCtxCols columns of D of chunk `chunk`: ctx = gate * sum_p
// alpha_p enc_p, rounded once to T. Chunk 0 also writes alpha (f32).
// Each chunk redoes the image's k softmaxes rather than wait for another
// block. The chunk's enc rows stream through a ring of kCtxRows pixels a
// stage (16-byte cp.async, kCtxStages - 1 stages in flight; a value at a
// time where a row of enc is not made of whole 16-byte words). Each
// thread sums two neighbouring columns over P in order for all k beams,
// the beams' weights of a pixel read as two 16-byte words of a
// transposed copy (pixel-major, zero past k), so that shared memory
// serves 3 reads for 16 multiply-adds.
constexpr int kCtxRows = 8, kCtxStages = 6, kCtxCols = 2 * kThreads;

// Shared memory of attention_context_chunk, bytes: the k softmax rows
// (padded to 16 bytes), their transpose (P, kMaxRows), then the ring.
template <typename T>
__host__ __device__ constexpr size_t context_smem(int k, int pix) {
  return ((size_t)k * pix + 3) / 4 * 16 + (size_t)pix * kMaxRows * 4 +
         (size_t)kCtxStages * kCtxRows * kCtxCols * sizeof(T);
}

template <typename T>
__device__ void attention_context_chunk(int img, int chunk,
                                        const T* __restrict__ enc,
                                        const float* scores,
                                        const float* gate, T* ctx,
                                        float* alpha, int k, int pix,
                                        int ddim, char* smem) {
  constexpr int kVec = 16 / sizeof(T), kWords = kCtxCols / kVec;
  float* soft = reinterpret_cast<float*>(smem);  // (k, P)
  float* wt = soft + ((size_t)k * pix + 3) / 4 * 4;  // (P, kMaxRows)
  T* ring = reinterpret_cast<T*>(wt + (size_t)pix * kMaxRows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = chunk * kCtxCols;
  const T* rows = enc + (size_t)img * pix * ddim + col0;
  const uint64_t policy = l2_evict_first();
  // Pixels [p0, p0 + kCtxRows) of the chunk's columns into `stage`.
  auto load = [&](int stage, int p0) {
#pragma unroll 1
    for (int i = threadIdx.x; i < kCtxRows * kWords; i += kThreads) {
      const int row = i / kWords, c = (i % kWords) * kVec, p = p0 + row;
      stage16(ring + (stage * kCtxRows + row) * kCtxCols + c,
              rows + (size_t)p * ddim + c, p < pix ? ddim - col0 - c : 0,
              policy);
    }
  };
  const int stages = (pix + kCtxRows - 1) / kCtxRows;
  __syncthreads();
  // The first stages fly while the softmax is taken.
#pragma unroll 1
  for (int s = 0; s < kCtxStages - 1; ++s) {
    if (s < stages) load(s, s * kCtxRows);
    cp_async_commit();
  }
  // The image's k score rows (contiguous), then one warp per beam.
  for (int i = threadIdx.x; i < k * pix; i += kThreads)
    soft[i] = scores[(size_t)img * k * pix + i];
  __syncthreads();
  if (warp < k) {
    float* w = soft + warp * pix;
    float m = -INFINITY;
    for (int p = lane; p < pix; p += 32) m = fmaxf(m, w[p]);
    m = warp_max(m);
    float sum = 0.f;
    for (int p = lane; p < pix; p += 32) {
      const float e = expf(w[p] - m);
      w[p] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float* out = alpha + ((size_t)img * k + warp) * pix;
    for (int p = lane; p < pix; p += 32) {
      const float v = w[p] / sum;
      w[p] = v;
      if (chunk == 0) out[p] = v;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < pix * kMaxRows; i += kThreads) {
    const int p = i / kMaxRows, r = i % kMaxRows;
    wt[i] = r < k ? soft[r * pix + p] : 0.f;
  }

  float acc[kMaxRows][2];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<kCtxStages - 2>();
    __syncthreads();  // stage st is in (and, at st = 0, the weights)
    const int next = st + kCtxStages - 1;
    if (next < stages) load(next % kCtxStages, next * kCtxRows);
    cp_async_commit();
    const T* x = ring + (st % kCtxStages) * kCtxRows * kCtxCols +
                 2 * threadIdx.x;
    const int p0 = st * kCtxRows;
#pragma unroll
    for (int row = 0; row < kCtxRows; ++row) {
      const int p = p0 + row;
      if (p < pix) {
        float w[kMaxRows];
        load_floats<kMaxRows>(wt + p * kMaxRows, w);
        const float x0 = to_float(x[row * kCtxCols]);
        const float x1 = to_float(x[row * kCtxCols + 1]);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          acc[r][0] = fmaf(w[r], x0, acc[r][0]);
          acc[r][1] = fmaf(w[r], x1, acc[r][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = col0 + 2 * threadIdx.x + j;
    if (d >= ddim) continue;
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < k) {
        const size_t o = ((size_t)img * k + r) * ddim + d;
        ctx[o] = from_float<T>(gate[o] * acc[r][j]);
      }
    }
  }
}

}  // namespace icd
