// Device code shared by K1 (fused_attention.cu) and K2 (fused_beam.cu).
//
// K1 launches each piece below as a kernel of its own; K2 runs the same
// pieces as phases of one persistent cooperative kernel, each block
// walking a share of the work items. So every piece takes its work item
// (a tile, an image and a chunk) as arguments instead of reading
// blockIdx, starts with __syncthreads() before it writes shared memory
// (the previous item or phase may still read it), and assumes
// kThreads threads per block.
//
// Buffers that K2 rewrites while it runs (h, att_dec, gate, scores, ctx)
// are read through plain pointers, never `const __restrict__`: that
// would allow the non-coherent read-only cache, which is not kept in step
// with writes made earlier in the same launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace icd {

constexpr int kThreads = 256;  // threads per block, every kernel
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

// ---------------------------------------------------------------------------
// Tiled product: out(m, n) = sum_k a(m, k) * b(n, k) over one 64 x 64 tile,
// 16-deep slices of k through shared memory, 4 x 4 outputs per thread, f32
// accumulation. a and b return the operands as float; store(m, n, sum) is
// called for each m < rows, n < cols of the tile.
constexpr int kTile = 64;
constexpr int kTileK = 16;
constexpr int kGemmSmemFloats = 2 * kTileK * (kTile + 1);

template <class LoadA, class LoadB, class Store>
__device__ void gemm_tile(int row0, int col0, int rows, int cols, int kdim,
                          LoadA a, LoadB b, Store store, float* smem) {
  float* as = smem;
  float* bs = smem + kTileK * (kTile + 1);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += kTileK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kTileK; i += kThreads) {
      const int m = i / kTileK, kk = i % kTileK, k = k0 + kk;
      const int r = row0 + m, n = col0 + m;
      as[kk * (kTile + 1) + m] = (k < kdim && r < rows) ? a(r, k) : 0.f;
      bs[kk * (kTile + 1) + m] = (k < kdim && n < cols) ? b(n, k) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = as[kk * (kTile + 1) + ty + 16 * i];
        y[i] = bs[kk * (kTile + 1) + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + tx + 16 * j;
      if (r < rows && n < cols) store(r, n, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. The products of h: att_dec = h Wd^T + bd and gate = sigmoid(h Wg^T +
// bg), as one (R, A + D) product with [Wd; Wg]. Both in f32.
template <typename T>
__device__ void decoder_products_tile(int row0, int col0, const T* h,
                                      const T* __restrict__ wd,
                                      const T* __restrict__ bd,
                                      const T* __restrict__ wg,
                                      const T* __restrict__ bg,
                                      float* att_dec, float* gate, int rows,
                                      int hdim, int adim, int ddim,
                                      float* smem) {
  gemm_tile(
      row0, col0, rows, adim + ddim, hdim,
      [=](int r, int k) { return to_float(h[(size_t)r * hdim + k]); },
      [=](int n, int k) {
        return n < adim ? to_float(wd[(size_t)n * hdim + k])
                        : to_float(wg[(size_t)(n - adim) * hdim + k]);
      },
      [=](int r, int n, float acc) {
        if (n < adim)
          att_dec[(size_t)r * adim + n] = acc + to_float(bd[n]);
        else
          gate[(size_t)r * ddim + (n - adim)] =
              sigmoid(acc + to_float(bg[n - adim]));
      },
      smem);
}

// ---------------------------------------------------------------------------
// 2. Scores of one image's k beams over a run of kPixelsPerChunk pixels:
// one warp per pixel, lanes across A, one accumulator per beam. The k
// att_dec rows sit in shared memory, so each att_enc row is read once for
// all k beams. Shared memory: (k + 1) * A floats.
constexpr int kPixelsPerChunk = 16;

template <typename T>
__device__ void attention_scores_chunk(int img, int chunk,
                                       const T* __restrict__ att_enc,
                                       const float* att_dec,
                                       const T* __restrict__ wf,
                                       const T* __restrict__ bf,
                                       float* scores, int k, int pix,
                                       int adim, float* smem) {
  float* dec = smem;             // (k, A) att_dec rows of this image
  float* wfs = smem + k * adim;  // (A,)
  __syncthreads();
  for (int i = threadIdx.x; i < k * adim; i += kThreads)
    dec[i] = att_dec[(size_t)img * k * adim + i];
  for (int i = threadIdx.x; i < adim; i += kThreads) wfs[i] = to_float(wf[i]);
  __syncthreads();

  const float bias = to_float(bf[0]);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p_end = min(pix, (chunk + 1) * kPixelsPerChunk);
  for (int p = chunk * kPixelsPerChunk + warp; p < p_end;
       p += kThreads / 32) {
    const T* e = att_enc + ((size_t)img * pix + p) * adim;
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
    for (int a = lane; a < adim; a += 32) {
      const float x = to_float(e[a]), w = wfs[a];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < k) acc[r] = fmaf(fmaxf(x + dec[r * adim + a], 0.f), w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < k) {  // k is the same for the whole warp
        const float s = warp_sum(acc[r]);
        if (lane == 0) scores[((size_t)img * k + r) * pix + p] = s + bias;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. Softmax over P, the context sum and the gate, for one image's k beams
// and the kThreads columns of D of chunk `chunk`: ctx = gate * sum_p alpha_p
// enc_p, rounded once to T. Chunk 0 also writes alpha (f32). Each chunk redoes
// the image's k softmaxes rather than wait for another block. Shared
// memory: k * P floats.
template <typename T>
__device__ void attention_context_chunk(int img, int chunk,
                                        const T* __restrict__ enc,
                                        const float* scores,
                                        const float* gate, T* ctx,
                                        float* alpha, int k, int pix,
                                        int ddim, float* smem) {
  float* weights = smem;  // (k, P) softmax of this image's rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (warp < k) {  // one warp per beam
    const size_t row = (size_t)img * k + warp;
    const float* s = scores + row * pix;
    float* w = weights + warp * pix;
    float m = -INFINITY;
    for (int p = lane; p < pix; p += 32) m = fmaxf(m, s[p]);
    m = warp_max(m);
    float sum = 0.f;
    for (int p = lane; p < pix; p += 32) {
      const float e = expf(s[p] - m);
      w[p] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int p = lane; p < pix; p += 32) {
      const float v = w[p] / sum;
      w[p] = v;
      if (chunk == 0) alpha[row * pix + p] = v;
    }
  }
  __syncthreads();

  const int d = chunk * kThreads + threadIdx.x;
  if (d >= ddim) return;
  const T* e = enc + (size_t)img * pix * ddim + d;
  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int p = 0; p < pix; ++p) {
    const float x = to_float(e[(size_t)p * ddim]);
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < k) acc[r] = fmaf(weights[r * pix + p], x, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < k) {
      const size_t o = ((size_t)img * k + r) * ddim + d;
      ctx[o] = from_float<T>(gate[o] * acc[r]);
    }
  }
}

}  // namespace icd
