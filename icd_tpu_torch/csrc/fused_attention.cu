// K1 on Hopper: one decode step of soft attention plus gate.
//
// Replaces the TPU kernel icd_tpu/ops/fused_attention.py:45 `_kernel`
// (launched by fused_attention_pallas, pallas_call at :103). For row r,
// whose image is r / k (k = rows per image, the beams of one image):
//
//   att_dec = h[r] . Wd^T + bd                       (A)
//   score_p = sum_a relu(att_enc[img, p, a] + att_dec[a]) * wf[a] + bf
//   alpha   = softmax_p(score)                       (P), f32
//   ctx[r]  = sigmoid(h[r] . Wg^T + bg) * sum_p alpha_p * enc[img, p]   (D)
//
// Weights come in nn.Linear layout: Wd (A, H), Wg (D, H). Inputs are f32
// or bf16, all of one type; every sum is taken in f32. ctx is returned in
// the input type and alpha in f32, as on the TPU.
//
// Bound. At the serving shapes (64 images x 5 beams, P = 196, D = 2048,
// A = H = 512, bf16) the function must read enc (51 MB) and att_enc
// (13 MB) once: about 20 us at 3.35 TB/s. Its arithmetic (1.2 GFLOP) is
// far below the tensor cores' line, so it is bound by bytes. Reading the
// grid once per beam instead of once per image would cost 5x.
//
// Design. Three launches on the caller's stream, nothing allocated here:
//  1. decoder_products: the two products of h, one tiled f32 product of
//     h (R, H) with [Wd; Wg] (A + D, H)^T, bias added, sigmoid on the
//     gate columns. Writes att_dec (R, A) and gate (R, D) in f32.
//  2. attention_scores: one block per (image, 16 pixels). The k att_dec
//     rows of the image sit in shared memory; each att_enc row is read
//     once and scored for all k beams.
//  3. attention_context: one block per (image, 256 columns of D). Each
//     block takes the softmax of the image's k score rows into shared
//     memory, then each thread streams one enc column over P once and
//     accumulates it for all k beams, and applies the gate.
// The TPU kernel pads P to 128 and masks the pad with -inf; here every
// loop stops at the real P, so there is nothing to mask.
// A simple, correct kernel: no tensor cores, TMA or cp.async yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxRows = 8;  // beams per image

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

// 1. att_dec = h Wd^T + bd and gate = sigmoid(h Wg^T + bg), as one
// (R, A + D) product: 64 x 64 output tiles, 16-deep slices of H through
// shared memory, 4 x 4 outputs per thread.
constexpr int kTile = 64;
constexpr int kTileK = 16;
constexpr int kProjThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kProjThreads)
    decoder_products(const T* __restrict__ h, const T* __restrict__ wd,
                     const T* __restrict__ bd, const T* __restrict__ wg,
                     const T* __restrict__ bg, float* __restrict__ att_dec,
                     float* __restrict__ gate, int rows, int hdim, int adim,
                     int ddim) {
  __shared__ float hs[kTileK][kTile + 1];
  __shared__ float ws[kTileK][kTile + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const int ncols = adim + ddim;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < hdim; k0 += kTileK) {
    for (int i = threadIdx.x; i < kTile * kTileK; i += kProjThreads) {
      const int m = i / kTileK, kk = i % kTileK, k = k0 + kk;
      const int r = row0 + m, n = col0 + m;
      float hv = 0.f, wv = 0.f;
      if (k < hdim) {
        if (r < rows) hv = to_float(h[(size_t)r * hdim + k]);
        if (n < adim)
          wv = to_float(wd[(size_t)n * hdim + k]);
        else if (n < ncols)
          wv = to_float(wg[(size_t)(n - adim) * hdim + k]);
      }
      hs[kk][m] = hv;
      ws[kk][m] = wv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = hs[kk][ty + 16 * i];
        b[i] = ws[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + tx + 16 * j;
      if (n < adim) {
        att_dec[(size_t)r * adim + n] = acc[i][j] + to_float(bd[n]);
      } else if (n < ncols) {
        const float z = acc[i][j] + to_float(bg[n - adim]);
        gate[(size_t)r * ddim + (n - adim)] = 1.f / (1.f + expf(-z));
      }
    }
  }
}

// 2. Scores of one image's k beams over a run of pixels: one warp per
// pixel, lanes across A, one accumulator per beam.
constexpr int kScoreThreads = 256;
constexpr int kPixelsPerBlock = 16;

template <typename T>
__global__ void __launch_bounds__(kScoreThreads)
    attention_scores(const T* __restrict__ att_enc,
                     const float* __restrict__ att_dec,
                     const T* __restrict__ wf, const T* __restrict__ bf,
                     float* __restrict__ scores, int k, int pix, int adim) {
  extern __shared__ float smem[];
  float* dec = smem;             // (k, A) att_dec rows of this image
  float* wfs = smem + k * adim;  // (A,)
  const int img = blockIdx.y;
  for (int i = threadIdx.x; i < k * adim; i += blockDim.x)
    dec[i] = att_dec[(size_t)img * k * adim + i];
  for (int i = threadIdx.x; i < adim; i += blockDim.x) wfs[i] = to_float(wf[i]);
  __syncthreads();

  const float bias = to_float(bf[0]);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int p_end = min(pix, (int)(blockIdx.x + 1) * kPixelsPerBlock);
  for (int p = blockIdx.x * kPixelsPerBlock + warp; p < p_end; p += nwarps) {
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

// 3. Softmax over P, the context sum and the gate, for one image's k
// beams and a run of kContextThreads columns of D.
constexpr int kContextThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kContextThreads)
    attention_context(const T* __restrict__ enc,
                      const float* __restrict__ scores,
                      const float* __restrict__ gate, T* __restrict__ ctx,
                      float* __restrict__ alpha, int k, int pix, int ddim) {
  extern __shared__ float weights[];  // (k, P) softmax of this image's rows
  const int img = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
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
      if (blockIdx.x == 0) alpha[row * pix + p] = v;
    }
  }
  __syncthreads();

  const int d = blockIdx.x * blockDim.x + threadIdx.x;
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

template <typename T>
cudaError_t launch(const void* enc, const void* att_enc, const void* h,
                   const void* wd, const void* bd, const void* wf,
                   const void* bf, const void* wg, const void* bg,
                   float* att_dec, float* gate, float* scores, void* ctx,
                   float* alpha, int images, int k, int pix, int ddim,
                   int adim, int hdim, cudaStream_t stream) {
  const int rows = images * k;
  const dim3 pgrid((adim + ddim + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  decoder_products<T><<<pgrid, kProjThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(wd),
      static_cast<const T*>(bd), static_cast<const T*>(wg),
      static_cast<const T*>(bg), att_dec, gate, rows, hdim, adim, ddim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 sgrid((pix + kPixelsPerBlock - 1) / kPixelsPerBlock, images);
  const size_t ssmem = (size_t)(k + 1) * adim * sizeof(float);
  attention_scores<T><<<sgrid, kScoreThreads, ssmem, stream>>>(
      static_cast<const T*>(att_enc), att_dec, static_cast<const T*>(wf),
      static_cast<const T*>(bf), scores, k, pix, adim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 cgrid((ddim + kContextThreads - 1) / kContextThreads, images);
  const size_t csmem = (size_t)k * pix * sizeof(float);
  attention_context<T><<<cgrid, kContextThreads, csmem, stream>>>(
      static_cast<const T*>(enc), scores, gate, static_cast<T*>(ctx), alpha,
      k, pix, ddim);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launches (0 on success). Scratch att_dec (R, A), gate (R, D) and
// scores (R, P) are f32 buffers the caller allocates, R = images * k.
extern "C" int icd_fused_attention(
    const void* enc, const void* att_enc, const void* h, const void* wd,
    const void* bd, const void* wf, const void* bf, const void* wg,
    const void* bg, void* att_dec, void* gate, void* scores, void* ctx,
    void* alpha, int images, int k, int pix, int ddim, int adim, int hdim,
    int dtype, void* stream) {
  if (k < 1 || k > kMaxRows || images < 1 || pix < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ad = static_cast<float*>(att_dec);
  float* g = static_cast<float*>(gate);
  float* sc = static_cast<float*>(scores);
  float* al = static_cast<float*>(alpha);
  if (dtype == 0)
    return (int)launch<float>(enc, att_enc, h, wd, bd, wf, bf, wg, bg, ad, g,
                              sc, ctx, al, images, k, pix, ddim, adim, hdim, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(enc, att_enc, h, wd, bd, wf, bf, wg, bg,
                                      ad, g, sc, ctx, al, images, k, pix, ddim,
                                      adim, hdim, s);
  return (int)cudaErrorInvalidValue;
}
