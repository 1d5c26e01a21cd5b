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
// Design. Three launches on the caller's stream, nothing allocated here.
// Their device code is in attention_common.cuh, which K2 shares:
//  1. decoder_products: the two products of h, one tiled product of h
//     (R, H) with [Wd; Wg] (A + D, H)^T, bias added, sigmoid on the
//     gate columns; on the tensor cores in bf16 (mma.sync, cp.async),
//     an FMA tile in f32. Writes att_dec (R, A) and gate (R, D) in f32.
//  2. attention_scores: one block per (image, 16 pixels). The k att_dec
//     rows of the image sit in shared memory; each att_enc row is read
//     once, in 16-byte words, and scored for all k beams.
//  3. attention_context: one block per (image, 512 columns of D). Each
//     block takes the softmax of the image's k score rows into shared
//     memory while the first pixels of its enc columns stream into a
//     cp.async ring; each thread then sums its two columns over P once
//     for all k beams and applies the gate.
// The TPU kernel pads P to 128 and masks the pad with -inf; here every
// loop stops at the real P, so there is nothing to mask.

#include "attention_common.cuh"

namespace {

using namespace icd;

constexpr int kPixelsPerChunk = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decoder_products(const T* h, const T* wd, const T* bd, const T* wg,
                     const T* bg, float* att_dec, float* gate, int rows,
                     int hdim, int adim, int ddim) {
  extern __shared__ __align__(16) char smem[];
  decoder_products_tile<T>(blockIdx.y * HShape::BM, blockIdx.x * HShape::BN,
                           h, wd, bd, wg, bg, att_dec, gate, rows, hdim, adim,
                           ddim, smem);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_scores(const T* att_enc, const float* att_dec, const T* wf,
                     const T* bf, float* scores, int k, int pix, int adim) {
  extern __shared__ __align__(16) char smem[];
  const int p0 = blockIdx.x * kPixelsPerChunk;
  attention_scores_chunk<T>(blockIdx.y, p0, min(pix, p0 + kPixelsPerChunk),
                            att_enc, att_dec, wf, bf, scores, k, pix, adim,
                            reinterpret_cast<float*>(smem));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_context(const T* enc, const float* scores, const float* gate,
                      T* ctx, float* alpha, int k, int pix, int ddim) {
  extern __shared__ __align__(16) char smem[];
  attention_context_chunk<T>(blockIdx.y, blockIdx.x, enc, scores, gate, ctx,
                             alpha, k, pix, ddim, smem);
}

// Dynamic shared memory of `kernel`: above 48 KB only once allowed.
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
cudaError_t launch(const void* enc, const void* att_enc, const void* h,
                   const void* wd, const void* bd, const void* wf,
                   const void* bf, const void* wg, const void* bg,
                   float* att_dec, float* gate, float* scores, void* ctx,
                   float* alpha, int images, int k, int pix, int ddim,
                   int adim, int hdim, cudaStream_t stream) {
  const int rows = images * k;
  const dim3 pgrid((adim + ddim + HShape::BN - 1) / HShape::BN,
                   (rows + HShape::BM - 1) / HShape::BM);
  const size_t psmem = product_smem<T, HShape>();
  cudaError_t err = allow_smem(decoder_products<T>, psmem);
  if (err != cudaSuccess) return err;
  decoder_products<T><<<pgrid, kThreads, psmem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(wd),
      static_cast<const T*>(bd), static_cast<const T*>(wg),
      static_cast<const T*>(bg), att_dec, gate, rows, hdim, adim, ddim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 sgrid((pix + kPixelsPerChunk - 1) / kPixelsPerChunk, images);
  const size_t ssmem = (size_t)(k + 1) * adim * sizeof(float);
  err = allow_smem(attention_scores<T>, ssmem);
  if (err != cudaSuccess) return err;
  attention_scores<T><<<sgrid, kThreads, ssmem, stream>>>(
      static_cast<const T*>(att_enc), att_dec, static_cast<const T*>(wf),
      static_cast<const T*>(bf), scores, k, pix, adim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 cgrid((ddim + kCtxCols - 1) / kCtxCols, images);
  const size_t csmem = context_smem<T>(k, pix);
  err = allow_smem(attention_context<T>, csmem);
  if (err != cudaSuccess) return err;
  attention_context<T><<<cgrid, kThreads, csmem, stream>>>(
      static_cast<const T*>(enc), scores, gate, static_cast<T*>(ctx), alpha,
      k, pix, ddim);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the first error of the
// launches' set-up or cudaGetLastError() after them (0 on success).
// Scratch att_dec (R, A), gate (R, D) and scores (R, P) are f32 buffers
// the caller allocates, R = images * k.
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
