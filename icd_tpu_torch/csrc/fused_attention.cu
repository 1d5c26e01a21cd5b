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
// far below the tensor cores' line, so it is bound by bytes: the design
// aims to keep device memory streaming the grids from the first
// microsecond to the last.
//
// Why this design. The three launches it replaces (products of h, then
// scores, then softmax and context) took 20.5, 15.3 and 31.8 us at the
// serving shapes on the H100 (k1_bench), and enc only began to stream in
// the third, after the products and the scores. Here both grids stream
// from the start of the second of two launches:
//  1. k1_gate: gate = sigmoid(h Wg^T + bg) (R, D), f32, a tiled product
//     of all R rows (bf16 on the tensor cores, mma.sync fed by a 4-stage
//     cp.async ring; f32 an FMA tile) in 160 x 64 tiles, so Wg is read
//     from L2 twice and not once per image. The gate is the only result
//     that goes through device memory and is needed only at the very end,
//     so the attention launch is chained to this one by programmatic
//     dependent launch: its blocks start as soon as every gate block has
//     started, and wait for the gate (griddepcontrol.wait) only before
//     they apply it. The gate runs on kGateBlocks blocks that walk its
//     tiles (an SM that holds one keeps room for one attention block, an
//     SM without one holds three), so that every attention block starts
//     at once.
//  2. k1_attention: a cluster of kCluster = 4 blocks per image, P split
//     across them (flash-decoding), k a template parameter so that the
//     sums of the beams stay in registers (three blocks an SM up to five
//     beams). Thread 0 of each block keeps a ring of kStages 16 KB stages
//     in flight with the TMA (cp.async.bulk, completion on one mbarrier a
//     stage, each stage refilled as soon as the block is done with it):
//     first the block's att_enc rows, then its enc rows, each row read
//     once. The first stages fly while the block
//     - computes att_dec for a quarter of A's columns (bf16: mma.sync,
//       h's rows from shared memory, Wd's rows loaded as 16-byte words
//       straight from memory, four slices in flight, the depth order
//       permuted alike in both operands; f32: one warp per column) and
//       takes the other quarters from its cluster's blocks through
//       distributed shared memory. (Wd is read from L2 once per image:
//       32 MB at the serving shapes; the gate done the same way would
//       read 128 MB.)
//     Then, as the stages land, it scores its pixels for all k beams (a
//     warp two pixels at a time, so that each att_dec read serves two),
//     takes their softmax with its own max (no scores buffer in device
//     memory), and sums its pixels' enc rows over all D columns with those
//     unnormalised f32 weights (8 columns a thread, k beams at once). The
//     cluster then combines: each block reads the k maxes and sums of
//     every block, and for its quarter of D the k partial sums of every
//     block (distributed shared memory, ranks in a fixed order, no
//     atomics: two launches give the same bits) and scales them by
//     exp(m_block - m) / sum; it writes its pixels' alpha =
//     exp(s - m) / sum, and only then waits for the gate, applies it and
//     writes ctx.
// What bounds it (k1_phases, serving shapes, bf16, H100): the attention
// blocks' own time, about 55 us, and not device memory's rate. A block
// spends about 15 us on att_dec (its 128 KB of Wd come from L2), 10 on
// the scores and 14 on the context sums as the stages land, then 3 on
// the combine and 6 on the store; the grids stream only during the
// scores and the sums. The gate's tiles (two a block, about 22 us each
// beside the streams) end at about 45 us, just before the blocks store.
// Rows that are not whole 16-byte words are copied in whole words that
// cover them (the copy starts at the row's address rounded down to 16
// bytes; the memory allocator's granularity keeps it inside the
// allocation) and read a value at a time.
//
// Rounding. Scores, softmax and every sum are f32. The context is summed
// with f32 weights; the TPU kernel (icd_tpu/ops/fused_attention.py:62)
// and the plain version round alpha to bf16 before that product in bf16.
// ctx is rounded to T once, at the end.
//
// The clock. Thread 0 of each block reads %globaltimer (ns) at the
// block's start and end (k1_gate: 2 stamps a block) or at the start and
// after each phase (k1_attention: start, att_dec, scores, context,
// combine, store: 6 stamps a block), into one int64 buffer, gate blocks
// first.

#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace icd;

constexpr int kCluster = 4;         // blocks per image
constexpr int kStages = 3;          // depth of a block's ring
constexpr int kStageBytes = 16384;  // bytes a stage of the ring aims at
constexpr int kBatch = 4;           // 32-deep slices of Wd a lane loads at once
constexpr int kCols = 8;            // columns of D a thread sums
constexpr int kMaxD = kThreads * kCols;
constexpr int kGateStamps = 2, kStamps = 6;
// Blocks of the bf16 gate launch (f32 takes one a tile): an SM that
// holds one keeps room for one attention block instead of three, so they
// are few and walk several tiles each.
constexpr int kGateBlocks = 32;
constexpr int kStats = 4 * kMaxRows + kCluster * kMaxRows;  // floats
// Groups of 4 output columns a thread combines: a rank's share of D is
// at most kMaxD / kCluster columns, for each of up to kMaxRows beams.
constexpr int kGroups =
    (kMaxD / kCluster / 4 * kMaxRows + kThreads - 1) / kThreads;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory, H100
static_assert(kWarps == kMaxRows, "one warp per beam in the softmax");

// The gate's product tile in bf16 (f32 takes TileOf's 64-row FMA tile).
using GShape = Shape<160, 64, 2, 4>;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// ---------------------------------------------------------------------------
// mbarriers and bulk copies.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Bytes [src, src + n) of global memory into shared memory at dst, in
// whole 16-byte words: the copy starts at src rounded down to 16 bytes,
// so the bytes asked for start at dst + (src & 15). Completes on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          size_t n, uint64_t* bar,
                                          uint64_t policy) {
  const uintptr_t a = (uintptr_t)src & ~(uintptr_t)15;
  const unsigned bytes =
      (unsigned)((((uintptr_t)src + n + 15) & ~(uintptr_t)15) - a);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(a), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// Row stride of h's rows in shared memory, bf16 values: whole 16-byte
// words, and one more, so that the 8 rows an mma reads at once fall in 8
// different bank groups.
__host__ __device__ constexpr int h_stride(int hdim) {
  return round8(hdim) + 8;
}

// ---------------------------------------------------------------------------
// Shared memory of k1_attention, bytes from the start: one mbarrier per
// ring slot, statistics, the image's k rows of h (bf16, rows padded to
// whole 16-byte words), att_dec (k, A) and wf (A) in f32, the block's
// scores (k, npb), their softmax weights transposed (npb, kMaxRows), then
// the ring, whose room the partial sums (k, D) f32 take after the stream.
// The ring carries the block's att_enc rows, spa pixels a stage, then its
// enc rows, spe pixels a stage.
struct Layout {
  int npb;      // pixels a block takes at most
  int spa;      // att_enc pixels a stage holds
  int spe;      // enc pixels a stage holds
  size_t slot;  // bytes of a ring slot
  size_t hs, dec, wf, sc, wt, ring, total;
};

__host__ __device__ inline int pixels_per_stage(size_t row, int npb) {
  const size_t fit = kStageBytes / row;
  return fit < 1 ? 1 : (fit > (size_t)npb ? npb : (int)fit);
}

__host__ __device__ inline Layout layout(int k, int pix, int ddim, int adim,
                                         int hdim, int es) {
  Layout l;
  l.npb = (pix + kCluster - 1) / kCluster;
  const size_t row_e = (size_t)ddim * es, row_a = (size_t)adim * es;
  l.spa = pixels_per_stage(row_a, l.npb);
  l.spe = pixels_per_stage(row_e, l.npb);
  const size_t sa = round16(l.spa * row_a), se = round16(l.spe * row_e);
  l.slot = (sa > se ? sa : se) + 16;
  size_t o = round16(kStages * 8) + kStats * 4;
  l.hs = o;
  o += round16((size_t)k * h_stride(hdim) * 2);
  l.dec = o;
  o += round16((size_t)k * adim * 4);
  l.wf = o;
  o += round16((size_t)adim * 4);
  l.sc = o;
  o += round16((size_t)k * l.npb * 4);
  l.wt = o;
  o += (size_t)l.npb * kMaxRows * 4;
  l.ring = o;
  const size_t ring = kStages * l.slot, part = (size_t)k * ddim * 4;
  l.total = o + (ring > part ? ring : part);
  return l;
}

// Columns of A that cluster rank c computes: [c * per, min(A, ...)).
__host__ __device__ constexpr int dec_cols(int adim) {
  return ((adim + kCluster - 1) / kCluster + 7) / 8 * 8;
}

// ---------------------------------------------------------------------------
// 1. The gate.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    k1_gate(const T* h, const T* __restrict__ wg, const T* __restrict__ bg,
            float* gate, long long* clock, int rows, int hdim, int ddim) {
  extern __shared__ __align__(16) char smem[];
  using Tile = TileOf<T, GShape>;
  const long long t0 = global_ns();
  // The attention launch may start now: it waits for the gate itself.
  asm volatile("griddepcontrol.launch_dependents;");
  const int cols = (ddim + Tile::BN - 1) / Tile::BN;
  const int tiles = cols * ((rows + Tile::BM - 1) / Tile::BM);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile / cols * Tile::BM, col0 = tile % cols * Tile::BN;
    const float* acc = product_tile<T, GShape>(
        row0, col0, rows, ddim, hdim, round8(hdim), 0, 1,
        [=](int r, int k) { return to_float(h[(size_t)r * hdim + k]); },
        [=](int n, int k) { return to_float(wg[(size_t)n * hdim + k]); },
        [=](int r, int k) {
          return Run{(const __nv_bfloat16*)h + (size_t)r * hdim + k, hdim - k};
        },
        [=](int n, int k) {
          return Run{(const __nv_bfloat16*)wg + (size_t)n * hdim + k, hdim - k};
        },
        smem);
    // A thread's column is the same in every row of the tile: its bias
    // is read once, not once a row (a load in the loop would make each
    // row wait for memory before its store).
    static_assert(kThreads % Tile::BN == 0, "a thread's column");
    const int j = threadIdx.x % Tile::BN, n = col0 + j;
    const float bias = n < ddim ? to_float(bg[n]) : 0.f;
    for (int m = threadIdx.x / Tile::BN; m < Tile::BM;
         m += kThreads / Tile::BN) {
      const int r = row0 + m;
      if (r < rows && n < ddim)
        gate[(size_t)r * ddim + n] = sigmoid(acc[m * Tile::Acc + j] + bias);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long* c = clock + (size_t)kGateStamps * blockIdx.x;
    c[0] = t0;
    c[1] = global_ns();
  }
}

// ---------------------------------------------------------------------------
// 2. Scores, softmax and context: one cluster per image.

// 8 bf16 values of a row of n values from column kk (zero past n or for
// no row), as a 16-byte word; one load where vec (rows of whole words).
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row, int kk,
                                       int n, bool vec) {
  if (row == nullptr || kk >= n) return make_uint4(0, 0, 0, 0);
  if (vec) return *reinterpret_cast<const uint4*>(row + kk);
  const unsigned short* p = reinterpret_cast<const unsigned short*>(row);
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned lo = kk + 2 * i < n ? p[kk + 2 * i] : 0u;
    const unsigned hi = kk + 2 * i + 1 < n ? p[kk + 2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// att_dec = h Wd^T + bd for the image's k rows of h and columns [n0, n1)
// of A, into dec (k, A) f32. bf16: one warp per 8 columns on the tensor
// cores (mma m16n8k16, rows k..15 zero), h's rows from shared memory (hs,
// rows of hp values). Lane (g, t) loads 8 values of Wd's row n0 + g at
// depth k0 + 8t as one 16-byte word, kBatch slices at once so that their
// loads are in flight together, and the matching word of h's row g; the
// two mma steps of a 32-deep slice take the words' halves. That permutes
// the depth order within the slice, the same way in both operands, so
// the products are those of h Wd^T. f32: one warp per column, lanes
// across the depth, h from memory.
template <typename T>
__device__ void dec_columns(const T* h, const __nv_bfloat16* hs, int hp,
                            const T* wd, const T* bd, float* dec, int k,
                            int n0, int n1, int hdim, int adim) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (is_f32<T>()) {
    for (int n = n0 + warp; n < n1; n += kWarps) {
      float acc[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
      for (int kk = lane; kk < hdim; kk += 32) {
        const float w = wd[(size_t)n * hdim + kk];
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r)
          if (r < k) acc[r] = fmaf(h[(size_t)r * hdim + kk], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < k) {
          const float s = warp_sum(acc[r]);
          if (lane == 0) dec[r * adim + n] = s + bd[n];
        }
      }
    }
  } else {
    const int g = lane / 4, t = lane % 4;
    const bool vec = hdim % 8 == 0 && aligned16(wd);
    for (int nt = n0 + 8 * warp; nt < n1; nt += 8 * kWarps) {
      const __nv_bfloat16* wrow =
          nt + g < n1 ? wd + (size_t)(nt + g) * hdim : nullptr;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kb = 0; kb < hdim; kb += 32 * kBatch) {
        uint4 b[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          b[i] = load8(wrow, kb + 32 * i + 8 * t, hdim, vec);
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int kk = kb + 32 * i + 8 * t;
          const uint4 a = g < k && kk < hdim
                              ? *reinterpret_cast<const uint4*>(hs + g * hp + kk)
                              : make_uint4(0, 0, 0, 0);
          const unsigned a0[4] = {a.x, 0u, a.y, 0u};
          const unsigned a1[4] = {a.z, 0u, a.w, 0u};
          mma_bf16(d, a0, b[i].x, b[i].y);
          mma_bf16(d, a1, b[i].z, b[i].w);
        }
      }
      if (g < k) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = nt + 2 * t + e;
          if (n < n1) dec[g * adim + n] = d[e] + to_float(bd[n]);
        }
      }
    }
  }
}

// 4 values of T from shared memory at p (8- or 16-byte aligned), as floats.
template <typename T>
__device__ __forceinline__ void load4(const T* p, float* x) {
  if constexpr (is_f32<T>()) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  }
}

// Scores of two pixels of a stage (rows x0 and x1 of att_enc in shared
// memory; x1 null for none) for the k beams: lanes across A, 4 columns a
// lane a step where rows are made of whole 16-byte words (so that every
// shared-memory read of att_dec, wf and att_enc is conflict-free), a
// value at a time otherwise. Each att_dec row read serves both pixels.
template <typename T, int K>
__device__ __forceinline__ void score_pair(const T* x0, const T* x1,
                                           const float* dec, const float* wfs,
                                           int adim, bool vec,
                                           float (&acc)[2][K]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < K; ++r) acc[0][r] = acc[1][r] = 0.f;
  const T* y1 = x1 != nullptr ? x1 : x0;
  if (vec) {
#pragma unroll 2
    for (int a = 4 * lane; a < adim; a += 128) {
      float v0[4], v1[4], w[4];
      load4<T>(x0 + a, v0);
      load4<T>(y1 + a, v1);
      load_floats<4>(wfs + a, w);
#pragma unroll
      for (int r = 0; r < K; ++r) {
        float dv[4];
        load_floats<4>(dec + r * adim + a, dv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][r] = fmaf(fmaxf(v0[j] + dv[j], 0.f), w[j], acc[0][r]);
          acc[1][r] = fmaf(fmaxf(v1[j] + dv[j], 0.f), w[j], acc[1][r]);
        }
      }
    }
  } else {
    for (int a = lane; a < adim; a += 32) {
      const float v0 = to_float(x0[a]), v1 = to_float(y1[a]), w = wfs[a];
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const float dv = dec[r * adim + a];
        acc[0][r] = fmaf(fmaxf(v0 + dv, 0.f), w, acc[0][r]);
        acc[1][r] = fmaf(fmaxf(v1 + dv, 0.f), w, acc[1][r]);
      }
    }
  }
}

struct Args {
  const void* enc;      // (B, P, D)
  const void* att_enc;  // (B, P, A)
  const void* h;        // (B * k, H)
  const void* wd;       // (A, H)
  const void* bd;       // (A)
  const void* wf;       // (A)
  const void* bf;       // (1)
  const float* gate;    // (B * k, D), from k1_gate
  void* ctx;            // (B * k, D) out, T
  float* alpha;         // (B * k, P) out
  long long* clock;     // (B * kCluster, kStamps)
  int k, pix, ddim, adim, hdim;
};

// K = k, the beams of an image, so that the sums of the beams live in
// registers: three blocks an SM for up to 5 beams, two beyond.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, K <= 5 ? 3 : 2)
    k1_attention(const Args g) {
  extern __shared__ __align__(16) char smem[];
  constexpr int kVec = 16 / sizeof(T), kWords = kCols / kVec;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int img = blockIdx.x / kCluster;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k = K, pix = g.pix, ddim = g.ddim, adim = g.adim;
  const int hdim = g.hdim, hp = h_stride(hdim);
  const Layout lay = layout(k, pix, ddim, adim, hdim, sizeof(T));
  const int p0 = min(pix, rank * lay.npb);
  const int np = min(pix, p0 + lay.npb) - p0;  // this block's pixels
  const int nsa = (np + lay.spa - 1) / lay.spa;   // att_enc stages
  const int nst = nsa + (np + lay.spe - 1) / lay.spe;  // and enc stages
  const size_t row_e = (size_t)ddim * sizeof(T);
  const size_t row_a = (size_t)adim * sizeof(T);

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // one a ring slot
  float* stats = reinterpret_cast<float*>(smem + round16(kStages * 8));
  float* m_loc = stats;                 // (kMaxRows) this block's maxes
  float* l_loc = stats + kMaxRows;      // and sums of exp(s - max)
  float* gmax = stats + 2 * kMaxRows;   // the image's maxes
  float* gsum = stats + 3 * kMaxRows;   // and sums
  float* scale = stats + 4 * kMaxRows;  // (kCluster, kMaxRows)
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + lay.hs);
  float* dec = reinterpret_cast<float*>(smem + lay.dec);
  float* wfs = reinterpret_cast<float*>(smem + lay.wf);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* wt = reinterpret_cast<float*>(smem + lay.wt);
  char* ring = smem + lay.ring;
  float* part = reinterpret_cast<float*>(smem + lay.ring);
  long long* clock = g.clock + (size_t)blockIdx.x * kStamps;

  const char* enc_rows = static_cast<const char*>(g.enc) +
                         ((size_t)img * pix + p0) * row_e;
  const char* att_rows = static_cast<const char*>(g.att_enc) +
                         ((size_t)img * pix + p0) * row_a;
  // Stage st of the block's stream: (first pixel, pixels, source).
  auto stage = [&](int st, int& q0, int& nq) {
    if (st < nsa) {
      q0 = st * lay.spa;
      nq = min(np - q0, lay.spa);
      return att_rows + q0 * row_a;
    }
    q0 = (st - nsa) * lay.spe;
    nq = min(np - q0, lay.spe);
    return enc_rows + q0 * row_e;
  };
  auto issue = [&](int st) {
    int q0, nq;
    const char* src = stage(st, q0, nq);
    const int slot = st % kStages;
    bulk_load(ring + slot * lay.slot, src, nq * (st < nsa ? row_a : row_e),
              bars + slot, l2_evict_first());
  };

  if (tid == 0) {
    clock[0] = global_ns();
    for (int i = 0; i < kStages; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < min(nst, kStages); ++s) issue(s);

  // att_dec while the copies fly: this rank's columns, then the others'.
  const T* h = static_cast<const T*>(g.h) + (size_t)img * k * hdim;
  const T* wf = static_cast<const T*>(g.wf);
  for (int i = tid; i < adim; i += kThreads) wfs[i] = to_float(wf[i]);
  if constexpr (!is_f32<T>()) {
    const int hw = round8(hdim);  // values of a row, zero past hdim
    if (hdim == hw && aligned16(h)) {  // rows of whole 16-byte words
      for (int i = tid; i < k * hw / 8; i += kThreads) {
        const int r = i / (hw / 8), w = i % (hw / 8);
        reinterpret_cast<uint4*>(hs + r * hp)[w] =
            reinterpret_cast<const uint4*>(h + r * hdim)[w];
      }
    } else {
      for (int i = tid; i < k * hw; i += kThreads) {
        const int r = i / hw, c = i % hw;
        hs[r * hp + c] = c < hdim ? h[r * hdim + c] : from_float<T>(0.f);
      }
    }
    __syncthreads();
  }
  const int per = dec_cols(adim);
  dec_columns<T>(h, hs, hp, static_cast<const T*>(g.wd),
                 static_cast<const T*>(g.bd), dec, k, min(adim, rank * per),
                 min(adim, (rank + 1) * per), hdim, adim);
  cluster.sync();
  // (per is a multiple of 8, so where A is a multiple of 4 every share
  // is made of whole float4s.)
  const int vw = adim % 4 == 0 ? 4 : 1;
  for (int c = 0; c < kCluster; ++c) {
    const int m0 = min(adim, c * per), w = (min(adim, m0 + per) - m0) / vw;
    if (c == rank || w <= 0) continue;
    const float* src = cluster.map_shared_rank(dec, c);
#pragma unroll 4
    for (int i = tid; i < k * w; i += kThreads) {
      const int o = (i / w) * adim + m0 + (i % w) * vw;
      if (vw == 4)
        *reinterpret_cast<float4*>(dec + o) =
            *reinterpret_cast<const float4*>(src + o);
      else
        dec[o] = src[o];
    }
  }
  __syncthreads();
  if (tid == 0) clock[1] = global_ns();

  // Scores of the block's pixels as their att_enc stages land: each warp
  // two pixels at a time.
  const float bias = to_float(static_cast<const T*>(g.bf)[0]);
  const bool avec = row_a % 16 == 0 && aligned16(g.att_enc);
  int st = 0;
  for (; st < nsa; ++st) {
    const int slot = st % kStages;
    mbar_wait(bars + slot, (st / kStages) & 1);
    int q0, nq;
    const char* src = stage(st, q0, nq);
    const char* base = ring + slot * lay.slot + ((uintptr_t)src & 15);
    for (int q = 2 * warp; q < nq; q += 2 * kWarps) {
      const T* x0 = reinterpret_cast<const T*>(base + q * row_a);
      const T* x1 = q + 1 < nq ? x0 + adim : nullptr;
      float acc[2][K];
      score_pair<T, K>(x0, x1, dec, wfs, adim, avec, acc);
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const float s0 = warp_sum(acc[0][r]), s1 = warp_sum(acc[1][r]);
        if (lane == 0) {
          sc[r * lay.npb + q0 + q] = s0 + bias;
          if (x1 != nullptr) sc[r * lay.npb + q0 + q + 1] = s1 + bias;
        }
      }
    }
    __syncthreads();  // every thread is done with the slot: refill it
    if (tid == 0 && st + kStages < nst) issue(st + kStages);
  }
  // The block's softmax weights exp(s - its max), warp r for beam r
  // (zero for r >= k), transposed for the context sum.
  {
    const int r = warp;
    float m = -INFINITY, l = 0.f;
    if (r < k) {
      for (int pl = lane; pl < np; pl += 32)
        m = fmaxf(m, sc[r * lay.npb + pl]);
      m = warp_max(m);
    }
    for (int pl = lane; pl < np; pl += 32) {
      const float e = r < k ? expf(sc[r * lay.npb + pl] - m) : 0.f;
      wt[pl * kMaxRows + r] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_loc[r] = m;
      l_loc[r] = l;
    }
  }
  __syncthreads();
  if (tid == 0) clock[2] = global_ns();

  // The context sum over the block's pixels as their enc stages land:
  // thread t takes the kCols columns of its kWords 16-byte words t,
  // t + kThreads, ...
  float acc[K][kCols];
#pragma unroll
  for (int r = 0; r < K; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  const bool evec = row_e % 16 == 0 && aligned16(g.enc);
  for (; st < nst; ++st) {
    const int slot = st % kStages;
    mbar_wait(bars + slot, (st / kStages) & 1);
    int q0, nq;
    const char* src = stage(st, q0, nq);
    const char* base = ring + slot * lay.slot + ((uintptr_t)src & 15);
#pragma unroll 2
    for (int q = 0; q < nq; ++q) {
      float w[kMaxRows], xv[kCols];
      load_floats<kMaxRows>(wt + (q0 + q) * kMaxRows, w);
      const T* x = reinterpret_cast<const T*>(base + q * row_e);
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const int c0 = (tid + j * kThreads) * kVec;
        if (evec) {
          if (c0 < ddim) {
            unpack16<T>(*reinterpret_cast<const uint4*>(x + c0), xv + j * kVec);
          } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) xv[j * kVec + e] = 0.f;
          }
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            xv[j * kVec + e] = c0 + e < ddim ? to_float(x[c0 + e]) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < K; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[r][c] = fmaf(w[r], xv[c], acc[r][c]);
    }
    __syncthreads();  // every thread is done with the slot: refill it
    if (tid == 0 && st + kStages < nst) issue(st + kStages);
  }
  if (tid == 0) clock[3] = global_ns();

  // The partial sums into the ring's room (every read of the ring is
  // behind the last __syncthreads, and no copy is in flight), then the
  // cluster combines.
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int c = (tid + j * kThreads) * kVec + e;
      if (c < ddim) {
#pragma unroll
        for (int r = 0; r < K; ++r) part[r * ddim + c] = acc[r][j * kVec + e];
      }
    }
  }
  cluster.sync();  // every rank's partial sums and statistics
  if (tid == 0) clock[4] = global_ns();
  if (tid < k) {
    float ms[kCluster], mx = -INFINITY, sum = 0.f;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) {
      ms[c] = cluster.map_shared_rank(m_loc, c)[tid];
      mx = fmaxf(mx, ms[c]);
    }
#pragma unroll
    for (int c = 0; c < kCluster; ++c) {
      ms[c] = expf(ms[c] - mx);  // 0 for a block with no pixels
      sum += ms[c] * cluster.map_shared_rank(l_loc, c)[tid];
    }
    gmax[tid] = mx;
    gsum[tid] = sum;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) scale[c * kMaxRows + tid] = ms[c] / sum;
  }
  __syncthreads();
  for (int i = tid; i < k * np; i += kThreads) {
    const int r = i / np, pl = i % np;
    g.alpha[((size_t)img * k + r) * pix + p0 + pl] =
        expf(sc[r * lay.npb + pl] - gmax[r]) / gsum[r];
  }
  // This rank's share of D, in groups of 4 columns (read as float4s from
  // each rank where D is a multiple of 4): the sums first, held in
  // registers, then the gate, which may still be on its way.
  const float* parts[kCluster];
#pragma unroll
  for (int c = 0; c < kCluster; ++c)
    parts[c] = cluster.map_shared_rank(part, c);
  const int dc = ((ddim + kCluster - 1) / kCluster + 3) / 4 * 4;
  const int c0 = min(ddim, rank * dc), c1 = min(ddim, c0 + dc);
  const int groups = (c1 - c0 + 3) / 4;  // a beam's groups of 4 columns
  const bool cvec = ddim % 4 == 0;
  float v[kGroups][4];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int i = tid + j * kThreads;
#pragma unroll
    for (int e = 0; e < 4; ++e) v[j][e] = 0.f;
    if (i >= k * groups) continue;
    const int r = i / groups, col = c0 + (i % groups) * 4;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) {
      const float f = scale[c * kMaxRows + r];
      const float* src = parts[c] + r * ddim + col;
      if (cvec) {
        const float4 x = *reinterpret_cast<const float4*>(src);
        v[j][0] = fmaf(f, x.x, v[j][0]);
        v[j][1] = fmaf(f, x.y, v[j][1]);
        v[j][2] = fmaf(f, x.z, v[j][2]);
        v[j][3] = fmaf(f, x.w, v[j][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < c1) v[j][e] = fmaf(f, src[e], v[j][e]);
      }
    }
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the gate is in
  T* ctx = static_cast<T*>(g.ctx);
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int i = tid + j * kThreads;
    if (i >= k * groups) continue;
    const int r = i / groups, col = c0 + (i % groups) * 4;
    const size_t o = ((size_t)img * k + r) * ddim + col;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < c1) ctx[o + e] = from_float<T>(g.gate[o + e] * v[j][e]);
  }
  cluster.sync();  // no block leaves while another reads its memory
  if (tid == 0) clock[5] = global_ns();
}

// Dynamic shared memory of `kernel`: above 48 KB only once allowed; all
// of the SM's 228 KB kept as shared memory, so that a gate block and an
// attention block, or two attention blocks, share an SM.
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess || bytes <= 48 * 1024) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Blocks of k1_gate: at most kGateBlocks, each walking its tiles.
template <typename T>
int gate_blocks(int rows, int ddim) {
  using Tile = TileOf<T, GShape>;
  const int tiles = ((ddim + Tile::BN - 1) / Tile::BN) *
                    ((rows + Tile::BM - 1) / Tile::BM);
  return is_f32<T>() || tiles < kGateBlocks ? tiles : kGateBlocks;
}

template <typename T, int K>
cudaError_t launch(Args a, const void* wg, const void* bg, float* gate,
                   int images, cudaStream_t stream) {
  const int rows = images * a.k;
  const int gblocks = gate_blocks<T>(rows, a.ddim);
  const size_t gsmem = product_smem<T, GShape>();
  cudaError_t err = allow_smem(k1_gate<T>, gsmem);
  if (err != cudaSuccess) return err;
  k1_gate<T><<<gblocks, kThreads, gsmem, stream>>>(
      static_cast<const T*>(a.h), static_cast<const T*>(wg),
      static_cast<const T*>(bg), gate, a.clock, rows, a.hdim, a.ddim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  a.gate = gate;
  a.clock += (size_t)kGateStamps * gblocks;
  const size_t smem =
      layout(a.k, a.pix, a.ddim, a.adim, a.hdim, sizeof(T)).total;
  err = allow_smem(k1_attention<T, K>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = kCluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(images * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, k1_attention<T, K>, a);
}

template <typename T>
cudaError_t launch_k(Args a, const void* wg, const void* bg, float* gate,
                     int images, cudaStream_t s) {
  switch (a.k) {
    case 1: return launch<T, 1>(a, wg, bg, gate, images, s);
    case 2: return launch<T, 2>(a, wg, bg, gate, images, s);
    case 3: return launch<T, 3>(a, wg, bg, gate, images, s);
    case 4: return launch<T, 4>(a, wg, bg, gate, images, s);
    case 5: return launch<T, 5>(a, wg, bg, gate, images, s);
    case 6: return launch<T, 6>(a, wg, bg, gate, images, s);
    case 7: return launch<T, 7>(a, wg, bg, gate, images, s);
    case 8: return launch<T, 8>(a, wg, bg, gate, images, s);
  }
  return cudaErrorInvalidValue;
}

size_t attention_smem(int k, int pix, int ddim, int adim, int hdim,
                      int dtype) {
  return layout(k, pix, ddim, adim, hdim, dtype == 0 ? 4 : 2).total;
}

}  // namespace

// Sizes of a launch: out[0] shared memory of an attention block (bytes),
// out[1] gate blocks, out[2] attention blocks, out[3] and out[4] clock
// stamps a gate block and an attention block write. Returns 0, or
// cudaErrorInvalidValue for a dtype it does not know.
extern "C" int icd_fused_attention_sizes(int images, int k, int pix,
                                         int ddim, int adim, int hdim,
                                         int dtype, long long* out) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int gg = dtype == 0 ? gate_blocks<float>(images * k, ddim)
                            : gate_blocks<__nv_bfloat16>(images * k, ddim);
  out[0] = (long long)attention_smem(k, pix, ddim, adim, hdim, dtype);
  out[1] = gg;
  out[2] = (long long)images * kCluster;
  out[3] = kGateStamps;
  out[4] = kStamps;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. gate (R, D) f32 is scratch the
// caller allocates, R = images * k; clock holds the stamps that
// icd_fused_attention_sizes counts. Returns the first error of the
// launches' set-up or cudaGetLastError() after them (0 on success).
extern "C" int icd_fused_attention(
    const void* enc, const void* att_enc, const void* h, const void* wd,
    const void* bd, const void* wf, const void* bf, const void* wg,
    const void* bg, void* gate, void* ctx, void* alpha, void* clock,
    int images, int k, int pix, int ddim, int adim, int hdim, int dtype,
    void* stream) {
  if (k < 1 || k > kMaxRows || images < 1 || pix < 1 || ddim < 1 ||
      ddim > kMaxD || adim < 1 || hdim < 1 || (dtype != 0 && dtype != 1) ||
      attention_smem(k, pix, ddim, adim, hdim, dtype) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Args a{enc, att_enc, h, wd, bd, wf, bf, nullptr, ctx,
         static_cast<float*>(alpha), static_cast<long long*>(clock),
         k, pix, ddim, adim, hdim};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(gate);
  if (dtype == 0) return (int)launch_k<float>(a, wg, bg, g, images, s);
  return (int)launch_k<__nv_bfloat16>(a, wg, bg, g, images, s);
}
