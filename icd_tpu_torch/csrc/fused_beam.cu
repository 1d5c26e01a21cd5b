// K2 on Hopper: a whole beam search in one launch.
//
// Replaces the TPU kernel icd_tpu/ops/fused_beam.py:99 `_kernel`
// (launched by beam_search_fused at :405, pallas_call at :467). Each of
// up to max_steps steps, for B images of k beams (R = B * k rows):
//
//   att_dec, gate = hc Wd^T + bd, sigmoid(hc Wg^T + bg)   hc = h in T, f32 out
//   alpha         = softmax_P(relu(att_enc + att_dec) wf + bf)          f32
//   x2            = (gate * sum_P alpha enc) in T
//   gates         = emb[word] Wi[:, :E]^T + x2 Wi[:, E:]^T + hc Wh^T + b_sum
//   c, h          = LSTM cell (i, f, g, o), f32
//   logits        = h_T Wfc^T + bfc, rounded to T (and so stored)
//   cand          = (logits - logsumexp) + cum, NEG_INF where the row is
//                   not live (step 1: row 0 only; then rows < k_active)
//   then the flat top-k of each image's k * V candidates in lax.top_k
//   order (value descending, flat index ascending), completion into the
//   running best (ties to the first maximum), survivor packing in top-k
//   rank order, and the permutation of h, c and the sequences.
// Outputs: the raw per-step alphas (S, B, k, P), parent pointers (S, B, k),
// best sequence (B, S), meta (B, 4) = best_len, best_step, best_parent,
// found, the number of steps run, and the phase clock (below). The
// winner's alpha trail is backtracked outside, as on the TPU
// (fused_beam.py:533-571). T is the grid's type (f32 or bf16); c, the
// scores and cum stay f32. Every use of h takes it rounded to T, so h is
// kept only so rounded (hc).
//
// Bound. At batch 64, k = 5, P = 196, D = 2048, A = H = E = 512,
// V = 10,000 in bf16, no chip memory holds enc and att_enc (51.4 + 12.8
// MB), so the least time reads them once a step; the weights (25.4 MB)
// could stay on chip and be read once a launch, and of the embedding only
// the rows gathered need be read (one a beam a step). About 64 MB a step at
// 3.35 TB/s against 8.5 GFLOP a step at the bf16 tensor-core peak: bound
// by bytes, about 20 us a step.
//
// Design. One persistent cooperative launch (cudaLaunchCooperativeKernel):
// two blocks on each SM, each walking a share of the work items of every
// phase, with grid.sync() between phases:
//   init  the state, from h0, c0 (one row per image) and the start token;
//   A     the products of h, one tiled product with [Wd; Wg];
//   B1    attention scores per (image, run of pixels), k beams per
//         att_enc read, one run per block;
//   B2    softmax, context and gate per (image, 512 columns of D), k beams
//         per enc read (A, B1 and B2 are K1's code, attention_common.cuh);
//   C     the LSTM gates' sums, one tiled product over [emb | x2 | hc] and
//         [Wi | Wh] in kCParts parts of its depth, the embedding read in
//         place by word id;
//   C2    the cell, adding the parts in order;
//   D     the fc product, logits rounded to T;
//   E     one block per image: log-softmax of its k rows (copied to
//         shared memory in one read where they fit), its top-k, the
//         running best, packing, and the permutation of its rows.
// In bf16 the products run on the tensor cores (mma.sync, cp.async ring;
// attention_common.cuh). What bounds them is what their tiles read from
// L2 (each row tile reads the weights, each column band the activations),
// so the large products take 160-row tiles: C's 2 x 32 tiles in 4 parts
// (256 work items for 264 blocks; the parts cost 10.5 MB of f32 sums a
// step, against about 100 MB of L2 reads saved). D takes 5 x 157 tiles
// of 64 x 64 (three even waves), A 5 x 80 of 64 x 32. Tiles of one column band go to neighbouring
// blocks, so a weight tile leaves memory once a step and the other row
// tiles find it in L2. B1 and B2 stream the grids in 16-byte words, many
// in flight a block.
// Before each step every block reads all k_active after the same barrier,
// so all blocks leave the loop at the same step. Each phase reads only
// buffers written before the last barrier, and in E each block touches
// only its own image's rows, reading h, c from hnew_c, c_new: no buffer
// is written while another block reads it.
//
// The phase clock. Block 0's thread 0 reads %globaltimer (ns; it ticks
// every 32 ns on the H100) at the start of the launch and after each grid
// barrier, into phase_ns (S, kPhases + 1): row 0 holds the start and the
// end of init, row s the start of step s and then the end of each phase.
//
// For diagnosis the workspace keeps what the last step run leaves there:
// its logits, each live row's log-sum-exp (phase E's one extra store), the
// running scores and words it chose, and the live beams
// (icd_fused_beam_views gives their offsets). A launch stopped after step
// s therefore shows step s's candidates, (logits - lse) + the running
// scores of a launch stopped after step s - 1, and its choice among them.

#include <cooperative_groups.h>
#include <limits.h>

#include <algorithm>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace icd;

constexpr float kNegInf = -1e9f;  // candidate mask, beam.py's NEG_INF
constexpr int kBlocksPerSm = 2;
constexpr int kPhases = 7;  // A, B1, B2, C, C2, D, E: grid barriers a step
// Shared memory a block may take with two blocks on an SM (228 KB an SM,
// 1 KB of it kept per block).
constexpr size_t kSmemBudget = 115712;
// Tiles of the LSTM gates (in kCParts parts of their depth, whose sums
// the cell adds) and of the fc product, in bf16; f32 takes 64-row FMA
// tiles of the same widths and one part.
using CShape = Shape<160, 64, 2, 2>;
using DShape = Shape<64, 64, 4, 5>;
constexpr int kCParts = 4;

template <typename T>
__host__ __device__ constexpr int c_parts() {
  return is_f32<T>() ? 1 : kCParts;
}

// The card's nanosecond clock, the same on every SM.
__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

struct Params {
  // Inputs, in T unless noted; weights in nn.Linear layout (out, in).
  const void* enc;      // (B, P, D)
  const void* att_enc;  // (B, P, A)
  const void* h0;       // (B, H)
  const void* c0;       // (B, H)
  const void* emb;      // (V, E)
  const void* wd;       // (A, H)
  const void* bd;       // (A)
  const void* wf;       // (A)
  const void* bf;       // (1)
  const void* wg;       // (D, H)
  const void* bg;       // (D)
  const void* wi;       // (4H, E + D)
  const void* wh;       // (4H, H)
  const float* b_sum;   // (4H) f32, bias_ih + bias_hh
  const void* wfc;      // (V, H)
  const void* bfc;      // (V)
  // Outputs.
  float* alpha;    // (S, B, k, P)
  int* parent;     // (S, B, k)
  int* best_seq;   // (B, S)
  int* meta;       // (B, 4)
  int* steps;      // (1)
  long long* phase_ns;  // (S, kPhases + 1) the phase clock
  // Scratch, carved from the caller's workspace.
  float* c;        // (R, H) state
  float* c_new;    // (R, H) this step's cell output, before packing
  float* att_dec;  // (R, A)
  float* gate;     // (R, D)
  float* scores;   // (R, P)
  float* gates;    // (parts, R, 4H) the LSTM gates' sums, part by part
  float* cum;      // (R) running scores
  float* best_score;  // (B)
  void* logits;    // (R, V) T
  void* hc;        // (R, H) T, h rounded: every product's only use of h
  void* hnew_c;    // (R, H) T, this step's h rounded, before packing
  void* x2;        // (R, D) T, gated context
  int* words;      // (R) last word of each row
  int* seqs;       // (R, S)
  int* kact;       // (B) live beams of each image
  float* lse;      // (R) each live row's log-sum-exp at the last step run
  int images, k, pix, ddim, adim, hdim, edim, vocab, max_steps;
  int start_id, end_id;
  int stage_logits;  // E copies its image's logits to shared memory
};

// Lays the scratch buffers out from address `base`, each aligned to 256
// bytes; returns the bytes used. With base 0 the pointers set are the
// buffers' byte offsets.
size_t carve(Params& p, uintptr_t base, size_t elt, int parts) {
  size_t off = 0;
  auto take = [&](size_t bytes) -> char* {
    off = (off + 255) & ~size_t(255);
    char* at = reinterpret_cast<char*>(base + off);
    off += bytes;
    return at;
  };
  const size_t r = (size_t)p.images * p.k, h = p.hdim, f = sizeof(float);
  const size_t s = (size_t)p.max_steps + 1;
  p.c = (float*)take(r * h * f);
  p.c_new = (float*)take(r * h * f);
  p.att_dec = (float*)take(r * p.adim * f);
  p.gate = (float*)take(r * p.ddim * f);
  p.scores = (float*)take(r * p.pix * f);
  p.gates = (float*)take(parts * r * 4 * h * f);
  p.cum = (float*)take(r * f);
  p.best_score = (float*)take(p.images * f);
  p.logits = take(r * p.vocab * elt);
  p.hc = take(r * h * elt);
  p.hnew_c = take(r * h * elt);
  p.x2 = take(r * p.ddim * elt);
  p.words = (int*)take(r * sizeof(int));
  p.seqs = (int*)take(r * s * sizeof(int));
  p.kact = (int*)take(p.images * sizeof(int));
  p.lse = (float*)take(r * f);
  return off;
}

struct SelectShared {
  float own[kMaxRows][kThreads];  // each thread's largest logit of a row
  float lse[kMaxRows], cum[kMaxRows], top_v[kMaxRows];
  int top_i[kMaxRows], ord_prev[kMaxRows], ord_word[kMaxRows];
  float red[kWarps][kMaxRows];
  float warp_best[kWarps];
  float red_v[kWarps];
  int red_i[kWarps];
  int improved, best_parent, best_word;
  // followed by the image's k sequences, (k, S) ints
};

// Where the LSTM-gates tile keeps its word ids: past its ring.
template <typename T>
__host__ __device__ constexpr size_t c_words_at() {
  return product_smem<T, CShape>();
}

// Shared memory of phase E: SelectShared, the image's k sequences, and
// with `logits` its k rows of logits.
__host__ __device__ size_t select_smem(const Params& p, size_t elt,
                                      bool logits) {
  const size_t head =
      (sizeof(SelectShared) + (size_t)p.k * (p.max_steps + 1) * 4 + 15) / 16 *
      16;
  return head + (logits ? (size_t)p.k * p.vocab * elt : 0);
}

// Shared memory of the launch (the most any phase takes); sets
// p.stage_logits where E's logits fit in the two-blocks-an-SM budget.
template <typename T>
size_t smem_bytes(Params& p) {
  p.stage_logits = select_smem(p, sizeof(T), true) <= kSmemBudget;
  return std::max({product_smem<T, HShape>(),
                   c_words_at<T>() + TileOf<T, CShape>::BM * sizeof(int),
                   product_smem<T, DShape>(),
                   (size_t)(p.k + 1) * p.adim * sizeof(float),
                   context_smem<T>(p.k, p.pix),
                   select_smem(p, sizeof(T), p.stage_logits)});
}

// lax.top_k's order: value descending, then index ascending.
__device__ __forceinline__ bool ranks_before(float av, int ai, float bv,
                                             int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Runs f(row0, col0, part) for this block's share of the bm x bn tiles
// of a (rows, cols) product, each in `parts` parts of its depth; tiles of
// one column band and part go to neighbouring blocks, so a weight tile
// is read from memory once and from L2 after.
template <class F>
__device__ void for_tiles(int rows, int cols, int bm, int bn, int parts,
                          F f) {
  const int rt = (rows + bm - 1) / bm, bands = (cols + bn - 1) / bn;
  for (int t = blockIdx.x; t < rt * bands * parts; t += gridDim.x) {
    const int band = t / rt % bands;
    f((t % rt) * bm, band * bn, t / rt / bands);
  }
}

// f(v, x) for this thread's share of the n values x[v] of a row, in
// order: 16 bytes at a time where `vec` (the row is made of whole 16-byte
// words), else one value at a time.
template <typename T, class F>
__device__ __forceinline__ void row_values(const T* x, int n, bool vec, F f) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    for (int v0 = threadIdx.x * kVec; v0 < n; v0 += kThreads * kVec) {
      float xs[kVec];
      unpack16<T>(*reinterpret_cast<const uint4*>(x + v0), xs);
#pragma unroll
      for (int e = 0; e < kVec; ++e) f(v0 + e, xs[e]);
    }
  } else {
    for (int v = threadIdx.x; v < n; v += kThreads) f(v, to_float(x[v]));
  }
}

// Keeps (val, idx), sorted in lax.top_k's order, the best kMaxRows of
// the candidates offered; constant indices keep the lists in registers.
__device__ __forceinline__ void keep_best(float (&val)[kMaxRows],
                                          int (&idx)[kMaxRows], float cand,
                                          int f) {
  if (!ranks_before(cand, f, val[kMaxRows - 1], idx[kMaxRows - 1])) return;
  val[kMaxRows - 1] = cand;
  idx[kMaxRows - 1] = f;
#pragma unroll
  for (int i = kMaxRows - 1; i > 0; --i) {
    if (ranks_before(val[i], idx[i], val[i - 1], idx[i - 1])) {
      const float tv = val[i];
      val[i] = val[i - 1];
      val[i - 1] = tv;
      const int ti = idx[i];
      idx[i] = idx[i - 1];
      idx[i - 1] = ti;
    }
  }
}

// Phase E for one image (fused_beam.py:236-384).
template <typename T>
__device__ void select_image(int img, int step, const Params& p,
                             char* smem) {
  constexpr int kVec = 16 / sizeof(T);
  SelectShared& sh = *reinterpret_cast<SelectShared*>(smem);
  int* old_seqs = reinterpret_cast<int*>(&sh + 1);
  const int k = p.k, v_n = p.vocab, h_n = p.hdim, s_n = p.max_steps + 1;
  const int row0 = img * k;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* logits = static_cast<const T*>(p.logits) + (size_t)row0 * v_n;
  __syncthreads();
  const int active = p.kact[img];  // read by all before thread 0 rewrites it
  // Rows j < live are live: step 1 row 0, then the active ones.
  const int live = step == 1 ? 1 : active;
  // What later parts read, loaded now so that the loads overlap.
  const float best_before = threadIdx.x == 0 ? p.best_score[img] : 0.f;
  if (threadIdx.x < k) sh.cum[threadIdx.x] = p.cum[row0 + threadIdx.x];
  for (int i = threadIdx.x; i < k * s_n; i += kThreads)
    old_seqs[i] = p.seqs[(size_t)row0 * s_n + i];
  if (p.stage_logits) {  // the live rows, one read, all in flight
    T* staged = reinterpret_cast<T*>(smem + select_smem(p, 0, false));
    const uint64_t policy = l2_evict_first();
    for (int i = threadIdx.x * kVec; i < live * v_n; i += kThreads * kVec)
      stage16(staged + i, logits + i, live * v_n - i, policy);
    cp_async_commit();  // wait_group waits only for committed copies
    cp_async_wait<0>();
    __syncthreads();
    logits = staged;
  }
  const bool vec = v_n % kVec == 0 && aligned16(logits);

  // Log-softmax terms of the live rows, a row at a time (rolled loops:
  // less code to fetch each step): block-wide max, then sum, each warp's
  // share summed by warp_sum and the warps' in order.
  for (int j = 0; j < live; ++j) {
    float mj = -INFINITY;
    row_values(logits + (size_t)j * v_n, v_n, vec,
               [&](int, float x) { mj = fmaxf(mj, x); });
    sh.own[j][threadIdx.x] = mj;
    mj = warp_max(mj);
    if (lane == 0) sh.red[warp][j] = mj;
  }
  __syncthreads();
  if (threadIdx.x < live) {
    float mj = sh.red[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) mj = fmaxf(mj, sh.red[w][threadIdx.x]);
    sh.lse[threadIdx.x] = mj;  // the max, for now
  }
  __syncthreads();
  for (int j = 0; j < live; ++j) {
    float sj = 0.f;
    const float mj = sh.lse[j];
    row_values(logits + (size_t)j * v_n, v_n, vec,
               [&](int, float x) { sj += expf(x - mj); });
    sj = warp_sum(sj);
    if (lane == 0) sh.red[warp][j] = sj;
  }
  __syncthreads();
  if (threadIdx.x < live) {
    float sj = sh.red[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) sj += sh.red[w][threadIdx.x];
    const float lse = sh.lse[threadIdx.x] + logf(sj);
    sh.lse[threadIdx.x] = lse;
    p.lse[row0 + threadIdx.x] = lse;  // kept for diagnosis only
  }
  __syncthreads();

  // A cutoff under the k best candidates: a candidate is monotone in its
  // logit within a row, so each thread's best is (own max - lse) + cum
  // of one of its rows; the k-th largest of the warps' bests belongs to k
  // distinct candidates, so no candidate below it can be among the k
  // best. Only candidates at or above it enter a thread's list, which
  // keeps the lists' inserts (and the warps' divergence) rare.
  float best = -INFINITY;
  for (int j = 0; j < live; ++j)
    best = fmaxf(best, (sh.own[j][threadIdx.x] - sh.lse[j]) + sh.cum[j]);
  best = warp_max(best);
  if (lane == 0) sh.warp_best[warp] = best;
  __syncthreads();
  float cutoff = -INFINITY;
  for (int i = 0; i < kWarps; ++i) {
    int above = 0;
    for (int w = 0; w < kWarps; ++w)
      above += sh.warp_best[w] >= sh.warp_best[i];
    if (above >= k) cutoff = fmaxf(cutoff, sh.warp_best[i]);
  }

  // Each thread keeps the best kMaxRows of the candidates it scans. A row
  // that is not live offers NEG_INF everywhere, so only its k lowest
  // indices can be chosen (NEG_INF ties go to the lower index, and the
  // live rows' candidates, running scores, lie far above NEG_INF): thread
  // 0 offers those k, and no one reads the row.
  float val[kMaxRows];
  int idx[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    val[i] = -INFINITY;  // below every candidate, NEG_INF included
    idx[i] = INT_MAX;
  }
  for (int j = 0; j < k; ++j) {
    if (j < live) {
      const float lse = sh.lse[j], cum = sh.cum[j];
      row_values(logits + (size_t)j * v_n, v_n, vec, [&](int v, float x) {
        const float cand = (x - lse) + cum;
        if (cand >= cutoff) keep_best(val, idx, cand, j * v_n + v);
      });
    } else if (threadIdx.x == 0) {
      for (int v = 0; v < k; ++v) keep_best(val, idx, kNegInf, j * v_n + v);
    }
  }

  // Merge: k rounds of a block-wide best over the threads' list heads.
  // Flat indices are unique, so the round's winner is the one thread
  // whose head has the winning index.
  for (int round = 0; round < k; ++round) {
    float bv = val[0];
    int bi = idx[0];
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ranks_before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      sh.red_v[warp] = bv;
      sh.red_i[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        if (ranks_before(sh.red_v[w], sh.red_i[w], bv, bi)) {
          bv = sh.red_v[w];
          bi = sh.red_i[w];
        }
      }
      sh.top_v[round] = bv;
      sh.top_i[round] = bi;
    }
    __syncthreads();
    if (idx[0] == sh.top_i[round]) {
#pragma unroll
      for (int i = 0; i < kMaxRows - 1; ++i) {
        val[i] = val[i + 1];
        idx[i] = idx[i + 1];
      }
      val[kMaxRows - 1] = -INFINITY;
      idx[kMaxRows - 1] = INT_MAX;
    }
  }

  // Completion, running best and packing: warp 0, lane j the j-th of the
  // k chosen (in registers; a per-thread array here would live in local
  // memory, which the large shared-memory carve-out leaves uncached).
  if (warp == 0) {
    const bool mine = lane < k;
    const int top = mine ? sh.top_i[lane] : 0;
    const int prev = top / v_n, word = top - prev * v_n;
    const bool valid = lane < active;  // active == k at step 1
    const bool fin = valid && word == p.end_id;
    const float score = valid ? sh.top_v[lane] : kNegInf;
    const bool surv = valid && !fin;
    const bool any_fin = __any_sync(0xffffffffu, fin);
    // The first maximum of the completions: value descending, lane ascending.
    float cv = !mine ? -INFINITY : fin ? score : kNegInf;
    int cl = lane;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, cv, o);
      const int ol = __shfl_xor_sync(0xffffffffu, cl, o);
      if (ov > cv || (ov == cv && ol < cl)) {
        cv = ov;
        cl = ol;
      }
    }
    const int best_prev = __shfl_sync(0xffffffffu, prev, cl);
    const int best_word = __shfl_sync(0xffffffffu, word, cl);
    // Survivors first, then the rest, each in top-k rank order.
    const unsigned below = (1u << lane) - 1u;
    const unsigned survivors = __ballot_sync(0xffffffffu, mine && surv);
    const unsigned others = __ballot_sync(0xffffffffu, mine && !surv);
    const int n = __popc(survivors);
    if (lane == 0) {
      const bool improved = any_fin && cv > best_before;
      int* meta = p.meta + (size_t)img * 4;
      if (improved) {
        p.best_score[img] = cv;
        meta[0] = step + 1;
        meta[1] = step;
        meta[2] = best_prev;
      }
      if (any_fin) meta[3] = 1;
      sh.improved = improved;
      sh.best_parent = best_prev;
      sh.best_word = best_word;
      p.kact[img] = n;
    }
    if (mine) {
      const int at = surv ? __popc(survivors & below)
                          : n + __popc(others & below);
      sh.ord_prev[at] = prev;
      sh.ord_word[at] = word;
      p.parent[((size_t)step * p.images + img) * k + at] = prev;
      p.words[row0 + at] = word;
      p.cum[row0 + at] = score;
    }
  }
  __syncthreads();

  if (sh.improved) {
    for (int s = threadIdx.x; s < s_n; s += kThreads)
      p.best_seq[(size_t)img * s_n + s] =
          s == step ? sh.best_word : old_seqs[sh.best_parent * s_n + s];
  }
  for (int i = threadIdx.x; i < k * s_n; i += kThreads) {
    const int j = i / s_n, s = i - j * s_n;
    p.seqs[(size_t)row0 * s_n + i] =
        s == step ? sh.ord_word[j] : old_seqs[sh.ord_prev[j] * s_n + s];
  }
  T* hc = static_cast<T*>(p.hc);
  const T* hn = static_cast<const T*>(p.hnew_c);
  for (int i = threadIdx.x; i < k * h_n; i += kThreads) {
    const int j = i / h_n, u = i - j * h_n;
    const size_t src = (size_t)(row0 + sh.ord_prev[j]) * h_n + u;
    const size_t dst = (size_t)(row0 + j) * h_n + u;
    p.c[dst] = p.c_new[src];
    hc[dst] = hn[src];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    fused_beam(Params p) {
  extern __shared__ __align__(16) char smem[];
  cg::grid_group grid = cg::this_grid();
  const int b_n = p.images, k = p.k, r_n = b_n * k, h_n = p.hdim;
  const int s_n = p.max_steps + 1, a_n = p.adim, d_n = p.ddim;
  const int e_n = p.edim, v_n = p.vocab, p_n = p.pix;
  const size_t gtid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t gsize = (size_t)gridDim.x * kThreads;
  const T* enc = static_cast<const T*>(p.enc);
  const T* att_enc = static_cast<const T*>(p.att_enc);
  const T* h0 = static_cast<const T*>(p.h0);
  const T* c0 = static_cast<const T*>(p.c0);
  const T* emb = static_cast<const T*>(p.emb);
  const T* wd = static_cast<const T*>(p.wd);
  const T* bd = static_cast<const T*>(p.bd);
  const T* wf = static_cast<const T*>(p.wf);
  const T* bf = static_cast<const T*>(p.bf);
  const T* wg = static_cast<const T*>(p.wg);
  const T* bg = static_cast<const T*>(p.bg);
  const T* wi = static_cast<const T*>(p.wi);
  const T* wh = static_cast<const T*>(p.wh);
  const T* wfc = static_cast<const T*>(p.wfc);
  const T* bfc = static_cast<const T*>(p.bfc);
  const float* b_sum = p.b_sum;
  T* hc = static_cast<T*>(p.hc);
  T* hnew_c = static_cast<T*>(p.hnew_c);
  T* x2 = static_cast<T*>(p.x2);
  T* logits = static_cast<T*>(p.logits);
  float* c_new = p.c_new;
  float* c = p.c;
  const int* words = p.words;
  // The operands as bf16, for the tensor-core tiles' runs (unused in f32).
  auto b16 = [](const void* q) {
    return static_cast<const __nv_bfloat16*>(q);
  };
  auto stamp = [&](int row, int col) {
    if (blockIdx.x == 0 && threadIdx.x == 0)
      p.phase_ns[row * (kPhases + 1) + col] = global_ns();
  };
  stamp(0, 0);

  // init (fused_beam.py:141-158)
  for (size_t i = gtid; i < (size_t)r_n * h_n; i += gsize) {
    const size_t src = i / h_n / k * h_n + i % h_n;  // row i / H, image row / k
    c[i] = to_float(c0[src]);
    hc[i] = h0[src];
  }
  for (size_t i = gtid; i < (size_t)r_n * s_n; i += gsize)
    p.seqs[i] = i % s_n == 0 ? p.start_id : p.end_id;
  for (size_t i = gtid; i < (size_t)b_n * s_n; i += gsize)
    p.best_seq[i] = i % s_n == 0 ? p.start_id : p.end_id;
  for (size_t i = gtid; i < (size_t)r_n; i += gsize) {
    p.words[i] = p.start_id;
    p.cum[i] = 0.f;
    p.parent[i] = 0;  // row 0 of the history: no step 0 was run
  }
  for (size_t i = gtid; i < (size_t)r_n * p_n; i += gsize) p.alpha[i] = 0.f;
  for (size_t i = gtid; i < (size_t)b_n; i += gsize) {
    p.kact[i] = k;
    p.best_score[i] = kNegInf;
    int* meta = p.meta + i * 4;
    meta[0] = 2;  // best_len
    meta[1] = 1;  // best_step
    meta[2] = 0;  // best_parent
    meta[3] = 0;  // found
  }
  grid.sync();
  stamp(0, 1);

  // B1's work items: each image's pixels in as many runs as there are
  // blocks per image (at least one).
  const int runs = max(1, (int)gridDim.x / b_n);
  const int run_len = (p_n + runs - 1) / runs;
  const int pruns = (p_n + run_len - 1) / run_len;
  const int ed = e_n + d_n, g_n = 4 * h_n;
  // [emb | x2 | hc] and [Wi | Wh] with each segment padded to whole runs
  // of 8 (the tensor-core tiles' depth; zeros in the padding).
  const int e8 = round8(e_n), d8 = round8(d_n);
  const int cpad = e8 + d8 + round8(h_n);
  const int spread = max(1, (int)gridDim.x / (kBlocksPerSm * b_n));
  using CTile = TileOf<T, CShape>;
  using DTile = TileOf<T, DShape>;
  constexpr int parts = c_parts<T>();

  int step = 1;
  for (; step <= p.max_steps; ++step) {
    int live = 0;
    for (int i = threadIdx.x; i < b_n; i += kThreads) live |= p.kact[i] > 0;
    if (!__syncthreads_or(live)) break;  // the same answer in every block
    stamp(step, 0);

    // A: att_dec and gate.
    for_tiles(r_n, a_n + d_n, HShape::BM, HShape::BN, 1,
              [&](int row0, int col0, int) {
                decoder_products_tile<T>(row0, col0, hc, wd, bd, wg, bg,
                                         p.att_dec, p.gate, r_n, h_n, a_n,
                                         d_n, smem);
              });
    grid.sync();
    stamp(step, 1);

    // B1: scores.
    for (int it = blockIdx.x; it < b_n * pruns; it += gridDim.x) {
      const int p0 = (it % pruns) * run_len;
      attention_scores_chunk<T>(it / pruns, p0, min(p_n, p0 + run_len),
                                att_enc, p.att_dec, wf, bf, p.scores, k, p_n,
                                a_n, reinterpret_cast<float*>(smem));
    }
    grid.sync();
    stamp(step, 2);

    // B2: softmax, context, gate; the step's raw alphas.
    const int dchunks = (d_n + kCtxCols - 1) / kCtxCols;
    float* alpha = p.alpha + (size_t)step * r_n * p_n;
    for (int it = blockIdx.x; it < b_n * dchunks; it += gridDim.x)
      attention_context_chunk<T>(it / dchunks, it % dchunks, enc, p.scores,
                                 p.gate, x2, alpha, k, p_n, d_n, smem);
    grid.sync();
    stamp(step, 3);

    // C: the LSTM gates' sums over [emb | x2 | hc] (E + D + H deep), part
    // by part of the depth.
    for_tiles(r_n, g_n, CTile::BM, CTile::BN, parts,
              [&](int row0, int col0, int part) {
      // The tile's word ids, loaded once (product_tile's first barrier
      // publishes them), for the runs of its embedding rows.
      int* tile_words = reinterpret_cast<int*>(smem + c_words_at<T>());
      for (int i = threadIdx.x; i < CTile::BM; i += kThreads)
        tile_words[i] = row0 + i < r_n ? words[row0 + i] : 0;
      const float* acc = product_tile<T, CShape>(
          row0, col0, r_n, g_n, ed + h_n, cpad, part, parts,
          [=](int r, int kk) {
            if (kk < e_n) return to_float(emb[(size_t)words[r] * e_n + kk]);
            if (kk < ed) return to_float(x2[(size_t)r * d_n + kk - e_n]);
            return to_float(hc[(size_t)r * h_n + kk - ed]);
          },
          [=](int n, int kk) {
            return kk < ed ? to_float(wi[(size_t)n * ed + kk])
                           : to_float(wh[(size_t)n * h_n + kk - ed]);
          },
          [=](int r, int kk) {
            if (kk < e8)
              return Run{b16(emb) + (size_t)tile_words[r - row0] * e_n + kk,
                         e_n - kk};
            kk -= e8;
            if (kk < d8) return Run{b16(x2) + (size_t)r * d_n + kk, d_n - kk};
            kk -= d8;
            return Run{b16(hc) + (size_t)r * h_n + kk, h_n - kk};
          },
          [=](int n, int kk) {
            if (kk < e8) return Run{b16(wi) + (size_t)n * ed + kk, e_n - kk};
            kk -= e8;
            if (kk < d8)
              return Run{b16(wi) + (size_t)n * ed + e_n + kk, d_n - kk};
            kk -= d8;
            return Run{b16(wh) + (size_t)n * h_n + kk, h_n - kk};
          },
          smem);
      float* out = p.gates + (size_t)part * r_n * g_n;
      for (int i = threadIdx.x; i < CTile::BM * CTile::BN; i += kThreads) {
        const int m = i / CTile::BN, j = i % CTile::BN;
        const int r = row0 + m, n = col0 + j;
        if (r < r_n && n < g_n)
          out[(size_t)r * g_n + n] = acc[m * CTile::Acc + j];
      }
    });
    grid.sync();
    stamp(step, 4);

    // C2: the cell (gate order i, f, g, o), the parts summed in order.
    for (size_t i = gtid; i < (size_t)r_n * h_n; i += gsize) {
      const size_t r = i / h_n, u = i % h_n;
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const size_t o = r * g_n + q * h_n + u;
        float v = p.gates[o];
        for (int part = 1; part < parts; ++part)
          v += p.gates[(size_t)part * r_n * g_n + o];
        g[q] = v + b_sum[q * h_n + u];
      }
      const float cn = sigmoid(g[1]) * c[i] + sigmoid(g[0]) * tanhf(g[2]);
      c_new[i] = cn;
      hnew_c[i] = from_float<T>(sigmoid(g[3]) * tanhf(cn));
    }
    grid.sync();
    stamp(step, 5);

    // D: fc logits, rounded to T as the per-step path rounds them.
    for_tiles(r_n, v_n, DTile::BM, DTile::BN, 1,
              [&](int row0, int col0, int) {
      const float* acc = product_tile<T, DShape>(
          row0, col0, r_n, v_n, h_n, round8(h_n), 0, 1,
          [=](int r, int kk) {
            return to_float(hnew_c[(size_t)r * h_n + kk]);
          },
          [=](int n, int kk) { return to_float(wfc[(size_t)n * h_n + kk]); },
          [=](int r, int kk) {
            return Run{b16(hnew_c) + (size_t)r * h_n + kk, h_n - kk};
          },
          [=](int n, int kk) {
            return Run{b16(wfc) + (size_t)n * h_n + kk, h_n - kk};
          },
          smem);
      for (int i = threadIdx.x; i < DTile::BM * DTile::BN; i += kThreads) {
        const int m = i / DTile::BN, j = i % DTile::BN;
        const int r = row0 + m, n = col0 + j;
        if (r < r_n && n < v_n)
          logits[(size_t)r * v_n + n] =
              from_float<T>(acc[m * DTile::Acc + j] + to_float(bfc[n]));
      }
    });
    grid.sync();
    stamp(step, 6);

    // E: per image, top-k and bookkeeping, on every `spread`-th block:
    // spread over the grid rather than packed at its start, so that two
    // of E's blocks share an SM less often.
    if (blockIdx.x % spread == 0)
      for (int img = blockIdx.x / spread; img < b_n;
           img += gridDim.x / spread)
        select_image<T>(img, step, p, smem);
    grid.sync();
    stamp(step, 7);
  }
  if (gtid == 0) *p.steps = step - 1;
}

template <typename T>
cudaError_t launch(Params& p, void* workspace, cudaStream_t stream,
                   int* grid_blocks) {
  carve(p, reinterpret_cast<uintptr_t>(workspace), sizeof(T), c_parts<T>());
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<T>(p);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_beam<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  // The cooperative grid must be co-resident: no more blocks than fit.
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_beam<T>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int blocks = sms * std::min(per_sm, kBlocksPerSm);
  *grid_blocks = blocks;
  void* args[] = {&p};
  // The launch returns its own error. cudaGetLastError() here would also
  // return one that a refused earlier call (say, too much shared memory)
  // left in this library's runtime, and fail a good launch.
  return cudaLaunchCooperativeKernel((const void*)fused_beam<T>,
                                     dim3(blocks), dim3(kThreads), args, smem,
                                     stream);
}

Params sizes(int images, int k, int pix, int ddim, int adim, int hdim,
             int edim, int vocab, int max_steps) {
  Params p{};
  p.images = images;
  p.k = k;
  p.pix = pix;
  p.ddim = ddim;
  p.adim = adim;
  p.hdim = hdim;
  p.edim = edim;
  p.vocab = vocab;
  p.max_steps = max_steps;
  return p;
}

}  // namespace

// Phases a step, as the clock records them.
extern "C" int icd_fused_beam_phases() { return kPhases; }

// Bytes of scratch icd_fused_beam needs for these sizes (dtype as below).
extern "C" size_t icd_fused_beam_workspace(int images, int k, int pix,
                                           int ddim, int adim, int hdim,
                                           int edim, int vocab,
                                           int max_steps, int dtype) {
  Params p = sizes(images, k, pix, ddim, adim, hdim, edim, vocab, max_steps);
  return dtype == 1 ? carve(p, 0, 2, c_parts<__nv_bfloat16>())
                    : carve(p, 0, 4, c_parts<float>());
}

// Byte offsets in that workspace of what the last step run leaves there,
// for diagnosis: offsets[0] cum (R f32, the running scores after it),
// [1] lse (R f32, each live row's log-sum-exp), [2] logits (R x V in the
// grid's type), [3] words (R int, the last words) and [4] kact (B int,
// each image's live beams after it); rows in packing order.
extern "C" void icd_fused_beam_views(int images, int k, int pix, int ddim,
                                     int adim, int hdim, int edim, int vocab,
                                     int max_steps, int dtype,
                                     size_t* offsets) {
  Params p = sizes(images, k, pix, ddim, adim, hdim, edim, vocab, max_steps);
  if (dtype == 1)
    carve(p, 0, 2, c_parts<__nv_bfloat16>());
  else
    carve(p, 0, 4, c_parts<float>());
  offsets[0] = reinterpret_cast<uintptr_t>(p.cum);
  offsets[1] = reinterpret_cast<uintptr_t>(p.lse);
  offsets[2] = reinterpret_cast<uintptr_t>(p.logits);
  offsets[3] = reinterpret_cast<uintptr_t>(p.words);
  offsets[4] = reinterpret_cast<uintptr_t>(p.kact);
}

// dtype: 0 = float32, 1 = bfloat16 (every input but b_sum, which is f32).
// One cooperative launch on `stream`; nothing allocated here. Returns the
// CUDA error of the launch (0 on success) and the grid's block count in
// *grid_blocks.
extern "C" int icd_fused_beam(
    const void* enc, const void* att_enc, const void* h0, const void* c0,
    const void* emb, const void* wd, const void* bd, const void* wf,
    const void* bf, const void* wg, const void* bg, const void* wi,
    const void* wh, const void* b_sum, const void* wfc, const void* bfc,
    void* alpha, void* parent, void* best_seq, void* meta, void* steps,
    void* phase_ns, void* workspace, int images, int k, int pix, int ddim,
    int adim, int hdim, int edim, int vocab, int max_steps, int start_id,
    int end_id, int dtype, void* stream, int* grid_blocks) {
  if (k < 1 || k > kMaxRows || images < 1 || pix < 1 || max_steps < 1 ||
      vocab < k || start_id < 0 || start_id >= vocab || end_id < 0 ||
      end_id >= vocab)
    return (int)cudaErrorInvalidValue;
  Params p = sizes(images, k, pix, ddim, adim, hdim, edim, vocab, max_steps);
  p.enc = enc;
  p.att_enc = att_enc;
  p.h0 = h0;
  p.c0 = c0;
  p.emb = emb;
  p.wd = wd;
  p.bd = bd;
  p.wf = wf;
  p.bf = bf;
  p.wg = wg;
  p.bg = bg;
  p.wi = wi;
  p.wh = wh;
  p.b_sum = static_cast<const float*>(b_sum);
  p.wfc = wfc;
  p.bfc = bfc;
  p.alpha = static_cast<float*>(alpha);
  p.parent = static_cast<int*>(parent);
  p.best_seq = static_cast<int*>(best_seq);
  p.meta = static_cast<int*>(meta);
  p.steps = static_cast<int*>(steps);
  p.phase_ns = static_cast<long long*>(phase_ns);
  p.start_id = start_id;
  p.end_id = end_id;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, workspace, s, grid_blocks);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(p, workspace, s, grid_blocks);
  return (int)cudaErrorInvalidValue;
}
