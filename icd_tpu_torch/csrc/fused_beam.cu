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
//   logits        = h_T Wfc^T + bfc, rounded to T, then f32
//   cand          = (logits - logsumexp) + cum, NEG_INF where the row is
//                   not live (step 1: row 0 only; then rows < k_active)
//   then the flat top-k of each image's k * V candidates in lax.top_k
//   order (value descending, flat index ascending), completion into the
//   running best (ties to the first maximum), survivor packing in top-k
//   rank order, and the permutation of h, c and the sequences.
// Outputs: the raw per-step alphas (S, B, k, P), parent pointers (S, B, k),
// best sequence (B, S), meta (B, 4) = best_len, best_step, best_parent,
// found, and the number of steps run. The winner's alpha trail is
// backtracked outside, as on the TPU (fused_beam.py:533-571). T is the
// grid's type (f32 or bf16); c and cum stay f32. Every use of h takes it
// rounded to T, so h is kept only so rounded (hc).
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
// as many blocks as fit on the card at once, each walking a share of the
// work items of every phase, with grid.sync() between phases:
//   init  the state, from h0, c0 (one row per image) and the start token;
//   A     the products of h, one tiled product with [Wd; Wg];
//   B1    attention scores per (image, 16 pixels), k beams per att_enc read;
//   B2    softmax, context and gate per (image, 256 columns of D), k beams
//         per enc read (A, B1 and B2 are K1's code, attention_common.cuh);
//   C     the LSTM gates, one tiled product over [emb | x2 | hc] and
//         [Wi | Wh], the embedding read in place by word id;
//   C2    the cell;
//   D     the fc product, logits rounded to T;
//   E     one block per image: log-softmax of its k rows, its top-k, the
//         running best, packing, and the permutation of its rows.
// Before each step every block reads all k_active after the same barrier,
// so all blocks leave the loop at the same step. Each phase reads only
// buffers written before the last barrier, and in E each block touches
// only its own image's rows, reading h, c from hnew_c, c_new: no buffer
// is written while another block reads it. Products are shared-memory FMA
// tiles with f32 accumulation: a simple, correct kernel, no tensor cores,
// TMA or cp.async yet; it reads the weights from L2 or memory every step.

#include <cooperative_groups.h>
#include <limits.h>

#include <algorithm>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace icd;

constexpr float kNegInf = -1e9f;  // candidate mask, beam.py's NEG_INF
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 4;

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
  // Scratch, carved from the caller's workspace.
  float* c;        // (R, H) state
  float* c_new;    // (R, H) this step's cell output, before packing
  float* att_dec;  // (R, A)
  float* gate;     // (R, D)
  float* scores;   // (R, P)
  float* gates;    // (R, 4H)
  float* logits;   // (R, V)
  float* cum;      // (R) running scores
  float* best_score;  // (B)
  void* hc;        // (R, H) T, h rounded: every product's only use of h
  void* hnew_c;    // (R, H) T, this step's h rounded, before packing
  void* x2;        // (R, D) T, gated context
  int* words;      // (R) last word of each row
  int* seqs;       // (R, S)
  int* kact;       // (B) live beams of each image
  int images, k, pix, ddim, adim, hdim, edim, vocab, max_steps;
  int start_id, end_id;
};

// Lays the scratch buffers out in `base` (nullptr: only count), each
// aligned to 256 bytes; returns the bytes used.
size_t carve(Params& p, char* base, size_t elt) {
  size_t off = 0;
  auto take = [&](size_t bytes) -> char* {
    off = (off + 255) & ~size_t(255);
    char* at = base ? base + off : nullptr;
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
  p.gates = (float*)take(r * 4 * h * f);
  p.logits = (float*)take(r * p.vocab * f);
  p.cum = (float*)take(r * f);
  p.best_score = (float*)take(p.images * f);
  p.hc = take(r * h * elt);
  p.hnew_c = take(r * h * elt);
  p.x2 = take(r * p.ddim * elt);
  p.words = (int*)take(r * sizeof(int));
  p.seqs = (int*)take(r * s * sizeof(int));
  p.kact = (int*)take(p.images * sizeof(int));
  return off;
}

struct SelectShared {
  float lse[kMaxRows], cum[kMaxRows], top_v[kMaxRows], ord_score[kMaxRows];
  int top_i[kMaxRows], ord_prev[kMaxRows], ord_word[kMaxRows];
  float red_v[kWarps];
  int red_i[kWarps];
  int improved, best_parent, best_word;
  // followed by the image's k sequences, (k, S) ints
};

size_t smem_bytes(const Params& p) {
  const size_t f = sizeof(float);
  return std::max({kGemmSmemFloats * f, (size_t)(p.k + 1) * p.adim * f,
                   (size_t)p.k * p.pix * f,
                   sizeof(SelectShared) + (size_t)p.k * (p.max_steps + 1) * 4});
}

// lax.top_k's order: value descending, then index ascending.
__device__ __forceinline__ bool ranks_before(float av, int ai, float bv,
                                             int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Runs f(row0, col0) for this block's share of the 64 x 64 tiles of a
// (rows, cols) product; tiles of one column band go to neighbouring
// blocks, so a weight tile is read from memory once and from L2 after.
template <class F>
__device__ void for_tiles(int rows, int cols, F f) {
  const int rt = (rows + kTile - 1) / kTile;
  const int n = rt * ((cols + kTile - 1) / kTile);
  for (int t = blockIdx.x; t < n; t += gridDim.x)
    f((t % rt) * kTile, (t / rt) * kTile);
}

// Phase E for one image (fused_beam.py:236-384).
template <typename T>
__device__ void select_image(int img, int step, const Params& p,
                             float* smem) {
  SelectShared& sh = *reinterpret_cast<SelectShared*>(smem);
  int* old_seqs = reinterpret_cast<int*>(&sh + 1);
  const int k = p.k, v_n = p.vocab, h_n = p.hdim, s_n = p.max_steps + 1;
  const int row0 = img * k;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  const int active = p.kact[img];  // read by all before thread 0 rewrites it

  // Log-softmax terms of the image's k rows, one warp a row.
  if (warp < k) {
    const float* x = p.logits + (size_t)(row0 + warp) * v_n;
    float m = -INFINITY;
    for (int v = lane; v < v_n; v += 32) m = fmaxf(m, x[v]);
    m = warp_max(m);
    float s = 0.f;
    for (int v = lane; v < v_n; v += 32) s += expf(x[v] - m);
    s = warp_sum(s);
    if (lane == 0) {
      sh.lse[warp] = m + logf(s);
      sh.cum[warp] = p.cum[row0 + warp];
    }
  }
  for (int i = threadIdx.x; i < k * s_n; i += kThreads)
    old_seqs[i] = p.seqs[(size_t)row0 * s_n + i];
  __syncthreads();

  // Each thread keeps the best kMaxRows of the candidates it scans,
  // sorted; a list of fixed length keeps the arrays in registers.
  float val[kMaxRows];
  int idx[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    val[i] = -INFINITY;  // below every candidate, NEG_INF included
    idx[i] = INT_MAX;
  }
  for (int j = 0; j < k; ++j) {
    const bool live = step == 1 ? j == 0 : j < active;
    const float* x = p.logits + (size_t)(row0 + j) * v_n;
    const float lse = sh.lse[j], cum = sh.cum[j];
    for (int v = threadIdx.x; v < v_n; v += kThreads) {
      const float cand = live ? (x[v] - lse) + cum : kNegInf;
      const int f = j * v_n + v;
      if (ranks_before(cand, f, val[kMaxRows - 1], idx[kMaxRows - 1])) {
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

  // Completion, running best and packing: k values, one thread.
  if (threadIdx.x == 0) {
    int prev[kMaxRows], word[kMaxRows], order[kMaxRows];
    float score[kMaxRows], comp[kMaxRows];
    bool surv[kMaxRows];
    bool any_fin = false;
    for (int j = 0; j < k; ++j) {
      prev[j] = sh.top_i[j] / v_n;
      word[j] = sh.top_i[j] - prev[j] * v_n;
      const bool valid = j < active;  // active == k at step 1
      const bool fin = valid && word[j] == p.end_id;
      score[j] = valid ? sh.top_v[j] : kNegInf;
      comp[j] = fin ? score[j] : kNegInf;
      surv[j] = valid && !fin;
      any_fin |= fin;
    }
    int comp_best = 0;  // the first maximum
    for (int j = 1; j < k; ++j)
      if (comp[j] > comp[comp_best]) comp_best = j;
    const bool improved = any_fin && comp[comp_best] > p.best_score[img];
    int* meta = p.meta + (size_t)img * 4;
    if (improved) {
      p.best_score[img] = comp[comp_best];
      meta[0] = step + 1;
      meta[1] = step;
      meta[2] = prev[comp_best];
    }
    if (any_fin) meta[3] = 1;
    sh.improved = improved;
    sh.best_parent = prev[comp_best];
    sh.best_word = word[comp_best];

    int n = 0;
    for (int j = 0; j < k; ++j)
      if (surv[j]) order[n++] = j;
    p.kact[img] = n;
    for (int j = 0; j < k; ++j)
      if (!surv[j]) order[n++] = j;
    int* parent = p.parent + ((size_t)step * p.images + img) * k;
    for (int j = 0; j < k; ++j) {
      const int o = order[j];
      sh.ord_prev[j] = prev[o];
      sh.ord_word[j] = word[o];
      sh.ord_score[j] = score[o];
      parent[j] = prev[o];
      p.words[row0 + j] = word[o];
      p.cum[row0 + j] = score[o];
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
__global__ void __launch_bounds__(kThreads, 2) fused_beam(Params p) {
  extern __shared__ float smem[];
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
  float* c_new = p.c_new;
  float* c = p.c;
  float* gates = p.gates;
  float* logits = p.logits;
  const int* words = p.words;

  // init (fused_beam.py:141-158)
  for (size_t i = gtid; i < (size_t)r_n * h_n; i += gsize) {
    const size_t src = i / h_n / k * h_n + i % h_n;  // row i / H, image row / k
    p.c[i] = to_float(c0[src]);
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

  int step = 1;
  for (; step <= p.max_steps; ++step) {
    int live = 0;
    for (int i = threadIdx.x; i < b_n; i += kThreads) live |= p.kact[i] > 0;
    if (!__syncthreads_or(live)) break;  // the same answer in every block

    // A: att_dec and gate.
    for_tiles(r_n, a_n + d_n, [&](int row0, int col0) {
      decoder_products_tile<T>(row0, col0, hc, wd, bd, wg, bg, p.att_dec,
                               p.gate, r_n, h_n, a_n, d_n, smem);
    });
    grid.sync();

    // B1: scores.
    const int pchunks = (p_n + kPixelsPerChunk - 1) / kPixelsPerChunk;
    for (int it = blockIdx.x; it < b_n * pchunks; it += gridDim.x)
      attention_scores_chunk<T>(it / pchunks, it % pchunks, att_enc,
                                p.att_dec, wf, bf, p.scores, k, p_n, a_n,
                                smem);
    grid.sync();

    // B2: softmax, context, gate; the step's raw alphas.
    const int dchunks = (d_n + kThreads - 1) / kThreads;
    float* alpha = p.alpha + (size_t)step * r_n * p_n;
    for (int it = blockIdx.x; it < b_n * dchunks; it += gridDim.x)
      attention_context_chunk<T>(it / dchunks, it % dchunks, enc, p.scores,
                                 p.gate, x2, alpha, k, p_n, d_n, smem);
    grid.sync();

    // C: LSTM gates over [emb | x2 | hc] (E + D + H deep).
    const int ed = e_n + d_n, g_n = 4 * h_n;
    for_tiles(r_n, g_n, [&](int row0, int col0) {
      gemm_tile(
          row0, col0, r_n, g_n, ed + h_n,
          [=](int r, int kk) {
            if (kk < e_n) return to_float(emb[(size_t)words[r] * e_n + kk]);
            if (kk < ed) return to_float(x2[(size_t)r * d_n + kk - e_n]);
            return to_float(hc[(size_t)r * h_n + kk - ed]);
          },
          [=](int n, int kk) {
            return kk < ed ? to_float(wi[(size_t)n * ed + kk])
                           : to_float(wh[(size_t)n * h_n + kk - ed]);
          },
          [=](int r, int n, float acc) {
            gates[(size_t)r * g_n + n] = acc + b_sum[n];
          },
          smem);
    });
    grid.sync();

    // C2: the cell (gate order i, f, g, o).
    for (size_t i = gtid; i < (size_t)r_n * h_n; i += gsize) {
      const float* g = gates + i / h_n * g_n + i % h_n;
      const float gi = sigmoid(g[0]), gf = sigmoid(g[h_n]);
      const float gg = tanhf(g[2 * h_n]), go = sigmoid(g[3 * h_n]);
      const float cn = gf * c[i] + gi * gg;
      c_new[i] = cn;
      hnew_c[i] = from_float<T>(go * tanhf(cn));
    }
    grid.sync();

    // D: fc logits, rounded to T as the per-step path rounds them.
    for_tiles(r_n, v_n, [&](int row0, int col0) {
      gemm_tile(
          row0, col0, r_n, v_n, h_n,
          [=](int r, int kk) {
            return to_float(hnew_c[(size_t)r * h_n + kk]);
          },
          [=](int n, int kk) { return to_float(wfc[(size_t)n * h_n + kk]); },
          [=](int r, int n, float acc) {
            logits[(size_t)r * v_n + n] =
                to_float(from_float<T>(acc + to_float(bfc[n])));
          },
          smem);
    });
    grid.sync();

    // E: per image, top-k and bookkeeping.
    for (int img = blockIdx.x; img < b_n; img += gridDim.x)
      select_image<T>(img, step, p, smem);
    grid.sync();
  }
  if (gtid == 0) *p.steps = step - 1;
}

template <typename T>
cudaError_t launch(Params& p, void* workspace, cudaStream_t stream,
                   int* grid_blocks) {
  carve(p, static_cast<char*>(workspace), sizeof(T));
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(p);
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
  const int blocks = sms * std::min(per_sm, kMaxBlocksPerSm);
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

// Bytes of scratch icd_fused_beam needs for these sizes (dtype as below).
extern "C" size_t icd_fused_beam_workspace(int images, int k, int pix,
                                           int ddim, int adim, int hdim,
                                           int edim, int vocab,
                                           int max_steps, int dtype) {
  Params p = sizes(images, k, pix, ddim, adim, hdim, edim, vocab, max_steps);
  return carve(p, nullptr, dtype == 1 ? 2 : 4);
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
    void* workspace, int images, int k, int pix, int ddim, int adim,
    int hdim, int edim, int vocab, int max_steps, int start_id, int end_id,
    int dtype, void* stream, int* grid_blocks) {
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
  p.start_id = start_id;
  p.end_id = end_id;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, workspace, s, grid_blocks);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(p, workspace, s, grid_blocks);
  return (int)cudaErrorInvalidValue;
}
