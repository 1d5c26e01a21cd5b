// K3 on Hopper: the eval-mode batch norm of the float ResNet trunk, with
// its ReLU and residual add, in one pass over the activation.
//
// It replaces no TPU kernel. The JAX package leaves BN to XLA, which
// fuses the normalisation, the ReLU and the residual add into the
// convolution's neighbours; the eager port ran them as separate ATen
// passes (under bf16 with f32 statistics: subtract, multiply and add in
// f32, a cast to bf16, a ReLU, and two more passes at a residual). For
// a contiguous NHWC activation x of C channels and one BN's per-channel
// terms (mean, inv = rsqrt(var + eps) * scale, bias), K3 writes
//
//   form 0   relu(bn(x))                  the stem, bn1, bn2
//   form 1   relu(bn(x) + r)              bn3 with an identity shortcut
//   form 2   relu(bn(x) + bn'(s))         bn3 with a downsample's BN
//
// with the very operations of the eager chain, in its order and at its
// roundings: inv = rsqrt(var + eps) * scale, once for each channel a
// thread touches, and bn(x) = ((x - mean) * inv + bias), each step an
// IEEE f32 operation (__fadd_rn, rsqrtf as ATen's rsqrt calls it,
// __fsub_rn, __fmul_rn: no FMA contraction) whose result is rounded to
// bf16 where PyTorch's type promotion makes that step's result bf16 (the
// flags); then rounded to x's type; a residual sum rounded again; then
// the ReLU (NaN kept, as ATen's clamp_min). T is x's type (f32 or bf16);
// r and s are T; each of mean, var, scale, bias is f32 or bf16.
//
// Bound. Bytes: at batch 64 the 100 sites of ResNet-101 at 224^2 read
// 1.04 G activations and write 0.94 G, 4.9 GB in bf16, 1.47 ms at
// 3.35 TB/s; the arithmetic is a few operations an element. Design:
// every activation is read once and the output written once, in 16-byte
// words (8 bf16 or 4 f32); the activations are read with evict-first
// loads (each is dead after this pass) and the output stored normally
// (the next convolution reads it, from L2 where it fits). A thread walks
// the vectors grid-stride, two a step for more bytes in flight, over a
// grid whose thread count is a multiple of C's vectors a row, so that
// every vector a thread touches has the same channels: a thread loads
// its per-channel terms once, into registers. A channel count that is
// not a multiple of the vector width, or a pointer off 16 bytes, takes
// the scalar variant (one element a word).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 threads an SM
constexpr int kMaxDevices = 64;

// A BN's flags: bits 0-3 say that mean, var, scale, bias are stored in
// bf16 (a bf16 var also rounds var + eps and its rsqrt to bf16); bits
// 4-7 that inv, the subtract, the multiply and the add round to bf16.
constexpr int kMeanBf16 = 1, kVarBf16 = 2, kScaleBf16 = 4, kBiasBf16 = 8;
constexpr int kInvBf16 = 16, kSubBf16 = 32, kMulBf16 = 64, kAddBf16 = 128;
constexpr int kAllFlags = 255;

struct Terms {
  const void* mean;
  const void* var;
  const void* scale;
  const void* bias;
  int flags;
  float eps;
};

struct Args {
  const void* x;
  const void* r;  // form 1: the residual; form 2: s, the shortcut's input
  void* out;
  Terms bn, bn2;  // bn2: form 2's shortcut BN
  long long nvec;  // vectors of V elements
  int cvec;        // vectors a row of C channels
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float bf16_bits(unsigned short u) {
  return __bfloat162float(__ushort_as_bfloat16(u));
}

template <typename T>
__device__ __forceinline__ float as_t(float v) {
  if constexpr (sizeof(T) == 2) {
    return round_bf16(v);
  } else {
    return v;
  }
}

// ATen's relu (clamp_min(x, 0) in f32): NaN passes.
__device__ __forceinline__ float relu(float v) {
  return v != v ? v : fmaxf(v, 0.0f);
}

// V values of one channel term, channels c .. c + V - 1.
template <int V>
__device__ __forceinline__ void load_term(const void* p, bool bf16, int c,
                                          float (&out)[V]) {
  if (bf16) {
    const unsigned short* q = static_cast<const unsigned short*>(p) + c;
    if constexpr (V == 8) {
      uint4 u = __ldg(reinterpret_cast<const uint4*>(q));
      const unsigned short* e = reinterpret_cast<const unsigned short*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = bf16_bits(e[i]);
    } else if constexpr (V == 4) {
      uint2 u = __ldg(reinterpret_cast<const uint2*>(q));
      const unsigned short* e = reinterpret_cast<const unsigned short*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i] = bf16_bits(e[i]);
    } else {
      out[0] = bf16_bits(__ldg(q));
    }
  } else {
    const float* q = static_cast<const float*>(p) + c;
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int j = 0; j < V / 4; ++j) {
        float4 f = __ldg(reinterpret_cast<const float4*>(q) + j);
        out[4 * j] = f.x;
        out[4 * j + 1] = f.y;
        out[4 * j + 2] = f.z;
        out[4 * j + 3] = f.w;
      }
    } else {
      out[0] = __ldg(q);
    }
  }
}

template <int V>
struct ChannelTerms {
  float mean[V], inv[V], bias[V];
  int flags;

  // The terms of channels c .. c + V - 1; inv = rsqrt(var + eps) *
  // scale, rounded as ATen rounds it.
  __device__ __forceinline__ void load(const Terms& t, int c) {
    flags = t.flags;
    float scale[V];
    load_term<V>(t.mean, flags & kMeanBf16, c, mean);
    load_term<V>(t.var, flags & kVarBf16, c, inv);
    load_term<V>(t.scale, flags & kScaleBf16, c, scale);
    load_term<V>(t.bias, flags & kBiasBf16, c, bias);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float v = __fadd_rn(inv[i], t.eps);
      if (flags & kVarBf16) v = round_bf16(v);
      float q = rsqrtf(v);
      if (flags & kVarBf16) q = round_bf16(q);
      q = __fmul_rn(q, scale[i]);
      if (flags & kInvBf16) q = round_bf16(q);
      inv[i] = q;
    }
  }

  // ((x - mean) * inv + bias), each step rounded as the eager chain
  // rounds it.
  __device__ __forceinline__ float apply(float x, int i) const {
    float d = __fsub_rn(x, mean[i]);
    if (flags & kSubBf16) d = round_bf16(d);
    float e = __fmul_rn(d, inv[i]);
    if (flags & kMulBf16) e = round_bf16(e);
    float y = __fadd_rn(e, bias[i]);
    if (flags & kAddBf16) y = round_bf16(y);
    return y;
  }
};

// V elements of T from vector i: one 16-byte evict-first load, or one
// element when V is 1.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const void* p, long long i,
                                         float (&out)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 2) {
      out[0] = bf16_bits(__ldcs(static_cast<const unsigned short*>(p) + i));
    } else {
      out[0] = __ldcs(static_cast<const float*>(p) + i);
    }
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    uint4 u = __ldcs(static_cast<const uint4*>(p) + i);
    if constexpr (sizeof(T) == 2) {
      const unsigned short* e = reinterpret_cast<const unsigned short*>(&u);
#pragma unroll
      for (int k = 0; k < V; ++k) out[k] = bf16_bits(e[k]);
    } else {
      const float* e = reinterpret_cast<const float*>(&u);
#pragma unroll
      for (int k = 0; k < V; ++k) out[k] = e[k];
    }
  }
}

// V values already representable in T, stored to vector i.
template <typename T, int V>
__device__ __forceinline__ void store_vec(void* p, long long i,
                                          const float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 2) {
      static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v[0]);
    } else {
      static_cast<float*>(p)[i] = v[0];
    }
  } else {
    uint4 u;
    if constexpr (sizeof(T) == 2) {
      unsigned short* e = reinterpret_cast<unsigned short*>(&u);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        e[k] = __bfloat16_as_ushort(__float2bfloat16(v[k]));
      }
    } else {
      float* e = reinterpret_cast<float*>(&u);
#pragma unroll
      for (int k = 0; k < V; ++k) e[k] = v[k];
    }
    static_cast<uint4*>(p)[i] = u;
  }
}

template <typename T, int kForm, int V>
__device__ __forceinline__ void epilogue(const Args& a,
                                         const ChannelTerms<V>& t,
                                         const ChannelTerms<V>& t2,
                                         const float (&x)[V],
                                         const float (&r)[V], long long i) {
  float o[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float y = as_t<T>(t.apply(x[k], k));
    if constexpr (kForm == 1) {
      y = as_t<T>(__fadd_rn(y, r[k]));
    } else if constexpr (kForm == 2) {
      y = as_t<T>(__fadd_rn(y, as_t<T>(t2.apply(r[k], k))));
    }
    o[k] = relu(y);
  }
  store_vec<T, V>(a.out, i, o);
}

template <typename T, int kForm, int V>
__global__ void __launch_bounds__(kThreads) bn_epilogue(Args a) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (first >= a.nvec) return;
  // stride is a multiple of cvec: every vector of this thread has the
  // channels of its first.
  const int c = (int)(first % a.cvec) * V;
  ChannelTerms<V> t, t2;
  t.load(a.bn, c);
  if constexpr (kForm == 2) t2.load(a.bn2, c);
  for (long long i = first; i < a.nvec; i += 2 * stride) {
    const long long j = i + stride;
    const bool second = j < a.nvec;
    float x0[V], x1[V], r0[V], r1[V];
    load_vec<T, V>(a.x, i, x0);
    if (second) load_vec<T, V>(a.x, j, x1);
    if constexpr (kForm != 0) {
      load_vec<T, V>(a.r, i, r0);
      if (second) load_vec<T, V>(a.r, j, r1);
    }
    epilogue<T, kForm, V>(a, t, t2, x0, r0, i);
    if (second) epilogue<T, kForm, V>(a, t, t2, x1, r1, j);
  }
}

long long gcd(long long p, long long q) {
  while (q) {
    long long t = p % q;
    p = q;
    q = t;
  }
  return p;
}

int sm_count() {
  static int counts[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    counts[dev] = n;
  }
  return counts[dev];
}

template <typename T, int V>
cudaError_t launch_v(int form, const Args& a, cudaStream_t s) {
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  long long grid = (a.nvec + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  if (grid > most) grid = most;
  // Round the grid up so that its threads are a multiple of cvec.
  const long long unit = a.cvec / gcd(a.cvec, kThreads);
  grid = (grid + unit - 1) / unit * unit;
  if (grid > INT32_MAX) return cudaErrorInvalidValue;
  if (form == 0) {
    bn_epilogue<T, 0, V><<<(unsigned)grid, kThreads, 0, s>>>(a);
  } else if (form == 1) {
    bn_epilogue<T, 1, V><<<(unsigned)grid, kThreads, 0, s>>>(a);
  } else {
    bn_epilogue<T, 2, V><<<(unsigned)grid, kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int vec, int form, const Args& a, cudaStream_t s) {
  return vec == 1 ? launch_v<T, 1>(form, a, s)
                  : launch_v<T, 16 / sizeof(T)>(form, a, s);
}

}  // namespace

// One BN's terms as the host prepares them once (ops/bn_epilogue.py's
// Terms): their pointers, the flags for each activation dtype (0 =
// float32, 1 = bfloat16) and the BN's eps.
// It lies outside the unnamed namespace: nvcc gives a function that
// takes a type of that namespace internal linkage, which would hide the
// C entry point.
struct HostTerms {
  const void* mean;
  const void* var;
  const void* scale;
  const void* bias;
  int flags[2];
  float eps;
};

// One K3 launch on ``stream`` of card ``device``. x, r (form 1: the
// residual; form 2: the shortcut's input) and out are contiguous
// (n / c, c) in dtype (0 = float32, 1 = bfloat16); bn (and bn2 in form
// 2) holds one BN's terms, c values each, f32 or bf16 as its flags for
// dtype say (bits above). vec (1, or 16 bytes of dtype) is the vector
// width; the caller checks that c is a multiple of it and every pointer
// 16-byte aligned. Returns cudaGetLastError() after the launch (0 on
// success), or an error for arguments K3 does not take.
extern "C" int icd_bn_epilogue(const void* x, const void* r, void* out,
                               const HostTerms* bn, const HostTerms* bn2,
                               long long n, int c, int dtype, int form,
                               int vec, int device, void* stream) {
  const int wide = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || form < 0 || form > 2 || n < 0 || c < 1 ||
      n % c != 0 || (vec != 1 && vec != wide) || c % vec != 0 ||
      bn == nullptr || (form == 2 && bn2 == nullptr) ||
      (form != 0 && r == nullptr))
    return (int)cudaErrorInvalidValue;
  const HostTerms* h2 = form == 2 ? bn2 : bn;
  const int flags = bn->flags[dtype], flags2 = h2->flags[dtype];
  if ((flags & ~kAllFlags) != 0 || (flags2 & ~kAllFlags) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a{x,
         r,
         out,
         {bn->mean, bn->var, bn->scale, bn->bias, flags, bn->eps},
         {h2->mean, h2->var, h2->scale, h2->bias, flags2, h2->eps},
         n / vec,
         c / vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? launch_t<float>(vec, form, a, s)
                   : launch_t<__nv_bfloat16>(vec, form, a, s);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
