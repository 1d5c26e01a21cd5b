// K4 on Hopper: the epilogue after each int8 convolution of the
// static-int8 ResNet trunk, in one pass over the int32 sums.
//
// It replaces no TPU kernel. The JAX package leaves this chain to XLA,
// which fuses the dequantization affine, the residual add, the ReLU and
// the requantize into the convolution's neighbours; the eager port ran
// each step as its own ATen pass over f32 (int32 -> f32, * scale,
// + bias, relu; the shortcut's s8 -> f32 and * in_scale, or the
// downsample's own affine, and the add; * inv_next, round, clamp and the
// cast to s8). For a convolution's int32 sums acc, contiguous
// (rows, C), and one site's per-channel terms, K4 writes
//
//   y = f32(acc) * scale + bias
//   residual 0   y                                      stem, conv1, conv2
//   residual 1   y + f32(q) * in_scale                  conv3, identity
//   residual 2   y + (f32(ds) * ds_scale + ds_bias)     conv3, downsample
//   then relu, and either
//   out s8       int8(clamp(rint(relu(.) * inv_next), -127, 127))
//   out float    relu(.) as f32, or rounded to bf16 (the trunk's last block)
//
// with the very operations of the eager chain, in its order and at its
// roundings: int32 -> f32 rounded to nearest (__int2float_rn, as ATen's
// cast), each multiply and add its own IEEE f32 operation (__fmul_rn,
// __fadd_rn: no FMA contraction), the ReLU keeping NaN (ATen's
// clamp_min), rintf rounding half to even (torch.round), and the bf16
// output rounded to nearest even (__float2bfloat16_rn). scale, bias,
// ds_scale, ds_bias are (C,) f32; inv_next and in_scale are single f32
// values in device memory (in_scale is 1 / inv_in as ATen computed it,
// prepared once by the host), so no launch waits on the host.
//
// Bound. Bytes: each int32 sum is read once (4 B), the s8 shortcut (1 B)
// or the downsample's int32 sums (4 B) once, and the output written once
// (1 B, or 2 / 4 at the last block). At batch 64 the 100 sites of
// ResNet-101 at 224^2 move 5.58 GB, 1.67 ms at 3.35 TB/s; the
// arithmetic is a few operations an element. Design: one thread a
// vector of 16 consecutive channels of one pixel row, so every access is
// 16 bytes a thread (four loads of int32 sums, one load of the s8
// shortcut or four of the downsample's sums, one s8 store) and
// neighbouring threads touch neighbouring addresses; the sums and the
// shortcut are read with evict-first loads (each is dead after this
// pass) and the output stored normally (the next convolution reads it,
// from L2 where it fits); the per-channel terms go through the read-only
// path and stay in L1, where every row's threads find them. A channel
// count that is not a multiple of 16, or a pointer off 16 bytes, takes
// the scalar variant (one element a thread).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;  // channels a thread in the vector variant

// Output types: 0 = s8 (requantized), 1 = f32, 2 = bf16.
constexpr int kOutS8 = 0, kOutF32 = 1, kOutBf16 = 2;

struct Args {
  const int32_t* acc;
  const void* other;  // residual 1: the s8 shortcut; 2: the downsample's sums
  void* out;
  const float* scale;
  const float* bias;
  const float* inv_next;
  const float* in_scale;
  const float* ds_scale;
  const float* ds_bias;
  long long nvec;  // vectors of V elements
  int cvec;        // vectors a row of C channels
};

// ATen's relu (clamp_min(x, 0) in f32): NaN passes.
__device__ __forceinline__ float relu(float v) {
  return v != v ? v : fmaxf(v, 0.0f);
}

// ATen's clamp(x, -127, 127) then the cast to int8 of an integral value.
__device__ __forceinline__ int8_t requant(float v, float inv) {
  float r = rintf(__fmul_rn(v, inv));
  if (r == r) r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (int8_t)r;
}

// V int32 values of vector i, as f32.
template <int V>
__device__ __forceinline__ void load_i32(const int32_t* p, long long i,
                                         float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = __int2float_rn(__ldcs(p + i));
  } else {
    const int4* q = reinterpret_cast<const int4*>(p) + i * (V / 4);
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      int4 u = __ldcs(q + j);
      out[4 * j] = __int2float_rn(u.x);
      out[4 * j + 1] = __int2float_rn(u.y);
      out[4 * j + 2] = __int2float_rn(u.z);
      out[4 * j + 3] = __int2float_rn(u.w);
    }
  }
}

// V int8 values of vector i, as f32.
template <int V>
__device__ __forceinline__ void load_s8(const int8_t* p, long long i,
                                        float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = (float)__ldcs(reinterpret_cast<const signed char*>(p) + i);
  } else {
    static_assert(V == 16, "a vector of s8 is 16 bytes");
    int4 u = __ldcs(reinterpret_cast<const int4*>(p) + i);
    const int8_t* e = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = (float)e[k];
  }
}

// V values of a (C,) f32 term, channels c .. c + V - 1, read-only path.
template <int V>
__device__ __forceinline__ void load_term(const float* p, int c,
                                          float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = __ldg(p + c);
  } else {
    const float4* q = reinterpret_cast<const float4*>(p + c);
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      float4 f = __ldg(q + j);
      out[4 * j] = f.x;
      out[4 * j + 1] = f.y;
      out[4 * j + 2] = f.z;
      out[4 * j + 3] = f.w;
    }
  }
}

// V output values of vector i (already relu'd f32 sums).
template <int kOut, int V>
__device__ __forceinline__ void store(void* p, long long i, const float (&v)[V],
                                      float inv) {
  if constexpr (kOut == kOutS8) {
    if constexpr (V == 1) {
      static_cast<int8_t*>(p)[i] = requant(v[0], inv);
    } else {
      int4 u;
      int8_t* e = reinterpret_cast<int8_t*>(&u);
#pragma unroll
      for (int k = 0; k < V; ++k) e[k] = requant(v[k], inv);
      static_cast<int4*>(p)[i] = u;
    }
  } else if constexpr (kOut == kOutF32) {
    if constexpr (V == 1) {
      static_cast<float*>(p)[i] = v[0];
    } else {
      float4* q = static_cast<float4*>(p) + i * (V / 4);
#pragma unroll
      for (int j = 0; j < V / 4; ++j) {
        q[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
      }
    }
  } else {
    if constexpr (V == 1) {
      static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v[0]);
    } else {
      int4* q = static_cast<int4*>(p) + i * (V / 8);
#pragma unroll
      for (int j = 0; j < V / 8; ++j) {
        int4 u;
        unsigned short* e = reinterpret_cast<unsigned short*>(&u);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          e[k] = __bfloat16_as_ushort(__float2bfloat16_rn(v[8 * j + k]));
        }
        q[j] = u;
      }
    }
  }
}

template <int kRes, int kOut, int V>
__global__ void __launch_bounds__(kThreads) int8_epilogue(Args a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.nvec) return;
  const int c = (int)(i % a.cvec) * V;
  float y[V], scale[V], bias[V];
  load_i32<V>(a.acc, i, y);
  float r[V];
  if constexpr (kRes == 1) {
    load_s8<V>(static_cast<const int8_t*>(a.other), i, r);
  } else if constexpr (kRes == 2) {
    load_i32<V>(static_cast<const int32_t*>(a.other), i, r);
  }
  load_term<V>(a.scale, c, scale);
  load_term<V>(a.bias, c, bias);
#pragma unroll
  for (int k = 0; k < V; ++k) y[k] = __fadd_rn(__fmul_rn(y[k], scale[k]), bias[k]);
  if constexpr (kRes == 1) {
    const float in_scale = __ldg(a.in_scale);
#pragma unroll
    for (int k = 0; k < V; ++k) y[k] = __fadd_rn(y[k], __fmul_rn(r[k], in_scale));
  } else if constexpr (kRes == 2) {
    load_term<V>(a.ds_scale, c, scale);
    load_term<V>(a.ds_bias, c, bias);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      y[k] = __fadd_rn(y[k], __fadd_rn(__fmul_rn(r[k], scale[k]), bias[k]));
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) y[k] = relu(y[k]);
  const float inv = kOut == kOutS8 ? __ldg(a.inv_next) : 0.0f;
  store<kOut, V>(a.out, i, y, inv);
}

template <int kRes, int V>
cudaError_t launch_o(int out, const Args& a, unsigned grid, cudaStream_t s) {
  if (out == kOutS8) {
    int8_epilogue<kRes, kOutS8, V><<<grid, kThreads, 0, s>>>(a);
  } else if (out == kOutF32) {
    int8_epilogue<kRes, kOutF32, V><<<grid, kThreads, 0, s>>>(a);
  } else {
    int8_epilogue<kRes, kOutBf16, V><<<grid, kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_v(int residual, int out, const Args& a, cudaStream_t s) {
  const long long grid = (a.nvec + kThreads - 1) / kThreads;
  if (grid > INT32_MAX) return cudaErrorInvalidValue;
  if (residual == 0) return launch_o<0, V>(out, a, (unsigned)grid, s);
  if (residual == 1) return launch_o<1, V>(out, a, (unsigned)grid, s);
  return launch_o<2, V>(out, a, (unsigned)grid, s);
}

}  // namespace

// One site's terms as the host prepares them once (ops/int8_epilogue.py's
// Terms): device pointers to scale and bias ((C,) f32), inv_next (one
// f32; null for a float output), in_scale (one f32; residual 1) and the
// downsample's ds_scale and ds_bias ((C,) f32; residual 2).
// It lies outside the unnamed namespace: nvcc gives a function that
// takes a type of that namespace internal linkage, which would hide the
// C entry point.
struct HostTerms {
  const float* scale;
  const float* bias;
  const float* inv_next;
  const float* in_scale;
  const float* ds_scale;
  const float* ds_bias;
};

// One K4 launch on ``stream`` of card ``device``. acc (int32), other
// (residual 1: s8; residual 2: int32) and out are contiguous (n / c, c);
// out is s8 (out 0), f32 (1) or bf16 (2). vec (1 or 16) is the vector
// width; the caller checks that c is a multiple of it and every pointer
// 16-byte aligned. Returns cudaGetLastError() after the launch (0 on
// success), or an error for arguments K4 does not take.
extern "C" int icd_int8_epilogue(const void* acc, const void* other,
                                 void* out, const HostTerms* t, long long n,
                                 int c, int residual, int out_type, int vec,
                                 int device, void* stream) {
  if (t == nullptr || residual < 0 || residual > 2 || out_type < 0 ||
      out_type > 2 || n < 0 || c < 1 || n % c != 0 ||
      (vec != 1 && vec != kVec) || c % vec != 0 || acc == nullptr ||
      out == nullptr || t->scale == nullptr || t->bias == nullptr ||
      (out_type == kOutS8 && t->inv_next == nullptr) ||
      (residual != 0 && other == nullptr) ||
      (residual == 1 && t->in_scale == nullptr) ||
      (residual == 2 && (t->ds_scale == nullptr || t->ds_bias == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a{static_cast<const int32_t*>(acc), other, out, t->scale, t->bias,
         t->inv_next, t->in_scale, t->ds_scale, t->ds_bias, n / vec,
         c / vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = vec == 1 ? launch_v<1>(residual, out_type, a, s)
                 : launch_v<kVec>(residual, out_type, a, s);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
