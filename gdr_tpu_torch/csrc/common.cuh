// Shared helpers of the port's CUDA kernels (sm_90a).
//
// Element types: float (the CLI's f32 model) and __nv_bfloat16 (the serving
// dtype); int8_t only as the rows of the int8 document store.  to_f / from_f
// convert with round-to-nearest-even, as the reference package's astype
// does, so a value "rounded to the model dtype" is from_f<T>(x) everywhere.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gdr {

constexpr float kNegInf = -1.0e9f;   // the reference package's NEG_INF

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the f32 value of v after rounding to T
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// 8 bf16 in one 16-byte word -> f32; the lower-addressed element is the low half
__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 8 f32 -> 8 bf16 in one 16-byte word, rounded (the inverse of unpack8)
__device__ __forceinline__ uint4 pack8(const float* f) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bytes of a row as f32 and back: the re-rank scorers read store rows in
// these chunks, one per lane, whatever the element type; the self-attention
// core reads and writes its cache rows in them
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int n = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void unpack(const uint4& u, float* f) { unpack8(u, f); }
  __device__ static uint4 pack(const float* f) { return pack8(f); }
};
template <> struct Chunk<int8_t> {
  static constexpr int n = 16;
  // the lower-addressed byte is the low byte; the shifts sign-extend it
  __device__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = static_cast<float>(static_cast<int>(w[i] << (24 - 8 * j)) >> 24);
  }
};

// Where element t of chunk i of the f32 query row sits in shared memory.
// Lane l reads chunk l, l + 32, ...: with 4 or 8 elements per chunk the
// row is kept in order; with 16 (int8) it is kept element-major
// (t * chunks + i), since in order 32 lanes reading element t of their
// chunks would meet in the same bank 16 ways.
template <typename T>
__device__ __forceinline__ int q_index(int i, int t, int chunks) {
  return Chunk<T>::n == 16 ? t * chunks + i : i * Chunk<T>::n + t;
}

// Stage the f32 query row q[0, D) into shared memory in q_index order.
template <typename T>
__device__ __forceinline__ void stage_query(const float* __restrict__ q, float4* qs, int D) {
  if constexpr (Chunk<T>::n == 16) {
    float* qf = reinterpret_cast<float*>(qs);
    const int chunks = D / 16;
    for (int e = threadIdx.x; e < D; e += blockDim.x)
      qf[q_index<T>(e / 16, e % 16, chunks)] = q[e];
  } else {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int i = threadIdx.x; i < D / 4; i += blockDim.x) qs[i] = q4[i];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// v[0..31] summed over the warp, lane l left with the sum of v[l]: at each
// stage a lane keeps the half of its values that its bit selects and adds
// the partner's copy of that half (31 shuffles in all).
__device__ __forceinline__ float warp_reduce_scatter32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const bool up = lane & s;
#pragma unroll
    for (int j = 0; j < s; ++j) {
      const float send = up ? v[j] : v[j + s];
      const float keep = up ? v[j + s] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
  return v[0];
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// The f32 dot of a store row of `chunks` 16-byte chunks with the query
// staged by stage_query<T>, read by a group of LANES lanes (the whole warp,
// or an aligned half of it); `lane` is the lane's index in its group, and
// every lane of the group gets the sum.
template <typename T, int LANES = 32>
__device__ __forceinline__ float row_dot(const uint4* __restrict__ row, const float* qf,
                                         int chunks, int lane) {
  constexpr int PER = Chunk<T>::n;
  float s = 0.f;
#pragma unroll 4
  for (int i = lane; i < chunks; i += LANES) {
    float e[PER];
    Chunk<T>::unpack(row[i], e);
#pragma unroll
    for (int t = 0; t < PER; ++t) s += qf[q_index<T>(i, t, chunks)] * e[t];
  }
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

}  // namespace gdr

// error text for a cudaError_t returned by a launcher
extern "C" const char* gdr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
