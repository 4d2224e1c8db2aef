// Latent attention (MLA, DeepSeek-V3's decompressed form) for one decode
// step over a shared query prefix, in f32 (sm_90a).
//
// Per beam row r (query b = r / W) and head h, at position lens[b] + pos:
//
//   q     = [q_nope | rope(q_pe)]                 (q   [R, H·192])
//   k_cur = [k_nope | rope(k_pe)],  v_cur = v     (kvb [R, H·256], kva's k_pe)
//   ck[pos, r, h] = k_cur;  cv[pos, r, h] = v_cur (in place)
//   out[r, h] = softmax(scale·q·[pk[b, h] ; ck[0..pos, r, h]]ᵀ + [bias[b] ; 0])
//               · [pv[b, h] ; cv[0..pos, r, h]]
//
// RoPE is transformers' de-interleaved form: pair i = (x[2i], x[2i+1])
// goes to (a cos f − b sin f, b cos f + a sin f) at columns i and i + 32,
// f = position · inv_freq[i].  Without rotation (`rotate` 0, NoPE MLA as
// Kimi Linear's) q_pe and k_pe are taken as they are.
//
// What bounds it: bytes, and few of them.  At GDR's ≤ 50 positions a step
// reads the prefix keys and values once per (query, head) (40 × 320 f32,
// 51 KB), the rows' projections and their ≤ 10 cached steps; it is a few
// MB a layer at 100 rows, against the layer's ~2 GB of expert weights.
// The design keeps the prefix from being copied per beam: a block takes
// one (query, head) and 8 of its beam rows, stages that head's prefix keys
// (rows padded to 196 floats, so the 8 lanes of a quarter-warp read 8
// different banks) and values in shared memory once, and a warp takes a
// row: a lane a prefix key for the scores, a lane 4 of the 128 value
// columns for the output.  The grid depends on the shapes alone, so a
// launch captures in a CUDA graph.  Every row's sums run in a fixed order.

#include "common.cuh"

namespace gdr {

constexpr int kMlaNope = 128, kMlaRope = 64, kMlaV = 128;
constexpr int kMlaK = kMlaNope + kMlaRope;   // 192
constexpr int kMlaKPad = kMlaK + 4;          // a staged key row, in floats
constexpr int kMlaWarps = 8;                 // beam rows a block
constexpr int kMlaMaxS = 128;
constexpr int kMlaMaxL = 32;

// a warp's q and scores in shared memory, in floats (a multiple of 4, so
// that every warp's q is 16-byte aligned)
__host__ __device__ inline int mla_warp_floats(int S) {
  return kMlaK + (S + kMlaMaxL + 3) / 4 * 4;
}

__host__ __device__ inline size_t mla_smem(int S) {
  return ((size_t)S * (kMlaKPad + kMlaV) + kMlaWarps * mla_warp_floats(S)) * sizeof(float);
}

__global__ void __launch_bounds__(kMlaWarps * 32)
mla_decode(const float* __restrict__ q, const float* __restrict__ kva,
           const float* __restrict__ kvb, const float* __restrict__ pk,
           const float* __restrict__ pv, const float* __restrict__ bias,
           const int* __restrict__ lens, float* __restrict__ ck, float* __restrict__ cv,
           const float* __restrict__ inv_freq, float* __restrict__ out, int W, int H,
           int S, int pos, int rank, float scale, int rotate) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);         // [S][kMlaKPad]
  float* vs = ks + (size_t)S * kMlaKPad;                // [S][kMlaV]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z, h = blockIdx.y;
  const int R = gridDim.z * W;
  float* qs = vs + (size_t)S * kMlaV + warp * mla_warp_floats(S);
  float* ps = qs + kMlaK;                               // S + pos + 1 scores

  {   // the (query, head)'s prefix keys and values, once a block
    const float4* k4 = reinterpret_cast<const float4*>(pk + ((size_t)b * H + h) * S * kMlaK);
    const float4* v4 = reinterpret_cast<const float4*>(pv + ((size_t)b * H + h) * S * kMlaV);
    for (int i = threadIdx.x; i < S * (kMlaK / 4); i += blockDim.x) {
      const int j = i / (kMlaK / 4), c = i % (kMlaK / 4);
      reinterpret_cast<float4*>(ks + (size_t)j * kMlaKPad)[c] = k4[i];
    }
    for (int i = threadIdx.x; i < S * (kMlaV / 4); i += blockDim.x)
      reinterpret_cast<float4*>(vs)[i] = v4[i];
  }
  __syncthreads();
  const int beam = blockIdx.x * kMlaWarps + warp;
  if (beam >= W) return;
  const int r = b * W + beam;
  const float p_at = (float)(lens[b] + pos);
  {   // this step's q (rotated) to shared memory; its key and value to the caches
    const float* qr = q + (size_t)r * H * kMlaK + (size_t)h * kMlaK;
    reinterpret_cast<float4*>(qs)[lane] = reinterpret_cast<const float4*>(qr)[lane];
    const float2 qp = reinterpret_cast<const float2*>(qr + kMlaNope)[lane];
    const float2 kp =
        reinterpret_cast<const float2*>(kva + (size_t)r * (rank + kMlaRope) + rank)[lane];
    const float* kv = kvb + (size_t)r * H * (kMlaNope + kMlaV) + (size_t)h * (kMlaNope + kMlaV);
    float* ckr = ck + (((size_t)pos * R + r) * H + h) * kMlaK;
    float* cvr = cv + (((size_t)pos * R + r) * H + h) * kMlaV;
    reinterpret_cast<float4*>(ckr)[lane] = reinterpret_cast<const float4*>(kv)[lane];
    if (rotate) {
      const float f = p_at * inv_freq[lane];
      float sn, cs;
      sincosf(f, &sn, &cs);
      qs[kMlaNope + lane] = qp.x * cs - qp.y * sn;
      qs[kMlaNope + 32 + lane] = qp.y * cs + qp.x * sn;
      ckr[kMlaNope + lane] = kp.x * cs - kp.y * sn;
      ckr[kMlaNope + 32 + lane] = kp.y * cs + kp.x * sn;
    } else {
      reinterpret_cast<float2*>(qs + kMlaNope)[lane] = qp;
      reinterpret_cast<float2*>(ckr + kMlaNope)[lane] = kp;
    }
    reinterpret_cast<float4*>(cvr)[lane] = reinterpret_cast<const float4*>(kv + kMlaNope)[lane];
  }
  __syncwarp();
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  // prefix scores: a lane a key
  for (int j = lane; j < S; j += 32) {
    const float4* k4 = reinterpret_cast<const float4*>(ks + (size_t)j * kMlaKPad);
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < kMlaK / 4; ++c) {
      const float4 a = q4[c], k = k4[c];
      s += a.x * k.x + a.y * k.y + a.z * k.z + a.w * k.w;
    }
    ps[j] = s * scale + bias[(size_t)b * S + j];
  }
  // the row's own steps: a warp a key
  for (int t = 0; t <= pos; ++t) {
    const float4* k4 =
        reinterpret_cast<const float4*>(ck + (((size_t)t * R + r) * H + h) * kMlaK);
    float s = 0.f;
    for (int c = lane; c < kMlaK / 4; c += 32) {
      const float4 a = q4[c], k = k4[c];
      s += a.x * k.x + a.y * k.y + a.z * k.z + a.w * k.w;
    }
    s = warp_sum(s);
    if (lane == 0) ps[S + t] = s * scale;
  }
  __syncwarp();
  const int n = S + pos + 1;
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, ps[j]);
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(ps[j] - m);
    ps[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  __syncwarp();
  // the output: a lane 4 value columns
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < S; ++j) {
    const float p = ps[j];
    const float4 v = reinterpret_cast<const float4*>(vs + (size_t)j * kMlaV)[lane];
    o.x += p * v.x;
    o.y += p * v.y;
    o.z += p * v.z;
    o.w += p * v.w;
  }
  for (int t = 0; t <= pos; ++t) {
    const float p = ps[S + t];
    const float4 v = reinterpret_cast<const float4*>(
        cv + (((size_t)t * R + r) * H + h) * kMlaV)[lane];
    o.x += p * v.x;
    o.y += p * v.y;
    o.z += p * v.z;
    o.w += p * v.w;
  }
  const float inv = 1.f / sum;
  reinterpret_cast<float4*>(out + (size_t)r * H * kMlaV + (size_t)h * kMlaV)[lane] =
      make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
}

}  // namespace gdr

// One MLA decode step (one launch on `stream`).  q [R, H·192], kva [R,
// rank + 64], kvb [R, H·256], pk [B, H, S, 192], pv [B, H, S, 128], bias
// [B, S] f32, lens [B] int32, ck [L, R, H, 192] and cv [L, R, H, 128]
// (written at pos), inv_freq [32] (unread when `rotate` is 0), out [R,
// H·128]; R = B·W.
extern "C" int gdr_mla_decode(const void* q, const void* kva, const void* kvb,
                              const void* pk, const void* pv, const void* bias,
                              const void* lens, void* ck, void* cv, const void* inv_freq,
                              void* out, int B, int W, int H, int S, int L, int pos,
                              int rank, float scale, int rotate, void* stream) {
  using namespace gdr;
  if (B <= 0 || W <= 0 || H <= 0 || S <= 0 || S > kMlaMaxS || L > kMlaMaxL || pos < 0 ||
      pos >= L || rank % 4)
    return cudaErrorInvalidValue;
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)mla_smem(kMlaMaxS));
    if (e != cudaSuccess) return e;
    opted = true;
  }
  const dim3 grid((W + kMlaWarps - 1) / kMlaWarps, H, B);
  mla_decode<<<grid, kMlaWarps * 32, mla_smem(S), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(kva),
      static_cast<const float*>(kvb), static_cast<const float*>(pk),
      static_cast<const float*>(pv), static_cast<const float*>(bias),
      static_cast<const int*>(lens), static_cast<float*>(ck), static_cast<float*>(cv),
      static_cast<const float*>(inv_freq), static_cast<float*>(out), W, H, S, pos, rank,
      scale, rotate);
  return cudaGetLastError();
}
