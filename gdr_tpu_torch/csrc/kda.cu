// Kimi Delta Attention (KDA, Kimi Linear's gated delta rule) in f32
// (sm_90a): a query's prefix, and one decode step of its beam rows.
//
// Per token row and head h (K = V = 128; see kernels/kda.py):
//
//   q, k, v = SiLU(causal depthwise conv_T(qkv))   (the head's 3 x 128 channels)
//   q = q / sqrt(Σq² + 1e-6) · K^-½;   k = k / sqrt(Σk² + 1e-6)
//   g = −exp(a_log[h]) · softplus(W_fb fa + dt_bias)      (fa = fgb[0, K))
//   β = sigmoid(fgb[2K + h]);   og = W_gb ga              (ga = fgb[K, 2K))
//   S ← diag(exp g) S;  u = kᵀS;  S ← S + β k (v − u)ᵀ;  o = Sᵀq
//   out = o · rsqrt(mean o² + eps) · norm_w · sigmoid(og)
//
// What bounds the decode: the state.  A beam row holds S [H, K, V] f32, 2
// MB at 32 heads, and a step reads it (from the row's source beam) and
// writes it, with nothing to reuse: at 100 rows 400 MB a layer.  So a
// block takes one (row, head): it issues the loads of that head's 64 KB of
// state first (a thread holds 16 state rows × 4 columns in registers, the
// warps' 16-row slices side by side), computes the token's q, k, v, gate
// and β meanwhile (the low-rank up projections W_fb, W_gb read from L2,
// 128 × 128 each a head), then decays, corrects and writes the state back
// in one pass and reduces o through shared memory.  The state is read from
// the source row's buffer and written to the row's place in the other
// buffer, so the beams' reorder costs no extra pass.  Loads and stores of
// the state bypass L1 and are marked streaming.  The grid is (H, rows):
// shapes alone, so a launch captures in a CUDA graph.
//
// The prefill: a block takes one (query, head) and runs the query's real
// tokens in order with the state in registers: first every token's q, k,
// v, decay, og and β into shared memory, then the recurrence, writing o
// per token; the final state and the last T − 1 raw inputs are the
// query's prefix cache.  Every sum runs in a fixed order.

#include "common.cuh"

namespace gdr {

constexpr int kKdaK = 128;                   // head dim, K = V
constexpr int kKdaThreads = 256;
constexpr int kKdaWarps = kKdaThreads / 32;
constexpr int kKdaSlice = kKdaK / kKdaWarps;  // state rows a thread holds
constexpr int kKdaMaxT = 4;
constexpr int kKdaMaxS = 64;
// the device counters (kernels/kda.py's STATS): the distinct source rows the
// decode calls read, the real tokens the prefills ran
constexpr int kKdaSourceRows = 0, kKdaPrefillTokens = 1;

// one token's values of one head
struct KdaTok {
  float q[kKdaK], k[kKdaK], v[kKdaK], dec[kKdaK], og[kKdaK];
  float beta[4];
};

// a block's scratch
struct KdaScratch {
  float ab[2 * kKdaK];               // fa, ga
  float red[kKdaWarps * kKdaK];      // the warps' partial u, then o
  float part[2 * kKdaWarps];
};

__device__ __forceinline__ float kda_silu(float y) { return y / (1.f + expf(-y)); }
__device__ __forceinline__ float kda_softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

// The token's values of head h into `t`: x, its raw qkv row [3HK]; win[i]
// (i < T − 1, oldest first), its window's rows, null for zeros; wout, the
// row's new window [T − 1][3HK] or null.
__device__ void kda_token(KdaTok& t, KdaScratch& sc, const float* __restrict__ x,
                          const float* const (&win)[kKdaMaxT - 1], float* __restrict__ wout,
                          const float* __restrict__ fgb, const float* __restrict__ w_fb,
                          const float* __restrict__ w_gb, const float* __restrict__ conv_w,
                          const float* __restrict__ a_log, const float* __restrict__ dt_bias,
                          int h, int H, int T) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = 3 * H * kKdaK;
  for (int c = tid; c < 3 * kKdaK; c += kKdaThreads) {
    const int sect = c / kKdaK, j = c % kKdaK;
    const size_t col = (size_t)sect * H * kKdaK + (size_t)h * kKdaK + j;
    const float* w = conv_w + col * T;
    float y = 0.f;
    for (int i = 0; i < T - 1; ++i) {
      const float p = win[i] ? win[i][col] : 0.f;
      y += w[i] * p;
      if (wout && i > 0) wout[(size_t)(i - 1) * C + col] = p;
    }
    const float xc = x[col];
    y += w[T - 1] * xc;
    if (wout && T > 1) wout[(size_t)(T - 2) * C + col] = xc;
    (sect == 0 ? t.q : sect == 1 ? t.k : t.v)[j] = kda_silu(y);
  }
  for (int c = tid; c < 2 * kKdaK; c += kKdaThreads) sc.ab[c] = fgb[c];
  if (tid == 0) t.beta[0] = 1.f / (1.f + expf(-fgb[2 * kKdaK + h]));
  __syncthreads();
  {   // warps 0-3: the gate's 128 channels, warps 4-7: the output gate's
    const bool gate = warp < kKdaWarps / 2;
    const int o0 = (warp % (kKdaWarps / 2)) * 32;
    const float4* w4 = reinterpret_cast<const float4*>(
        (gate ? w_fb : w_gb) + ((size_t)h * kKdaK + o0) * kKdaK);
    const float4 a = reinterpret_cast<const float4*>(sc.ab + (gate ? 0 : kKdaK))[lane];
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = dot4(w4[i * (kKdaK / 4) + lane], a);
    const float s = warp_reduce_scatter32(acc);
    const int o = o0 + lane;
    if (gate)
      t.dec[o] = expf(-expf(a_log[h]) * kda_softplus(s + dt_bias[(size_t)h * kKdaK + o]));
    else
      t.og[o] = s;
  }
  {   // Σq² (warps 0-3) and Σk² (warps 4-7)
    const float e = tid < kKdaK ? t.q[tid] : t.k[tid - kKdaK];
    const float ss = warp_sum(e * e);
    if (lane == 0) sc.part[warp] = ss;
  }
  __syncthreads();
  {
    const int w0 = tid < kKdaK ? 0 : kKdaWarps / 2;
    const float ss = sc.part[w0] + sc.part[w0 + 1] + sc.part[w0 + 2] + sc.part[w0 + 3];
    const float inv = rsqrtf(ss + 1e-6f);
    if (tid < kKdaK)
      t.q[tid] *= inv * rsqrtf((float)kKdaK);
    else
      t.k[tid - kKdaK] *= inv;
  }
  __syncthreads();
}

// One token of the recurrence for this thread's slice s (state rows
// kg·16 … kg·16 + 15, columns 4·cg … 4·cg + 3) and the gated-normed output
// to out [V] (threads 0 … 127, a column each); the new state to `store`
// (a head's [K, V] as float4s) when given.
__device__ void kda_step(float4 (&s)[kKdaSlice], const KdaTok& t, KdaScratch& sc,
                         float4* __restrict__ store, float* __restrict__ out,
                         const float* __restrict__ norm_w, float eps) {
  const int tid = threadIdx.x, cg = tid & 31, kg = tid >> 5;
  const int k0 = kg * kKdaSlice;
  float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kKdaSlice; ++i) {
    const float d = t.dec[k0 + i], kk = t.k[k0 + i];
    s[i].x *= d; s[i].y *= d; s[i].z *= d; s[i].w *= d;
    u.x += kk * s[i].x; u.y += kk * s[i].y; u.z += kk * s[i].z; u.w += kk * s[i].w;
  }
  float4* red4 = reinterpret_cast<float4*>(sc.red);
  red4[kg * 32 + cg] = u;
  __syncthreads();
  u = red4[cg];
#pragma unroll
  for (int g = 1; g < kKdaWarps; ++g) {
    const float4 p = red4[g * 32 + cg];
    u.x += p.x; u.y += p.y; u.z += p.z; u.w += p.w;
  }
  const float beta = t.beta[0];
  const float4 v = reinterpret_cast<const float4*>(t.v)[cg];
  const float4 dv = make_float4(beta * (v.x - u.x), beta * (v.y - u.y), beta * (v.z - u.z),
                                beta * (v.w - u.w));
  __syncthreads();                      // every warp has read the partial u
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kKdaSlice; ++i) {
    const float kk = t.k[k0 + i], qq = t.q[k0 + i];
    s[i].x += kk * dv.x; s[i].y += kk * dv.y; s[i].z += kk * dv.z; s[i].w += kk * dv.w;
    if (store) __stcs(store + (size_t)(k0 + i) * (kKdaK / 4) + cg, s[i]);
    o.x += qq * s[i].x; o.y += qq * s[i].y; o.z += qq * s[i].z; o.w += qq * s[i].w;
  }
  red4[kg * 32 + cg] = o;
  __syncthreads();
  float ov = 0.f;
  if (tid < kKdaK) {
#pragma unroll
    for (int g = 0; g < kKdaWarps; ++g) ov += sc.red[g * kKdaK + tid];
    const float ss = warp_sum(ov * ov);
    if ((tid & 31) == 0) sc.part[kKdaWarps + (tid >> 5)] = ss;
  }
  __syncthreads();
  if (tid < kKdaK) {
    const float* p = sc.part + kKdaWarps;
    const float inv = rsqrtf((p[0] + p[1] + p[2] + p[3]) / kKdaK + eps);
    out[tid] = ov * inv * norm_w[tid] / (1.f + expf(-t.og[tid]));
  }
  __syncthreads();                      // the scratch is free again
}

__global__ void __launch_bounds__(kKdaThreads, 2)
kda_decode(const float* __restrict__ qkv, const float* __restrict__ fgb,
           const float* __restrict__ w_fb, const float* __restrict__ w_gb,
           const float* __restrict__ conv_w, const float* __restrict__ a_log,
           const float* __restrict__ dt_bias, const float* __restrict__ norm_w,
           const float* __restrict__ state_in, const float* __restrict__ conv_in,
           const int* __restrict__ src, float* __restrict__ state_out,
           float* __restrict__ conv_out, float* __restrict__ out,
           unsigned long long* __restrict__ stats, int R, int n_in, int H, int T, float eps) {
  __shared__ __align__(16) KdaTok t;
  __shared__ __align__(16) KdaScratch sc;
  const int h = blockIdx.x, r = blockIdx.y;
  const int tid = threadIdx.x, cg = tid & 31, kg = tid >> 5;
  const auto source = [&](int row) {
    return src ? src[row] : (int)((long long)row * n_in / R);
  };
  const int sr = source(r);
  if (stats && h == 0 && tid == 0) {   // a source row is counted at its first reader
    bool first = true;
    for (int p = 0; p < r && first; ++p) first = source(p) != sr;
    if (first) atomicAdd(stats + kKdaSourceRows, 1ull);
  }
  const size_t C = (size_t)3 * H * kKdaK;
  float4 s[kKdaSlice];
  {   // the source row's state, first, so that the loads run under the prologue
    const float4* in = reinterpret_cast<const float4*>(
        state_in + ((size_t)sr * H + h) * kKdaK * kKdaK);
#pragma unroll
    for (int i = 0; i < kKdaSlice; ++i)
      s[i] = __ldcs(in + (size_t)(kg * kKdaSlice + i) * (kKdaK / 4) + cg);
  }
  const float* win[kKdaMaxT - 1] = {nullptr, nullptr, nullptr};
  for (int i = 0; i < T - 1; ++i) win[i] = conv_in + ((size_t)sr * (T - 1) + i) * C;
  kda_token(t, sc, qkv + (size_t)r * C, win,
            conv_out ? conv_out + (size_t)r * (T - 1) * C : nullptr,
            fgb + (size_t)r * (2 * kKdaK + H), w_fb, w_gb, conv_w, a_log, dt_bias, h, H, T);
  kda_step(s, t, sc,
           reinterpret_cast<float4*>(state_out + ((size_t)r * H + h) * kKdaK * kKdaK),
           out + ((size_t)r * H + h) * kKdaK, norm_w, eps);
}

__global__ void __launch_bounds__(kKdaThreads, 1)
kda_prefill(const float* __restrict__ qkv, const float* __restrict__ fgb,
            const float* __restrict__ w_fb, const float* __restrict__ w_gb,
            const float* __restrict__ conv_w, const float* __restrict__ a_log,
            const float* __restrict__ dt_bias, const float* __restrict__ norm_w,
            const int* __restrict__ lens, float* __restrict__ out,
            float* __restrict__ state, float* __restrict__ conv,
            unsigned long long* __restrict__ stats, int S, int H, int T, float eps) {
  extern __shared__ float4 smem[];
  KdaScratch& sc = *reinterpret_cast<KdaScratch*>(smem);
  KdaTok* toks = reinterpret_cast<KdaTok*>(smem + sizeof(KdaScratch) / 16);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, cg = tid & 31, kg = tid >> 5;
  const int n = min(lens[b], S);
  if (stats && h == 0 && tid == 0) atomicAdd(stats + kKdaPrefillTokens, (unsigned long long)n);
  const size_t C = (size_t)3 * H * kKdaK, HK = (size_t)H * kKdaK;
  const size_t row0 = (size_t)b * S;
  for (int j = 0; j < n; ++j) {
    const float* win[kKdaMaxT - 1] = {nullptr, nullptr, nullptr};
    for (int i = 0; i < T - 1; ++i) {
      const int p = j - (T - 1) + i;
      if (p >= 0) win[i] = qkv + (row0 + p) * C;
    }
    kda_token(toks[j], sc, qkv + (row0 + j) * C, win, nullptr,
              fgb + (row0 + j) * (2 * kKdaK + H), w_fb, w_gb, conv_w, a_log, dt_bias, h, H,
              T);
  }
  float4 s[kKdaSlice];
#pragma unroll
  for (int i = 0; i < kKdaSlice; ++i) s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < n; ++j)
    kda_step(s, toks[j], sc, nullptr, out + (row0 + j) * HK + (size_t)h * kKdaK, norm_w, eps);
  for (int j = n; j < S; ++j)
    if (tid < kKdaK) out[(row0 + j) * HK + (size_t)h * kKdaK + tid] = 0.f;
  float4* st = reinterpret_cast<float4*>(state + ((size_t)b * H + h) * kKdaK * kKdaK);
#pragma unroll
  for (int i = 0; i < kKdaSlice; ++i) st[(size_t)(kg * kKdaSlice + i) * (kKdaK / 4) + cg] = s[i];
  if (conv)   // the last T − 1 raw inputs of the head's channels, zero before the first
    for (int c = tid; c < 3 * kKdaK; c += kKdaThreads) {
      const size_t col = (size_t)(c / kKdaK) * HK + (size_t)h * kKdaK + c % kKdaK;
      for (int i = 0; i < T - 1; ++i) {
        const int p = n - (T - 1) + i;
        conv[((size_t)b * (T - 1) + i) * C + col] = p >= 0 ? qkv[(row0 + p) * C + col] : 0.f;
      }
    }
}

__host__ __device__ inline size_t kda_prefill_smem(int S) {
  return sizeof(KdaScratch) + (size_t)S * sizeof(KdaTok);
}

}  // namespace gdr

// The prefill of B queries (one launch on `stream`).  qkv [B·S, 3HK], fgb
// [B·S, 2K + H], w_fb / w_gb [HK, K], conv_w [3HK, T], a_log [H], dt_bias
// [HK], norm_w [K], lens [B] int32; out [B·S, HK], state [B, H, K, K],
// conv [B, T − 1, 3HK] (null when T is 1); stats, the int64 counters, or null.
extern "C" int gdr_kda_prefill(const void* qkv, const void* fgb, const void* w_fb,
                               const void* w_gb, const void* conv_w, const void* a_log,
                               const void* dt_bias, const void* norm_w, const void* lens,
                               void* out, void* state, void* conv, void* stats, int B, int S,
                               int H, int T, float eps, void* stream) {
  using namespace gdr;
  if (B <= 0 || S <= 0 || S > kKdaMaxS || H <= 0 || T < 1 || T > kKdaMaxT ||
      (T > 1 && !conv) || B > 65535)
    return cudaErrorInvalidValue;
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kda_prefill, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kda_prefill_smem(kKdaMaxS));
    if (e != cudaSuccess) return e;
    opted = true;
  }
  kda_prefill<<<dim3(H, B), kKdaThreads, kda_prefill_smem(S), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(fgb),
      static_cast<const float*>(w_fb), static_cast<const float*>(w_gb),
      static_cast<const float*>(conv_w), static_cast<const float*>(a_log),
      static_cast<const float*>(dt_bias), static_cast<const float*>(norm_w),
      static_cast<const int*>(lens), static_cast<float*>(out), static_cast<float*>(state),
      static_cast<float*>(conv), static_cast<unsigned long long*>(stats), S, H, T, eps);
  return cudaGetLastError();
}

// One decode step of R rows (one launch on `stream`).  qkv [R, 3HK], fgb
// [R, 2K + H]; state_in [n_in, H, K, K] and conv_in [n_in, T − 1, 3HK], read
// at row src[r] (src null: r · n_in / R); state_out [R, H, K, K] and
// conv_out [R, T − 1, 3HK], written at r; out [R, HK]; stats, the int64
// counters, or null.
extern "C" int gdr_kda_decode(const void* qkv, const void* fgb, const void* w_fb,
                              const void* w_gb, const void* conv_w, const void* a_log,
                              const void* dt_bias, const void* norm_w, const void* state_in,
                              const void* conv_in, const void* src, void* state_out,
                              void* conv_out, void* out, void* stats, int R, int n_in, int H,
                              int T, float eps, void* stream) {
  using namespace gdr;
  if (R <= 0 || n_in <= 0 || H <= 0 || T < 1 || T > kKdaMaxT || R > 65535 ||
      (T > 1 && (!conv_in || !conv_out)) || state_in == state_out)
    return cudaErrorInvalidValue;
  kda_decode<<<dim3(H, R), kKdaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(fgb),
      static_cast<const float*>(w_fb), static_cast<const float*>(w_gb),
      static_cast<const float*>(conv_w), static_cast<const float*>(a_log),
      static_cast<const float*>(dt_bias), static_cast<const float*>(norm_w),
      static_cast<const float*>(state_in), static_cast<const float*>(conv_in),
      static_cast<const int*>(src), static_cast<float*>(state_out),
      static_cast<float*>(conv_out), static_cast<float*>(out),
      static_cast<unsigned long long*>(stats), R, n_in, H, T, eps);
  return cudaGetLastError();
}
