// Routed experts in f32 (sm_90a): Switch Transformer's top-1 sparse FFN,
// and DeepSeek-V3's top-k sigmoid-routed SwiGLU experts (at the end).
//
// Switch:
//
//   h = RMSNorm(x);  z = h · Wrᵀ;  e = argmax z;  π = softmax(z)[e]
//   x' = x + π · Wo[e] · ReLU(Wi[e] · h)      (x' = x for a dropped token)
//
// A token is dropped when `capacity` earlier tokens of its sequence (rows
// q·seq_len … q·seq_len + seq_len − 1, plus `counts[q, e]` tokens of earlier
// calls) were sent to the same expert, as transformers' Top1Router counts.
//
// What bounds it: the experts' weights.  An expert is 2·d·d_ff f32 (18.9 MB
// at Switch-Base's widths) and a call of a serving step touches 1–128 of
// them with a few rows each, so a call is a batch of GEMVs that must read
// every touched expert's weights once at HBM speed; its FLOPs per byte stay
// below 2·(rows per expert) / 4, under the card's f32 ridge of 20 up to ~40
// rows an expert.  And it runs inside a captured CUDA graph: no count may
// reach the host, so every launch has a grid fixed by the shapes alone.
//
// Four launches, each a `gdr::moe_` kernel:
// - moe_router: a block normalises 8 rows (written once to `hbuf`) and
//   scores them against 32 experts: a warp takes 4 experts, its lanes
//   stride d in float4, and the 32 sums of (expert, row) are reduced over
//   the warp by a butterfly that leaves lane l with sum l.
// - moe_group (one block): per row the argmax (the first of equal logits)
//   and π; the capacity rule; each sequence's counts; the kept rows grouped
//   by expert (`order`) and cut into chunks of at most 8 rows of one expert,
//   all in device memory; the stats counters; dropped rows copy x.
// - moe_up / moe_down: a persistent grid walks the work list (chunk, tile
//   of columns) that moe_group left, so an empty expert costs nothing, a
//   busy one is spread over as many blocks as its chunks, and the grid is
//   the card's, not the routing's.  A work item stages its chunk's rows in
//   shared memory (K in pieces of 1,024), each warp streams 4 weight rows
//   of the expert in float4 and forms the 4 × 8 dots, reduced as in the
//   router; each weight element is read once per chunk.
//   moe_up writes ReLU(h · Wiᵀ) at the row's place in the grouping, moe_down
//   writes x + π · (that · Woᵀ) at the row.  Every row's sums run in a fixed
//   order whatever the grouping, so a call gives the same bits every time.

#include "common.cuh"

namespace gdr {

constexpr int kMoeRows = 8;           // rows a block stages (router and products)
constexpr int kMoeCols = 4;           // weight rows a warp reads at once
constexpr int kRouterWarps = 8;       // 8 warps x 4 experts = 32 experts a block
constexpr int kUpWarps = 8;           // moe_up: 32 columns of d_ff a work item
constexpr int kDownWarps = 4;         // moe_down: 16 columns of d a work item
constexpr int kChunkK = 1024;         // K elements of a staged row
constexpr int kGroupThreads = 1024;
constexpr int kMaxExperts = 1024;
constexpr int kMaxD = 3584;           // the router's 8 staged rows in 112 KB, the
                                      // top-k up product's 16 in 224 KB

// v[0..31] summed over the 16 lanes of a half-warp, lane l of the half left
// with the sums of v[2 (l % 16)] and v[2 (l % 16) + 1] in v[0] and v[1] (30
// shuffles in all).
__device__ __forceinline__ void half_reduce_scatter32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 8, n = 16; s >= 1; s >>= 1, n >>= 1) {
    const bool up = lane & s;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const float send = up ? v[j] : v[j + n];
      const float keep = up ? v[j + n] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
}

// The most row chunks a call can have: the kept rows of each hit expert in
// chunks of kMoeRows, at most R / kMoeRows + E of them.
__host__ __device__ inline int max_chunks(int R, int E) { return R / kMoeRows + E + 1; }

// The int32 meta area moe_group writes and the products read.
struct Meta {
  int* n_chunks;      // [1]
  int* chunk_expert;  // [C]: the expert of each chunk of kept rows ...
  int* chunk_place;   // [C]: ... its first grouped place ...
  int* chunk_rows;    // [C]: ... and its rows (1 to kMoeRows)
  int* order;         // [R]: the row at each grouped place
  int* expert;        // [R]: each row's expert
  int* kept;          // [R]
  __device__ __host__ Meta(int* m, int E, int R)
      : n_chunks(m), chunk_expert(m + 1), chunk_place(m + 1 + max_chunks(R, E)),
        chunk_rows(m + 1 + 2 * max_chunks(R, E)), order(m + 1 + 3 * max_chunks(R, E)),
        expert(order + R), kept(order + 2 * R) {}
};

__global__ void __launch_bounds__(kRouterWarps * 32)
moe_router(const float* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ wr, float* __restrict__ hbuf,
           float* __restrict__ logits, int R, int D, int E, float eps) {
  extern __shared__ float4 hs[];        // kMoeRows rows of D floats
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d4 = D / 4;
  const int r0 = blockIdx.x * kMoeRows;
  {   // warp w normalises row r0 + w
    const int r = r0 + warp;
    float4* dst = hs + warp * d4;
    if (r < R) {
      const float4* xr = reinterpret_cast<const float4*>(x + (size_t)r * D);
      const float4* s4 = reinterpret_cast<const float4*>(scale);
      float ss = 0.f;
      for (int i = lane; i < d4; i += 32) {
        const float4 v = xr[i];
        ss += dot4(v, v);
      }
      const float inv = rsqrtf(warp_sum(ss) / D + eps);
      float4* out = reinterpret_cast<float4*>(hbuf + (size_t)r * D);
      for (int i = lane; i < d4; i += 32) {
        const float4 v = xr[i], s = s4[i];
        const float4 h = make_float4(v.x * inv * s.x, v.y * inv * s.y,
                                     v.z * inv * s.z, v.w * inv * s.w);
        dst[i] = h;
        if (blockIdx.y == 0) out[i] = h;
      }
    } else {
      for (int i = lane; i < d4; i += 32) dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
  const int e0 = blockIdx.y * kRouterWarps * kMoeCols + warp * kMoeCols;
  const float4* w4 = reinterpret_cast<const float4*>(wr);
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
#pragma unroll 2
  for (int i = lane; i < d4; i += 32) {
    float4 a[kMoeRows];
#pragma unroll
    for (int rr = 0; rr < kMoeRows; ++rr) a[rr] = hs[rr * d4 + i];
#pragma unroll
    for (int c = 0; c < kMoeCols; ++c) {
      if (e0 + c >= E) continue;
      const float4 w = w4[(size_t)(e0 + c) * d4 + i];
#pragma unroll
      for (int rr = 0; rr < kMoeRows; ++rr) acc[c * kMoeRows + rr] += dot4(w, a[rr]);
    }
  }
  const float v = warp_reduce_scatter32(acc);
  const int e = e0 + lane / kMoeRows, r = r0 + lane % kMoeRows;
  if (e < E && r < R) logits[(size_t)r * E + e] = v;
}

__global__ void __launch_bounds__(kGroupThreads)
moe_group(const float* __restrict__ logits, const float* __restrict__ x,
          float* __restrict__ out, float* __restrict__ prob, int* meta_ptr,
          int* counts, long long* stats, int R, int D, int E, int seq_len,
          int capacity) {
  __shared__ int load[kMaxExperts], fill[kMaxExperts], start[kMaxExperts];
  __shared__ int dropped;
  const Meta m(meta_ptr, E, R);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int e = threadIdx.x; e < E; e += blockDim.x) load[e] = fill[e] = 0;
  if (threadIdx.x == 0) dropped = 0;
  // each row's expert (the first of equal largest logits) and π, a warp a row
  for (int r = warp; r < R; r += warps) {
    const float* z = logits + (size_t)r * E;
    float best = -INFINITY;
    int arg = E;
    for (int e = lane; e < E; e += 32)
      if (z[e] > best) { best = z[e]; arg = e; }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float b = __shfl_xor_sync(0xffffffffu, best, o);
      const int a = __shfl_xor_sync(0xffffffffu, arg, o);
      if (b > best || (b == best && a < arg)) { best = b; arg = a; }
    }
    float s = 0.f;
    for (int e = lane; e < E; e += 32) s += expf(z[e] - best);
    s = warp_sum(s);
    if (lane == 0) {
      m.expert[r] = min(arg, E - 1);
      prob[r] = 1.f / s;
    }
  }
  __syncthreads();
  // a token is kept while fewer than `capacity` earlier tokens of its
  // sequence went to its expert
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int e = m.expert[r], q = r / seq_len;
    int prior = counts ? counts[(size_t)q * E + e] : 0;
    for (int j = q * seq_len; j < r; ++j) prior += m.expert[j] == e;
    const int keep = prior < capacity;
    m.kept[r] = keep;
    atomicAdd(keep ? &load[e] : &dropped, 1);
  }
  __syncthreads();
  if (counts)
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      atomicAdd(&counts[(size_t)(r / seq_len) * E + m.expert[r]], 1);
  if (threadIdx.x == 0) {   // each hit expert's kept rows, in chunks
    int at = 0, hits = 0, most = 0, chunks = 0;
    for (int e = 0; e < E; ++e) {
      start[e] = at;
      hits += load[e] > 0;
      most = max(most, load[e]);
      for (int c0 = 0; c0 < load[e]; c0 += kMoeRows, ++chunks) {
        m.chunk_expert[chunks] = e;
        m.chunk_place[chunks] = at + c0;
        m.chunk_rows[chunks] = min(kMoeRows, load[e] - c0);
      }
      at += load[e];
    }
    *m.n_chunks = chunks;
    stats[0] += 1;
    stats[1] += R;
    stats[2] += hits;
    stats[3] += most;
    stats[4] += dropped;
    stats[5] += R;
    stats[7] += R;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    if (m.kept[r]) {
      const int e = m.expert[r];
      m.order[start[e] + atomicAdd(&fill[e], 1)] = r;
    }
  // a dropped token adds 0: its row is the residual alone
  const int d4 = D / 4;
  for (int r = warp; r < R; r += warps)
    if (!m.kept[r]) {
      const float4* src = reinterpret_cast<const float4*>(x + (size_t)r * D);
      float4* dst = reinterpret_cast<float4*>(out + (size_t)r * D);
      for (int i = lane; i < d4; i += 32) dst[i] = src[i];
    }
}

// C = A · W[e]ᵀ over the chunks of kept rows: a chunk's rows are the
// grouped places chunk_place … (kDown: rows of `a` at those places; else
// rows order[place] of `a`), W [E, N, K].  kDown: out[row] = x[row] + π·c;
// else out[place] = ReLU(c).  A work item is (chunk, tile of columns).
template <bool kDown, int kWarps>
__device__ __forceinline__ void moe_product(const float* __restrict__ a,
                                            const float* __restrict__ w, int* meta_ptr,
                                            const float* __restrict__ x,
                                            const float* __restrict__ prob,
                                            float* __restrict__ out, int R, int N, int K,
                                            int E) {
  extern __shared__ float4 as[];        // kMoeRows rows of kChunkK floats
  constexpr int kCols = kWarps * kMoeCols;
  const Meta m(meta_ptr, E, R);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = N / kCols;
  const int items = *m.n_chunks * tiles;
  const int k4 = K / 4;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int chunk = item / tiles;
    const int first = m.chunk_place[chunk], nr = m.chunk_rows[chunk];
    const int col0 = (item % tiles) * kCols + warp * kMoeCols;
    const float4* w4 =
        reinterpret_cast<const float4*>(w + (size_t)m.chunk_expert[chunk] * N * K);
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    for (int kc = 0; kc < k4; kc += kChunkK / 4) {
      const int len = min(kChunkK / 4, k4 - kc);
      __syncthreads();
      for (int i = threadIdx.x; i < kMoeRows * len; i += blockDim.x) {
        const int rr = i / len, j = i % len;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (rr < nr) {
          const int place = first + rr;
          const size_t row = kDown ? place : m.order[place];
          v = reinterpret_cast<const float4*>(a + row * K)[kc + j];
        }
        as[rr * (kChunkK / 4) + j] = v;
      }
      __syncthreads();
#pragma unroll 2
      for (int j = lane; j < len; j += 32) {
        float4 av[kMoeRows];
#pragma unroll
        for (int rr = 0; rr < kMoeRows; ++rr) av[rr] = as[rr * (kChunkK / 4) + j];
#pragma unroll
        for (int c = 0; c < kMoeCols; ++c) {
          const float4 wv = w4[(size_t)(col0 + c) * k4 + kc + j];
#pragma unroll
          for (int rr = 0; rr < kMoeRows; ++rr) acc[c * kMoeRows + rr] += dot4(wv, av[rr]);
        }
      }
    }
    const float v = warp_reduce_scatter32(acc);
    const int col = col0 + lane / kMoeRows, rr = lane % kMoeRows;
    if (rr < nr) {
      const int place = first + rr;
      if (kDown) {
        const int row = m.order[place];
        const size_t o = (size_t)row * N + col;
        out[o] = x[o] + prob[row] * v;
      } else {
        out[(size_t)place * N + col] = fmaxf(v, 0.f);
      }
    }
  }
}

__global__ void __launch_bounds__(kUpWarps * 32)
moe_up(const float* __restrict__ hbuf, const float* __restrict__ wi, int* meta,
       float* __restrict__ hid, int R, int F, int D, int E) {
  moe_product<false, kUpWarps>(hbuf, wi, meta, nullptr, nullptr, hid, R, F, D, E);
}

__global__ void __launch_bounds__(kDownWarps * 32)
moe_down(const float* __restrict__ hid, const float* __restrict__ wo, int* meta,
         const float* __restrict__ x, const float* __restrict__ prob,
         float* __restrict__ out, int R, int D, int F, int E) {
  moe_product<true, kDownWarps>(hid, wo, meta, x, prob, out, R, D, F, E);
}

// blocks of a persistent product launch: as many as fit on the card at
// once (the occupancy asked once per kernel, at the first call, which runs
// outside graph capture), and no more than there can be work items
template <typename K>
static int persistent_grid(K kernel, int& per_sm, int threads, size_t smem, int sms,
                           int max_items) {
  if (per_sm == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
           cudaSuccess ||
       per_sm < 1))
    per_sm = 1;
  return max(1, min(per_sm * sms, max_items));
}

// moe_router over R rows: kMoeRows rows of D floats staged a block (the
// shared-memory limit raised once for D up to kMaxD)
static cudaError_t launch_router(const float* x, const float* scale, const float* router,
                                 float* hbuf, float* logits, int R, int D, int E, float eps,
                                 cudaStream_t s) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t e =
        cudaFuncSetAttribute(moe_router, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(kMoeRows * kMaxD * sizeof(float)));
    if (e != cudaSuccess) return e;
    opted = true;
  }
  const dim3 grid((R + kMoeRows - 1) / kMoeRows,
                  (E + kRouterWarps * kMoeCols - 1) / (kRouterWarps * kMoeCols));
  moe_router<<<grid, kRouterWarps * 32, (size_t)kMoeRows * D * sizeof(float), s>>>(
      x, scale, router, hbuf, logits, R, D, E, eps);
  return cudaGetLastError();
}

}  // namespace gdr

// One expert sublayer (four launches on `stream`).  x, out [R, D]; scale
// [D]; router [E, D]; wi [E, F, D]; wo [E, D, F]; counts [R / seq_len, E]
// int32 or null; stats [8] int64, added to; scratch: logits [R, E], hbuf
// [R, D], hid [R, F], prob [R] f32 and meta [1 + 3 (R / 8 + E + 1) + 3R]
// int32.
extern "C" int gdr_moe_sublayer(const void* x, const void* scale, const void* router,
                                const void* wi, const void* wo, void* out, void* counts,
                                void* stats, void* logits, void* hbuf, void* hid,
                                void* prob, void* meta, int R, int D, int F, int E,
                                int seq_len, int capacity, float eps, int sms,
                                void* stream) {
  using namespace gdr;
  if (R <= 0 || seq_len <= 0 || R % seq_len || D % (kDownWarps * kMoeCols) ||
      D > kMaxD || F % (kUpWarps * kMoeCols) || E <= 0 || E > kMaxExperts || sms <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* outf = static_cast<float*>(out);
  float* lg = static_cast<float*>(logits);
  float* hb = static_cast<float*>(hbuf);
  float* hd = static_cast<float*>(hid);
  float* pr = static_cast<float*>(prob);
  int* mt = static_cast<int*>(meta);
  cudaError_t err = launch_router(xf, static_cast<const float*>(scale),
                                  static_cast<const float*>(router), hb, lg, R, D, E, eps, s);
  if (err != cudaSuccess) return err;
  moe_group<<<1, kGroupThreads, 0, s>>>(lg, xf, outf, pr, mt, static_cast<int*>(counts),
                                        static_cast<long long*>(stats), R, D, E, seq_len,
                                        capacity);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = (size_t)kMoeRows * kChunkK * sizeof(float);
  const int up_tiles = F / (kUpWarps * kMoeCols), down_tiles = D / (kDownWarps * kMoeCols);
  static int up_per_sm = 0, down_per_sm = 0;
  const int chunks = max_chunks(R, E);
  moe_up<<<persistent_grid(moe_up, up_per_sm, kUpWarps * 32, smem, sms, chunks * up_tiles),
           kUpWarps * 32, smem, s>>>(hb, static_cast<const float*>(wi), mt, hd, R, F, D, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  moe_down<<<persistent_grid(moe_down, down_per_sm, kDownWarps * 32, smem, sms,
                             chunks * down_tiles),
             kDownWarps * 32, smem, s>>>(hd, static_cast<const float*>(wo), mt, xf, pr,
                                         outf, R, D, F, E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- top-k
//
// DeepSeek-V3's routed experts (transformers' DeepseekV3MoE, one group):
//
//   h = RMSNorm(x);  s = sigmoid(h · Wrᵀ);  the row's K experts e_j are those
//   of the K largest s + b (the lower index first among equals), ascending;
//   w_j = s_{e_j} / (Σ_j s_{e_j} + 1e-20) · scale
//   x' = base + Σ_j w_j · Wo[e_j] (silu(Wg[e_j] h) ⊙ Wu[e_j] h)
//
// where base is x plus the shared experts' output (the caller's GEMMs) and
// an expert's wi [2F, D] holds its gate rows, then its up rows.  No capacity.
//
// The chip's share of an expert-parallel layer: the router scores all E
// experts and each row's K are chosen, and weighted, over all of them, but
// the card holds experts [offset, offset + held) only (wi, wo [held, ...]),
// and the sum runs over the chosen experts it holds; what the others would
// add is another card's.  held = E, offset 0 is the whole layer.
//
// What bounds it: the hit experts' weights, 3·D·F f32 each (34.6 MB at
// Moonlight's D 2,048, F 1,408).  A beam step's 100 rows make 600
// assignments over 64 experts, ~9.4 an expert, so nearly every expert is
// read each call, at ~2·9.4 / 4 FLOP a byte, under the f32 ridge.  So the
// chunks hold up to kTopRows = 16 assignments of one expert, and an expert
// with ≤ 16 is read once.
//
// Five launches, each a `gdr::moe_` kernel:
// - moe_router (as above): h to `hbuf`, the logits.
// - moe_topk_group (one block): each row's K experts and weights (a warp a
//   row), the assignments a = r·K + j to held experts grouped by expert and
//   cut into chunks, the stats (with moe_assignments += R·K, moe_held +=
//   those to held experts, moe_chunks += the chunks), the chosen experts to
//   `route` when asked.
// - moe_swiglu_up / moe_topk_down: a persistent grid, one block of 16 warps
//   an SM, over work items (chunk, tile of weight rows), dealt to the
//   blocks in contiguous runs.  Up: an expert's gate row c and up row
//   F + c make hid's column c, silu(g)·u at the assignment's grouped place;
//   down: Wo[e]'s rows make ybuf's columns, w_a · (hid · Woᵀ) at the
//   assignment.
// - moe_combine: x' = base + Σ_j ybuf[r·K + j], j in order, over the held
//   experts' assignments.
//
// The products' inner loop: a column register tile over broadcast
// activations, whose on-chip work follows the chunk's real rows.
// - A block stages its chunk's rows in shared memory once for a run of
//   items of that chunk, at a height H of 4, 8, 12 or 16 rows, the least that
//   holds the chunk (moe_topk_group's chunk_rows, read on the device; the
//   rows past it zero), and runs the loop instantiated at that height.
// - A warp takes 16 weight rows: 4 groups of 8 lanes, a group's lanes
//   striding K in float4s, each lane holding the float4s of 4 weight rows
//   (up: gate rows c, c + 1 and up rows F + c, F + c + 1) at its k.  The 4
//   groups read the same activation float4 at each step, a broadcast, and
//   each feeds 4 weight rows: a lane's 64 bytes of weights a step cost H
//   shared float4s (16·H bytes, a quarter of them distinct) and 16·H FMAs,
//   so the shared-memory bytes and FMAs a weight byte scale with H.  Two
//   steps' loads go out together: 64 KB of weights in flight an SM.  (Loading
//   the next step's weights while a step is summed read 71-76% of the
//   bytes' rate at 31-100 rows, against 80-85% without.)
// - The sums go over the group's 8 lanes (a reduce-scatter: a lane keeps
//   one weight row and H / 2 rows); an item of 16 / S warps' weight rows
//   cuts K in S slices, one a warp, and the slices' sums are added in
//   order through shared memory (two buffers, a named barrier a column
//   group).  S (1, 2, 4, 8 or 16) is chosen on the device from the call's
//   chunk count, so that the busiest block streams the fewest bytes, an
//   item's drain counted too: the 1-row step's 6 chunks still spread over
//   every SM.
// Each output's sum runs in a fixed order (a lane's steps, the 8-lane
// tree, the slices in order) whatever its place, so a call gives the same
// bits every time and a replay the eager call's.

namespace gdr {

constexpr int kTopRows = 16;        // assignments a chunk holds
constexpr int kTopWarps = 16;       // a block's warps, one block an SM
constexpr int kTopLaneK = 8;        // lanes of a group, striding K
constexpr int kTopTile = 4;         // weight rows a lane holds
constexpr int kTopWarpRows = 4 * kTopTile;   // a warp's weight rows
constexpr int kTopUnroll = 2;       // k steps whose loads go out together
constexpr int kTopStage = 8;        // float4s a thread stages at once
constexpr int kTopMaxK = 16;
constexpr int kTopMaxSmem = 232448;
constexpr int kTopMetaBytes = 2 * kTopRows * 4;   // down: a row's assignment, weight
// the slices' partial sums: a float a lane and row of H / 2, two buffers
constexpr int kTopPartials = kTopWarps * 32 * (kTopRows / 2);
constexpr int kTopSplitBytes = 2 * kTopPartials * 4;
constexpr long long kTopItemBytes = 65536;   // an item's drain, in weight bytes

__host__ __device__ inline int topk_max_chunks(int A, int E) { return A / kTopRows + E + 1; }

struct TopMeta {
  int* n_chunks;      // [1]
  int* chunk_expert;  // [C]
  int* chunk_place;   // [C]
  int* chunk_rows;    // [C]: 1 to kTopRows
  int* order;         // [A]: the assignment at each grouped place
  int* expert;        // [A]: each assignment's held expert (−1: not held)
  __device__ __host__ TopMeta(int* m, int E, int A)
      : n_chunks(m), chunk_expert(m + 1), chunk_place(m + 1 + topk_max_chunks(A, E)),
        chunk_rows(m + 1 + 2 * topk_max_chunks(A, E)),
        order(m + 1 + 3 * topk_max_chunks(A, E)), expert(order + A) {}
};

__global__ void __launch_bounds__(kGroupThreads)
moe_topk_group(const float* __restrict__ logits, const float* __restrict__ bias,
               float* __restrict__ wgt, int* __restrict__ route, int* meta_ptr,
               long long* stats, int R, int E, int K, float scale, int held, int offset) {
  __shared__ int load[kMaxExperts], fill[kMaxExperts], start[kMaxExperts];
  const int A = R * K;
  const TopMeta m(meta_ptr, held, A);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int e = threadIdx.x; e < held; e += blockDim.x) load[e] = fill[e] = 0;
  for (int r = warp; r < R; r += warps) {
    const float* z = logits + (size_t)r * E;
    unsigned taken = 0;                 // bit i: expert lane + 32 i chosen
    int sel[kTopMaxK];
#pragma unroll
    for (int j = 0; j < kTopMaxK; ++j) {
      if (j >= K) break;
      float best = -INFINITY;
      int arg = E;
      for (int i = 0, e = lane; e < E; ++i, e += 32) {
        if (taken >> i & 1u) continue;
        const float c = 1.f / (1.f + expf(-z[e])) + bias[e];
        if (c > best) { best = c; arg = e; }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float bb = __shfl_xor_sync(0xffffffffu, best, o);
        const int a = __shfl_xor_sync(0xffffffffu, arg, o);
        if (bb > best || (bb == best && a < arg)) { best = bb; arg = a; }
      }
      sel[j] = arg;
      if ((arg & 31) == lane) taken |= 1u << (arg >> 5);
    }
    if (lane == 0) {
      for (int i = 1; i < K; ++i)        // ascending expert order
        for (int j = i; j > 0 && sel[j - 1] > sel[j]; --j) {
          const int t = sel[j]; sel[j] = sel[j - 1]; sel[j - 1] = t;
        }
      float sig[kTopMaxK], sum = 0.f;
      for (int j = 0; j < K; ++j) {
        sig[j] = 1.f / (1.f + expf(-z[sel[j]]));
        sum += sig[j];
      }
      const float inv = 1.f / (sum + 1e-20f);
      for (int j = 0; j < K; ++j) {
        const int a = r * K + j, e = sel[j] - offset;
        m.expert[a] = e >= 0 && e < held ? e : -1;
        wgt[a] = sig[j] * inv * scale;
        if (route) route[a] = sel[j];
      }
    }
  }
  __syncthreads();
  for (int a = threadIdx.x; a < A; a += blockDim.x)
    if (m.expert[a] >= 0) atomicAdd(&load[m.expert[a]], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int at = 0, hits = 0, most = 0, chunks = 0;
    for (int e = 0; e < held; ++e) {
      start[e] = at;
      hits += load[e] > 0;
      most = max(most, load[e]);
      for (int c0 = 0; c0 < load[e]; c0 += kTopRows, ++chunks) {
        m.chunk_expert[chunks] = e;
        m.chunk_place[chunks] = at + c0;
        m.chunk_rows[chunks] = min(kTopRows, load[e] - c0);
      }
      at += load[e];
    }
    *m.n_chunks = chunks;
    stats[0] += 1;
    stats[1] += R;
    stats[2] += hits;
    stats[3] += most;
    stats[5] += A;
    stats[6] += chunks;
    stats[7] += at;
  }
  __syncthreads();
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const int e = m.expert[a];
    if (e >= 0) m.order[start[e] + atomicAdd(&fill[e], 1)] = a;
  }
}

// One stage of group_reduce_scatter: the lanes whose bit s is set keep
// v[n … 2n − 1], the others v[0 … n − 1], each adding the partner's copy.
template <int N, int n>
__device__ __forceinline__ void group_stage(float (&v)[N], int s) {
  const bool up = (threadIdx.x & 31) & s;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const float lo = v[j], hi = v[j + n];
    v[j] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, s);
  }
}

// v[0..N-1] summed over the 8 lanes of a group (lane bits 0-2), lane l of
// the group left with the sums of v[l·N/8 … (l+1)·N/8 − 1] in v[0 … N/8 − 1]
// (7N/8 shuffles; every stage's bounds known to the compiler, so that v
// stays in registers).
template <int N>
__device__ __forceinline__ void group_reduce_scatter(float (&v)[N]) {
  group_stage<N, N / 2>(v, 4);
  group_stage<N, N / 4>(v, 2);
  group_stage<N, N / 8>(v, 1);
}

// acc + w · a: four FMAs, x, y, z, w in order
__device__ __forceinline__ float fma4(float acc, const float4& w, const float4& a) {
  return fmaf(w.w, a.w, fmaf(w.z, a.z, fmaf(w.y, a.y, fmaf(w.x, a.x, acc))));
}

// the warps of one column group meet (barrier `id`, `threads` threads)
__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The warps an item's weight rows span (16 / S): of 16, 8, 4, 2, 1 (down to
// 16 / max_split), the one whose busiest block streams the fewest bytes,
// an item's drain counted as kTopItemBytes; a tie to the larger item.
// `warp_cols`: output columns a warp makes; `row_bytes`: a weight row's.
__device__ inline int topk_item_warps(int chunks, int N, int warp_cols, int row_bytes,
                                      int max_split, int& tiles) {
  long long best = -1;
  int pick = kTopWarps;
  for (int cw = kTopWarps; cw * max_split >= kTopWarps; cw >>= 1) {
    const int t = (N + cw * warp_cols - 1) / (cw * warp_cols);
    const long long busiest = ((long long)chunks * t + gridDim.x - 1) / gridDim.x;
    const long long cost =
        busiest * ((long long)cw * kTopWarpRows * row_bytes + kTopItemBytes);
    if (best < 0 || cost < best) {
      best = cost;
      pick = cw;
      tiles = t;
    }
  }
  return pick;
}

// One work item at height H: this warp's 16 weight rows of `w` (the
// expert's) over its slice of K against the chunk's H rows in `as`, the
// sums reduced over each group's 8 lanes, then over the slices through
// `red`, then written by the first slice's warp.  c0: the warp's first
// output column; cw: the warps across an item's columns.
template <bool kUp, int H>
__device__ __forceinline__ void topk_item(const float4* __restrict__ as, float* red,
                                          const float* __restrict__ w,
                                          float* __restrict__ out, const int* s_asg,
                                          const float* s_wgt, int first, int nr, int c0,
                                          int N, int k4, int cw) {
  constexpr int kHalf = H / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kl = lane & (kTopLaneK - 1), grp = lane / kTopLaneK;
  const int split = kTopWarps / cw, kw = warp / cw;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* wr[kTopTile];
  if (kUp) {    // gate rows c, c + 1, up rows N + c, N + c + 1
    const int c = c0 + 2 * grp;
    wr[0] = w4 + (size_t)c * k4;
    wr[2] = w4 + (size_t)(N + c) * k4;
    wr[1] = wr[0] + k4;
    wr[3] = wr[2] + k4;
  } else {      // rows c0 + 4·grp … + 3
    wr[0] = w4 + (size_t)(c0 + kTopTile * grp) * k4;
#pragma unroll
    for (int c = 1; c < kTopTile; ++c) wr[c] = wr[c - 1] + k4;
  }
  float acc[kTopTile * H];              // [weight row][chunk row]
#pragma unroll
  for (int i = 0; i < kTopTile * H; ++i) acc[i] = 0.f;
  const int steps = (k4 + kTopLaneK - 1) / kTopLaneK;
  const int s_lo = kw * steps / split, s_hi = (kw + 1) * steps / split;
  if (c0 < N) {
    for (int s = s_lo; s < s_hi; s += kTopUnroll) {
      float4 wv[kTopUnroll][kTopTile];
#pragma unroll
      for (int u = 0; u < kTopUnroll; ++u) {
        const int j = (s + u) * kTopLaneK + kl;
        const bool ok = s + u < s_hi && j < k4;
#pragma unroll
        for (int c = 0; c < kTopTile; ++c)
          wv[u][c] = ok ? wr[c][j] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kTopUnroll; ++u) {
        const int j = (s + u) * kTopLaneK + kl;
        if (s + u < s_hi && j < k4) {
#pragma unroll
          for (int r = 0; r < H; ++r) {
            const float4 av = as[r * k4 + j];
#pragma unroll
            for (int c = 0; c < kTopTile; ++c)
              acc[c * H + r] = fma4(acc[c * H + r], wv[u][c], av);
          }
        }
      }
    }
  }
  group_reduce_scatter(acc);   // weight row kl / 2, chunk rows rb … rb + H/2 − 1
  if (split > 1) {
    const int col = warp % cw;
    if (kw > 0)
#pragma unroll
      for (int i = 0; i < kHalf; ++i) red[(warp * kHalf + i) * 32 + lane] = acc[i];
    group_barrier(1 + col, split * 32);
    if (kw == 0)
      for (int p = 1; p < split; ++p)
#pragma unroll
        for (int i = 0; i < kHalf; ++i) acc[i] += red[((p * cw + col) * kHalf + i) * 32 + lane];
  }
  const int rb = (kl & 1) * kHalf;
  if (kUp) {    // lanes 0-3 of a group hold gate sums, lanes 4-7 the up sums
    float u[kHalf];
#pragma unroll
    for (int i = 0; i < kHalf; ++i) u[i] = __shfl_down_sync(0xffffffffu, acc[i], 4);
    const int col = c0 + 2 * grp + (kl >> 1);
    if (kw == 0 && c0 < N && kl < 4)
#pragma unroll
      for (int i = 0; i < kHalf; ++i)
        if (rb + i < nr)
          out[(size_t)(first + rb + i) * N + col] = acc[i] / (1.f + expf(-acc[i])) * u[i];
  } else {
    const int col = c0 + kTopTile * grp + (kl >> 1);
    if (kw == 0 && c0 < N)
#pragma unroll
      for (int i = 0; i < kHalf; ++i)
        if (rb + i < nr) out[(size_t)s_asg[rb + i] * N + col] = s_wgt[rb + i] * acc[i];
  }
}

// The chunks' products, a in [*, K], W [E, (kUp ? 2N : N), K]:
//   up (kUp):  a = hbuf, the row for grouped place p order[p] / topk; out =
//              hid [A, N] at the place: silu(g) · u.
//   down:      a = hid, the row for place p p itself; out = ybuf [A, N] at
//              the assignment: wgt · (hid · Wᵀ).
// max_split: 16 where the slices' partial sums fit beside the staged rows,
// else 1.
template <bool kUp>
__device__ __forceinline__ void topk_product(const float* __restrict__ a,
                                             const float* __restrict__ w, int* meta_ptr,
                                             const float* __restrict__ wgt,
                                             float* __restrict__ out, int R, int N, int K,
                                             int E, int topk, int max_split) {
  // [16 assignments][16 weights], the rows [kTopRows][K / 4], the partials
  extern __shared__ float4 smem[];
  int* s_asg = reinterpret_cast<int*>(smem);
  float* s_wgt = reinterpret_cast<float*>(smem) + kTopRows;
  float4* as = smem + kTopMetaBytes / 16;
  const int k4 = K / 4;
  float* red = reinterpret_cast<float*>(as + kTopRows * k4);
  constexpr int kWarpCols = kUp ? kTopWarpRows / 2 : kTopWarpRows;
  const TopMeta m(meta_ptr, E, R * topk);
  int tiles = 1;
  const int cw = topk_item_warps(*m.n_chunks, N, kWarpCols, K * 4, max_split, tiles);
  const long long items = (long long)*m.n_chunks * tiles;
  const int lo = (int)(items * blockIdx.x / gridDim.x);
  const int hi = (int)(items * (blockIdx.x + 1) / gridDim.x);
  const int warp = threadIdx.x >> 5;
  int staged = -1, h = kTopRows, buf = 0;
  for (int item = lo; item < hi; ++item, buf ^= 1) {
    const int chunk = item / tiles;
    const int first = m.chunk_place[chunk], nr = m.chunk_rows[chunk];
    if (chunk != staged) {              // every warp is done with the last rows
      __syncthreads();
      h = nr <= 4 ? 4 : nr <= 8 ? 8 : nr <= 12 ? 12 : kTopRows;
      // a thread's loads of kTopStage float4s go out before its stores
      const int threads = blockDim.x;
      for (int i0 = threadIdx.x; i0 < h * k4; i0 += kTopStage * threads) {
        float4 v[kTopStage];
#pragma unroll
        for (int u = 0; u < kTopStage; ++u) {
          const int i = i0 + u * threads, rr = i / k4, j = i - rr * k4;
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < h * k4 && rr < nr) {
            const int place = first + rr;
            const size_t row = kUp ? m.order[place] / topk : place;
            v[u] = reinterpret_cast<const float4*>(a + row * (size_t)K)[j];
          }
        }
#pragma unroll
        for (int u = 0; u < kTopStage; ++u)
          if (i0 + u * threads < h * k4) as[i0 + u * threads] = v[u];
      }
      if (!kUp && threadIdx.x < kTopRows) {
        const int rr = threadIdx.x;
        s_asg[rr] = rr < nr ? m.order[first + rr] : 0;
        s_wgt[rr] = rr < nr ? wgt[s_asg[rr]] : 0.f;
      }
      staged = chunk;
      __syncthreads();
    }
    const float* we = w + (size_t)m.chunk_expert[chunk] * (kUp ? 2 * N : N) * K;
    const int c0 = ((item % tiles) * cw + warp % cw) * kWarpCols;
    float* rb = red + buf * kTopPartials;
    if (h == 4)
      topk_item<kUp, 4>(as, rb, we, out, s_asg, s_wgt, first, nr, c0, N, k4, cw);
    else if (h == 8)
      topk_item<kUp, 8>(as, rb, we, out, s_asg, s_wgt, first, nr, c0, N, k4, cw);
    else if (h == 12)
      topk_item<kUp, 12>(as, rb, we, out, s_asg, s_wgt, first, nr, c0, N, k4, cw);
    else
      topk_item<kUp, kTopRows>(as, rb, we, out, s_asg, s_wgt, first, nr, c0, N, k4, cw);
  }
}

__global__ void __launch_bounds__(kTopWarps * 32, 1)
moe_swiglu_up(const float* __restrict__ hbuf, const float* __restrict__ wi, int* meta,
              float* __restrict__ hid, int R, int F, int D, int E, int K, int max_split) {
  topk_product<true>(hbuf, wi, meta, nullptr, hid, R, F, D, E, K, max_split);
}

__global__ void __launch_bounds__(kTopWarps * 32, 1)
moe_topk_down(const float* __restrict__ hid, const float* __restrict__ wo, int* meta,
              const float* __restrict__ wgt, float* __restrict__ ybuf, int R, int D, int F,
              int E, int K, int max_split) {
  topk_product<false>(hid, wo, meta, wgt, ybuf, R, D, F, E, K, max_split);
}

__global__ void moe_combine(const float* __restrict__ base, const float* __restrict__ ybuf,
                            const int* __restrict__ expert, float* __restrict__ out, int R,
                            int D, int K) {
  const int d4 = D / 4;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)R * d4) return;
  const size_t r = i / d4, c = i % d4;
  float4 acc = reinterpret_cast<const float4*>(base)[i];
  for (int j = 0; j < K; ++j) {
    if (expert[r * K + j] < 0) continue;          // another card's expert
    const float4 y = reinterpret_cast<const float4*>(ybuf + (r * K + j) * D)[c];
    acc.x += y.x;
    acc.y += y.y;
    acc.z += y.z;
    acc.w += y.w;
  }
  reinterpret_cast<float4*>(out)[i] = acc;
}

}  // namespace gdr

// One top-k expert sublayer (five launches on `stream`).  x, base, out [R,
// D]; scale [D]; router [E, D]; bias [E]; wi [held, 2F, D]; wo [held, D,
// F], experts offset … offset + held − 1 of the E; stats [8] int64, added
// to; route [R, K] int32 or null; scratch: logits [R, E], hbuf [R, D], hid
// [R·K, F], ybuf [R·K, D], wgt [R·K] f32 and meta [1 + 3 (R·K / 16 + held
// + 1) + 2 R·K] int32.
extern "C" int gdr_moe_topk_sublayer(const void* x, const void* base, const void* scale,
                                     const void* router, const void* bias, const void* wi,
                                     const void* wo, void* out, void* stats, void* logits,
                                     void* hbuf, void* hid, void* ybuf, void* wgt, void* meta,
                                     void* route, int R, int D, int F, int E, int K,
                                     int held, int offset, float route_scale, float eps,
                                     int sms, void* stream) {
  using namespace gdr;
  if (R <= 0 || D % 16 || D > kMaxD || F % 32 ||
      kTopMetaBytes + (size_t)kTopRows * F * 4 > kTopMaxSmem ||
      E <= 0 || E > kMaxExperts || K <= 0 || K > kTopMaxK || K > E || sms <= 0 ||
      held <= 0 || offset < 0 || offset + held > E)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hb = static_cast<float*>(hbuf);
  float* lg = static_cast<float*>(logits);
  int* mt = static_cast<int*>(meta);
  cudaError_t err =
      launch_router(static_cast<const float*>(x), static_cast<const float*>(scale),
                    static_cast<const float*>(router), hb, lg, R, D, E, eps, s);
  if (err != cudaSuccess) return err;
  moe_topk_group<<<1, kGroupThreads, 0, s>>>(
      lg, static_cast<const float*>(bias), static_cast<float*>(wgt), static_cast<int*>(route),
      mt, static_cast<long long*>(stats), R, E, K, route_scale, held, offset);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  static int up_per_sm = 0, down_per_sm = 0;
  static bool opted = false;
  if (!opted) {
    if ((err = cudaFuncSetAttribute(moe_swiglu_up, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kTopMaxSmem)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(moe_topk_down, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kTopMaxSmem)) != cudaSuccess)
      return err;
    opted = true;
  }
  // the staged rows, and the slices' partial sums where they fit beside them
  // (else items of 16 warps, one slice); the grid as many blocks as there
  // can be items of one warp's columns
  const int chunks = topk_max_chunks(R * K, held);
  const size_t up_rows = kTopMetaBytes + (size_t)kTopRows * D * sizeof(float);
  const size_t down_rows = kTopMetaBytes + (size_t)kTopRows * F * sizeof(float);
  const int up_split = up_rows + kTopSplitBytes <= kTopMaxSmem ? kTopWarps : 1;
  const int down_split = down_rows + kTopSplitBytes <= kTopMaxSmem ? kTopWarps : 1;
  const size_t up_smem = up_rows + (up_split > 1 ? kTopSplitBytes : 0);
  const size_t down_smem = down_rows + (down_split > 1 ? kTopSplitBytes : 0);
  const int up_cols = kTopWarpRows / 2, down_cols = kTopWarpRows;
  moe_swiglu_up<<<persistent_grid(moe_swiglu_up, up_per_sm, kTopWarps * 32, up_smem, sms,
                                  chunks * ((F + up_cols - 1) / up_cols)),
                  kTopWarps * 32, up_smem, s>>>(hb, static_cast<const float*>(wi), mt,
                                                static_cast<float*>(hid), R, F, D, held, K,
                                                up_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  moe_topk_down<<<persistent_grid(moe_topk_down, down_per_sm, kTopWarps * 32, down_smem, sms,
                                  chunks * ((D + down_cols - 1) / down_cols)),
                  kTopWarps * 32, down_smem, s>>>(
      static_cast<const float*>(hid), static_cast<const float*>(wo), mt,
      static_cast<const float*>(wgt), static_cast<float*>(ybuf), R, D, F, held, K,
      down_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t n4 = (size_t)R * (D / 4);
  moe_combine<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(base), static_cast<const float*>(ybuf),
      TopMeta(mt, held, R * K).expert, static_cast<float*>(out), R, D, K);
  return cudaGetLastError();
}
